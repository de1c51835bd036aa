"""PyTorch port, the Rewriter and its decoding against the JAX package at toy
sizes: the config, the weight bridge, ``rewriter_apply`` (float32 within
2e-5, bfloat16 within two bf16 steps of the largest logit; free-running and
teacher-forced; both implementation tiers, the kernels' plain versions
against the JAX Pallas kernels in interpret mode; an embedding of at most
128 and one wider, the two input routes of the encoder), the anchored greedy
decode, the forced scorers (within 1e-5), and the host-side selection, fit
and gate of ``decoding/rescore.py``."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu.decoding import greedy as jgreedy
from attention_based_e2e_asr_dnn_tpu.decoding import rescore as jrescore
from attention_based_e2e_asr_dnn_tpu.models import rewriter as jrw
from attention_based_e2e_asr_dnn_tpu_torch.decoding import greedy as tgreedy
from attention_based_e2e_asr_dnn_tpu_torch.decoding import rescore as trescore
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.models import rewriter as trw

torch.set_num_threads(1)

ATOL_F32 = 2e-5    # logits: the same float32 arithmetic in another order
SCORE_ATOL = 1e-5  # forced scores: float32 means of log-probabilities
BF16_STEPS = 2     # bfloat16 logits: two bf16 steps (2**-7 relative) of the largest

MODEL = dict(emb_dim=16, enc_lstm_layers=2, enc_lstm_hid_dim=8, enc_dropouts=(0.0, 0.0),
             att_proj_dim=8, att_heads=2, dec_lstm_hid_dim=16, dec_lstm_out_dim=8,
             dec_lstm_dropout=0.0, CHR_MAX_STEPS=14)
# an embedding wider than 128: the encoder's first layer takes lstm_scan over
# the projected input instead of the fused-input form
WIDE = dict(MODEL, emb_dim=144, att_proj_dim=72)


def _cfgs(impl="pallas", **changes):
    model = {**MODEL, **changes, "lstm_impl": impl, "decoder_impl": impl}
    return jrw.RewriterConfig(**model), trw.RewriterConfig(**model)


def _params(cfg, seed=0):
    params = jax.tree.map(lambda a: np.array(a, np.float32),
                          jrw.rewriter_init(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    for key in ("init_h1", "init_c1", "init_h2", "init_c2", "cls_b"):
        params["decoder"][key] = rng.uniform(-0.5, 0.5, params["decoder"][key].shape
                                             ).astype(np.float32)
    return params


def _inputs(seed=0, batch=4, width=16):
    """Char-id rows [SOS, chars, EOS, EOS pad] and their lengths."""
    rng = np.random.default_rng(seed)
    lx = rng.integers(4, width + 1, batch).astype(np.int32)
    lx[0] = width
    x = np.full((batch, width), 29, np.int32)
    for b, n in enumerate(lx):
        x[b, 0] = 0
        x[b, 1:n - 1] = rng.integers(1, 29, n - 2)
    return x, lx


def test_config_fields_and_defaults_match_jax():
    j_fields = [f.name for f in dataclasses.fields(jrw.RewriterConfig)]
    assert j_fields == [f.name for f in dataclasses.fields(trw.RewriterConfig)]
    assert dataclasses.asdict(trw.RewriterConfig()) == dataclasses.asdict(jrw.RewriterConfig())
    j_cfg, t_cfg = _cfgs()
    # the port's speller adds the score kind; the Rewriter's is the JAX one's
    t_speller = dataclasses.asdict(t_cfg.speller_config())
    assert t_speller.pop("att_score") == "dot"
    assert t_speller == dataclasses.asdict(j_cfg.speller_config())


def test_weight_bridge_round_trip_and_init_shapes():
    j_cfg, t_cfg = _cfgs()
    params = _params(j_cfg)
    module = trw.rewriter_from_jax_params(params)
    names = dict(module.named_parameters())
    assert {"encoder.0.fwd.w_ih", "encoder.1.bwd.w_hh", "decoder.char_emb",
            "decoder.init_h1", "decoder.attention.query_map.w"} <= set(names)
    back = trw.rewriter_to_jax_params(module)
    flat_j, tree_j = jax.tree.flatten(params)
    flat_t, tree_t = jax.tree.flatten(back)
    assert tree_j == tree_t
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)
    fresh = trw.rewriter_to_jax_params(trw.rewriter_init(t_cfg, torch.Generator().manual_seed(0)))
    assert jax.tree.map(np.shape, fresh) == jax.tree.map(np.shape, params)
    assert not fresh["decoder"]["char_emb"][29].any()  # the PAD row
    with pytest.raises(ValueError, match="encoder and decoder"):
        trw.Rewriter({"encoder": []})


def _apply_both(j_cfg, t_cfg, params, x, lx, forced, dtype):
    j_params = jax.tree.map(jnp.asarray, params)
    t_params = trw.rewriter_from_jax_params(params)
    if forced:
        dec_y = np.concatenate([x[:, 1:], np.full((x.shape[0], 1), 29, np.int32)], axis=1)
        ref = jrw.rewriter_apply(j_params, j_cfg, jax.random.key(7), jnp.asarray(x),
                                 jnp.asarray(lx), jnp.asarray(dec_y), tf_rate=1.0,
                                 train=True, compute_dtype=dtype[0]).logits
        # tf_rate 1.0 forces every step past the first whatever the coins
        draws = tlas.TrainDraws([None] * t_cfg.enc_lstm_layers,
                                torch.zeros(dec_y.shape[1]), None, None)
        with torch.no_grad():
            got = trw.rewriter_apply(t_params, t_cfg, x, lx, torch.from_numpy(dec_y),
                                     tf_rate=1.0, train=True, compute_dtype=dtype[1],
                                     draws=draws).logits
    else:
        ref = jrw.rewriter_apply(j_params, j_cfg, None, jnp.asarray(x), jnp.asarray(lx),
                                 compute_dtype=dtype[0]).logits
        with torch.no_grad():
            got = trw.rewriter_apply(t_params, t_cfg, x, lx, compute_dtype=dtype[1]).logits
    return got.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("forced", [False, True], ids=["free", "forced"])
@pytest.mark.parametrize("impl,width", [("scan", "narrow"), ("pallas", "narrow"),
                                        ("pallas", "wide")])
def test_rewriter_apply_matches_jax_float32(impl, width, forced):
    j_cfg, t_cfg = _cfgs(impl, **(WIDE if width == "wide" else {}))
    params = _params(j_cfg, 1)
    x, lx = _inputs(1)
    got, ref = _apply_both(j_cfg, t_cfg, params, x, lx, forced, (None, None))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL_F32, rtol=0)


@pytest.mark.parametrize("forced", [False, True], ids=["free", "forced"])
def test_rewriter_apply_matches_jax_bfloat16(forced):
    """The bfloat16 policy at the embedding lookup, both kernel tiers (their
    plain versions against the JAX Pallas kernels in interpret mode). The
    free-running decode is held over the steps before the two first differ
    in their fed-back ids (a tie broken the other way by one rounding), the
    forced one over all steps."""
    j_cfg, t_cfg = _cfgs("pallas")
    params = _params(j_cfg, 2)
    x, lx = _inputs(2)
    got, ref = _apply_both(j_cfg, t_cfg, params, x, lx, forced,
                           (jnp.bfloat16, torch.bfloat16))
    if not forced:
        same = (got.argmax(-1) == ref.argmax(-1)).all(axis=0)
        steps = int(np.argmin(same)) + 1 if not same.all() else got.shape[1]
        assert steps >= 4
        got, ref = got[:, :steps], ref[:, :steps]
    tol = BF16_STEPS * 2.0 ** -7 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol


def _encode_both(j_cfg, t_cfg, params, x, lx):
    from attention_based_e2e_asr_dnn_tpu.ops.lstm import locked_lstm_stack_apply

    j_params = jax.tree.map(jnp.asarray, params)
    emb = j_params["decoder"]["char_emb"]
    enc = locked_lstm_stack_apply(j_params["encoder"], None, emb[jnp.asarray(x)],
                                  jnp.asarray(lx), init_dropout=0.0, mid_dropout=0.0,
                                  bidirectional=True, train=False, impl=j_cfg.lstm_impl)
    t_params = trw.rewriter_from_jax_params(params)
    with torch.no_grad():
        t_enc = trw.rewriter_encode(t_params, t_cfg, x, lx)
    return j_params, enc, t_params, t_enc


@pytest.mark.parametrize("anchored", [0, 1], ids=["free", "anchored"])
def test_anchored_decode_matches_jax(anchored):
    j_cfg, t_cfg = _cfgs("pallas")
    params = _params(j_cfg, 3)
    x, lx = _inputs(3)
    anchor = x[:, 1:]
    alen = (np.maximum(lx - 2, 0) // 2 * anchored).astype(np.int32)
    ref = np.asarray(jgreedy.make_rewriter_anchored_step(j_cfg)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(lx),
        jnp.asarray(anchor), jnp.asarray(alen)))
    t_params = trw.rewriter_from_jax_params(params)
    got = tgreedy.make_rewriter_anchored_step(t_cfg)(t_params, x, lx, anchor, alen)
    np.testing.assert_array_equal(got.numpy(), ref)
    free = tgreedy.make_rewriter_greedy_step(t_cfg)(t_params, x, lx).numpy()
    ref_free = np.asarray(jgreedy.make_rewriter_greedy_step(j_cfg)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(lx)))
    np.testing.assert_array_equal(free, ref_free)
    if anchored:
        for b in range(x.shape[0]):
            np.testing.assert_array_equal(got[b, :alen[b]].numpy(), anchor[b, :alen[b]])
    else:
        np.testing.assert_array_equal(got.numpy(), free)


def test_forced_scorers_match_jax():
    j_cfg, t_cfg = _cfgs("pallas")
    params = _params(j_cfg, 4)
    x, lx = _inputs(4)
    cand, lc = _inputs(5)
    j_params = jax.tree.map(jnp.asarray, params)
    t_params = trw.rewriter_from_jax_params(params)
    ref = np.asarray(jrescore.make_rewriter_scorer(j_cfg)(
        j_params, jnp.asarray(x), jnp.asarray(lx), jnp.asarray(cand), jnp.asarray(lc)))
    got = trescore.make_rewriter_scorer(t_cfg)(t_params, x, lx, cand, lc).numpy()
    np.testing.assert_allclose(got, ref, atol=SCORE_ATOL, rtol=0)
    ref_tok = np.asarray(jrescore.make_rewriter_token_scorer(j_cfg)(
        j_params, jnp.asarray(x), jnp.asarray(lx), jnp.asarray(x)))
    got_tok = trescore.make_rewriter_token_scorer(t_cfg)(t_params, x, lx, x).numpy()
    np.testing.assert_allclose(got_tok, ref_tok, atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["span_anchor_lengths", "candidates_to_layout",
                                  "select_among_candidates", "fit_margin"])
def test_host_functions_are_the_jax_ones(name):
    assert inspect.getsource(getattr(trescore, name)) == \
        inspect.getsource(getattr(jrescore, name))


def test_fit_margin_equals_jax():
    rng = np.random.default_rng(6)
    for n in (0, 1, 7, 40):
        margins = np.round(rng.standard_normal(n), 1)  # ties among the margins
        ld_in = rng.integers(0, 9, n)
        ld_co = rng.integers(0, 9, n)
        assert trescore.fit_margin(margins, ld_in, ld_co) == \
            jrescore.fit_margin(margins, ld_in, ld_co)


def test_gate_and_selection_match_jax():
    j_cfg, t_cfg = _cfgs("pallas")
    params = _params(j_cfg, 7)
    x, lx = _inputs(7)
    j_params = jax.tree.map(jnp.asarray, params)
    t_params = trw.rewriter_from_jax_params(params)
    j_scorer, t_scorer = jrescore.make_rewriter_scorer(j_cfg), trescore.make_rewriter_scorer(t_cfg)
    rng = np.random.default_rng(7)
    cands = [rng.integers(1, 30, (4, n)).astype(np.int32) for n in (9, 20)]
    for margin in (0.0, 0.3):
        use, s_c, s_i = trescore.gate_corrections(t_scorer, t_params, x, lx, cands[0], 29, 0,
                                                  margin=margin)
        j_use, j_c, j_i = jrescore.gate_corrections(j_scorer, j_params, x, lx, cands[0], 29, 0,
                                                    margin=margin)
        np.testing.assert_array_equal(use, j_use)
        np.testing.assert_allclose(s_c, j_c, atol=SCORE_ATOL, rtol=0)
        np.testing.assert_allclose(s_i, j_i, atol=SCORE_ATOL, rtol=0)
    ids, lc, margins = trescore.select_among_candidates(t_scorer, t_params, x, lx, cands, 29, 0)
    j_ids, j_lc, j_margins = jrescore.select_among_candidates(j_scorer, j_params, x, lx,
                                                              cands, 29, 0)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(lc, j_lc)
    np.testing.assert_allclose(margins, j_margins, atol=SCORE_ATOL, rtol=0)
