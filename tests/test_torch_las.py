"""PyTorch port, the model: config dataclasses, the weight bridge, attention,
the free-running speller and early-exit greedy decoding against the JAX
package at toy sizes, in float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu.decoding.greedy import (
    greedy_decode_early_stop as j_greedy,
    make_las_greedy_step as j_make_step,
)
from attention_based_e2e_asr_dnn_tpu.models import las as jlas
from attention_based_e2e_asr_dnn_tpu.ops import attention as jatt
from attention_based_e2e_asr_dnn_tpu_torch.decoding.greedy import (
    greedy_decode_early_stop as t_greedy,
    make_las_greedy_step as t_make_step,
)
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.ops import attention as tatt

torch.set_num_threads(1)

ATOL_F32 = 2e-5  # the same float32 arithmetic in another order

CFG = jlas.LASConfig(
    listener=jlas.ListenerConfig(input_dim=15, uniform_hid_dim=16, lstm_layers=1,
                                 plstm_layers=1, lstm_impl="pallas"),
    speller=jlas.SpellerConfig(enc_out_dim=32, att_proj_dim=8, att_heads=2,
                               dec_emb_dim=16, dec_lstm_hid_dim=16,
                               dec_lstm_out_dim=8, CHR_MAX_STEPS=12),
)


def _port_cfg(cfg):
    return tlas.LASConfig(listener=tlas.ListenerConfig(**dataclasses.asdict(cfg.listener)),
                          speller=tlas.SpellerConfig(**dataclasses.asdict(cfg.speller)))


def _params(seed=0, cfg=CFG):
    """JAX-initialised params as numpy, with non-zero learned initial
    states (a trained model's are not zero)."""
    params = jax.tree.map(np.asarray, jlas.las_init(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    for key in ("init_h1", "init_c1", "init_h2", "init_c2"):
        params["speller"][key] = rng.uniform(-0.5, 0.5, params["speller"][key].shape
                                             ).astype(np.float32)
    return params


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# the port's own fields (Chiu et al. 2018's LAS: the frame stacking and the
# additive score), whose defaults leave the model as the JAX package has it
PORT_ONLY = {"stack_left": 0, "stack_stride": 1, "att_score": "dot"}


def _jax_view(d):
    """A config's ``asdict`` without the port's own fields, each checked to
    hold its default."""
    out = {}
    for k, v in d.items():
        if k in PORT_ONLY:
            assert v == PORT_ONLY[k], k
        else:
            out[k] = _jax_view(v) if isinstance(v, dict) else v
    return out


@pytest.mark.parametrize("name", ["ListenerConfig", "SpellerConfig", "LASConfig"])
def test_config_fields_and_defaults_match_jax(name):
    j_fields = {f.name: f for f in dataclasses.fields(getattr(jlas, name))}
    t_fields = {f.name: f for f in dataclasses.fields(getattr(tlas, name))}
    assert list(j_fields) == [f for f in t_fields if f not in PORT_ONLY]
    assert dataclasses.asdict(getattr(jlas, name)()) == \
        _jax_view(dataclasses.asdict(getattr(tlas, name)()))


def test_config_from_dicts_and_tying_check():
    lis = {"input_dim": 15, "uniform_hid_dim": 24, "plstm_layers": 2}
    spl = {"att_proj_dim": 8, "dec_emb_dim": 16, "att_heads": 1}
    assert _jax_view(dataclasses.asdict(tlas.las_config_from_dicts(lis, spl))) == \
        dataclasses.asdict(jlas.las_config_from_dicts(lis, spl))
    with pytest.raises(ValueError, match="dec_emb_dim == 2\\*att_proj_dim"):
        tlas.las_config_from_dicts(lis, {"att_proj_dim": 8, "dec_emb_dim": 12})


def test_weight_bridge_round_trip():
    params = _params(1)
    module = tlas.las_from_jax_params(params)
    names = dict(module.named_parameters())
    assert "listener.base.0.fwd.w_ih" in names and "speller.init_h1" in names
    assert all(p.dtype == torch.float32 for p in names.values())
    back = tlas.las_to_jax_params(module)
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    assert np.abs(back["speller"]["init_c2"]).max() > 0


def test_port_init_has_the_jax_tree_shapes():
    cfg = _port_cfg(CFG)
    ours = tlas.las_to_jax_params(tlas.las_init(cfg, torch.Generator().manual_seed(0)))
    ref = jax.tree.map(np.asarray, jlas.las_init(jax.random.key(0), CFG))
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    assert [a.shape for a in jax.tree.leaves(ours)] == [a.shape for a in jax.tree.leaves(ref)]
    assert np.all(ours["speller"]["char_emb"][CFG.speller.CHR_PAD_IDX] == 0)


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("legacy_scale", [False, True])
def test_cross_attention_matches_jax(heads, legacy_scale):
    rng = np.random.default_rng(heads + 2 * legacy_scale)
    params = jax.tree.map(np.asarray, jatt.cross_attention_init(
        jax.random.key(heads), 12, 6, 8, heads))
    enc_h = rng.standard_normal((3, 7, 12)).astype(np.float32)
    enc_l = np.array([7, 4, 1], np.int32)
    dec_h = rng.standard_normal((3, 6)).astype(np.float32)
    j_cache = jatt.cross_attention_precompute(_jax(params), jnp.asarray(enc_h),
                                              jnp.asarray(enc_l), heads)
    j_ctx, j_w, j_q = jatt.cross_attention_step(_jax(params), j_cache, jnp.asarray(dec_h),
                                                heads, legacy_scale)
    t_params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    t_cache = tatt.cross_attention_precompute(t_params, torch.from_numpy(enc_h),
                                              torch.from_numpy(enc_l), heads)
    t_ctx, t_w, t_q = tatt.cross_attention_step(t_params, t_cache, torch.from_numpy(dec_h),
                                                heads, legacy_scale)
    for a, b in zip(t_cache, j_cache):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL_F32)
    for a, b in ((t_ctx, j_ctx), (t_w, j_w), (t_q, j_q)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL_F32)
    assert np.all(t_w.numpy()[2, :, 1:] == 0.0)  # re-zeroed pads


def _encoder(seed=3):
    rng = np.random.default_rng(seed)
    enc_h = rng.standard_normal((4, 6, 32)).astype(np.float32)
    enc_l = np.array([6, 5, 2, 1], np.int32)
    enc_h[np.arange(6)[None, :] >= enc_l[:, None]] = 0.0
    return enc_h, enc_l


def test_speller_free_run_logits_match_jax():
    params = _params(2)
    enc_h, enc_l = _encoder()
    ref = jlas.speller_apply(_jax(params["speller"]), CFG.speller, None,
                             jnp.asarray(enc_h), jnp.asarray(enc_l))
    module = tlas.las_from_jax_params(params)
    with torch.no_grad():
        out = tlas.speller_apply(module["speller"], _port_cfg(CFG).speller,
                                 torch.from_numpy(enc_h), torch.from_numpy(enc_l))
    assert out.logits.shape == (4, CFG.speller.CHR_MAX_STEPS, 30)
    # logits reach ~10 (tied N(0, 1) embedding): float32 order differences
    # scale with them
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits), atol=1e-4)
    np.testing.assert_allclose(out.att_map.numpy(), np.asarray(ref.att_map), atol=ATOL_F32)


@pytest.mark.parametrize("max_len_factor", [3.0, 0.0])
def test_greedy_decode_ids_match_jax_exactly(max_len_factor):
    params = _params(4)
    enc_h, enc_l = _encoder(5)
    ref = np.asarray(j_greedy(_jax(params["speller"]), CFG.speller, jnp.asarray(enc_h),
                              jnp.asarray(enc_l), max_len_factor=max_len_factor))
    module = tlas.las_from_jax_params(params)
    with torch.no_grad():
        ids = t_greedy(module["speller"], _port_cfg(CFG).speller, torch.from_numpy(enc_h),
                       torch.from_numpy(enc_l), max_len_factor=max_len_factor)
    np.testing.assert_array_equal(ids.numpy(), ref)
    if max_len_factor:  # the length cap finishes the 1-frame row after 3 ids
        assert np.all(ids.numpy()[3, 3:] == CFG.speller.CHR_PAD_IDX)


def test_las_greedy_step_matches_jax():
    params = _params(6)
    rng = np.random.default_rng(6)
    lx = np.array([16, 12, 7, 3], np.int32)
    x = rng.standard_normal((4, 16, 15)).astype(np.float32)
    x[np.arange(16)[None, :] >= lx[:, None]] = 0.0
    ref = np.asarray(j_make_step(CFG)(_jax(params), jnp.asarray(x), jnp.asarray(lx)))
    ids = t_make_step(_port_cfg(CFG))(tlas.las_from_jax_params(params),
                                      torch.from_numpy(x), torch.from_numpy(lx))
    np.testing.assert_array_equal(ids.numpy(), ref)
