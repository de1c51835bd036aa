"""PyTorch port, beam search against the JAX package at toy sizes, in
float32: the numpy finalization's copy, ``beam_search`` (ids equal, final
scores within 1e-5, ties included), beam 1 against greedy, the LAS beam
steps (the eval step's loss decode on the fused decode's plain version, the
JAX one in interpret mode), the ``Transcriber`` and the ``infer`` CLI with
``beam_size: 4``."""

import argparse
import dataclasses
import inspect
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu import infer as jinfer
from attention_based_e2e_asr_dnn_tpu.decoding import beam as jbeam
from attention_based_e2e_asr_dnn_tpu.decoding import select as jselect
from attention_based_e2e_asr_dnn_tpu.models import las as jlas
from attention_based_e2e_asr_dnn_tpu.serving import Transcriber as JaxTranscriber
from attention_based_e2e_asr_dnn_tpu_torch import infer as tinfer
from attention_based_e2e_asr_dnn_tpu_torch import serving as tserving
from attention_based_e2e_asr_dnn_tpu_torch.decoding import beam as tbeam
from attention_based_e2e_asr_dnn_tpu_torch.decoding import select as tselect
from attention_based_e2e_asr_dnn_tpu_torch.decoding.greedy import greedy_decode_early_stop
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas

from test_torch_infer import _infer_yaml, toy  # noqa: F401  (the fixture)

torch.set_num_threads(1)

SCORE_ATOL = 1e-5   # final beam scores: float32 sums of ~12 log-probabilities
METRIC_ATOL = 2e-5  # the eval step's loss and perplexity

SPELLER = jlas.SpellerConfig(enc_out_dim=16, att_proj_dim=8, att_heads=2, dec_emb_dim=16,
                             dec_lstm_hid_dim=16, dec_lstm_out_dim=8, CHR_MAX_STEPS=12)
LAS = jlas.LASConfig(
    listener=jlas.ListenerConfig(input_dim=15, uniform_hid_dim=8, lstm_layers=1,
                                 plstm_layers=1, lstm_impl="pallas"),
    speller=dataclasses.replace(SPELLER, decoder_impl="pallas"))


def _port_speller_cfg(cfg):
    return tlas.SpellerConfig(**dataclasses.asdict(cfg))


def _speller_case(seed, tied=False):
    """Seeded speller parameters (non-zero learned states), encodings and
    lengths. ``tied``: the embedding rows in groups of three equal rows, and
    the classifier bias with them, so that every step has tied logits."""
    params = jax.tree.map(lambda a: np.array(a, np.float32), jlas.las_init(
        jax.random.key(seed), dataclasses.replace(LAS, speller=SPELLER)))["speller"]
    rng = np.random.default_rng(seed)
    for key in ("init_h1", "init_c1", "init_h2", "init_c2", "cls_b"):
        params[key] = rng.uniform(-0.5, 0.5, params[key].shape).astype(np.float32)
    if tied:
        for r in range(1, 28):
            params["char_emb"][r] = params["char_emb"][1 + 3 * ((r - 1) // 3)]
            params["cls_b"][r] = params["cls_b"][1 + 3 * ((r - 1) // 3)]
    enc_h = rng.standard_normal((3, 6, 16)).astype(np.float32)
    enc_l = np.array([6, 2, 4], np.int32)
    return params, enc_h, enc_l


def test_select_copy_equals_the_jax_module():
    for name in ("backtrace", "backtrace_all", "select_best_sequences"):
        assert inspect.getsource(getattr(tselect, name)) == \
            inspect.getsource(getattr(jselect, name)), name
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 30, (7, 2, 3)).astype(np.int32)
    parents = rng.integers(0, 3, (7, 2, 3)).astype(np.int32)
    scores = rng.standard_normal((2, 3)).astype(np.float32)
    for alpha in (0.0, 0.7):
        np.testing.assert_array_equal(
            tselect.select_best_sequences(tokens, parents, scores, 29, alpha),
            jselect.select_best_sequences(tokens, parents, scores, 29, alpha))


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("beam,alpha,factor", [
    (1, 0.0, 3.0), (4, 0.0, 3.0), (4, 0.5, 0.0), (8, 0.0, 0.0), (8, 0.5, 3.0)])
def test_beam_search_matches_jax(beam, alpha, factor, tied):
    params, enc_h, enc_l = _speller_case(1, tied)
    exact = alpha == 0.0
    j_tok, j_par, j_fin, j_scores, _ = jbeam._beam_decode_scan(
        jax.tree.map(jnp.asarray, params), SPELLER, jnp.asarray(enc_h), jnp.asarray(enc_l),
        beam, 12, exact_prune=exact, max_len_factor=factor)
    t_params = tlas.ParamTree(params)
    t_tok, t_par, t_fin, t_scores, _ = tbeam._beam_decode(
        t_params, _port_speller_cfg(SPELLER), torch.from_numpy(enc_h), torch.from_numpy(enc_l),
        beam, 12, exact_prune=exact, max_len_factor=factor)
    np.testing.assert_array_equal(t_tok, np.asarray(j_tok))
    np.testing.assert_array_equal(t_par, np.asarray(j_par))
    np.testing.assert_array_equal(t_fin, np.asarray(j_fin))
    live = np.asarray(j_scores) > -1e29
    np.testing.assert_array_equal(t_scores > -1e29, live)
    np.testing.assert_allclose(t_scores[live], np.asarray(j_scores)[live], atol=SCORE_ATOL)
    ids = tbeam.beam_search(t_params, _port_speller_cfg(SPELLER), torch.from_numpy(enc_h),
                            torch.from_numpy(enc_l), beam, 12, alpha, factor)
    ref = jbeam.beam_search(jax.tree.map(jnp.asarray, params), SPELLER, jnp.asarray(enc_h),
                            jnp.asarray(enc_l), beam, 12, alpha, factor)
    np.testing.assert_array_equal(ids, ref)
    assert ids.dtype == np.int32 and ids.shape == (3, 12)


def test_beam_one_equals_greedy():
    params, enc_h, enc_l = _speller_case(2)
    cfg = _port_speller_cfg(SPELLER)
    t_params = tlas.ParamTree(params)
    ids = tbeam.beam_search(t_params, cfg, torch.from_numpy(enc_h), torch.from_numpy(enc_l), 1)
    greedy = greedy_decode_early_stop(t_params, cfg, torch.from_numpy(enc_h),
                                      torch.from_numpy(enc_l))
    np.testing.assert_array_equal(ids, greedy.numpy())


def _las_params(seed):
    params = jax.tree.map(np.asarray, jlas.las_init(jax.random.key(seed), LAS))
    rng = np.random.default_rng(seed)
    for key in ("init_h1", "init_c1", "init_h2", "init_c2", "cls_b"):
        params["speller"][key] = rng.uniform(-0.5, 0.5, params["speller"][key].shape
                                             ).astype(np.float32)
    return params


def test_las_beam_steps_match_jax():
    params = _las_params(3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, 15)).astype(np.float32)
    lx = np.array([16, 9, 12, 4], np.int32)
    y = rng.integers(1, 29, (4, 8)).astype(np.int32)
    ly = np.array([8, 5, 3, 6], np.int32)
    t_cfg = tlas.LASConfig(listener=tlas.ListenerConfig(**dataclasses.asdict(LAS.listener)),
                           speller=_port_speller_cfg(LAS.speller))
    t_params = tlas.las_from_jax_params(params)
    j_params = jax.tree.map(jnp.asarray, params)

    ids = tbeam.make_las_beam_step(t_cfg, 4)(t_params, torch.from_numpy(x), torch.from_numpy(lx))
    ref = jbeam.make_las_beam_step(LAS, 4)(j_params, jnp.asarray(x), jnp.asarray(lx))
    np.testing.assert_array_equal(ids.numpy(), ref)

    t_step = tbeam.make_las_eval_beam_step(t_cfg, 4, length_alpha=0.5)
    j_step = jbeam.make_las_eval_beam_step(LAS, 4, length_alpha=0.5)
    args = [torch.from_numpy(a) for a in (x, lx, y, ly)]
    for want in (True, False):
        metrics, t_ids = t_step(t_params, *args, want_ids=want)
        j_metrics, j_ids = j_step(j_params, *map(jnp.asarray, (x, lx, y, ly)), want_ids=want)
        for key in ("loss", "ppl", "n_tokens"):
            np.testing.assert_allclose(float(metrics[key]), float(j_metrics[key]),
                                       atol=METRIC_ATOL, rtol=METRIC_ATOL, err_msg=key)
        if want:
            np.testing.assert_array_equal(t_ids.numpy(), j_ids)
        else:
            assert t_ids is None and j_ids is None
    # with a mesh (data parallelism, here one rank in a gloo group of its
    # own): the same metrics and the gathered ids
    from attention_based_e2e_asr_dnn_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.make_mesh(1, device="cpu")
    try:
        m_metrics, m_ids = tbeam.make_las_eval_beam_step(t_cfg, 4, length_alpha=0.5,
                                                         mesh=mesh)(t_params, *args)
    finally:
        tmesh.close_mesh()
    metrics, t_ids = t_step(t_params, *args)
    for key in ("loss", "ppl", "n_tokens"):
        assert float(m_metrics[key]) == float(metrics[key]), key
    np.testing.assert_array_equal(m_ids.numpy(), t_ids.numpy())


def test_transcriber_with_beam_matches_jax(toy):  # noqa: F811
    _, _, exp = toy
    rng = np.random.default_rng(5)
    feats = [rng.standard_normal((int(n), 15)).astype(np.float32)
             for n in rng.integers(6, 30, 7)]
    opts = dict(beam_size=4, length_alpha=0.5, batch_size=4, pad_time_multiple=4)
    ref = JaxTranscriber(exp, **opts).transcribe(feats)
    assert tserving.Transcriber(exp, device="cpu", **opts).transcribe(feats) == ref


@pytest.mark.parametrize("opts", [{"run_all": True, "beam_size": 4},
                                  {"epoch_num": 2, "beam_size": 4, "length_alpha": 0.5,
                                   "max_len_factor": 0}],
                         ids=["run_all", "epoch_num-alpha"])
def test_infer_cli_with_beam_writes_the_jax_csvs(toy, tmp_path, opts):  # noqa: F811
    root, data, exp = toy
    outs = {}
    for side in ("jax", "port"):
        exp_copy = shutil.copytree(exp, str(tmp_path / side))
        cfg = _infer_yaml(str(tmp_path), side, data, exp_copy, **opts)
        if side == "jax":
            jinfer.main(argparse.Namespace(config_file=cfg))
        else:
            tinfer.main(tinfer.build_argparser().parse_args(["-c", cfg, "--device", "cpu"]))
        preds = os.path.join(exp_copy, "preds")
        outs[side] = {f: open(os.path.join(preds, f), "rb").read()
                      for f in sorted(os.listdir(preds))}
    assert outs["port"] == outs["jax"] and outs["port"]
