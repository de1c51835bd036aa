"""PyTorch port, sequence parallelism (``parallel/sequence.py``): the
time-sharded attention step against the JAX ``sequence_parallel_attention_step``
on conftest's virtual CPU devices (context, weights, q_proj) and against the
one-device step's gradients; whole train steps at data 2 x seq 2 and at
data 1 x seq 2 x model 2 against the JAX step whose encoder output carries
the ``("data", "seq")`` sharding constraint, as the JAX ``train`` CLI routes
``parallel.sequence``; and the ``train`` CLI's sequence-parallel runs against
its plain run. Randomness quiesced; tolerances as in
``tests/test_torch_tp.py`` (float32 2e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from attention_based_e2e_asr_dnn_tpu.ops import attention as jatt
from attention_based_e2e_asr_dnn_tpu.parallel import mesh as jmesh
from attention_based_e2e_asr_dnn_tpu.parallel import sequence as jseq
from attention_based_e2e_asr_dnn_tpu_torch.ops import attention as tatt
from attention_based_e2e_asr_dnn_tpu_torch.parallel import mesh as tmesh
from attention_based_e2e_asr_dnn_tpu_torch.parallel import sequence as tseq

from test_torch_tp import (
    ATOL,
    assert_state_matches_jax,
    batch,
    cpus,
    jax_mesh_step,
    jparams,
    port_grid_step,
)

torch.set_num_threads(1)

HEADS, B, T, ENC, DEC, PROJ = 2, 4, 16, 8, 6, 8


def _attention_inputs():
    params = jax.tree.map(np.asarray, jatt.cross_attention_init(jax.random.key(0), ENC, DEC,
                                                                 PROJ, HEADS))
    rng = np.random.default_rng(1)
    enc_h = rng.normal(size=(B, T, ENC)).astype(np.float32)
    enc_l = np.array([16, 9, 5, 2], np.int32)
    dec_h = rng.normal(size=(B, DEC)).astype(np.float32)
    return params, enc_h, enc_l, dec_h


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else
            torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in tree.items()}


def _leaves(tree):
    """The tensors in ``jax.tree.leaves``' order (keys sorted)."""
    return [t for k in sorted(tree)
            for t in (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


@pytest.mark.parametrize("seq", [2, 4, 8])
def test_sequence_parallel_attention_step_matches_jax(seq):
    """The time axis in ``seq`` blocks: context, weights and q_proj against
    the JAX shard_map step over ``seq`` virtual devices; the gradients of the
    context in every parameter and the query against JAX's one-device step
    (the same function)."""
    params, enc_h, enc_l, dec_h = _attention_inputs()
    jp = jax.tree.map(jnp.asarray, params)
    cache = jatt.cross_attention_precompute(jp, jnp.asarray(enc_h), jnp.asarray(enc_l), HEADS)
    mesh = Mesh(np.array(jax.devices()[:seq]), ("seq",))
    j_ctx, j_w, j_q = jseq.sequence_parallel_attention_step(
        jp, jseq.shard_cache_over_time(cache, mesh), jnp.asarray(dec_h), HEADS, mesh)

    tp = _torch_tree(params)
    t_dec = torch.from_numpy(dec_h).requires_grad_(True)
    t_cache = tatt.cross_attention_precompute(tp, torch.from_numpy(enc_h),
                                              torch.from_numpy(enc_l), HEADS)
    sharded = tseq.shard_cache_over_time(t_cache, cpus(seq))
    assert [k.shape[2] for k in sharded.keys] == [T // seq] * seq
    ctx, wgts, q = tatt.cross_attention_step(tp, sharded, t_dec, HEADS)
    np.testing.assert_allclose(ctx.detach().numpy(), np.asarray(j_ctx), atol=ATOL)
    np.testing.assert_allclose(torch.cat(wgts.blocks, dim=-1).detach().numpy(), np.asarray(j_w),
                               atol=ATOL)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(j_q), atol=ATOL)
    np.testing.assert_allclose(wgts[1].detach().numpy(), np.asarray(j_w)[1], atol=ATOL)

    def j_loss(p, d):
        c = jatt.cross_attention_precompute(p, jnp.asarray(enc_h), jnp.asarray(enc_l), HEADS)
        return jnp.sum(jatt.cross_attention_step(p, c, d, HEADS)[0] ** 2)

    j_gp, j_gd = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(dec_h))
    got = torch.autograd.grad((ctx ** 2).sum(), _leaves(tp) + [t_dec])
    want = jax.tree.leaves(jax.tree.map(np.asarray, j_gp)) + [np.asarray(j_gd)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


def test_sequence_parallel_step_takes_the_alignment_prior():
    """With the ``init_force`` prior's row the renormalising softmax is
    global too: the context equals the one-device step's, the weights stay
    the pre-forcing ones; a time axis the blocks do not divide raises."""
    params, enc_h, enc_l, dec_h = _attention_inputs()
    tp = _torch_tree(params)
    cache = tatt.cross_attention_precompute(tp, torch.from_numpy(enc_h),
                                            torch.from_numpy(enc_l), HEADS)
    row = torch.linspace(0.0, 1.0, T)
    want = tatt.cross_attention_step(tp, cache, torch.from_numpy(dec_h), HEADS,
                                     init_wgts_row=row)
    got = tatt.cross_attention_step(tp, tseq.shard_cache_over_time(cache, cpus(4)),
                                    torch.from_numpy(dec_h), HEADS, init_wgts_row=row)
    torch.testing.assert_close(got[0], want[0], atol=ATOL, rtol=0)
    torch.testing.assert_close(torch.cat(got[1].blocks, dim=-1), want[1], atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="time axis 16 not divisible by the sequence-"
                                         "parallel degree 3"):
        tseq.shard_cache_over_time(cache, cpus(3))


def _seq_hook(mesh):
    sharding = NamedSharding(mesh, P("data", "seq", None))
    return lambda enc_h: jax.lax.with_sharding_constraint(enc_h, sharding)


@pytest.mark.parametrize("data,seq,model", [(2, 2, 1), (1, 2, 2)],
                         ids=["data2-seq2", "data1-seq2-model2"])
def test_sequence_parallel_step_matches_jax(data, seq, model):
    """One train step with the attention's time axis on the seq devices (and
    the weights in column blocks at model 2) against the JAX CLI's route:
    the encoder output constrained to ``P("data", "seq", None)`` on a
    ``(data, seq)`` mesh, or on a ``(data, seq, model)`` mesh with the state
    placed for tensor parallelism."""
    params = jparams()
    b = batch()
    if model > 1:
        j_mesh = jmesh.make_mesh_3d(data, seq, model)
        grid = tmesh.make_mesh_3d(data, seq, model, devices=cpus(data * seq * model))
    else:
        j_mesh = jmesh.make_mesh_2d(data, seq, axis_names=("data", "seq"))
        grid = tmesh.make_mesh_2d(data, seq, axis_names=("data", "seq"),
                                  devices=cpus(data * seq))
    j_state, j_metrics = jax_mesh_step(params, b, j_mesh, enc_hook=_seq_hook(j_mesh),
                                       shard_state=model > 1)
    state, metrics = port_grid_step(params, b, grid)
    assert bool(state.params.sharded_names()) == (model > 1)
    assert_state_matches_jax(tmesh.unshard_train_state(state), j_state, j_metrics, metrics)


@pytest.mark.parametrize("parallel", [{"use": True, "sequence": 2, "data": 2},
                                      {"use": True, "sequence": 2, "data": 1, "model": 2}],
                         ids=["data2-seq2", "seq2-model2"])
def test_train_cli_with_sequence_parallelism(tmp_path, parallel):
    """The twin of the JAX ``test_train_cli_with_sequence_parallelism``: the
    ``train`` CLI with ``parallel.sequence`` (and ``model`` on a 3-D grid)
    against its plain run, two epochs, randomness quiesced."""
    from test_torch_dp_cli import _cli_config, _train
    from attention_based_e2e_asr_dnn_tpu_torch.tools import make_synthetic_data

    corpus = str(tmp_path / "corpus")
    make_synthetic_data.generate(corpus, n_train=16, n_dev=8, n_test=8, words_min=2,
                                 words_max=3, seed=1)
    runs = {}
    for name, par in (("plain", {"use": False}), ("seq", parallel)):
        runs[name] = _train(_cli_config(corpus, tmp_path / name, par, impl="scan", epochs=2))
    np.testing.assert_allclose(runs["seq"].train_history["loss"],
                               runs["plain"].train_history["loss"], rtol=2e-4)
    np.testing.assert_allclose(runs["seq"].dev_history["loss"],
                               runs["plain"].dev_history["loss"], rtol=2e-4)
