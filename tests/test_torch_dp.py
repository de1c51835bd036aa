"""PyTorch port, data parallelism (``parallel/``): the DP train and eval
steps of two gloo ranks on the CPU against the JAX package's shard_map steps
on two of conftest's virtual CPU devices, and against the port's own
one-process step; replication, the global NaN guard, a shard of padding,
``process_slice`` / ``shard_batch_fn`` and the per-rank loading helpers.

The ranks are processes that ``parallel.dp.spawn`` starts; their functions
live in ``tests/torch_dp_ranks.py``, which imports no JAX. The JAX side runs
here, in the test's process, and the ranks get numpy arrays: the same
parameters (``las_from_jax_params``), the same batch from a numpy seed, and
where the step is random each rank's own draws, replayed from the JAX keys
as the JAX step folds the shard index into them (``dp.py:86-88``).

Tolerances: the loss rtol 1e-5 and the parameters after a step atol 1e-4,
those of the JAX package's own DP tests (``tests/test_parallel.py``); the
attention key bias, whose gradient is rounding noise that Adam scales up to
steps of the order of lr, within 2 lr a step (as in
``tests/test_torch_train_las.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu.decoding import beam as jbeam
from attention_based_e2e_asr_dnn_tpu.models import las as jlas
from attention_based_e2e_asr_dnn_tpu.parallel import dp as jdp
from attention_based_e2e_asr_dnn_tpu.parallel import mesh as jmesh
from attention_based_e2e_asr_dnn_tpu.parallel import multihost as jmultihost
from attention_based_e2e_asr_dnn_tpu.training import optim as joptim
from attention_based_e2e_asr_dnn_tpu.training import steps as jsteps
from attention_based_e2e_asr_dnn_tpu_torch.data.specaug import SpecAugDraws
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.parallel import dp as tdp
from attention_based_e2e_asr_dnn_tpu_torch.parallel import mesh as tmesh
from attention_based_e2e_asr_dnn_tpu_torch.parallel import multihost as tmultihost
from attention_based_e2e_asr_dnn_tpu_torch.training import optim as toptim
from attention_based_e2e_asr_dnn_tpu_torch.training import steps as tsteps

import torch_dp_ranks as ranks
from test_torch_train_las import (
    CFG,
    LX,
    LY,
    NO_DROPOUT,
    OPT_CONFIGS,
    B,
    L,
    _amsgrad_state,
    _batch,
    _jax,
    _params,
    _port_cfg,
    replay_las_draws,
)

torch.set_num_threads(1)

N = 2                       # ranks, and virtual devices of the JAX mesh
CPU2 = ["cpu"] * N
TIMEOUT_S = 120.0           # a rank stuck in a collective fails the test
SPEC_TIME = 10
LR = 1e-3


def _spawn(fn, *args):
    return tdp.spawn(fn, N, args=args, devices=CPU2, timeout_s=TIMEOUT_S)


def _global_batch(ly=LY):
    x, y = _batch()
    y = y.copy()
    y[np.arange(L)[None, :] >= ly[:, None]] = 29
    return x, LX, y, np.asarray(ly, np.int32)


def _assert_params_close(got, want, n_steps, atol=1e-4):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(jax.tree.map(np.asarray, want))):
        if "key_map" in str(path) and "'b'" in str(path):
            np.testing.assert_allclose(a, b, atol=2 * LR * n_steps, err_msg=str(path))
            continue
        np.testing.assert_allclose(a, b, atol=atol, err_msg=str(path))


# ---------------------------------------------------------------------------
# The JAX shard_map step, and its draws replayed for each rank
# ---------------------------------------------------------------------------

def replay_dp_draws(state_rng, cfg, use_specaug):
    """Each shard's draws of one JAX DP step (``dp.py:85-91``): the state key
    split in three, the shard index folded into the SpecAugment and model
    keys, then the one-process step's draws at B/N rows."""
    _, aug_rng, model_rng = jax.random.split(state_rng, 3)
    out = []
    for idx in range(N):
        aug = jax.random.fold_in(aug_rng, idx)
        spec = None
        if use_specaug:
            def axis(k, param):
                k_w, k_s = jax.random.split(k)
                return (jax.random.uniform(k_w, (1,), minval=0.0, maxval=float(param)),
                        jax.random.uniform(k_s, (1,)))

            k_f, k_t = jax.random.split(aug)
            spec = SpecAugDraws(*(torch.from_numpy(np.array(a))
                                  for a in (*axis(k_f, 6), *axis(k_t, SPEC_TIME))))
        draws = replay_las_draws(jax.random.fold_in(model_rng, idx), cfg, B // N, L, spec)
        out.append(ranks.draws_to_numpy(draws))
    return out


def _jax_dp_steps(cfg, params, batch, tf_rates, use_specaug, accum_steps=1):
    """JAX DP steps on a 2-device mesh, ``accum_steps`` of them an update;
    (final state, metrics of each step, each step's replayed draws, the
    optimizer's start leaves)."""
    tx = joptim.build_optimizer("adamw", OPT_CONFIGS, grad_norm=5.0, accum_steps=accum_steps)

    def apply_fn(p, rng, x, lx, dec_y=None, tf_rate=1.0, init_force=False, train=False):
        return jlas.las_apply(p, cfg, rng, x, lx, dec_y, tf_rate, init_force, train)

    mesh = jmesh.make_mesh(N)
    step = jdp.make_dp_train_step(apply_fn, tx, mesh, accum_steps=accum_steps,
                                  use_specaug=use_specaug, specaug_time=SPEC_TIME, donate=False)
    state = jsteps.create_train_state(_jax(params), tx, jax.random.key(1))
    ams = _amsgrad_state(state.opt_state)
    start = (int(ams.count), *(jax.tree.map(np.asarray, t) for t in (ams.mu, ams.nu, ams.nu_max)))
    sharded = jmesh.shard_batch_fn(mesh)(batch)
    metrics, draws = [], []
    for tf_rate in tf_rates:
        draws.append(replay_dp_draws(state.rng, cfg, use_specaug))
        state, m, _ = step(state, *sharded, jnp.float32(tf_rate), jnp.float32(LR))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, draws, start


@pytest.mark.parametrize("random,accum", [(False, 1), (True, 1), (False, 2)],
                         ids=["deterministic", "replayed-draws", "deterministic-accu_grad-2"])
def test_dp_train_step_matches_jax_shard_map(random, accum):
    """Two gloo ranks against the JAX shard_map step on two virtual devices,
    scan tier there, the kernels' plain versions here, float32. Without
    randomness (dropout off, tf 1.0, no SpecAugment: ``test_parallel.py``'s
    setting), and with dropout, SpecAugment and tf 0.5, each rank's draws
    replayed from its folded JAX keys; and with ``accu_grad: 2``
    (``configs/rewriter.yml:13``): two steps, one update of the mean of
    their all-reduced gradients."""
    cfg = CFG if random else NO_DROPOUT
    tf_rates = [0.5, 0.5] if random else [1.0] * accum
    params = _params(cfg)
    batch = _global_batch()
    j_state, j_metrics, j_draws, start = _jax_dp_steps(cfg, params, batch, tf_rates, random,
                                                       accum)
    steps = [(tf, LR, d if random else None) for tf, d in zip(tf_rates, j_draws)]
    # accumulating, both sides start from their own fresh state (the optax
    # leaves hold no accumulator)
    out = _spawn(ranks.train_steps, params, _port_cfg(cfg), OPT_CONFIGS, batch, steps,
                 random, SPEC_TIME, 0, start if accum == 1 else None, None, 5.0, accum)
    for rank in out:
        for got, want in zip(rank["metrics"], j_metrics):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            assert got["n_tokens"] == want["n_tokens"] == float(LY.sum())
            assert got["finite"] and want["finite"]
        _assert_params_close(rank["params"], j_state.params, len(tf_rates))
    if random:  # the coins split the steps, so teacher forcing was live
        coins = j_draws[0][0][1][1:]
        assert (coins <= 0.5).any() and not (coins <= 0.5).all()


def _one_process_step(cfg, params, batch, n_steps=1, accum_steps=1):
    opt = toptim.build_optimizer("adamw", OPT_CONFIGS, grad_norm=5.0, accum_steps=accum_steps)
    t_cfg = _port_cfg(cfg)

    def apply_fn(p, x, lx, **kwargs):
        return tlas.las_apply(p, t_cfg, x, lx, **kwargs)

    step = tsteps.make_train_step(apply_fn, opt, accum_steps=accum_steps)
    state = tsteps.create_train_state(tlas.las_from_jax_params(params), opt, device="cpu")
    metrics = []
    for _ in range(n_steps):
        state, m, _ = step(state, *(torch.from_numpy(a) for a in batch), 1.0, LR)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("accum", [1, 2], ids=["accu_grad-1", "accu_grad-2"])
@pytest.mark.parametrize("ly", [np.full((B,), 7, np.int32), LY], ids=["equal", "unequal"])
def test_dp_step_matches_the_one_process_step(ly, accum):
    """Two ranks against the port's one-process ``make_train_step`` on the
    whole batch, two steps, with ``accu_grad`` 1 and 2
    (``configs/rewriter.yml:13``: the two steps' gradients accumulated into
    one update). With unequal token counts between the shards (16 and 19)
    an average over ranks, as ``DistributedDataParallel`` takes it, would
    give another loss; the global token mean does not."""
    params = _params(NO_DROPOUT)
    batch = _global_batch(ly)
    state, metrics = _one_process_step(NO_DROPOUT, params, batch, n_steps=2,
                                       accum_steps=accum)
    out = _spawn(ranks.train_steps, params, _port_cfg(NO_DROPOUT), OPT_CONFIGS, batch,
                 [(1.0, LR, None)] * 2, False, 200, 0, None, None, 5.0, accum)
    for rank in out:
        for got, want in zip(rank["metrics"], metrics):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
            assert got["n_tokens"] == want["n_tokens"] == float(ly.sum())
        _assert_params_close(rank["params"], tlas.las_to_jax_params(state.params), 2)
    if ly is LY and accum == 1:
        # the shards' own token means, averaged, differ from the global mean
        shard_means = []
        for rows in (slice(0, B // 2), slice(B // 2, B)):
            _, m = _one_process_step(NO_DROPOUT, params, tuple(a[rows] for a in batch))
            shard_means.append(m[0]["loss"])
        assert abs(np.mean(shard_means) - metrics[0]["loss"]) > 1e-3


def test_dp_ranks_stay_bit_identical():
    """Three steps with dropout, SpecAugment and tf 0.5 drawn from each
    rank's own generator: the ranks draw differently, and their parameters
    and optimizer states stay bit-equal."""
    params = _params(CFG)
    out = _spawn(ranks.train_steps, _params(CFG), _port_cfg(CFG), OPT_CONFIGS,
                 _global_batch(), [(0.5, LR, None)] * 3, True, SPEC_TIME, 7)
    a, b = out
    assert a["seed"] != b["seed"]
    assert len(a["leaves"]) == len(b["leaves"]) > len(list(tlas.las_from_jax_params(params).parameters()))
    for x, y in zip(a["leaves"], b["leaves"]):
        np.testing.assert_array_equal(x, y)
    assert a["metrics"] == b["metrics"] and all(m["finite"] for m in a["metrics"])


def test_dp_nan_guard_is_global():
    """A NaN in rank 0's rows only: both ranks see ``finite`` False and keep
    their parameters and optimizer state bit-equal to before the step (JAX
    ``test_parallel.py::test_dp_shard_map_nan_guard_is_global``)."""
    out = _spawn(ranks.train_steps, _params(NO_DROPOUT), _port_cfg(NO_DROPOUT), OPT_CONFIGS,
                 _global_batch(), [(1.0, LR, None)] * 2, False, 200, 0, None, [0])
    for rank in out:
        assert rank["metrics"][0]["finite"] and not rank["metrics"][1]["finite"]
        for x, y in zip(rank["leaves"], rank["before"]):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(out[0]["leaves"], out[1]["leaves"]):
        np.testing.assert_array_equal(x, y)


def test_a_shard_of_padding_adds_nothing():
    """Rank 1's rows are all padding (``ly = 0``, as the Trainer sets it on
    the repeat-padded rows of an epoch's last batch): the train step, the
    eval step and the eval beam step give the loss and the token count of
    rank 0's rows alone, as the one-process steps on the whole batch do."""
    ly = LY.copy()
    ly[B // 2:] = 0
    params = _params(NO_DROPOUT)
    batch = _global_batch(ly)
    state, metrics = _one_process_step(NO_DROPOUT, params, batch)
    out = _spawn(ranks.train_steps, params, _port_cfg(NO_DROPOUT), OPT_CONFIGS, batch,
                 [(1.0, LR, None)])
    for rank in out:
        np.testing.assert_allclose(rank["metrics"][0]["loss"], metrics[0]["loss"], rtol=1e-5)
        assert rank["metrics"][0]["n_tokens"] == float(LY[: B // 2].sum())
        _assert_params_close(rank["params"], tlas.las_to_jax_params(state.params), 1)

    t_cfg = _port_cfg(NO_DROPOUT)
    module = tlas.las_from_jax_params(params)
    tb = [torch.from_numpy(a) for a in batch]
    one_eval, _ = tsteps.make_eval_step(lambda p, x, lx: tlas.las_apply(p, t_cfg, x, lx))(
        module, *tb)
    from attention_based_e2e_asr_dnn_tpu_torch.decoding.beam import make_las_eval_beam_step

    one_beam, _ = make_las_eval_beam_step(t_cfg, 4)(module, *tb)
    for e_metrics, _, b_metrics, _ in _spawn(ranks.eval_steps, params, t_cfg, batch):
        for got, want in ((e_metrics, one_eval), (b_metrics, one_beam)):
            np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)
            assert got["n_tokens"] == float(want["n_tokens"])


def test_dp_eval_and_eval_beam_steps_match_jax():
    """The DP eval step and the eval beam step with ``mesh`` on two ranks
    against JAX's ``make_dp_eval_step`` and ``make_las_eval_beam_step(mesh=)``
    on a two-device mesh: the loss (rtol 1e-5) and the gathered ids."""
    params = _params(NO_DROPOUT)
    batch = _global_batch()

    def apply_fn(p, rng, x, lx, dec_y=None, tf_rate=1.0, init_force=False, train=False):
        return jlas.las_apply(p, NO_DROPOUT, rng, x, lx, dec_y, tf_rate, init_force, train)

    mesh = jmesh.make_mesh(N)
    sharded = jmesh.shard_batch_fn(mesh)(batch)
    j_eval, j_ids = jdp.make_dp_eval_step(apply_fn, mesh)(_jax(params), *sharded)
    j_beam, j_beam_ids = jbeam.make_las_eval_beam_step(NO_DROPOUT, 4, mesh=mesh)(
        _jax(params), *sharded)
    out = _spawn(ranks.eval_steps, params, _port_cfg(NO_DROPOUT), batch)
    for e_metrics, e_ids, b_metrics, b_ids in out:
        np.testing.assert_allclose(e_metrics["loss"], float(j_eval["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(e_ids, np.asarray(j_ids))
        np.testing.assert_allclose(b_metrics["loss"], float(j_beam["loss"]), rtol=1e-5)
        assert b_metrics["n_tokens"] == float(j_beam["n_tokens"])
        np.testing.assert_array_equal(b_ids, np.asarray(j_beam_ids))


# ---------------------------------------------------------------------------
# The mesh and the per-rank loading helpers
# ---------------------------------------------------------------------------

def _fake_mesh(rank, size=N):
    return tmesh.DataMesh(size, rank, torch.device("cpu"), "gloo")


def test_shard_batch_fn_and_process_slice_match_jax():
    """A rank's rows are the JAX shard of that index; a batch the mesh cannot
    split raises the JAX message, in both functions."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    lx = np.arange(8, dtype=np.int32)
    (xj, lxj) = jmesh.shard_batch_fn(jmesh.make_mesh(N))((x, lx))
    for rank in range(N):
        xt, lxt = tmesh.shard_batch_fn(_fake_mesh(rank))((x, lx))
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj.addressable_shards[rank].data))
        np.testing.assert_array_equal(lxt.numpy(), np.asarray(lxj.addressable_shards[rank].data))
        sl = tmultihost.process_slice(8, _fake_mesh(rank))
        assert (sl.start, sl.stop) == (rank * 4, rank * 4 + 4)
    # one process, as the JAX process count is here
    assert tmultihost.process_slice(8) == jmultihost.process_slice(8) == slice(0, 8)
    bad = np.zeros((5, 3), np.float32)
    with pytest.raises(ValueError) as j_err:
        jmesh.shard_batch_fn(jmesh.make_mesh(N))((bad,))
    with pytest.raises(ValueError) as t_err:
        tmesh.shard_batch_fn(_fake_mesh(0))((bad,))
    assert str(t_err.value) == str(j_err.value) == \
        "batch dim 5 not divisible by data-parallel degree 2"
    with pytest.raises(ValueError, match="global batch 5 not divisible by process count 2"):
        tmultihost.process_slice(5, _fake_mesh(1))


def test_mesh_refusals_and_the_backend_rule():
    assert tmesh.choose_backend(["cpu", "cpu"]) == "gloo"
    assert tmesh.choose_backend(["cuda:0", "cuda:0"]) == "gloo"   # ranks that share a card
    assert tmesh.choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"requested {have + 1} devices but only {have} present"):
        tmesh.make_mesh(have + 1)
    with pytest.raises(ValueError, match=f"requested {have + 1} devices but only {have} present"):
        tdp.spawn(ranks.multihost_sum, have + 1, args=(np.zeros(2),))
    with pytest.raises(ValueError, match="outside a process group"):
        tmesh.make_mesh(2, device="cpu")


def test_multihost_helpers_in_two_gloo_processes():
    """The counterpart of ``tests/test_multihost_spawn.py``: two processes
    over loopback, each loading only its ``process_slice`` of the global
    batch; the all-reduced sum of the slices is the global sum."""
    glob = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    out = _spawn(ranks.multihost_sum, glob)
    assert [o[:2] for o in out] == [(0, 4), (4, 8)]
    assert all(o[2] == float(glob.sum()) and o[3] == "cpu" for o in out)


def test_one_rank_mesh_in_process_and_spawn_reports_a_failed_rank():
    """``make_mesh(1)`` outside a group makes a one-rank group here;
    ``spawn`` raises a rank's exception in the parent with its traceback."""
    mesh = tmesh.make_mesh(1, device="cpu")
    try:
        assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "gloo")
        assert tmesh.make_mesh().rank == 0        # joins the group it is in
        t = torch.ones(3)
        assert torch.equal(tdp.all_reduce_sum(t, mesh), torch.ones(3))
        np.testing.assert_array_equal(tdp.gather_rows(mesh, torch.arange(4)), np.arange(4))
    finally:
        tmesh.close_mesh()
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed:(.|\n)*ValueError: global batch 5"):
        _spawn(ranks.multihost_sum, np.zeros((5, 3), np.float32))


def test_fold_seed_gives_each_rank_its_own_stream():
    seeds = {tdp.fold_seed(s, r) for s in (0, 1, 2**40) for r in range(8)}
    assert len(seeds) == 24 and all(0 <= s < 2**63 for s in seeds)
    state = tsteps.create_train_state(tlas.las_from_jax_params(_params(NO_DROPOUT)),
                                      toptim.build_optimizer("sgd", {"lr": 0.1}), seed=5,
                                      device="cpu")
    g = tdp.shard_generator(state, _fake_mesh(1))
    assert g is tdp.shard_generator(state, _fake_mesh(1))   # made once
    assert g.initial_seed() == tdp.fold_seed(5, 1)
    assert dataclasses.is_dataclass(_fake_mesh(0))
