"""PyTorch port, tensor parallelism over a device grid of one controller
(``parallel/mesh.py``, ``parallel/grid.py``) against the JAX package's 2-D
mesh on conftest's virtual CPU devices: the grids' shapes and refusals, the
set of column-sharded leaves, the per-device bytes, one train step at data
2 x model 2 (and data 1 x model 2), the Trainer over two epochs against the
one-device Trainer, and the ``lmtrain`` CLI with ``model: 2`` against the JAX
CLI. The port's grids are ``["cpu"] * n``: the same code as on cards, every
``.to`` a no-op.

Randomness is quiesced (tf_rate 1, dropout 0, no SpecAugment), as the JAX
package's own parallel tests run. Tolerances: the loss, the gradient norm
and the first Adam moment (after one AdamW step it is (1 - b1) times the
clipped gradient, so it holds the gradients) within float32's 2e-5; each
parameter's sum within 1e-4 (after one step every parameter moves by about
lr whatever its gradient, so the parameters alone would prove little);
epoch losses within 2e-4."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu.models import las as jlas
from attention_based_e2e_asr_dnn_tpu.parallel import mesh as jmesh
from attention_based_e2e_asr_dnn_tpu.training import optim as joptim
from attention_based_e2e_asr_dnn_tpu.training import steps as jsteps
from attention_based_e2e_asr_dnn_tpu_torch import train as ttrain
from attention_based_e2e_asr_dnn_tpu_torch.config import Config
from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher
from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import AsrTrainDevDataset
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.parallel import grid as tgrid
from attention_based_e2e_asr_dnn_tpu_torch.parallel import mesh as tmesh
from attention_based_e2e_asr_dnn_tpu_torch.training import optim as toptim
from attention_based_e2e_asr_dnn_tpu_torch.training import steps as tsteps
from attention_based_e2e_asr_dnn_tpu_torch.training.trainer import Trainer

from test_torch_trainer import TRN, _batchers, corpus  # noqa: F401 - the fixture
from test_torch_train_las import _amsgrad_state

torch.set_num_threads(1)

ATOL = 2e-5
SUM_ATOL = 1e-4
LR = 1e-3
OPT = {"lr": LR, "weight_decay": 1e-6, "amsgrad": True}
LISTENER = dict(input_dim=15, uniform_hid_dim=16, lstm_layers=1, plstm_layers=1,
                init_dropout=0.0, mid_dropout=0.0, final_dropout=0.0)
SPELLER = dict(att_proj_dim=8, att_heads=2, att_dropout=0.0, dec_emb_dim=16,
               dec_emb_dropout=0.0, dec_lstm_hid_dim=16, dec_lstm_out_dim=8,
               dec_lstm_dropout=0.0, CHR_MAX_STEPS=12)
JCFG = jlas.las_config_from_dicts(LISTENER, SPELLER)
TCFG = tlas.las_config_from_dicts(LISTENER, SPELLER)


def cpus(n):
    return ["cpu"] * n


def jparams(seed=0):
    params = jax.tree.map(np.asarray, jlas.las_init(jax.random.key(seed), JCFG))
    rng = np.random.default_rng(seed)
    for key in ("init_h1", "init_c1", "init_h2", "init_c2"):
        params["speller"][key] = rng.uniform(-0.5, 0.5, params["speller"][key].shape
                                             ).astype(np.float32)
    return params


def batch(b=8, t=32, label=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, 15)).astype(np.float32)
    lx = rng.integers(t // 2, t + 1, size=(b,)).astype(np.int32)
    y = rng.integers(0, 30, size=(b, label)).astype(np.int32)
    ly = rng.integers(2, label + 1, size=(b,)).astype(np.int32)
    return x, lx, y, ly


def jax_apply(cfg=JCFG, enc_hook=None):
    def apply_fn(p, rng, x, lx, dec_y=None, tf_rate=1.0, init_force=False, train=False):
        return jlas.las_apply(p, cfg, rng, x, lx, dec_y, tf_rate, init_force, train,
                              enc_hook=enc_hook)

    return apply_fn


def jax_mesh_step(params, b, mesh=None, grad_norm=5.0, enc_hook=None, n_steps=1,
                  shard_state=True):
    """``n_steps`` JAX train steps, the state placed on ``mesh`` (None: one
    device): (state, metrics of the last step)."""
    tx = joptim.build_optimizer("adamw", OPT, grad_norm=grad_norm)
    state = jsteps.create_train_state(jax.tree.map(jnp.asarray, params), tx,
                                      jax.random.key(1))
    if mesh is not None and shard_state:
        state = jmesh.shard_train_state(state, mesh)
    step = jsteps.make_train_step(jax_apply(enc_hook=enc_hook), tx, use_specaug=False,
                                  donate=False)
    arrays = jmesh.shard_batch_fn(mesh)(b) if mesh is not None else b
    for _ in range(n_steps):
        state, metrics, _ = step(state, *arrays, jnp.float32(1.0), jnp.float32(LR))
    return state, {k: float(v) for k, v in metrics.items()}


def port_state(params, grad_norm=5.0, accum=1):
    opt = toptim.build_optimizer("adamw", OPT, grad_norm=grad_norm, accum_steps=accum)
    return opt, tsteps.create_train_state(tlas.las_from_jax_params(params), opt, seed=1,
                                          device="cpu")


def port_grid_step(params, b, grid, n_steps=1):
    opt, state = port_state(params)
    state = tmesh.shard_train_state(state, grid)
    step = tgrid.make_grid_train_step(ttrain.make_las_apply_factory(TCFG)(1.0), opt, grid)
    tensors = [torch.from_numpy(a) for a in b]
    for _ in range(n_steps):
        state, metrics, _ = step(state, *tensors, 1.0, LR)
    return state, {k: float(v) for k, v in metrics.items()}


def assert_state_matches_jax(whole, j_state, j_metrics, metrics, names=("mu", "nu_max")):
    """Loss, gradient norm, the Adam moments within ``ATOL``; every
    parameter's sum within ``SUM_ATOL``."""
    np.testing.assert_allclose(metrics["loss"], j_metrics["loss"], atol=ATOL)
    np.testing.assert_allclose(metrics["grad_norm"], j_metrics["grad_norm"], atol=ATOL)
    ours = tlas.las_to_jax_params(whole.params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                            jax.tree.leaves(jax.tree.map(np.asarray, j_state.params))):
        np.testing.assert_allclose(a.sum(), b.sum(), atol=SUM_ATOL, err_msg=str(path))
    ams = _amsgrad_state(j_state.opt_state)
    got = toptim.opt_state_to_optax(whole.params, whole.opt_state)
    assert got["count"] == int(ams.count)
    for name in names:
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got[name]),
                                jax.tree.leaves(jax.tree.map(np.asarray, getattr(ams, name)))):
            np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"{name} {path}")


def dotted(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


# ---------------------------------------------------------------------------
# Grids: shapes and refusals
# ---------------------------------------------------------------------------

GRIDS = {
    "2d-data-none": ("2d", dict(data=None, model=2)),
    "2d-2x2": ("2d", dict(data=2, model=2)),
    "2d-8x1": ("2d", dict(data=None, model=1)),
    "2d-indivisible": ("2d", dict(data=None, model=3)),
    "2d-too-many": ("2d", dict(data=3, model=3)),
    "2d-model-0": ("2d", dict(data=None, model=0)),
    "3d-data-none": ("3d", dict(data=None, seq=2, model=2)),
    "3d-1x2x2": ("3d", dict(data=1, seq=2, model=2)),
    "3d-indivisible": ("3d", dict(data=None, seq=3, model=1)),
    "3d-too-many": ("3d", dict(data=5, seq=2, model=1)),
    "3d-seq-0": ("3d", dict(data=None, seq=0, model=1)),
}


@pytest.mark.parametrize("case", list(GRIDS))
def test_grid_shapes_and_refusals_match_jax(case):
    """``make_mesh_2d`` / ``make_mesh_3d`` over eight devices: the JAX
    mesh's axis sizes and names, or its ValueError word for word."""
    kind, kw = GRIDS[case]
    j_fn = jmesh.make_mesh_2d if kind == "2d" else jmesh.make_mesh_3d
    t_fn = tmesh.make_mesh_2d if kind == "2d" else tmesh.make_mesh_3d
    try:
        want = j_fn(**kw)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            t_fn(**kw, devices=cpus(8))
        assert str(got.value) == str(exc)
        return
    grid = t_fn(**kw, devices=cpus(8))
    assert grid.shape == dict(want.shape) and grid.axis_names == tuple(want.axis_names)
    assert grid.size == want.size


def test_grid_row_devices_and_the_batch_refusal():
    """A grid's rows, model and seq devices lie where the JAX axes put
    them; ``shard_batch_fn`` of a grid refuses rows its data axis cannot
    split with the JAX message."""
    devs = [torch.device("cpu", i) for i in range(8)]
    g = tmesh.make_mesh_3d(2, 2, 2, devices=devs)
    assert g.gather_device(1) == devs[4]
    assert g.model_devices(1) == devs[4:6] and g.seq_devices(1) == [devs[4], devs[6]]
    g2 = tmesh.make_mesh_2d(2, 2, devices=devs[:4])
    assert g2.model_devices(1) == devs[2:4] and g2.seq_devices(1) == [devs[2]]
    x = np.zeros((6, 4), np.float32)
    with pytest.raises(ValueError) as want:
        jmesh.shard_batch_fn(jmesh.make_mesh_2d(4, 2))((x,))
    with pytest.raises(ValueError) as got:
        tmesh.shard_batch_fn(tmesh.make_mesh_2d(4, 2, devices=cpus(8)))((x,))
    assert str(got.value) == str(want.value)
    assert tmesh.shard_batch_fn(g2)((x[:4],))[0].shape == (4, 4)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def test_placement_shards_the_jax_leaves():
    """The set of column-sharded parameters and optimizer moments equals the
    JAX ``model_parallel_placement``'s on the same tree at model 2; each
    block holds half the columns, and its moments have its shape and
    device."""
    params = jparams()
    mesh = jmesh.make_mesh_2d(data=4, model=2)
    tx = joptim.build_optimizer("adamw", OPT, grad_norm=5.0)
    j_state = jmesh.shard_train_state(
        jsteps.create_train_state(jax.tree.map(jnp.asarray, params), tx, jax.random.key(1)),
        mesh)
    want = {dotted(p) for p, leaf in jax.tree_util.tree_leaves_with_path(j_state.params)
            if not leaf.sharding.is_fully_replicated}
    grid = tmesh.make_mesh_2d(4, 2, devices=cpus(8))
    _, state = port_state(params)
    state = tmesh.shard_train_state(state, grid)
    assert set(state.params.sharded_names()) == want
    assert {n.split(".")[-1] for n in want} == {"w_ih", "w_hh", "w", "char_emb"}
    flat = state.params.tensors()
    pos = 0
    for name in state.params.names:
        leaf = state.params.leaves[name]
        blocks = leaf if isinstance(leaf, list) else [leaf]
        for block in blocks:
            mu = state.opt_state.mu[pos]
            assert mu.shape == block.shape and mu.device == block.device
            if isinstance(leaf, list):
                assert block.shape[1] == toptim._tree_get(params, name).shape[1] // 2
            pos += 1
    assert pos == len(flat)


def test_tp_placement_reduces_per_device_bytes():
    """The twin of the JAX ``test_tp_placement_reduces_per_device_bytes``:
    the gate matrices, the attention maps and ``char_emb`` land in column
    blocks, and one device's parameter bytes fall well below the whole
    tree's at model 2 (to exactly the whole at model 1)."""
    params = jparams()
    total = sum(a.nbytes for a in jax.tree.leaves(params))
    _, state = port_state(params)
    one = tmesh.GridParams(state.params, tmesh.make_mesh_2d(4, 1, devices=cpus(4)))
    two = tmesh.GridParams(state.params, tmesh.make_mesh_2d(4, 2, devices=cpus(8)))
    assert one.sharded_names() == [] and one.per_device_bytes() == total
    tags = {n.split(".")[-2] if n.endswith(".w") else n.split(".")[-1]
            for n in two.sharded_names()}
    assert {"w_ih", "w_hh", "key_map", "value_map", "query_map", "char_emb"} <= tags
    assert two.per_device_bytes() < 0.8 * total


def test_replicate_params_puts_a_copy_on_each_data_row():
    """``replicate_params``: the module on each data row's gather device,
    the module itself where it already sits there, equal values."""
    module = tlas.las_from_jax_params(jparams())
    copies = tmesh.replicate_params(module, tmesh.make_mesh_2d(3, 2, devices=cpus(6)))
    assert len(copies) == 3 and all(c is module for c in copies)
    devs = [torch.device("cpu", i) for i in range(4)]
    grid = tmesh.make_mesh_2d(2, 2, devices=devs)
    assert [grid.gather_device(r) for r in range(2)] == [devs[0], devs[2]]


# ---------------------------------------------------------------------------
# One train step against the JAX 2-D mesh step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,model", [(2, 2), (1, 2)], ids=["data2-model2", "data1-model2"])
def test_tp_step_matches_the_jax_2d_mesh_step(data, model):
    params = jparams()
    b = batch()
    j_state, j_metrics = jax_mesh_step(params, b, jmesh.make_mesh_2d(data, model))
    state, metrics = port_grid_step(params, b, tmesh.make_mesh_2d(data, model,
                                                                  devices=cpus(data * model)))
    assert_state_matches_jax(tmesh.unshard_train_state(state), j_state, j_metrics, metrics)


def test_tp_step_round_trips_to_one_device():
    """``unshard_train_state`` of a placed state is the state it was placed
    from, and a sharded gradient step equals the one-device step of the
    port (the same function, the products cut into column blocks)."""
    params = jparams()
    b = batch(seed=1)
    opt, one = port_state(params)
    placed = tmesh.shard_train_state(port_state(params)[1],
                                     tmesh.make_mesh_2d(2, 2, devices=cpus(4)))
    back = tmesh.unshard_train_state(placed)
    for p, q in zip(back.params.parameters(), one.params.parameters()):
        assert torch.equal(p, q)
    step = tsteps.make_train_step(ttrain.make_las_apply_factory(TCFG)(1.0), opt)
    one, m_one, _ = step(one, *(torch.from_numpy(a) for a in b), 1.0, LR)
    state, m = port_grid_step(params, b, tmesh.make_mesh_2d(2, 2, devices=cpus(4)))
    whole = tmesh.unshard_train_state(state)
    assert abs(m["loss"] - float(m_one["loss"])) <= ATOL
    for a, c in zip(whole.opt_state.mu, one.opt_state.mu):
        torch.testing.assert_close(a, c, atol=ATOL, rtol=0)


@pytest.mark.parametrize("route", ["lstm_layer", "lstm_layer_remat", "fused_speller",
                                   "grid_step"])
def test_kernel_tiers_refuse_a_sharded_weight(route):
    """A column-sharded weight takes the plain loops (the same output as the
    whole weight) and never a kernel: the LSTM kernels' route, the fused
    decode and a grid step of a ``pallas`` config raise the JAX CLIs'
    tensor-parallel ``ValueError`` on CPU tensors too, where the kernels'
    wrappers would otherwise run their plain versions."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm as tlstm

    params = jparams()
    _, state = port_state(params)
    grid = tmesh.make_mesh_2d(1, 2, devices=cpus(2))
    placed = tmesh.GridParams(state.params, grid)
    tree = placed.view(0)
    layer = tree["listener"]["base"][0]
    whole = placed.whole_tree()["listener"]["base"][0]
    x, lx = torch.randn(2, 8, 15, requires_grad=True), torch.tensor([8, 5])
    torch.testing.assert_close(tlstm._layer_apply(layer, x, lx, True, "scan"),
                               tlstm._layer_apply(whole, x, lx, True, "scan"),
                               atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="column-sharded weight .tensor parallelism. "
                                         "requires the scan implementations"):
        if route.startswith("lstm_layer"):
            tlstm._layer_apply(layer, x, lx, True, "pallas", remat=route.endswith("remat"))
        elif route == "fused_speller":
            cfg = tlas.las_config_from_dicts(LISTENER, {**SPELLER, "decoder_impl": "pallas"})
            tlas.speller_apply(tree["speller"], cfg.speller, torch.randn(2, 4, 32),
                               torch.tensor([4, 3]))
        else:
            cfg = tlas.las_config_from_dicts({**LISTENER, "lstm_impl": "pallas"}, SPELLER)
            opt, state = port_state(params)
            step = tgrid.make_grid_train_step(ttrain.make_las_apply_factory(cfg)(1.0), opt,
                                              grid)
            step(tmesh.shard_train_state(state, grid),
                 *(torch.from_numpy(a) for a in batch()), 1.0, LR)


# ---------------------------------------------------------------------------
# The Trainer over a grid
# ---------------------------------------------------------------------------

SCAN_TRN = {**TRN, "epochs": 2}


def _scan_trainer(corpus, folder, **kwargs):
    trn, dev = _batchers(corpus, AsrTrainDevDataset, BucketBatcher)
    cfg = tlas.las_config_from_dicts({**LISTENER, "uniform_hid_dim": 8},
                                     {**SPELLER, "att_heads": 1, "dec_lstm_hid_dim": 8,
                                      "CHR_MAX_STEPS": 40})
    return Trainer(init_fn=lambda g: tlas.las_init(cfg, g),
                   make_apply=ttrain.make_las_apply_factory(cfg), trn_batcher=trn,
                   dev_batcher=dev, trncfgs=Config(SCAN_TRN), saving_dir=str(folder),
                   milestone_dir=str(folder / "milestones"), sos_idx=0, eos_idx=29,
                   device="cpu", **kwargs)


def test_2d_grid_trainer_epochs_match_single_device(corpus, tmp_path):  # noqa: F811
    """The twin of the JAX ``test_2d_mesh_trainer_epochs_match_single_device``:
    two full epochs on a (4, 2) grid give the one-device Trainer's losses,
    with the gate matrices in halves; the checkpoint it writes is whole and
    resumes in the one-device Trainer."""
    single = _scan_trainer(corpus, tmp_path / "single")
    single.train_eval(2)
    grid = tmesh.make_mesh_2d(4, 2, devices=cpus(8))
    tp = _scan_trainer(corpus, tmp_path / "grid", shard_batch=tmesh.shard_batch_fn(grid),
                       shard_state=lambda s: tmesh.shard_train_state(s, grid))
    gate = tp.state.params.leaves["listener.base.0.fwd.w_ih"]
    assert [b.shape[1] for b in gate] == [16, 16]
    tp.train_eval(2)
    np.testing.assert_allclose(tp.train_history["loss"], single.train_history["loss"],
                               rtol=2e-4)
    np.testing.assert_allclose(tp.dev_history["loss"], single.dev_history["loss"], rtol=2e-4)
    ckpt = os.path.join(tp.saving_dir, "ckpts", "last.ckpt")
    tp.save(ckpt)
    resumed = _scan_trainer(corpus, tmp_path / "resumed")
    resumed.load(ckpt)
    assert resumed.epoch == tp.epoch and int(resumed.state.opt_state.count) == tp.batch
    for p, q in zip(resumed.state.params.parameters(), tp.whole_params().parameters()):
        assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# lmtrain with model: 2
# ---------------------------------------------------------------------------

def test_lmtrain_tensor_parallel_matches_the_jax_cli(tmp_path):
    """``lmtrain`` with ``parallel: {use: true, model: 2, data: 2}`` in both
    packages from the same parameters, on the scan loops: the same epoch
    losses and dev LD, and the port's Rewriter placed in column blocks by
    the LAS rule."""
    from test_torch_lmtrain import LOSS_TOL, _config, _corpus, _params, _run

    corpus_ = _corpus(str(tmp_path / "c"))
    params = _params()
    par = {"use": True, "model": 2, "data": 2}
    out = {}
    for side in ("jax", "port"):
        cfg = _config(corpus_, str(tmp_path / side), parallel=par, epochs=2)
        out[side] = _run(side, cfg, params)
    j, t = out["jax"], out["port"]
    np.testing.assert_allclose(t.train_history["loss"], j.train_history["loss"], **LOSS_TOL)
    np.testing.assert_allclose(t.dev_history["loss"], j.dev_history["loss"], **LOSS_TOL)
    assert t.dev_history["ld"] == pytest.approx(j.dev_history["ld"], abs=1e-6)
    sharded = t.state.params.sharded_names()
    assert "decoder.char_emb" in sharded and "encoder.0.fwd.w_hh" in sharded
