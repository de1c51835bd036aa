"""PyTorch port, pipeline parallelism (``parallel/pipeline.py``): the
two-stage listener | speller step against the JAX pipeline step on
conftest's virtual CPU devices, at 1, 2 and 4 microbatches, with the global
clip engaged, with gradient accumulation, with data parallelism in each
stage and with data x tensor parallelism in each stage; the NaN guard as a
true no-op; the stages on their devices; the Trainer's refusals; and the
``train`` CLI with ``parallel.pipeline`` against its plain run, resumed
across stage layouts and across modes.

Randomness is quiesced (tf_rate 1, dropout 0, no SpecAugment), where the
pipeline equals the one-device step. Tolerances as in
``tests/test_torch_tp.py``: loss, gradient norm and each stage's first and
amsgrad moments within 2e-5, parameter sums within 1e-4."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu.parallel import pipeline as jpipe
from attention_based_e2e_asr_dnn_tpu.training import optim as joptim
from attention_based_e2e_asr_dnn_tpu_torch.config import Config
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.parallel import mesh as tmesh
from attention_based_e2e_asr_dnn_tpu_torch.parallel import pipeline as tpipe
from attention_based_e2e_asr_dnn_tpu_torch.training import checkpoints as tckpt
from attention_based_e2e_asr_dnn_tpu_torch.training import optim as toptim
from attention_based_e2e_asr_dnn_tpu_torch.training.trainer import Trainer

from test_torch_tp import ATOL, JCFG, LR, OPT, SUM_ATOL, TCFG, batch, cpus, jparams
from test_torch_train_las import _amsgrad_state

torch.set_num_threads(1)


def _jax_pipeline(params, batches, n_mb, dp=1, tp=1, grad_norm=5.0, accum=1):
    tx = joptim.build_optimizer("adamw", OPT, grad_norm=1e30)
    devices = jax.devices()[:2 * dp * tp]
    state = jpipe.init_pipeline_state(jax.tree.map(jnp.asarray, params), tx,
                                      jax.random.key(1), devices=devices, dp=dp, tp=tp)
    step = jpipe.make_pipeline_train_step(JCFG, tx, devices=devices, n_microbatches=n_mb,
                                          grad_norm=grad_norm, accum_steps=accum, dp=dp,
                                          tp=tp)
    for b in batches:
        state, metrics = step(state, *b, jnp.float32(1.0), jnp.float32(LR))
    return state, {k: float(v) for k, v in metrics.items()}


def _port_pipeline(params, batches, n_mb, dp=1, tp=1, grad_norm=5.0, accum=1, devices=None):
    opt = toptim.build_optimizer("adamw", OPT, grad_norm=1e30)
    devices = devices or cpus(2 * dp * tp)
    state = tpipe.init_pipeline_state(tlas.las_from_jax_params(params), opt, 1, devices,
                                      dp=dp, tp=tp)
    step = tpipe.make_pipeline_train_step(TCFG, opt, devices, n_mb, grad_norm=grad_norm,
                                          accum_steps=accum, dp=dp, tp=tp)
    for b in batches:
        state, metrics = step(state, *(torch.from_numpy(a) for a in b), 1.0, LR)
    return state, {k: float(v) for k, v in metrics.items()}


def _assert_pipeline_matches(state, metrics, j_state, j_metrics):
    np.testing.assert_allclose(metrics["loss"], j_metrics["loss"], atol=ATOL)
    np.testing.assert_allclose(metrics["grad_norm"], j_metrics["grad_norm"], atol=ATOL)
    whole = state.whole_params("cpu")
    for name, gp, opt, j_params, j_opt in (
            ("listener", state.params_listener, state.opt_listener, j_state.params_listener,
             j_state.opt_listener),
            ("speller", state.params_speller, state.opt_speller, j_state.params_speller,
             j_state.opt_speller)):
        module = whole[name]
        ours = tlas._tree_to_numpy(module)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                                jax.tree.leaves(jax.tree.map(np.asarray, j_params))):
            np.testing.assert_allclose(a.sum(), b.sum(), atol=SUM_ATOL, err_msg=f"{name} {path}")
        got = toptim.opt_state_to_optax(module, tmesh.gather_opt_state(gp, opt, "cpu"))
        ams = _amsgrad_state(j_opt)
        assert got["count"] == int(ams.count)
        for field in ("mu", "nu_max"):
            for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got[field]),
                                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                                 getattr(ams, field)))):
                np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"{name} {field} {path}")


@pytest.mark.parametrize("n_microbatches", [1, 2, 4])
def test_pipeline_matches_jax(n_microbatches):
    params = jparams()
    b = [batch()]
    j = _jax_pipeline(params, b, n_microbatches)
    _assert_pipeline_matches(*_port_pipeline(params, b, n_microbatches), *j)


def test_pipeline_global_clip_matches_jax():
    """A clip low enough to engage: the cross-stage global norm scales both
    stages alike, as the JAX step does."""
    params = jparams()
    b = [batch(seed=3)]
    j = _jax_pipeline(params, b, 2, grad_norm=0.05)
    state, metrics = _port_pipeline(params, b, 2, grad_norm=0.05)
    assert metrics["grad_norm"] > 0.05
    _assert_pipeline_matches(state, metrics, *j)


def test_pipeline_accu_grad_matches_jax():
    """``accu_grad`` 2 inside the step: the first call stashes the
    accumulators and leaves the parameters alone, the second updates on the
    window's mean, clipped after accumulating."""
    params = jparams()
    batches = [batch(seed=s) for s in (0, 1)]
    j = _jax_pipeline(params, batches, 2, accum=2)
    state, _ = _port_pipeline(params, batches[:1], 2, accum=2)
    assert state.acc_listener is not None and state.acc_count == 1
    before = tlas._tree_to_numpy(state.whole_params("cpu"))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(before),
                            jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    state, metrics = _port_pipeline(params, batches, 2, accum=2)
    assert state.acc_listener is None and state.acc_count == 0
    _assert_pipeline_matches(state, metrics, *j)


def test_pipeline_nan_guard_is_a_true_noop():
    """A non-finite batch leaves both stages' parameters and optimizer
    states as they were, the count included."""
    params = jparams()
    x, lx, y, ly = batch()
    x = x.copy()
    x[0, 0, 0] = np.inf
    state, metrics = _port_pipeline(params, [(x, lx, y, ly)], 2)
    assert not metrics["finite"]
    after = tlas._tree_to_numpy(state.whole_params("cpu"))
    for a, b in zip(jax.tree.leaves(after), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert int(state.opt_listener.count) == 0 and int(state.opt_speller.count) == 0
    assert all(float(m.abs().sum()) == 0.0 for m in state.opt_speller.mu)


def test_pipeline_stages_live_on_their_devices():
    """The listener on stage 0's group, the speller on stage 1's (with tp 2
    in column blocks); two steps keep the placement."""
    devices = [torch.device("cpu", i) for i in range(8)]
    params = jparams()
    state, metrics = _port_pipeline(params, [batch(), batch(seed=2)], 2, dp=2, tp=2,
                                    devices=devices)
    assert np.isfinite(metrics["loss"])
    assert list(state.params_listener.grid.devices.reshape(-1)) == devices[:4]
    assert list(state.params_speller.grid.devices.reshape(-1)) == devices[4:]
    blocks = state.params_listener.leaves["base.0.fwd.w_hh"]
    assert [b.shape[1] for b in blocks] == [32, 32]
    with pytest.raises(ValueError, match=r"pipeline x \(dp=2 x tp=2\) needs 2\*dp\*tp = 8 "
                                         r"devices, got 4"):
        tpipe.make_pipeline_train_step(TCFG, toptim.build_optimizer("adamw", OPT), cpus(4),
                                       dp=2, tp=2)


def test_pipeline_dp_matches_jax():
    """PP x DP: each stage over two devices, a microbatch's rows split
    between them; an indivisible microbatch raises the JAX message."""
    params = jparams()
    b = [batch()]
    j = _jax_pipeline(params, b, 2, dp=2)
    state, metrics = _port_pipeline(params, b, 2, dp=2)
    _assert_pipeline_matches(state, metrics, *j)
    step = tpipe.make_pipeline_train_step(TCFG, toptim.build_optimizer("adamw", OPT, 1e30),
                                          cpus(4), 2, dp=2)
    x, lx, y, ly = (torch.from_numpy(a[:6]) for a in b[0])
    with pytest.raises(ValueError, match="microbatch 3 not divisible by dp=2"):
        step(state, x, lx, y, ly, 1.0, LR)
    with pytest.raises(ValueError, match="batch 6 not divisible by 4 microbatches"):
        tpipe.make_pipeline_train_step(TCFG, toptim.build_optimizer("adamw", OPT, 1e30),
                                       cpus(4), 4, dp=2)(state, x, lx, y, ly, 1.0, LR)


def test_pipeline_dp_tp_matches_jax():
    """PP x DP x TP: each stage over a (2, 2) group, its weights in column
    blocks, against the JAX step on eight devices."""
    params = jparams()
    b = [batch()]
    j = _jax_pipeline(params, b, 2, dp=2, tp=2)
    state, metrics = _port_pipeline(params, b, 2, dp=2, tp=2)
    assert state.params_speller.sharded_names()
    _assert_pipeline_matches(state, metrics, *j)


# ---------------------------------------------------------------------------
# The Trainer and the train CLI
# ---------------------------------------------------------------------------

PIPE_TRN = {"seed": 3, "epochs": 1, "batch_size": 8, "accu_grad": 1, "grad_norm": 5.0,
            "init_force": False, "tf_rate": 1.0, "use_specaug": False,
            "optimizer": {"name": "adamw", "configs": {"lr": 1e-3}}}


@pytest.mark.parametrize("extra,match", [
    ({"init_force": True}, "pipeline parallelism does not support init_force"),
    ({"dropout_scheduler": {"use": True, "configs": {1: 0.5}}},
     "pipeline parallelism does not support the dropout scheduler"),
    (None, "dp_mesh .* and pipeline are mutually exclusive"),
], ids=["init_force", "dropout_scheduler", "dp_mesh"])
def test_trainer_pipeline_refusals(tmp_path, extra, match):
    pipeline = {"cfg": TCFG, "n_microbatches": 2, "devices": cpus(2)}
    kwargs = {"dp_mesh": object()} if extra is None else {}
    with pytest.raises(ValueError, match=match):
        Trainer(init_fn=lambda g: tlas.las_init(TCFG, g), make_apply=None, trn_batcher=None,
                dev_batcher=None, trncfgs=Config({**PIPE_TRN, **(extra or {})}),
                saving_dir=str(tmp_path), device="cpu", pipeline=pipeline, **kwargs)


@pytest.fixture(scope="module")
def cli_corpus(tmp_path_factory):
    from attention_based_e2e_asr_dnn_tpu_torch.tools import make_synthetic_data

    root = str(tmp_path_factory.mktemp("pp-corpus"))
    make_synthetic_data.generate(root, n_train=16, n_dev=8, n_test=8, words_min=2,
                                 words_max=3, seed=1)
    return root


@pytest.fixture(scope="module")
def plain_run(cli_corpus, tmp_path_factory):
    from test_torch_dp_cli import _cli_config, _train

    return _train(_cli_config(cli_corpus, tmp_path_factory.mktemp("plain"), {"use": False},
                              impl="scan", epochs=2))


@pytest.mark.parametrize("pp_dp,pp_tp", [(1, 1), (2, 1), (1, 2)])
def test_train_cli_with_pipeline_parallelism(cli_corpus, plain_run, tmp_path, pp_dp, pp_tp):
    """The twin of the JAX ``test_train_cli_with_pipeline_parallelism``: the
    ``train`` CLI with ``parallel: {use: true, pipeline: 2, data: D, model:
    M}`` against its plain run, two epochs; checkpoints written whole."""
    from test_torch_dp_cli import _cli_config, _train

    trainer = _train(_cli_config(cli_corpus, tmp_path, {"use": True, "pipeline": 2,
                                                        "data": pp_dp, "model": pp_tp},
                                 impl="scan", epochs=2))
    np.testing.assert_allclose(trainer.train_history["loss"], plain_run.train_history["loss"],
                               rtol=2e-4)
    np.testing.assert_allclose(trainer.dev_history["loss"], plain_run.dev_history["loss"],
                               rtol=2e-4)
    assert os.listdir(os.path.join(trainer.saving_dir, "ckpts"))


def test_train_cli_pipeline_resumes_across_layouts_and_modes(cli_corpus, plain_run,
                                                             tmp_path, capsys):
    """A pipeline checkpoint (dp 1) resumes into PP x dp 2 with its optimizer
    state, continuing as the uninterrupted plain run does; the one-device
    Trainer resumes it with its parameters and a fresh optimizer state (two
    Adam states against one), and so does a pipeline run from a one-device
    checkpoint."""
    from test_torch_dp_cli import _cli_config, _train

    first = _train(_cli_config(cli_corpus, tmp_path / "a", {"use": True, "pipeline": 2},
                               impl="scan", epochs=1))
    ckpt = os.path.join(first.saving_dir, "ckpts", "last.ckpt")
    first.save(ckpt)
    resumed = _train(_cli_config(cli_corpus, tmp_path / "b",
                                 {"use": True, "pipeline": 2, "data": 2}, impl="scan",
                                 epochs=2, finetune={"use": True, "reinit_lr": False,
                                                     "checkpoint": ckpt}))
    assert resumed.epoch == 2
    np.testing.assert_allclose(resumed.train_history["loss"], plain_run.train_history["loss"],
                               rtol=2e-4)
    assert resumed.state.params_listener.grid.axis_size("data") == 2
    capsys.readouterr()
    one = _train(_cli_config(cli_corpus, tmp_path / "c", {"use": False}, impl="scan",
                             epochs=2, finetune={"use": True, "reinit_lr": False,
                                                 "checkpoint": ckpt}))
    assert "fresh optimizer state" in capsys.readouterr().out
    whole = tlas._tree_to_numpy(first.whole_params())
    assert one.epoch == 2 and np.isfinite(one.train_history["loss"]).all()
    one_ckpt = os.path.join(one.saving_dir, "ckpts", "last.ckpt")
    one.save(one_ckpt)
    back = _train(_cli_config(cli_corpus, tmp_path / "d", {"use": True, "pipeline": 2},
                              impl="scan", epochs=3, finetune={"use": True, "reinit_lr": False,
                                                               "checkpoint": one_ckpt}))
    assert "fresh optimizer state" in capsys.readouterr().out
    assert back.epoch == 3 and np.isfinite(back.train_history["loss"]).all()
    # the pipeline's checkpoint holds the whole tree, in the one-device layout
    saved = tckpt.load_checkpoint(ckpt)["params"]
    for a, b in zip(jax.tree.leaves(saved), jax.tree.leaves(whole)):
        np.testing.assert_array_equal(a, b)
