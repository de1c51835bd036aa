"""PyTorch port, tensor, sequence and pipeline parallelism across cards: one
train step of each mode with its grid on distinct cards against the same
step on one card, and the ``train`` CLI with ``parallel: {use: true, model:
2}`` on the visible cards. base-LAS width on the scan tiers (the JAX
package refuses the kernel tiers with these modes, and so does the port),
float32 with TF32 off, randomness quiesced, random weights from a seed.
Each test skips below the cards it needs; the CPU tests hold the same code
over ``["cpu"] * n`` against the JAX package (``tests/test_torch_tp.py``,
``test_torch_sp.py``, ``test_torch_pipeline.py``).

    python -m pytest tests/test_torch_parallel_cuda.py -m cuda --noconftest -q
"""

import os

import numpy as np
import pytest
import torch
import yaml

from attention_based_e2e_asr_dnn_tpu_torch import train
from attention_based_e2e_asr_dnn_tpu_torch.models.las import las_config_from_dicts, las_init
from attention_based_e2e_asr_dnn_tpu_torch.parallel import grid as pgrid
from attention_based_e2e_asr_dnn_tpu_torch.parallel import mesh as pmesh
from attention_based_e2e_asr_dnn_tpu_torch.parallel import pipeline as ppipe
from attention_based_e2e_asr_dnn_tpu_torch.tools import make_synthetic_data
from attention_based_e2e_asr_dnn_tpu_torch.training.optim import build_optimizer
from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
    create_train_state,
    make_train_step,
)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 19
B, T, L = 16, 256, 32
LR = 1e-3
TOL = 2e-5  # relative: loss, grad norm, the first Adam moment's norm


def _cards(n: int) -> list:
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [torch.device("cuda", i) for i in range(n)]


def _cfg():
    with open(os.path.join(REPO, "configs", "base-las.yml")) as fh:
        model = yaml.safe_load(fh)["model"]["configs"]
    return las_config_from_dicts(
        {**model["listener_configs"], "lstm_impl": "scan", "init_dropout": 0.0,
         "mid_dropout": 0.0, "final_dropout": 0.0},
        {**model["speller_configs"], "decoder_impl": "scan", "dec_lstm_dropout": 0.0})


def _batch(device):
    gen = torch.Generator().manual_seed(SEED)
    lx = torch.randint(T // 2, T + 1, (B,), generator=gen).to(torch.int32)
    ly = torch.randint(L // 2, L + 1, (B,), generator=gen).to(torch.int32)
    x = torch.randn(B, T, 15, generator=gen)
    y = torch.randint(1, 29, (B, L), generator=gen).to(torch.int32)
    return tuple(t.to(device) for t in (x, lx, y, ly))


def _params(cfg):
    return las_init(cfg, torch.Generator().manual_seed(SEED))


@pytest.fixture(scope="module")
def one_card():
    """The one-card step: its metrics and first moment (flat)."""
    dev = _cards(1)[0]
    cfg = _cfg()
    opt = build_optimizer("adamw", {"lr": LR, "amsgrad": True}, grad_norm=5.0)
    state = create_train_state(_params(cfg), opt, seed=SEED, device=dev)
    step = make_train_step(train.make_las_apply_factory(cfg)(1.0), opt)
    state, metrics, _ = step(state, *_batch(dev), 1.0, LR)
    return ({k: float(v) for k, v in metrics.items()},
            torch.cat([m.reshape(-1) for m in state.opt_state.mu]))


def _assert_close(metrics, mu, one_card):
    ref, ref_mu = one_card
    for key in ("loss", "grad_norm"):
        assert abs(float(metrics[key]) - ref[key]) <= TOL * max(abs(ref[key]), 1.0), key
    flat = torch.cat([m.reshape(-1) for m in mu]).to(ref_mu.device)
    assert float(torch.linalg.vector_norm(flat - ref_mu) / torch.linalg.vector_norm(ref_mu)) <= TOL


GRIDS = {
    "tp-2": (2, lambda d: pmesh.make_mesh_2d(1, 2, devices=d)),
    "dp2-tp2": (4, lambda d: pmesh.make_mesh_2d(2, 2, devices=d)),
    "seq-2": (2, lambda d: pmesh.make_mesh_2d(1, 2, axis_names=("data", "seq"), devices=d)),
    "seq2-tp2": (4, lambda d: pmesh.make_mesh_3d(1, 2, 2, devices=d)),
}


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_step_across_cards_matches_one_card(one_card, name):
    n, build = GRIDS[name]
    devices = _cards(n)
    grid = build(devices)
    cfg = _cfg()
    opt = build_optimizer("adamw", {"lr": LR, "amsgrad": True}, grad_norm=5.0)
    state = pmesh.shard_train_state(create_train_state(_params(cfg), opt, seed=SEED,
                                                       device=devices[0]), grid)
    if grid.axis_size("model") > 1:
        blocks = state.params.leaves["listener.base.0.fwd.w_hh"]
        assert [b.device for b in blocks] == grid.model_devices(0)
    step = pgrid.make_grid_train_step(train.make_las_apply_factory(cfg)(1.0), opt, grid)
    state, metrics, _ = step(state, *_batch(devices[0]), 1.0, LR)
    torch.cuda.synchronize()
    _assert_close(metrics, pmesh.gather_opt_state(state.params, state.opt_state,
                                                  devices[0]).mu, one_card)


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 1), (1, 2)], ids=["pp", "pp-dp2", "pp-tp2"])
def test_pipeline_step_across_cards_matches_one_card(one_card, dp, tp):
    devices = _cards(2 * dp * tp)
    cfg = _cfg()
    opt = build_optimizer("adamw", {"lr": LR, "amsgrad": True}, grad_norm=1e30)
    state = ppipe.init_pipeline_state(_params(cfg), opt, SEED, devices, dp=dp, tp=tp)
    assert state.params_speller.grid.gather_device(0) == devices[dp * tp]
    step = ppipe.make_pipeline_train_step(cfg, opt, devices, 2, grad_norm=5.0, dp=dp, tp=tp)
    state, metrics = step(state, *_batch(devices[0]), 1.0, LR)
    torch.cuda.synchronize()
    mu = []
    for gp, o in ((state.params_listener, state.opt_listener),
                  (state.params_speller, state.opt_speller)):
        mu += pmesh.gather_opt_state(gp, o, devices[0]).mu
    _assert_close(metrics, mu, one_card)


def test_train_cli_tensor_parallel_on_the_visible_cards(tmp_path):
    """``parallel: {use: true, model: 2}`` with ``data`` null: the CLI's
    grid takes every visible card (cards / 2 data rows) and trains one
    epoch with finite losses; asking for more cards than are present raises
    the JAX ``make_mesh_2d`` message."""
    cards = _cards(2)[:1] * torch.cuda.device_count()  # every visible card counts
    corpus = str(tmp_path / "corpus")
    make_synthetic_data.generate(corpus, n_train=16, n_dev=8, n_test=8, words_min=2,
                                 words_max=4, seed=SEED)
    with open(os.path.join(REPO, "configs", "base-las.yml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg["model"]["configs"]["listener_configs"]["lstm_impl"] = "scan"
    cfg["model"]["configs"]["speller_configs"].update(decoder_impl="scan", CHR_MAX_STEPS=64)
    data_rows = len(cards) // 2
    cfg.update(TRN_FOLDER=os.path.join(corpus, "train-clean-100"),
               DEV_FOLDER=os.path.join(corpus, "dev-clean"),
               TST_FOLDER=os.path.join(corpus, "test-clean"),
               EXP_FOLDER=str(tmp_path / "exp"), MST_FOLDER=str(tmp_path / "ms"),
               epochs=1, batch_size=8 * data_rows, parallel={"use": True, "model": 2})
    path = str(tmp_path / "tp.yml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    trainer = train.main(train.build_argparser().parse_args(["-c", path]))
    assert trainer.grid.shape == {"data": data_rows, "model": 2}
    assert np.isfinite(trainer.train_history["loss"]).all()
    cfg["parallel"] = {"use": True, "model": 2, "data": len(cards)}
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    with pytest.raises(ValueError, match=f"requested data={len(cards)} x model=2 = "
                                         f"{2 * len(cards)} devices but only"):
        train.main(train.build_argparser().parse_args(["-c", path]))
