"""PyTorch port, the measurement tools on the CPU at toy widths:
``tools/bench.py`` against the repository's ``bench.py`` (the realistic
length draw and bucket plan; the step; the model blocks of the configs) and
its JSON line; ``utils/flops.py``'s peak table and MFU;
``tools/profile_step.py``'s rows. No time is asserted: a CPU time says
nothing of the card."""

import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch
import yaml

from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    las_apply,
    las_config_from_dicts,
    las_init,
)
from attention_based_e2e_asr_dnn_tpu_torch.tools import bench, profile_step
from attention_based_e2e_asr_dnn_tpu_torch.training.optim import build_optimizer
from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
    create_train_state,
    make_train_step,
)
from attention_based_e2e_asr_dnn_tpu_torch.utils import flops

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = {"listener_configs": {**bench.MODELS["base"]["listener_configs"], "uniform_hid_dim": 16,
                            "plstm_layers": 1},
       "speller_configs": {**bench.MODELS["base"]["speller_configs"], "att_proj_dim": 16,
                           "dec_emb_dim": 32, "dec_lstm_hid_dim": 16, "dec_lstm_out_dim": 16,
                           "CHR_MAX_STEPS": 12}}


def _root_bench():
    """The repository's ``bench.py``: it imports JAX only inside functions."""
    spec = importlib.util.spec_from_file_location("root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("batch", [32, 128])
def test_realistic_plan_is_bench_pys(seed, batch):
    ref = _root_bench()
    for a, b in zip(bench.sample_realistic_lengths(256, seed),
                    ref.sample_realistic_lengths(256, seed)):
        np.testing.assert_array_equal(a, b)
    ours, waste = bench.plan_realistic_batches(batch, n_utts=512, seed=seed)
    theirs, ref_waste = ref.plan_realistic_batches(batch, n_utts=512, seed=seed)
    assert waste == ref_waste and len(ours) == len(theirs) == 512 // batch
    for (t, l, lx, ly), (rt, rl, rlx, rly) in zip(ours, theirs):
        assert (t, l) == (rt, rl)
        np.testing.assert_array_equal(lx, rlx)
        np.testing.assert_array_equal(ly, rly)


def test_the_default_plan_and_its_shapes():
    plans, waste = bench.plan_realistic_batches(128)
    assert len(plans) == 8 and 0.0 < waste < 0.3
    assert all(t % 256 == 0 and l % 32 == 0 and lx.max() <= t and ly.max() <= l
               for t, l, lx, ly in plans)


@pytest.mark.parametrize("arch,config", [("base", "base-las.yml"),
                                         ("scaled", "scaled-las.yml")])
def test_model_blocks_are_the_configs(arch, config):
    with open(os.path.join(REPO, "configs", config)) as fh:
        written = yaml.safe_load(fh)["model"]["configs"]
    assert bench.MODELS[arch] == written


def test_bench_step_is_make_train_steps():
    """One step of the bench's step at toy widths against one of a step
    built from the recipe it names: the same loss, norm and parameters."""
    _check_step_against_recipe(torch.bfloat16)


def test_bench_float32_step_is_make_train_steps():
    """``--dtype float32``'s step is the same recipe computing in float32."""
    _check_step_against_recipe(torch.float32)


def _check_step_against_recipe(dtype):
    cfg, step, state, _ = bench.build_step_and_state(TOY, "cpu", compute_dtype=dtype)
    ref_cfg = las_config_from_dicts(TOY["listener_configs"], TOY["speller_configs"])
    assert ref_cfg == cfg
    opt = build_optimizer("adamw", {"lr": 1e-3, "weight_decay": 5e-6, "amsgrad": True},
                          grad_norm=5.0)
    ref_state = create_train_state(las_init(ref_cfg, torch.Generator().manual_seed(0)), opt,
                                   seed=1, device="cpu")
    ref_step = make_train_step(lambda p, x, lx, **kw: las_apply(p, ref_cfg, x, lx, **kw), opt,
                               compute_dtype=dtype, use_specaug=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 32, 15)).astype(np.float32))
    lx = torch.tensor([32, 30, 25, 17], dtype=torch.int32)
    y = torch.from_numpy(rng.integers(1, 29, size=(4, 8)).astype(np.int32))
    ly = torch.tensor([8, 7, 5, 3], dtype=torch.int32)
    _, m, _ = step(state, x, lx, y, ly, 0.9, 1e-3)
    _, rm, _ = ref_step(ref_state, x, lx, y, ly, 0.9, 1e-3)
    assert bool(m["finite"]) and torch.equal(m["loss"], rm["loss"])
    assert torch.equal(m["grad_norm"], rm["grad_norm"])
    for a, b in zip(state.params.parameters(), ref_state.params.parameters()):
        assert torch.equal(a, b)


def _tiny_plan(batch, pad_time=256, pad_label=32, n_utts=1024, seed=0):
    lx = np.array([32, 20, 31, 9][:batch], np.int32)
    ly = np.array([8, 5, 7, 2][:batch], np.int32)
    return [(32, 8, lx, ly), (32, 8, lx, ly), (16, 8, np.minimum(lx, 16), ly)], 0.25


def _toy_bench(monkeypatch):
    for name, value in (("TIME_STEPS", 32), ("LABEL_LEN", 8), ("WARMUP_STEPS", 1),
                        ("MEASURE_STEPS", 1)):
        monkeypatch.setattr(bench, name, value)
    monkeypatch.setattr(bench, "MODELS", {"base": TOY, "scaled": TOY})
    monkeypatch.setattr(bench, "plan_realistic_batches", _tiny_plan)
    monkeypatch.setenv("BENCH_ARCH", "scaled")
    monkeypatch.setenv("BENCH_BATCH", "4")


def test_json_line_and_its_keys(monkeypatch, capsys):
    """``main`` at toy widths and shapes: one JSON line with every key, the
    realistic mode weighted over the plan's shapes."""
    _toy_bench(monkeypatch)
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["compute_dtype"] == "bfloat16"
    assert {"metric", "value", "unit", "s_per_step", "value_realistic", "pad_waste_frac",
            "mfu", "flops_per_step", "peak_mib", "arch", "card", "power_limit_w",
            "launches_per_step"} <= set(rec)
    assert "vs_baseline" not in rec
    assert rec["arch"] == "scaled" and rec["batch"] == 4 and rec["shape"] == [4, 32, 8]
    assert math.isfinite(rec["value"]) and rec["value"] == pytest.approx(4 / rec["s_per_step"])
    assert math.isfinite(rec["value_realistic"]) and rec["pad_waste_frac"] == 0.25
    assert rec["realistic_shapes"] == [[16, 8, 1], [32, 8, 2]]
    cfg = las_config_from_dicts(TOY["listener_configs"], TOY["speller_configs"])
    assert rec["flops_per_step"] == flops.las_train_step_flops(cfg, 4, 32, 8)
    # the CPU has no peak, no device memory, no kernel launches and no card
    assert (rec["mfu"], rec["peak_mib"], rec["launches_per_step"], rec["card"],
            rec["power_limit_w"]) == (None, None, {}, "cpu", None)
    with pytest.raises(ValueError, match="BENCH_ARCH"):
        bench.run("small", 4, "cpu")


def test_dtype_flag_times_the_float32_step(monkeypatch, capsys):
    """``--dtype float32`` builds the float32 step and names it in the line;
    another dtype is refused."""
    _toy_bench(monkeypatch)
    built = []
    real = bench.build_step_and_state
    monkeypatch.setattr(bench, "build_step_and_state",
                        lambda *a, **kw: built.append(kw["compute_dtype"]) or real(*a, **kw))
    assert bench.main(["--device", "cpu", "--dtype", "float32"]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert built == [torch.float32] and rec["compute_dtype"] == "float32"
    assert math.isfinite(rec["value"]) and math.isfinite(rec["value_realistic"])
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--dtype", "float16"])


def test_peak_table_and_mfu(monkeypatch):
    assert flops.peak_flops_per_chip("cpu") is None
    assert flops.peak_flops_per_chip(torch.device("cpu")) is None
    assert flops.mfu(1e12, 0.5, "cpu") is None
    # a card, by the name CUDA reports
    names = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: names[-1])
    names.append("NVIDIA H100 80GB HBM3")
    assert flops.peak_flops_per_chip("cuda:0") == 989.4e12
    assert flops.peak_flops_per_chip() == 989.4e12
    assert flops.mfu(989.4e12, 2.0, torch.device("cuda")) == pytest.approx(0.5)
    assert flops.mfu(1e12, 0.0, "cuda") is None
    names.append("NVIDIA A100-SXM4-80GB")  # not in the table: no guess
    assert flops.peak_flops_per_chip("cuda") is None
    assert not any(name.startswith("TPU") for name in flops._PEAK_BF16)


def test_profile_step_rows():
    rows = profile_step.profile_rows(TOY, batch=4, time_steps=32, label_len=8, device="cpu",
                                     warmup=1, steps=1, windows=1)
    assert [r["name"] for r in rows] == [
        "full train step", "listener fwd", "listener fwd+bwd", "speller fwd",
        "speller fwd+bwd", "joint fwd (loss)", "joint fwd+bwd", "full step, no guard",
        "specaug", "optimizer update"]
    assert all(math.isfinite(r["ms"]) and r["ms"] > 0 and r["mfu"] is None for r in rows)
    counted = {r["name"]: r["flops"] for r in rows}
    assert counted["listener fwd+bwd"] == 3 * counted["listener fwd"]
    assert counted["specaug"] is None and counted["full train step"] == counted["joint fwd+bwd"]
    table = profile_step.format_table(rows, "toy")
    assert table.splitlines()[0] == "toy" and "residual (full-sum)" in table
    assert profile_step.model_for("scaled", "scan")["speller_configs"]["decoder_impl"] == "scan"
    with pytest.raises(ValueError, match="PROF_ARCH"):
        profile_step.model_for("small")


def test_tools_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_step.main([])
    assert bench.card_and_power("cpu") == ("cpu", None)
