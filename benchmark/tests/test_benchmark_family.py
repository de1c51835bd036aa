"""Families: a cell of a second family joins from new files alone; the
``las`` family makes for ``base-las`` exactly what it made before there were
families; ``las``'s launches follow the port's route."""

import hashlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import harness, mixes, weights
from benchmark.tests import toy
from benchmark.tests.test_benchmark_counts import MODEL
from benchmark.tests.test_benchmark_toy_cell import _digests

# A second family, as a later configuration brings one: the ``las`` model
# with its LSTM weights drawn at half ``las``'s scale, and ``las``'s
# reference and counts.
FAMILY = '''"""A toy second family: ``las`` at half the LSTM weights' scale."""

from benchmark import counts, weights
from benchmark.reference import las_ref

precision = las_ref.precision
control_precision = las_ref.control_precision
train_steps = las_ref.train_steps
train_step_flops = counts.train_step_flops
train_step_launches = counts.train_step_launches


def leaf_specs(model):
    return [(n, s, kind, k / 2 if kind == "uniform" and ".w_" in n else k)
            for n, s, kind, k in weights.leaf_specs(model)]


def feature_width(model):
    return model["listener_configs"]["input_dim"]


def dropout_rates(model):
    return [rate for _, _, rate in las_ref.listener_layers(model)]
'''
READER = '''"""The counted kernel launches a traced step (a toy reader)."""


def read(ctx):
    return len(ctx.launches) / ctx.steps if ctx.launches else None
'''
CELL = "toyfam.train"
# the cell's own limits: its bfloat16 scan decode reads up to 6.5e-4, 0.017,
# 0.018 and 0.068 on seeds 1-13; a frozen state or half the batch reads 0.56
# or more on the last three
LIMITS = {"loss_gap": 0.01, "grad_gap": 0.05, "change_gap": 0.05, "grad_leaf_gap": 0.15}
ADDED = ["benchmark/configs/toyfam.json", "benchmark/families/toyfam.py",
         "benchmark/limits/toyfam.train.json", "benchmark/metrics/toyfam_launches.py",
         "benchmark/traffic/toyfam-train.json"]


def make_root(tmp: str) -> str:
    """A copy of the benchmark with the cell ``toyfam.train`` of the family
    ``toyfam`` added as toy.py adds its cell: new files and new entries in
    the copy's BENCHMARK.json. H=16, the scan decode, 160 features."""
    shutil.copytree(os.path.join(toy.ROOT, "benchmark"), os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = os.path.join(tmp, "benchmark")
    with open(os.path.join(toy.ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    with open(os.path.join(here, "configs", "base-las.json")) as fh:
        cfg = json.load(fh)
    m = cfg["model"]
    m["listener_configs"].update(uniform_hid_dim=16, input_dim=160)
    m["speller_configs"].update(att_proj_dim=8, dec_emb_dim=16, dec_lstm_hid_dim=16,
                                dec_lstm_out_dim=8, CHR_MAX_STEPS=10, att_heads=2,
                                decoder_impl="scan")
    cfg.update(family="toyfam", batch_size=4, pad_time_multiple=16, pad_label_multiple=8)
    with open(os.path.join(here, "traffic", "train-longform.json")) as fh:
        mix = json.load(fh)
    mix.update(utterances=12, words=[1, 3], max_frames=64, batch_size=4)
    for path, text in (("configs/toyfam.json", json.dumps(cfg)),
                       ("traffic/toyfam-train.json", json.dumps(mix)),
                       ("families/toyfam.py", FAMILY), ("metrics/toyfam_launches.py", READER),
                       ("limits/toyfam.train.json", json.dumps(LIMITS))):
        with open(os.path.join(here, path), "w") as fh:
            fh.write(text)
    spec["configs"].append({"name": "toyfam", "source": "https://example.org/toyfam",
                            "file": "benchmark/configs/toyfam.json", "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": CELL, "config": "toyfam", "traffic": "toyfam-train",
                              "chips": 1, "why": "toy"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in metric:
            metric["workloads"].append(CELL)
    spec["per_layer"].append({"name": "toyfam_launches", "unit": "launches", "better": "lower",
                              "source": "device_trace", "layer": "LSTM kernels",
                              "moves": "train_utt_s", "workloads": [CELL]})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return tmp


def test_a_second_family_joins_from_new_files(tmp_path):
    root = make_root(str(tmp_path))
    before, after = _digests(toy.ROOT), _digests(root)
    assert all(after[k] == v for k, v in before.items()), "a benchmark file was edited"
    assert sorted(set(after) - set(before)) == ADDED
    cell = harness.resolve(CELL, root)
    assert harness.family(cell).__file__ == os.path.join(root, "benchmark", "families", "toyfam.py")


@pytest.mark.parametrize("trace", [False, True])
def test_the_second_familys_run_uses_its_own_parts(tmp_path, monkeypatch, trace):
    root = make_root(str(tmp_path))
    cell = harness.resolve(CELL, root)
    family, calls = harness.family(cell), []

    class Recorder:
        def __getattr__(self, name):
            def call(*args, **kwargs):
                calls.append(name)
                return getattr(family, name)(*args, **kwargs)
            return call

    monkeypatch.setattr(harness, "family", lambda c: Recorder())
    outcome, run = toy.run_cell(root, CELL, trace=trace)
    want = {"leaf_specs", "feature_width", "dropout_rates", "train_steps", "precision"}
    assert want | ({"train_step_flops", "train_step_launches"} if trace else set()) == set(calls)
    stream = io.StringIO()
    line = harness.finish(run, outcome, stream)
    assert stream.getvalue().count("\n") == 1 and line["correct"] is True
    if trace:
        plans = mixes.plan_batches(cell.mix, cell.config)
        want = [ln for p in plans for ln in family.train_step_launches(
            cell.config["model"], "bfloat16", p.t_pad, p.l_pad, p.lx)]
        assert outcome.trace.launches == want
        # 160 features take the projected form at layer 0; the scan decode launches nothing
        assert want[0].counter == "lstm_scan_train"
        assert not [ln for ln in want if ln.counter.startswith("speller")]
        assert line["metrics"]["toyfam_launches"]["value"] == 8.0  # 4 layers x (forward, adjoint)


# ---------------------------------------------------------------------------
# base-las pinned to what the harness made before it had families (seed 7,
# on the CPU)
# ---------------------------------------------------------------------------

def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


PLANS = [(1024, 192)] * 5 + [(1280, 192)] * 5 + [(1280, 256)] * 2 + [(1536, 256)] * 4


@pytest.fixture(scope="module")
def base():
    cell = harness.resolve("base-las.train-longform")
    return cell, harness.family(cell), cell.config["model"], \
        mixes.plan_batches(cell.mix, cell.config)


def test_base_las_weights_are_pinned(base):
    _, family, model, _ = base
    flat = weights.make_flat(family.leaf_specs(model), 7, torch.device("cpu"))
    assert (len(flat), sum(t.numel() for t in flat.values())) == (43, 37650974)
    names = [torch.tensor([ord(c) for c in n]) for n in flat]
    assert _digest(names + list(flat.values())) == "51cfb770dc4a78cc"


def test_base_las_plans_batch_and_draws_are_pinned(base):
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import TrainDraws

    cell, family, model, plans = base
    cpu = torch.device("cpu")
    assert [(p.t_pad, p.l_pad) for p in plans] == PLANS
    assert _digest([torch.as_tensor(np.concatenate([p.lx for p in plans])),
                    torch.as_tensor(np.concatenate([p.ly for p in plans]))]) == "9a4c7927afe68aa1"
    gen = torch.Generator(device=cpu).manual_seed(mixes.sub_seed(7, 1))
    b = mixes.make_batch(plans[0], gen, cpu, family.feature_width(model))
    assert tuple(b.x.shape) == (96, 1024, 15)
    assert _digest([b.x, b.lx, b.y, b.ly]) == "9c495eda2e4e0074"
    gen = torch.Generator(device=cpu).manual_seed(mixes.sub_seed(7, 3))
    d = harness.entry(cell).draw_step(model, family.dropout_rates(model), 96, plans[0].l_pad,
                                      gen, cpu, TrainDraws)
    assert _digest(list(d.listener_masks) + [d.coins, d.m1, d.m2] + list(d.specaug)) \
        == "1cb78e46cf8ab86e"


def test_base_las_launches_and_flops_are_pinned(base):
    cell, family, model, plans = base
    ln = [x for p in plans for x in family.train_step_launches(
        model, cell.config["compute_dtype"], p.t_pad, p.l_pad, p.lx)]
    assert len(ln) == 160
    assert sum(x.flops for x in ln) == 43604141334528.0
    assert sum(x.nbytes for x in ln) == 144034203438.0
    assert [x.counter for x in ln[:10]] == [
        "lstm_scan_fusedin_train", "lstm_bwd_dw"] + ["lstm_scan_train", "lstm_bwd_dw"] * 3 + [
        "speller_decode_train", "speller_decode_bwd"]
    assert sum(family.train_step_flops(model, p.lx, p.ly) for p in plans) == 121739994264576.0


# ---------------------------------------------------------------------------
# las's launches on the port's other routes, by hand (the tiny model of
# test_benchmark_counts: B=2, lx 6 and 3, T=8, 1 + 1 layers, H=4)
# ---------------------------------------------------------------------------

def _las():
    return harness.family(harness.resolve("base-las.train-longform"))


def _with(listener=None, speller=None):
    return {"listener_configs": {**MODEL["listener_configs"], **(listener or {})},
            "speller_configs": {**MODEL["speller_configs"], **(speller or {})}}


def test_the_scan_decode_launches_no_speller_kernel():
    lx = np.array([6, 3])
    fused = _las().train_step_launches(MODEL, "bfloat16", 8, 4, lx)
    scan = _las().train_step_launches(_with(speller={"decoder_impl": "scan"}), "bfloat16", 8, 4, lx)
    assert [x.counter for x in scan] == ["lstm_scan_fusedin_train", "lstm_bwd_dw",
                                        "lstm_scan_train", "lstm_bwd_dw"]
    assert scan == fused[:4]


def test_an_input_over_128_is_projected_before_the_recurrence():
    lx = np.array([6, 3])
    wide = _with(listener={"input_dim": 160})
    ln = _las().train_step_launches(wide, "bfloat16", 8, 4, lx)
    assert [x.counter for x in ln] == ["lstm_scan_train", "lstm_bwd_dw", "lstm_scan_train",
                                      "lstm_bwd_dw", "speller_decode_train", "speller_decode_bwd"]
    fwd0 = ln[0]
    # the recurrence alone: 9 valid frames x 2 dirs x 2 x 4 units x 16 gates
    assert fwd0.flops == 2 * 9 * 2 * 16 * 4
    # x_proj (9 frames x 2 x 16 x 2 B) + w_hh + lengths + hs, cs (2 x 8 x 8) + gates (2 x 8 x 32)
    assert fwd0.nbytes == 9 * 32 * 2 + 2 * 4 * 16 * 2 + 2 * 4 + 2 * 8 * (2 * 8 + 32) * 2
    # at 128 the input is still projected inside the recurrence
    edge = _las().train_step_launches(_with(listener={"input_dim": 128}), "bfloat16", 8, 4, lx)
    assert edge[0].counter == "lstm_scan_fusedin_train"
    assert edge[0].flops == 2 * 9 * 2 * 16 * (4 + 128)
    remat = _with(listener={"input_dim": 160, "remat": True})
    names = [x.counter for x in _las().train_step_launches(remat, "bfloat16", 8, 4, lx)]
    assert names[:3] == ["lstm_scan", "lstm_scan_train", "lstm_bwd_dw"]
