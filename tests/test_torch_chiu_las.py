"""Chiu et al. 2018's LAS on the port (``configs/chiu-las.yml``): the frame
stacking, the flat BiLSTM listener, the additive attention score and its
step-loop decode, held on the CPU to the plain float32 reference
``tests/reference_chiu_las.py`` at a small size with the structure kept
(stacking 3 / 3, 2 flat layers, 4 heads); the benchmark's copy of the
reference, its ``chiu`` family and its configuration; the ``train`` and
``infer`` CLIs on the configuration at toy widths."""

import copy
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

from attention_based_e2e_asr_dnn_tpu_torch import infer as tinfer
from attention_based_e2e_asr_dnn_tpu_torch import train as ttrain
from attention_based_e2e_asr_dnn_tpu_torch.data.specaug import SpecAugDraws
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.ops import attention, speller_additive
from attention_based_e2e_asr_dnn_tpu_torch.tools import make_synthetic_data
from attention_based_e2e_asr_dnn_tpu_torch.training.optim import build_optimizer
from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
    create_train_state, make_train_step)
from attention_based_e2e_asr_dnn_tpu_torch.utils import flops
from benchmark import harness, mixes
from benchmark.families import chiu
from benchmark.reference import chiu_ref

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import reference_chiu_las as ref  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _yaml(name):
    with open(os.path.join(ROOT, "configs", name)) as fh:
        return yaml.safe_load(fh)


CHIU = _yaml("chiu-las.yml")["model"]["configs"]


def small_model(**speller):
    """The chiu-las block at a small size: 6 features stacked 3 / 3, 2 flat
    layers of 16, 4 heads over 16, a 16-unit decoder; both kernel tiers
    (their plain versions here)."""
    m = copy.deepcopy(CHIU)
    m["listener_configs"].update(input_dim=6, uniform_hid_dim=16, lstm_layers=2)
    m["speller_configs"].update({**dict(att_proj_dim=16, dec_emb_dim=32, dec_lstm_hid_dim=16,
                                        dec_lstm_out_dim=16, CHR_MAX_STEPS=6), **speller})
    return m


def _cfg(model):
    return tlas.las_config_from_dicts(model["listener_configs"], model["speller_configs"])


def _flat(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def _inputs(model, seed=0, batch=4, t=23, steps=7):
    g = torch.Generator().manual_seed(seed)
    lc, sc = model["listener_configs"], model["speller_configs"]
    lx = torch.tensor([t, 17, 11, 5][:batch], dtype=torch.int32)
    x = torch.randn(batch, t, lc["input_dim"], generator=g)
    x = x * (torch.arange(t)[None, :, None] < lx[:, None, None])
    ly = torch.tensor([steps, 6, 4, 3][:batch], dtype=torch.int32)
    y = torch.randint(1, 29, (batch, steps), generator=g, dtype=torch.int32)
    y = torch.where(torch.arange(steps)[None, :] < ly[:, None], y, 29)
    width = 2 * lc["uniform_hid_dim"]

    def keep(shape, rate):
        return torch.rand(shape, generator=g) < 1.0 - rate

    rates = [lc["init_dropout"]] + [lc["mid_dropout"]] * (lc["lstm_layers"] - 1)
    masks = [keep((batch, 1, width), r) for r in rates]
    spec = SpecAugDraws(torch.tensor([2.0]), torch.tensor([0.4]), torch.tensor([5.0]),
                        torch.tensor([0.3]))
    draws = tlas.TrainDraws(masks, torch.rand(steps, generator=g),
                            keep((steps, batch, sc["dec_lstm_hid_dim"]), sc["dec_lstm_dropout"]),
                            keep((steps, batch, sc["dec_lstm_out_dim"]), sc["dec_lstm_dropout"]),
                            spec)
    return x, lx, y, ly, draws


# ---------------------------------------------------------------------------
# The front end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps,left,stride", [(11, 3, 3), (12, 3, 3), (10, 2, 2), (7, 0, 1)])
def test_stacking_and_lengths_at_odd_lengths(steps, left, stride):
    x = torch.randn(3, steps, 4)
    lengths = torch.tensor([steps, 7, 1], dtype=torch.int32)
    got, got_l = tlas.stack_frames(x, lengths, left, stride)
    want, want_l = ref.stack_frames(x, lengths, left, stride)
    bench, bench_l = chiu_ref.stack_frames(x, lengths, left, stride)
    n_out = -(-steps // stride)
    assert got.shape == (3, n_out, (left + 1) * 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(bench, want, rtol=0, atol=0)
    assert got_l.tolist() == want_l.tolist() == bench_l.tolist() == [
        -(-n // stride) for n in (steps, 7, 1)]
    for k in range(n_out):  # [x_{sk-left}, ..., x_{sk}], zero before the start
        for j in range(left + 1):
            src = stride * k - left + j
            expect = x[:, src] if 0 <= src < steps else torch.zeros(3, 4)
            torch.testing.assert_close(got[:, k, 4 * j:4 * j + 4], expect, rtol=0, atol=0)


def test_the_published_listener_reads_320_inputs_at_a_30ms_rate():
    cfg = _cfg(CHIU)
    lc = cfg.listener
    assert (lc.frame_dim, lc.time_reduction, lc.enc_out_dim) == (320, 3, 2048)
    params = tlas.las_init(cfg, torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in params.parameters()) == 142201886
    assert tuple(params["listener"]["base"][0]["fwd"]["w_ih"].shape) == (320, 4096)
    assert tuple(params["speller"]["attention"]["v"].shape) == (4, 256)
    assert len(params["listener"]["pyramid"]) == 0
    # the CLI's FLOPs summary counts the layers over the stacked frames
    per_frame = 2 * 2 * ((320 + 1024) + 4 * (2048 + 1024)) * 4096
    assert flops.listener_flops(cfg, 2, 1536) == 2 * 512 * per_frame


# ---------------------------------------------------------------------------
# The additive score
# ---------------------------------------------------------------------------

def _score_operands(dtype, batch=3, te=9, heads=2, d=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(batch, heads, d, generator=g, dtype=torch.float64).to(dtype)
    k = torch.randn(batch, te, heads, d, generator=g, dtype=torch.float64).to(dtype)
    v = torch.randn(heads, d, generator=g, dtype=torch.float64).to(dtype)
    mask = torch.arange(te)[None, :] >= torch.tensor([te, 5, 1])[:batch, None]
    return q, k, v, mask


def test_additive_score_plain_version_follows_its_formula():
    q, k, v, mask = _score_operands(torch.float32)
    got = speller_additive.additive_scores_plain(q, k, v, mask)
    for b in range(3):
        for h in range(2):
            for t in range(9):
                want = (v[h] * torch.tanh(q[b, h] + k[b, t, h])).sum()
                if mask[b, t]:
                    assert got[b, h, t] == torch.finfo(torch.float32).min
                else:
                    torch.testing.assert_close(got[b, h, t], want, rtol=1e-6, atol=1e-6)
    # bfloat16 inputs: summed in float32, the scores rounded once
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    low = speller_additive.additive_scores_plain(qb, kb, vb, mask)
    assert low.dtype == torch.bfloat16
    full = speller_additive.additive_scores_plain(qb.float(), kb.float(), vb.float(), mask)
    pad = mask[:, None, :].expand_as(low)
    torch.testing.assert_close(low[~pad].float(), full[~pad].bfloat16().float(), rtol=0, atol=0)
    assert bool((low[pad] == torch.finfo(torch.bfloat16).min).all())


def test_additive_score_gradient_is_its_adjoint():
    """The Function's backward (the adjoint, tanh recomputed, ds ignored at
    padded frames) against finite differences, in float64."""
    q, k, v, mask = _score_operands(torch.float64)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]

    def fn(q_, k_, v_):  # padded entries are constant: keep them out of the check
        return speller_additive.additive_scores(q_, k_, v_, mask).masked_fill(mask[:, None], 0.0)

    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-7, rtol=1e-6)
    ds = torch.randn(3, 2, 9, dtype=torch.float64)
    dq, dk, dv = speller_additive.additive_scores_bwd_plain(q, k, v, mask, ds)
    assert bool((dk[mask] == 0).all())
    want = torch.autograd.grad(
        speller_additive.additive_scores_plain(*leaves, mask).masked_fill(mask[:, None], 0.0),
        leaves, ds.masked_fill(mask[:, None], 0.0))
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_the_additive_step_refuses_a_time_sharded_cache():
    class Sharded:
        def attention_step(self, *args):
            raise AssertionError("not reached")

    params = {"query_map": {"w": torch.zeros(4, 4), "b": torch.zeros(4)}, "v": torch.zeros(2, 2)}
    with pytest.raises(ValueError, match="time-sharded"):
        attention.cross_attention_step(params, Sharded(), torch.zeros(1, 4), 2)


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------

def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def _program_step(model, dtype, inputs, tf_rate):
    """One step of the port's train step: (loss, {leaf: gradient}) from the
    optimizer's first moment (no clip), and the decode routes taken."""
    cfg = _cfg(model)
    params = tlas.las_init(cfg, torch.Generator().manual_seed(3))
    flat = _flat(params)
    opt = build_optimizer("adamw", {"lr": 1e-3, "weight_decay": 0.0, "amsgrad": True},
                          grad_norm=1e9)
    state = create_train_state(params, opt, seed=0, device="cpu")
    step = make_train_step(lambda p, x, lx, **kw: tlas.las_apply(p, cfg, x, lx, **kw), opt,
                           compute_dtype=dtype, use_specaug=True)
    x, lx, y, ly, draws = inputs
    tlas.reset_decode_routes()
    _, metrics, _ = step(state, x, lx, y, ly, tf_rate, 1e-3, draws=draws)
    names = [n for n, _ in state.params.named_parameters()]
    grads = {n: m / 0.1 for n, m in zip(names, state.opt_state.mu)}
    return float(metrics["loss"]), grads, flat, set(tlas.decode_route_report().values())


def _worst(grads, want):
    """The worst leaf's relative gap of the gradient, over leaves whose
    reference gradient is at least a hundredth of the median leaf's: the
    smaller ones (the key bias, the initial query, and at this size ``v``)
    are sums that nearly cancel, where bfloat16 rounding is as large as the
    sum (the float32 test holds them)."""
    norms = {n: float(g.norm()) for n, g in want.items()}
    floor = 1e-2 * float(np.median(list(norms.values())))
    return max(_rel(grads[n], want[n]) for n in want if norms[n] >= floor)


# float32: the program and the reference differ in summation order only
# (measured ~1e-6 on the loss, ~8e-5 on the worst leaf). bfloat16
# (teacher-forced throughout, so both feed the same ids): every product's
# operands and every stored activation are rounded to 8 bits, the carries
# kept in float32; measured 5e-5 on the loss and 3.7e-2 on the worst leaf
# (the key projection's weight). The float8 e4m3 control (operands rounded
# to 4 bits) reads 2.7e-4 and 0.24 there.
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 6e-2)}


@pytest.mark.parametrize("dtype,tf_rate", [(torch.float32, 0.5), (torch.bfloat16, 1.0)])
def test_a_train_step_matches_the_reference(dtype, tf_rate):
    model = small_model()
    inputs = _inputs(model)
    loss, grads, flat, routes = _program_step(model, dtype, inputs, tf_rate)
    assert routes == {"scan"}
    x, lx, y, ly, draws = inputs
    want_loss, want = ref.loss_and_grads(flat, model, x, lx, y, ly, draws, tf_rate)
    assert set(grads) == set(want)
    loss_tol, grad_tol = TOL[dtype]
    assert abs(loss - float(want_loss)) / float(want_loss) < loss_tol
    assert _worst(grads, want) < grad_tol


def test_float8_operands_fail_the_bfloat16_tolerances():
    """The control: the benchmark's reference with every product's operands
    rounded to float8 e4m3 falls outside the bfloat16 tolerances above."""
    model = small_model()
    x, lx, y, ly, draws = _inputs(model)
    cfg = _cfg(model)
    flat = _flat(tlas.las_init(cfg, torch.Generator().manual_seed(3)))
    want_loss, want = ref.loss_and_grads(flat, model, x, lx, y, ly, draws, 1.0)
    batch = mixes.Batch(x, lx, y, ly)
    with chiu_ref.las_ref.precision("float8_e4m3fn") as q:
        low_loss, low = chiu_ref.loss_and_grads(flat, model, batch, draws, 1.0, q)
    loss_tol, grad_tol = TOL[torch.bfloat16]
    assert (abs(float(low_loss) - float(want_loss)) / float(want_loss) > loss_tol
            or _worst(low, want) > grad_tol)


def test_the_eval_decode_logits_match_the_reference():
    model = small_model(CHR_MAX_STEPS=8)
    cfg = _cfg(model)
    params = tlas.las_init(cfg, torch.Generator().manual_seed(5))
    x, lx, _, _, _ = _inputs(model, seed=2)
    tlas.reset_decode_routes()
    with torch.no_grad():
        got = tlas.las_apply(params, cfg, x, lx).logits
    assert set(tlas.decode_route_report().values()) == {"scan"}
    want = ref.eval_logits(_flat(params), model, x, lx, 8)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_the_dot_product_path_is_unchanged_for_base_las(monkeypatch):
    """base-las: no stacking (``stack_frames`` never called), no leaf ``v``,
    the fused decode's route, and the dot-product step as its formula."""
    base = _yaml("base-las.yml")["model"]["configs"]
    small = copy.deepcopy(base)
    small["listener_configs"].update(uniform_hid_dim=16)
    small["speller_configs"].update(att_proj_dim=16, dec_emb_dim=32, dec_lstm_hid_dim=16,
                                    dec_lstm_out_dim=16, CHR_MAX_STEPS=5)
    cfg = _cfg(small)
    assert (cfg.listener.frame_dim, cfg.listener.time_reduction) == (15, 8)
    assert cfg.speller.att_score == "dot"
    params = tlas.las_init(cfg, torch.Generator().manual_seed(0))
    assert "v" not in params["speller"]["attention"]

    def refuse(*args):
        raise AssertionError("base-las stacks no frames")

    monkeypatch.setattr(tlas, "stack_frames", refuse)
    tlas.reset_decode_routes()
    x = torch.randn(2, 32, 15)
    with torch.no_grad():
        tlas.las_apply(params, cfg, x, torch.tensor([32, 20], dtype=torch.int32))
    assert set(tlas.decode_route_report().values()) == {"plain"}
    sp = params["speller"]["attention"]
    enc = torch.randn(2, 4, 32)
    cache = attention.cross_attention_precompute(sp, enc, torch.tensor([4, 2]), 1)
    dec_h = torch.randn(2, 16)
    with torch.no_grad():
        ctx, wgts, qp = attention.cross_attention_step(sp, cache, dec_h, 1)
        qq = dec_h @ sp["query_map"]["w"] + sp["query_map"]["b"]
        s = torch.einsum("bd,btd->bt", qq, cache.keys[:, 0]) * (1 / 4.0)
        s = s.masked_fill(cache.mask, torch.finfo(torch.float32).min)
    torch.testing.assert_close(wgts[:, 0], torch.softmax(s, -1).masked_fill(cache.mask, 0.0),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The benchmark's parts
# ---------------------------------------------------------------------------

def test_the_two_references_agree(monkeypatch):
    """``benchmark/reference/chiu_ref.py`` (row blocks, layers run again for
    their gradients) and ``tests/reference_chiu_las.py`` (whole) give the
    same loss and gradients up to float32 summation order."""
    monkeypatch.setattr(chiu_ref, "ROWS", 3)
    model = small_model()
    x, lx, y, ly, draws = _inputs(model, seed=4)
    flat = _flat(tlas.las_init(_cfg(model), torch.Generator().manual_seed(7)))
    want_loss, want = ref.loss_and_grads(flat, model, x, lx, y, ly, draws, 0.5)
    with chiu_ref.las_ref.precision(None) as q:
        loss, got = chiu_ref.loss_and_grads(flat, model, mixes.Batch(x, lx, y, ly), draws, 0.5, q)
    assert abs(float(loss) - float(want_loss)) < 1e-5 * float(want_loss)
    assert set(got) == set(want)
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=1e-4, atol=1e-6)


def _config_json():
    with open(os.path.join(ROOT, "benchmark", "configs", "chiu-las.json")) as fh:
        return json.load(fh)


def test_config_file_holds_the_chiu_yaml_model_block():
    got = _config_json()
    assert got["model"] == CHIU
    assert got["family"] == "chiu" and got["reduced"] == [] and "1712.01769" in got["source"]
    assert got["parameters"] == 142201886


def test_the_family_leaves_are_the_ports():
    model = _config_json()["model"]
    specs = chiu.leaf_specs(model)
    params = tlas.las_init(_cfg(model), torch.Generator().manual_seed(0))
    assert {n: tuple(s) for n, s, _, _ in specs} == {
        n: tuple(p.shape) for n, p in params.named_parameters()}
    assert chiu.feature_width(model) == 80
    assert chiu.dropout_rates(model) == [0.3] * 5


def test_the_family_launches_against_hand_counts():
    model = _config_json()["model"]
    lx = np.array([1536, 1500, 711] + [1200] * 125)
    launches = chiu.train_step_launches(model, "bfloat16", 1536, 256, lx)
    names = [ln.counter for ln in launches]
    # 5 layers: the x_proj training forward and the adjoint without dW_hh;
    # the step loop: 256 steps and the initial query, each way
    assert names == (["lstm_scan_train", "lstm_bwd"] * 5 + ["speller_additive_scores"] * 257
                     + ["speller_additive_scores_bwd"] * 257)
    enc = 512 + 500 + 237 + 400 * 125                    # ceil(l / 3)
    fwd, bwd = launches[10], launches[-1]
    assert fwd.nbytes == 2 * (enc * 1024 + 128 * 1024 + 1024 + 128 * 4 * 512)
    assert bwd.nbytes == 2 * (enc * 1024 + 128 * 512 * 1024 + 2 * (128 * 1024 + 1024)
                              + 128 * 4 * 512)
    assert fwd.flops == 2.0 * enc * 1024 and bwd.flops == 6.0 * enc * 1024
    # layer 0 reads the 320-wide stacked frames projected before the
    # recurrence: its x_proj stream is 2 x 4H a frame
    assert launches[0].nbytes == launches[2].nbytes
    assert 1e-6 < fwd.bound_s() == fwd.nbytes / 3.35e12


def test_the_family_flops_against_hand_counts():
    model = _config_json()["model"]
    lx, ly = np.array([30, 7]), np.array([5, 2])
    enc = np.array([10, 3])
    n = enc.sum()
    listener = 2 * n * 2 * (320 + 1024) * 4096 + 4 * 2 * n * 2 * (2048 + 1024) * 4096
    keys_values = 2 * 2 * n * 2048 * 1024
    cells = 2 * (2048 + 1024 + 1024) * 4096 + 2 * (1024 + 1024) * 4096
    per_step = cells + 2 * 1024 * 1024 + 2 * 2 * 1024 * 30
    attention_ = 2 * (2 * 1024) * (enc * ly).sum()       # score and context, 2 Te P each
    want = 3 * (listener + keys_values + ly.sum() * per_step + attention_)
    assert chiu.train_step_flops(model, lx, ly) == pytest.approx(want, rel=1e-12)


def test_the_cell_resolves_with_the_new_readers():
    cell = harness.resolve("chiu-las.train-longform")
    names = [m["name"] for m in cell.per_layer]
    assert {"additive_scores_roofline.train", "additive_scores_bwd_roofline.train"} <= set(names)
    assert "speller_roofline.train" not in names and "torch_ops_ms.train" not in names
    assert harness.family(cell).__name__ == "benchmark_family_chiu"


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def test_train_and_infer_clis_take_the_configuration(tmp_path, capsys):
    """``train --device cpu`` with ``configs/chiu-las.yml`` at toy widths
    (stacking 3 / 3, 2 flat layers, 4 heads, the additive score) on a
    generated corpus of 6 features a frame, then ``infer`` from its folder."""
    corpus = tmp_path / "corpus"
    make_synthetic_data.generate(str(corpus), n_train=16, n_dev=8, n_test=8, words_min=1,
                                 words_max=2, n_feats=6, seed=3)
    cfg = _yaml("chiu-las.yml")
    cfg.update(TRN_FOLDER=str(corpus / "train-clean-100"), DEV_FOLDER=str(corpus / "dev-clean"),
               TST_FOLDER=str(corpus / "test-clean"), EXP_FOLDER=str(tmp_path / "exp"),
               MST_FOLDER=str(tmp_path / "mst"), epochs=2, batch_size=8, pad_time_multiple=24,
               compute_dtype="float32")
    cfg["model"]["configs"] = small_model(CHR_MAX_STEPS=24)
    path = tmp_path / "train.yml"
    path.write_text(yaml.safe_dump(cfg))
    tlas.reset_decode_routes()
    trainer = ttrain.main(ttrain.build_argparser().parse_args(["-c", str(path), "--device", "cpu"]))
    assert set(tlas.decode_route_report().values()) == {"scan"}
    assert "additive attention score" in capsys.readouterr().err
    folder = trainer.saving_dir
    log = json.load(open(os.path.join(folder, "log.json")))
    assert len(log[0]["loss"]) == 2 and all(np.isfinite(v) for v in log[0]["loss"])
    infer_yml = tmp_path / "infer.yml"
    infer_yml.write_text(yaml.safe_dump({
        "SOME_FOLDER": str(corpus / "test-clean"), "exp_folder": folder, "batch_size": 8,
        "pad_time_multiple": 24, "run_all": True, "epoch_num": None, "run_avg": True,
        "early_stop": False}))
    tinfer.main(tinfer.build_argparser().parse_args(["-c", str(infer_yml), "--device", "cpu"]))
    preds = [f for f in os.listdir(os.path.join(folder, "preds")) if f.endswith("-tst.csv")]
    lines = open(os.path.join(folder, "preds", preds[0])).read().split("\n")
    assert lines[0] == "id,label" and len(lines[1:-1]) == 8


def _toy_root(tmp):
    """A copy of the benchmark with the chiu cell at toy widths (the
    configuration's structure, 6 features, a 12-utterance mix)."""
    root = str(tmp)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    cfg = _config_json()
    cfg["model"] = small_model(CHR_MAX_STEPS=10)
    cfg.update(batch_size=4, pad_time_multiple=24, pad_label_multiple=8)
    with open(os.path.join(root, "benchmark", "configs", "chiu-las.json"), "w") as fh:
        json.dump(cfg, fh)
    mix = os.path.join(root, "benchmark", "traffic", "train-longform.json")
    with open(mix) as fh:
        spec = json.load(fh)
    spec.update(utterances=12, words=[1, 3], max_frames=64, batch_size=4)
    with open(mix, "w") as fh:
        json.dump(spec, fh)
    with open(os.path.join(root, "benchmark", "limits", "chiu-las.train-longform.json"), "w") as fh:
        json.dump({"loss_gap": 0.01, "grad_gap": 0.05, "change_gap": 0.05,
                   "grad_leaf_gap": 0.1}, fh)
    return root


@pytest.mark.parametrize("faults", [(), ("frozen",), ("half_batch",)])
def test_the_cell_runs_end_to_end_at_toy_widths(tmp_path, faults):
    """The benchmark's train entry over the chiu family on the CPU: the
    port's step against ``chiu_ref`` in bfloat16 is correct under toy
    limits; a frozen state and a step on half the batch are not."""
    cell = harness.resolve("chiu-las.train-longform", _toy_root(tmp_path))
    run = harness.Run(cell, 2**31 + 5, 0.0, False, torch.device("cpu"), 0.0, faults)
    outcome = harness.entry(cell).run(run)
    assert outcome.attempted >= 3 and outcome.failed == 0
    ok = {c.name: c.ok() for c in outcome.checks}
    assert set(ok) == {"loss_gap", "grad_gap", "change_gap", "grad_leaf_gap"}
    assert all(ok.values()) == (not faults), [(c.name, c.value) for c in outcome.checks]
