"""PyTorch port, the train step's named spans (``utils/profiling.py::span``)
on the CPU at toy widths: under ``torch.profiler`` one ``las.train_step`` a
step with the layers' spans inside it; without a profiler ``span`` hands
back one shared null context; the numbers are the same with the profiler on
as off; the ``las.launch.<key>`` spans of the ``csrc/`` kernel calls appear
only where a kernel runs, checked on the card by the one card-marked case.
Free of JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_spans.py -m cuda --noconftest
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from attention_based_e2e_asr_dnn_tpu_torch.data.specaug import draw_specaug
from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    TrainDraws,
    draw_train_noise,
    las_apply,
    las_config_from_dicts,
    las_init,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda, speller_cuda
from attention_based_e2e_asr_dnn_tpu_torch.training.optim import build_optimizer
from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
    create_train_state,
    make_train_step,
)
from attention_based_e2e_asr_dnn_tpu_torch.utils import profiling

# the spans every train step opens (SpecAugment on), each inside las.train_step
LAYER_SPANS = ("las.specaug", "las.listener", "las.speller.operands", "las.speller.decode",
               "las.loss", "las.backward", "las.optimizer")

TOY = ({"input_dim": 15, "uniform_hid_dim": 32, "lstm_layers": 1, "plstm_layers": 1,
        "bidirectional": True, "init_dropout": 0.3, "mid_dropout": 0.3,
        "final_dropout": 0.35},
       {"att_proj_dim": 16, "att_heads": 1, "dec_emb_dim": 32, "dec_lstm_hid_dim": 32,
        "dec_lstm_out_dim": 16, "dec_lstm_dropout": 0.3, "CHR_MAX_STEPS": 8,
        "dec_vocab_size": 30, "CHR_SOS_IDX": 0, "CHR_PAD_IDX": 29})
# the model block of configs/base-las.yml, which the card's kernels take
BASE_LAS = ({**TOY[0], "uniform_hid_dim": 512, "plstm_layers": 3},
            {**TOY[1], "att_proj_dim": 256, "dec_emb_dim": 512, "dec_lstm_hid_dim": 512,
             "dec_lstm_out_dim": 256, "CHR_MAX_STEPS": 600})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _program(widths, device, lstm_impl, decoder_impl, remat=False, dtype=torch.float32,
             batch=2, frames=16, labels=4):
    """A seeded state, step and two batches with their draws."""
    cfg = las_config_from_dicts({**widths[0], "lstm_impl": lstm_impl, "remat": remat},
                                {**widths[1], "decoder_impl": decoder_impl})
    opt = build_optimizer("adamw", {"lr": 1e-3, "weight_decay": 5e-6, "amsgrad": True},
                          grad_norm=5.0)
    state = create_train_state(las_init(cfg, torch.Generator().manual_seed(11)), opt,
                               seed=12, device=str(device))
    step = make_train_step(lambda p, xx, ll, **kw: las_apply(p, cfg, xx, ll, **kw), opt,
                           compute_dtype=dtype, use_specaug=True)
    gen = torch.Generator().manual_seed(5)
    batches = []
    for _ in range(2):
        lx = torch.randint(frames // 2, frames + 1, (batch,), generator=gen).to(torch.int32)
        lx[0] = frames
        x = torch.randn(batch, frames, 15, generator=gen)
        y = torch.randint(1, 29, (batch, labels), generator=gen).to(torch.int32)
        ly = torch.randint(1, labels + 1, (batch,), generator=gen).to(torch.int32)
        draws = draw_train_noise(cfg, batch, labels, torch.Generator().manual_seed(len(batches)),
                                 "cpu")
        spec = draw_specaug(1, 6, 8, False, torch.Generator().manual_seed(9 + len(batches)),
                            "cpu")
        draws = TrainDraws(*(_to(t, device) for t in draws[:4]), _to(spec, device))
        batches.append(tuple(t.to(device) for t in (x, lx, y, ly)) + (draws,))
    return state, step, batches


def _to(obj, device):
    if obj is None:
        return None
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, list):
        return [_to(t, device) for t in obj]
    return type(obj)(*(_to(t, device) for t in obj))


def _run(state, step, batches):
    losses = []
    for x, lx, y, ly, draws in batches:
        _, metrics, _ = step(state, x, lx, y, ly, 0.9, 1e-3, draws=draws)
        losses.append(metrics["loss"])
    return [float(v) for v in losses]


def _host_spans(prof):
    """(name, start ns, end ns) of every ``las.*`` span the host recorded."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("las.") and "cuda" not in str(e.device_type()).lower():
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


def _profiled(state, step, batches, device):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        losses = _run(state, step, batches)
    return losses, prof


@pytest.mark.parametrize("lstm_impl,decoder_impl,remat,backward",
                         [("pallas", "pallas", False, ("las.backward.listener",
                                                       "las.backward.speller")),
                          ("pallas", "pallas", True, ("las.backward.listener",
                                                      "las.backward.speller")),
                          ("scan", "scan", False, ())],
                         ids=["kernel-routes", "kernel-routes-remat", "scan-routes"])
def test_step_spans_nest_inside_the_train_step(lstm_impl, decoder_impl, remat, backward):
    """Two steps under a CPU profiler: two ``las.train_step`` spans, each
    holding every layer's span once (the listener's adjoint once a layer
    call); the adjoints' spans inside ``las.backward``; no kernel call's
    span on the plain routes."""
    state, step, batches = _program(TOY, torch.device("cpu"), lstm_impl, decoder_impl, remat)
    _, prof = _profiled(state, step, batches, torch.device("cpu"))
    spans = _host_spans(prof)
    steps = [s for s in spans if s[0] == "las.train_step"]
    assert len(steps) == 2
    for outer in steps:
        inside = [s for s in spans if s is not outer and _inside(s, outer)]
        names = [s[0] for s in inside]
        for name in LAYER_SPANS:
            assert names.count(name) == 1, (name, names)
        grad = next(s for s in inside if s[0] == "las.backward")
        for name in backward:
            held = [s for s in inside if s[0] == name]
            assert held and all(_inside(s, grad) for s in held), name
        assert set(names) <= set(LAYER_SPANS) | set(backward)
    assert not any(s[0].startswith(profiling.LAUNCH) for s in spans)


def test_span_without_a_profiler_is_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("las.train_step")
    assert isinstance(off, contextlib.nullcontext)
    assert profiling.span("las.optimizer") is off
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.span("las.optimizer")
        assert on is not off and not isinstance(on, contextlib.nullcontext)
    assert profiling.span("las.optimizer") is off


def test_profiler_changes_no_number():
    """Two steps with the profiler on give the losses and parameters of the
    same two steps with it off, bit for bit."""
    runs = []
    for profiled in (False, True):
        state, step, batches = _program(TOY, torch.device("cpu"), "pallas", "pallas")
        if profiled:
            losses, _ = _profiled(state, step, batches, torch.device("cpu"))
        else:
            losses = _run(state, step, batches)
        runs.append((losses, [p.detach().clone() for p in state.params.parameters()]))
    (plain_losses, plain_params), (prof_losses, prof_params) = runs
    assert plain_losses == prof_losses
    for p, q in zip(plain_params, prof_params):
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_kernel_calls_open_their_spans_on_card(cuda_device):
    """Two bfloat16 base-LAS steps on the card's kernels, profiled: every
    layer's span once a step, the adjoints' spans (opened on the autograd
    engine's thread) inside ``las.backward``, one ``las.launch.<key>`` span
    a kernel call whose keys are those of the launch counters that moved, no
    ``las.*`` span among the device's events but the profiler's mirrors of
    the host's, and the step's numbers as with the profiler off."""
    runs = []
    for profiled in (False, True):
        state, step, batches = _program(BASE_LAS, cuda_device, "pallas", "pallas",
                                        dtype=torch.bfloat16, batch=8, frames=256, labels=32)
        _run(state, step, batches[:1])  # the kernels bound and planned
        torch.cuda.synchronize()
        before = {**lstm_cuda.LAUNCHES, **speller_cuda.LAUNCHES}
        if profiled:
            losses, prof = _profiled(state, step, batches, cuda_device)
        else:
            losses = _run(state, step, batches)
        torch.cuda.synchronize()
        after = {**lstm_cuda.LAUNCHES, **speller_cuda.LAUNCHES}
        runs.append((losses, [p.detach().clone() for p in state.params.parameters()]))
    assert runs[0][0] == runs[1][0]
    for p, q in zip(runs[0][1], runs[1][1]):
        assert torch.equal(p, q)
    spans = _host_spans(prof)
    steps = [s for s in spans if s[0] == "las.train_step"]
    assert len(steps) == 2
    for outer in steps:
        inside = [s for s in spans if _inside(s, outer)]
        for name in LAYER_SPANS:
            assert [s[0] for s in inside].count(name) == 1, name
        grad = next(s for s in inside if s[0] == "las.backward")
        for name in ("las.backward.listener", "las.backward.speller"):
            held = [s for s in inside if s[0] == name]
            assert held and all(_inside(s, grad) for s in held), name
    moved = {k for k in after if after[k] != before[k]}
    launched = {s[0][len(profiling.LAUNCH):] for s in spans if s[0].startswith(profiling.LAUNCH)}
    assert launched == moved and moved
    device = [e for e in prof.profiler.kineto_results.events()
              if "cuda" in str(e.device_type()).lower() and not e.is_user_annotation()]
    assert device and not any(e.name().startswith("las.") for e in device)
