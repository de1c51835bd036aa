"""PyTorch port, the additive score's training decode on the card
(``models/additive_decode.py``): the captured forward and adjoint against
the step loop under autograd, replays on fresh operands, the eager pass
where a shape's graphs are held or the card has no room for more, and the
launch counters. Free of JAX:

    python -m pytest tests/test_torch_additive_decode_cuda.py -m cuda --noconftest

Every test here skips without a CUDA device."""

import copy

import pytest
import torch

from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.models import additive_decode
from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda

MODEL = {
    "listener_configs": {"input_dim": 8, "stack_left": 3, "stack_stride": 3,
                         "uniform_hid_dim": 32, "lstm_layers": 2, "plstm_layers": 0,
                         "bidirectional": True, "init_dropout": 0.3, "mid_dropout": 0.3,
                         "final_dropout": 0.35, "lstm_impl": "scan"},
    "speller_configs": {"att_score": "additive", "att_proj_dim": 64, "att_heads": 4,
                        "dec_emb_dim": 128, "dec_lstm_hid_dim": 64, "dec_lstm_out_dim": 64,
                        "dec_lstm_dropout": 0.3, "decoder_impl": "scan"},
}
# The replay against the same pass run eagerly on the card: the same kernels
# on the same operands, but for the order of the index-add's atomics in the
# fed embeddings' gradient (a few bfloat16 steps of that leaf).
SAME = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# Against the step loop under autograd, which rounds elsewhere (the weights'
# gradients summed step by step in bfloat16, not once in float32), over the
# leaves of at least a hundredth of the median leaf's norm (smaller ones are
# sums that nearly cancel): tests/test_torch_chiu_las.py's tolerances.
LOOP = {torch.bfloat16: 6e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured only on the card")
    return torch.device("cuda")


def _case(device, dtype, seed, batch=8, t=48, steps=12):
    cfg = tlas.las_config_from_dicts(MODEL["listener_configs"], MODEL["speller_configs"])
    params = tlas.las_init(cfg, torch.Generator().manual_seed(3)).to(device)
    g = torch.Generator().manual_seed(seed)
    lx = torch.randint(t // 2, t + 1, (batch,), generator=g)
    lx[0] = t
    x = torch.randn(batch, t, 8, generator=g) * (torch.arange(t)[None, :, None] < lx[:, None, None])
    y = torch.randint(1, 29, (batch, steps), generator=g, dtype=torch.int32)
    draws = tlas.draw_train_noise(cfg, batch, steps, g, "cpu")
    draws = tlas.TrainDraws([m.to(device) for m in draws.listener_masks],
                            draws.coins.to(device), draws.m1.to(device), draws.m2.to(device),
                            None)
    return cfg, params, (x.to(device, dtype), lx.to(device), y.to(device), draws)


def _speller(params, cfg, enc_h, enc_l, y, tf_rate, draws, route):
    """``speller_apply``'s training decode on ``route``: "graph" (the
    Function, replayed), "eager" (the Function, not captured) or "loop" (the
    step loop under autograd)."""
    sp = tlas.cast_params(params, enc_h.dtype)
    feeds = tlas.teacher_forcing(sp, cfg, y, tf_rate, draws)
    cache, state, wgts0 = tlas.speller_start(sp, cfg, enc_h, enc_l)
    if route == "loop":
        return tlas.speller_loop(sp, cfg, cache, state, wgts0, y.shape[1], *feeds)
    return additive_decode.additive_decode_train(sp, cfg, cache, state, wgts0, *feeds,
                                                 capture=route == "graph")


def _pass(cfg, params, case, route):
    """(output, gradients) of a training pass with the decode on ``route``."""
    x, lx, y, draws = case
    enc_h, enc_l = tlas.listener_apply(params["listener"], cfg.listener, x, lx, True,
                                       masks=draws.listener_masks)
    out = _speller(params["speller"], cfg.speller, enc_h, enc_l, y, 0.7, draws, route)
    grads = torch.autograd.grad(out.logits.float().square().sum(), list(params.parameters()))
    return out, grads


def _gap(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _worst(got, want):
    norms = [float(w.norm()) for w in want]
    floor = 1e-2 * sorted(norms)[len(norms) // 2]
    return max(_gap(a, b) for a, b, n in zip(got, want, norms) if n >= floor)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_captured_decode_matches_the_step_loop(cuda_device, dtype):
    cfg, params, _ = _case(cuda_device, dtype, 0)
    additive_decode._GRAPHS.clear()
    for seed in (1, 2, 3):  # the first captures, the others replay on fresh operands
        case = _case(cuda_device, dtype, seed)[2]
        speller_cuda.reset_launch_counts()
        got, got_g = _pass(cfg, params, case, "graph")
        torch.cuda.synchronize()
        steps = case[2].shape[1]
        # one a decode step and one for the initial query; the first pass
        # also runs each loop once before it captures it
        made = steps * (2 if seed == 1 else 1) + 1
        assert (speller_cuda.LAUNCHES["speller_additive_scores"],
                speller_cuda.LAUNCHES["speller_additive_scores_bwd"]) == (made, made)
        same, same_g = _pass(cfg, params, case, "eager")
        assert _gap(got.logits, same.logits) <= SAME[dtype]
        assert _gap(got.att_map, same.att_map) <= SAME[dtype]
        for a, b in zip(got_g, same_g):
            assert _gap(a, b) <= SAME[dtype]
        loop, loop_g = _pass(cfg, params, case, "loop")
        assert _gap(got.logits, loop.logits) <= SAME[dtype]
        assert _worst(got_g, loop_g) <= LOOP[dtype]
    assert len(additive_decode._GRAPHS) == 1


@pytest.mark.cuda
def test_a_held_shape_runs_eagerly_and_agrees(cuda_device):
    """Two passes of one shape before either backward: the second runs
    eagerly, and the summed gradient is that of the two passes run eagerly."""
    cfg, params, case = _case(cuda_device, torch.bfloat16, 4)
    case2 = _case(cuda_device, torch.bfloat16, 5)[2]
    additive_decode._GRAPHS.clear()
    outs = []
    for c in (case, case2):
        x, lx, y, draws = c
        outs.append(tlas.las_apply(params, cfg, x, lx, dec_y=y, tf_rate=0.7, train=True,
                                   draws=draws))
    (graphs,) = additive_decode._GRAPHS.values()
    assert graphs.busy()
    loss = sum(o.logits.float().square().sum() for o in outs)
    got = torch.autograd.grad(loss, list(params.parameters()))
    assert not graphs.busy()
    want = [a + b for a, b in zip(_pass(cfg, params, case, "eager")[1],
                                  _pass(cfg, params, case2, "eager")[1])]
    for a, b in zip(got, want):
        assert _gap(a, b) <= SAME[torch.bfloat16]
    # a pass whose autograd graph is dropped without a backward holds nothing
    x, lx, y, draws = case
    tlas.las_apply(params, cfg, x, lx, dec_y=y, tf_rate=0.7, train=True, draws=draws)
    assert not graphs.busy()


@pytest.mark.cuda
def test_shapes_past_the_cap_run_eagerly(cuda_device, monkeypatch):
    """With the card's free memory below twice the first shape's graphs, a
    second shape runs eagerly; the first still replays."""
    additive_decode._GRAPHS.clear()
    total = torch.cuda.mem_get_info(cuda_device)[1]
    graphs = []
    cfg, params, _ = _case(cuda_device, torch.bfloat16, 0)
    for steps in (12, 9, 12):
        case = _case(cuda_device, torch.bfloat16, steps, steps=steps)[2]
        got = _pass(cfg, params, case, "graph")[1]
        want = _pass(cfg, params, case, "eager")[1]
        for a, b in zip(got, want):
            assert _gap(a, b) <= SAME[torch.bfloat16]
        if not graphs:
            (first,) = graphs = list(additive_decode._GRAPHS.values())
            assert first.bytes > 0
            monkeypatch.setattr(torch.cuda, "mem_get_info",
                                lambda device=None: (2 * first.bytes - 1, total))
    assert list(additive_decode._GRAPHS.values()) == graphs


@pytest.mark.cuda
def test_the_chiu_shapes_capture_and_replay(cuda_device):
    """The cell's speller shapes (B=128, Te=512, 64 steps here) at
    chiu-las's speller widths: two replays give the same logits, those of
    the pass run eagerly."""
    model = copy.deepcopy(MODEL)
    model["speller_configs"].update(att_proj_dim=1024, dec_emb_dim=2048, dec_lstm_hid_dim=1024,
                                    dec_lstm_out_dim=1024)
    cfg = tlas.las_config_from_dicts(model["listener_configs"], model["speller_configs"])
    params = tlas.las_init(cfg, torch.Generator().manual_seed(3)).to(cuda_device)
    sp = tlas.cast_params(params["speller"], torch.bfloat16)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    enc = torch.randn(128, 512, 64, generator=g, device=cuda_device).to(torch.bfloat16)
    enc_l = torch.randint(237, 513, (128,), generator=g, device=cuda_device)
    y = torch.randint(1, 29, (128, 64), generator=g, device=cuda_device, dtype=torch.int32)
    draws = tlas.TrainDraws([], torch.rand(64, generator=g, device=cuda_device),
                            torch.rand(64, 128, 1024, generator=g, device=cuda_device) < 0.7,
                            torch.rand(64, 128, 1024, generator=g, device=cuda_device) < 0.7, None)
    additive_decode._GRAPHS.clear()
    with torch.no_grad():
        outs = [_speller(sp, cfg.speller, enc, enc_l, y, 0.9, draws, route).logits
                for route in ("graph", "graph", "eager")]
    assert torch.equal(outs[0], outs[1])
    assert _gap(outs[1], outs[2]) <= SAME[torch.bfloat16]
