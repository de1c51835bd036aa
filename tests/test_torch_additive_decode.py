"""PyTorch port, the additive score's training decode as one autograd
Function (``models/additive_decode.py``) against the step loop under
autograd (``models/las.py::speller_loop``), on the CPU at a small size of chiu-las's
structure (stacking 3 / 3, flat BiLSTM, 4 heads, dropout, teacher forcing
at 0.7 so that both fed-back and gold embeddings are read). Free of JAX."""

import copy

import pytest
import torch

from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.models import additive_decode

MODEL = {
    "listener_configs": {"input_dim": 6, "stack_left": 3, "stack_stride": 3,
                         "uniform_hid_dim": 16, "lstm_layers": 2, "plstm_layers": 0,
                         "bidirectional": True, "init_dropout": 0.3, "mid_dropout": 0.3,
                         "final_dropout": 0.35, "lstm_impl": "pallas"},
    "speller_configs": {"att_score": "additive", "att_proj_dim": 16, "att_heads": 4,
                        "dec_emb_dim": 32, "dec_lstm_hid_dim": 16, "dec_lstm_out_dim": 24,
                        "dec_lstm_dropout": 0.3, "decoder_impl": "pallas"},
}


def _case(dtype, seed=0, batch=5, t=31, steps=11, model=MODEL):
    cfg = tlas.las_config_from_dicts(model["listener_configs"], model["speller_configs"])
    params = tlas.las_init(cfg, torch.Generator().manual_seed(3))
    if dtype == torch.float64:
        params = params.double()
    g = torch.Generator().manual_seed(seed)
    lx = torch.randint(4, t + 1, (batch,), generator=g)
    lx[0] = t
    x = torch.randn(batch, t, 6, generator=g) * (torch.arange(t)[None, :, None] < lx[:, None, None])
    y = torch.randint(1, 29, (batch, steps), generator=g, dtype=torch.int32)
    draws = tlas.draw_train_noise(cfg, batch, steps, g, "cpu")
    return cfg, params, x.to(dtype), lx, y, draws


def _loop(params, cfg, x, lx, dec_y, tf_rate, train, draws):
    """``las_apply``'s training pass with the decode on the step loop under
    autograd."""
    enc_h, enc_l = tlas.listener_apply(params["listener"], cfg.listener, x, lx, train,
                                       masks=draws.listener_masks)
    sp = tlas.cast_params(params["speller"], x.dtype)
    feeds = tlas.teacher_forcing(sp, cfg.speller, dec_y, tf_rate, draws)
    cache, state, wgts0 = tlas.speller_start(sp, cfg.speller, enc_h, enc_l)
    return tlas.speller_loop(sp, cfg.speller, cache, state, wgts0, dec_y.shape[1], *feeds)


def _pass(case, function):
    cfg, params, x, lx, y, draws = case
    out = (tlas.las_apply if function else _loop)(params, cfg, x, lx, dec_y=y, tf_rate=0.7,
                                                  train=True, draws=draws)
    weights = torch.randn(out.logits.shape, generator=torch.Generator().manual_seed(9),
                          dtype=torch.float64)
    loss = (out.logits.double() * weights).sum()
    return out, torch.autograd.grad(loss, list(params.parameters()))


def _gap(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


# float64: the two differ in summation order only (measured 7e-14 on the
# worst leaf); float32 likewise (measured 3.7e-5, the attention key bias,
# a sum that nearly cancels under the softmax).
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 2e-4)])
def test_the_function_is_the_step_loop(dtype, tol):
    case = _case(dtype)
    got, got_g = _pass(case, True)
    want, want_g = _pass(case, False)
    assert got.logits.grad_fn.name() == "_AdditiveDecodeBackward"
    assert want.logits.grad_fn.name() != "_AdditiveDecodeBackward"
    assert torch.equal(got.logits, want.logits)
    assert torch.equal(got.att_map, want.att_map)
    for a, b in zip(got_g, want_g):
        assert _gap(a, b) <= tol


def test_bfloat16_logits_are_the_step_loops_and_the_gradient_no_further_from_float64():
    """The forward is the same operations; the adjoint sums the weights'
    gradients once in float32 where the loop sums step by step in
    bfloat16, so each speller leaf is at least about as close to the
    float64 gradient (measured: closer on all 20, by 1% (``v``) to 58%)."""
    case = _case(torch.bfloat16)
    got, got_g = _pass(case, True)
    want, want_g = _pass(case, False)
    assert torch.equal(got.logits, want.logits)
    _, exact = _pass(_case(torch.float64), True)
    names = [n for n, _ in case[1].named_parameters()]
    closer = 0
    for n, a, b, e in zip(names, got_g, want_g, exact):
        if n.startswith("speller."):
            assert _gap(a, e) <= 1.1 * _gap(b, e), n
            closer += _gap(a, e) <= _gap(b, e)
    assert closer >= 18


def test_the_other_passes_keep_the_step_loop():
    """init_force, the eval decode and a dot-product score take the step
    loop under autograd; a shape's pass without dropout or forcing draws
    runs the Function."""
    case = _case(torch.float32)
    cfg, params, x, lx, y, draws = case
    out = tlas.las_apply(params, cfg, x, lx, dec_y=y, tf_rate=0.7, train=True, draws=draws,
                         init_force=True)
    assert out.logits.grad_fn.name() != "_AdditiveDecodeBackward"
    with torch.no_grad():
        tlas.las_apply(params, cfg, x, lx)
    model = copy.deepcopy(MODEL)
    model["speller_configs"].update(att_score="dot", decoder_impl="scan")
    dot = _case(torch.float32, model=model)
    out, _ = _pass(dot, True)
    assert out.logits.grad_fn.name() != "_AdditiveDecodeBackward"
    out = tlas.las_apply(params, cfg, x, lx, dec_y=y, train=True)
    assert out.logits.grad_fn.name() == "_AdditiveDecodeBackward"


def test_the_cpu_never_captures():
    additive_decode._GRAPHS.clear()
    _pass(_case(torch.float32), True)
    assert additive_decode._GRAPHS == {}
