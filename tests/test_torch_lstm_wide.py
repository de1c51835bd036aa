"""PyTorch port, the wide-layer route of the listener in training: the plain
version of kernel ``lstm_bwd`` (the adjoint without dW_hh) and the outside
``dW_hh`` product against the JAX package's ``_backward_pallas`` in interpret
mode and ``_dw_outside_einsum``; the autograd Functions on that route against
the Pallas VJP forced onto it; and ``remat`` in the stacks. Toy widths: the
route is forced by lowering both packages' thresholds inside a test, no file
of either package changes. The kernel itself is tested on the card by
test_torch_lstm_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_las as ttl
import test_torch_train_lstm as ttlstm
from attention_based_e2e_asr_dnn_tpu.ops import lstm_pallas as jlp
from attention_based_e2e_asr_dnn_tpu.ops.precision import matmul_precision
from attention_based_e2e_asr_dnn_tpu.training import steps as jsteps
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda
from attention_based_e2e_asr_dnn_tpu_torch.training import optim as toptim
from attention_based_e2e_asr_dnn_tpu_torch.training import steps as tsteps

torch.set_num_threads(1)

ATOL_F32 = 2e-5  # float32: the same arithmetic summed in another order
H = ttlstm.H
LENGTHS, B, T = ttlstm.LENGTHS, ttlstm.B, ttlstm.T


def _bf16_steps(ref: np.ndarray, n: int) -> float:
    """``n`` bfloat16 steps (2**-8 relative) of the tensor's largest entry."""
    return n * 2.0 ** -8 * max(float(np.abs(ref).max()), 1e-3)


@pytest.fixture
def wide_route(monkeypatch):
    """Both packages take the route of a layer too wide for the in-kernel
    dW_hh at the toy width: the JAX VJP ``_backward_pallas`` plus
    ``_dw_outside_einsum``, the port ``lstm_bwd`` plus ``dw_hh_outside``.
    Yields the calls the port's route made."""
    monkeypatch.setattr(jlp, "_dw_kernel_fits", lambda *a: False)
    monkeypatch.setattr(lstm_cuda, "_BWD_DW_MAX_HIDDEN", H // 2)
    calls = []
    for name in ("lstm_bwd", "lstm_bwd_dw", "dw_hh_outside"):
        def counted(*args, _fn=getattr(lstm_cuda, name), _name=name):
            calls.append(_name)
            return _fn(*args)

        monkeypatch.setattr(lstm_cuda, name, counted)
    return calls


# ---------------------------------------------------------------------------
# lstm_bwd_plain and dw_hh_outside against the Pallas adjoint without dW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_lstm_bwd_plain_matches_pallas_adjoint(reverse, dtype_name):
    """The same saved streams (the port's training forward, one direction)
    through ``lstm_bwd_plain`` / ``dw_hh_outside`` and through
    ``_backward_pallas(interpret=True)`` / ``_dw_outside_einsum``. float32:
    atol 2e-5. bfloat16: dpre within two bf16 steps of its largest entry (one
    flipped rounding carries along the recurrence), dW_hh within two steps."""
    t_dtype, j_dtype = ((torch.float32, jnp.float32) if dtype_name == "float32"
                        else (torch.bfloat16, jnp.bfloat16))
    rng = np.random.default_rng(40 + reverse)
    k = 1.0 / np.sqrt(H)
    w_hh = torch.from_numpy(rng.uniform(-k, k, (1, H, 4 * H)).astype(np.float32)).to(t_dtype)
    x_proj = torch.from_numpy(rng.standard_normal((B, T, 4 * H)).astype(np.float32)).to(t_dtype)
    dy = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32)).to(t_dtype)
    lengths = torch.from_numpy(LENGTHS)
    hs, cs, gates = lstm_cuda.lstm_scan_train(x_proj, w_hh, lengths, (reverse,))
    dpre = lstm_cuda.lstm_bwd(gates, cs, dy, w_hh, lengths, (reverse,))
    d_whh = lstm_cuda.dw_hh_outside(hs, dpre, (reverse,))[0]
    assert dpre.dtype == t_dtype and d_whh.dtype == torch.float32
    # with dW_hh in the loop: the same dpre bit for bit, the same sum
    both = lstm_cuda.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, (reverse,))
    assert torch.equal(both[0], dpre)
    np.testing.assert_allclose(d_whh.numpy(), both[1][0].numpy(),
                               atol=1e-5 * float(both[1].abs().max()))

    def tm(t):  # (B, T, X) -> time-major jax array in the stream dtype
        return jnp.asarray(t.float().numpy().transpose(1, 0, 2), j_dtype)

    j_gates, j_cs, j_hs, j_dy = tm(gates), tm(cs), tm(hs), tm(dy)
    zero_row = jnp.zeros((1, B, H), j_dtype)
    c_prev = (jnp.concatenate([j_cs[1:], zero_row]) if reverse
              else jnp.concatenate([zero_row, j_cs[:-1]]))
    mask = jnp.asarray((np.arange(T)[:, None] < LENGTHS[None, :]).astype(np.float32))
    j_w = jnp.asarray(w_hh[0].float().numpy(), j_dtype)
    j_dpre = jlp._backward_pallas(j_w, mask, j_gates, j_cs, c_prev, j_dy, interpret=True,
                                  reverse=reverse)
    j_dw = jlp._dw_outside_einsum(j_hs, j_dpre, reverse, matmul_precision(j_dtype))
    ref_dpre = np.asarray(j_dpre, np.float32).transpose(1, 0, 2)
    ref_dw = np.asarray(j_dw, np.float32)
    if dtype_name == "float32":
        np.testing.assert_allclose(dpre.numpy(), ref_dpre, atol=ATOL_F32)
        np.testing.assert_allclose(d_whh.numpy(), ref_dw, atol=ATOL_F32, rtol=1e-5)
    else:
        np.testing.assert_allclose(dpre.float().numpy(), ref_dpre, atol=_bf16_steps(ref_dpre, 2))
        np.testing.assert_allclose(d_whh.numpy(), ref_dw, atol=_bf16_steps(ref_dw, 2))
    pads = np.arange(T)[None, :] >= LENGTHS[:, None]
    assert np.all(dpre.float().numpy()[pads] == 0.0)


# in_dim 5 takes the fused-input Function, 160 the x_proj Function (> 128)
@pytest.mark.parametrize("in_dim", [5, 160])
@pytest.mark.parametrize("reverse", [False, True])
def test_wide_route_function_matches_pallas_vjp_fp32(wide_route, in_dim, reverse):
    rng = np.random.default_rng(500 + in_dim + reverse)
    params = ttlstm._lstm_params(rng, in_dim)
    x = rng.standard_normal((B, T, in_dim)).astype(np.float32)
    ref = ttlstm._jax_grads(lambda p, xx, ll, interpret: jlp.lstm_apply_pallas(
        p, xx, ll, reverse=reverse, interpret=interpret), params, x, LENGTHS, jnp.float32)
    ours = ttlstm._torch_grads(
        lambda p, xx, ll: lstm_cuda.lstm_apply_kernel(p, xx, ll, reverse),
        params, x, LENGTHS, torch.float32)
    assert wide_route == ["lstm_bwd", "dw_hh_outside"]
    # float32 atol 2e-5 on hs and every gradient: summation order only
    np.testing.assert_allclose(ours[0], ref[0], atol=ATOL_F32)
    ttlstm._assert_tree_close(ours[1], ref[1], atol=ATOL_F32, rtol=1e-5)
    np.testing.assert_allclose(ours[2], ref[2], atol=ATOL_F32, rtol=1e-5)


@pytest.mark.parametrize("in_dim", [5, 160])
def test_wide_route_bilstm_matches_pallas_vjp(wide_route, in_dim):
    """Both directions in one Function call on the wide route, float32 (atol
    2e-5) and bfloat16 (two bf16 steps of each tensor's largest entry; four
    for the wide input's bias gradient, a sum of B * T bf16 terms taken by XLA
    there and by PyTorch here)."""
    rng = np.random.default_rng(600 + in_dim)
    params = {"fwd": ttlstm._lstm_params(rng, in_dim), "bwd": ttlstm._lstm_params(rng, in_dim)}
    x = rng.standard_normal((B, T, in_dim)).astype(np.float32)
    ref = ttlstm._jax_grads(jlp.bilstm_apply_pallas, params, x, LENGTHS, jnp.float32)
    ours = ttlstm._torch_grads(lstm_cuda.bilstm_apply_kernel, params, x, LENGTHS, torch.float32)
    assert wide_route == ["lstm_bwd", "dw_hh_outside"]
    np.testing.assert_allclose(ours[0], ref[0], atol=ATOL_F32)
    ttlstm._assert_tree_close(ours[1], ref[1], atol=ATOL_F32, rtol=1e-5)
    np.testing.assert_allclose(ours[2], ref[2], atol=ATOL_F32, rtol=1e-5)

    ref = ttlstm._jax_grads(jlp.bilstm_apply_pallas, params, x, LENGTHS, jnp.bfloat16)
    ours = ttlstm._torch_grads(lstm_cuda.bilstm_apply_kernel, params, x, LENGTHS,
                               torch.bfloat16)
    np.testing.assert_allclose(ours[0], ref[0], atol=_bf16_steps(ref[0], 2))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours[1]),
                            jax.tree.leaves(ref[1])):
        steps = 4 if in_dim > 128 and "'b'" in str(path) else 2
        np.testing.assert_allclose(a, b, atol=_bf16_steps(b, steps), err_msg=str(path))
    np.testing.assert_allclose(ours[2], ref[2], atol=_bf16_steps(ref[2], 2))


def test_narrow_layers_keep_the_in_kernel_dw_route(monkeypatch):
    """Up to H = 512 the Functions stay on ``lstm_bwd_dw``."""
    calls = []
    for name in ("lstm_bwd", "lstm_bwd_dw"):
        def counted(*args, _fn=getattr(lstm_cuda, name), _name=name):
            calls.append(_name)
            return _fn(*args)

        monkeypatch.setattr(lstm_cuda, name, counted)
    x_proj = torch.zeros(2, 4, 4 * H, requires_grad=True)
    hs = lstm_cuda.lstm_scan(x_proj, torch.zeros(1, H, 4 * H), torch.tensor([4, 2]), (False,))
    hs.sum().backward()
    assert calls == ["lstm_bwd_dw"]


def test_adjoint_without_dw_raises_off_cpu_without_cuda():
    """A non-CPU tensor goes to the kernel or raises; never the plain loop."""
    g = torch.empty(2, 4, 128, device="meta")
    h = torch.empty(2, 4, 32, device="meta")
    with pytest.raises(ValueError, match="lstm_bwd: kernel needs CUDA tensors"):
        lstm_cuda.lstm_bwd(g, h, h, torch.empty(1, 32, 128, device="meta"),
                           torch.ones(2, dtype=torch.int32), (False,))


@pytest.mark.parametrize("ndir,hidden,sms,want", [
    (2, 512, 132, [(0, 2)]),             # base-LAS: both directions in one launch
    (2, 1024, 132, [(0, 1), (1, 1)]),    # scaled-LAS: one launch a direction
    (1, 1024, 132, [(0, 1)]),
    (2, 768, 132, [(0, 1), (1, 1)]),
])
def test_direction_groups(ndir, hidden, sms, want):
    assert lstm_cuda._direction_groups("k", ndir, hidden, sms) == want
    assert lstm_cuda._staged_width(hidden) == (hidden if hidden <= 512 else hidden // 2)


def test_direction_groups_raise_past_the_card():
    with pytest.raises(ValueError, match="H=2048 needs 256 co-resident blocks"):
        lstm_cuda._direction_groups("k", 1, 2048, 132)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _listener(seed, impl, remat):
    cfg = ttl._port_cfg(ttl.CFG, impl).listener
    cfg = dataclasses.replace(cfg, remat=remat)
    params = tlas.las_from_jax_params(ttl._params(ttl.CFG, seed))["listener"]
    return cfg, params


@pytest.mark.parametrize("impl", ["pallas", "scan"])
def test_remat_gradients_equal_bit_for_bit(impl):
    """The listener in training with ``remat`` on against off: the output and
    every gradient bit-equal (the second forward repeats the first: the
    dropout masks are inputs)."""
    x, _ = ttl._batch()
    gen = torch.Generator().manual_seed(3)
    masks = [torch.rand(ttl.B, 1, 64, generator=gen) < 0.7 for _ in range(3)]
    out = {}
    for remat in (False, True):
        cfg, params = _listener(0, impl, remat)
        xx = torch.from_numpy(x).requires_grad_(True)
        enc, enc_l = tlas.listener_apply(params, cfg, xx, torch.from_numpy(ttl.LX), True, masks)
        grads = torch.autograd.grad((enc ** 2).sum(), [xx, *params.parameters()])
        out[remat] = (enc.detach(), enc_l, *grads)
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)
    assert any(float(g.abs().max()) > 0 for g in out[True][2:])


def test_remat_first_pass_runs_the_lean_forward(monkeypatch):
    """With ``remat`` the first pass of each layer is the lean forward (no cs,
    no gates); the training forward and the adjoint run in the backward pass.
    Without a gradient wanted, or in eval, nothing is wrapped."""
    calls = []
    for name in ("lstm_scan_plain", "lstm_scan_fusedin_plain", "lstm_scan_train_plain",
                 "lstm_scan_fusedin_train_plain", "lstm_bwd_dw_plain"):
        def counted(*args, _fn=getattr(lstm_cuda, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)

        monkeypatch.setattr(lstm_cuda, name, counted)
    cfg, params = _listener(0, "pallas", True)
    x = torch.from_numpy(ttl._batch()[0])
    enc, _ = tlas.listener_apply(params, cfg, x, torch.from_numpy(ttl.LX), True, [None] * 3)
    # at this width every layer's input (15, then 2 x 64) is narrow enough for
    # the fused-input kernels
    assert calls == ["lstm_scan_fusedin_plain"] * 3
    del calls[:]
    enc.sum().backward()
    # backwards through the layers: each recomputed by its training forward,
    # then differentiated by the adjoint
    assert calls == ["lstm_scan_fusedin_train_plain", "lstm_bwd_dw_plain"] * 3
    del calls[:]
    with torch.no_grad():
        enc, _ = tlas.listener_apply(params, cfg, x, torch.from_numpy(ttl.LX))
    assert enc.grad_fn is None and calls == ["lstm_scan_fusedin_plain"] * 3


def test_train_step_with_remat_matches_jax():
    """A whole float32 train step with ``remat: true`` in both packages,
    SpecAugment, dropout and coins replayed: loss, grad_norm, every parameter
    and optimizer leaf. Tolerances as
    test_torch_train_las.py::test_two_train_steps_match_jax."""
    cfg = dataclasses.replace(ttl.CFG, listener=dataclasses.replace(ttl.CFG.listener,
                                                                    remat=True))
    params = ttl._params(cfg)
    x, y = ttl._batch()
    tx, j_step = ttl._jax_step_fn(cfg, 5.0)
    j_state = jsteps.create_train_state(ttl._jax(params), tx, jax.random.key(1))
    opt, t_step = ttl._port_step_fn(cfg, 5.0)
    state = tsteps.create_train_state(tlas.las_from_jax_params(params), opt, device="cpu")
    ams = ttl._amsgrad_state(j_state.opt_state)
    state.opt_state = toptim.opt_state_from_optax(
        state.params, ams.count, *(jax.tree.map(np.asarray, t) for t in
                                   (ams.mu, ams.nu, ams.nu_max)))
    _, draws = ttl.replay_train_draws(j_state.rng, cfg, ttl.B, ttl.L, use_specaug=True, time=10)
    j_state, j_metrics, j_att = j_step(j_state, jnp.asarray(x), jnp.asarray(ttl.LX),
                                       jnp.asarray(y), jnp.asarray(ttl.LY), 0.5, 1e-3)
    state, metrics, att = t_step(state, *(torch.from_numpy(a) for a in (x, ttl.LX, y, ttl.LY)),
                                 0.5, 1e-3, draws=draws)
    for name in ("loss", "ppl", "grad_norm", "n_tokens"):
        np.testing.assert_allclose(float(metrics[name]), float(j_metrics[name]),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(att.numpy(), np.asarray(j_att), atol=ATOL_F32)
    ttl._assert_state_matches(state, j_state, atol=1e-5, rtol=1e-4)
