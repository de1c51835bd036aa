"""PyTorch port, the LSTM training forward and its adjoint: the plain
versions of kernels ``lstm_scan_train`` / ``lstm_scan_fusedin_train`` /
``lstm_bwd_dw`` and the autograd Functions over them (their CPU route)
against the JAX package's Pallas route in interpret mode, forward and
``jax.grad``. The kernels themselves are tested on the card by
test_torch_lstm_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu.ops.lstm_pallas import (
    bilstm_apply_pallas,
    lstm_apply_pallas,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm as tlstm
from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda

torch.set_num_threads(1)

# float32: the same arithmetic summed in another order
ATOL_F32 = 2e-5
H = 32
LENGTHS = np.array([12, 7, 1, 9, 12], np.int32)   # a length-1 row and full rows
B, T = len(LENGTHS), 12


def _lstm_params(rng, in_dim, hidden=H):
    k = 1.0 / np.sqrt(hidden)
    return {"w_ih": rng.uniform(-k, k, (in_dim, 4 * hidden)).astype(np.float32),
            "w_hh": rng.uniform(-k, k, (hidden, 4 * hidden)).astype(np.float32),
            "b": rng.uniform(-k, k, (4 * hidden,)).astype(np.float32)}


def _torch_leaves(tree, dtype=torch.float32):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)).to(dtype).requires_grad_(True), tree)


def _jax_grads(fn, params, x, lengths, dtype):
    """hs and the gradients of sum(hs**2) w.r.t. (params, x) through the
    Pallas route in interpret mode, the inputs in ``dtype``."""
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    x = jnp.asarray(x, dtype)

    def loss(p, xx):
        hs = fn(p, xx, jnp.asarray(lengths), interpret=True)
        return jnp.sum(hs.astype(jnp.float32) ** 2), hs

    (_, hs), (g_p, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
    to_np = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return to_np(hs), jax.tree.map(to_np, g_p), to_np(g_x)


def _torch_grads(fn, params, x, lengths, dtype):
    params = _torch_leaves(params, dtype)
    x = torch.from_numpy(x).to(dtype).requires_grad_(True)
    hs = fn(params, x, torch.from_numpy(lengths))
    (hs.float() ** 2).sum().backward()
    to_np = lambda t: t.detach().float().numpy()  # noqa: E731
    return to_np(hs), jax.tree.map(lambda p: to_np(p.grad), params), to_np(x.grad)


def _assert_tree_close(ours, ref, atol, rtol=0.0):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=str(path))


# in_dim 5 takes the fused-input Function, 160 the x_proj Function (> 128)
@pytest.mark.parametrize("in_dim", [5, 160])
@pytest.mark.parametrize("reverse", [False, True])
def test_function_matches_pallas_vjp_fp32(in_dim, reverse):
    rng = np.random.default_rng(100 + in_dim + reverse)
    params = _lstm_params(rng, in_dim)
    x = rng.standard_normal((B, T, in_dim)).astype(np.float32)
    ref = _jax_grads(lambda p, xx, ll, interpret: lstm_apply_pallas(
        p, xx, ll, reverse=reverse, interpret=interpret), params, x, LENGTHS, jnp.float32)
    lstm_cuda.reset_launch_counts()
    ours = _torch_grads(lambda p, xx, ll: lstm_cuda.lstm_apply_kernel(p, xx, ll, reverse),
                        params, x, LENGTHS, torch.float32)
    assert not any(lstm_cuda.LAUNCHES.values())   # CPU tensors: the plain versions
    # float32 atol 2e-5 on hs and every gradient: summation order only
    np.testing.assert_allclose(ours[0], ref[0], atol=ATOL_F32)
    _assert_tree_close(ours[1], ref[1], atol=ATOL_F32, rtol=1e-5)
    np.testing.assert_allclose(ours[2], ref[2], atol=ATOL_F32, rtol=1e-5)
    # no gradient reaches a padded frame of x
    pads = np.arange(T)[None, :] >= LENGTHS[:, None]
    assert np.all(ours[2][pads] == 0.0) and np.any(ours[2][~pads] != 0.0)


@pytest.mark.parametrize("in_dim", [5, 160])
def test_bilstm_function_matches_pallas_vjp_fp32(in_dim):
    """Both directions in one Function call against the JAX package's
    direction-per-kernel BiLSTM."""
    rng = np.random.default_rng(200 + in_dim)
    params = {"fwd": _lstm_params(rng, in_dim), "bwd": _lstm_params(rng, in_dim)}
    x = rng.standard_normal((B, T, in_dim)).astype(np.float32)
    ref = _jax_grads(bilstm_apply_pallas, params, x, LENGTHS, jnp.float32)
    ours = _torch_grads(lstm_cuda.bilstm_apply_kernel, params, x, LENGTHS, torch.float32)
    np.testing.assert_allclose(ours[0], ref[0], atol=ATOL_F32)
    _assert_tree_close(ours[1], ref[1], atol=ATOL_F32, rtol=1e-5)
    np.testing.assert_allclose(ours[2], ref[2], atol=ATOL_F32, rtol=1e-5)


@pytest.mark.parametrize("in_dim", [5, 160])
@pytest.mark.parametrize("reverse", [False, True])
def test_function_matches_pallas_vjp_bf16(in_dim, reverse):
    """bfloat16 streams: the port rounds where the Pallas kernels round
    (saved gates and cs, dpre before both products, the weight gradients at
    the end). Tolerance: two bf16 steps (2 * 2**-8 relative) of the largest
    magnitude of the compared tensor, since an order difference that flips
    one rounding carries along the recurrence."""
    rng = np.random.default_rng(300 + in_dim + reverse)
    params = _lstm_params(rng, in_dim)
    x = rng.standard_normal((B, T, in_dim)).astype(np.float32)
    ref = _jax_grads(lambda p, xx, ll, interpret: lstm_apply_pallas(
        p, xx, ll, reverse=reverse, interpret=interpret), params, x, LENGTHS, jnp.bfloat16)
    ours = _torch_grads(lambda p, xx, ll: lstm_cuda.lstm_apply_kernel(p, xx, ll, reverse),
                        params, x, LENGTHS, torch.bfloat16)

    def two_steps(b, steps=2):
        return steps * 2.0 ** -8 * max(float(np.abs(b).max()), 1e-3)

    np.testing.assert_allclose(ours[0], ref[0], atol=two_steps(ref[0]))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours[1]),
                            jax.tree.leaves(ref[1])):
        # the wide route's bias gradient is a sum of B * T bfloat16 terms taken
        # outside any kernel, by XLA there and by PyTorch here, each with its
        # own accumulation: four steps
        steps = 4 if in_dim > 128 and "'b'" in str(path) else 2
        np.testing.assert_allclose(a, b, atol=two_steps(b, steps), err_msg=str(path))
    np.testing.assert_allclose(ours[2], ref[2], atol=two_steps(ref[2]))


def test_function_takes_batch_past_one_launch():
    """B = 40 > the 32 rows of one launch (on the card: two launches whose
    partial dW_hh are summed; here the plain version at the same shape)."""
    rng = np.random.default_rng(7)
    lengths = rng.integers(1, 9, 40).astype(np.int32)
    lengths[0], lengths[39] = 8, 1
    params = _lstm_params(rng, 5)
    x = rng.standard_normal((40, 8, 5)).astype(np.float32)
    ref = _jax_grads(lambda p, xx, ll, interpret: lstm_apply_pallas(
        p, xx, ll, interpret=interpret), params, x, lengths, jnp.float32)
    ours = _torch_grads(lstm_cuda.lstm_apply_kernel, params, x, lengths, torch.float32)
    np.testing.assert_allclose(ours[0], ref[0], atol=ATOL_F32)
    _assert_tree_close(ours[1], ref[1], atol=ATOL_F32, rtol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_explicit_adjoint_equals_autograd_fp32(fused):
    """``lstm_bwd_dw_plain`` (the adjoint written out step by step) against
    autograd through the forward loop ``_scan_plain``; float32, so the
    roundings of the explicit adjoint are no-ops. atol 1e-5: summation order."""
    gen = torch.Generator().manual_seed(3)
    lengths = torch.from_numpy(LENGTHS)
    k = H ** -0.5
    w_hh = ((torch.rand(2, H, 4 * H, generator=gen) * 2 - 1) * k).requires_grad_(True)
    if fused:
        x = torch.randn(B, T, 5, generator=gen).requires_grad_(True)
        w_ih = ((torch.rand(2, 5, 4 * H, generator=gen) * 2 - 1) * k).requires_grad_(True)
        b = ((torch.rand(2, 4 * H, generator=gen) * 2 - 1) * k).requires_grad_(True)
        leaves = (x, w_ih, b, w_hh)
        plain = lstm_cuda.lstm_scan_fusedin_plain(x, w_ih, b, w_hh, lengths, (False, True))
        routed = lstm_cuda.lstm_scan_fusedin(x, w_ih, b, w_hh, lengths, (False, True))
    else:
        x_proj = torch.randn(B, T, 2 * 4 * H, generator=gen).requires_grad_(True)
        leaves = (x_proj, w_hh)
        plain = lstm_cuda.lstm_scan_plain(x_proj, w_hh, lengths, (False, True))
        routed = lstm_cuda.lstm_scan(x_proj, w_hh, lengths, (False, True))
    assert type(routed.grad_fn).__name__.startswith("_LstmScan")
    torch.testing.assert_close(routed, plain, atol=0, rtol=0)
    dy = torch.randn(plain.shape, generator=gen)
    want = torch.autograd.grad(plain, leaves, dy)
    got = torch.autograd.grad(routed, leaves, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_train_streams_keep_carry_at_pads():
    """cs holds the frozen carry at padded frames (the adjoint indexes it as
    c_prev), hs and the gates are zero there, and hs equals the lean
    forward's bit for bit."""
    gen = torch.Generator().manual_seed(5)
    lengths = torch.from_numpy(LENGTHS)
    x_proj = torch.randn(B, T, 2 * 4 * H, generator=gen)
    w_hh = (torch.rand(2, H, 4 * H, generator=gen) - 0.5) * 0.3
    hs, cs, gates = lstm_cuda.lstm_scan_train(x_proj, w_hh, lengths, (False, True))
    assert torch.equal(hs, lstm_cuda.lstm_scan(x_proj, w_hh, lengths, (False, True)))
    pads = torch.arange(T)[None, :] >= lengths[:, None]
    assert hs[pads].abs().max() == 0 and gates[pads].abs().max() == 0
    # forward direction: the carry after the last valid frame; reverse: zero
    row = 1
    assert torch.equal(cs[row, LENGTHS[row]:, :H],
                       cs[row, LENGTHS[row] - 1, :H].expand(T - LENGTHS[row], H))
    assert cs[row, LENGTHS[row]:, H:].abs().max() == 0


def test_wrappers_stay_lean_without_grad():
    """No gradient wanted: the lean forward (no autograd Function)."""
    x_proj = torch.zeros(2, 4, 4 * H, requires_grad=True)
    w_hh = torch.zeros(1, H, 4 * H)
    lengths = torch.tensor([4, 2], dtype=torch.int32)
    with torch.no_grad():
        assert lstm_cuda.lstm_scan(x_proj, w_hh, lengths, (False,)).grad_fn is None
    assert lstm_cuda.lstm_scan(x_proj.detach(), w_hh, lengths, (False,)).grad_fn is None


def test_adjoint_wrapper_raises_off_cpu_without_cuda():
    """A non-CPU tensor goes to the kernel or raises; never the plain loop."""
    g = torch.empty(2, 4, 128, device="meta")
    h = torch.empty(2, 4, 32, device="meta")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        lstm_cuda.lstm_bwd_dw(g, h, h, h, torch.empty(1, 32, 128, device="meta"),
                              torch.ones(2, dtype=torch.int32), (False,))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        lstm_cuda.lstm_scan_train(g, torch.empty(1, 32, 128, device="meta"),
                                  torch.ones(2, dtype=torch.int32), (False,))


@pytest.mark.parametrize("stack", ["locked", "pyramidal"])
def test_stack_remat_raises_in_training(stack):
    """``remat=True`` in training no longer raises (the name dates from when
    it did): the stack recomputes each layer in the backward pass, and the
    output and every gradient equal those of ``remat=False`` bit for bit."""
    gen = torch.Generator().manual_seed(9)
    fn = (tlstm.locked_lstm_stack_apply if stack == "locked"
          else tlstm.pyramidal_lstm_stack_apply)
    in_dim = 6 if stack == "locked" else 3  # the pyramid doubles its input

    def direction(d):
        return {"w_ih": (torch.rand(d, 4 * H, generator=gen) - 0.5) * 0.4,
                "w_hh": (torch.rand(H, 4 * H, generator=gen) - 0.5) * 0.4,
                "b": torch.rand(4 * H, generator=gen) - 0.5}

    widths = [6, 2 * H] if stack == "locked" else [6, 4 * H]
    params = [{"fwd": direction(d), "bwd": direction(d)} for d in widths]
    leaves = [t.requires_grad_(True) for layer in params for p in layer.values()
              for t in p.values()]
    x = torch.randn(3, 8, in_dim, generator=gen).requires_grad_(True)
    lengths = torch.tensor([8, 5, 2])
    masks = [torch.rand(3, 1, 2 * H, generator=gen) < 0.8 for _ in params]
    kw = dict(impl="pallas", train=True, masks=masks, mid_dropout=0.2)
    kw.update({"init_dropout": 0.2} if stack == "locked" else {"final_dropout": 0.2})
    grads = {}
    for remat in (False, True):
        y, _ = fn(params, x, lengths, remat=remat, **kw)
        grads[remat] = (y.detach(), *torch.autograd.grad(y.square().sum(), [x, *leaves]))
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)
