"""PyTorch port, the last two recurrence forms: the plain versions of
``lstm_scan_cs`` (the JAX ``_forward_pallas`` with ``with_cs=True``) and
``bilstm_scan_fused`` (``_forward_pallas_bi``), the autograd Function over the
latter against ``jax.vjp(pallas_bilstm_scan)``, and the op
``bilstm_apply_fused`` against ``bilstm_apply_pallas_fused`` and against the
port's two-kernel op ``bilstm_apply_kernel``. The JAX side runs its Pallas
kernels in interpret mode; the kernels themselves are tested on the card by
test_torch_lstm_cuda.py.

The port's kernels take lengths, the JAX ones a mask: the masks here are the
length masks the op builds (direction 1's flipped, so its pads come first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu.ops.lstm_pallas import (
    _forward_pallas,
    _forward_pallas_bi,
    _forward_pallas_train,
    bilstm_apply_pallas_fused,
    pallas_bilstm_scan,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda

torch.set_num_threads(1)

# float32: the same arithmetic summed in another order
ATOL_F32 = 2e-5
# bfloat16, forward streams: both sides carry h and c in float32 and round
# the same places; a summation-order difference can flip one rounding of h
# (2**-8 near 1, 2**-7 for |c| in [1, 2)), which the recurrence carries on
ATOL_BF16_FWD = 2.0 ** -6
# bfloat16, gradients: the JAX adjoint does its gate math and carries dh, dc
# in bfloat16, the port in float32 on gates rounded to bfloat16; over the
# largest entry of the reference tensor the difference stays within a few
# bfloat16 steps. Measured here at most 1.9e-2 (five steps); the bound is six.
RTOL_BF16_GRAD = 6 * 2.0 ** -8
LENGTHS = np.array([10, 7, 1, 9, 10], np.int32)   # a length-1 row and full rows
B, T = len(LENGTHS), 10


def _valid(lengths=LENGTHS, seq_len=T):
    return (np.arange(seq_len)[None, :] < lengths[:, None]).astype(np.float32)  # (B, T)


def _bi_inputs(rng, hidden):
    """xp (T, 2, B, 4H), w_hh (2, H, 4H), mask (T, 2, B) with direction 1's
    flipped, as ``bilstm_apply_pallas_fused`` builds them."""
    k = 1.0 / np.sqrt(hidden)
    xp = rng.standard_normal((T, 2, B, 4 * hidden)).astype(np.float32)
    w_hh = rng.uniform(-k, k, (2, hidden, 4 * hidden)).astype(np.float32)
    valid = _valid()
    mask = np.stack([valid, valid[:, ::-1]], 0).transpose(2, 0, 1)      # (T, 2, B)
    return xp, w_hh, np.ascontiguousarray(mask)


def _np(a):
    return np.asarray(a, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden", [32, 64])
def test_scan_cs_plain_matches_pallas_with_cs(reverse, hidden):
    rng = np.random.default_rng(300 + hidden + reverse)
    k = 1.0 / np.sqrt(hidden)
    x_proj = rng.standard_normal((B, T, 4 * hidden)).astype(np.float32)
    w_hh = rng.uniform(-k, k, (hidden, 4 * hidden)).astype(np.float32)
    hs, cs = _forward_pallas(jnp.asarray(x_proj.transpose(1, 0, 2)), jnp.asarray(w_hh),
                             jnp.asarray(_valid().T), interpret=True, reverse=reverse,
                             with_cs=True)
    got_hs, got_cs = lstm_cuda.lstm_scan_cs(_t(x_proj), _t(w_hh)[None], _t(LENGTHS, torch.int32),
                                            (reverse,))
    np.testing.assert_allclose(got_hs.numpy(), _np(hs).transpose(1, 0, 2), atol=ATOL_F32)
    np.testing.assert_allclose(got_cs.numpy(), _np(cs).transpose(1, 0, 2), atol=ATOL_F32)
    # the streams are those of the lean and of the training forms, bit for bit
    args = (_t(x_proj), _t(w_hh)[None], _t(LENGTHS, torch.int32), (reverse,))
    assert torch.equal(got_hs, lstm_cuda.lstm_scan_plain(*args))
    assert torch.equal(got_cs, lstm_cuda.lstm_scan_train_plain(*args)[1])
    assert got_hs[_valid() == 0].abs().max() == 0


def test_scan_cs_plain_two_directions_bf16():
    """Both directions side by side in bfloat16, against the JAX training
    forward's hs and cs (the same kernel with the gates bound)."""
    hidden = 32
    rng = np.random.default_rng(310)
    k = 1.0 / np.sqrt(hidden)
    x_proj = rng.standard_normal((B, T, 2 * 4 * hidden)).astype(np.float32)
    w_hh = rng.uniform(-k, k, (2, hidden, 4 * hidden)).astype(np.float32)
    got_hs, got_cs = lstm_cuda.lstm_scan_cs(
        _t(x_proj, torch.bfloat16), _t(w_hh, torch.bfloat16), _t(LENGTHS, torch.int32),
        (False, True))
    assert got_hs.dtype == got_cs.dtype == torch.bfloat16
    for d, rev in enumerate((False, True)):
        xp_d = jnp.asarray(x_proj[..., d * 4 * hidden:(d + 1) * 4 * hidden].transpose(1, 0, 2),
                           jnp.bfloat16)
        hs, cs, _ = _forward_pallas_train(xp_d, jnp.asarray(w_hh[d], jnp.bfloat16),
                                          jnp.asarray(_valid().T), interpret=True, reverse=rev)
        sl = slice(d * hidden, (d + 1) * hidden)
        np.testing.assert_allclose(got_hs[..., sl].float().numpy(), _np(hs).transpose(1, 0, 2),
                                   atol=ATOL_BF16_FWD)
        np.testing.assert_allclose(got_cs[..., sl].float().numpy(), _np(cs).transpose(1, 0, 2),
                                   atol=ATOL_BF16_FWD)


@pytest.mark.parametrize("hidden", [32, 64])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_bilstm_scan_fused_plain_matches_pallas_bi(hidden, dtype_name):
    """hs and cs over every frame, the padded ones included: direction 0
    holds the frozen carry there, direction 1 (pads first) zeros."""
    rng = np.random.default_rng(320 + hidden)
    xp, w_hh, mask = _bi_inputs(rng, hidden)
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    hs, cs = _forward_pallas_bi(jnp.asarray(xp, jdt), jnp.asarray(w_hh, jdt),
                                jnp.asarray(mask), interpret=True)
    got_hs, got_cs = lstm_cuda.bilstm_scan_fused(_t(xp, tdt), _t(w_hh, tdt),
                                                 _t(LENGTHS, torch.int32))
    assert got_hs.shape == got_cs.shape == (T, 2, B, hidden) and got_hs.dtype == tdt
    atol = ATOL_F32 if dtype_name == "float32" else ATOL_BF16_FWD
    np.testing.assert_allclose(got_hs.float().numpy(), _np(hs), atol=atol)
    np.testing.assert_allclose(got_cs.float().numpy(), _np(cs), atol=atol)
    pads = mask == 0                                                    # (T, 2, B)
    # direction 1's pads hold zeros; direction 0's are not all zero (row 1
    # of length 7 keeps its last valid state on frames 7..9)
    assert got_hs[:, 1][torch.from_numpy(pads[:, 1])].abs().max() == 0
    assert got_cs[:, 1][torch.from_numpy(pads[:, 1])].abs().max() == 0
    assert torch.equal(got_hs[9, 0, 1], got_hs[6, 0, 1]) and got_hs[9, 0, 1].abs().max() > 0
    assert torch.equal(got_cs[9, 0, 1], got_cs[6, 0, 1])


def _function_grads(xp, w_hh, d_hs, dtype):
    xp_t = _t(xp, dtype).requires_grad_(True)
    w_t = _t(w_hh, dtype).requires_grad_(True)
    hs = lstm_cuda._BilstmScanFused.apply(xp_t, w_t, _t(LENGTHS, torch.int32))
    d_xp, d_w = torch.autograd.grad(hs, [xp_t, w_t], _t(d_hs, dtype))
    return hs.detach().float().numpy(), d_xp.float().numpy(), d_w.float().numpy()


@pytest.mark.parametrize("hidden", [32, 64])
def test_function_matches_pallas_bilstm_scan_vjp_fp32(hidden):
    """The cotangent is non-zero at padded frames: on direction 0's it must
    reach the row's last valid frame through the frozen carry."""
    rng = np.random.default_rng(330 + hidden)
    xp, w_hh, mask = _bi_inputs(rng, hidden)
    d_hs = rng.standard_normal((T, 2, B, hidden)).astype(np.float32)
    hs, vjp = jax.vjp(lambda a, w: pallas_bilstm_scan(a, w, jnp.asarray(mask), True),
                      jnp.asarray(xp), jnp.asarray(w_hh))
    ref_dxp, ref_dw = vjp(jnp.asarray(d_hs))
    lstm_cuda.reset_launch_counts()
    got_hs, got_dxp, got_dw = _function_grads(xp, w_hh, d_hs, torch.float32)
    assert not any(lstm_cuda.LAUNCHES.values())   # CPU tensors: the plain versions
    np.testing.assert_allclose(got_hs, _np(hs), atol=ATOL_F32)
    np.testing.assert_allclose(got_dxp, _np(ref_dxp), atol=ATOL_F32)
    np.testing.assert_allclose(got_dw, _np(ref_dw), atol=5 * ATOL_F32)  # sums B x T terms
    assert np.abs(got_dxp[mask == 0]).max() == 0
    # without the pad cotangents direction 0's gradient differs: they matter
    clipped = d_hs * mask[..., None]
    _, other, _ = _function_grads(xp, w_hh, clipped, torch.float32)
    assert np.abs(other[:, 0] - got_dxp[:, 0]).max() > 1e-3
    np.testing.assert_allclose(other[:, 1], got_dxp[:, 1], atol=1e-7)


def test_function_matches_pallas_bilstm_scan_vjp_bf16():
    hidden = 32
    rng = np.random.default_rng(340)
    xp, w_hh, mask = _bi_inputs(rng, hidden)
    d_hs = rng.standard_normal((T, 2, B, hidden)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, w: pallas_bilstm_scan(a, w, jnp.asarray(mask), True),
                     jnp.asarray(xp, jnp.bfloat16), jnp.asarray(w_hh, jnp.bfloat16))
    ref_dxp, ref_dw = (_np(g) for g in vjp(jnp.asarray(d_hs, jnp.bfloat16)))
    _, got_dxp, got_dw = _function_grads(xp, w_hh, d_hs, torch.bfloat16)
    for got, ref in ((got_dxp, ref_dxp), (got_dw, ref_dw)):
        assert np.abs(got - ref).max() <= RTOL_BF16_GRAD * np.abs(ref).max()


def _layer_params(rng, in_dim, hidden):
    k = 1.0 / np.sqrt(hidden)

    def one():
        return {"w_ih": rng.uniform(-k, k, (in_dim, 4 * hidden)).astype(np.float32),
                "w_hh": rng.uniform(-k, k, (hidden, 4 * hidden)).astype(np.float32),
                "b": rng.uniform(-k, k, (4 * hidden,)).astype(np.float32)}

    return {"fwd": one(), "bwd": one()}


def _torch_op_grads(fn, params, x, r, dtype):
    leaves = jax.tree.map(lambda a: _t(a, dtype).requires_grad_(True), params)
    x_t = _t(x, dtype).requires_grad_(True)
    out = fn(leaves, x_t, _t(LENGTHS, torch.int32))
    (out.float() * _t(r)).sum().backward()
    to_np = lambda t: t.detach().float().numpy()  # noqa: E731
    return to_np(out), jax.tree.map(lambda p: to_np(p.grad), leaves), to_np(x_t.grad)


def _jax_op_grads(params, x, r, dtype):
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)

    def loss(p, xx):
        out = bilstm_apply_pallas_fused(p, xx, jnp.asarray(LENGTHS), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * r), out

    (_, out), (g_p, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x, dtype))
    return _np(out), jax.tree.map(_np, g_p), _np(g_x)


# in_dim 20 and 160: either side of the two-kernel op's fused-input threshold
@pytest.mark.parametrize("in_dim,hidden", [(20, 32), (160, 32), (160, 64)])
def test_op_matches_pallas_fused_and_two_kernel_op_fp32(in_dim, hidden):
    """One listener layer's JAX parameters through both packages' fused ops,
    and through the port's two-kernel op: output and the gradients w.r.t.
    every parameter and x of ``sum(out * r)``."""
    rng = np.random.default_rng(350 + in_dim + hidden)
    params = _layer_params(rng, in_dim, hidden)
    x = rng.standard_normal((B, T, in_dim)).astype(np.float32)
    r = rng.standard_normal((B, T, 2 * hidden)).astype(np.float32)
    ref_out, ref_gp, ref_gx = _jax_op_grads(params, x, r, jnp.float32)
    out, gp, gx = _torch_op_grads(lstm_cuda.bilstm_apply_fused, params, x, r, torch.float32)
    assert np.abs(out[_valid() == 0]).max() == 0
    np.testing.assert_allclose(out, ref_out, atol=ATOL_F32)
    np.testing.assert_allclose(gx, ref_gx, atol=ATOL_F32)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(gp), jax.tree.leaves(ref_gp)):
        np.testing.assert_allclose(a, b, atol=5 * ATOL_F32, err_msg=str(path))
    # the port's two-kernel op on the same parameters
    out2, gp2, gx2 = _torch_op_grads(lstm_cuda.bilstm_apply_kernel, params, x, r, torch.float32)
    np.testing.assert_allclose(out, out2, atol=ATOL_F32)
    np.testing.assert_allclose(gx, gx2, atol=ATOL_F32)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(gp), jax.tree.leaves(gp2)):
        np.testing.assert_allclose(a, b, atol=5 * ATOL_F32, err_msg=str(path))


def test_op_matches_pallas_fused_bf16():
    in_dim, hidden = 160, 32
    rng = np.random.default_rng(360)
    params = _layer_params(rng, in_dim, hidden)
    x = rng.standard_normal((B, T, in_dim)).astype(np.float32)
    r = rng.standard_normal((B, T, 2 * hidden)).astype(np.float32)
    ref_out, ref_gp, ref_gx = _jax_op_grads(params, x, r, jnp.bfloat16)
    out, gp, gx = _torch_op_grads(lstm_cuda.bilstm_apply_fused, params, x, r, torch.bfloat16)
    np.testing.assert_allclose(out, ref_out, atol=ATOL_BF16_FWD)
    pairs = [(gx, ref_gx)] + list(zip(jax.tree.leaves(gp), jax.tree.leaves(ref_gp)))
    for got, ref in pairs:
        assert np.abs(got - ref).max() <= RTOL_BF16_GRAD * np.abs(ref).max()


def test_op_without_grad_takes_the_plain_forward():
    rng = np.random.default_rng(370)
    params = jax.tree.map(_t, _layer_params(rng, 160, 32))
    x = _t(rng.standard_normal((B, T, 160)).astype(np.float32))
    with torch.no_grad():
        out = lstm_cuda.bilstm_apply_fused(params, x, _t(LENGTHS, torch.int32))
        ref = lstm_cuda.bilstm_apply_kernel(params, x, _t(LENGTHS, torch.int32))
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL_F32)


def test_fused_launcher_refuses_cpu_tensors_and_malformed_xp():
    """The checks that need no card: the wrappers' launcher refuses CPU
    tensors, and a malformed xp is named."""
    xp = torch.zeros(T, 2, B, 4 * 32)
    w_hh = torch.zeros(2, 32, 4 * 32)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_cuda._launch_streams("bilstm_scan_fused", True, xp, w_hh,
                                  _t(LENGTHS, torch.int32), (False, False))
    with pytest.raises(ValueError, match=r"\(T, 2, B, 4H\)"):
        lstm_cuda._launch_streams("bilstm_scan_fused", True, xp[:, 0], w_hh,
                                  _t(LENGTHS, torch.int32), (False, False))
    assert {"lstm_scan_cs", "bilstm_scan_fused"} <= set(lstm_cuda.LAUNCHES)
