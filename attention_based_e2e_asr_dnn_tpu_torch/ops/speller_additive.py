"""The additive attention score of one decode step on the card
(``csrc/speller_additive.cu``), with its plain version and the autograd
Function that joins the kernel to its adjoint.

    scores[b, h, t] = sum_d v[h, d] * tanh(q[b, h, d] + k[b, t, h, d])

over the valid frames (``mask`` False), the dtype's most negative value at
the padded ones, as ``ops/attention.py`` masks the dot-product score. It
replaces no TPU kernel: the JAX package scores attention by dot products
only, and the fused decode (``ops/speller_cuda.py``) computes only those, so
a speller with ``att_score: additive`` takes the step loop of
``models/las.py::speller_apply``, and each of its steps calls
``additive_scores`` once.

``k`` is the keys' projection as ``cross_attention_precompute`` forms it,
(B, Te, heads, d_head) contiguous; ``q`` (B, heads, d_head); ``v`` (heads,
d_head); ``mask`` (B, Te) bool, True where padded. The forward keeps only
its inputs; the adjoint recomputes the tanh from q and k and returns dq, dk
(zero at padded frames) and dv, with no (B, Te, heads, d_head) tensor kept
between the passes.

For a CPU tensor each pass runs its plain version; for a CUDA tensor it
launches the kernel (bfloat16 or float32, d_head a multiple of 8 up to
1024) or raises. Each launch counts in ``LAUNCHES`` (``speller_cuda.LAUNCHES``
is this dict) and runs under the span ``las.launch.<key>``.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build
from attention_based_e2e_asr_dnn_tpu_torch.utils.profiling import LAUNCH, span

SOURCE = os.path.join(cuda_build.CSRC, "speller_additive.cu")
FORWARD, ADJOINT = "speller_additive_scores", "speller_additive_scores_bwd"
# launches since the last reset (``ops/speller_cuda.py`` adds the fused
# decode's counters to this same dict)
LAUNCHES = {FORWARD: 0, ADJOINT: 0}
MAX_D_HEAD = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 for the narrow floats, the dtype itself for float64."""
    return torch.promote_types(dtype, torch.float32)


def additive_scores_plain(q, k, v, mask):
    """The forward in torch ops: the sum in float32 (float64 for float64
    inputs), the scores in q's dtype."""
    acc = _acc_dtype(q.dtype)
    th = torch.tanh(q.to(acc)[:, None] + k.to(acc))              # (B, Te, H, D)
    scores = (th * v.to(acc)).sum(-1).transpose(1, 2)            # (B, H, Te)
    return scores.masked_fill(mask[:, None, :], torch.finfo(q.dtype).min).to(q.dtype)


def additive_scores_bwd_plain(q, k, v, mask, ds):
    """The adjoint in torch ops: (dq, dk, dv) in the inputs' dtype, tanh
    recomputed, ds ignored (and dk zero) at padded frames."""
    acc = _acc_dtype(q.dtype)
    th = torch.tanh(q.to(acc)[:, None] + k.to(acc))              # (B, Te, H, D)
    g = ds.to(acc).masked_fill(mask[:, None, :], 0.0).transpose(1, 2)[..., None]
    dpre = g * v.to(acc) * (1.0 - th * th)
    return (dpre.sum(1).to(q.dtype), dpre.to(k.dtype), (g * th).sum((0, 1)).to(v.dtype))


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build ``csrc/speller_additive.cu`` (once per source version) and bind
    its C entry points."""
    lib = ctypes.CDLL(cuda_build.build_library(SOURCE))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.speller_additive_scores_launch.argtypes = [i, p, p, p, p, p, i, i, i, i,
                                                   ctypes.c_float, p]
    lib.speller_additive_scores_launch.restype = ctypes.c_int
    lib.speller_additive_scores_bwd_launch.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.speller_additive_scores_bwd_launch.restype = ctypes.c_int
    return lib


def _check(name, q, k, v, mask, ds=None):
    """The shapes, dtypes, devices and layouts the kernel takes; returns
    (B, Te, H, D)."""
    if not q.is_cuda:
        raise ValueError(f"{name}: kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (float32 or bfloat16)")
    batch, te, heads, d = k.shape
    if d % 8 or d > MAX_D_HEAD:
        raise ValueError(f"{name}: d_head {d} must be a multiple of 8 up to {MAX_D_HEAD}")
    shapes = {"q": (q, (batch, heads, d)), "k": (k, (batch, te, heads, d)),
              "v": (v, (heads, d))}
    if ds is not None:
        shapes["ds"] = (ds, (batch, heads, te))
    for key, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, expected {shape}")
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {q.dtype} on {q.device}")
    if (tuple(mask.shape) != (batch, te) or mask.dtype != torch.bool
            or mask.device != q.device or not mask.is_contiguous()):
        raise ValueError(f"{name}: mask must be contiguous bool ({batch}, {te}) on {q.device}")
    return batch, te, heads, d


def _launch(q, k, v, mask):
    with span(LAUNCH + FORWARD):
        batch, te, heads, d = _check(FORWARD, q, k, v, mask)
        scores = torch.empty((batch, heads, te), dtype=q.dtype, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = load_library().speller_additive_scores_launch(
                _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                mask.data_ptr(), scores.data_ptr(), batch, heads, te, d,
                torch.finfo(q.dtype).min, stream)
        if err != 0:
            raise RuntimeError(f"{FORWARD}: launch failed with cudaError {err}")
        LAUNCHES[FORWARD] += 1
        return scores


def _launch_bwd(q, k, v, mask, ds):
    with span(LAUNCH + ADJOINT):
        batch, te, heads, d = _check(ADJOINT, q, k, v, mask, ds)
        dq = torch.empty_like(q)
        dk = torch.empty_like(k)
        dv_part = torch.empty((batch, heads, d), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = load_library().speller_additive_scores_bwd_launch(
                _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                mask.data_ptr(), ds.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv_part.data_ptr(), batch, heads, te, d, stream)
        if err != 0:
            raise RuntimeError(f"{ADJOINT}: launch failed with cudaError {err}")
        LAUNCHES[ADJOINT] += 1
        return dq, dk, dv_part.sum(0).to(v.dtype)


def additive_scores_forward(q, k, v, mask):
    """The scores (B, heads, Te): the kernel for CUDA tensors, else the
    plain version."""
    return additive_scores_plain(q, k, v, mask) if q.device.type == "cpu" else _launch(q, k, v, mask)


def additive_scores_backward(q, k, v, mask, ds):
    """(dq, dk, dv) of ``additive_scores_forward``: the adjoint kernel for
    CUDA tensors, else the plain version."""
    if q.device.type == "cpu":
        return additive_scores_bwd_plain(q, k, v, mask, ds)
    return _launch_bwd(q, k, v, mask, ds.contiguous())


class _AdditiveScores(torch.autograd.Function):
    """The forward keeps its inputs only; the backward is the adjoint."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return additive_scores_forward(q, k, v, mask)

    @staticmethod
    def backward(ctx, ds):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = additive_scores_backward(q, k, v, mask, ds)
        return dq, dk, dv, None


def additive_scores(q, k, v, mask):
    """The masked additive scores (B, heads, Te), differentiable in q, k and
    v through the adjoint."""
    return _AdditiveScores.apply(q, k, v, mask)
