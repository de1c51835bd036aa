"""LSTM-recurrence kernels for Hopper (counterpart of the JAX
``ops/lstm_pallas.py``, inference form), with their plain versions.

Two kernels, one CUDA source (``csrc/lstm_scan.cu``) with a compile-time
switch for the input projection:

  ``lstm_scan``          replaces ``_lstm_scan_nocs_kernel``
                         (lstm_pallas.py:87, via ``_forward_pallas`` with
                         ``with_cs=False``): the recurrence over a
                         precomputed ``x @ W_ih + b``;
  ``lstm_scan_fusedin``  replaces ``_lstm_scan_fusedin_kernel``
                         (lstm_pallas.py:854, via ``_fusedin_call`` with
                         ``train=False``): the same with the narrow input
                         projection (in_dim <= 128) done in the kernel.

Each launch runs the whole time loop of one layer for one or both
directions and at most 32 batch rows, with the carry on chip; the source's
header says what bounds it and how it is laid out. A wider batch takes one
launch per 32 rows (``row_chunks``): rows are independent, so the result is
the per-chunk results stacked. Each wrapper runs its plain PyTorch version
for a CPU tensor, launches the kernel for a CUDA tensor or raises, and
counts its launches in ``LAUNCHES``.

The library is built with ``nvcc`` at first use into ``_build/``
(``ops/cuda_build.py``) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List, Sequence, Tuple

import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build
from attention_based_e2e_asr_dnn_tpu_torch.ops.lstm import (
    FUSED_IN_MAX_DIM,
    _gates,
    directions_apply,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops.masking import length_mask

SOURCE = os.path.join(cuda_build.CSRC, "lstm_scan.cu")

# the kernel's fixed geometry (csrc/lstm_scan.cu): hidden units per block,
# batch rows per block (one per lane)
_UNITS = 8
_BMAX = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel since the last reset
LAUNCHES = {"lstm_scan": 0, "lstm_scan_fusedin": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

def library_path() -> str:
    return cuda_build.library_path(SOURCE)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build ``csrc/lstm_scan.cu`` (once per source version) and bind its C
    entry point."""
    so = cuda_build.build_library(SOURCE)
    lib = ctypes.CDLL(so)
    fn = lib.lstm_scan_launch
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [i, i, i, i, i, i, i, i,   # dtype fused ndir rev B T D H
                   p, ll, ll, ll,            # x and its strides
                   p, p, p, p,               # w_ih bias w_hh lengths
                   p, ll, ll, ll,            # out and its strides
                   p, p]                     # exchange buffer, stream
    fn.restype = ctypes.c_int
    return lib


def row_chunks(batch: int, rows: int = _BMAX) -> List[Tuple[int, int]]:
    """[start, end) row ranges of at most ``rows`` rows covering ``batch``."""
    return [(r0, min(r0 + rows, batch)) for r0 in range(0, batch, rows)]


def _launch(name: str, fused: bool, x: torch.Tensor, w_ih, b,
            w_hh: torch.Tensor, lengths: torch.Tensor,
            reverse: Tuple[bool, ...]) -> torch.Tensor:
    """Check shapes, launch the kernel once per 32 rows, return
    (B, T, ndir * H)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: kernel needs CUDA tensors, got {x.device}")
    dtype = x.dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32 or bfloat16)")
    ndir, hidden, four_h = w_hh.shape
    batch, seq_len = x.shape[0], x.shape[1]
    in_dim = x.shape[2] if fused else 0
    tensors = [x, w_hh] + ([w_ih, b] if fused else [])
    for t in tensors:
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: all operands must be contiguous "
                             f"{dtype} on {x.device}")
    if four_h != 4 * hidden or len(reverse) != ndir:
        raise ValueError(f"{name}: w_hh {tuple(w_hh.shape)} must be "
                         f"(ndir, H, 4H) with one reverse flag per direction")
    if batch < 1:
        raise ValueError(f"{name}: empty batch")
    if seq_len < 1:
        raise ValueError(f"{name}: empty time axis")
    if hidden % 32 != 0:
        raise ValueError(f"{name}: hidden {hidden} must be a multiple of 32")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if ndir * hidden // _UNITS > sms:
        raise ValueError(f"{name}: {ndir} x H={hidden} needs "
                         f"{ndir * hidden // _UNITS} co-resident blocks, the "
                         f"card has {sms} SMs")
    if fused:
        if in_dim > FUSED_IN_MAX_DIM:
            raise ValueError(f"{name}: in_dim {in_dim} > {FUSED_IN_MAX_DIM}")
        if w_ih.shape != (ndir, in_dim, four_h) or b.shape != (ndir, four_h):
            raise ValueError(f"{name}: w_ih/b shapes {tuple(w_ih.shape)}, "
                             f"{tuple(b.shape)} do not match")
        x_strides = (0, seq_len * in_dim, in_dim)
    else:
        if x.shape[2] != ndir * four_h:
            raise ValueError(f"{name}: x_proj width {x.shape[2]} != "
                             f"{ndir} x 4H")
        x_strides = (four_h, seq_len * ndir * four_h, ndir * four_h)
    if lengths.shape != (batch,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)} != ({batch},)")
    if batch > _BMAX:
        return torch.cat([_launch(name, fused, x[r0:r1], w_ih, b, w_hh,
                                  lengths[r0:r1], reverse)
                          for r0, r1 in row_chunks(batch)])

    lib = load_library()
    lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty(batch, seq_len, ndir * hidden, dtype=dtype, device=x.device)
    hbuf = torch.empty(2, ndir, batch, hidden, dtype=dtype, device=x.device)
    rev_bits = sum(1 << d for d, r in enumerate(reverse) if r)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lstm_scan_launch(
            _DTYPE_CODES[dtype], int(fused), ndir, rev_bits, batch, seq_len,
            in_dim, hidden, x.data_ptr(), *x_strides,
            w_ih.data_ptr() if fused else None,
            b.data_ptr() if fused else None,
            w_hh.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), hidden, seq_len * ndir * hidden, ndir * hidden,
            hbuf.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {err}")
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _scan_plain(pre_x: torch.Tensor, w_hh: torch.Tensor, valid: torch.Tensor,
                reverse: bool) -> torch.Tensor:
    """One direction's recurrence in float32 over pre_x (B, T, 4H) float32;
    w_hh (H, 4H) in the weight dtype. Returns (B, T, H) float32."""
    batch, seq_len, _ = pre_x.shape
    hidden = w_hh.shape[0]
    w = w_hh.float()
    h = pre_x.new_zeros(batch, hidden)
    c = pre_x.new_zeros(batch, hidden)
    out = pre_x.new_zeros(batch, seq_len, hidden)
    steps = range(seq_len - 1, -1, -1) if reverse else range(seq_len)
    for t in steps:
        pre = pre_x[:, t] + h.to(w_hh.dtype).float() @ w
        h_new, c_new = _gates(pre, c, hidden)
        m = valid[:, t, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        out[:, t] = torch.where(m, h_new, 0.0)
    return out


def lstm_scan_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                    lengths: torch.Tensor,
                    reverse: Sequence[bool]) -> torch.Tensor:
    """Plain version of ``lstm_scan``."""
    four_h = w_hh.shape[2]
    valid = length_mask(lengths, x_proj.shape[1])
    outs = [_scan_plain(x_proj[..., d * four_h:(d + 1) * four_h].float(),
                        w_hh[d], valid, rev) for d, rev in enumerate(reverse)]
    return torch.cat(outs, dim=-1).to(x_proj.dtype)


def lstm_scan_fusedin_plain(x: torch.Tensor, w_ih: torch.Tensor,
                            b: torch.Tensor, w_hh: torch.Tensor,
                            lengths: torch.Tensor,
                            reverse: Sequence[bool]) -> torch.Tensor:
    """Plain version of ``lstm_scan_fusedin``: the input projection in
    float32, ``(x @ W_ih + b) + h @ W_hh`` as the Pallas kernel sums it."""
    valid = length_mask(lengths, x.shape[1])
    outs = [_scan_plain(x.float() @ w_ih[d].float() + b[d].float(), w_hh[d],
                        valid, rev) for d, rev in enumerate(reverse)]
    return torch.cat(outs, dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def lstm_scan(x_proj: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor,
              reverse: Sequence[bool]) -> torch.Tensor:
    """LSTM recurrence over a precomputed projection, one or more directions.

    x_proj (B, T, ndir * 4H) = ``x @ W_ih + b`` of each direction side by
    side; w_hh (ndir, H, 4H); lengths (B,); ``reverse[d]`` walks direction d
    in descending time. Returns (B, T, ndir * H), zero at padded frames, in
    x_proj's dtype."""
    if x_proj.device.type == "cpu":
        return lstm_scan_plain(x_proj, w_hh, lengths, reverse)
    return _launch("lstm_scan", False, x_proj, None, None, w_hh, lengths,
                   tuple(reverse))


def lstm_scan_fusedin(x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor,
                      w_hh: torch.Tensor, lengths: torch.Tensor,
                      reverse: Sequence[bool]) -> torch.Tensor:
    """LSTM recurrence with the input projection in the kernel.

    x (B, T, D) with D <= 128, shared by the directions; w_ih (ndir, D, 4H);
    b (ndir, 4H); w_hh (ndir, H, 4H). Otherwise as ``lstm_scan``."""
    if x.device.type == "cpu":
        return lstm_scan_fusedin_plain(x, w_ih, b, w_hh, lengths, reverse)
    return _launch("lstm_scan_fusedin", True, x, w_ih, b, w_hh, lengths,
                   tuple(reverse))


def lstm_apply_kernel(params, x: torch.Tensor, lengths: torch.Tensor,
                      reverse: bool = False) -> torch.Tensor:
    """``lstm_apply_pallas``'s contract on the kernels: (B, T, D) ->
    (B, T, H), zero at pads; in_dim <= 128 takes the fused-input kernel."""
    return directions_apply([params], x, lengths, (reverse,),
                            lstm_scan_fusedin, lstm_scan)


def bilstm_apply_kernel(params, x: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """``bilstm_apply_pallas``'s contract, both directions in one launch:
    (B, T, D) -> (B, T, 2H) = [fwd, bwd]."""
    return directions_apply([params["fwd"], params["bwd"]], x, lengths,
                            (False, True), lstm_scan_fusedin, lstm_scan)
