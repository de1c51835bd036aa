"""Fused speller-decode kernels for Hopper (counterpart of the JAX
``ops/speller_pallas.py``), with their plain versions and the autograd
Function that joins them.

  ``speller_decode``        replaces ``_decode_fwd_kernel``
                            (speller_pallas.py:90) as ``_fwd_chunk`` (:465)
                            launches it with ``save_residuals=False``: one
                            launch runs every step of the decode for the whole
                            batch (input-id select, cell 1, cell 2, query,
                            masked-softmax attention per head, tied
                            classifier, first-max feedback).
  ``speller_decode_train``  the same kernel with ``save_residuals=True``: the
                            per-step dropout masks m1, m2 on the cells'
                            outputs and the residual streams of the adjoint
                            (the fed id, both cells' gates and c, the dropped
                            h1 and h2, the context).
  ``speller_decode_bwd``    replaces ``_decode_bwd_kernel`` (:223) as
                            ``_bwd_chunk`` (:554) launches it: the adjoint,
                            walking time down, with the products against the
                            transposed weights inside.

The sources (``csrc/speller_decode_tc.cu``, the forward in bfloat16 on
tensor cores; ``csrc/speller_decode.cu``, the forward in float32;
``csrc/speller_bwd_tc.cu``, the adjoint in bfloat16 on tensor cores;
``csrc/speller_bwd.cu``, the adjoint in float32) say what bounds the kernels
and how they are laid out; ``plan_decode_tc`` and ``plan_decode_bwd_tc`` say
which launches a bfloat16 call makes, ``plan_decode_f32`` and
``plan_decode_bwd_f32`` the geometry of a float32 forward and adjoint call's
one launch (pure, tested on the CPU). Each wrapper runs its plain
PyTorch version for a CPU tensor, launches the kernel for a CUDA tensor or
raises, and counts its launches in ``LAUNCHES``; a running profiler sees
each kernel call as the span ``las.launch.<key>`` (``<key>`` its
``LAUNCHES`` counter). On the card the TPU's
routing (``pick_chunk``, the Te pad to 64, the lane gates of
``fused_decode_unavailable_reason``) does not apply: a shape a kernel cannot
take raises a ``ValueError`` that names the limit, where the JAX package
falls back to the scan decoder.

``fused_decode`` is the JAX ``fused_decode`` (:636): where a gradient is
wanted it goes through ``_FusedDecode``, whose forward is the training kernel
and whose backward is the adjoint kernel plus the weight-gradient products
the JAX package also forms outside its kernels (``_fused_bwd`` :694);
otherwise it stays on the eval kernel.

``speller_apply_fused`` is the JAX ``speller_apply_fused`` (:862), the
teacher-forced training decode and the free-running eval decode: the operands
(``decode_operands``, the span ``las.speller.operands``), the forced-id
stream and the dropout masks from the pass's draws, ``fused_decode``, and the
``SpellerOutput`` of ``models/las.py::speller_apply`` (the span
``las.speller.decode``); ``_FusedDecode``'s backward is
``las.backward.speller``.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
import os
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build, speller_additive
from attention_based_e2e_asr_dnn_tpu_torch.ops.shards import refuse_sharded
from attention_based_e2e_asr_dnn_tpu_torch.ops.attention import (
    cross_attention_precompute,
    cross_attention_step,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops.lstm_cuda import _wants_grad
from attention_based_e2e_asr_dnn_tpu_torch.utils.profiling import LAUNCH, span

SOURCE = os.path.join(cuda_build.CSRC, "speller_decode.cu")
TC_SOURCE = os.path.join(cuda_build.CSRC, "speller_decode_tc.cu")
BWD_SOURCE = os.path.join(cuda_build.CSRC, "speller_bwd.cu")
BWD_TC_SOURCE = os.path.join(cuda_build.CSRC, "speller_bwd_tc.cu")
# with the additive score of the step loop's attention (ops/speller_additive.py)
SOURCES = (SOURCE, TC_SOURCE, BWD_SOURCE, BWD_TC_SOURCE, speller_additive.SOURCE)

NEG = -1e9  # additive pad bias; exp(NEG - max) underflows to exactly 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the shared memory a block may use on the card (sm_90)
_SMEM_LIMIT_F32 = 232448

# launches since the last reset: the fused decode's, in one dict with the
# additive score's (ops/speller_additive.py counts its own there)
LAUNCHES = speller_additive.LAUNCHES
LAUNCHES.update({"speller_decode": 0, "speller_decode_train": 0, "speller_decode_bwd": 0})


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the residual streams of the training form, in the order the wrappers return
# them: the fed id (T, B) int32 (it stands for the Pallas kernel's one-hot
# ``sel`` (T, B, Vp)); then in the weight dtype both cells' activated gates
# [i, f, g, o] (T, B, 4H) and c (T, B, H), the dropped outputs h1d and h2d,
# and the context (T, B, P)
RESIDUALS = ("sel", "gates1", "c1", "h1d", "gates2", "c2", "h2d", "ctx")


def pick_te_chunk(te: int) -> int:
    """The Pallas kernel's encoder-time piece (speller_pallas.py:809): its
    context sums are taken per piece, then added."""
    for c in (64, 32, 16, 8):
        if te % c == 0:
            return c
    return te


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _decode_steps(k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1, wih2,
                  whh2, b2, wq, bq, wcls, clsb, heads, scale, sos_idx, steps,
                  forced, m1, m2, residuals):
    """The decode step by step in PyTorch with the Pallas kernel's numerics
    (speller_pallas.py:90-216): fp32 carries, rounded to the weight dtype
    only as dot operands; fp32 dots and gates; the cells' outputs times the
    step's mask in fp32 where there is one, the dropped value being the
    carry; scores and context as fp32 products of operands rounded to the
    weight dtype, summed in fp32 (the context per ``pick_te_chunk`` piece):
    what the kernel computes in interpret mode, where XLA forms the products
    of ``qh * kc`` and ``wc * vc`` in fp32; the feedback is the first maximum
    of the fp32 logits."""
    wdt = k.dtype
    batch, te, proj = k.shape
    d_head = proj // heads
    h1dim, h2dim = whh1.shape[0], whh2.shape[0]
    te_chunk = pick_te_chunk(te)

    def op(x):  # a dot operand: rounded to the weight dtype, exact in fp32
        return x.to(wdt).float()

    embw1, wc1, whh1, wih2, whh2, wq, wcls = (
        w.float() for w in (embw1, wc1, whh1, wih2, whh2, wq, wcls))
    k, v, b2, bq, clsb, bias = (x.float() for x in (k, v, b2, bq, clsb, bias))
    h1, c1, h2, c2, ctx = (s.float() for s in (h10, c10, h20, c20, ctx0))
    prev = torch.full((batch,), sos_idx, dtype=torch.long, device=k.device)
    logits_t, wgts_t, ids_t = [], [], []
    saved = [[] for _ in RESIDUALS]
    for t in range(steps):
        sel = prev if forced is None else torch.where(forced[t] >= 0,
                                                      forced[t].long(), prev)
        pre1 = (embw1[sel] + op(ctx) @ wc1) + op(h1) @ whh1
        act1 = _activate(pre1, h1dim)
        h1, c1 = _cell_out(act1, c1, h1dim)
        if m1 is not None:
            h1 = h1 * m1[t].float()
        pre2 = (op(h1) @ wih2 + op(h2) @ whh2) + b2
        act2 = _activate(pre2, h2dim)
        h2, c2 = _cell_out(act2, c2, h2dim)
        if m2 is not None:
            h2 = h2 * m2[t].float()
        q = op(h2) @ wq + bq
        ctx_parts, w_parts = [], []
        for h in range(heads):
            sl = slice(h * d_head, (h + 1) * d_head)
            sc = (op(q[:, None, sl]) * k[:, :, sl]).sum(-1) * scale + bias
            e = torch.exp(sc - sc.amax(-1, keepdim=True))
            w = e / e.sum(-1, keepdim=True)
            w_parts.append(w)
            ctx_parts.append(sum(
                (op(w[:, c0:c0 + te_chunk, None]) * v[:, c0:c0 + te_chunk, sl]
                 ).sum(1) for c0 in range(0, te, te_chunk)))
        ctx = torch.cat(ctx_parts, -1)
        logits = op(torch.cat([q, ctx], -1)) @ wcls + clsb
        prev = torch.argmax(logits, -1)  # the first maximum
        logits_t.append(logits.to(wdt))
        wgts_t.append(torch.stack(w_parts, 1).to(wdt))
        ids_t.append(prev)
        if residuals:
            for store, x in zip(saved, (sel.to(torch.int32), act1.to(wdt), c1.to(wdt),
                                        h1.to(wdt), act2.to(wdt), c2.to(wdt),
                                        h2.to(wdt), ctx.to(wdt))):
                store.append(x)
    out = (torch.stack(logits_t), torch.stack(wgts_t),
           torch.stack(ids_t).to(torch.int32))
    if residuals:
        return (*out, tuple(torch.stack(x) for x in saved))
    return out


def _activate(pre, hid):
    """Activated gates [i, f, g, o] of a pre-activation (B, 4H), fp32."""
    return torch.cat([torch.sigmoid(pre[:, :2 * hid]),
                      torch.tanh(pre[:, 2 * hid:3 * hid]),
                      torch.sigmoid(pre[:, 3 * hid:])], dim=-1)


def _cell_out(act, c, hid):
    i, f, g, o = act.split(hid, dim=-1)
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def speller_decode_plain(k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1,
                         whh1, wih2, whh2, b2, wq, bq, wcls, clsb, *,
                         heads: int, scale: float, sos_idx: int, steps: int,
                         forced: Optional[torch.Tensor] = None):
    """Plain version of ``speller_decode`` (``_decode_steps`` has the
    numerics). Returns (logits (T, B, Vp), weights (T, B, heads, Te), both in
    k's dtype, and the fed-back ids (T, B) int32)."""
    return _decode_steps(k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1,
                         wih2, whh2, b2, wq, bq, wcls, clsb, heads, scale, sos_idx,
                         steps, forced, None, None, residuals=False)


def speller_decode_train_plain(k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1,
                               whh1, wih2, whh2, b2, wq, bq, wcls, clsb, *,
                               heads: int, scale: float, sos_idx: int, steps: int,
                               forced: Optional[torch.Tensor] = None,
                               m1: Optional[torch.Tensor] = None,
                               m2: Optional[torch.Tensor] = None):
    """Plain version of ``speller_decode_train``: ``speller_decode_plain``
    with the masks, plus the residual streams in k's dtype (``RESIDUALS``)."""
    return _decode_steps(k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1,
                         wih2, whh2, b2, wq, bq, wcls, clsb, heads, scale, sos_idx,
                         steps, forced, m1, m2, residuals=True)


def _cell_adjoint(d_hd, mask_t, gates_t, c_t, c_prev, dc, hid):
    """One cell's gate adjoint at one step (speller_pallas.py:292-309), fp32:
    the cotangent of the dropped output -> (dpre (B, 4H), the new dc)."""
    d_hn = d_hd if mask_t is None else d_hd * mask_t.float()
    i, f, g, o = gates_t.float().split(hid, dim=-1)
    tanh_c = torch.tanh(c_t.float())
    dc_tot = dc + d_hn * o * (1.0 - tanh_c * tanh_c)
    dpre = torch.cat([dc_tot * g * i * (1.0 - i),
                      dc_tot * c_prev.float() * f * (1.0 - f),
                      dc_tot * i * (1.0 - g * g),
                      d_hn * tanh_c * o * (1.0 - o)], dim=-1)
    return dpre, dc_tot * f


def speller_decode_bwd_plain(k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1,
                             c1, gates2, c2, wgts, m1, m2, dqup, dctxup, dwup, *,
                             heads: int, scale: float):
    """Plain version of ``speller_decode_bwd``: the adjoint written out, one
    step at a time with time running down, with the Pallas kernel's roundings
    (speller_pallas.py:223-390): the saved streams read in the weight dtype;
    dpre, d_q, d_ctx and ``dsc * scale`` rounded to the weight dtype as dot
    operands and as stored; the attention products formed in fp32 from those
    rounded operands and summed in fp32 (dq_att per ``pick_te_chunk`` piece);
    carries fp32. Not autograd through the forward, which would round
    nowhere."""
    wdt = k.dtype
    steps, batch = gates1.shape[:2]
    te, proj = k.shape[1], k.shape[2]
    d_head = proj // heads
    h1dim, h2dim = whh1.shape[0], whh2.shape[0]
    te_chunk = pick_te_chunk(te)

    def op(x):
        return x.to(wdt).float()

    kf, vf = k.float(), v.float()
    wc1t, whh1t, wih2t, whh2t, wqt = (w.float().T for w in (wc1, whh1, wih2, whh2, wq))
    f32 = {"dtype": torch.float32, "device": k.device}
    dh1, dc1 = torch.zeros(batch, h1dim, **f32), torch.zeros(batch, h1dim, **f32)
    dh2, dc2 = torch.zeros(batch, h2dim, **f32), torch.zeros(batch, h2dim, **f32)
    dctx = torch.zeros(batch, proj, **f32)
    dpre1_t, dpre2_t, dq_t, dctxtot_t, dsc_t = ([None] * steps for _ in range(5))
    for t in range(steps - 1, -1, -1):
        d_ctx = dctx + dctxup[t].float()
        dctxtot_t[t] = d_ctx.to(wdt)
        dq_parts, dsc_parts = [], []
        for h in range(heads):
            sl = slice(h * d_head, (h + 1) * d_head)
            w = wgts[t, :, h].float()
            dw = (op(d_ctx[:, None, sl]) * vf[:, :, sl]).sum(-1)
            if dwup is not None:
                dw = dw + dwup[t, :, h].float()
            dsc = w * (dw - (dw * w).sum(-1, keepdim=True))
            dsc_parts.append(dsc.to(wdt))
            dscs = op(dsc * scale)
            dq_parts.append(sum(
                (dscs[:, c0:c0 + te_chunk, None] * kf[:, c0:c0 + te_chunk, sl]).sum(1)
                for c0 in range(0, te, te_chunk)))
        d_q = torch.cat(dq_parts, -1) + dqup[t].float()
        dq_t[t] = d_q.to(wdt)
        dsc_t[t] = torch.stack(dsc_parts, 1)
        # cell 2
        dpre2, dc2 = _cell_adjoint(dh2 + op(d_q) @ wqt, None if m2 is None else m2[t],
                                   gates2[t], c2[t], c2[t - 1] if t else c20, dc2, h2dim)
        dpre2_t[t] = dpre2.to(wdt)
        dpre2 = dpre2_t[t].float()
        dh2 = dpre2 @ whh2t
        # cell 1
        dpre1, dc1 = _cell_adjoint(dh1 + dpre2 @ wih2t, None if m1 is None else m1[t],
                                   gates1[t], c1[t], c1[t - 1] if t else c10, dc1, h1dim)
        dpre1_t[t] = dpre1.to(wdt)
        dpre1 = dpre1_t[t].float()
        dh1 = dpre1 @ whh1t
        dctx = dpre1 @ wc1t
    return (torch.stack(dpre1_t), torch.stack(dpre2_t), torch.stack(dq_t),
            torch.stack(dctxtot_t), torch.stack(dsc_t), dh1, dc1, dh2, dc2, dctx)


# ---------------------------------------------------------------------------
# Build, bind, launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def load_library(defines: tuple = ()) -> ctypes.CDLL:
    """Build ``csrc/speller_decode.cu`` (the float32 forward; once per source
    version; with the macros ``defines``: ``("DF_TRACE",)`` is the
    phase-stamped build of ``tools/trace_speller_decode.py``) and bind its C
    entry points."""
    lib = ctypes.CDLL(cuda_build.build_library(SOURCE, defines))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.speller_decode_launch.argtypes = [i, i, p, p, p, ctypes.c_float, p]
    lib.speller_decode_launch.restype = ctypes.c_int
    lib.speller_decode_smem_bytes.argtypes = [i] * 9
    lib.speller_decode_smem_bytes.restype = ctypes.c_size_t
    lib.speller_decode_limits.argtypes = [i, ctypes.POINTER(ctypes.c_longlong)]
    lib.speller_decode_limits.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_bwd_library(defines: tuple = ()) -> ctypes.CDLL:
    """Build ``csrc/speller_bwd.cu`` (the float32 adjoint; with the macros
    ``defines``: ``("DA_TRACE",)`` is the phase-stamped build of
    ``tools/trace_speller_decode.py``) and bind its C entry points."""
    lib = ctypes.CDLL(cuda_build.build_library(BWD_SOURCE, defines))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.speller_bwd_launch.argtypes = [p, p, p, ctypes.c_float, p, p]
    lib.speller_bwd_launch.restype = ctypes.c_int
    lib.speller_bwd_smem_bytes.argtypes = [p, p]
    lib.speller_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.speller_bwd_limits.argtypes = [i, ctypes.POINTER(ctypes.c_longlong)]
    lib.speller_bwd_limits.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_tc_library(defines: tuple = ()) -> ctypes.CDLL:
    """Build ``csrc/speller_decode_tc.cu`` (with the macros ``defines``:
    ``("DT_TRACE",)`` is the phase-stamped build of
    ``tools/trace_speller_decode.py``) and bind its C entry points."""
    lib = ctypes.CDLL(cuda_build.build_library(TC_SOURCE, defines))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.speller_decode_tc_launch.argtypes = [i, i, p, p, i, ctypes.c_float, p, p]
    lib.speller_decode_tc_launch.restype = ctypes.c_int
    lib.speller_decode_tc_smem_bytes.argtypes = [i] * 8
    lib.speller_decode_tc_smem_bytes.restype = ctypes.c_size_t
    lib.speller_decode_tc_limits.argtypes = [i, ctypes.POINTER(ctypes.c_longlong)]
    lib.speller_decode_tc_limits.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_bwd_tc_library(defines: tuple = ()) -> ctypes.CDLL:
    """Build ``csrc/speller_bwd_tc.cu`` (with the macros ``defines``:
    ``("DB_TRACE",)`` is the phase-stamped build of
    ``tools/trace_speller_decode.py``) and bind its C entry points."""
    lib = ctypes.CDLL(cuda_build.build_library(BWD_TC_SOURCE, defines))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.speller_bwd_tc_launch.argtypes = [p, p, ctypes.c_float, p, p]
    lib.speller_bwd_tc_launch.restype = ctypes.c_int
    lib.speller_bwd_tc_smem_bytes.argtypes = [i] * 7
    lib.speller_bwd_tc_smem_bytes.restype = ctypes.c_size_t
    lib.speller_bwd_tc_limits.argtypes = [i, ctypes.POINTER(ctypes.c_longlong)]
    lib.speller_bwd_tc_limits.restype = ctypes.c_int
    lib.speller_bwd_tc_groups.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.speller_bwd_tc_groups.restype = None
    return lib


LOADERS = (load_library, load_tc_library, load_bwd_library, load_bwd_tc_library,
           speller_additive.load_library)


# the float32 forward's geometry (csrc/speller_decode.cu), mirrored here so
# that its plan is pure; kernel_limits reads the source's, and a card test
# holds the two equal: blocks at most, threads a block, padded vocabulary,
# rows of a thread's product tile, columns a ring stage, a staged row's
# padding, the ring's most stages, attention rows a block takes at once
F32_LIMITS = {"max_grid": 128, "nthreads": 256, "vmax": 32, "rt": 4, "kc": 128, "pad": 4,
              "max_stages": 4, "att_rows": 4}


@functools.lru_cache(maxsize=None)
def kernel_limits(device: int) -> dict:
    """The float32 forward's geometry as ``csrc/speller_decode.cu`` defines
    it (``F32_LIMITS``' keys), with the shared memory a block of ``device``
    may opt into and its SMs."""
    out = (ctypes.c_longlong * 10)()
    err = load_library().speller_decode_limits(device, out)
    if err != 0:
        raise RuntimeError(f"speller_decode: reading the limits of device "
                           f"{device} failed with cudaError {err}")
    return dict(zip((*F32_LIMITS, "smem_optin", "sms"), out))


class DecodeF32Plan(NamedTuple):
    """The one launch of a float32 forward call and its geometry."""
    blocks: int
    col_groups: int  # CG: each owns H1 / CG, H2 / CG and P / CG columns
    row_groups: int  # RG: each owns ``rows`` batch rows
    rows: int
    sub: int         # rows of a product's sub-tile (its staged input)
    stages: int      # the ring's stages
    att_rows: int    # attention rows a block takes at once
    smem: int        # shared memory a block, bytes


def _query_width(nq: int) -> int:
    """Columns of a group of the query's product (``df_query_width``): 4, 2
    or 1, the widest that divides the block's NQ query columns."""
    return 4 if nq % 4 == 0 else 2 if nq % 2 == 0 else 1


def _groups(h1dim: int, h2dim: int, proj: int, col_groups: int) -> tuple:
    """((column groups, width) of cell 1, cell 2 and the query a block
    owns: a cell's unit is a group of its four gates."""
    nq = proj // col_groups
    return ((h1dim // col_groups, 4), (h2dim // col_groups, 4),
            (nq // _query_width(nq), _query_width(nq)))


def decode_f32_smem_bytes(te: int, proj: int, heads: int, h1dim: int, h2dim: int,
                          col_groups: int, sub: int, stages: int, att_rows: int) -> int:
    """Shared memory a block of the float32 forward uses (``df_smem_bytes``
    in csrc/speller_decode.cu): its columns of [wc1; whh1], [wih2; whh2] and
    wq as fp32; then one region that the products' ring (``stages`` x
    ``sub`` rows x 132 floats) and the attention's buffers (``att_rows`` rows
    of q, ctx, the classifier's partials and the scores, and 1024 floats of
    the context's group sums) take in turn."""
    lim = F32_LIMITS
    u1, u2, nq = h1dim // col_groups, h2dim // col_groups, proj // col_groups
    weights = 4 * u1 * (proj + h1dim) + 4 * u2 * (h1dim + h2dim) + nq * h2dim
    ring = stages * sub * (lim["kc"] + lim["pad"])
    attn = (att_rows * (2 * proj + lim["nthreads"] // 32 * lim["vmax"] + heads * te)
            + lim["nthreads"] * 4)
    return 4 * (weights + max(ring, attn))


def _tile_rows(sub: int, groups: int) -> int:
    """Rows of a thread's product tile (``df_tile_rows``): 4 where that
    keeps 128 threads busy, else 2 or 1."""
    return 4 if sub // 4 * groups >= 128 else 2 if sub // 2 * groups >= 128 else 1


def _f32_step_us(batch: int, proj: int, h1dim: int, h2dim: int, col_groups: int,
                 row_groups: int, rows: int, sub: int, att_rows: int) -> float:
    """A rough time of one decode step on a float32 geometry, to rank plans:
    each product's FMAs a block at 20 a clock for each warp it keeps busy,
    up to four (an SM's schedulers), at 1.7 GHz; ~4 us an attention pass of
    fixed latency; and the inputs every column group stages from L2 (B x
    (K1 + K2 + H2) floats each) at ~5 TB/s."""
    clocks = 0.0
    for (groups, width), k in zip(_groups(h1dim, h2dim, proj, col_groups),
                                  (proj + h1dim, h1dim + h2dim, h2dim)):
        warps = -(-(sub // _tile_rows(sub, groups) * groups) // 32)
        clocks += rows * width * groups * k / (20 * min(warps, 4))
    passes = -(-(-(-batch // (col_groups * row_groups))) // att_rows)
    staging_us = col_groups * batch * (proj + 2 * h1dim + 2 * h2dim) * 4 / 5e6
    return clocks / 1.7e3 + 4.0 * passes + staging_us


def plan_decode_f32(batch: int, te: int, proj: int, heads: int, h1dim: int, h2dim: int,
                    vp: int, sms: int, smem_optin: int,
                    name: str = "speller_decode") -> DecodeF32Plan:
    """The launch of a float32 ``speller_decode`` / ``speller_decode_train``
    call (one a call, the whole batch) on a card of ``sms`` SMs whose blocks
    may opt into ``smem_optin`` bytes of shared memory: CG column groups x RG
    row groups of blocks (powers of two, at most 128 and the SMs), of the
    geometries whose shared memory fits the one ``_f32_step_us`` ranks
    fastest (then the fewest column groups, whose inputs every one of them
    stages). For each (CG, RG) the widest product sub-tile (a multiple of 4
    rows whose tiles the block's threads hold), then the most attention rows
    and ring stages that fit; down to 4-row sub-tiles, one stage and one
    attention row, whose block uses no more than the earlier float32 body
    did on the same columns, so every shape that body took is taken.
    Raises a ``ValueError`` naming the limit for a shape the kernel does not
    take."""
    lim = F32_LIMITS
    if batch < 1 or te < 1:
        raise ValueError(f"{name}: batch {batch} and encoder length {te} must be at least 1")
    if h1dim % 8 or h2dim % 8 or proj % 8 or min(h1dim, h2dim, proj) < 8:
        raise ValueError(f"{name}: H1 {h1dim}, H2 {h2dim} and P {proj} must be multiples "
                         f"of 8")
    if proj % heads or (proj // heads) % 8:
        raise ValueError(f"{name}: head width P / heads = {proj} / {heads} "
                         f"must be a whole multiple of 8")
    if proj > lim["nthreads"] * 4:
        raise ValueError(f"{name}: P {proj} above {lim['nthreads'] * 4} "
                         f"(the context takes one 16-byte slice a thread)")
    if vp > lim["vmax"]:
        raise ValueError(f"{name}: padded vocabulary {vp} must be at most {lim['vmax']}")
    most = 1 << (min(lim["max_grid"], sms).bit_length() - 1)
    limit = min(smem_optin, _SMEM_LIMIT_F32)
    rt, best, least = lim["rt"], None, None
    cg = 1
    while cg <= most and not (h1dim % cg or h2dim % cg or proj % cg):
        groups = [g for g, _ in _groups(h1dim, h2dim, proj, cg)]

        def holds(sub):  # the block's threads hold every product's tiles
            return all(sub // rt * g <= lim["nthreads"] for g in groups)

        rg = 1
        while cg * rg <= most and rg <= max(1, batch // 2) and holds(rt):
            rows = -(-batch // rg)
            subs = [s for s in (rt << i for i in range(6)) if holds(s)]
            subs = sorted({min(s, -(-rows // rt) * rt) for s in subs}, reverse=True)
            chunks = -(-max(proj + h1dim, h1dim + h2dim) // lim["kc"])
            fit = None
            for sub in subs:
                for att in range(min(lim["att_rows"], lim["nthreads"] * 4 // proj,
                                     -(-batch // (cg * rg))), 0, -1):
                    for stages in range(min(lim["max_stages"], chunks), 0, -1):
                        smem = decode_f32_smem_bytes(te, proj, heads, h1dim, h2dim, cg, sub,
                                                     stages, att)
                        least = smem if least is None else min(least, smem)
                        if smem <= limit:
                            fit = (sub, att, stages, smem)
                            break
                    if fit:
                        break
                if fit:
                    break
            if fit:
                sub, att, stages, smem = fit
                key = (round(_f32_step_us(batch, proj, h1dim, h2dim, cg, rg, rows, sub, att), 6),
                       cg)
                if best is None or key < best[0]:
                    best = (key, DecodeF32Plan(cg * rg, cg, rg, rows, sub, stages, att, smem))
            rg *= 2
        cg *= 2
    if best is None:
        raise ValueError(f"{name}: needs {least} bytes of shared memory a block at the "
                         f"least (Te {te}, heads {heads}, H1 {h1dim}, float32), the device's "
                         f"limit is {limit}")
    return best[1]


# the bfloat16 forward's geometry (csrc/speller_decode_tc.cu), mirrored here
# so that the plan is pure; tc_kernel_limits reads the source's, and a card
# test holds the two equal
TC_LIMITS = {"rows": 128, "max_grid": 128, "max_units1": 8, "max_units2": 4, "kc": 64,
             "sel": 64, "qcols": 8, "vmax": 32, "max_stages": 8, "min_stages": 4,
             "smem_limit": 232448, "nthreads": 288}
_TC_ALIGN, _TC_BAR_BYTES = 1024, 2 * 8 * 8
_TC_ATT_THREADS, _TC_ATT_WARPS = 256, 8  # the attention's threads (the consumers)
# the (cell-1, cell-2) wgmma widths / 8 the streamed form is built for
# (DT_SCASE in the source): the blocks whose resident tiles leave the
# ring too little room, H1 896-1024 (7-8 units a block) and H2 256-512
STREAM_NC = ((4, 1), (4, 2))


@functools.lru_cache(maxsize=None)
def tc_kernel_limits(device: int) -> dict:
    """The bfloat16 forward's geometry as ``csrc/speller_decode_tc.cu``
    defines it (``TC_LIMITS``' keys), with the shared memory a block of
    ``device`` may opt into and its SMs."""
    out = (ctypes.c_longlong * 14)()
    err = load_tc_library().speller_decode_tc_limits(device, out)
    if err != 0:
        raise RuntimeError(f"speller_decode: reading the limits of device "
                           f"{device} failed with cudaError {err}")
    return dict(zip((*TC_LIMITS, "smem_optin", "sms"), out))


class DecodeTcLaunch(NamedTuple):
    """One cooperative launch of the bfloat16 forward."""
    r0: int      # first batch row
    r1: int      # one past the last
    stages: int  # the ring's stages
    smem: int    # shared memory a block, bytes


class DecodeTcPlan(NamedTuple):
    """The launches of a bfloat16 forward call and the geometry they share."""
    launches: List[DecodeTcLaunch]
    blocks: int
    units1: int        # cell-1 units a block
    units2: int        # cell-2 units a block
    query_blocks: int  # blocks that own query columns (the first ones)
    cols: dict         # gate (or query) columns a block owns in each product
    streamed: bool     # cell 1's weights stream through the ring (else resident)


def _tc_cols(units: int) -> int:
    """wgmma's N for ``units`` units of four gate columns: 4 U rounded up
    to a multiple of 8 (the last four columns zeros where U is odd)."""
    return 8 * ((units + 1) // 2)


def tc_blocks(h1dim: int, h2dim: int, sms: int) -> int:
    """Blocks of a bfloat16 forward launch: the largest power of two up to
    128 and the card's SMs that divides H1 and H2."""
    blocks = 1 << (min(TC_LIMITS["max_grid"], sms).bit_length() - 1)
    while blocks > 1 and (h1dim % blocks or h2dim % blocks):
        blocks //= 2
    return blocks


def decode_tc_smem_bytes(rows: int, te: int, proj: int, heads: int, h1dim: int,
                         h2dim: int, blocks: int, streamed: bool = False) -> tuple:
    """(shared memory a block uses, the ring's stages) in a launch of
    ``rows`` rows of the bfloat16 forward on ``blocks`` blocks
    (``dt_smem_bytes`` in csrc/speller_decode_tc.cu): the weight tiles of
    cell 1 (N1 = 4 U1 rounded up to 8 columns, K = H1 + P + 64; not in the
    ``streamed`` form), cell 2 (N2, K = H2 + H1) and the query (8, K = H2)
    as bf16; the ring, stages of the rows rounded up to 64 (64 or 128) x 64
    columns (streamed: and N1 weight rows x 64 k behind them), in what the
    rest leaves of the card's limit, at most 8; the gate tile, 128 rows x the
    wider N + 8 fp32; the attention's fp32 buffers; the mbarriers; and the
    slack that puts the tiles on a 1024-byte boundary."""
    lim = TC_LIMITS
    kc = lim["kc"]
    n1, n2 = _tc_cols(h1dim // blocks), _tc_cols(h2dim // blocks)
    weights = ((0 if streamed else (h1dim + proj + lim["sel"]) // kc * n1 * 128)
               + (h2dim + h1dim) // kc * n2 * 128
               + h2dim // kc * lim["qcols"] * 128)
    red = lim["rows"] * (max(n1, n2) + 8) * 4
    att = -(-(2 * proj + _TC_ATT_WARPS * lim["vmax"] + _TC_ATT_THREADS * 8
              + heads * te) * 4 // 16) * 16
    fixed = _TC_ALIGN + weights + red + att + _TC_BAR_BYTES
    stage = (128 if rows > 64 else 64) * 128 + (n1 * 128 if streamed else 0)
    stages = min(max(lim["smem_limit"] - fixed, 0) // stage, lim["max_stages"])
    return fixed + stages * stage, stages


def _tc_spans(batch: int, te: int, proj: int, heads: int, h1dim: int, h2dim: int,
              blocks: int):
    """(rows a span, streamed) of a bfloat16 forward call: the resident
    form in 128-row spans where one fits ``min_stages`` ring stages, else in
    64-row spans; where neither does, the streamed form (for the wgmma widths
    it is built for, ``STREAM_NC``), 128 rows a span where that fits. None:
    no form fits."""
    lim = TC_LIMITS
    most = min(batch, lim["rows"])
    nc = (_tc_cols(h1dim // blocks) // 8, _tc_cols(h2dim // blocks) // 8)
    forms = [False] + ([True] if nc in STREAM_NC else [])
    for streamed in forms:
        for span in (lim["rows"], 64):
            rows = min(most, span)
            if decode_tc_smem_bytes(rows, te, proj, heads, h1dim, h2dim, blocks,
                                    streamed)[1] >= lim["min_stages"]:
                return span, streamed
    return None


def plan_decode_tc(batch: int, te: int, proj: int, heads: int, h1dim: int, h2dim: int,
                   vp: int, sms: int, smem_optin: int,
                   name: str = "speller_decode") -> DecodeTcPlan:
    """The launches of a bfloat16 ``speller_decode`` / ``speller_decode_train``
    call on a card of ``sms`` SMs whose blocks may opt into ``smem_optin``
    bytes of shared memory: one launch a span of up to 128 batch rows (the
    rows of the decode are independent; spans of 64 rows where a block's
    weight tiles leave too little room for the ring's 128-row stages),
    ``tc_blocks`` blocks each (128 where
    H1 and H2 are multiples of 128), each owning H1 / G units of cell 1 (1 to
    8), H2 / G of cell 2 (1 to 4) and, in the first P / 8 blocks, 8 query
    columns. Raises a ``ValueError`` naming the limit for a shape the kernel
    does not take."""
    lim = TC_LIMITS
    if batch < 1 or te < 1:
        raise ValueError(f"{name}: batch {batch} and encoder length {te} must be at least 1")
    kc = lim["kc"]
    if h1dim % kc or h2dim % kc or proj % kc or min(h1dim, h2dim, proj) < kc:
        raise ValueError(f"{name}: H1 {h1dim}, H2 {h2dim} and P {proj} must be multiples "
                         f"of {kc} (bfloat16: the products' 64-column TMA boxes)")
    blocks = tc_blocks(h1dim, h2dim, sms)
    for cell, width, most in (("H1", h1dim, lim["max_units1"]), ("H2", h2dim, lim["max_units2"])):
        if width > most * blocks:
            raise ValueError(f"{name}: {cell} {width} above {most * blocks} (bfloat16: at "
                             f"most {most} units of the cell a block on {blocks} blocks)")
    query_blocks = proj // lim["qcols"]
    if query_blocks > blocks:
        raise ValueError(f"{name}: P {proj} above {lim['qcols']} x {blocks} blocks "
                         f"(bfloat16: {lim['qcols']} query columns a block)")
    if proj % heads or (proj // heads) % 8:
        raise ValueError(f"{name}: head width P / heads = {proj} / {heads} "
                         f"must be a whole multiple of 8")
    if vp > lim["vmax"]:
        raise ValueError(f"{name}: padded vocabulary {vp} must be at most {lim['vmax']}")
    # the resident form in 128-row spans where one fits ``min_stages`` ring
    # stages, else in 64-row spans (whose stages are half the size); where
    # the resident tiles leave no room for either, cell 1's weights stream
    # through the ring (_tc_spans)
    span, streamed = _tc_spans(batch, te, proj, heads, h1dim, h2dim, blocks) or (
        lim["rows"], False)
    launches = []
    for r0 in range(0, batch, span):
        r1 = min(r0 + span, batch)
        smem, stages = decode_tc_smem_bytes(r1 - r0, te, proj, heads, h1dim, h2dim, blocks,
                                            streamed)
        if stages < lim["min_stages"] or smem > smem_optin:
            raise ValueError(f"{name}: needs {smem} bytes of shared memory a block with "
                             f"{lim['min_stages']} ring stages or more (Te {te}, heads "
                             f"{heads}, H1 {h1dim}, bfloat16), the device's limit is "
                             f"{min(smem_optin, lim['smem_limit'])}")
        launches.append(DecodeTcLaunch(r0, r1, stages, smem))
    units1, units2 = h1dim // blocks, h2dim // blocks
    return DecodeTcPlan(launches, blocks, units1, units2, query_blocks,
                        {"cell1": _tc_cols(units1), "cell2": _tc_cols(units2),
                         "query": lim["qcols"]}, streamed)


def stream_weights(whh1: torch.Tensor, wc1: torch.Tensor, embw1: torch.Tensor,
                   blocks: int) -> torch.Tensor:
    """Cell 1's weights for the streamed form, (G N1, H1 + P + 64): row g N1
    + n holds, K-major over [h1; ctx; one-hot], the column of block g's
    product column n that the resident form writes into its tile (``put`` in
    csrc/speller_decode_tc.cu): gate n % 4 of the block's unit n // 4, i.e.
    column (n % 4) H1 + g U1 + n // 4 of [whh1; wc1; embw1], embw1 padded
    with zero rows to 64; a zero row for a unit slot past U1."""
    h1dim, vp = whh1.shape[0], embw1.shape[0]
    units = h1dim // blocks
    n1 = _tc_cols(units)
    w = torch.cat([whh1, wc1, embw1, embw1.new_zeros(TC_LIMITS["sel"] - vp, 4 * h1dim)])
    w = torch.cat([w, w.new_zeros(w.shape[0], 1)], dim=1)  # column 4 H1: zeros
    n = torch.arange(n1, device=w.device)
    col = (n % 4) * h1dim + (n // 4) + units * torch.arange(blocks, device=w.device)[:, None]
    col = torch.where(n // 4 < units, col, 4 * h1dim)
    return w[:, col.reshape(-1)].t().contiguous()


# the bfloat16 adjoint's geometry (csrc/speller_bwd_tc.cu), mirrored here so
# that its plan is pure; bwd_tc_kernel_limits reads the source's constants and
# speller_bwd_tc_groups its assignment of groups, and a card test holds each
# equal to this copy
BWD_TC_LIMITS = {"rows": 128, "max_grid": 128, "kc": 64, "gcols": 8, "max_groups": 4,
                 "max_stages": 8, "min_stages": 2, "smem_limit": 232448, "nthreads": 288}
# the groups' kinds, in the order of their ids: 8 units of cell 1, 8 units of
# cell 2, 8 columns of the context
BWD_KINDS = ("cell1", "cell2", "ctx")
# the kinds whose columns each product phase forms: (b) d_q @ wq^T, (c)
# dpre2 @ [wih2; whh2]^T, (d) dpre1 @ [whh1; wc1]^T
BWD_PHASES = {"b": ("cell2",), "c": ("cell1", "cell2"), "d": ("cell1", "ctx")}


@functools.lru_cache(maxsize=None)
def bwd_tc_kernel_limits(device: int) -> dict:
    """The bfloat16 adjoint's geometry as ``csrc/speller_bwd_tc.cu`` defines
    it (``BWD_TC_LIMITS``' keys), with the shared memory a block of
    ``device`` may opt into and its SMs."""
    out = (ctypes.c_longlong * 11)()
    err = load_bwd_tc_library().speller_bwd_tc_limits(device, out)
    if err != 0:
        raise RuntimeError(f"speller_decode_bwd: reading the limits of device "
                           f"{device} failed with cudaError {err}")
    return dict(zip((*BWD_TC_LIMITS, "smem_optin", "sms"), out))


class DecodeBwdTcPlan(NamedTuple):
    """The launches of a bfloat16 adjoint call and the geometry they share."""
    launches: List[DecodeTcLaunch]
    blocks: int
    groups: List[List[tuple]]  # each block's groups: (kind, first unit or column)
    max_groups: int            # groups a block, at most
    phase_blocks: dict         # blocks that own columns in each product phase
    phase_cols: dict           # the widest N of a block in each product phase


def bwd_tc_groups(h1dim: int, h2dim: int, proj: int, blocks: int) -> List[List[tuple]]:
    """Each block's groups of 8 output columns (``csrc/speller_bwd_tc.cu``):
    group i, of the (H1 + H2 + P) / 8 in the order of ``BWD_KINDS``, goes to
    block i mod ``blocks``; (kind, its first unit or context column)."""
    gc = BWD_TC_LIMITS["gcols"]
    ids = [(kind, first) for kind, width in zip(BWD_KINDS, (h1dim, h2dim, proj))
           for first in range(0, width, gc)]
    return [ids[b::blocks] for b in range(blocks)]


def decode_bwd_tc_smem_bytes(rows: int, te: int, proj: int, heads: int, max_groups: int) -> tuple:
    """(shared memory a block uses, the ring's stages) in a launch of
    ``rows`` rows of the bfloat16 adjoint (``db_smem_bytes`` in
    csrc/speller_bwd_tc.cu): the ring, stages of the rows rounded up to 64 (64
    or 128) x 64 k of the input and 8 x ``max_groups`` weight rows x 64 k, in
    what the rest leaves of the card's limit, at most 8; the product's tile,
    128 rows x (8 ``max_groups`` + 8) fp32; the attention's fp32 buffers
    (d_ctx, the group sums, dw of every head); the mbarriers; and the slack
    that puts the ring on a 1024-byte boundary."""
    lim = BWD_TC_LIMITS
    n = lim["gcols"] * max_groups
    red = lim["rows"] * (n + 8) * 4
    att = -(-(proj + _TC_ATT_THREADS * 8 + heads * te) * 4 // 16) * 16
    fixed = _TC_ALIGN + red + att + _TC_BAR_BYTES
    stage = (128 if rows > 64 else 64) * 128 + n * 128
    stages = min(max(lim["smem_limit"] - fixed, 0) // stage, lim["max_stages"])
    return fixed + stages * stage, stages


def plan_decode_bwd_tc(batch: int, te: int, proj: int, heads: int, h1dim: int, h2dim: int,
                       sms: int, smem_optin: int,
                       name: str = "speller_decode_bwd") -> DecodeBwdTcPlan:
    """The launches of a bfloat16 ``speller_decode_bwd`` call on a card of
    ``sms`` SMs whose blocks may opt into ``smem_optin`` bytes of shared
    memory: one launch a span of up to 128 batch rows, min(128, SMs) blocks
    each, owning the groups of ``bwd_tc_groups``. Raises a ``ValueError``
    naming the limit for a shape the kernel does not take."""
    lim = BWD_TC_LIMITS
    if batch < 1 or te < 1:
        raise ValueError(f"{name}: batch {batch} and encoder length {te} must be at least 1")
    kc = lim["kc"]
    if h1dim % kc or h2dim % kc or proj % kc or min(h1dim, h2dim, proj) < kc:
        raise ValueError(f"{name}: H1 {h1dim}, H2 {h2dim} and P {proj} must be multiples "
                         f"of {kc} (bfloat16: the products' 64-column TMA boxes)")
    blocks = min(lim["max_grid"], sms)
    groups = bwd_tc_groups(h1dim, h2dim, proj, blocks)
    max_groups = max(len(g) for g in groups)
    if max_groups > lim["max_groups"]:
        raise ValueError(f"{name}: H1 + H2 + P = {h1dim + h2dim + proj} above "
                         f"{lim['gcols'] * lim['max_groups'] * blocks} (bfloat16: at most "
                         f"{lim['max_groups']} groups of {lim['gcols']} columns a block on "
                         f"{blocks} blocks)")
    if proj % heads or (proj // heads) % 8:
        raise ValueError(f"{name}: head width P / heads = {proj} / {heads} "
                         f"must be a whole multiple of 8")
    if proj > _TC_ATT_THREADS * 8:
        raise ValueError(f"{name}: P {proj} above {_TC_ATT_THREADS * 8} "
                         f"(the attention takes one 16-byte slice a thread)")
    launches = []
    for r0 in range(0, batch, lim["rows"]):
        r1 = min(r0 + lim["rows"], batch)
        smem, stages = decode_bwd_tc_smem_bytes(r1 - r0, te, proj, heads, max_groups)
        if stages < lim["min_stages"] or smem > smem_optin:
            raise ValueError(f"{name}: needs {smem} bytes of shared memory a block with "
                             f"{lim['min_stages']} ring stages or more (Te {te}, heads "
                             f"{heads}, bfloat16), the device's limit is "
                             f"{min(smem_optin, lim['smem_limit'])}")
        launches.append(DecodeTcLaunch(r0, r1, stages, smem))
    phase_blocks, phase_cols = {}, {}
    for ph, kinds in BWD_PHASES.items():
        per_block = [sum(kind in kinds for kind, _ in g) for g in groups]
        phase_blocks[ph] = sum(n > 0 for n in per_block)
        phase_cols[ph] = lim["gcols"] * max(per_block)
    return DecodeBwdTcPlan(launches, blocks, groups, max_groups, phase_blocks, phase_cols)


# the float32 adjoint's geometry (csrc/speller_bwd.cu), mirrored here so
# that its plan is pure; bwd_kernel_limits reads the source's, and a card
# test holds the two equal: blocks at most, consumer threads a block, k of a
# TMA box, floats of a box's (and a staged) row, boxes a ring stage, stages, k
# slices and rows of a box at most, the ring's alignment slack
BWD_F32_LIMITS = {"max_grid": 128, "nthreads": 256, "box_k": 128, "ldx": 132, "max_boxes": 2,
                  "max_stages": 8, "max_ks": 16, "max_box_rows": 256, "align": 128}


@functools.lru_cache(maxsize=None)
def bwd_kernel_limits(device: int) -> dict:
    """The float32 adjoint's geometry as ``csrc/speller_bwd.cu`` defines it
    (``BWD_F32_LIMITS``' keys), the shared memory a block of ``device`` may
    opt into, and its SMs."""
    keys = (*BWD_F32_LIMITS, "smem_optin", "sms")
    out = (ctypes.c_longlong * len(keys))()
    err = load_bwd_library().speller_bwd_limits(device, out)
    if err != 0:
        raise RuntimeError(f"speller_decode_bwd: reading the limits of device "
                           f"{device} failed with cudaError {err}")
    return dict(zip(keys, out))


class DecodeBwdF32Plan(NamedTuple):
    """The one launch of a float32 adjoint call and its geometry."""
    blocks: int
    col_groups: int  # CG: each owns H1 / CG, H2 / CG units and P / CG context columns
    row_groups: int  # RG: each owns ``rows`` batch rows
    rows: int
    sub: int         # rows of a product's sub-tile (a ring stage's rows)
    boxes: int       # TMA boxes (128 k) a ring stage
    stages: int      # the ring's stages
    ks: int          # k slices of a product, at most
    att_groups: int  # frame groups of the attention's dq_att, at most
    stream: int      # 1: (d)'s weight rows stream through the ring each step
    smem: int        # shared memory a block, bytes


def bwd_f32_tiling(sub: int, cols: int, ks_max: int, quads: int) -> tuple:
    """A product's thread tiles over ``sub`` rows x ``cols`` columns
    (``da_tiling``): (columns a tile WD, the widest of 4, 2, 1 dividing
    ``cols``; rows a tile RT = 8; tiles; k slices KS, up to ``ks_max``, the
    stage's ``quads`` 16-byte pieces and what fills the 256 threads)."""
    wd = 4 if cols % 4 == 0 else 2 if cols % 2 == 0 else 1
    tiles = cols // wd * (sub // 8)
    return wd, 8, tiles, min(BWD_F32_LIMITS["nthreads"] // tiles if tiles else 0, ks_max, quads)


def _bwd_f32_phases(proj: int, h1dim: int, h2dim: int, col_groups: int) -> tuple:
    """(columns, K) of the three products a block forms: (b) its cell-2
    units over P, (c) its cell-1 and cell-2 units over 4 H2, (d) its cell-1
    units and context columns over 4 H1."""
    u1, u2, nq = h1dim // col_groups, h2dim // col_groups, proj // col_groups
    return ((u2, proj), (u1 + u2, 4 * h2dim), (u1 + nq, 4 * h1dim))


def _bwd_att_groups(proj: int, heads: int, att: int) -> int:
    return min(att, BWD_F32_LIMITS["nthreads"] // (proj // heads // 4))


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _bwd_f32_wrows(proj: int, h1dim: int, col_groups: int) -> int:
    """(d)'s weight rows of a block where they stream, each kind padded to 8."""
    return _pad8(h1dim // col_groups) + _pad8(proj // col_groups)


def decode_bwd_f32_smem_bytes(te: int, proj: int, heads: int, h1dim: int, h2dim: int,
                              col_groups: int, sub: int, boxes: int, stages: int, ks: int,
                              att_groups: int, stream: int = 0) -> int:
    """Shared memory a block of the float32 adjoint uses (``da_smem_bytes``
    in csrc/speller_bwd.cu): 128 bytes of alignment slack; the ring,
    ``stages`` x ``boxes`` x (``sub`` rows, and with ``stream`` the block's
    (d) weight rows, each kind padded to 8) x 132 floats; two mbarriers a
    stage (rounded up to 16 bytes); the block's resident weight rows, fp32
    ((d)'s only without ``stream``); and one region that the attention
    (d_ctx of a head, dw of Te frames, the dq_att group sums, 8 warp sums)
    and the products' partial tiles (KS x ``sub`` x columns of the widest
    phase) take in turn."""
    lim = BWD_F32_LIMITS
    d = proj // heads
    att = d + te + _bwd_att_groups(proj, heads, att_groups) * d + lim["nthreads"] // 32
    red = 0
    for cols, k in _bwd_f32_phases(proj, h1dim, h2dim, col_groups):
        quads = min(boxes * lim["box_k"], k) // 4
        red = max(red, bwd_f32_tiling(sub, cols, ks, quads)[3] * sub * cols)
    u1, u2, nq = h1dim // col_groups, h2dim // col_groups, proj // col_groups
    weights = u2 * proj + (u1 + u2) * 4 * h2dim + (0 if stream else (u1 + nq) * 4 * h1dim)
    ring = stages * boxes * (sub + (_bwd_f32_wrows(proj, h1dim, col_groups) if stream else 0)) \
        * lim["ldx"] * 4
    bars = stages * 16
    return lim["align"] + ring + bars + 4 * (weights + max(att, red))


# a ring's shapes in the order taken where they fit: (boxes a stage, the
# fewest stages); measured on an H100 at base- and scaled-LAS: as many k
# slices as fit first, then the widest stages, as many as fit but at least
# one in flight behind the one read, and a ring of one stage (no load behind
# the product) last
_BWD_RINGS = ((2, 2), (1, 2), (2, 1), (1, 1))


def _bwd_f32_inner(te: int, proj: int, heads: int, h1dim: int, h2dim: int, col_groups: int,
                   sub: int, stream: int, limit: int):
    """(k slices, the ring's index in ``_BWD_RINGS``, boxes, stages,
    attention groups, shared memory) of a block of ``col_groups`` and
    ``sub``-row sub-tiles: the most k slices (16, 8, ... 1) and attention
    groups (all, 16, 1) with which a ring of ``_BWD_RINGS`` fits ``limit``
    bytes, the first such ring, and as many stages as fit up to 8; or, where
    none fits, the least shared memory a block needs (an int)."""
    lim = BWD_F32_LIMITS

    def smem(boxes, stages, ks, att):
        return decode_bwd_f32_smem_bytes(te, proj, heads, h1dim, h2dim, col_groups, sub, boxes,
                                         stages, ks, att, stream)

    least = smem(1, 1, 1, 1)
    if least > limit:
        return least
    atts = sorted({_bwd_att_groups(proj, heads, a) for a in (lim["nthreads"], 16, 1)},
                  reverse=True)
    for ks, att in itertools.product((16, 8, 4, 2, 1), atts):
        if smem(1, 1, ks, att) > limit:  # no ring fits beside these
            continue
        for i, (boxes, fewest) in enumerate(_BWD_RINGS):
            base = smem(boxes, 0, ks, att)
            stages = min(lim["max_stages"], (limit - base) // (smem(boxes, 1, ks, att) - base))
            if stages >= fewest:
                return ks, i, boxes, stages, att, smem(boxes, stages, ks, att)
    return least


def plan_decode_bwd_f32(batch: int, te: int, proj: int, heads: int, h1dim: int, h2dim: int,
                        sms: int, smem_optin: int,
                        name: str = "speller_decode_bwd") -> DecodeBwdF32Plan:
    """The launch of a float32 ``speller_decode_bwd`` call (one a call, the
    whole batch) on a card of ``sms`` SMs whose blocks may opt into
    ``smem_optin`` bytes of shared memory: CG column groups (a power of two
    dividing H1, H2 and P) x RG row groups of R rows. For each split and
    each form of (d)'s weights (resident, or streamed with its input where a
    block's rows of them fit a TMA box), the widest sub-tile (the whole row
    group where it fits) with the k slices, ring and attention groups of
    ``_bwd_f32_inner``. Of these it takes the most blocks (at most 128 and
    the SMs), then the most k slices and the ring first in ``_BWD_RINGS``,
    then the fewest bytes into a block a step (the rows its ring carries of
    the three products' inputs, and (d)'s weight rows where they stream: at
    the same blocks every split forms the same FMAs a block, and the
    products are bound by their feed), then the most column groups (the
    fewest rows padded to 8). Down to 8-row sub-tiles, one stage of one box,
    one k slice and one attention group, a block uses no more shared memory
    than the float32 forward's (``plan_decode_f32``) least on the same
    columns, so every shape the forward takes is taken. Raises a
    ``ValueError`` naming the limit for a shape the kernel does not take."""
    lim = BWD_F32_LIMITS
    if batch < 1 or te < 1:
        raise ValueError(f"{name}: batch {batch} and encoder length {te} must be at least 1")
    if h1dim % 8 or h2dim % 8 or proj % 8 or min(h1dim, h2dim, proj) < 8:
        raise ValueError(f"{name}: H1 {h1dim}, H2 {h2dim} and P {proj} must be multiples "
                         f"of 8")
    if heads < 1 or proj % heads or (proj // heads) % 8:
        raise ValueError(f"{name}: head width P / heads = {proj} / {heads} "
                         f"must be a whole multiple of 8")
    if proj // heads > lim["nthreads"] * 4:
        raise ValueError(f"{name}: head width {proj // heads} above {lim['nthreads'] * 4} "
                         f"(the attention takes one 16-byte slice a thread)")
    most = min(lim["max_grid"], sms)
    limit = min(smem_optin, _SMEM_LIMIT_F32)
    splits = {}  # blocks -> {(CG, RG, R)}
    cg = 1
    while cg <= most and not (h1dim % cg or h2dim % cg or proj % cg):
        rg_try = 1
        while cg * rg_try <= most and rg_try <= batch:
            rows = -(-batch // rg_try)
            rg = -(-batch // rows)
            splits.setdefault(cg * rg, set()).add((cg, rg, rows))
            rg_try *= 2
        cg *= 2
    least, tiled = None, False
    for blocks in sorted(splits, reverse=True):
        best = None
        for cg, rg, rows in splits[blocks]:
            phases = _bwd_f32_phases(proj, h1dim, h2dim, cg)
            # (d)'s weights may stream where a block's rows of each fit a TMA box
            streams = (0, 1) if max(h1dim, proj) // cg <= lim["max_box_rows"] else (0,)
            atoms = _pad8(rows)
            subs = sorted({min(atoms, lim["max_box_rows"]), *(8 << i for i in range(6))},
                          reverse=True)
            for stream in streams:
                for sub in (s for s in subs if s <= atoms):
                    if any(bwd_f32_tiling(sub, cols, 1, 1)[2] > lim["nthreads"]
                           for cols, _ in phases):
                        continue
                    tiled = True
                    inner = _bwd_f32_inner(te, proj, heads, h1dim, h2dim, cg, sub, stream, limit)
                    if isinstance(inner, int):
                        least = min(least or inner, inner)
                        continue
                    ks, ring, boxes, stages, att, smem = inner
                    fed = -(-rows // sub) * sub * (proj + 4 * h2dim + 4 * h1dim) + \
                        (_bwd_f32_wrows(proj, h1dim, cg) * 4 * h1dim if stream else 0)
                    key = (-ks, ring, fed, -cg)
                    if best is None or key < best[0]:
                        best = (key, DecodeBwdF32Plan(blocks, cg, rg, rows, sub, boxes, stages,
                                                      ks, _bwd_att_groups(proj, heads, att),
                                                      stream, smem))
                    break
        if best is not None:
            return best[1]
    if not tiled:
        raise ValueError(f"{name}: H1 / CG + P / CG columns of a block above "
                         f"{lim['nthreads']} tiles at every column group (H1 {h1dim}, "
                         f"H2 {h2dim}, P {proj})")
    raise ValueError(f"{name}: needs {least} bytes of shared memory a block at the "
                     f"least (Te {te}, heads {heads}, H1 {h1dim}, float32), the device's "
                     f"limit is {limit}")


def _check_operands(name, ref, operands):
    """Every operand (label -> (tensor, shape)) has its shape and is
    contiguous, in ``ref``'s dtype, on ``ref``'s device (a CUDA device)."""
    if not ref.is_cuda:
        raise ValueError(f"{name}: kernel needs CUDA tensors, got {ref.device}")
    if ref.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {ref.dtype} not supported "
                         f"(float32 or bfloat16)")
    for key, (t, shape) in operands.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.device != ref.device or t.dtype != ref.dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {ref.dtype} on "
                             f"{ref.device}")


def _launch(k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1, wih2,
            whh2, b2, wq, bq, wcls, clsb, heads, scale, sos_idx, steps,
            forced, m1=None, m2=None, train=False):
    """Check shapes and launch the forward kernel: bfloat16 on the
    tensor-core source (``_launch_tc``), float32 on ``csrc/speller_decode.cu``.
    Returns (logits, weights, ids), and with ``train`` also the tuple of
    residual streams."""
    name = "speller_decode_train" if train else "speller_decode"
    with span(LAUNCH + name):
        dtype = k.dtype
        batch, te, proj = k.shape
        h1dim, h2dim, vp = whh1.shape[0], whh2.shape[0], embw1.shape[0]
        operands = {"k": (k, (batch, te, proj)), "v": (v, (batch, te, proj)),
                    "bias": (bias, (batch, te)), "ctx0": (ctx0, (batch, proj)),
                    "h10": (h10, (batch, h1dim)), "c10": (c10, (batch, h1dim)),
                    "h20": (h20, (batch, h2dim)), "c20": (c20, (batch, h2dim)),
                    "embw1": (embw1, (vp, 4 * h1dim)),
                    "wc1": (wc1, (proj, 4 * h1dim)),
                    "whh1": (whh1, (h1dim, 4 * h1dim)),
                    "wih2": (wih2, (h1dim, 4 * h2dim)),
                    "whh2": (whh2, (h2dim, 4 * h2dim)), "b2": (b2, (4 * h2dim,)),
                    "wq": (wq, (h2dim, proj)), "bq": (bq, (proj,)),
                    "wcls": (wcls, (2 * proj, vp)), "clsb": (clsb, (vp,))}
        if m1 is not None or m2 is not None:
            if not train or m1 is None or m2 is None:
                raise ValueError(f"{name}: the dropout masks m1 and m2 come "
                                 f"together, and only in the training form")
            operands["m1"] = (m1, (steps, batch, h1dim))
            operands["m2"] = (m2, (steps, batch, h2dim))
        _check_operands(name, k, operands)
        if forced is not None and (
                tuple(forced.shape) != (steps, batch) or forced.dtype != torch.int32
                or forced.device != k.device or not forced.is_contiguous()):
            raise ValueError(f"{name}: forced ids must be contiguous int32 "
                             f"({steps}, {batch}) on {k.device}")
        if steps < 1:
            raise ValueError(f"{name}: steps {steps} must be at least 1")
        if not 0 <= sos_idx < vp:
            raise ValueError(f"{name}: padded vocabulary {vp} must hold <sos> {sos_idx}")
        if dtype == torch.bfloat16:
            return _launch_tc(name, k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1,
                              wih2, whh2, b2, wq, bq, wcls, clsb, heads, scale, sos_idx,
                              steps, forced, m1, m2, train)
        lim = kernel_limits(k.device.index)
        plan = plan_decode_f32(batch, te, proj, heads, h1dim, h2dim, vp, lim["sms"],
                               lim["smem_optin"], name)
        lib = load_library()

        def empty(*shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=k.device)

        logits = empty(steps, batch, vp)
        wgts = empty(steps, batch, heads, te)
        ids = empty(steps, batch, dt=torch.int32)
        # the exchange buffers of the eval form (the training form exchanges
        # through its h1d, h2d and context streams), then q, the fp32 c carries
        # and the fed-back id
        scratch = ([None] * 3 if train else
                   [empty(2, batch, h1dim), empty(2, batch, h2dim), empty(batch, proj)])
        scratch += [empty(batch, proj), empty(batch, h1dim, dt=torch.float32),
                    empty(batch, h2dim, dt=torch.float32), empty(batch, dt=torch.int32)]
        saved = ()
        if train:  # the order of RESIDUALS
            saved = (empty(steps, batch, dt=torch.int32), empty(steps, batch, 4 * h1dim),
                     empty(steps, batch, h1dim), empty(steps, batch, h1dim),
                     empty(steps, batch, 4 * h2dim), empty(steps, batch, h2dim),
                     empty(steps, batch, h2dim), empty(steps, batch, proj))
        # the order of enum Ptr in the source; last each row's extent and the
        # rows in order of it (scratch)
        tensors = ([k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1, wih2,
                    whh2, b2, wq, bq, wcls, clsb, forced, logits, wgts, ids]
                   + scratch + [m1, m2, *saved] + [None] * (8 - len(saved))
                   + [empty(batch, dt=torch.int32), empty(batch, dt=torch.int32)])
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[None if t is None else t.data_ptr() for t in tensors])
        dims = (ctypes.c_int * 9)(batch, te, steps, proj, heads, h1dim, h2dim, vp,
                                  sos_idx)
        geom = (ctypes.c_int * 6)(plan.col_groups, plan.row_groups, plan.rows, plan.sub,
                                  plan.stages, plan.att_rows)
        with torch.cuda.device(k.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.speller_decode_launch(_DTYPE_CODES[dtype], int(train), geom, ptrs,
                                            dims, float(scale), stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed with cudaError {err}")
        LAUNCHES[name] += 1
        return (logits, wgts, ids, saved) if train else (logits, wgts, ids)


def _launch_tc(name, k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1, wih2,
               whh2, b2, wq, bq, wcls, clsb, heads, scale, sos_idx, steps, forced,
               m1, m2, train):
    """The bfloat16 forward on ``csrc/speller_decode_tc.cu``, one launch a
    span of ``plan_decode_tc`` (operands already checked)."""
    batch, te, proj = k.shape
    h1dim, h2dim, vp = whh1.shape[0], whh2.shape[0], embw1.shape[0]
    lim = tc_kernel_limits(k.device.index)
    plan = plan_decode_tc(batch, te, proj, heads, h1dim, h2dim, vp, lim["sms"],
                          lim["smem_optin"], name)
    lib = load_tc_library()

    def empty(*shape, dt=k.dtype):
        return torch.empty(shape, dtype=dt, device=k.device)

    logits = empty(steps, batch, vp)
    wgts = empty(steps, batch, heads, te)
    ids = empty(steps, batch, dt=torch.int32)
    # the exchanges: slot 0 the t = -1 state; the training form's slots 1..
    # are its h1d, h2d and context streams
    slots = steps + 1 if train else 2
    h1x, h2x, ctxx = (empty(slots, batch, n) for n in (h1dim, h2dim, proj))
    selx = empty(2, batch, TC_LIMITS["sel"])  # the fed id's one-hot
    qx = empty(batch, proj)
    streams = [None] * 5
    if train:  # sel, gates1, c1, gates2, c2
        streams = [empty(steps, batch, dt=torch.int32), empty(steps, batch, 4 * h1dim),
                   empty(steps, batch, h1dim), empty(steps, batch, 4 * h2dim),
                   empty(steps, batch, h2dim)]
    counters = torch.zeros(len(plan.launches), 4, dtype=torch.int32, device=k.device)
    w1s = stream_weights(whh1, wc1, embw1, plan.blocks) if plan.streamed else None
    # the order of enum TcPtr in the source, each with its batch dimension
    # (None: no batch dimension)
    entries = ([(t, 0) for t in (k, v, bias, ctx0, h10, c10, h20, c20)]
               + [(t, None) for t in (embw1, wc1, whh1, wih2, whh2, b2, wq, bq, wcls, clsb)]
               + [(t, 1) for t in (forced, logits, wgts, ids, h1x, h2x, ctxx, selx)]
               + [(qx, 0)] + [(t, 1) for t in (m1, m2, *streams)] + [(w1s, None)])
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i, ln in enumerate(plan.launches):
            ptrs = (ctypes.c_void_p * len(entries))(*[
                None if t is None else
                t.data_ptr() + (0 if bdim is None else ln.r0 * t.stride(bdim) * t.element_size())
                for t, bdim in entries])
            dims = (ctypes.c_int * 11)(ln.r1 - ln.r0, batch, te, steps, proj, heads, h1dim,
                                       h2dim, vp, sos_idx, plan.blocks)
            err = lib.speller_decode_tc_launch(int(train), int(plan.streamed), ptrs, dims,
                                               slots, float(scale), counters[i].data_ptr(),
                                               stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch failed with cudaError {err}")
            LAUNCHES[name] += 1
    if not train:
        return logits, wgts, ids
    sel, gates1, c1, gates2, c2 = streams
    return logits, wgts, ids, (sel, gates1, c1, h1x[1:], gates2, c2, h2x[1:], ctxx[1:])


def _launch_bwd(k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1, gates2,
                c2, wgts, m1, m2, dqup, dctxup, dwup, heads, scale):
    """Check shapes and launch the adjoint kernel: bfloat16 on the
    tensor-core source (``_launch_bwd_tc``), float32 on
    ``csrc/speller_bwd.cu``, the whole batch in one launch (the source says
    why)."""
    name = "speller_decode_bwd"
    with span(LAUNCH + name):
        dtype = k.dtype
        batch, te, proj = k.shape
        h1dim, h2dim = whh1.shape[0], whh2.shape[0]
        steps = gates1.shape[0]
        operands = {"k": (k, (batch, te, proj)), "v": (v, (batch, te, proj)),
                    "wc1": (wc1, (proj, 4 * h1dim)),
                    "whh1": (whh1, (h1dim, 4 * h1dim)),
                    "wih2": (wih2, (h1dim, 4 * h2dim)),
                    "whh2": (whh2, (h2dim, 4 * h2dim)), "wq": (wq, (h2dim, proj)),
                    "c10": (c10, (batch, h1dim)), "c20": (c20, (batch, h2dim)),
                    "gates1": (gates1, (steps, batch, 4 * h1dim)),
                    "c1": (c1, (steps, batch, h1dim)),
                    "gates2": (gates2, (steps, batch, 4 * h2dim)),
                    "c2": (c2, (steps, batch, h2dim)),
                    "wgts": (wgts, (steps, batch, heads, te)),
                    "dqup": (dqup, (steps, batch, proj)),
                    "dctxup": (dctxup, (steps, batch, proj))}
        if (m1 is None) != (m2 is None):
            raise ValueError(f"{name}: the dropout masks m1 and m2 come together")
        if m1 is not None:
            operands["m1"] = (m1, (steps, batch, h1dim))
            operands["m2"] = (m2, (steps, batch, h2dim))
        if dwup is not None:
            operands["dwup"] = (dwup, (steps, batch, heads, te))
        _check_operands(name, k, operands)

        def empty(*shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=k.device)

        f32 = torch.float32
        outs = [empty(steps, batch, 4 * h1dim), empty(steps, batch, 4 * h2dim),
                empty(steps, batch, proj), empty(steps, batch, proj),
                empty(steps, batch, heads, te),
                empty(batch, h1dim, dt=f32), empty(batch, h1dim, dt=f32),
                empty(batch, h2dim, dt=f32), empty(batch, h2dim, dt=f32),
                empty(batch, proj, dt=f32)]
        if dtype == torch.bfloat16:
            return _launch_bwd_tc(k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1, gates2,
                                  c2, wgts, m1, m2, dqup, dctxup, dwup, heads, scale, outs)
        if steps < 1:
            raise ValueError(f"{name}: steps {steps} must be at least 1")
        plan = bwd_f32_plan_for(k, heads, h1dim, h2dim, name)
        lib = load_bwd_library()
        counters = torch.zeros(2 + 4 * plan.row_groups, dtype=torch.int32, device=k.device)
        # the order of enum Ptr in the source; last each (row, head) item's extent
        # and the items in order of it (scratch)
        tensors = ([k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1, gates2, c2,
                    wgts, m1, m2, dqup, dctxup, dwup] + outs
                   + [empty(batch * heads, dt=torch.int32), empty(batch * heads, dt=torch.int32)])
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[None if t is None else t.data_ptr() for t in tensors])
        dims = (ctypes.c_int * 7)(batch, te, steps, proj, heads, h1dim, h2dim)
        geom = bwd_f32_geometry(plan)
        geom = (ctypes.c_int * len(geom))(*geom)
        with torch.cuda.device(k.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.speller_bwd_launch(ptrs, dims, geom, float(scale), counters.data_ptr(),
                                         stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed with cudaError {err} ({plan})")
        LAUNCHES[name] += 1
        return tuple(outs)


def bwd_f32_plan_for(k: torch.Tensor, heads: int, h1dim: int, h2dim: int,
                     name: str = "speller_decode_bwd") -> DecodeBwdF32Plan:
    """The plan a float32 adjoint call on K ``k`` (B, Te, P) takes on its
    card: ``plan_decode_bwd_f32`` on the card's SMs and shared memory."""
    lim = bwd_kernel_limits(k.device.index)
    batch, te, proj = k.shape
    return plan_decode_bwd_f32(batch, te, proj, heads, h1dim, h2dim, lim["sms"],
                               lim["smem_optin"], name)


def bwd_f32_geometry(plan: DecodeBwdF32Plan) -> tuple:
    """The plan's geometry in the order of enum GeomSlot in
    csrc/speller_bwd.cu."""
    return (plan.col_groups, plan.row_groups, plan.rows, plan.sub, plan.boxes, plan.stages,
            plan.ks, plan.att_groups, plan.stream)


def _launch_bwd_tc(k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1, gates2, c2, wgts,
                   m1, m2, dqup, dctxup, dwup, heads, scale, outs):
    """The bfloat16 adjoint on ``csrc/speller_bwd_tc.cu`` into ``outs``, one
    launch a span of ``plan_decode_bwd_tc`` (operands already checked)."""
    name = "speller_decode_bwd"
    batch, te, proj = k.shape
    h1dim, h2dim = whh1.shape[0], whh2.shape[0]
    steps = gates1.shape[0]
    lim = bwd_tc_kernel_limits(k.device.index)
    plan = plan_decode_bwd_tc(batch, te, proj, heads, h1dim, h2dim, lim["sms"],
                              lim["smem_optin"], name)
    lib = load_bwd_tc_library()
    counters = torch.zeros(len(plan.launches), 4, dtype=torch.int32, device=k.device)
    # the order of enum BtPtr in the source, each with its batch dimension
    # (None: no batch dimension)
    entries = ([(k, 0), (v, 0)] + [(t, None) for t in (wc1, whh1, wih2, whh2, wq)]
               + [(c10, 0), (c20, 0)]
               + [(t, 1) for t in (gates1, c1, gates2, c2, wgts, m1, m2, dqup, dctxup, dwup)]
               + [(t, 1) for t in outs[:5]] + [(t, 0) for t in outs[5:]])
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i, ln in enumerate(plan.launches):
            ptrs = (ctypes.c_void_p * len(entries))(*[
                None if t is None else
                t.data_ptr() + (0 if bdim is None else ln.r0 * t.stride(bdim) * t.element_size())
                for t, bdim in entries])
            dims = (ctypes.c_int * 9)(ln.r1 - ln.r0, batch, te, steps, proj, heads, h1dim,
                                      h2dim, plan.blocks)
            err = lib.speller_bwd_tc_launch(ptrs, dims, float(scale), counters[i].data_ptr(),
                                            stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch failed with cudaError {err}")
            LAUNCHES[name] += 1
    return tuple(outs)


def speller_decode(k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1,
                   wih2, whh2, b2, wq, bq, wcls, clsb, *, heads: int,
                   scale: float, sos_idx: int, steps: int,
                   forced: Optional[torch.Tensor] = None):
    """The whole free-running decode of a batch.

    k, v (B, Te, P) with head h in columns [h*d, (h+1)*d); bias (B, Te),
    0 or NEG; the t = -1 state ctx0 (B, P), h10/c10 (B, H1), h20/c20
    (B, H2); embw1 (Vp, 4H1) = pad(emb) @ W_ih1[:E] + b1; wc1 (P, 4H1) and
    whh1 (H1, 4H1); wih2 (H1, 4H2), whh2 (H2, 4H2), b2 (4H2,); wq (H2, P),
    bq (P,); wcls (2P, Vp), clsb (Vp,) NEG-padded. All in one dtype
    (float32 or bfloat16). ``forced`` (T, B) int32 feeds id ``forced[t]``
    at step t where it is >= 0 (-1 = free run); step 0 otherwise feeds
    ``sos_idx``.

    Returns (logits (T, B, Vp), weights (T, B, heads, Te), ids (T, B)
    int32): the ids are each step's first-max argmax, the next step's input
    unless forced."""
    args = (k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1, wih2,
            whh2, b2, wq, bq, wcls, clsb)
    if k.device.type == "cpu":
        return speller_decode_plain(*args, heads=heads, scale=scale,
                                    sos_idx=sos_idx, steps=steps,
                                    forced=forced)
    return _launch(*args, heads, scale, sos_idx, steps, forced)


def speller_decode_train(k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1,
                         wih2, whh2, b2, wq, bq, wcls, clsb, *, heads: int,
                         scale: float, sos_idx: int, steps: int,
                         forced: Optional[torch.Tensor] = None,
                         m1: Optional[torch.Tensor] = None,
                         m2: Optional[torch.Tensor] = None):
    """The training form of ``speller_decode``: its operands, the forced ids,
    and the dropout masks m1 (T, B, H1), m2 (T, B, H2) in the operands'
    dtype, 0 or 1 / keep (both or neither), which multiply the cells' outputs
    in fp32; the dropped output is the carry.

    Returns (logits, weights, ids, residuals): the streams the adjoint reads
    (``RESIDUALS``), in the operands' dtype but for the fed ids."""
    args = (k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1, wih2,
            whh2, b2, wq, bq, wcls, clsb)
    if k.device.type == "cpu":
        return speller_decode_train_plain(*args, heads=heads, scale=scale,
                                          sos_idx=sos_idx, steps=steps,
                                          forced=forced, m1=m1, m2=m2)
    return _launch(*args, heads, scale, sos_idx, steps, forced, m1, m2, train=True)


def speller_decode_bwd(k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1,
                       gates2, c2, wgts, m1, m2, dqup, dctxup, dwup, *,
                       heads: int, scale: float):
    """The adjoint of the training decode, time running down.

    k, v and the weights as ``speller_decode`` takes them; c10, c20 the
    t = -1 carries; the forward's streams gates1 (T, B, 4H1), c1 (T, B, H1),
    gates2, c2, the attention weights (T, B, heads, Te) and the masks m1, m2
    (or None); the cotangents of q and of the context through the
    classifier, dqup and dctxup (T, B, P), and of the weights, dwup
    (T, B, heads, Te) or None. All in one dtype.

    Returns (dpre1 (T, B, 4H1), dpre2 (T, B, 4H2), dq, dctxtot (T, B, P),
    dsc (T, B, heads, Te) in that dtype; dh10, dc10 (B, H1), dh20, dc20
    (B, H2), dctx0 (B, P) float32)."""
    args = (k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1, gates2, c2,
            wgts, m1, m2, dqup, dctxup, dwup)
    if k.device.type == "cpu":
        return speller_decode_bwd_plain(*args, heads=heads, scale=scale)
    return _launch_bwd(*args, heads, scale)


class _FusedDecode(torch.autograd.Function):
    """``fused_decode`` under autograd (the JAX ``fused_decode`` custom VJP,
    speller_pallas.py:636-802): forward the training kernel, backward the
    adjoint kernel and, outside any kernel as in the JAX package
    (``_fused_bwd`` :694-799), the cotangents through the tied classifier and
    the weight gradients as products over all T x B rows, each with float32
    accumulation and the result in the operand's dtype."""

    @staticmethod
    def forward(ctx, heads, scale, sos_idx, steps, forced, m1, m2, *operands):
        logits, wgts, ids, saved = speller_decode_train(
            *operands, heads=heads, scale=scale, sos_idx=sos_idx, steps=steps,
            forced=forced, m1=m1, m2=m2)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(ids)
        ctx.options = (heads, scale)
        ctx.has_masks = m1 is not None
        ctx.save_for_backward(*operands, *saved, wgts, *((m1, m2) if ctx.has_masks else ()))
        return logits, wgts, ids

    @staticmethod
    def backward(ctx, d_logits, d_wgts, _d_ids):
        with span("las.backward.speller"):
            heads, scale = ctx.options
            tensors = ctx.saved_tensors
            (k, v, _bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1, wih2, whh2, b2,
             wq, bq, wcls, clsb) = tensors[:18]
            sel, gates1, c1, h1d, gates2, c2, h2d, ctxs, wgts = tensors[18:27]
            m1, m2 = tensors[27:] if ctx.has_masks else (None, None)
            dt = k.dtype
            steps, batch, vp = gates1.shape[0], k.shape[0], embw1.shape[0]
            proj = k.shape[2]
            if d_logits is None:
                d_logits = torch.zeros(steps, batch, vp, dtype=dt, device=k.device)
            d_logits = d_logits.to(dt)
            # upstream through the tied classifier
            d_dec = d_logits @ wcls.T
            dqup = d_dec[..., :proj].contiguous()
            dctxup = d_dec[..., proj:].contiguous()
            dwup = None if d_wgts is None else d_wgts.to(dt).contiguous()
            (dpre1, dpre2, dq, dctxtot, dsc, d_h10, d_c10, d_h20, d_c20,
             d_ctx0) = speller_decode_bwd(k, v, wc1, whh1, wih2, whh2, wq, c10, c20,
                                          gates1, c1, gates2, c2, wgts, m1, m2, dqup,
                                          dctxup, dwup, heads=heads, scale=scale)

            def rows(x):  # (T, B, X) -> (T * B, X)
                return x.reshape(-1, x.shape[-1])

            def shifted(x0, xs):  # the stream one step earlier, the t = -1 value first
                return rows(torch.cat([x0[None], xs[:-1]]))

            def col_sum(x):
                return rows(x).sum(0, dtype=torch.float32).to(dt)

            dpre1_r, dpre2_r, dq_r, dl_r = rows(dpre1), rows(dpre2), rows(dq), rows(d_logits)
            # the one-hot the Pallas kernel stores is rebuilt from the fed ids
            sel_1h = F.one_hot(sel.reshape(-1).long(), vp).to(dt)
            d_embw1 = sel_1h.T @ dpre1_r
            d_wc1 = shifted(ctx0, ctxs).T @ dpre1_r
            d_whh1 = shifted(h10, h1d).T @ dpre1_r
            d_wih2 = rows(h1d).T @ dpre2_r
            d_whh2 = shifted(h20, h2d).T @ dpre2_r
            d_wq = rows(h2d).T @ dq_r
            # the classifier: q recomputed once as one product
            q_all = h2d @ wq + bq
            d_wcls = rows(torch.cat([q_all, ctxs], dim=-1)).T @ dl_r
            # the attention cache, per head as products over time in float32
            d_head = proj // heads
            d_k = scale * torch.einsum(
                "tbhe,tbhd->behd", dsc.float(),
                q_all.float().reshape(steps, batch, heads, d_head))
            d_v = torch.einsum("tbhe,tbhd->behd", wgts.float(),
                               dctxtot.float().reshape(steps, batch, heads, d_head))
            return (None,) * 7 + (
                d_k.reshape(k.shape).to(dt), d_v.reshape(v.shape).to(dt), None,
                d_ctx0.to(dt), d_h10.to(dt), d_c10.to(dt), d_h20.to(dt), d_c20.to(dt),
                d_embw1, d_wc1, d_whh1, d_wih2, d_whh2, col_sum(dpre2), d_wq,
                col_sum(dq), d_wcls, col_sum(d_logits))


def fused_decode(operands, *, heads: int, scale: float, sos_idx: int, steps: int,
                 forced: Optional[torch.Tensor] = None,
                 m1: Optional[torch.Tensor] = None,
                 m2: Optional[torch.Tensor] = None):
    """The fused decode over ``speller_decode``'s 18 operands, differentiable
    in all of them but the pad bias: (logits (T, B, Vp), weights (T, B,
    heads, Te)). Where a gradient is wanted the training kernel runs under
    ``_FusedDecode``; without one, and without masks, the eval kernel does."""
    opts = {"heads": heads, "scale": scale, "sos_idx": sos_idx, "steps": steps}
    if _wants_grad(*operands):
        return _FusedDecode.apply(heads, scale, sos_idx, steps, forced, m1, m2,
                                  *operands)[:2]
    if m1 is None:
        return speller_decode(*operands, **opts, forced=forced)[:2]
    return speller_decode_train(*operands, **opts, forced=forced, m1=m1, m2=m2)[:2]


# ---------------------------------------------------------------------------
# speller integration (called from models/las.py::speller_apply)
# ---------------------------------------------------------------------------

def decode_operands(params, cfg, enc_h: torch.Tensor, enc_l: torch.Tensor):
    """``speller_decode``'s operands for one batch, in the encoder's dtype
    (speller_pallas.py:933-984): K/V in the head-concatenated layout, the
    NEG pad bias, the t = -1 state (the context of the learned initial query
    from the plain attention step), the pre-projected char embedding and the
    padded tied classifier. Returns (operands, the t = -1 attention
    weights (B, heads, Te))."""
    with span("las.speller.operands"):
        batch, enc_len, _ = enc_h.shape
        dtype = enc_h.dtype
        heads, proj = cfg.att_heads, cfg.att_proj_dim
        h1dim, h2dim = cfg.dec_lstm_hid_dim, cfg.dec_lstm_out_dim
        vocab = cfg.dec_vocab_size
        vp = max(32, ((vocab + 7) // 8) * 8)

        def cast(x):
            return x.to(dtype)

        def init(name, width):
            return cast(params[name]).expand(batch, width).contiguous()

        emb = cast(params["char_emb"])
        cache = cross_attention_precompute(params["attention"], enc_h, enc_l, heads)
        bias = torch.zeros(batch, enc_len, dtype=dtype,
                           device=enc_h.device).masked_fill(cache.mask, NEG)
        init_query = cast(params["init_query"]).expand(batch, h2dim)
        context0, wgts0, _ = cross_attention_step(params["attention"], cache,
                                                  init_query, heads,
                                                  cfg.legacy_scale)
        w_ih1 = cast(params["cell1"]["w_ih"])
        embw1 = (F.pad(emb, (0, 0, 0, vp - vocab)) @ w_ih1[:cfg.dec_emb_dim]
                 + cast(params["cell1"]["b"]))
        operands = (
            cache.keys.transpose(1, 2).reshape(batch, enc_len, proj),
            cache.values.transpose(1, 2).reshape(batch, enc_len, proj),
            bias, context0.contiguous(),
            init("init_h1", h1dim), init("init_c1", h1dim),
            init("init_h2", h2dim), init("init_c2", h2dim),
            embw1, w_ih1[cfg.dec_emb_dim:], cast(params["cell1"]["w_hh"]),
            cast(params["cell2"]["w_ih"]), cast(params["cell2"]["w_hh"]),
            cast(params["cell2"]["b"]),
            cast(params["attention"]["query_map"]["w"]),
            cast(params["attention"]["query_map"]["b"]),
            F.pad(emb.T, (0, vp - vocab)).contiguous(),
            F.pad(cast(params["cls_b"]), (0, vp - vocab), value=NEG))
        return operands, wgts0


def decode_options(cfg) -> dict:
    """``speller_decode``'s keyword arguments for a speller config."""
    d_head = cfg.att_proj_dim // cfg.att_heads
    scale = math.sqrt(d_head) if cfg.legacy_scale else 1.0 / math.sqrt(d_head)
    return {"heads": cfg.att_heads, "scale": scale,
            "sos_idx": cfg.CHR_SOS_IDX, "steps": cfg.CHR_MAX_STEPS}


def decode_draws(cfg, dec_y, tf_rate, train: bool, draws, dtype):
    """The forced-id stream and the dropout masks of one pass
    (speller_pallas.py:899-931): step t feeds ``dec_y[:, t - 1]`` where
    ``coins[t] <= tf_rate`` (one coin a step, shared by the batch; step 0 is
    never forced), else -1, the fed-back argmax; the masks are the draws'
    keep masks scaled by 1 / keep in ``dtype`` (in bfloat16 the scale is
    rounded, as in the JAX package). Without ``draws`` or outside training:
    no forcing, no dropout. Returns (forced (T, B) int32 or None, m1, m2)."""
    forced = m1 = m2 = None
    if not train or draws is None:
        return forced, m1, m2
    if dec_y is not None:
        coins = draws.coins.to(dec_y.device).clone()
        coins[0] = 2.0
        gold = torch.cat([torch.zeros_like(dec_y[:, :1]), dec_y[:, :-1]], dim=1).T
        forced = torch.where((coins <= tf_rate)[:, None], gold.to(torch.int32),
                             -1).contiguous()
    if cfg.dec_lstm_dropout > 0.0:
        keep = 1.0 - cfg.dec_lstm_dropout
        m1 = (draws.m1.to(dtype) / keep).contiguous()
        m2 = (draws.m2.to(dtype) / keep).contiguous()
    return forced, m1, m2


def speller_apply_fused(params, cfg, enc_h: torch.Tensor, enc_l: torch.Tensor,
                        dec_y: Optional[torch.Tensor] = None, tf_rate=1.0,
                        train: bool = False, draws=None):
    """The decode through the fused kernels (the JAX ``speller_apply_fused``,
    speller_pallas.py:862; no ``init_force``). Training: ``dec_y.shape[1]``
    teacher-forced steps with the coins and dropout masks of ``draws``
    (``models.las.TrainDraws``), differentiable in the parameters and
    ``enc_h``. Eval (``dec_y=None``): ``CHR_MAX_STEPS`` free-running greedy
    steps. Returns ``SpellerOutput(logits (B, steps, V), att_map)``, the
    attention map of sample 0 with the t = -1 step first."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import SpellerOutput

    refuse_sharded(params, "decoder_impl")
    operands, wgts0 = decode_operands(params, cfg, enc_h, enc_l)
    with span("las.speller.decode"):
        opts = decode_options(cfg)
        if dec_y is not None:
            opts["steps"] = dec_y.shape[1]
        forced, m1, m2 = decode_draws(cfg, dec_y, tf_rate, train, draws, enc_h.dtype)
        logits_t, wgts_t = fused_decode(operands, **opts, forced=forced, m1=m1, m2=m2)
        logits = logits_t.transpose(0, 1)[:, :, :cfg.dec_vocab_size]
        w_sample0 = wgts_t[:, 0].transpose(0, 1)  # (heads, steps, Te)
        att_map = torch.cat([wgts0[0][:, None, :], w_sample0], dim=1)
        return SpellerOutput(logits=logits, att_map=att_map.transpose(-2, -1))
