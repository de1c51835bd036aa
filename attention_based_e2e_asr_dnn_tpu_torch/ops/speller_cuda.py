"""Fused speller-decode kernel for Hopper (counterpart of the JAX
``ops/speller_pallas.py``, eval form), with its plain version.

  ``speller_decode``  replaces ``_decode_fwd_kernel`` (speller_pallas.py:90)
                      as ``_fwd_chunk`` (:465) launches it with
                      ``save_residuals=False``: one launch runs every step of
                      the free-running decode for the whole batch (input-id
                      select, cell 1, cell 2, query, masked-softmax attention
                      per head, tied classifier, first-max feedback).

The source (``csrc/speller_decode.cu``) says what bounds the kernel and how
it is laid out. The wrapper runs the plain PyTorch version
(``speller_decode_plain``) for a CPU tensor, launches the kernel for a CUDA
tensor or raises, and counts its launches in ``LAUNCHES``. On the card the
TPU's routing (``pick_chunk``, the Te pad to 64, the lane gates of
``fused_decode_unavailable_reason``) does not apply: a shape the kernel
cannot take raises a ``ValueError`` that names the limit, where the JAX
package falls back to the scan decoder.

``speller_apply_fused`` is the eval form (``dec_y=None``) of the JAX
``speller_apply_fused`` (speller_pallas.py:862): the operands
(``decode_operands``), the kernel, and the ``SpellerOutput`` of
``models/las.py::speller_apply``.

The training form (teacher forcing, dropout masks, the residual streams and
the adjoint kernel #9) is not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build
from attention_based_e2e_asr_dnn_tpu_torch.ops.attention import (
    cross_attention_precompute,
    cross_attention_step,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops.lstm import _gates

SOURCE = os.path.join(cuda_build.CSRC, "speller_decode.cu")

NEG = -1e9  # additive pad bias; exp(NEG - max) underflows to exactly 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches since the last reset
LAUNCHES = {"speller_decode": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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

def speller_decode_plain(k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1,
                         whh1, wih2, whh2, b2, wq, bq, wcls, clsb, *,
                         heads: int, scale: float, sos_idx: int, steps: int,
                         forced: Optional[torch.Tensor] = None):
    """Plain version of ``speller_decode``, step by step in PyTorch with the
    Pallas kernel's numerics (speller_pallas.py:90-216): fp32 carries,
    rounded to the weight dtype only as dot operands; fp32 dots and gates;
    scores and context as fp32 products of operands rounded to the weight
    dtype, summed in fp32 (the context per ``pick_te_chunk`` piece): what
    the kernel computes in interpret mode, where XLA forms the products of
    ``qh * kc`` and ``wc * vc`` in fp32; the feedback is the first maximum
    of the fp32 logits.

    Returns (logits (T, B, Vp), weights (T, B, heads, Te), both in k's
    dtype, and the fed-back ids (T, B) int32)."""
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
    for t in range(steps):
        sel = prev if forced is None else torch.where(forced[t] >= 0,
                                                      forced[t].long(), prev)
        pre1 = (embw1[sel] + op(ctx) @ wc1) + op(h1) @ whh1
        h1, c1 = _gates(pre1, c1, h1dim)
        pre2 = (op(h1) @ wih2 + op(h2) @ whh2) + b2
        h2, c2 = _gates(pre2, c2, h2dim)
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
    return (torch.stack(logits_t), torch.stack(wgts_t),
            torch.stack(ids_t).to(torch.int32))


# ---------------------------------------------------------------------------
# Build, bind, launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build ``csrc/speller_decode.cu`` (once per source version) and bind
    its C entry points."""
    lib = ctypes.CDLL(cuda_build.build_library(SOURCE))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.speller_decode_launch.argtypes = [i, i, p, p, ctypes.c_float, p]
    lib.speller_decode_launch.restype = ctypes.c_int
    lib.speller_decode_smem_bytes.argtypes = [i] * 7
    lib.speller_decode_smem_bytes.restype = ctypes.c_size_t
    lib.speller_decode_limits.argtypes = [i, ctypes.POINTER(ctypes.c_longlong)]
    lib.speller_decode_limits.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def kernel_limits(device: int) -> dict:
    """The kernel's geometry as the source defines it (at most ``max_grid``
    blocks of ``nthreads`` threads, each owning 1, 2, 4 ... ``max_units``
    units of each cell and query columns; ``vmax`` padded vocabulary
    entries) and the shared memory a block of ``device`` may opt into."""
    out = (ctypes.c_longlong * 5)()
    err = load_library().speller_decode_limits(device, out)
    if err != 0:
        raise RuntimeError(f"speller_decode: reading the limits of device "
                           f"{device} failed with cudaError {err}")
    return dict(zip(("max_grid", "max_units", "nthreads", "vmax",
                     "smem_optin"), out))


def grid_size(h1dim: int, h2dim: int, proj: int, max_grid: int) -> int:
    """Blocks of the launch: the largest power of two up to ``max_grid``
    that divides both cells' widths and the projection width."""
    grid = max_grid
    while grid > 1 and (h1dim % grid or h2dim % grid or proj % grid):
        grid //= 2
    return grid


def _launch(k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1, wih2,
            whh2, b2, wq, bq, wcls, clsb, heads, scale, sos_idx, steps,
            forced):
    name = "speller_decode"
    if not k.is_cuda:
        raise ValueError(f"{name}: kernel needs CUDA tensors, got {k.device}")
    dtype = k.dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32 or bfloat16)")
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
    for key, (t, shape) in operands.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.device != k.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {dtype} on "
                             f"{k.device}")
    if batch < 1 or te < 1 or steps < 1:
        raise ValueError(f"{name}: batch {batch}, encoder length {te} and "
                         f"steps {steps} must be at least 1")
    lim = kernel_limits(k.device.index)
    grid = grid_size(h1dim, h2dim, proj, lim["max_grid"])
    allowed = [1 << i for i in range(lim["max_units"].bit_length())]
    if any(n % 8 or n // grid not in allowed for n in (h1dim, h2dim, proj)):
        raise ValueError(f"{name}: H1 {h1dim}, H2 {h2dim} and P {proj} must "
                         f"be multiples of 8 and each {grid} x "
                         f"{', '.join(map(str, allowed[:-1]))} or "
                         f"{allowed[-1]} (one launch of {grid} blocks)")
    if proj % heads or (proj // heads) % 8:
        raise ValueError(f"{name}: head width P / heads = {proj} / {heads} "
                         f"must be a whole multiple of 8")
    vec = 16 // k.element_size()  # elements in a 16-byte load
    if proj > lim["nthreads"] * vec:
        raise ValueError(f"{name}: P {proj} above {lim['nthreads'] * vec} "
                         f"(the context takes one 16-byte slice a thread)")
    if vp > lim["vmax"] or not 0 <= sos_idx < vp:
        raise ValueError(f"{name}: padded vocabulary {vp} must be at most "
                         f"{lim['vmax']} and hold <sos> {sos_idx}")
    if forced is not None and (
            tuple(forced.shape) != (steps, batch) or forced.dtype != torch.int32
            or forced.device != k.device or not forced.is_contiguous()):
        raise ValueError(f"{name}: forced ids must be contiguous int32 "
                         f"({steps}, {batch}) on {k.device}")
    lib = load_library()
    code = _DTYPE_CODES[dtype]
    smem = lib.speller_decode_smem_bytes(code, grid, te, proj, heads, h1dim,
                                         h2dim)
    if smem > lim["smem_optin"]:
        raise ValueError(f"{name}: needs {smem} bytes of shared memory a "
                         f"block (Te {te}, heads {heads}, H1 {h1dim}), the "
                         f"device's limit is {lim['smem_optin']}")

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=k.device)

    logits = empty(steps, batch, vp)
    wgts = empty(steps, batch, heads, te)
    ids = empty(steps, batch, dt=torch.int32)
    scratch = [empty(2, batch, h1dim), empty(2, batch, h2dim),
               empty(batch, proj), empty(batch, proj),
               empty(batch, h1dim, dt=torch.float32),
               empty(batch, h2dim, dt=torch.float32),
               empty(batch, dt=torch.int32)]
    # the order of enum Ptr in the source
    tensors = ([k, v, bias, ctx0, h10, c10, h20, c20, embw1, wc1, whh1, wih2,
                whh2, b2, wq, bq, wcls, clsb, forced, logits, wgts, ids]
               + scratch)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    dims = (ctypes.c_int * 9)(batch, te, steps, proj, heads, h1dim, h2dim, vp,
                              sos_idx)
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.speller_decode_launch(code, grid, ptrs, dims, float(scale),
                                        stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {err}")
    LAUNCHES[name] += 1
    return logits, wgts, ids


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


def speller_apply_fused(params, cfg, enc_h: torch.Tensor,
                        enc_l: torch.Tensor):
    """The free-running eval decode (``CHR_MAX_STEPS`` greedy steps) through
    ``speller_decode``: the JAX ``speller_apply_fused`` with ``dec_y=None,
    train=False``. Returns ``SpellerOutput(logits (B, steps, V), att_map)``,
    the attention map of sample 0 with the t = -1 step first."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import SpellerOutput

    operands, wgts0 = decode_operands(params, cfg, enc_h, enc_l)
    logits_t, wgts_t, _ = speller_decode(*operands, **decode_options(cfg))
    logits = logits_t.transpose(0, 1)[:, :, :cfg.dec_vocab_size]
    w_sample0 = wgts_t[:, 0].transpose(0, 1)  # (heads, steps, Te)
    att_map = torch.cat([wgts0[0][:, None, :], w_sample0], dim=1)
    return SpellerOutput(logits=logits, att_map=att_map.transpose(-2, -1))
