"""Multi-head cross-attention for the decoder (counterpart of the JAX
``ops/attention.py``): keys/values precomputed once per batch, one query per
decode step.

Scaling is the correct ``1/sqrt(d_head)`` unless ``legacy_scale`` (the
reference multiplies by ``sqrt(d_head)``). Where the attention's parameters
hold the leaf ``v`` (heads, d_head), the score is additive instead (Bahdanau
et al. 2015, per head as in Chiu et al. 2018): ``v[h] . tanh(q[h] + k[t,
h])``, unscaled, on ``ops/speller_additive.py`` (a kernel on the card, plain
ops on the CPU). Padded frames get the dtype's most negative value before
the softmax and are re-zeroed after it. With
an ``init_wgts_row`` (the early-epoch alignment forcing) the weights are
multiplied by the prior's row and renormalised by a second softmax, as the
reference does; the weights recorded for the attention map stay the
pre-forcing ones.

A cache whose time axis is sharded over devices
(``parallel/sequence.py::shard_cache_over_time``) brings its own step:
``cross_attention_step`` hands such a cache the query
(``sequence_parallel_attention_step``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops.masking import pad_mask
from attention_based_e2e_asr_dnn_tpu_torch.ops.speller_additive import additive_scores


class AttentionCache(NamedTuple):
    """Per-batch precomputed attention state."""

    keys: torch.Tensor    # (B, heads, T, d_head)
    values: torch.Tensor  # (B, heads, T, d_head)
    mask: torch.Tensor    # (B, T) True where PADDED


def linear_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b in x's dtype; params {"w": (in, out), "b": (out,)}."""
    return x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)


def cross_attention_precompute(params, enc_h: torch.Tensor,
                               enc_l: torch.Tensor, heads: int) -> AttentionCache:
    """Project encoder outputs (B, T, enc_out_dim) to keys/values once.
    For the additive score the values are laid out (B, heads, T, d_head) in
    memory here, once, so that each step's context reads them without a
    copy; the keys stay a view of the projection's (B, T, heads, d_head),
    the layout the score's kernel reads."""
    batch, seq_len, _ = enc_h.shape
    proj_dim = params["key_map"]["w"].shape[1]
    d_head = proj_dim // heads
    keys = linear_apply(params["key_map"], enc_h).reshape(batch, seq_len, heads, d_head)
    values = linear_apply(params["value_map"], enc_h).reshape(batch, seq_len, heads, d_head)
    values = values.transpose(1, 2)
    if "v" in params:
        values = values.contiguous()
    return AttentionCache(keys=keys.transpose(1, 2), values=values,
                          mask=pad_mask(enc_l, seq_len))


def cross_attention_step(params, cache: AttentionCache, dec_h: torch.Tensor,
                         heads: int, legacy_scale: bool = False,
                         init_wgts_row: Optional[torch.Tensor] = None):
    """One decode-step query: dec_h (B, dec_out_dim) ->
    (context (B, proj_dim), weights (B, heads, T), q_proj (B, proj_dim)).
    ``init_wgts_row`` (T,): this step's row of the diagonal-forcing prior;
    the returned weights are then the pre-forcing ones."""
    additive = "v" in params
    if not isinstance(cache, AttentionCache):  # time-sharded (parallel/sequence.py)
        if additive:
            raise ValueError("the additive score has no time-sharded step "
                             "(sequence parallelism)")
        return cache.attention_step(params, dec_h, heads, legacy_scale, init_wgts_row)
    batch = dec_h.shape[0]
    proj_dim = params["query_map"]["w"].shape[1]
    d_head = proj_dim // heads
    dtype = dec_h.dtype

    q_proj = linear_apply(params["query_map"], dec_h)
    q = q_proj.reshape(batch, heads, d_head)
    mask = cache.mask[:, None, :]
    if additive:  # masked already; the keys in the projection's layout (a
        # view of it, so no copy, unless the cache was rebuilt, as a beam's is)
        scores = additive_scores(q, cache.keys.transpose(1, 2).contiguous(),
                                 params["v"].to(dtype), cache.mask)
    else:
        scale = math.sqrt(d_head) if legacy_scale else 1.0 / math.sqrt(d_head)
        # the scale rounded to the compute dtype, as the JAX package
        # multiplies by it; a Python number, so no host-to-device copy per step
        scale = torch.tensor(scale, dtype=dtype).item()
        scores = torch.einsum("bhd,bhtd->bht", q, cache.keys) * scale
        scores = scores.masked_fill(mask, torch.finfo(dtype).min)
    wgts = torch.softmax(scores, dim=-1).masked_fill(mask, 0.0)
    used = wgts
    if init_wgts_row is not None:
        # renormalised by another softmax, not by the sum (reference parity)
        used = torch.softmax(wgts * init_wgts_row[None, None, :].to(dtype), dim=-1)
    context = torch.einsum("bht,bhtd->bhd", used, cache.values).reshape(batch, proj_dim)
    if "final_map" in params:
        context = linear_apply(params["final_map"], context)
    return context, wgts, q_proj


def block_diagonal_prior(enc_len: int, steps: int, blocks: int = 6,
                         device=None) -> torch.Tensor:
    """Block-diagonal attention prior for early-epoch alignment forcing:
    entry (i, t) is 1 when encoder frame i and decode step t fall in the same
    of ``blocks`` blocks. Returns (enc_len, steps) float32."""
    a_side = enc_len // blocks + 1
    b_side = steps // blocks + 1
    rows = torch.arange(enc_len, device=device) // a_side
    cols = torch.arange(steps, device=device) // b_side
    return (rows[:, None] == cols[None, :]).float()
