"""Sequence-parallel cross-attention (counterpart of the JAX
``parallel/sequence.py``): the attention cache's time axis cut over devices.

Each seq device holds its frames of K, V and the pad mask and computes its
local scores. The global softmax is assembled on the gather device, as the
JAX ``shard_map`` body assembles it with ``pmax`` / ``psum``: the global
maximum of the scores (without a gradient: the softmax does not depend on
the shift), then the sums of the exponentials and the context numerators,
each a shard's partial moved there and added. The weights keep their
sharded layout (``TimeShards``); ``TimeShards[i]`` puts row i's together.

``shard_cache_over_time`` returns a ``TimeShardedCache``, which
``ops/attention.py::cross_attention_step`` hands the query to, so that the
speller's step loop runs unchanged over it (``models/las.py::speller_apply``
with ``cache_hook``; ``parallel/grid.py`` sets the hook for a grid with a
``seq`` axis).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops.attention import AttentionCache, linear_apply
from attention_based_e2e_asr_dnn_tpu_torch.ops.shards import on_device


class TimeShards:
    """Attention weights (B, heads, T) held as time blocks, block s on the
    device of the cache's block s. ``[i]`` is row i's (heads, T), put
    together on the gather device."""

    def __init__(self, blocks: Sequence[torch.Tensor], gather):
        self.blocks = list(blocks)
        self.gather = torch.device(gather)

    def __getitem__(self, i) -> torch.Tensor:
        return torch.cat([on_device(b[i], self.gather) for b in self.blocks], dim=-1)


class TimeShardedCache(NamedTuple):
    """An ``AttentionCache`` cut along time: block s of keys / values (B,
    heads, T_s, d_head) and of the pad mask (B, T_s) on ``devices[s]``."""

    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    mask: List[torch.Tensor]
    gather: torch.device

    def attention_step(self, params, dec_h, heads, legacy_scale=False, init_wgts_row=None):
        return sequence_parallel_attention_step(params, self, dec_h, heads, legacy_scale,
                                                init_wgts_row)


def _global_softmax_parts(scores: List[torch.Tensor], masks: List[torch.Tensor], gather):
    """exp(scores - global max) a block, zero at pads, and the global sum of
    them on ``gather`` (B, h)."""
    local_max = [on_device(s.detach().amax(dim=-1), gather) for s in scores]
    global_max = torch.stack(local_max).amax(dim=0)                    # (B, h)
    exps = [torch.exp(s - on_device(global_max, s.device)[..., None])
            .masked_fill(m[:, None, :], 0.0)
            for s, m in zip(scores, masks)]
    denom = sum(on_device(e.sum(dim=-1), gather) for e in exps)
    return exps, denom


def sequence_parallel_attention_step(params, cache: TimeShardedCache, dec_h: torch.Tensor,
                                     heads: int, legacy_scale: bool = False,
                                     init_wgts_row: Optional[torch.Tensor] = None):
    """``cross_attention_step`` with the cache's time axis cut over devices:
    dec_h (B, dec_out_dim) on the gather device -> (context (B, proj_dim),
    weights as ``TimeShards``, q_proj (B, proj_dim)). ``init_wgts_row`` (T,):
    the alignment prior's row, whose renormalising softmax is global too; the
    weights returned are then the pre-forcing ones, as in the one-device
    step."""
    batch = dec_h.shape[0]
    proj_dim = params["query_map"]["w"].shape[1]
    d_head = proj_dim // heads
    dtype = dec_h.dtype
    gather = cache.gather

    q_proj = linear_apply(params["query_map"], dec_h)
    q = q_proj.reshape(batch, heads, d_head)
    scale = math.sqrt(d_head) if legacy_scale else 1.0 / math.sqrt(d_head)
    scale = torch.tensor(scale, dtype=dtype).item()
    neg = torch.finfo(dtype).min
    scores = [(torch.einsum("bhd,bhtd->bht", on_device(q, k.device), k) * scale
               ).masked_fill(m[:, None, :], neg)
              for k, m in zip(cache.keys, cache.mask)]
    exps, denom = _global_softmax_parts(scores, cache.mask, gather)
    wgts = [e / on_device(denom, e.device)[..., None] for e in exps]
    used = wgts
    if init_wgts_row is not None:
        # the one-device step's renormalising softmax over wgts * prior, over
        # the whole time axis (its pads included, as there)
        cuts = [w.shape[-1] for w in wgts]
        rows = torch.split(init_wgts_row, cuts)
        biased = [w * on_device(r, w.device)[None, None, :].to(dtype) for w, r in zip(wgts, rows)]
        no_pad = [torch.zeros_like(m) for m in cache.mask]
        used, total = _global_softmax_parts(biased, no_pad, gather)
        used = [u / on_device(total, u.device)[..., None] for u in used]
    ctx_num = sum(on_device(torch.einsum("bht,bhtd->bhd", u, v), gather)
                  for u, v in zip(used, cache.values))
    context = ctx_num.reshape(batch, proj_dim)
    if "final_map" in params:
        context = linear_apply(params["final_map"], context)
    return context, TimeShards(wgts, gather), q_proj


def shard_cache_over_time(cache: AttentionCache, devices: Sequence) -> TimeShardedCache:
    """``cache`` cut along time into ``len(devices)`` equal blocks, block s
    on ``devices[s]``; its time axis must divide, as the JAX ``device_put``
    onto ``P(None, None, 'seq', None)`` requires."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    seq_len = cache.keys.shape[2]
    if seq_len % n:
        raise ValueError(f"attention time axis {seq_len} not divisible by the sequence-"
                         f"parallel degree {n}")
    keys = torch.chunk(cache.keys, n, dim=2)
    values = torch.chunk(cache.values, n, dim=2)
    mask = torch.chunk(cache.mask, n, dim=1)
    return TimeShardedCache([on_device(k, d) for k, d in zip(keys, devices)],
                            [on_device(v, d) for v, d in zip(values, devices)],
                            [on_device(m, d) for m, d in zip(mask, devices)],
                            cache.keys.device)
