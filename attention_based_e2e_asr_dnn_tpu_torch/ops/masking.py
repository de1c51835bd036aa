"""Length-mask utilities (counterpart of the JAX ``ops/masking.py``).

Static-shape padded batches carry per-example lengths; masks come from them.
"""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, max_len: int,
                dtype: torch.dtype = torch.bool) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) mask, True where t < length."""
    t = torch.arange(max_len, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)


def pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) mask, True where PADDED (t >= length)."""
    t = torch.arange(max_len, device=lengths.device)
    return t[None, :] >= lengths[:, None]
