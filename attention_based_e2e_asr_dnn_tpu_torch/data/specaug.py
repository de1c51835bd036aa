"""SpecAugment on the device (counterpart of the JAX ``data/specaug.py``).

One frequency mask and one time mask on a padded (B, T, F) batch, torchaudio
semantics as the JAX package replicates them: width ~ Uniform[0, param),
start ~ Uniform[0, 1) * (size - width), masked value 0.0, positions compared
as floats (``pos >= start and pos < start + width``), one mask shared by the
batch unless ``iid``. The widths and unit starts are either drawn from an
explicit ``torch.Generator`` (``draw_specaug``) or handed in, so a test can
replay another framework's draw.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SpecAugDraws(NamedTuple):
    """Per axis: the width in [0, param) and the start as a unit fraction in
    [0, 1), each of shape (B,) with ``iid`` or (1,)."""

    freq_width: torch.Tensor
    freq_start: torch.Tensor
    time_width: torch.Tensor
    time_start: torch.Tensor


def draw_specaug(batch: int, freq_mask_param: int, time_mask_param: int, iid: bool,
                 generator: Optional[torch.Generator], device) -> SpecAugDraws:
    shape = (batch,) if iid else (1,)

    def unit():
        return torch.rand(shape, generator=generator, device=device)

    return SpecAugDraws(unit() * float(freq_mask_param), unit(),
                        unit() * float(time_mask_param), unit())


def _keep_mask(size: int, width: torch.Tensor, unit_start: torch.Tensor) -> torch.Tensor:
    """(B or 1, size) keep mask (True = keep)."""
    start = unit_start * (size - width)
    pos = torch.arange(size, dtype=torch.float32, device=width.device)[None, :]
    return ~((pos >= start[:, None]) & (pos < (start + width)[:, None]))


def specaugment(x: torch.Tensor, draws: SpecAugDraws) -> torch.Tensor:
    """Apply one frequency + one time mask to (B, T, F) features."""
    _, seq_len, n_feats = x.shape
    keep_f = _keep_mask(n_feats, draws.freq_width.float(), draws.freq_start.float())
    keep_t = _keep_mask(seq_len, draws.time_width.float(), draws.time_start.float())
    x = x * keep_f[:, None, :].to(x.dtype)
    return x * keep_t[:, :, None].to(x.dtype)
