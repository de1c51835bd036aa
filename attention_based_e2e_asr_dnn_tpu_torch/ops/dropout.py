"""Dropout variants used by the recurrent stacks (counterpart of the JAX
``ops/dropout.py``).

``locked_dropout``: variational dropout, one Bernoulli mask per (batch, 1,
feature) shared across time. ``dropout``: elementwise. A mask handed in by
the caller (0/1 or bool, True = keep) is used as it is, so a test can replay
another framework's draw; otherwise the mask is drawn from the explicit
``torch.Generator``. Either way the kept values are scaled by 1 / keep in the
order the JAX functions use: ``x * mask / keep``.
"""

from __future__ import annotations

from typing import Optional

import torch


def draw_keep_mask(shape, rate: float, generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
    """A Bernoulli(1 - rate) keep mask (bool) of ``shape`` on ``device``."""
    return torch.rand(shape, generator=generator, device=device) < (1.0 - rate)


def locked_dropout(x: torch.Tensor, rate: float,
                   mask: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Variational dropout over (B, T, D): the mask (B, 1, D) is shared
    across the time axis. ``rate <= 0`` returns x."""
    if rate <= 0.0:
        return x
    if mask is None:
        mask = draw_keep_mask((x.shape[0], 1, x.shape[-1]), rate, generator, x.device)
    return x * mask.to(x.dtype) / (1.0 - rate)


def dropout(x: torch.Tensor, rate: float, mask: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Elementwise dropout; the mask has x's shape. ``rate <= 0`` returns x."""
    if rate <= 0.0:
        return x
    if mask is None:
        mask = draw_keep_mask(x.shape, rate, generator, x.device)
    return x * mask.to(x.dtype) / (1.0 - rate)
