"""The numbers that decide ``correct``, each worked out from the program's
outputs and the plain reference's.

Training (the first three steps of the measured path):
  ``loss_gap``    the largest relative gap of a step's loss;
  ``grad_gap``    the worst leaf's gap between the norms of the first
                  step's gradient as the optimizer took it (after the clip),
                  over the larger of the reference's norm of that leaf and
                  of the median leaf;
  ``change_gap``  the same for the parameters' change over the three steps,
                  leaving out leaves whose reference gradient is under a
                  thousandth of the median leaf's (Adam moves those by
                  round-off alone: the attention key bias, under softmax);
  ``grad_leaf_gap`` the first gradient's gap over each leaf's own reference
                  norm, so that a small leaf (a bias, an attention map) is
                  judged on its own scale, leaving out the same leaves as
                  ``change_gap``. (The change is not judged on each leaf's own
                  scale: Adam's first step moves every coordinate by the
                  learning rate whatever its gradient's size, so a coordinate
                  whose gradient is near nought moves by round-off alone, and
                  a bias of a few dozen coordinates swings by a few percent.)
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

NEGLIGIBLE = 1e-3


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.detach().double().norm()) for n, t in tensors.items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], names,
               own: bool = False) -> Tuple[float, str]:
    """The largest gap of norms over the reference's norm of the leaf, or
    (``own`` false) over the larger of it and the median leaf's."""
    names = list(names)
    floor = 0.0 if own else statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_numbers(prog_losses: List[float], ref_losses: List[float],
                  prog_grad: Dict[str, float], ref_grad: Dict[str, float],
                  prog_change: Dict[str, float], ref_change: Dict[str, float]) -> Dict[str, tuple]:
    """{name: (value, what it is of)}."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    floor = statistics.median(ref_grad.values())
    moving = [n for n in ref_grad if ref_grad[n] >= NEGLIGIBLE * floor]
    grad_gap, grad_leaf = worst_leaf(prog_grad, ref_grad, ref_grad)
    change_gap, change_leaf = worst_leaf(prog_change, ref_change, moving)
    return {"loss_gap": (loss_gap, "steps 1-3"), "grad_gap": (grad_gap, grad_leaf),
            "change_gap": (change_gap, change_leaf),
            "grad_leaf_gap": worst_leaf(prog_grad, ref_grad, moving, own=True)}
