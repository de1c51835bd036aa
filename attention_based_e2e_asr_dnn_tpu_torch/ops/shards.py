"""Column-sharded weights and the operations on them (tensor parallelism
over a grid of devices, ``parallel/mesh.py``).

A ``ColumnShards`` is a 2-D weight (in, out) held as M contiguous column
blocks, the JAX ``P(None, 'model')`` layout, block j on its own device. The
ops that take one use only what is here: the column-parallel product ``x @
W``, the embedding lookup ``W[ids]`` and, through ``W.T`` (a ``RowShards``),
the tied classifier's partial products summed on x's device. Every operation
is ``.to``, products and ``torch.cat``, so autograd differentiates through
it. The plain loops take such a weight; a kernel's wrapper refuses it
(``refuse_sharded``).
"""

from __future__ import annotations

from typing import Sequence

import torch


def on_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device`` (itself where it is there already)."""
    return t if t.device == device else t.to(device)


def any_sharded(tree) -> bool:
    """Whether a weight, or any leaf of a dict / list tree of them, is
    column-sharded."""
    if isinstance(tree, dict):
        return any(any_sharded(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(any_sharded(v) for v in tree)
    return isinstance(tree, ColumnShards)


def refuse_sharded(tree, impl: str) -> None:
    """A kernel cannot take a column-sharded weight: raise the JAX CLIs'
    tensor-parallel ``ValueError`` where ``tree`` holds one."""
    if any_sharded(tree):
        raise ValueError(
            f"a column-sharded weight (tensor parallelism) requires the scan "
            f"implementations, but {impl} is 'pallas'. TP shards the LSTM gate "
            "matrices, which a fused kernel cannot consume sharded.")


class ColumnShards:
    """A 2-D weight (in, out) held as M contiguous column blocks (the JAX
    ``P(None, 'model')``), block j on its own device; products gather on
    ``gather``. Differentiable: every operation is ``.to``, products and
    ``torch.cat``."""

    def __init__(self, shards: Sequence[torch.Tensor], gather):
        self.shards = list(shards)
        self.gather = torch.device(gather)

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.shards[0].shape[0], sum(s.shape[1] for s in self.shards)))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.gather

    def to(self, dtype: torch.dtype) -> "ColumnShards":
        return ColumnShards([s.to(dtype) for s in self.shards], self.gather)

    def float(self) -> "ColumnShards":
        return self.to(torch.float32)

    @property
    def T(self) -> "RowShards":
        return RowShards(self)

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ W``: each block's product on its device, gathered and
        concatenated along the output columns."""
        return torch.cat([on_device(on_device(x, s.device) @ s, x.device)
                          for s in self.shards], dim=-1)

    def __getitem__(self, ids: torch.Tensor) -> torch.Tensor:
        """The embedding lookup ``W[ids]`` on column blocks: each block's rows
        on its device, gathered and concatenated along the columns."""
        return torch.cat([on_device(s[on_device(ids, s.device)], self.gather)
                          for s in self.shards], dim=-1)


class RowShards:
    """``W.T`` of a ``ColumnShards`` W: its rows (W's columns) in blocks. The
    product ``x @ W.T`` contracts over the sharded width: a partial product
    a block on its device, summed on x's device (the tied classifier)."""

    def __init__(self, cols: ColumnShards):
        self.cols = cols

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        out, start = None, 0
        for s in self.cols.shards:
            width = s.shape[1]
            part = on_device(on_device(x[..., start:start + width], s.device) @ s.T, x.device)
            out = part if out is None else out + part
            start += width
        return out
