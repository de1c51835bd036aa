"""Data-parallel decoding: a batch split into row blocks over devices
(counterpart of the JAX ``Transcriber(data_parallel=n)`` and the
``data_parallel`` artifacts of ``export.py``).

The JAX package replicates the parameters over an n-device mesh and lets
GSPMD partition the decode over the batch: each utterance decodes alone, so
no collective is needed. Here the parameters are copied to each device once,
a batch of B rows is cut into n blocks of B/n, each block is decoded on its
device on a stream of its own (one host thread a block), and the blocks'
ids are put back in order.

``dp_devices`` picks the devices (the first n cards); ``RowSplit`` takes any
list, so that a test can hold the split over ``[cpu, cpu]`` and the card's
smoke test over ``[cuda:0, cuda:0]``.
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence

import numpy as np
import torch


def check_divisible(batch_size: int, n: int) -> None:
    """The JAX ``Transcriber``'s refusal of a batch that n blocks cannot split."""
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} not divisible by data_parallel {n}")


def dp_devices(device, n: int) -> List[torch.device]:
    """The devices of an n-way split on ``device``'s kind: the first n cards
    (the CPU counts as one device). Fewer raise the JAX message."""
    dev = torch.device(device)
    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    if visible < n:
        raise ValueError(f"data_parallel={n} but only {visible} devices visible")
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def _placed(device: torch.device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def replicate(params: torch.nn.Module, devices: Sequence) -> List[torch.nn.Module]:
    """``params`` on each of ``devices``: ``params`` itself where it already
    sits there, else one copy of its own a distinct device. ``params`` is
    never moved (``Module.to`` moves a module in place and returns it)."""
    home = next(iter(params.parameters())).device
    copies: dict = {}
    out = []
    for d in devices:
        d = _placed(torch.device(d))
        if d not in copies:
            copies[d] = params if d == home else copy.deepcopy(params).to(d)
        out.append(copies[d])
    return out


class RowSplit:
    """``split(x, lx) -> ids``: ``step(params, x, lx)`` on each of
    ``len(devices)`` row blocks of the host batch, block i on ``devices[i]``
    with the parameters there (``replicate``), the ids (host arrays)
    concatenated in row order."""

    def __init__(self, step: Callable, params: torch.nn.Module, devices: Sequence):
        self.step = step
        self.devices = [torch.device(d) for d in devices]
        self.params = replicate(params, self.devices)
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]
        self._pool = ThreadPoolExecutor(len(self.devices))

    def _block(self, i: int, x: np.ndarray, lx: np.ndarray) -> np.ndarray:
        dev, stream = self.devices[i], self.streams[i]
        scope = contextlib.ExitStack()
        if stream is not None:  # this thread launches on block i's card and stream
            scope.enter_context(torch.cuda.device(dev))
            scope.enter_context(torch.cuda.stream(stream))
        with scope:
            ids = self.step(self.params[i], torch.from_numpy(x).to(dev),
                            torch.from_numpy(lx).to(dev))
            return ids.cpu().numpy() if torch.is_tensor(ids) else np.asarray(ids)

    def __call__(self, x: np.ndarray, lx: np.ndarray) -> np.ndarray:
        n = len(self.devices)
        check_divisible(x.shape[0], n)
        per = x.shape[0] // n
        blocks = [self._pool.submit(self._block, i, np.ascontiguousarray(x[i * per:(i + 1) * per]),
                                    np.ascontiguousarray(lx[i * per:(i + 1) * per]))
                  for i in range(n)]
        return np.concatenate([b.result() for b in blocks], axis=0)
