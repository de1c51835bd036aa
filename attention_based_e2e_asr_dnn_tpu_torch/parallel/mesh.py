"""The 1-D data-parallel mesh (counterpart of the JAX ``parallel/mesh.py``'s
``make_mesh`` and ``shard_batch_fn``).

The JAX package is single-controller: one process holds a ``Mesh`` of every
device and shards a global batch over its ``'data'`` axis. Here there is one
process for each rank over a ``torch.distributed`` process group, and the
"mesh" is that group seen from one rank: a ``DataMesh`` record of the world
size, the rank, the rank's device, the group and its backend.

Backend rule, decided once at setup and never swapped after a failure:
NCCL where every rank owns a card of its own; gloo where ranks share a card
(two ranks on one H100) or run on the CPU. gloo on CUDA tensors does
``all_reduce``, ``broadcast`` and ``barrier`` but not ``all_gather``, so the
package gathers only through ``all_gather_object`` (``parallel/dp.py``).

``make_mesh`` joins the group a rank already has (one that
``parallel/dp.py::spawn`` set up, or one the caller made), sets one up from
``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, or, asked for one
rank outside both, makes a one-rank group on a loopback port.

Not ported here: the 2-D / 3-D meshes, the tensor-parallel placement and
``shard_train_state`` (ROADMAP queue 1, item 16).
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
_RANK_MESH = None  # this process's rank, once ``init_rank`` has joined a group


@dataclass
class DataMesh:
    """One rank's view of the data-parallel group."""

    size: int
    rank: int
    device: torch.device
    backend: str
    group: Optional[object] = None  # None: the default (world) group


def choose_backend(devices: Sequence) -> str:
    """NCCL where every rank has a card of its own, gloo otherwise (ranks on
    the CPU, or ranks that share a card)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs):
        idx = [torch.cuda.current_device() if d.index is None else d.index
               for d in devs]
        if len(set(idx)) == len(idx):
            return "nccl"
    return "gloo"


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_device_count(n: int, devices: Optional[Sequence] = None) -> None:
    """The JAX ``make_mesh``'s refusal of more ranks than cards; an explicit
    device list (ranks that share a card, or CPU ranks) is taken as given."""
    if devices is not None:
        if len(devices) != n:
            raise ValueError(f"{n} ranks but {len(devices)} devices given")
        return
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise ValueError(f"requested {n} devices but only {have} present")


def init_rank(rank: int, world_size: int, device, init_method: str, backend: str,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> DataMesh:
    """Join (as ``rank``, on ``device``) the group of ``world_size`` ranks at
    ``init_method``; ``timeout_s`` bounds every collective, so that a rank
    stuck in one fails the run instead of hanging it."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: device {device} but no CUDA device here")
        torch.cuda.set_device(device)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    global _RANK_MESH
    _RANK_MESH = DataMesh(world_size, rank, device, backend)
    return _RANK_MESH


def make_mesh(n_devices: Optional[int] = None, device=None) -> DataMesh:
    """The 1-D data-parallel mesh of this rank.

    In a process group already set up (by ``parallel/dp.py::spawn``): that
    group, which must have ``n_devices`` ranks where a count is asked for.
    Under ``torchrun``: the group of its environment, the rank on
    ``cuda:LOCAL_RANK`` (``device`` where given, e.g. ``cpu``). Outside
    both: one rank only (``n_devices`` None or 1), in a group of its own on a
    loopback port, on ``device`` (default ``cuda``). More ranks than cards
    raises, as the JAX ``requested N devices but only M present``."""
    if dist.is_initialized():
        size = dist.get_world_size()
        if n_devices is not None and int(n_devices) != size:
            raise ValueError(f"requested {n_devices} devices but the process group "
                             f"has {size} ranks")
        if _RANK_MESH is not None and device is None:
            return _RANK_MESH
        backend = dist.get_backend()
        if device is None:  # a group the caller made: NCCL ranks sit on their card
            device = ("cpu" if backend != "nccl"
                      else torch.device("cuda", torch.cuda.current_device()))
        return DataMesh(size, dist.get_rank(), torch.device(device), backend)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if n_devices is not None and int(n_devices) != world:
            raise ValueError(f"requested {n_devices} devices but torchrun started "
                             f"{world} ranks")
        rank = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        if device is None or torch.device(device).type == "cuda":
            check_device_count(int(os.environ.get("LOCAL_WORLD_SIZE", world)))
            device = torch.device("cuda", local)
            backend = "nccl"
        else:
            device = torch.device(device)
            backend = "gloo"
        return init_rank(rank, world, device, "env://", backend)
    n = 1 if n_devices is None else int(n_devices)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        check_device_count(n)
    if n != 1:
        raise ValueError(
            f"make_mesh({n}) outside a process group: start the ranks with "
            f"parallel.dp.spawn or torchrun --nproc-per-node {n}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return init_rank(0, 1, device, f"tcp://127.0.0.1:{free_port()}", choose_backend([device]))


def row_block(n_rows: int, rank: int, size: int,
              names: Tuple[str, str] = ("batch dim", "data-parallel degree")) -> slice:
    """Rows ``[rank * B/size, (rank + 1) * B/size)`` of a global batch of
    ``n_rows``: the JAX shard order. A batch that ``size`` does not divide
    raises ``"<names[0]> B not divisible by <names[1]> size"``, the JAX
    message."""
    if n_rows % size:
        raise ValueError(f"{names[0]} {n_rows} not divisible by {names[1]} {size}")
    per = n_rows // size
    return slice(rank * per, (rank + 1) * per)


def shard_rows(n_rows: int, mesh: DataMesh) -> slice:
    """``row_block`` of ``mesh``'s rank."""
    return row_block(n_rows, mesh.rank, mesh.size)


def shard_batch_fn(mesh: DataMesh):
    """``f(tuple of host arrays) -> tuple of this rank's rows on its device``:
    each array's rows ``shard_rows``, so that a rank's shard is exactly the JAX
    shard, its T and L padding the global batch's."""

    def shard(batch: Sequence) -> Tuple[torch.Tensor, ...]:
        out = []
        for arr in batch:
            rows = shard_rows(arr.shape[0], mesh)
            t = arr if torch.is_tensor(arr) else torch.from_numpy(np.ascontiguousarray(arr))
            out.append(t[rows].to(mesh.device))
        return tuple(out)

    return shard


def close_mesh() -> None:
    """Leave the process group this process joined (a no-op outside one)."""
    global _RANK_MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK_MESH = None
