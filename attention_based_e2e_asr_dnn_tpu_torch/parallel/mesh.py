"""Device meshes (counterpart of the JAX ``parallel/mesh.py``).

**The 1-D data-parallel mesh** (``make_mesh``, ``shard_batch_fn`` of a
``DataMesh``). The JAX package is single-controller: one process holds a
``Mesh`` of every device and shards a global batch over its ``'data'`` axis.
For pure data parallelism there is one process for each rank over a
``torch.distributed`` group, and the "mesh" is that group seen from one
rank: a ``DataMesh`` record of the world size, the rank, the rank's device,
the group and its backend.

Backend rule, decided once at setup and never swapped after a failure:
NCCL where every rank owns a card of its own; gloo where ranks share a card
(two ranks on one H100) or run on the CPU. gloo on CUDA tensors does
``all_reduce``, ``broadcast`` and ``barrier`` but not ``all_gather``, so the
package gathers only through ``all_gather_object`` (``parallel/dp.py``).

``make_mesh`` joins the group a rank already has (one that
``parallel/dp.py::spawn`` set up, or one the caller made), sets one up from
``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, or, asked for one
rank outside both, makes a one-rank group on a loopback port.

**The 2-D and 3-D grids** (``make_mesh_2d``, ``make_mesh_3d``: tensor and
sequence parallelism, and the pipeline's stage groups). These are one
controller over a grid of ``torch.device``s, as the JAX meshes are: a
``DeviceGrid`` is a numpy array of devices with the JAX axis names,
``("data", "model")`` or ``("data", "seq", "model")``, the model axis
innermost. ``Tensor.to(device)`` is the collective and autograd
differentiates through it, so no backward of a collective is written by
hand. A grid may list one device many times (``["cpu"] * 4`` in the tests,
``[cuda:0] * 4`` in the card's smoke test); real cards run through the same
code.

Tensor parallelism (``model_parallel_placement``, ``shard_train_state``)
follows the JAX ``P(None, 'model')`` layout: ``w_ih`` / ``w_hh``, the
attention maps' ``w`` and ``char_emb`` are held as M contiguous column
blocks (``ops/shards.py::ColumnShards``), block j on the model axis's device j, where
``shape[1] % M == 0``; everything else is replicated. The master copy of a
parameter lives on row 0 of the data axis (a replicated one on the grid's
first device); each data row uses its own copies, moved there with ``.to``,
so the gradients of every row add up on the master. The operations on a
sharded weight (``ColumnShards``): the column-parallel product (a shard's
product on its device, then moved to the row's gather device and
concatenated), the embedding lookup on column shards, and the tied
classifier over column-sharded ``char_emb`` (a partial product a shard,
then summed: the ``psum`` XLA inserts). The plain LSTM loops, ``linear_apply``
and the speller's step take such a weight through these operations; an
unsharded one is untouched.
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from attention_based_e2e_asr_dnn_tpu_torch.ops.shards import ColumnShards, on_device

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


def shard_batch_fn(mesh):
    """Of a ``DataMesh``: ``f(tuple of host arrays) -> tuple of this rank's
    rows on its device``, each array's rows ``shard_rows``, so that a rank's
    shard is exactly the JAX shard, its T and L padding the global batch's.
    Of a ``DeviceGrid``: ``f(tuple of arrays) -> the same tensors on the
    grid's first device``, where a train or eval step over the grid takes
    each data row's block; a batch the data rows cannot split raises the
    JAX message."""
    if isinstance(mesh, DeviceGrid):
        return _grid_batch_fn(mesh)

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


# ---------------------------------------------------------------------------
# The 2-D and 3-D grids of one controller
# ---------------------------------------------------------------------------

@dataclass
class DeviceGrid:
    """Devices in a numpy object array whose axes carry the JAX mesh's
    names; ``"data"`` is the outermost axis, ``"model"`` (where present)
    the innermost."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, name: str) -> int:
        """The size of axis ``name``; 1 where the grid has no such axis."""
        return self.shape.get(name, 1)

    def _row(self, row: int) -> np.ndarray:
        return self.devices[row] if self.axis_names[0] == "data" else self.devices

    def gather_device(self, row: int = 0) -> torch.device:
        """Where data row ``row`` gathers products and runs what is not
        split: the first device of its block."""
        return self._row(row).reshape(-1)[0]

    def model_devices(self, row: int = 0) -> List[torch.device]:
        """The devices of the model axis in data row ``row`` (its first
        sequence position)."""
        block = self._row(row)
        names = [n for n in self.axis_names if n != "data"]
        if "model" not in names:
            return [block.reshape(-1)[0]]
        if names == ["seq", "model"]:
            block = block[0]
        return list(block.reshape(-1))

    def seq_devices(self, row: int = 0) -> List[torch.device]:
        """The devices of the sequence axis in data row ``row`` (its first
        model position)."""
        block = self._row(row)
        names = [n for n in self.axis_names if n != "data"]
        if "seq" not in names:
            return [block.reshape(-1)[0]]
        if names == ["seq", "model"]:
            block = block[:, 0]
        return list(block.reshape(-1))


def visible_devices() -> List[torch.device]:
    """Every visible card (none without CUDA)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def _grid(devices, shape: Tuple[int, ...], axis_names) -> DeviceGrid:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return DeviceGrid(arr.reshape(shape), tuple(axis_names))


def make_mesh_2d(data: Optional[int] = None, model: int = 1,
                 axis_names: Tuple[str, str] = ("data", "model"),
                 devices: Optional[Sequence] = None) -> DeviceGrid:
    """2-D ``(data, model)`` grid over ``devices`` (default: every visible
    card): batch rows on 'data', the column blocks of tensor parallelism on
    'model', laid innermost. ``data=None`` uses the devices divided by
    ``model``. The JAX ``make_mesh_2d``'s refusals and messages."""
    devices = visible_devices() if devices is None else list(devices)
    if model < 1:
        raise ValueError(f"model parallelism must be >= 1, got {model}")
    if data is None:
        if len(devices) % model != 0:
            raise ValueError(f"{len(devices)} devices not divisible by model={model}")
        data = len(devices) // model
    need = data * model
    if need > len(devices):
        raise ValueError(f"requested data={data} x model={model} = {need} devices but only "
                         f"{len(devices)} present")
    return _grid(devices[:need], (data, model), axis_names)


def make_mesh_3d(data: Optional[int] = None, seq: int = 1, model: int = 1,
                 axis_names: Tuple[str, str, str] = ("data", "seq", "model"),
                 devices: Optional[Sequence] = None) -> DeviceGrid:
    """3-D ``(data, seq, model)`` grid: batch rows on 'data', the attention's
    time axis on 'seq', tensor parallelism on 'model' (innermost, seq next,
    data outermost). ``data=None`` uses the devices divided by
    ``seq * model``. The JAX ``make_mesh_3d``'s refusals and messages."""
    devices = visible_devices() if devices is None else list(devices)
    if seq < 1 or model < 1:
        raise ValueError(f"seq/model degrees must be >= 1, got {seq}/{model}")
    inner = seq * model
    if data is None:
        if len(devices) % inner != 0:
            raise ValueError(f"{len(devices)} devices not divisible by seq*model={inner}")
        data = len(devices) // inner
    need = data * inner
    if need > len(devices):
        raise ValueError(f"requested data={data} x seq={seq} x model={model} = {need} "
                         f"devices but only {len(devices)} present")
    return _grid(devices[:need], (data, seq, model), axis_names)


def _grid_batch_fn(grid: DeviceGrid):
    data_par = grid.axis_size("data")
    home = grid.gather_device(0)

    def shard(batch: Sequence) -> Tuple[torch.Tensor, ...]:
        out = []
        for arr in batch:
            if arr.shape[0] % data_par != 0:
                raise ValueError(f"batch dim {arr.shape[0]} not divisible by data-parallel "
                                 f"degree {data_par}")
            t = arr if torch.is_tensor(arr) else torch.from_numpy(np.ascontiguousarray(arr))
            out.append(t.to(home))
        return tuple(out)

    shard.grid = grid  # the Trainer's steps run over it
    return shard


_ATT_MAPS = ("key_map", "value_map", "query_map")


def model_parallel_placement(grid: DeviceGrid, model_axis: Optional[str] = "model"):
    """``shards(name, shape) -> bool``: whether tensor parallelism over
    ``model_axis`` holds the parameter (or optimizer moment) named ``name``
    (a dotted path of the JAX params tree, e.g.
    ``listener.base.0.fwd.w_ih``) column-sharded. The JAX rule: a 2-D leaf
    whose columns the axis divides, under a ``w_ih`` / ``w_hh`` key, a
    ``w`` under ``key_map`` / ``value_map`` / ``query_map``, or
    ``char_emb``; everything else replicated. A model axis of 1 (or None)
    shards nothing."""
    model_par = 1 if model_axis is None else grid.axis_size(model_axis)

    def shards(name: str, shape) -> bool:
        if model_par <= 1 or len(shape) != 2 or shape[1] % model_par:
            return False
        keys = name.split(".")
        if "w_ih" in keys or "w_hh" in keys:
            return True
        if any(m in keys for m in _ATT_MAPS) and "w" in keys:
            return True
        return "char_emb" in keys

    return shards


class GridParams:
    """A parameter tree placed on a ``DeviceGrid`` for tensor parallelism:
    the master of each parameter, a leaf tensor that the optimizer steps in
    place, on the grid's first device or, where
    ``model_parallel_placement`` shards it, as M column blocks on row 0's
    model devices. ``view(row)`` is the tree as data row ``row`` computes
    with it (nested dicts and lists, indexed like the module)."""

    def __init__(self, module: torch.nn.Module, grid: DeviceGrid,
                 model_axis: Optional[str] = "model"):
        shards = model_parallel_placement(grid, model_axis)
        self.grid = grid
        self.module_type = type(module)
        self.names: List[str] = []
        self.leaves: Dict[str, object] = {}
        home = grid.gather_device(0)
        model_devs = grid.model_devices(0)
        for name, p in module.named_parameters():
            self.names.append(name)
            data = p.detach()
            if shards(name, tuple(p.shape)):
                blocks = torch.chunk(data, len(model_devs), dim=1)
                self.leaves[name] = [torch.nn.Parameter(b.to(d).clone())
                                     for b, d in zip(blocks, model_devs)]
            else:
                self.leaves[name] = torch.nn.Parameter(data.to(home).clone())

    def sharded_names(self) -> List[str]:
        return [n for n in self.names if isinstance(self.leaves[n], list)]

    def tensors(self) -> List[torch.Tensor]:
        """The masters in a fixed order (a sharded parameter's blocks in
        column order): the list the optimizer state follows."""
        out = []
        for n in self.names:
            leaf = self.leaves[n]
            out.extend(leaf if isinstance(leaf, list) else [leaf])
        return out

    def view(self, row: int = 0):
        """The tree for data row ``row``: a replicated leaf moved to the
        row's gather device, a sharded one a ``ColumnShards`` of its blocks
        moved to the row's model devices (no copy on row 0)."""
        from attention_based_e2e_asr_dnn_tpu_torch.training.optim import _nest

        gather = self.grid.gather_device(row)
        model_devs = self.grid.model_devices(row)
        flat = {}
        for n in self.names:
            leaf = self.leaves[n]
            if isinstance(leaf, list):
                flat[n] = ColumnShards([on_device(b, d) for b, d in zip(leaf, model_devs)], gather)
            else:
                flat[n] = on_device(leaf, gather)
        return _nest(flat)

    def gather_list(self, flat: Sequence[torch.Tensor], device) -> List[torch.Tensor]:
        """A list that follows ``tensors()`` (the masters, or an optimizer
        moment of them) -> one whole tensor a parameter, on ``device``."""
        device = torch.device(device)
        it = iter(flat)
        out = []
        for n in self.names:
            leaf = self.leaves[n]
            if isinstance(leaf, list):
                out.append(torch.cat([on_device(next(it).detach(), device) for _ in leaf], dim=1))
            else:
                out.append(on_device(next(it).detach(), device))
        return out

    def scatter_list(self, whole: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The inverse of ``gather_list``: one tensor a parameter -> copies
        laid out as ``tensors()``, each on its master's device."""
        out = []
        for n, t in zip(self.names, whole):
            leaf = self.leaves[n]
            if isinstance(leaf, list):
                blocks = torch.chunk(t.detach(), len(leaf), dim=1)
                out.extend(b.to(m.device).clone() for b, m in zip(blocks, leaf))
            else:
                out.append(t.detach().to(leaf.device).clone())
        return out

    def whole_tree(self, device=None):
        """The tree in one piece on ``device`` (default: the grid's first
        device), as nested dicts and lists of detached tensors."""
        from attention_based_e2e_asr_dnn_tpu_torch.training.optim import _nest

        device = self.grid.gather_device(0) if device is None else torch.device(device)
        return _nest(dict(zip(self.names, self.gather_list(self.tensors(), device))))

    def whole_module(self, device=None) -> torch.nn.Module:
        """``whole_tree`` as the module type it was placed from: what a
        checkpoint stores and an eval pass of one device reads."""
        return self.module_type(self.whole_tree(device))

    def per_device_bytes(self) -> int:
        """The parameter bytes one device of the grid holds: every
        replicated leaf whole and one block of each sharded leaf."""
        total = 0
        for n in self.names:
            leaf = self.leaves[n]
            if isinstance(leaf, list):
                total += max(b.numel() * b.element_size() for b in leaf)
            else:
                total += leaf.numel() * leaf.element_size()
        return total


def scatter_opt_state(params: GridParams, opt):
    """A whole optimizer state (one tensor a parameter) laid out as
    ``params.tensors()``, each moment on its parameter's device, the counts
    on the grid's first device."""
    from attention_based_e2e_asr_dnn_tpu_torch.training.optim import OptState

    home = params.grid.gather_device(0)

    def lay(field):
        return None if field is None else params.scatter_list(field)

    return OptState(opt.count.to(home), lay(opt.mu), lay(opt.nu), lay(opt.nu_max),
                    None if opt.mini_step is None else opt.mini_step.to(home),
                    lay(opt.acc_grads))


def gather_opt_state(params: GridParams, opt, device):
    """The inverse of ``scatter_opt_state``: every moment whole on
    ``device``."""
    from attention_based_e2e_asr_dnn_tpu_torch.training.optim import OptState

    device = torch.device(device)

    def whole(field):
        return None if field is None else params.gather_list(field, device)

    return OptState(opt.count.to(device), whole(opt.mu), whole(opt.nu), whole(opt.nu_max),
                    None if opt.mini_step is None else opt.mini_step.to(device),
                    whole(opt.acc_grads))


def shard_train_state(state, grid: DeviceGrid, model_axis: Optional[str] = "model"):
    """A one-device ``TrainState`` placed on ``grid``: its parameters as
    ``GridParams`` (the gate matrices, the attention maps and ``char_emb``
    column-sharded on ``model_axis``, the rest replicated) and its optimizer
    state's per-parameter moments laid out the same way, each on its
    parameter's device; the step count on the grid's first device, the
    generator kept."""
    from attention_based_e2e_asr_dnn_tpu_torch.training.steps import TrainState

    params = GridParams(state.params, grid, model_axis)
    return TrainState(params, scatter_opt_state(params, state.opt_state), state.generator,
                      state.step)


def unshard_train_state(state, device=None):
    """The inverse of ``shard_train_state``: a ``TrainState`` of one device
    (default: the grid's first) whose parameters are the whole tree, its
    moments whole too; what a checkpoint stores."""
    from attention_based_e2e_asr_dnn_tpu_torch.training.steps import TrainState

    params: GridParams = state.params
    device = params.grid.gather_device(0) if device is None else torch.device(device)
    return TrainState(params.whole_module(device),
                      gather_opt_state(params, state.opt_state, device), state.generator,
                      state.step)


def replicate_params(params: torch.nn.Module, grid: DeviceGrid) -> List[torch.nn.Module]:
    """The parameter module on each data row's gather device of ``grid``
    (the module itself where it already sits there; one copy a distinct
    device): a decode of one controller over the grid's rows."""
    from attention_based_e2e_asr_dnn_tpu_torch.parallel.split import replicate

    return replicate(params, [grid.gather_device(r) for r in range(grid.axis_size("data"))])
