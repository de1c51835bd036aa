"""Per-rank data loading helpers (counterpart of the JAX
``parallel/multihost.py``).

In the JAX package each process of a multi-host slice loads its
``process_slice`` of the global batch, and ``global_batch_from_local``
stitches the processes' slices into one globally sharded array. Here there is
one process for each rank and no global array to stitch: a rank's slice is
already all that its step reads, so ``global_batch_from_local`` and
``shard_batch_multihost`` are the identity on the local slice, placed on the
rank's device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from attention_based_e2e_asr_dnn_tpu_torch.parallel.mesh import DataMesh, row_block


def _rank_and_size() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_slice(n_examples: int, mesh: Optional[DataMesh] = None) -> slice:
    """The half-open [start, stop) range of the global batch this rank owns
    (``row_block``), of ``mesh`` or of the process group."""
    idx, n_proc = (mesh.rank, mesh.size) if mesh is not None else _rank_and_size()
    return row_block(n_examples, idx, n_proc, ("global batch", "process count"))


def global_batch_from_local(mesh: DataMesh, local) -> torch.Tensor:
    """This rank's slice of the global batch (see ``process_slice``) on its
    device: with one process for each rank the local slice is the rank's
    whole batch."""
    t = local if torch.is_tensor(local) else torch.from_numpy(np.ascontiguousarray(local))
    return t.to(mesh.device)


def shard_batch_multihost(mesh: DataMesh, batch: Sequence) -> Tuple[torch.Tensor, ...]:
    """Tuple-of-arrays variant of ``global_batch_from_local``."""
    return tuple(global_batch_from_local(mesh, a) for a in batch)
