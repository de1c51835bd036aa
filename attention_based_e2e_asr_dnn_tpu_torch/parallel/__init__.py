"""Parallelism (counterpart of the JAX ``parallel/``): ``mesh`` (the 1-D
``make_mesh`` over a ``torch.distributed`` group, the 2-D / 3-D device
grids, tensor-parallel placement, ``shard_batch_fn``), ``multihost``
(``process_slice``), ``dp`` (the data-parallel train and eval steps,
``spawn``), ``grid`` (the train and eval steps over a device grid: tensor
and sequence parallelism), ``sequence`` (time-sharded attention),
``pipeline`` (the two-stage listener | speller pipeline) and ``split`` (the
decode's row split)."""

from attention_based_e2e_asr_dnn_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    DeviceGrid,
    make_mesh,
    make_mesh_2d,
    make_mesh_3d,
    shard_batch_fn,
    shard_train_state,
)
from attention_based_e2e_asr_dnn_tpu_torch.parallel.multihost import (  # noqa: F401
    process_slice,
)
from attention_based_e2e_asr_dnn_tpu_torch.parallel.dp import (  # noqa: F401
    make_dp_eval_step,
    make_dp_train_step,
    spawn,
)
