"""Data parallelism over a ``torch.distributed`` group (counterpart of the
JAX ``parallel/``): ``mesh`` (the 1-D ``make_mesh``, ``shard_batch_fn``),
``multihost`` (``process_slice``), ``dp`` (the train and eval steps,
``spawn``). The 2-D / 3-D meshes, tensor-parallel placement, ``sequence``
and ``pipeline`` are ROADMAP queue 1, item 16."""

from attention_based_e2e_asr_dnn_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    make_mesh,
    shard_batch_fn,
)
from attention_based_e2e_asr_dnn_tpu_torch.parallel.multihost import (  # noqa: F401
    process_slice,
)
from attention_based_e2e_asr_dnn_tpu_torch.parallel.dp import (  # noqa: F401
    make_dp_eval_step,
    make_dp_train_step,
    spawn,
)
