"""attention_based_e2e_asr_dnn_tpu_torch — the PyTorch/CUDA port of tpu-las.

The JAX package ``attention_based_e2e_asr_dnn_tpu`` is the reference; this
package keeps its module names so each counterpart is easy to find, imports
``torch`` and never ``jax``, and replaces every Pallas kernel on its path with
a kernel written by hand for Hopper (``csrc/``).

Ported so far: greedy serving of a trained LAS experiment, and the batch
``infer`` CLI with the eval decode on the fused speller-decode kernel.

  ops/masking      length and pad masks
  ops/precision    compute-dtype policy (config name -> torch dtype)
  ops/lstm         plain LSTM directions and the listener's stacks
  ops/cuda_build   nvcc build of a ``csrc/`` source at first use
  ops/lstm_cuda    the LSTM-recurrence CUDA kernels, their plain versions
  ops/attention    cross-attention precompute and decode step
  ops/speller_cuda the fused eval speller-decode CUDA kernel, its plain
                   version, and the eval ``speller_apply_fused``
  models/las       configs, the ListenAttendSpell parameter module, the
                   weight bridge to the JAX params tree, listener/speller
                   (routed on ``decoder_impl``), the eval ``las_apply``
  decoding/greedy  early-exit greedy decode
  data/batching    length-bucketed batches (numpy)
  data/datasets    the reference-layout and toy ASR datasets (numpy)
  training/loss    masked token-mean cross-entropy
  training/steps   the eval and inference steps
  training/checkpoints  the ``.ckpt`` npz format, reader and writer
  serving          Transcriber / StreamingTranscriber
  infer            the batch inference CLI

Reused by import from the reference package (all free of JAX):
``constants``, ``compat``, ``config`` (needs ``yaml``) and
``utils.levenshtein``.
"""

__version__ = "0.1.0"

from attention_based_e2e_asr_dnn_tpu.constants import (  # noqa: F401
    EOS_IDX,
    SOS_IDX,
    VOCAB,
    VOCAB_MAP,
)
