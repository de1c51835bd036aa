"""attention_based_e2e_asr_dnn_tpu_torch — the PyTorch/CUDA port of tpu-las.

The JAX package ``attention_based_e2e_asr_dnn_tpu`` is the reference; this
package keeps its module names so each counterpart is easy to find, imports
``torch`` and never ``jax``, and replaces every Pallas kernel on its path with
a kernel written by hand for Hopper (``csrc/``).

Ported so far: greedy serving of a trained LAS experiment.

  ops/masking      length and pad masks
  ops/precision    compute-dtype policy (config name -> torch dtype)
  ops/lstm         plain LSTM directions and the listener's stacks
  ops/lstm_cuda    the LSTM-recurrence CUDA kernels, their plain versions
  ops/attention    cross-attention precompute and decode step
  models/las       configs, the ListenAttendSpell parameter module, the
                   weight bridge to the JAX params tree, listener/speller
  decoding/greedy  early-exit greedy decode
  training/checkpoints  the ``.ckpt`` npz format, reader and writer
  serving          Transcriber / StreamingTranscriber

Reused by import from the reference package (all free of JAX):
``constants``, ``compat`` and ``utils.levenshtein``.
"""

__version__ = "0.1.0"

from attention_based_e2e_asr_dnn_tpu.constants import (  # noqa: F401
    EOS_IDX,
    SOS_IDX,
    VOCAB,
    VOCAB_MAP,
)
