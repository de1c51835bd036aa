"""attention_based_e2e_asr_dnn_tpu_torch — the PyTorch/CUDA port of tpu-las.

The JAX package ``attention_based_e2e_asr_dnn_tpu`` is the reference; this
package keeps its module names so each counterpart is easy to find, imports
``torch`` and never ``jax``, and replaces every Pallas kernel on its path with
a kernel written by hand for Hopper (``csrc/``).

It imports nothing of the JAX package, not even a module there that is free
of JAX: what it needs of ``constants``, ``config``, ``utils/levenshtein`` and
``compat`` it keeps as its own copies under the same names.

Ported so far: greedy serving of a trained LAS experiment, the batch
``infer`` CLI with the eval decode on the fused speller-decode kernel, the
training step with both kernel tiers (``lstm_impl: pallas``, ``decoder_impl:
pallas``) at base-LAS and scaled-LAS width (H=1024, ``remat``), and the
``train`` CLI with the Trainer, its checkpoint policy and the convergence
harness.

  constants        the output vocabulary
  config           YAML -> attribute tree with ``configs``-splat semantics
  compat           reference ``.pt`` state_dict -> params tree
  utils/levenshtein  edit distance, ``ids_to_str``
  ops/masking      length and pad masks
  ops/precision    compute-dtype policy (config name -> torch dtype)
  ops/dropout      locked and elementwise dropout, masks injectable
  ops/lstm         plain LSTM directions and the listener's stacks, with
                   ``remat`` (a layer recomputed in the backward pass)
  ops/cuda_build   nvcc build of a ``csrc/`` source at first use
  ops/lstm_cuda    the LSTM-recurrence CUDA kernels (``lstm_scan``,
                   ``lstm_scan_fusedin``, their training forms, the adjoints
                   ``lstm_bwd_dw`` up to H=512 and ``lstm_bwd`` with the
                   outside dW_hh product up to H=1024), their plain versions,
                   the autograd Functions
  ops/attention    cross-attention precompute and decode step, the
                   init_force prior
  ops/speller_cuda the fused speller-decode CUDA kernels (eval, training
                   forward, adjoint), their plain versions, ``_FusedDecode``
                   and ``speller_apply_fused``
  models/las       configs, the ListenAttendSpell parameter module, the
                   weight bridge to the JAX params tree, ``TrainDraws``,
                   listener/speller (eval and teacher-forced training),
                   ``las_apply``
  decoding/greedy  early-exit greedy decode
  data/batching    length-bucketed batches (numpy), ``ThreadedPrefetcher``
  data/datasets    the reference-layout and toy ASR datasets (numpy)
  data/specaug     SpecAugment on the device, draws injectable
  training/loss    masked token-mean cross-entropy
  training/optim   adam / adamw / sgd after optax, the schedulers
  training/steps   the train, eval and inference steps
  training/checkpoints  the ``.ckpt`` npz format, reader and writer,
                   ``CheckpointManager``
  training/trainer the epoch-loop ``Trainer`` (schedulers, dev LD, crash
                   save, resume; checkpoints either package resumes from)
  utils/logging    ``MetricLogger``, ``experiment_folder``, ``log.json``
  utils/summary    the parameter table and shape/FLOP summary the CLI prints
  utils/flops      the analytic FLOPs model
  utils/plotting   attention-map PNGs (matplotlib at the call)
  parallel/        data parallelism: the 1-D mesh over a torch.distributed
                   group, the DP train and eval steps, ``spawn``, the
                   serving split
  serving          Transcriber / StreamingTranscriber
  infer            the batch inference CLI
  train            the training CLI
  tools/           kernel timing (``time_lstm_kernels``,
                   ``time_speller_kernels``), the synthetic corpus generator
                   and the convergence harness
"""

__version__ = "0.1.0"

from attention_based_e2e_asr_dnn_tpu_torch.constants import (  # noqa: F401
    EOS_IDX,
    SOS_IDX,
    VOCAB,
    VOCAB_MAP,
)
