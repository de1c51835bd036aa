#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (attention_based_e2e_asr_dnn_tpu_torch) once
on one NVIDIA card, from the root of a checkout:

    python3 chip_smoke.py

1. The card's name and power limit, the torch / CUDA / nvcc versions, and
   the time to build the kernels from ``csrc/`` (one ``nvcc`` per source,
   all started together).
2. Each LSTM kernel against its plain PyTorch version on the same CUDA
   tensors at the shapes the infer CLI gives it (B=64; H=512; listener layer
   0 at T=1536 with D=15, pyramid layer 1 at T=768 over a 2 x 4H
   projection), both directions in one launch, lengths mixed from 1 to T,
   float32 (the CUDA-core kernels, one launch of all rows) and
   bfloat16 (the tensor-core kernels, one launch of all rows): max-abs error
   against a stated tolerance and the median time of each (CUDA events).
   Every forward launch count below is the plan's
   (``lstm_cuda.plan_launches``), asserted: in bfloat16 one launch per 128
   rows with both directions at H=512 and H=1024; in float32 one launch of
   every row and both directions up to H=512, one a direction at H=1024.
3. ``speller_decode`` on the operands the eval decode builds from seeded
   full-width parameters: base-LAS at B=64 and scaled-LAS (H1 1024, 4
   heads) at B=32, Te=192 with lengths mixed from 1 to Te, 600 steps,
   float32 (``csrc/speller_decode.cu``) and bfloat16 (the tensor-core source
   ``csrc/speller_decode_tc.cu``, one launch a call up to 128 rows,
   asserted). The plain version forced along the kernel's own fed-back ids
   must agree at every step within the stated tolerance; the plain version
   run free must pick the same ids wherever the top two logits are further
   apart than the tolerance (float32). Median kernel time, the plain time
   and each case's bound.
4. A base-LAS experiment folder (config.json with the base-las model block,
   two seeded full-width random checkpoints) served on the card through
   ``Transcriber.transcribe`` and ``StreamingTranscriber.submit``, with the
   kernels' launch counters reset just before and read just after.
   Utterances/s, per-batch latency and peak device memory are printed.
5. Parity on one batch: the listener once through the kernels and once
   through the plain functions (``lstm_impl: scan``), then greedy decoding
   of both. float32: encoder outputs within tolerance and identical ids.
   bfloat16: the max error and the share of identical transcripts.
6. Kernels ``lstm_scan_train`` / ``lstm_scan_fusedin_train`` (the training
   forward) and ``lstm_bwd_dw`` (its adjoint) at the train step's shapes
   (B=128, H=512; layer 0 at T=1536 with D=15, layer 1 at T=768 over a
   2 x 4H projection), float32 and bfloat16 (the bf16 adjoint the
   tensor-core kernel, one launch of all rows and both directions; the
   float32 training forward one launch of all rows, its adjoint too: R=64
   rows x U=16 units a block, 128 blocks; the plan's counts asserted), ragged
   lengths with a length-1 row and a full row in every 32 rows: hs bit-equal
   to the lean kernels'; cs, gates, dpre, dW_hh and the fused-input
   Function's d_x, d_wih, d_b against the plain versions; ``lstm_bwd`` (the
   adjoint without dW_hh) at the same shapes, its dpre against
   ``lstm_bwd_dw``'s and against its own plain version, and the outside dW_hh
   product against the sum inside the kernel; in both dtypes the two forms'
   dpre bit-equal (asserted). Then the same at scaled-LAS's H=1024 (float32:
   the wide form, one launch a direction, ``lstm_bwd`` too, U=8 units x R=128
   rows a block; bfloat16 one): the training forward, ``lstm_bwd`` with the
   outside product (timed on its own) as the adjoint, and the lean forward
   kernels, which are a ``remat`` layer's first pass (timed at B=128 at both
   widths). At H=512 also the benchmark cell's batch, B=96 at T=1536
   (bfloat16; the adjoint's two row groups of 48 rows, each a chain of its
   own): ``lstm_bwd_dw`` and ``lstm_bwd`` against their plain versions at
   the same tolerance, twice, each row group in turn the one whose rows run
   to at most two thirds of the frames, with a length-1 and a longest row in
   each group; both forms' dpre bit-equal, the launches and the launches by
   row groups ({2: 1} a call) asserted.
7. Kernels ``speller_decode_train`` (the fused decoder's training forward)
   and ``speller_decode_bwd`` (its adjoint) at the train step's shapes: the
   base-LAS decoder at B=128 and the scaled-LAS decoder (H1 1024, 4 heads) at
   B=32, Te=192 with lengths mixed from 1 to Te, L=192, dropout 0.3, forced
   and free steps mixed, float32 and bfloat16 (the forward on
   ``csrc/speller_decode_tc.cu``, the adjoint on ``csrc/speller_bwd_tc.cu``,
   one launch a call). The forward's logits, weights
   and eight residual streams against the plain version fed the kernel's own
   ids; the adjoint's five streams and five final carries against the plain
   adjoint, with and without a cotangent on the weights; every operand's
   gradient through the autograd Function on the kernels against the same
   Function on the plain versions; the training form without dropout and
   forcing bit-equal to ``speller_decode``. The float32 adjoint
   (``csrc/speller_bwd.cu``) prints its plan (column and row groups, ring
   stages) beside its time and repeats bit for bit over two calls; then a
   small float32 case at each of two shapes the earlier float32 adjoint
   refused ((H1 640, H2 128, P 256) and scaled-LAS at Te=704, B=8): the
   training forward against its plain version, the adjoint against its own,
   and every operand's gradient through the Function. Then, in bfloat16,
   against their
   plain versions with one launch a call asserted: a decoder block past the
   narrower geometry of 2 cell-2 units a block (``dec_lstm_out_dim: 512``,
   four cell-2 units a block) on the base-LAS decoder's other widths, the eval
   form, the training form and the adjoint at B=64, 32 steps; the
   scaled-LAS decoder at phase 10's batch, B=128, L=192 (the adjoint's full
   128-row tiles with two groups of columns on half its blocks), the training
   form and the adjoint, with and without a cotangent on the weights; and a
   block whose weight tiles leave too little shared memory for four ring
   stages of 128 rows (H1 768, H2 384, P 1024), whose eval and training forms
   take B=128 in two 64-row launches (the plan's, asserted), then the adjoint
   in one; and two blocks whose resident weight tiles leave no room for four
   stages even of 64 rows (H1 1024, H2 512, P 1024, 1 and 4 heads), whose
   eval and training forms stream cell 1's weights through the ring (the
   plan's streamed form, asserted) and take B=128 in one launch, then the
   adjoint; the eval forms of the spans and of the streamed blocks timed over
   600 steps.
8. A trainer that takes a few steps: seeded base-LAS weights, one seeded
   batch (B=128, T=1536, L=192, lengths ragged within the bucket), bfloat16
   compute, SpecAugment and dropout on, tf_rate 0.9, AdamW (amsgrad, lr 1e-3,
   wd 5e-6), clip 5, NaN guard on, ``lstm_impl: pallas``. First with
   ``decoder_impl: pallas``, every kernel tier engaged: one warm-up step and 3
   timed steps (up to 10 if the loss has not fallen below the warm-up
   step's). Every step finite, the loss falls, a step launches the listener's
   training forward 4 times (a layer's whole batch and both directions in
   one launch), its adjoint 4 times (one launch a layer, in two row groups:
   the launches by row groups printed and asserted), the decoder's
   training forward once
   and its adjoint once, none of the lean or eval kernels, and calls no
   plain version; the decode route is ``cuda``. An ``init_force`` pass and
   a pass with labels outside training take the step loop and record the
   route ``scan``, as in the JAX package. Then with
   ``decoder_impl: scan`` (the decoder as a loop of PyTorch ops under
   autograd, the earlier route) for comparison, one warm-up and 2 steps.
   Seconds a step, utterances/s, peak device memory and the split listener
   forward / speller forward / backward / optimizer of each.
9. Train parity: one float32 step at full width and a short time axis (B=40,
   T=256, L=32, dropout and SpecAugment on, one shared set of draws) through
   three routes on the card: both kernel tiers, the listener kernels with the
   scan decoder, and the plain loops (``lstm_impl: scan``, ``decoder_impl:
   scan``): loss, grad_norm and every updated parameter of the first two
   against the third. The float32 adjoint's launches in the kernel routes'
   steps (here and in phase 10's) are its rows' in the JSON line, a float32
   train run being its main path.
10. scaled-LAS (the model block of ``configs/scaled-las.yml``: listener
   H=1024, ``remat: true``; speller 4 heads, hid 1024) on the same batch and
   recipe as 8, both kernel tiers: one warm-up and 3 timed steps, every one
   finite. This phase asserts finiteness and the launches, not a falling
   loss: AdamW's first updates at lr 1e-3 (+-lr on each of 144M parameters)
   throw this model's loss on one repeated batch above the untrained
   model's, and a few steps do not bring it back; that the loss falls at
   this width is held by phase 11's epochs. A step launches the
   lean forward 4 times (the first pass of the four ``remat`` layers, one
   launch each), the training forward 4 times and ``lstm_bwd`` 4 times (one
   launch a layer) in the backward pass, ``lstm_bwd_dw``
   never, and calls no plain version. Seconds a step, utterances/s, the
   split, peak device memory, and
   one step with ``remat: false`` for the memory it saves. Then the float32
   parity step of 9 at this width, the kernels against the plain loops.
11. The ``train`` CLI in-process on the card at scaled-LAS width: a seeded
   corpus from the port's generator (256 / 64 / 64 utterances),
   ``configs/scaled-las.yml`` with ``parallel.use: false`` and ``lazy_data:
   true`` as it stands (the batches come from ``LazyAsrTrainDevDataset``),
   the folders pointed at the corpus, ``batch_size`` 32 and 2 epochs: the
   train loss falls, dev loss and dev LD are finite, ``ckpts/``
   holds what ``CheckpointManager`` kept, ``log.json`` and the config snapshot
   are there, the decode route is ``cuda``, no plain version ran. Then the
   CLI again with ``finetune.use: true`` on the last checkpoint for one more
   epoch: it starts at the saved epoch with the saved lr and tf_rate, and its
   train loss is below the last saved epoch's. Then the
   ``infer`` CLI (``early_stop: false``) decodes the corpus's test split from
   the folder the Trainer wrote, every best checkpoint and their average.
12. Kernels ``lstm_scan_cs`` (#3: the lean recurrence with the carry stream
   cs) and ``bilstm_scan_fused`` (#7: both directions in one launch over
   (T, 2, B, 4H) with direction 1 flipped in time, hs the frozen carry at
   padded frames), and the op ``bilstm_apply_fused`` over #7, at a listener
   layer's full width (H=512, input 1024 wide; T=768 at B=8, 32 and 128, and
   T=1536 at B=32), float32 and bfloat16, ragged lengths with a
   length-1 and a full row in every launch. #3's hs bit-equal to
   ``lstm_scan``'s and its cs to ``lstm_scan_train``'s; #7's hs and cs against
   the plain version at every frame, pads included; the op against
   ``bilstm_apply_kernel`` (the lean kernel, both directions a launch): equal
   at valid frames, zero at pads; its gradients of ``sum(out * r)`` w.r.t. x
   and the six parameters against the same Function on the plain versions and
   against ``bilstm_apply_kernel``'s through the training forward and
   ``lstm_bwd_dw``; H=1024 raises. Times of the fused op against the two-kernel
   op, forward and forward + backward. No YAML key of either package routes to
   these kernels: their main path is the op, driven once a shape with the
   counts set to 0 just before and read just after.
13. The HTTP entry: ``AsrHttpServer`` over ``Transcriber(exp,
   auto_warmup=(512, 1536))`` on a free loopback port. ``/readyz`` is 200 after
   ``wait_ready`` (kernels built and bound, the largest bucket run); POSTs of
   the three body forms (``features``, ``instances``, ``features_b64``) give
   ``Transcriber.transcribe``'s text; the same at once are batched by the
   queue; bad bodies give 400; ``/metrics`` counts them; the lean kernels'
   launches rose.
14. The ``infer`` CLI in-process on the card over a 128-utterance test set in
   the reference layout, at ``batch_size: 64``, every best checkpoint and
   their average, twice: ``early_stop: true`` (the early-exit greedy decode)
   and ``early_stop: false`` (the fused decode kernel). The CSVs must be
   well-formed and in template order, the decode route ``cuda``, and the
   launch counts those of 64-row batches. Utterances/s, ms per batch and
   peak device memory are printed.

15. Beam search at base-LAS (bf16, the experiment of phase 4):
   ``Transcriber(beam_size=8)`` on phase 4's 40 utterances and the ``infer``
   CLI with ``beam_size: 8`` on phase 14's test set (every best checkpoint
   and their average), with the launch counters reset just before each and
   read just after (the listener's lean kernels; the beam step is plain
   PyTorch, as the JAX beam is plain XLA); utterances/s and ms per batch.
   Then on one batch: the float32 beam ids of the listener kernels equal to
   those of the plain loops (``lstm_impl: scan``), and beam 1 equal to greedy
   in float32 and bfloat16.
16. The Rewriter chain at ``configs/rewriter.yml``'s model block with both
   kernel tiers (the file sets neither): first #1 (``lstm_scan``) at the
   encoder's H=256, B=256, T=608, and #8's eval form at the decoder's widths
   (H1 256, H2 128, P 128, one head), B=256, Te=608, 600 steps, float32 and
   bfloat16, against their plain versions, timed. Then a seeded experiment
   folder (bfloat16 policy) and 256 generated prediction lines of 100-600
   characters at ``configs/lm-infer.yml``'s ``batch_size: 256``: the
   ``lminfer`` CLI in five modes (``early_stop: false``, greedy, beam 8, a
   gate with a fixed margin, ``"auto"`` with span rewrites over a generated
   64-pair calibration set), float32 as the JAX CLI decodes, each CSV
   well-formed in template order, launches read per run; the ``Corrector``
   (bfloat16, beam 8) behind a ``Transcriber`` on phase 4's utterances,
   equal to ``correct(transcribe(...))``; one ``tools/serve_http
   --corrector`` burst of six POSTs. Lines/s, ms per batch, launches.
17. The Rewriter trains: the ``lmtrain`` CLI on a generated corpus (512
   train and 64 dev pairs of 100-600 characters, gold transcripts and
   predictions with one character in 20 replaced), ``configs/rewriter.yml``
   as it stands but for its data paths and ``epochs: 3`` and with both
   kernel tiers (bfloat16, batch 64, accu_grad 2): the train loss must fall;
   a resumed epoch; ``lminfer`` (``early_stop: false``) from the folder it
   wrote. ``lstm_scan_train`` and ``lstm_bwd_dw`` (H=256), the decode's
   training form and its adjoint (H1 256, H2 128, P 128, Te and L to 608),
   and the dev pass's eval form held against their plain versions on the
   inputs the CLI gave them and timed; one float32 Rewriter step through the
   kernels against one through the plain loops. s/step, epoch seconds, peak
   memory.
18. Export: phase 4's experiment as a greedy, a beam-8 and an int8 artifact
   (one bucket of 32 rows over the serve utterances) and phase 17's Rewriter
   as a gated corrector artifact (beam 8, Te 608). ``ArtifactTranscriber``'s
   ids equal to the ``Transcriber``'s on the same padded batches, and
   ``ExportedCorrector.correct`` equal to the ``Corrector``'s chain on the
   same batches; the int8 agreement printed; a ``serve_http --artifact
   --corrector-artifact`` burst over loopback; utt/s beside the
   ``Transcriber``'s in the same run, s to ready.
19. The port's bench (``tools/bench.py``) in-process for base-LAS and
   scaled-LAS: B=128, T=1536, L=192, bf16, 2 warm-up steps and 8 timed
   steps, then ``bench.py``'s realistic bucket plan; both JSON lines
   printed, every figure finite, the launches a dense step the plans'
   (``forward_launches`` / ``adjoint_launches``), the dense s/step beside
   phases 8 and 10's median step of the same run.
20. Profiles. ``tools/profile_step``'s rows for both models (its table
   printed). The Trainer's ``profile`` block: the ``train`` CLI for two
   epochs of ``configs/base-las.yml`` at its batch (96) on a generated
   long-form corpus (``make_synthetic_data --words 25 45``, the bench's
   realistic lengths: 384 / 96 / 8 utterances) with ``profile: {use: true,
   epoch: 1, batches: 3}`` (the second epoch: no first-use allocation in
   the window); the trace must name the four bf16 kernels, hold 3 steps'
   launches of the decode's adjoint, the pinned copies and the
   prefetcher's thread. With this script's own
   profiler: one ``infer.main`` call (``configs/infer.yml``'s keys on phase
   14's test set) and one ``Transcriber.transcribe`` of phase 4's
   utterances. For each trace the device's busy share of the window (the
   union of its kernel intervals) and its 5 longest idle gaps.
21. Tools: ``dev.extract_mini`` on phase 11's corpus; ``import_reference_ckpt``
   from phase 4's checkpoint to a reference ``.pt``, back, and out again,
   the tensors bit-equal; ``export_serving --check`` for the LAS (greedy,
   beam 8, int8; 32 x 1536) and phase 17's Rewriter; ``serving_bench`` on
   phase 4's experiment at the tool's default stream of 256 utterances
   (latency over its first 128 requests; ``cold_warm_accuracy_match`` 1.0).
22. The recipe and chain tools on a generated corpus of 64 / 16 / 16
   utterances: ``full_recipe_run`` (base-LAS with both kernel tiers, 10
   epochs to its first milestone, one Rewriter epoch, ``lminfer`` beam 8
   with the gate), ``chain_refit`` on its run (one Rewriter epoch, three
   ``lminfer`` modes), ``best_effort_eval`` from its artifacts; each record
   printed.
23. Data parallelism (``parallel/``). After phase 21: ``Transcriber(
   data_parallel=2)`` refuses this one card; the split itself over
   ``[cuda:0, cuda:0]`` (two row blocks on two streams) gives phase 4's
   transcripts exactly, and a ``data_parallel=2`` artifact those of a
   ``data_parallel=1`` one; ``lmtrain`` with ``parallel: {use: true, data:
   1}`` for one epoch on phase 17's corpus. After phase 22: the DP train
   step at base-LAS width, bf16, both kernel tiers, on two gloo ranks that
   share this card (``parallel.dp.spawn``), global batch B=64 (32 rows a
   rank), T=768, L=96: the DP eval step at the initial parameters and one DP
   step on each rank's rows of the one-process step's draws, against the
   one-process step and eval on the same 64 rows (loss and grad_norm within
   ``TRAIN_TOL`` bf16, n_tokens equal, parameters within 2 lr); three more
   steps on the ranks' own draws, after which the ranks' parameters and
   optimizer states are bit-equal (sha256); a NaN in rank 0's rows, skipped
   on both. Each rank's launch counters, set to 0 before its DP run and
   read after, show every kernel of the step's and the dev pass's path. The
   DP step's time a rank, the all-reduce of its gradient buffer alone (gloo
   stages through the host: not NCCL's time across cards) and the
   one-process step at 64 and at 32 rows. Then the ``train`` CLI with
   ``parallel: {use: true, data: 1}`` (one rank, NCCL) on phase 11's corpus
   at base-LAS for 2 epochs, its checkpoint resumed with ``parallel.use:
   false``, ``infer`` from its folder; and ``tools/dp_probe.py``.
24. The two remaining drivers (``tools/fullscale_run.py``,
   ``tools/speller_control.py``). ``fullscale_run`` in both modes
   (``resident``, ``streamed``) on a long-form corpus from
   ``make_synthetic_data --words 25 45`` (256 / 32 / 32 utterances), 2
   epochs at batch 32 each, its JSON line printed; with the counters set to
   0 before each run and read after, its path's kernels launched: the
   listener's training forms (``lstm_scan_fusedin_train``,
   ``lstm_scan_train``, ``lstm_bwd_dw``) and the dev decode's
   (``lstm_scan_fusedin``, ``lstm_scan``, ``speller_decode``), and the
   fused decoder's training pair not at all (the speller trains on the scan
   loop under ``init_force``, as in the JAX package); dev LD and losses
   finite. ``speller_control`` at its full widths
   (B=128, Te=192, L=192, H1 1024, H2 256, P 256, emb 512, 4 heads, bf16):
   the five variants' walls and MFU and the fused tier's forward and
   forward + backward; on the tool's own operands and draws, #8's train
   form and #9 through the autograd Function against the Function over
   their plain versions (logits and every operand's gradient, fed the
   kernel's ids, within the bf16 ``SPELLER_TRAIN_TOL``).
25. Tensor, sequence and pipeline parallelism (``parallel/``) on
   ``[cuda:0] * n``, base-LAS width, the scan tiers, float32, TF32 off,
   B=16, T=256, L=32, randomness quiesced (tf_rate 1, dropout 0, no
   SpecAugment): one train step each of TP (1 x 2), DP x TP (2 x 2), SP
   (seq 2), SP x TP (1 x 2 x 2), PP (2 microbatches) and PP x DP x TP (dp 2,
   tp 2) against the one-device scan step on the card: loss, grad norm and
   the first Adam moment (its relative error) within 2e-5; each step's
   seconds and the parameter bytes one device holds at model 1 and 2. One
   ``Trainer`` epoch with ``shard_state`` at model 2 and one with
   ``pipeline`` (2 microbatches), each given its device list, on a small
   generated corpus; each checkpoint resumed in the one-device Trainer with
   the same parameters.

Beside each kernel's time the record holds ``bound_ms``, the least time the
card could take for the same work: the larger of the operations this run's
valid frames need over the peak of their type (bf16 989 TFLOP/s dense on the
tensor cores; float32 67 TFLOP/s, the CUDA cores' exact FMAs)
and the bytes the function must move over 3.35 TB/s (of a padded input stream only the rows at valid
frames, which are all a kernel needs to read; the weights, the lengths and
every output whole, pads being written as zeros); and ``library_ms``, the time of
one PyTorch call for the same function (cuDNN's LSTM through ``nn.LSTM`` on
the packed batch), a yardstick the port never calls; None for the speller
kernels, whose function no single PyTorch call computes.

The wall seconds of each group of phases are logged as ``[phase] ...`` lines
(the build, the plain versions' Python loops and the CLIs' checkpoint work are
host-bound and move with the host: 375-527 s in all on two machines).

Any failure exits non-zero before the result. The line before the last is
the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 11785
DEVICE = "cuda"
B, H = 32, 512
# float32: the kernel and the plain loop differ only in summation order;
# over 1536 steps that stays near 1e-6. bfloat16: h is rounded to bf16 as
# the dot operand and the output is bf16 (step 2**-8 near 1), so an order
# difference that flips one rounding propagates.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# speller_decode forced along its own ids over 600 steps, (logits, attention
# weights). float32: the kernel and the plain loop differ only in summation
# order (measured ~4e-6 on logits of magnitude ~10). bfloat16: the outputs
# are bf16 (one step is 2**-5 at |logit| 4-8, 2**-8 at weights near 1) and
# the carries are rounded to bf16 each step, so an order difference that
# flips one rounding propagates; two steps of the largest logits' and of
# weights near 1.
SPELLER_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.25, 2.0 ** -7)}
KERNELS = {
    # name: (T, input width, TPU kernel it replaces); T as infer pads the
    # longest utterance (1500 frames to a multiple of 256), halved by the pyramid
    "lstm_scan_fusedin": (1536, 15, "attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py:854"),
    "lstm_scan": (768, 2 * 2 * H, "attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py:87"),
}
SOURCE = "attention_based_e2e_asr_dnn_tpu_torch/csrc/lstm_scan.cu"
STREAMS_SOURCE = "attention_based_e2e_asr_dnn_tpu_torch/csrc/lstm_scan_streams.cu"
# the bfloat16 forms of the forward recurrence (the records' dtype): tensor cores
TC_SOURCE = "attention_based_e2e_asr_dnn_tpu_torch/csrc/lstm_scan_tc.cu"
TC_STREAMS_SOURCE = "attention_based_e2e_asr_dnn_tpu_torch/csrc/lstm_scan_tc_streams.cu"
BWD_SOURCE = "attention_based_e2e_asr_dnn_tpu_torch/csrc/lstm_bwd.cu"
# the bfloat16 adjoint (the records' dtype): tensor cores, dpre streamed by TMA
BWD_TC_SOURCE = "attention_based_e2e_asr_dnn_tpu_torch/csrc/lstm_bwd_tc.cu"
PALLAS = "attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py"
# the card's published peaks (H100 SXM): dense bf16 FLOP/s on the tensor
# cores, float32 FLOP/s outside them (the float32 kernels' exact FMAs), bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# the train step's shapes
TRAIN_B, TRAIN_T, TRAIN_L = 128, 1536, 192
TRAIN_KERNELS = {
    # forward name: (T, input is the fused 15 features, TPU kernel it replaces,
    # the lean kernel and the TPU kernel that one replaces)
    "lstm_scan_fusedin_train": (1536, True, PALLAS + ":854", "lstm_scan_fusedin",
                                PALLAS + ":854"),
    "lstm_scan_train": (768, False, PALLAS + ":239", "lstm_scan", PALLAS + ":87"),
}
# scaled-LAS's listener width (configs/scaled-las.yml): the kernels' wide
# form, one launch a direction, the adjoint without dW_hh
WIDE_H = 1024


def at_width(name: str, hidden: int) -> str:
    """The record's name: the kernel's, with the width where it is not 512."""
    return name if hidden == H else f"{name} (H={hidden})"


def f32_adjoint_name(hidden: int) -> str:
    """The float32 adjoint's record: ``lstm_bwd_dw`` up to H=512, ``lstm_bwd``
    above, as ``_adjoint`` routes them."""
    if hidden > H:
        return f"lstm_bwd (H={hidden}, float32)"
    return "lstm_bwd_dw (float32)"


# The training forward and the adjoint against their plain versions: the
# largest error over the largest magnitude of the plain tensor. float32:
# summation order over up to 1536 steps (dW_hh sums T x B terms).
# bfloat16: the streams are bf16 and an order difference that flips one
# rounding carries along the recurrence: four bf16 steps (4 * 2**-8).
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
BASE_LAS_MODEL = {
    "listener_configs": {
        "input_dim": 15, "uniform_hid_dim": 512, "lstm_layers": 1,
        "plstm_layers": 3, "bidirectional": True, "init_dropout": 0.3,
        "mid_dropout": 0.3, "final_dropout": 0.35, "lstm_impl": "pallas"},
    "speller_configs": {
        "att_proj_dim": 256, "att_heads": 1, "att_dropout": 0.0,
        "dec_emb_dim": 512, "dec_emb_dropout": 0.0, "dec_lstm_hid_dim": 512,
        "dec_lstm_out_dim": 256, "dec_lstm_dropout": 0.3, "CHR_MAX_STEPS": 600,
        "USE_GREEDY": True, "decoder_impl": "pallas",
        "dec_vocab_size": 30, "CHR_SOS_IDX": 0, "CHR_PAD_IDX": 29},
}
# the model block of configs/scaled-las.yml
SCALED_LAS_MODEL = {
    "listener_configs": {**BASE_LAS_MODEL["listener_configs"], "uniform_hid_dim": WIDE_H,
                         "remat": True},
    "speller_configs": {**BASE_LAS_MODEL["speller_configs"], "att_heads": 4,
                        "dec_lstm_hid_dim": 1024},
}
MODELS = {"base-LAS": BASE_LAS_MODEL, "scaled-LAS": SCALED_LAS_MODEL}
N_UTTS, MIN_FRAMES, MAX_FRAMES = 40, 200, 1500
N_TEST_UTTS, INFER_BATCH = 128, 64

SPELLER_SOURCE = "attention_based_e2e_asr_dnn_tpu_torch/csrc/speller_decode.cu"
# the bfloat16 forms of the decode (the records' dtype): tensor cores
SPELLER_TC_SOURCE = "attention_based_e2e_asr_dnn_tpu_torch/csrc/speller_decode_tc.cu"
SPELLER_BWD_SOURCE = "attention_based_e2e_asr_dnn_tpu_torch/csrc/speller_bwd.cu"
# the bfloat16 adjoint (the records' dtype): tensor cores
SPELLER_BWD_TC_SOURCE = "attention_based_e2e_asr_dnn_tpu_torch/csrc/speller_bwd_tc.cu"
SPELLER_REPLACES = "attention_based_e2e_asr_dnn_tpu/ops/speller_pallas.py:90"
SPELLER_BWD_REPLACES = "attention_based_e2e_asr_dnn_tpu/ops/speller_pallas.py:223"
# speller_decode at the main path's shapes: base-LAS as infer runs it
# (batch_size 64) and scaled-LAS (configs/scaled-las.yml: H1 1024, 4 heads
# of 64) at B=32; encoder length 192 (1536 frames / 8), 600 steps
SPELLER_CASES = {
    # name: (speller config changes, listener width, batch)
    "base-LAS": ({}, 512, 64),
    "scaled-LAS": ({"dec_lstm_hid_dim": 1024, "att_heads": 4}, 1024, 32),
}
TE_DEC = 192
# the training form and the adjoint at the train step's shapes (192 label
# steps): base-LAS at the train batch, scaled-LAS at B=32
SPELLER_TRAIN_CASES = {
    "base-LAS": ({}, 512, TRAIN_B),
    "scaled-LAS": ({"dec_lstm_hid_dim": 1024, "att_heads": 4}, 1024, 32),
}
# speller_decode_train and speller_decode_bwd against their plain versions on
# the same inputs (the plain forward fed the kernel's own ids), and every
# operand's gradient through the Function on the kernels against the
# Function on the plain versions: the largest error over the largest
# magnitude of the plain tensor. float32: summation order over 192 steps
# (the weight gradients sum T x B terms). bfloat16: every stream and dot
# operand is rounded to bf16, and an order difference that flips one
# rounding is carried down the recurrence and through the products: four
# bf16 steps (4 * 2**-8), as for the LSTM training kernels.
SPELLER_TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple:
    """(least time in ms, "operations" or "bytes") at the card's peaks for
    operations in ``dtype`` ("bfloat16" or "float32", or a torch dtype)."""
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fmt_ms(value) -> str:
    return "not measured" if value is None else f"{value:.3f}"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def valid_bytes(frames: int, *streams) -> int:
    """Bytes of the rows of padded (B, T, width) ``streams`` at a run's
    ``frames`` valid (row, time) positions: what must be read of them."""
    return sum(frames * t.shape[-1] * t.element_size() for t in streams)


def nn_lstm_ms(torch, x, lengths, dtype, mode: str, hidden: int = 512):
    """cuDNN's LSTM through ``nn.LSTM`` (one bidirectional layer, H hidden)
    on the packed batch, CUDA-event median of 5: ``mode`` "infer" (forward
    under no_grad), "train" (forward with the graph kept) or "backward" (all
    gradients from a given output gradient). None where this PyTorch build
    has no such LSTM for the dtype."""
    from torch.nn.utils.rnn import pack_padded_sequence

    try:
        lstm = torch.nn.LSTM(x.shape[2], hidden, batch_first=True, bidirectional=True)
        lstm = lstm.to(DEVICE, dtype)
        packed = pack_padded_sequence(x.detach().clone().requires_grad_(mode != "infer"),
                                      lengths.cpu().long(), batch_first=True,
                                      enforce_sorted=False)
        if mode == "infer":
            with torch.no_grad():
                lstm(packed)
                return cuda_median_ms(torch, lambda: lstm(packed), 5)
        if mode == "train":
            lstm(packed)
            return cuda_median_ms(torch, lambda: lstm(packed), 5)
        out = lstm(packed)[0].data
        dy = torch.randn_like(out)
        leaves = list(lstm.parameters())
        run = lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)  # noqa: E731
        run()
        return cuda_median_ms(torch, run, 5)
    except RuntimeError as exc:
        log(f"  nn.LSTM {mode} {dtype}: not available ({str(exc).splitlines()[0]})")
        return None


def cuda_median_ms(torch, fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(torch, fn, calls: int = 50, reps: int = 5) -> float:
    """Device ms a call of ``fn`` alone: ``calls`` calls back to back between
    one pair of CUDA events, issued while a sleep kernel holds the stream,
    so that the host's time to issue them is hidden; the median of
    ``reps``. For kernels of tens of microseconds, where one call between
    two events reads the host's checks and allocations too."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# about 50 ms at the H100's clocks: longer than the host takes to issue 50
# calls of a kernel wrapper of about 0.1 ms each
QUEUE_SLEEP_CYCLES = 100_000_000


def timed_ms(torch, fn) -> tuple:
    """(what ``fn`` returns, its time in ms by CUDA events): one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


class phase:
    """Logs the wall seconds of the block it wraps."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"[phase] {self.name}: {time.perf_counter() - self.t0:.1f} s")


def environment(torch, card: str) -> float:
    from torch.utils.cpp_extension import CUDA_HOME

    from attention_based_e2e_asr_dnn_tpu_torch.data.native_loader import native_available
    from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build

    nvcc = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "--version"],
                          capture_output=True, text=True, check=True).stdout
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}  nvcc: {nvcc.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    libs = cuda_build.build_all()  # one nvcc per source, side by side; then bound
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.2f} s ({SOURCE}, {STREAMS_SOURCE}, {TC_SOURCE}, "
        f"{TC_STREAMS_SOURCE}, {BWD_SOURCE}, {BWD_TC_SOURCE}, {SPELLER_SOURCE}, "
        f"{SPELLER_TC_SOURCE}, {SPELLER_BWD_SOURCE}, {SPELLER_BWD_TC_SOURCE}, "
        f"{ADDITIVE_SOURCE}; "
        f"cuda_build.build_all, the call the entry points make)")
    log(f"native batch assembler (native/libasrtpu.so, not tracked): "
        f"{'loaded' if native_available() else 'absent, the numpy assembler serves'}")
    for so in libs:
        with open(so + ".log") as fh:
            for line in fh:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {os.path.basename(so)}: {line.strip()}")
    return build_s


def kernel_phase(torch, card: str) -> dict:
    """Each kernel against its plain version at the infer CLI's batch (one
    launch in either dtype); returns the JSON records."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc

    gen = torch.Generator().manual_seed(SEED)
    records = {}
    B = INFER_BATCH
    for name, (seq_len, in_dim, replaces) in KERNELS.items():
        lengths = torch.randint(1, seq_len + 1, (B,), generator=gen)
        lengths[0], lengths[1] = seq_len, 1
        lengths[-2], lengths[-1] = 1, seq_len  # both extremes in the last row group too
        lengths = lengths.to(torch.int32).cuda()
        k = 1.0 / H ** 0.5
        w_hh32 = ((torch.rand(2, H, 4 * H, generator=gen) * 2 - 1) * k).cuda()
        w_ih32 = ((torch.rand(2, in_dim, 4 * H, generator=gen) * 2 - 1) * k).cuda()
        b32 = ((torch.rand(2, 4 * H, generator=gen) * 2 - 1) * k).cuda()
        x32 = torch.randn(B, seq_len, in_dim, generator=gen).cuda()
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            w_hh = w_hh32.to(dtype)
            x = x32.to(dtype) if name == "lstm_scan_fusedin" else (x32.clamp(-1, 1) * 0.5).to(dtype)
            if name == "lstm_scan_fusedin":
                w_ih, b = w_ih32.to(dtype), b32.to(dtype)
                args = (x, w_ih, b, w_hh, lengths, (False, True))
                kern, plain = lc.lstm_scan_fusedin, lc.lstm_scan_fusedin_plain
            else:
                w_cat = torch.cat([w_ih32[0], w_ih32[1]], dim=1).to(dtype)
                x_proj = torch.matmul(x, w_cat) + torch.cat([b32[0], b32[1]]).to(dtype)
                args = (x_proj, w_hh, lengths, (False, True))
                kern, plain = lc.lstm_scan, lc.lstm_scan_plain
            before = lc.LAUNCHES[name]
            got = kern(*args)
            torch.cuda.synchronize()
            n_launch = forward_launches(torch, dtype, B, H,
                                        in_dim if name == "lstm_scan_fusedin" else 0)
            if lc.LAUNCHES[name] - before != n_launch:
                raise AssertionError(f"{name} {dtype_name}: B={B} took "
                                     f"{lc.LAUNCHES[name] - before} launches, not {n_launch}")
            ref = plain(*args)
            torch.cuda.synchronize()
            if got.shape != (B, seq_len, 2 * H) or got.dtype != dtype:
                raise AssertionError(f"{name}: output {tuple(got.shape)} {got.dtype}")
            pads = torch.arange(seq_len, device="cuda")[None, :] >= lengths[:, None].long()
            if pads.any() and got[pads].abs().max().item() != 0.0:
                raise AssertionError(f"{name}: non-zero output at padded frames")
            err = (got.float() - ref.float()).abs().max().item()
            ms = cuda_median_ms(torch, lambda: kern(*args), 20)
            plain_ms = cuda_median_ms(torch, lambda: plain(*args), 3)
            # the work of this run's valid frames, both directions
            frames = int(lengths.sum())
            flops = 2 * frames * 2 * 4 * H * (H + (in_dim if name == "lstm_scan_fusedin" else 0))
            bound, bound_by = bound_ms(
                flops, valid_bytes(frames, args[0]) + nbytes(*args[1:-2], lengths, got), dtype)
            library_ms = nn_lstm_ms(torch, x, lengths, dtype, "infer")
            log(f"[{card}] {name} {dtype_name} B={B} T={seq_len} D={in_dim} H={H} 2 dirs: "
                f"max_abs_err {err:.3e} (tol {TOL[dtype_name]:g})  kernel {ms:.3f} ms  "
                f"plain {plain_ms:.3f} ms  bound {bound:.3f} ms ({bound_by})  "
                f"nn.LSTM on the layer's input {fmt_ms(library_ms)} ms")
            if not err <= TOL[dtype_name]:
                raise AssertionError(f"{name} {dtype_name}: max_abs_err {err} > {TOL[dtype_name]}")
            if dtype_name == "bfloat16":  # the serving dtype goes into the record
                records[name] = {"name": name, "route": "cuda", "source": TC_SOURCE,
                                 "replaces": replaces, "launches": 0,
                                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound, "bound_by": bound_by,
                                 "library_ms": library_ms}
    return records


def speller_kernel_phase(torch, card: str) -> dict:
    """speller_decode against its plain version on the operands the main path
    builds (random full-width parameters, encoder lengths mixed from 1 to
    Te): the plain version forced along the kernel's own fed-back ids must
    give the same logits and weights at every step; the plain version run
    free must pick the same ids wherever the top two logits are further
    apart than the tolerance (float32). Returns the JSON record."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
        las_config_from_dicts,
        las_init,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    gen = torch.Generator().manual_seed(SEED)
    record = None
    for case, (changes, width, batch) in SPELLER_CASES.items():
        cfg = las_config_from_dicts(
            {**BASE_LAS_MODEL["listener_configs"], "uniform_hid_dim": width},
            {**BASE_LAS_MODEL["speller_configs"], **changes})
        params = las_init(cfg, gen)["speller"].cuda()
        spl = cfg.speller
        vocab = spl.dec_vocab_size
        lengths = torch.randint(1, TE_DEC + 1, (batch,), generator=gen)
        lengths[0], lengths[1] = TE_DEC, 1
        enc = torch.randn(batch, TE_DEC, cfg.listener.enc_out_dim, generator=gen) * 0.5
        enc[torch.arange(TE_DEC)[None, :] >= lengths[:, None]] = 0.0
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            with torch.inference_mode():
                operands, _ = sc.decode_operands(params, spl, enc.to(dtype).cuda(),
                                                 lengths.cuda())
                opts = sc.decode_options(spl)
                sc.reset_launch_counts()
                logits, wgts, ids = sc.speller_decode(*operands, **opts)
                torch.cuda.synchronize()
                if sc.LAUNCHES["speller_decode"] != 1:
                    raise AssertionError(f"speller_decode {case} {dtype_name} B={batch}: "
                                         f"{sc.LAUNCHES['speller_decode']} launches, not 1")
                forced = torch.cat([torch.full_like(ids[:1], -1), ids[:-1]]).contiguous()
                p_logits, p_wgts, p_ids = sc.speller_decode_plain(*operands, **opts,
                                                                  forced=forced)
                _, _, free_ids = sc.speller_decode_plain(*operands, **opts)
                torch.cuda.synchronize()
                ms = cuda_median_ms(torch, lambda: sc.speller_decode(*operands, **opts), 10)
                plain_ms = cuda_median_ms(
                    torch, lambda: sc.speller_decode_plain(*operands, **opts), 1)
            shape = (spl.CHR_MAX_STEPS, batch)
            if ids.shape != shape or logits.shape != (*shape, operands[8].shape[0]):
                raise AssertionError(f"speller_decode {case}: outputs {tuple(ids.shape)}, "
                                     f"{tuple(logits.shape)}")
            if not torch.isfinite(logits[..., :vocab].float()).all():
                raise AssertionError(f"speller_decode {case} {dtype_name}: logits not finite")
            err = (logits[..., :vocab].float() - p_logits[..., :vocab].float()).abs().max().item()
            w_err = (wgts.float() - p_wgts.float()).abs().max().item()
            tol, w_tol = SPELLER_TOL[dtype_name]
            # rows whose free-run ids differ: the top-two gap of the plain
            # logits where they first differ (identical inputs up to there)
            gaps = []
            for r in torch.nonzero((free_ids != ids).any(0)).flatten().tolist():
                t0 = int(torch.nonzero(free_ids[:, r] != ids[:, r])[0])
                top2 = p_logits[t0, r].float().topk(2).values
                gaps.append((top2[0] - top2[1]).item())
            same = batch - len(gaps)
            forced_same = int((p_ids == ids).all(0).sum())
            log(f"[{card}] speller_decode {case} {dtype_name} B={batch} Te={TE_DEC} "
                f"T={spl.CHR_MAX_STEPS} H1={spl.dec_lstm_hid_dim} heads={spl.att_heads}: "
                f"forced logits max_abs_err {err:.3e} (tol {tol:g}), weights {w_err:.3e} "
                f"(tol {w_tol:g}); "
                f"forced-run argmax equal in {forced_same}/{batch} rows; free run identical "
                f"ids in {same}/{batch} rows (top-two gaps where not: "
                f"{[round(g, 6) for g in gaps]}); kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
            if not (err <= tol and w_err <= w_tol):
                raise AssertionError(f"speller_decode {case} {dtype_name}: errors {err}, "
                                     f"{w_err} above {tol}, {w_tol}")
            if dtype_name == "float32" and any(g > tol for g in gaps):
                raise AssertionError(f"speller_decode {case}: free-run ids differ where the "
                                     f"top two logits are {max(gaps)} apart")
            # the bound of every case: per row and step, cell 1 over [context;
            # h1] (the embedding arrives pre-projected), cell 2, the query,
            # scores and context over the row's valid frames, the classifier
            proj, h1, h2 = spl.att_proj_dim, spl.dec_lstm_hid_dim, spl.dec_lstm_out_dim
            per_row = 2 * ((proj + h1) * 4 * h1 + (h1 + h2) * 4 * h2
                           + h2 * proj + 2 * proj * vocab)
            flops = spl.CHR_MAX_STEPS * (batch * per_row + 4 * proj * int(lengths.sum()))
            moved = nbytes(*(t for t in operands if torch.is_tensor(t)), logits, wgts, ids)
            bound, bound_by = bound_ms(flops, moved, dtype_name)
            log(f"[{card}] speller_decode {case} {dtype_name} B={batch}: bound {bound:.3f} ms "
                f"({bound_by}; {flops:.3e} operations, {moved:.3e} bytes)")
            if case == "base-LAS" and dtype_name == "bfloat16":  # the infer path's
                record = {"name": "speller_decode", "route": "cuda",
                          "source": SPELLER_TC_SOURCE, "replaces": SPELLER_REPLACES,
                          "launches": 0, "max_abs_err": err, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                          "library_ms": None}
    return record


BWD_NAMES = ("dpre1", "dpre2", "dq", "dctxtot", "dsc", "dh10", "dc10", "dh20", "dc20",
             "dctx0")
OPERAND_NAMES = ("k", "v", "bias", "ctx0", "h10", "c10", "h20", "c20", "embw1", "wc1", "whh1",
                 "wih2", "whh2", "b2", "wq", "bq", "wcls", "clsb")


def speller_train_kernel_phase(torch, card: str) -> dict:
    """speller_decode_train and speller_decode_bwd against their plain
    versions on the operands the train step builds (random full-width
    parameters, encoder lengths mixed from 1 to Te, dropout 0.3, a coin
    stream that mixes forced and free steps); returns the JSON records
    (base-LAS, bfloat16)."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
        las_config_from_dicts,
        las_init,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    gen = torch.Generator().manual_seed(SEED + 3)
    records = {}
    steps = TRAIN_L
    for case, (changes, width, batch) in SPELLER_TRAIN_CASES.items():
        cfg = las_config_from_dicts(
            {**BASE_LAS_MODEL["listener_configs"], "uniform_hid_dim": width},
            {**BASE_LAS_MODEL["speller_configs"], **changes})
        params = las_init(cfg, gen)["speller"].to(DEVICE)
        spl = cfg.speller
        vocab, proj = spl.dec_vocab_size, spl.att_proj_dim
        h1, h2, heads = spl.dec_lstm_hid_dim, spl.dec_lstm_out_dim, spl.att_heads
        lengths = torch.randint(1, TE_DEC + 1, (batch,), generator=gen)
        lengths[0], lengths[1] = TE_DEC, 1
        enc = torch.randn(batch, TE_DEC, cfg.listener.enc_out_dim, generator=gen) * 0.5
        enc[torch.arange(TE_DEC)[None, :] >= lengths[:, None]] = 0.0
        coins = torch.rand(steps, generator=gen)
        coins[0] = 2.0
        gold = torch.randint(1, vocab - 1, (steps, batch), generator=gen, dtype=torch.int32)
        forced = torch.where((coins <= 0.7)[:, None], gold, -1).to(DEVICE).contiguous()
        n_free = int((forced[:, 0] < 0).sum())
        keep = 1.0 - spl.dec_lstm_dropout
        keep1 = torch.rand(steps, batch, h1, generator=gen) < keep
        keep2 = torch.rand(steps, batch, h2, generator=gen) < keep
        cots32 = [torch.randn(steps, batch, n, generator=gen) * 0.1 for n in (proj, proj)]
        dw32 = torch.randn(steps, batch, heads, TE_DEC, generator=gen) * 0.1
        dl32 = torch.randn(steps, batch, 32, generator=gen) * 0.1
        dl32[..., vocab:] = 0.0
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            tol = SPELLER_TRAIN_TOL[dtype_name]
            with torch.no_grad():
                operands, _ = sc.decode_operands(params, spl, enc.to(dtype).to(DEVICE),
                                                 lengths.to(DEVICE))
            opts = {**sc.decode_options(spl), "steps": steps}
            m1, m2 = ((m.to(dtype) / keep).to(DEVICE) for m in (keep1, keep2))
            sc.reset_launch_counts()
            logits, wgts, ids, saved = sc.speller_decode_train(*operands, **opts, forced=forced,
                                                               m1=m1, m2=m2)
            torch.cuda.synchronize()
            if sc.LAUNCHES["speller_decode_train"] != 1:
                raise AssertionError(f"speller_decode_train {case} {dtype_name} B={batch}: "
                                     f"{sc.LAUNCHES['speller_decode_train']} launches, not 1")
            sel = saved[0]
            if not (torch.equal(sel[forced >= 0], forced[forced >= 0])
                    and torch.equal(sel[1:][forced[1:] < 0], ids[:-1][forced[1:] < 0])
                    and bool((sel[0] == spl.CHR_SOS_IDX).all())):
                raise AssertionError(f"speller_decode_train {case} {dtype_name}: the fed ids "
                                     f"are not the forced ids and the fed-back argmax")
            if not torch.isfinite(logits[..., :vocab].float()).all():
                raise AssertionError(f"speller_decode_train {case} {dtype_name}: logits not finite")
            # the fed-back id is the first maximum of the step's own fp32
            # logits: in float32 the stored logits are those, in bfloat16
            # their monotone rounding, which may tie where they did not
            shown = logits[..., :vocab].float()
            top = shown.max(-1).values
            first = torch.where(shown == top[..., None],
                                torch.arange(vocab, device=DEVICE), vocab).min(-1).values
            picked = shown.gather(-1, ids.long().unsqueeze(-1)).squeeze(-1)
            if not (torch.equal(picked, top)
                    and (dtype != torch.float32 or torch.equal(ids.long(), first))):
                raise AssertionError(f"speller_decode_train {case} {dtype_name}: the ids are "
                                     f"not the first maxima of the kernel's own logits")
            # the plain version fed the kernel's own ids at every step
            p_logits, p_wgts, _, p_saved = sc.speller_decode_train_plain(
                *operands, **opts, forced=sel, m1=m1, m2=m2)
            errs = {"logits": rel_err(logits[..., :vocab], p_logits[..., :vocab]),
                    "weights": rel_err(wgts, p_wgts)}
            errs.update({n: rel_err(a, b) for n, a, b in
                         zip(sc.RESIDUALS[1:], saved[1:], p_saved[1:])})
            # the training form without dropout and forcing is the eval form
            with torch.no_grad():
                lean = sc.speller_decode(*operands, **opts)
                bare = sc.speller_decode_train(*operands, **opts)
            if not all(torch.equal(a, b) for a, b in zip(bare[:3], lean)):
                raise AssertionError(f"speller_decode_train {case} {dtype_name}: without "
                                     f"masks and forcing it differs from speller_decode")
            k, v, _, _, _, c10, _, c20, _, wc1, whh1, wih2, whh2, _, wq = operands[:15]
            _, gates1, c1, _, gates2, c2, _, _ = saved
            dqup, dctxup = (c.to(dtype).to(DEVICE) for c in cots32)
            dwup = dw32.to(dtype).to(DEVICE)
            bwd_args = (k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1, gates2, c2,
                        wgts, m1, m2, dqup, dctxup)
            kw = {"heads": opts["heads"], "scale": opts["scale"]}
            for label, dw in (("", None), (" (weights' cotangent)", dwup)):
                got = sc.speller_decode_bwd(*bwd_args, dw, **kw)
                want = sc.speller_decode_bwd_plain(*bwd_args, dw, **kw)
                errs.update({n + label: rel_err(a, b) for n, a, b in zip(BWD_NAMES, got, want)})
                if got[4][wgts == 0].abs().max().item() != 0.0:
                    raise AssertionError(f"speller_decode_bwd {case} {dtype_name}: a score "
                                         f"gradient at a padded frame")
            del got, want
            # every operand's gradient through the Function: the kernels
            # against the plain versions, both fed the kernel's ids
            d_logits = dl32.to(dtype).to(DEVICE)
            grads = {}
            for route in ("kernels", "plain"):
                saved_fns = (sc.speller_decode_train, sc.speller_decode_bwd)
                if route == "plain":
                    sc.speller_decode_train = sc.speller_decode_train_plain
                    sc.speller_decode_bwd = sc.speller_decode_bwd_plain
                try:
                    leaves = [t.detach().requires_grad_(n != "bias")
                              for n, t in zip(OPERAND_NAMES, operands)]
                    outs = sc.fused_decode(leaves, **opts, forced=sel, m1=m1, m2=m2)
                    grads[route] = torch.autograd.grad(
                        outs, [t for t in leaves if t.requires_grad], [d_logits, dwup])
                finally:
                    sc.speller_decode_train, sc.speller_decode_bwd = saved_fns
            errs.update({"d_" + n: rel_err(a, b) for n, a, b in zip(
                [n for n in OPERAND_NAMES if n != "bias"], grads["kernels"], grads["plain"])})
            del grads, leaves, outs
            n_fwd, n_bwd = sc.LAUNCHES["speller_decode_train"], sc.LAUNCHES["speller_decode_bwd"]
            if (n_fwd, n_bwd) != (3, 3):
                raise AssertionError(f"speller kernels {case}: {dict(sc.LAUNCHES)} launches, "
                                     f"not 3 of the forward and 3 of the adjoint")
            plan_note = ""
            if dtype_name == "float32":
                plan_note = f32_bwd_checks(torch, sc, f"{case} B={batch}", bwd_args, dwup, kw,
                                           h1, h2)
            fwd_ms = cuda_median_ms(torch, lambda: sc.speller_decode_train(
                *operands, **opts, forced=forced, m1=m1, m2=m2), 10)
            bwd_ms = cuda_median_ms(torch, lambda: sc.speller_decode_bwd(*bwd_args, None, **kw),
                                    10)
            plain_fwd_ms = cuda_median_ms(torch, lambda: sc.speller_decode_train_plain(
                *operands, **opts, forced=sel, m1=m1, m2=m2), 1)
            plain_bwd_ms = cuda_median_ms(
                torch, lambda: sc.speller_decode_bwd_plain(*bwd_args, None, **kw), 1)
            # per row and step: cell 1 over [context; h1], cell 2, the query,
            # the classifier, and scores and context over the row's valid
            # frames; the adjoint: the products with wq^T, [wih2; whh2]^T and
            # [whh1; wc1]^T and the two attention products
            frames = int(lengths.sum())
            cells = (proj + h1) * 4 * h1 + (h1 + h2) * 4 * h2 + h2 * proj
            fwd_flops = steps * (2 * batch * (cells + 2 * proj * vocab) + 4 * proj * frames)
            bwd_flops = steps * (2 * batch * cells + 4 * proj * frames)
            fwd_bound = bound_ms(fwd_flops, nbytes(*operands, forced, m1, m2, logits, wgts, ids,
                                                   *saved), dtype_name)
            bwd_outs = sc.speller_decode_bwd(*bwd_args, None, **kw)
            bwd_bound = bound_ms(bwd_flops, nbytes(*bwd_args, *bwd_outs), dtype_name)
            del bwd_outs
            worst = max(errs, key=lambda n: errs[n][1])
            log(f"[{card}] speller_decode_train + speller_decode_bwd {case} {dtype_name} "
                f"B={batch} Te={TE_DEC} L={steps} H1={h1} heads={heads}, dropout "
                f"{spl.dec_lstm_dropout}, {n_free} free steps of {steps}: {len(errs)} tensors "
                f"against the plain versions, largest error {errs[worst][0]:.3e} "
                f"({errs[worst][1]:.1e} of max, {worst}; tolerance {tol:g} of max); the "
                f"training form without masks and forcing bit-equal to speller_decode")
            log("    " + ", ".join(f"{n} {r:.1e}" for n, (_, r) in errs.items()))
            log(f"    forward kernel {fwd_ms:.3f} ms  plain {plain_fwd_ms:.3f} ms  bound "
                f"{fwd_bound[0]:.3f} ms ({fwd_bound[1]}; {fwd_flops:.3e} operations)")
            log(f"    adjoint kernel {bwd_ms:.3f} ms  plain {plain_bwd_ms:.3f} ms  bound "
                f"{bwd_bound[0]:.3f} ms ({bwd_bound[1]}; {bwd_flops:.3e} operations){plan_note}")
            bad = {n: r for n, (_, r) in errs.items() if not r <= tol}
            if bad:
                raise AssertionError(f"speller kernels {case} {dtype_name}: errors over {tol} "
                                     f"of max: {bad}")
            if case == "base-LAS" and dtype_name == "float32":  # a float32 train step's
                records["speller_decode_bwd (float32)"] = {
                    "name": "speller_decode_bwd (float32)", "route": "cuda",
                    "source": SPELLER_BWD_SOURCE, "replaces": SPELLER_BWD_REPLACES,
                    "launches": 0, "max_abs_err": max(errs[n][0] for n in BWD_NAMES),
                    "ms": bwd_ms, "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound[0],
                    "bound_by": bwd_bound[1], "library_ms": None}
            if case == "base-LAS" and dtype_name == "bfloat16":  # the train step's
                records["speller_decode_train"] = {
                    "name": "speller_decode_train", "route": "cuda",
                    "source": SPELLER_TC_SOURCE,
                    "replaces": SPELLER_REPLACES, "launches": 0,
                    "max_abs_err": max(errs[n][0] for n in ("logits", *sc.RESIDUALS[1:])),
                    "ms": fwd_ms, "plain_ms": plain_fwd_ms, "bound_ms": fwd_bound[0],
                    "bound_by": fwd_bound[1], "library_ms": None}
                records["speller_decode_bwd"] = {
                    "name": "speller_decode_bwd", "route": "cuda",
                    "source": SPELLER_BWD_TC_SOURCE,
                    "replaces": SPELLER_BWD_REPLACES, "launches": 0,
                    "max_abs_err": max(errs[n][0] for n in BWD_NAMES),
                    "ms": bwd_ms, "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound[0],
                    "bound_by": bwd_bound[1], "library_ms": None}
            del logits, wgts, ids, saved, p_logits, p_wgts, p_saved, lean, bare
            torch.cuda.empty_cache()
    for label in F32_NEW_SHAPES:
        f32_new_shape_check(torch, card, label)
        torch.cuda.empty_cache()
    for label in BF16_SPELLER_CHECKS:
        bf16_speller_check(torch, card, label)
        torch.cuda.empty_cache()
    return records


def f32_bwd_checks(torch, sc, label: str, bwd_args: tuple, dwup, kw: dict, h1: int,
                   h2: int) -> str:
    """The float32 adjoint on ``bwd_args``: two calls bit-equal; returns the
    plan for the log line."""
    plan = sc.bwd_f32_plan_for(bwd_args[0], kw["heads"], h1, h2)
    first = sc.speller_decode_bwd(*bwd_args, dwup, **kw)
    again = sc.speller_decode_bwd(*bwd_args, dwup, **kw)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"speller_decode_bwd float32 {label}: two calls differ")
    return (f"; plan {plan.col_groups} column x {plan.row_groups} row groups of {plan.rows} "
            f"rows, sub-tiles {plan.sub}, {plan.stages} stages of {plan.boxes} boxes, k slices "
            f"{plan.ks}, (d)'s weights {'streamed' if plan.stream else 'resident'}, "
            f"{plan.smem} B; two calls bit-equal")


# float32 shapes the earlier float32 adjoint refused (5 cell-1 units a block
# on its grid of 128; its shared memory past Te=640 at scaled-LAS), taken by
# the plan: (speller config changes, listener width, batch, encoder length,
# label steps)
F32_NEW_SHAPES = {
    "H1 640, H2 128, P 256": ({"dec_lstm_hid_dim": 640, "dec_lstm_out_dim": 128}, H, 8,
                              TE_DEC, 48),
    "scaled-LAS at Te=704": ({"dec_lstm_hid_dim": 1024, "att_heads": 4}, WIDE_H, 8, 704, 48),
}


def f32_new_shape_check(torch, card: str, label: str) -> None:
    """The float32 training forward, adjoint and Function at
    ``F32_NEW_SHAPES[label]`` against their plain versions (the forward fed
    its own ids; ``SPELLER_TRAIN_TOL``), dsc 0 at padded frames, one launch a
    call."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
        las_config_from_dicts,
        las_init,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    changes, width, batch, te, steps = F32_NEW_SHAPES[label]
    gen = torch.Generator().manual_seed(SEED + 5)
    cfg = las_config_from_dicts(
        {**BASE_LAS_MODEL["listener_configs"], "uniform_hid_dim": width},
        {**BASE_LAS_MODEL["speller_configs"], **changes})
    spl = cfg.speller
    params = las_init(cfg, gen)["speller"].to(DEVICE)
    h1, h2, heads, proj = spl.dec_lstm_hid_dim, spl.dec_lstm_out_dim, spl.att_heads, \
        spl.att_proj_dim
    lengths = torch.randint(1, te + 1, (batch,), generator=gen)
    lengths[0], lengths[1] = te, 1
    enc = torch.randn(batch, te, cfg.listener.enc_out_dim, generator=gen) * 0.5
    with torch.no_grad():
        operands, _ = sc.decode_operands(params, spl, enc.to(DEVICE), lengths.to(DEVICE))
    opts = {**sc.decode_options(spl), "steps": steps}
    keep = 1.0 - spl.dec_lstm_dropout
    m1, m2 = (((torch.rand(steps, batch, n, generator=gen) < keep).float() / keep).to(DEVICE)
              for n in (h1, h2))
    tol = SPELLER_TRAIN_TOL["float32"]
    sc.reset_launch_counts()
    logits, wgts, _, saved = sc.speller_decode_train(*operands, **opts, m1=m1, m2=m2)
    p_logits, p_wgts, _, p_saved = sc.speller_decode_train_plain(
        *operands, **opts, forced=saved[0], m1=m1, m2=m2)
    vocab = spl.dec_vocab_size
    errs = {"logits": rel_err(logits[..., :vocab], p_logits[..., :vocab]),
            "weights": rel_err(wgts, p_wgts)}
    errs.update({n: rel_err(a, b) for n, a, b in zip(sc.RESIDUALS[1:], saved[1:], p_saved[1:])})
    k, v, _, _, _, c10, _, c20, _, wc1, whh1, wih2, whh2, _, wq = operands[:15]
    _, gates1, c1, _, gates2, c2, _, _ = saved
    dqup, dctxup = ((torch.randn(steps, batch, proj, generator=gen) * 0.1).to(DEVICE)
                    for _ in range(2))
    dwup = (torch.randn(*wgts.shape, generator=gen) * 0.1).to(DEVICE)
    bwd_args = (k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1, gates2, c2, wgts, m1, m2,
                dqup, dctxup)
    kw = {"heads": heads, "scale": opts["scale"]}
    got = sc.speller_decode_bwd(*bwd_args, dwup, **kw)
    want = sc.speller_decode_bwd_plain(*bwd_args, dwup, **kw)
    errs.update({n: rel_err(a, b) for n, a, b in zip(BWD_NAMES, got, want)})
    if got[4][wgts == 0].abs().max().item() != 0.0:
        raise AssertionError(f"speller_decode_bwd float32 {label}: a score gradient at a "
                             f"padded frame")
    d_logits = (torch.randn(steps, batch, logits.shape[-1], generator=gen) * 0.1).to(DEVICE)
    d_logits[..., vocab:] = 0.0
    grads = {}
    for route in ("kernels", "plain"):
        saved_fns = (sc.speller_decode_train, sc.speller_decode_bwd)
        if route == "plain":
            sc.speller_decode_train = sc.speller_decode_train_plain
            sc.speller_decode_bwd = sc.speller_decode_bwd_plain
        try:
            leaves = [t.detach().requires_grad_(n != "bias")
                      for n, t in zip(OPERAND_NAMES, operands)]
            outs = sc.fused_decode(leaves, **opts, forced=saved[0], m1=m1, m2=m2)
            grads[route] = torch.autograd.grad(outs, [t for t in leaves if t.requires_grad],
                                               [d_logits, dwup])
        finally:
            sc.speller_decode_train, sc.speller_decode_bwd = saved_fns
    errs.update({"d_" + n: rel_err(a, b) for n, a, b in zip(
        [n for n in OPERAND_NAMES if n != "bias"], grads["kernels"], grads["plain"])})
    if dict(sc.LAUNCHES) != {"speller_decode": 0, "speller_decode_train": 2,
                             "speller_decode_bwd": 2, "speller_additive_scores": 0,
                             "speller_additive_scores_bwd": 0}:
        raise AssertionError(f"speller kernels float32 {label}: {dict(sc.LAUNCHES)} launches, "
                             f"not one a call")
    plan = sc.bwd_f32_plan_for(k, heads, h1, h2)
    worst = max(errs, key=lambda n: errs[n][1])
    log(f"[{card}] float32 speller_decode_train + speller_decode_bwd at {label} (H1 {h1}, H2 "
        f"{h2}, P {proj}, {heads} heads), B={batch} Te={te} L={steps}, a shape the earlier "
        f"float32 adjoint refused: {len(errs)} tensors against the plain versions, largest "
        f"error {errs[worst][0]:.3e} ({errs[worst][1]:.1e} of max, {worst}; tolerance {tol:g} "
        f"of max); the adjoint's plan {plan.col_groups} x {plan.row_groups} groups, "
        f"{plan.stages} stages, {plan.smem} B")
    bad = {n: r for n, (_, r) in errs.items() if not r <= tol}
    if bad:
        raise AssertionError(f"speller kernels float32 {label}: errors over {tol} of max: {bad}")


# the bf16 speller kernels at shapes the comparisons above do not reach,
# against their plain versions: a decoder block past the narrower geometry of
# 2 cell-2 units a block (four cell-2 units a block in the forward, two groups
# of columns on some blocks of the adjoint) on the base-LAS decoder's other
# widths, the eval form too; scaled-LAS's decoder at the train batch, the
# shape phase 10's step runs (full 128-row tiles, two groups of columns on
# half the adjoint's blocks); and a block whose weight tiles leave too little
# shared memory for four 128-row ring stages, whose forward takes the train
# batch in two 64-row spans (the adjoint keeps one 128-row launch); and two
# blocks whose resident weight tiles leave no room for four stages even of
# 64 rows, whose forward streams cell 1's weights through the ring (one
# launch of 128 rows; "streamed" in the label)
BF16_SPELLER_CHECKS = {
    # label: (listener width, speller changes, batch, steps, with the eval
    # form, the forward's launches a call)
    "widened block dec_lstm_out_dim 512": (H, {"dec_lstm_out_dim": 512}, 64, 32, True, 1),
    "scaled-LAS at the train batch": (WIDE_H, {"dec_lstm_hid_dim": 1024, "att_heads": 4},
                                      TRAIN_B, TRAIN_L, False, 1),
    "64-row spans, H1 768, H2 384, P 1024": (
        H, {"dec_lstm_hid_dim": 768, "dec_lstm_out_dim": 384, "att_proj_dim": 1024,
            "dec_emb_dim": 2048}, TRAIN_B, 32, True, 2),
    "streamed cell-1 weights, H1 1024, H2 512, P 1024, 1 head": (
        H, {"dec_lstm_hid_dim": 1024, "dec_lstm_out_dim": 512, "att_proj_dim": 1024,
            "dec_emb_dim": 2048}, TRAIN_B, 32, True, 1),
    "streamed cell-1 weights, H1 1024, H2 512, P 1024, 4 heads": (
        H, {"dec_lstm_hid_dim": 1024, "dec_lstm_out_dim": 512, "att_proj_dim": 1024,
            "dec_emb_dim": 2048, "att_heads": 4}, TRAIN_B, 32, True, 1),
}


def bf16_speller_check(torch, card: str, label: str) -> None:
    """The bf16 speller kernels at ``BF16_SPELLER_CHECKS[label]``: the eval
    form (where asked) against its plain version forced along its ids
    (``SPELLER_TOL``), the training form's streams and the adjoint's, with
    and without a cotangent on the weights, against their plain versions
    (``SPELLER_TRAIN_TOL``); the forward's launches a call as the check
    states them (asserted against the plan), the adjoint's one."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
        las_config_from_dicts,
        las_init,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    width, changes, batch, steps, eval_form, fwd_launches = BF16_SPELLER_CHECKS[label]
    gen = torch.Generator().manual_seed(SEED + 5)
    cfg = las_config_from_dicts(
        {**BASE_LAS_MODEL["listener_configs"], "uniform_hid_dim": width},
        {**BASE_LAS_MODEL["speller_configs"], **changes})
    spl = cfg.speller
    vocab = spl.dec_vocab_size
    params = las_init(cfg, gen)["speller"].to(DEVICE)
    lengths = torch.randint(1, TE_DEC + 1, (batch,), generator=gen)
    lengths[0], lengths[1] = TE_DEC, 1
    enc = torch.randn(batch, TE_DEC, cfg.listener.enc_out_dim, generator=gen) * 0.5
    enc[torch.arange(TE_DEC)[None, :] >= lengths[:, None]] = 0.0
    keep = 1.0 - spl.dec_lstm_dropout
    m1, m2 = (((torch.rand(steps, batch, h, generator=gen) < keep).to(torch.bfloat16) / keep)
              .to(DEVICE) for h in (spl.dec_lstm_hid_dim, spl.dec_lstm_out_dim))
    errs, eval_errs = {}, ""
    with torch.no_grad():
        operands, _ = sc.decode_operands(params, spl, enc.to(torch.bfloat16).to(DEVICE),
                                         lengths.to(DEVICE))
        opts = {**sc.decode_options(spl), "steps": steps}
        sc.reset_launch_counts()
        if eval_form:
            logits, wgts, ids = sc.speller_decode(*operands, **opts)
            own = torch.cat([torch.full_like(ids[:1], -1), ids[:-1]]).contiguous()
            p_logits, p_wgts, _ = sc.speller_decode_plain(*operands, **opts, forced=own)
            tol, w_tol = SPELLER_TOL["bfloat16"]
            err = (logits[..., :vocab].float() - p_logits[..., :vocab].float()).abs().max().item()
            w_err = (wgts.float() - p_wgts.float()).abs().max().item()
            eval_errs = (f"eval logits max_abs_err {err:.3e} (tol {tol:g}), weights "
                         f"{w_err:.3e} (tol {w_tol:g}); ")
            if not (err <= tol and w_err <= w_tol):
                raise AssertionError(f"bf16 speller, {label}: eval errors {err}, {w_err}")
            del logits, wgts, ids, p_logits, p_wgts
        t_logits, t_wgts, _, saved = sc.speller_decode_train(*operands, **opts, m1=m1, m2=m2)
        tp_logits, tp_wgts, _, tp_saved = sc.speller_decode_train_plain(
            *operands, **opts, forced=saved[0], m1=m1, m2=m2)
        errs = {"logits": rel_err(t_logits[..., :vocab], tp_logits[..., :vocab]),
                "weights": rel_err(t_wgts, tp_wgts)}
        errs.update({n: rel_err(a, b) for n, a, b in
                     zip(sc.RESIDUALS[1:], saved[1:], tp_saved[1:])})
        del tp_logits, tp_wgts, tp_saved
        k, v, _, _, _, c10, _, c20, _, wc1, whh1, wih2, whh2, _, wq = operands[:15]
        _, gates1, c1, _, gates2, c2, _, _ = saved
        dqup, dctxup = ((torch.randn(steps, batch, spl.att_proj_dim, generator=gen) * 0.1)
                        .to(DEVICE, torch.bfloat16) for _ in range(2))
        dwup = (torch.randn(*t_wgts.shape, generator=gen) * 0.1).to(DEVICE, torch.bfloat16)
        bwd_args = (k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1, gates2, c2,
                    t_wgts, m1, m2, dqup, dctxup)
        kw = {"heads": opts["heads"], "scale": opts["scale"]}
        for tag, dw in (("", None), (" (weights' cotangent)", dwup)):
            got = sc.speller_decode_bwd(*bwd_args, dw, **kw)
            want = sc.speller_decode_bwd_plain(*bwd_args, dw, **kw)
            errs.update({n + tag: rel_err(a, b) for n, a, b in zip(BWD_NAMES, got, want)})
            del got, want
        torch.cuda.synchronize()
    counts = dict(sc.LAUNCHES)
    lim = sc.tc_kernel_limits(0)
    plan = sc.plan_decode_tc(batch, TE_DEC, spl.att_proj_dim, spl.att_heads,
                             spl.dec_lstm_hid_dim, spl.dec_lstm_out_dim, operands[8].shape[0],
                             lim["sms"], lim["smem_optin"])
    spans = ""
    # the streamed form exactly where the label says so: a block whose
    # resident tiles fit keeps them
    if plan.streamed != label.startswith("streamed"):
        raise AssertionError(f"bf16 speller, {label}: the plan's form (streamed "
                             f"{plan.streamed}) is not the check's")
    if fwd_launches > 1 or plan.streamed:  # the eval form over the whole decode, timed
        with torch.no_grad():
            opts = {**opts, "steps": spl.CHR_MAX_STEPS}
            ms = cuda_median_ms(torch, lambda: sc.speller_decode(*operands, **opts), 5)
            span = plan.launches[0].r1
            # the batch-major operands (k .. c20) cut to the first span
            first = [t[:span].contiguous() for t in operands[:8]] + list(operands[8:])
            ms_one = (cuda_median_ms(torch, lambda: sc.speller_decode(*first, **opts), 5)
                      if fwd_launches > 1 else ms)
            plain_ms = cuda_median_ms(
                torch, lambda: sc.speller_decode_plain(*operands, **opts), 1)
        proj, h1, h2 = spl.att_proj_dim, spl.dec_lstm_hid_dim, spl.dec_lstm_out_dim
        per_row = 2 * ((proj + h1) * 4 * h1 + (h1 + h2) * 4 * h2 + h2 * proj
                       + 2 * proj * vocab)
        flops = spl.CHR_MAX_STEPS * (batch * per_row + 4 * proj * int(lengths.sum()))
        out_bytes = spl.CHR_MAX_STEPS * batch * (operands[8].shape[0] * 2
                                                 + spl.att_heads * TE_DEC * 2 + 4)
        bound, bound_by = bound_ms(flops, nbytes(*operands) + out_bytes, "bfloat16")
        spans = (f"; eval form ({'streamed' if plan.streamed else 'resident'} cell-1 "
                 f"weights, {plan.launches[0].stages} ring stages of "
                 f"{plan.launches[0].smem} bytes a block) over {spl.CHR_MAX_STEPS} steps in "
                 f"spans {[(ln.r0, ln.r1) for ln in plan.launches]}: {ms:.3f} ms, one "
                 f"{span}-row span alone {ms_one:.3f} ms, plain {plain_ms:.3f} ms, bound "
                 f"{bound:.3f} ms ({bound_by})")
    worst = max(errs, key=lambda n: errs[n][1])
    log(f"[{card}] bf16 speller, {label} (H1 {spl.dec_lstm_hid_dim}, H2 "
        f"{spl.dec_lstm_out_dim}, P {spl.att_proj_dim}, heads {spl.att_heads}) B={batch} "
        f"Te={TE_DEC} L={steps}: {eval_errs}train + adjoint, {len(errs)} tensors, largest "
        f"{errs[worst][1]:.1e} of max ({worst}; tolerance {SPELLER_TRAIN_TOL['bfloat16']:g}); "
        f"launches {counts}{spans}")
    if len(plan.launches) != fwd_launches:
        raise AssertionError(f"bf16 speller, {label}: plan {plan.launches}")
    want_counts = {"speller_decode": int(eval_form) * fwd_launches,
                   "speller_decode_train": fwd_launches, "speller_decode_bwd": 2,
                   "speller_additive_scores": 0, "speller_additive_scores_bwd": 0}
    if counts != want_counts:
        raise AssertionError(f"bf16 speller, {label}: launches {counts}, not {want_counts}")
    bad = {n: r for n, (_, r) in errs.items() if not r <= SPELLER_TRAIN_TOL["bfloat16"]}
    if bad:
        raise AssertionError(f"bf16 speller, {label}: errors over tolerance: {bad}")


def forward_launches(torch, dtype, batch: int, hidden: int, in_dim: int = 0) -> int:
    """Launches of a two-direction forward call, from the plan
    (``lstm_cuda.plan_launches``): bfloat16 one per 128 rows, both
    directions in each at every width up to 1024; float32 every row and both
    directions in one launch up to H=512 at the main paths' batches (B <=
    256; the Rewriter's B=256 at H=256 included), one a direction at H=1024.
    Both asserted against the plan."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = lc.plan_launches("forward", dtype, batch, hidden, 2, sms, in_dim)
    if dtype == torch.bfloat16:
        want = len(lc.row_chunks(batch, 128))
        ok = len(plan) == want and all(ln.nd == 2 for ln in plan)
    else:
        want = 2 if hidden > H else 1
        ok = batch > 256 or (len(plan) == want and all(ln.r1 - ln.r0 == batch for ln in plan))
    if not ok:
        raise AssertionError(f"forward B={batch} H={hidden} {dtype}: plan {plan}, not "
                             f"{want} launches")
    return len(plan)


def adjoint_launches(torch, dtype, batch: int, hidden: int, with_dw: bool) -> int:
    """Launches of a two-direction adjoint call, from the plan
    (``lstm_cuda.plan_bwd_launches``): bfloat16 one per 128 rows with both
    directions; float32 every row in one launch up to the train batch (B <=
    128), both directions in it up to H=512 and one launch a direction at
    H=1024. Both asserted against the plan."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = lc.plan_bwd_launches("adjoint", dtype, batch, hidden, 2, sms, with_dw)
    spans = [(ln.r0, ln.r1, ln.d0, ln.nd) for ln in plan]
    if dtype == torch.bfloat16:
        ok = len(plan) == len(lc.row_chunks(batch, 128)) and all(ln.nd == 2 for ln in plan)
    else:
        ok = batch > TRAIN_B or spans == (
            [(0, batch, 0, 2)] if hidden <= H else [(0, batch, 0, 1), (0, batch, 1, 1)])
    if not ok:
        raise AssertionError(f"adjoint B={batch} H={hidden} {dtype}: plan {plan}")
    return len(plan)


def ragged_lengths(torch, gen, batch: int, low: int, high: int):
    """Lengths in [low, high] with a full row and a length-``low`` row in
    every B (32) rows: in every row group of the float32 kernels and every
    launch of the bfloat16 ones."""
    lengths = torch.randint(low, high + 1, (batch,), generator=gen)
    for r0 in range(0, batch, B):
        lengths[r0], lengths[min(r0 + 1, batch - 1)] = high, low
    return lengths.to(torch.int32)


def rel_err(got, ref) -> tuple:
    """(max-abs error, the same over the largest magnitude of ``ref``)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


CELL_B = 96  # the benchmark cell's batch (benchmark/configs/base-las.json)


# Chiu et al. 2018's LAS (configs/chiu-las.yml): the additive score at its
# cell's shapes (B 128, Te 384 and 512 stacked frames, 4 heads of 256)
ADDITIVE_SOURCE = "attention_based_e2e_asr_dnn_tpu_torch/csrc/speller_additive.cu"
ADDITIVE_SHAPES = ((128, 512, 4, 256), (128, 384, 4, 256))
# bf16, of the largest magnitude: the kernel sums in fp32 in another order
# than the plain version, its tanh is tanh.approx.f32 (~2^-11 relative) and
# the outputs are rounded to bf16, so an entry may land one bf16 step off:
# 2^-7 of a score near 1.5 (measured 5.1e-3 on the scores, 2.4e-3 on dq,
# 3.3e-3 on dk, 2.8e-4 on dv)
ADDITIVE_TOL = 2.0 ** -7
CHIU_STEP = (128, 1536, 256)  # batch, frames, labels: the cell's longer shape


def chiu_model() -> dict:
    """The model block of configs/chiu-las.yml."""
    import yaml

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                           "chiu-las.yml")) as fh:
        return yaml.safe_load(fh)["model"]["configs"]


def additive_score_phase(torch, card: str) -> dict:
    """The additive score's forward and adjoint (ops/speller_additive.py)
    against their plain versions at the chiu-las cell's shapes, timed by
    CUDA events over calls issued back to back (``queued_ms``; the
    adjoint's time holds its wrapper's sum of dv over the batch) beside
    their bound (bytes over 3.35 TB/s: k at the valid frames, q, v, the
    scores; the adjoint also dk whole, ds, dq and dv); then 1 + 2 chiu-las
    train steps at the published widths, which take the step loop
    (``models/additive_decode.py``: the first step captures its two loops,
    the others replay them) and launch each kernel once a decode step and
    once for the initial query. Returns the JSON records."""
    from attention_based_e2e_asr_dnn_tpu_torch.models import las
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_additive as sa
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
    from attention_based_e2e_asr_dnn_tpu_torch.training.optim import build_optimizer
    from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
        create_train_state, make_train_step)

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 26)
    records = {}
    for batch, te, heads, d in ADDITIVE_SHAPES:
        bf = torch.bfloat16
        q = (torch.rand(batch, heads, d, generator=gen, device=DEVICE) * 2 - 1).to(bf)
        k = (torch.rand(batch, te, heads, d, generator=gen, device=DEVICE) * 2 - 1).to(bf)
        v = ((torch.rand(heads, d, generator=gen, device=DEVICE) * 2 - 1) / d ** 0.5).to(bf)
        lx = torch.randint(te * 237 // 512, te + 1, (batch,), generator=gen, device=DEVICE)
        lx[0] = te
        mask = torch.arange(te, device=DEVICE)[None, :] >= lx[:, None]
        ds = torch.randn(batch, heads, te, generator=gen, device=DEVICE).to(bf)
        sc.reset_launch_counts()
        got = (sa.additive_scores_forward(q, k, v, mask),
               *sa.additive_scores_backward(q, k, v, mask, ds))
        want = (sa.additive_scores_plain(q, k, v, mask),
                *sa.additive_scores_bwd_plain(q, k, v, mask, ds))
        torch.cuda.synchronize()
        if (sc.LAUNCHES["speller_additive_scores"], sc.LAUNCHES["speller_additive_scores_bwd"]) != (1, 1):
            raise AssertionError(f"additive score: {dict(sc.LAUNCHES)} launches, not one a call")
        pad = mask[:, None, :].expand(batch, heads, te)
        if not bool((got[0][pad] == want[0][pad]).all()) or not bool((got[2][mask] == 0).all()):
            raise AssertionError("additive score: padded frames not masked as the plain version")
        errs = {"scores": rel_err(got[0][~pad], want[0][~pad])}
        errs.update({n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:])})
        bad = {n: r for n, (_, r) in errs.items() if not r <= ADDITIVE_TOL}
        if bad:
            raise AssertionError(f"additive score B={batch} Te={te}: errors over "
                                 f"{ADDITIVE_TOL} of max: {bad}")
        valid, small = float(lx.sum()) * heads * d, batch * heads * d + heads * d
        fwd_bytes = 2 * (valid + small + batch * heads * te)
        bwd_bytes = 2 * (valid + batch * te * heads * d + 2 * small + batch * heads * te)
        fwd_ms = queued_ms(torch, lambda: sa.additive_scores_forward(q, k, v, mask))
        bwd_ms = queued_ms(torch, lambda: sa.additive_scores_backward(q, k, v, mask, ds))
        once_ms = (cuda_median_ms(torch, lambda: sa.additive_scores_forward(q, k, v, mask), 20),
                   cuda_median_ms(torch, lambda: sa.additive_scores_backward(q, k, v, mask, ds),
                                  20))
        plain_fwd_ms = cuda_median_ms(torch, lambda: sa.additive_scores_plain(q, k, v, mask), 5)
        plain_bwd_ms = cuda_median_ms(
            torch, lambda: sa.additive_scores_bwd_plain(q, k, v, mask, ds), 5)
        bounds = (fwd_bytes / 3.35e9, bwd_bytes / 3.35e9)
        log(f"  additive score B={batch} Te={te} {heads}x{d} bf16: forward {fwd_ms:.4f} ms "
            f"(bound {bounds[0]:.4f}, plain {plain_fwd_ms:.4f}), adjoint {bwd_ms:.4f} ms "
            f"(bound {bounds[1]:.4f}, plain {plain_bwd_ms:.4f}); one call after a sync "
            f"{once_ms[0]:.4f} / {once_ms[1]:.4f} ms; errors {errs}")
        if te == ADDITIVE_SHAPES[0][1]:
            for name, ms, plain_ms, bound, keys in (
                    ("speller_additive_scores", fwd_ms, plain_fwd_ms, bounds[0], ("scores",)),
                    ("speller_additive_scores_bwd", bwd_ms, plain_bwd_ms, bounds[1],
                     ("dq", "dk", "dv"))):
                records[name] = {"name": name, "route": "cuda", "source": ADDITIVE_SOURCE,
                                 "replaces": None, "launches": 0,
                                 "max_abs_err": max(errs[n][0] for n in keys), "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                                 "library_ms": None}
        del q, k, v, ds, got, want
        torch.cuda.empty_cache()

    model = chiu_model()
    cfg = las.las_config_from_dicts(model["listener_configs"], model["speller_configs"])
    params = las.las_init(cfg, torch.Generator().manual_seed(SEED + 27))
    opt = build_optimizer("adamw", {"lr": 1e-3, "weight_decay": 5e-6, "amsgrad": True},
                          grad_norm=5.0)
    state = create_train_state(params, opt, seed=SEED, device=DEVICE)
    step = make_train_step(lambda p, x, lx, **kw: las.las_apply(p, cfg, x, lx, **kw), opt,
                           compute_dtype=torch.bfloat16, use_specaug=True)
    batch, t_pad, labels = CHIU_STEP
    x = torch.randn(batch, t_pad, cfg.listener.input_dim, generator=gen, device=DEVICE)
    lx = torch.randint(t_pad * 3 // 4, t_pad + 1, (batch,), generator=gen, device=DEVICE)
    x = x * (torch.arange(t_pad, device=DEVICE)[None, :, None] < lx[:, None, None])
    ly = torch.randint(labels * 3 // 4, labels + 1, (batch,), generator=gen, device=DEVICE)
    y = torch.randint(1, 29, (batch, labels), generator=gen, device=DEVICE)
    y = torch.where(torch.arange(labels, device=DEVICE)[None, :] < ly[:, None], y, 29)
    las.reset_decode_routes()
    step(state, x, lx.int(), y.int(), ly.int(), 0.9, 1e-3)
    torch.cuda.synchronize()
    lstm_cuda.reset_launch_counts()
    sc.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(2):
        _, m, _ = step(state, x, lx.int(), y.int(), ly.int(), 0.9, 1e-3)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 2
    counts = {k: n for k, n in {**lstm_cuda.LAUNCHES, **sc.LAUNCHES}.items() if n}
    layers = 2 * cfg.listener.lstm_layers  # two steps: the x_proj forward and #6 a layer
    want = {"lstm_scan_train": layers, "lstm_bwd": layers,
            "speller_additive_scores": 2 * (labels + 1),
            "speller_additive_scores_bwd": 2 * (labels + 1)}
    routes = las.decode_route_report()
    if counts != want or set(routes.values()) != {"scan"} or not bool(torch.isfinite(m["loss"])):
        raise AssertionError(f"chiu-las steps: launches {counts} != {want}, routes {routes}, "
                             f"loss {float(m['loss'])}")
    log(f"  chiu-las train step B={batch} T={t_pad} L={labels}: {step_s:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated()} B, loss {float(m['loss']):.4f}, launches {counts}")
    for name in records:
        records[name]["launches"] = counts[name]
    del state, step, params
    gc.collect()
    torch.cuda.empty_cache()
    return records


def cell_adjoint_check(torch, card: str, hidden: int) -> None:
    """The bfloat16 adjoint at the benchmark cell's batch, B=96, T=1536:
    two row groups of 48 rows, each a chain of its own (its own counter and
    tensor map; group 1's partial dW_hh added by group 0). ``lstm_bwd_dw``
    and ``lstm_bwd`` against their plain versions within ``TRAIN_TOL``, the
    two forms' dpre bit-equal, one launch a call in two row groups; twice,
    each group in turn the shorter chain (its rows run to at most two thirds
    of the frames), with a length-1 and a longest row in each group."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc

    batch, seq_len, rev, dtype = CELL_B, TRAIN_T, (False, True), torch.bfloat16
    tol = TRAIN_TOL["bfloat16"]
    gen = torch.Generator().manual_seed(SEED + 7 + hidden)
    k = 1.0 / hidden ** 0.5
    four_h = 4 * hidden
    w_hh = ((torch.rand(2, hidden, four_h, generator=gen) * 2 - 1) * k).to(DEVICE, dtype)
    x_proj = ((torch.rand(batch, seq_len, 2 * four_h, generator=gen) - 0.5)).to(DEVICE, dtype)
    dy = torch.randn(batch, seq_len, 2 * hidden, generator=gen).to(DEVICE, dtype)
    n_adjoint = adjoint_launches(torch, dtype, batch, hidden, True)
    half = batch // 2
    for short in (0, 1):
        lengths = torch.randint(1, seq_len + 1, (batch,), generator=gen)
        for g in (0, 1):
            high = seq_len * 2 // 3 if g == short else seq_len
            rows = lengths[g * half:(g + 1) * half]
            rows.clamp_(max=high)
            rows[0], rows[-1] = high, 1
        lengths = lengths.to(torch.int32).to(DEVICE)
        hs, cs, gates = lc.lstm_scan_train(x_proj, w_hh, lengths, rev)
        lc.reset_launch_counts()
        dpre, d_whh = lc.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev)
        nodw = lc.lstm_bwd(gates, cs, dy, w_hh, lengths, rev)
        torch.cuda.synchronize()
        counts, row_groups = dict(lc.LAUNCHES), dict(lc.ADJOINT_ROW_GROUPS)
        if (counts["lstm_bwd_dw"] != n_adjoint or counts["lstm_bwd"] != n_adjoint
                or n_adjoint != 1
                or row_groups != {**dict.fromkeys(row_groups, 0), 2: 2 * n_adjoint}):
            raise AssertionError(f"adjoint B={batch} H={hidden}: launches {counts}, by row "
                                 f"groups {row_groups}; not one a call in two row groups")
        p_dpre, p_dwhh = lc.lstm_bwd_dw_plain(gates, cs, hs, dy, w_hh, lengths, rev)
        p_nodw = lc.lstm_bwd_plain(gates, cs, dy, w_hh, lengths, rev)
        pads = torch.arange(seq_len, device=DEVICE)[None, :] >= lengths[:, None].long()
        errs = {"dpre": rel_err(dpre, p_dpre), "dW_hh": rel_err(d_whh, p_dwhh),
                "lstm_bwd dpre": rel_err(nodw, p_nodw)}
        log(f"[{card}] lstm_bwd_dw + lstm_bwd bfloat16 B={batch} T={seq_len} H={hidden} "
            f"(the cell's batch; row group {short} the shorter chain): launches {counts}, by "
            f"row groups {row_groups}; max_abs_err "
            + ", ".join(f"{n} {a:.3e} ({r:.1e} of max)" for n, (a, r) in errs.items())
            + f"; tolerance {tol:g} of max")
        if not torch.equal(nodw, dpre):
            raise AssertionError(f"B={batch}: lstm_bwd's dpre differs from lstm_bwd_dw's")
        if dpre[pads].abs().max().item() != 0.0:
            raise AssertionError(f"B={batch}: non-zero dpre at padded frames")
        bad = {n: r for n, (_, r) in errs.items() if not r <= tol}
        if bad:
            raise AssertionError(f"adjoint B={batch}: errors over {tol} of max: {bad}")
        del hs, cs, gates, dpre, d_whh, nodw, p_dpre, p_dwhh, p_nodw


def train_kernel_phase(torch, card: str, hidden: int = H) -> dict:
    """The training forward and the adjoint against their plain versions at
    the train step's shapes and listener width ``hidden``; returns the JSON
    records (bfloat16). Up to H=512 the adjoint is ``lstm_bwd_dw``, and
    ``lstm_bwd`` with the outside dW_hh product is held against it; at
    scaled-LAS's H=1024 the adjoint is ``lstm_bwd`` with that product (a
    launch a direction), and the lean forward kernels are recorded too: they
    are the first pass of a ``remat`` layer."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc

    gen = torch.Generator().manual_seed(SEED + 1 + hidden)
    records = {}
    batch, rev = TRAIN_B, (False, True)
    wide = hidden > H
    four_h = 4 * hidden
    for name, (seq_len, fused, replaces, lean_name, lean_replaces) in TRAIN_KERNELS.items():
        in_dim = 15 if fused else 2 * 2 * hidden
        lengths = ragged_lengths(torch, gen, batch, 1, seq_len).to(DEVICE)
        k = 1.0 / hidden ** 0.5
        w_hh32 = ((torch.rand(2, hidden, four_h, generator=gen) * 2 - 1) * k).to(DEVICE)
        w_ih32 = ((torch.rand(2, in_dim, four_h, generator=gen) * 2 - 1) * k).to(DEVICE)
        b32 = ((torch.rand(2, four_h, generator=gen) * 2 - 1) * k).to(DEVICE)
        x32 = torch.randn(batch, seq_len, in_dim, generator=gen).to(DEVICE)
        dy32 = torch.randn(batch, seq_len, 2 * hidden, generator=gen).to(DEVICE)
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            tol = TRAIN_TOL[dtype_name]
            # the adjoint's launches: lstm_bwd_dw up to H=512, lstm_bwd above
            n_adjoint = adjoint_launches(torch, dtype, batch, hidden, not wide)
            w_hh, dy = w_hh32.to(dtype), dy32.to(dtype)
            if fused:
                x = x32.to(dtype)
                w_ih, b = w_ih32.to(dtype), b32.to(dtype)
                args = (x, w_ih, b, w_hh)
                lean, train, plain, lean_plain = (
                    lc.lstm_scan_fusedin, lc.lstm_scan_fusedin_train,
                    lc.lstm_scan_fusedin_train_plain, lc.lstm_scan_fusedin_plain)
            else:
                x = (x32.clamp(-1, 1) * 0.5).to(dtype)
                w_cat = torch.cat([w_ih32[0], w_ih32[1]], dim=1).to(dtype)
                args = (torch.matmul(x, w_cat) + torch.cat([b32[0], b32[1]]).to(dtype), w_hh)
                lean, train, plain, lean_plain = (lc.lstm_scan, lc.lstm_scan_train,
                                                  lc.lstm_scan_train_plain, lc.lstm_scan_plain)
            lc.reset_launch_counts()
            hs, cs, gates = train(*args, lengths, rev)
            if wide:
                dpre = lc.lstm_bwd(gates, cs, dy, w_hh, lengths, rev)
                d_whh = lc.dw_hh_outside(hs, dpre, rev)
            else:
                dpre, d_whh = lc.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev)
            torch.cuda.synchronize()
            adjoint = "lstm_bwd" if wide else "lstm_bwd_dw"
            n_launch = forward_launches(torch, dtype, batch, hidden, in_dim if fused else 0)
            if lc.LAUNCHES[name] != n_launch or lc.LAUNCHES[adjoint] != n_adjoint:
                raise AssertionError(f"{name}: B={batch} took {dict(lc.LAUNCHES)} launches, "
                                     f"not {n_launch} (forward) and {n_adjoint} (adjoint)")
            with torch.no_grad():
                if not torch.equal(hs, lean(*args, lengths, rev)):
                    raise AssertionError(f"{name} {dtype_name}: hs differs from the lean kernel's")
            # the plain versions run once: compared below, and timed here
            (p_hs, p_cs, p_gates), plain_fwd_ms = timed_ms(
                torch, lambda: plain(*args, lengths, rev))
            if wide:
                p_dpre, plain_bwd_ms = timed_ms(
                    torch, lambda: lc.lstm_bwd_plain(gates, cs, dy, w_hh, lengths, rev))
                # the product's reference: float32 operands, the plain dpre
                p_dwhh = lc.dw_hh_outside(hs.float(), p_dpre.float(), rev)
            else:
                (p_dpre, p_dwhh), plain_bwd_ms = timed_ms(
                    torch, lambda: lc.lstm_bwd_dw_plain(gates, cs, hs, dy, w_hh, lengths, rev))
            torch.cuda.synchronize()
            pads = torch.arange(seq_len, device=DEVICE)[None, :] >= lengths[:, None].long()
            if dpre[pads].abs().max().item() != 0.0 or gates[pads].abs().max().item() != 0.0:
                raise AssertionError(f"{name} {dtype_name}: non-zero dpre or gates at "
                                     f"padded frames")
            errs = {"hs": rel_err(hs, p_hs), "cs": rel_err(cs, p_cs),
                    "gates": rel_err(gates, p_gates), "dpre": rel_err(dpre, p_dpre),
                    "dW_hh": rel_err(d_whh, p_dwhh)}
            same_dpre = None
            if not wide:
                # the adjoint without dW_hh at this width: its dpre against
                # lstm_bwd_dw's, the outside product against the sum in the kernel
                nodw = lc.lstm_bwd(gates, cs, dy, w_hh, lengths, rev)
                same_dpre = torch.equal(nodw, dpre)
                errs["lstm_bwd dpre vs lstm_bwd_dw"] = rel_err(nodw, dpre)
                errs["outside dW_hh vs in-kernel"] = rel_err(lc.dw_hh_outside(hs, nodw, rev),
                                                             d_whh)
                errs["lstm_bwd dpre"] = rel_err(nodw, p_dpre)
                if lc.LAUNCHES["lstm_bwd"] != adjoint_launches(torch, dtype, batch, hidden, False):
                    raise AssertionError(f"lstm_bwd: {dict(lc.LAUNCHES)} launches")
                # one body for both forms in each dtype: dW_hh never touches dh's sums
                if not same_dpre:
                    raise AssertionError(f"{name}: {dtype_name} lstm_bwd's dpre differs from "
                                         f"lstm_bwd_dw's")
                del nodw
            if fused:
                # the fused-input Function's own products over the kernel's dpre,
                # against the same products over the plain dpre
                leaves = [a.clone().requires_grad_(True) for a in args]
                got = torch.autograd.grad(lc.lstm_scan_fusedin(*leaves, lengths, rev),
                                          leaves, dy)
                x2 = x.reshape(-1, in_dim)
                for d in range(2):
                    dp = p_dpre[..., d * four_h:(d + 1) * four_h].reshape(-1, four_h)
                    part = (dp @ w_ih[d].T).reshape(x.shape)
                    want_x = part if d == 0 else want_x + part
                    errs[f"d_wih[{d}]"] = rel_err(got[1][d], x2.T @ dp)
                    errs[f"d_b[{d}]"] = rel_err(got[2][d], dp.sum(0, dtype=torch.float32))
                errs["d_x"] = rel_err(got[0], want_x)
                del leaves, got, want_x, part, dp
            reps = 5 if wide else 10
            fwd_ms = cuda_median_ms(torch, lambda: train(*args, lengths, rev), reps)
            bwd_dw_ms = None if wide else cuda_median_ms(
                torch, lambda: lc.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev), reps)
            bwd_ms = cuda_median_ms(
                torch, lambda: lc.lstm_bwd(gates, cs, dy, w_hh, lengths, rev), reps)
            dw_ms = cuda_median_ms(torch, lambda: lc.dw_hh_outside(hs, dpre, rev), 5)
            frames = int(lengths.sum())
            fwd_flops = 2 * frames * 2 * four_h * (hidden + (in_dim if fused else 0))
            fwd_bound = bound_ms(fwd_flops, valid_bytes(frames, args[0])
                                 + nbytes(*args[1:], lengths, hs, cs, gates), dtype)
            # dh_prev = dpre @ W_hh^T: 2 * 4H * H a frame and direction; the
            # kernel that also sums dW_hh += h^T dpre does as much again
            nodw_flops = 2 * frames * 2 * four_h * hidden
            nodw_bound = bound_ms(nodw_flops, valid_bytes(frames, gates, cs, dy)
                                  + nbytes(w_hh, lengths, dpre), dtype)
            dw_bound = bound_ms(2 * nodw_flops, valid_bytes(frames, gates, cs, hs, dy)
                                + nbytes(w_hh, lengths, dpre, d_whh), dtype)
            lib_fwd = nn_lstm_ms(torch, x, lengths, dtype, "train", hidden)
            lib_bwd = nn_lstm_ms(torch, x, lengths, dtype, "backward", hidden)
            shown = ", ".join(f"{k} {a:.3e} ({r:.1e} of max)" for k, (a, r) in errs.items())
            log(f"[{card}] {name} + {adjoint} {dtype_name} B={batch} ({n_launch} + {n_adjoint} "
                f"launches) "
                f"T={seq_len} D={in_dim} H={hidden} 2 dirs: hs bit-equal to the lean kernel; "
                f"max_abs_err {shown}; tolerance {tol:g} of max"
                + ("" if same_dpre is None else
                   f"; lstm_bwd's dpre bit-equal to lstm_bwd_dw's: {same_dpre}"))
            log(f"    forward kernel {fwd_ms:.3f} ms  plain {plain_fwd_ms:.3f} ms  bound "
                f"{fwd_bound[0]:.3f} ms ({fwd_bound[1]})  nn.LSTM forward {fmt_ms(lib_fwd)} ms")
            log(f"    adjoint: lstm_bwd {bwd_ms:.3f} ms (bound {nodw_bound[0]:.3f} ms, "
                f"{nodw_bound[1]}; {nodw_flops:.3e} operations); lstm_bwd_dw "
                f"{fmt_ms(bwd_dw_ms)} ms (bound {dw_bound[0]:.3f} ms, {dw_bound[1]}); plain "
                f"{plain_bwd_ms:.3f} ms; nn.LSTM backward {fmt_ms(lib_bwd)} ms")
            log(f"    outside dW_hh product (dw_hh_outside, one torch.mm a direction over "
                f"{batch} x {seq_len - 1} rows): {dw_ms:.3f} ms")
            bad = {k: r for k, (_, r) in errs.items() if not r <= tol}
            if bad:
                raise AssertionError(f"{name} {dtype_name}: errors over {tol} of max: {bad}")
            if dtype_name == "float32" and fused:
                # the float32 adjoint's record at its largest shape; its launches
                # are the float32 parity steps' (phases 9 and 10)
                records[f32_adjoint_name(hidden)] = {
                    "name": f32_adjoint_name(hidden), "route": "cuda", "source": BWD_SOURCE,
                    "replaces": PALLAS + (":311" if wide else ":382"), "launches": 0,
                    "max_abs_err": errs["dpre"][0], "ms": bwd_ms if wide else bwd_dw_ms,
                    "plain_ms": plain_bwd_ms,
                    "bound_ms": (nodw_bound if wide else dw_bound)[0],
                    "bound_by": (nodw_bound if wide else dw_bound)[1],
                    "library_ms": lib_bwd}
            if dtype_name == "bfloat16":
                records[at_width(name, hidden)] = {
                    "name": at_width(name, hidden), "route": "cuda", "source": TC_SOURCE,
                    "replaces": replaces,
                    "launches": 0, "max_abs_err": max(errs["cs"][0], errs["gates"][0]),
                    "ms": fwd_ms, "plain_ms": plain_fwd_ms, "bound_ms": fwd_bound[0],
                    "bound_by": fwd_bound[1], "library_ms": lib_fwd}
                # the lean kernels at the train batch (at H=1024 remat's first pass)
                with torch.no_grad():
                    lean_ms = cuda_median_ms(torch, lambda: lean(*args, lengths, rev), reps)
                    lean_plain_ms = cuda_median_ms(
                        torch, lambda: lean_plain(*args, lengths, rev), 1)
                lean_bound = bound_ms(fwd_flops, valid_bytes(frames, args[0])
                                      + nbytes(*args[1:], lengths, hs), dtype)
                lib_lean = nn_lstm_ms(torch, x, lengths, dtype, "infer", hidden)
                log(f"    lean kernel {lean_name} {lean_ms:.3f} ms  plain "
                    f"{lean_plain_ms:.3f} ms  bound {lean_bound[0]:.3f} ms "
                    f"({lean_bound[1]})  nn.LSTM under no_grad {fmt_ms(lib_lean)} ms")
                if wide:  # a row: remat's first pass; at H=512 no main path runs them at B=128
                    records[at_width(lean_name, hidden)] = {
                        "name": at_width(lean_name, hidden), "route": "cuda", "source": TC_SOURCE,
                        "replaces": lean_replaces, "launches": 0, "max_abs_err": errs["hs"][0],
                        "ms": lean_ms, "plain_ms": lean_plain_ms, "bound_ms": lean_bound[0],
                        "bound_by": lean_bound[1], "library_ms": lib_lean}
                if fused and not wide:  # the adjoint's record at its largest shape
                    records["lstm_bwd_dw"] = {
                        "name": "lstm_bwd_dw", "route": "cuda", "source": BWD_TC_SOURCE,
                        "replaces": PALLAS + ":382", "launches": 0,
                        "max_abs_err": errs["dpre"][0], "ms": bwd_dw_ms,
                        "plain_ms": plain_bwd_ms,
                        "bound_ms": dw_bound[0], "bound_by": dw_bound[1],
                        "library_ms": lib_bwd}
                if fused and wide:
                    records["lstm_bwd"] = {
                        "name": "lstm_bwd", "route": "cuda", "source": BWD_TC_SOURCE,
                        "replaces": PALLAS + ":311", "launches": 0,
                        "max_abs_err": errs["dpre"][0], "ms": bwd_ms, "plain_ms": plain_bwd_ms,
                        "bound_ms": nodw_bound[0], "bound_by": nodw_bound[1],
                        "library_ms": lib_bwd}
            del hs, cs, gates, dpre, d_whh, p_hs, p_cs, p_gates, p_dpre, p_dwhh
            torch.cuda.empty_cache()
    if not wide:
        cell_adjoint_check(torch, card, hidden)
        torch.cuda.empty_cache()
    return records


# the fused-BiLSTM op at a listener layer's shapes: a pyramid layer's input
# is 2 x 2H = 1024 wide; (T, B) as serving and training give them
FUSED_IN_DIM = 2 * H
FUSED_CASES = ((768, 8), (768, 32), (768, 128), (1536, 32))
# the JSON rows' shapes: the serving batch, and the train batch
FUSED_RECORD_CASES = {(768, 32): "", (768, 128): " (B=128)"}


def fused_layer(torch, gen, dtype):
    """One listener layer's parameters at full width, seeded."""
    k = 1.0 / H ** 0.5

    def one():
        return {"w_ih": ((torch.rand(FUSED_IN_DIM, 4 * H, generator=gen) * 2 - 1) * k),
                "w_hh": ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) * k),
                "b": ((torch.rand(4 * H, generator=gen) * 2 - 1) * k)}

    return {d: {n: t.to(DEVICE, dtype) for n, t in one().items()} for d in ("fwd", "bwd")}


def op_grads(torch, fn, params, x, lengths, r):
    """(out, [d_x, then the six parameter gradients]) of ``sum(out * r)``."""
    leaves = {d: {n: t.detach().requires_grad_(True) for n, t in p.items()}
              for d, p in params.items()}
    xx = x.detach().requires_grad_(True)
    out = fn(leaves, xx, lengths)
    flat = [xx] + [t for p in leaves.values() for t in p.values()]
    return out.detach(), torch.autograd.grad((out.float() * r).sum(), flat)


def fused_kernel_phase(torch, card: str) -> tuple:
    """Kernels ``lstm_scan_cs`` (#3) and ``bilstm_scan_fused`` (#7) and the
    op ``bilstm_apply_fused`` at a listener layer's full width; returns the
    JSON records, each with the launches of its own shape's driven run. No
    YAML key of either
    package routes to these two kernels (the JAX package keeps the op beside
    its two-kernel BiLSTM as the small-batch variant), so their main path is
    the op itself, driven here forward and backward with the counts set to 0
    just before and read just after, apart from every comparison."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc

    gen = torch.Generator().manual_seed(SEED + 6)
    records, rev = {}, (False, True)
    names = ("d_x", "d_w_ih[fwd]", "d_w_hh[fwd]", "d_b[fwd]", "d_w_ih[bwd]", "d_w_hh[bwd]",
             "d_b[bwd]")
    driven = dict.fromkeys(("lstm_scan_cs", "bilstm_scan_fused", "lstm_bwd"), 0)
    for seq_len, batch in FUSED_CASES:
        lengths = ragged_lengths(torch, gen, batch, 1, seq_len).to(DEVICE)
        x32 = (torch.randn(batch, seq_len, FUSED_IN_DIM, generator=gen).clamp(-1, 1) * 0.5)
        r = torch.randn(batch, seq_len, 2 * H, generator=gen).to(DEVICE)
        params32 = fused_layer(torch, gen, torch.float32)
        pads = torch.arange(seq_len, device=DEVICE)[None, :] >= lengths[:, None].long()
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            tol = TRAIN_TOL[dtype_name]
            params = {d: {n: t.to(dtype) for n, t in p.items()} for d, p in params32.items()}
            x = x32.to(DEVICE, dtype)
            n_launch = forward_launches(torch, dtype, batch, H)
            n_adjoint = adjoint_launches(torch, dtype, batch, H, False)
            w_hh = torch.stack([params["fwd"]["w_hh"], params["bwd"]["w_hh"]])
            w_cat = torch.cat([params["fwd"]["w_ih"], params["bwd"]["w_ih"]], dim=1)
            x_proj = torch.matmul(x, w_cat) + torch.cat([params["fwd"]["b"], params["bwd"]["b"]])
            xp = torch.stack([x_proj[..., :4 * H], x_proj[..., 4 * H:].flip(1)], dim=0)
            xp = xp.permute(2, 0, 1, 3).contiguous()

            # --- the driven run: the public ops, counts read right after
            lc.reset_launch_counts()
            with forbid_plain():
                lc.lstm_scan_cs(x_proj, w_hh, lengths, rev)
                out, grads = op_grads(torch, lc.bilstm_apply_fused, params, x, lengths, r)
                torch.cuda.synchronize()
            counts = dict(lc.LAUNCHES)
            want = {**dict.fromkeys(counts, 0), "lstm_scan_cs": n_launch,
                    "bilstm_scan_fused": n_launch, "lstm_bwd": n_adjoint}
            if counts != want:
                raise AssertionError(f"fused op B={batch}: launches {counts} != {want}")
            for k in driven:
                driven[k] += counts[k]

            # --- #3: hs bit-equal to the lean kernel's, cs to the training kernel's
            hs3, cs3 = lc.lstm_scan_cs(x_proj, w_hh, lengths, rev)
            with torch.no_grad():
                same_hs = torch.equal(hs3, lc.lstm_scan(x_proj, w_hh, lengths, rev))
            same_cs = torch.equal(cs3, lc.lstm_scan_train(x_proj, w_hh, lengths, rev)[1])
            if not (same_hs and same_cs):
                raise AssertionError(f"lstm_scan_cs {dtype_name} B={batch} T={seq_len}: hs "
                                     f"bit-equal to lstm_scan's {same_hs}, cs bit-equal to "
                                     f"lstm_scan_train's {same_cs}")
            (p_hs3, p_cs3), plain3 = timed_ms(
                torch, lambda: lc.lstm_scan_cs_plain(x_proj, w_hh, lengths, rev))
            errs = {"#3 hs": rel_err(hs3, p_hs3), "#3 cs": rel_err(cs3, p_cs3)}

            # --- #7 against its plain version, every frame
            hs7, cs7 = lc.bilstm_scan_fused(xp, w_hh, lengths)
            torch.cuda.synchronize()
            (p_hs7, p_cs7), plain7 = timed_ms(
                torch, lambda: lc.bilstm_scan_fused_plain(xp, w_hh, lengths))
            errs.update({"#7 hs": rel_err(hs7, p_hs7), "#7 cs": rel_err(cs7, p_cs7)})
            if hs7.shape != (seq_len, 2, batch, H) or hs7.dtype != dtype:
                raise AssertionError(f"bilstm_scan_fused: output {tuple(hs7.shape)} {hs7.dtype}")
            # direction 0 holds the frozen carry on its pads (the length-1 row:
            # every later frame repeats frame 0), direction 1 zeros on its own
            row = 1
            pads1 = pads.flip(1).T                                       # (T, B)
            if not (torch.equal(hs7[-1, 0, row], hs7[0, 0, row])
                    and hs7[0, 0, row].abs().max().item() > 0
                    and torch.equal(cs7[-1, 0, row], cs7[0, 0, row])
                    and hs7[:, 1][pads1].abs().max().item() == 0.0
                    and cs7[:, 1][pads1].abs().max().item() == 0.0):
                raise AssertionError(f"bilstm_scan_fused {dtype_name}: padded frames do not "
                                     f"hold the frozen carry (direction 0) and zeros "
                                     f"(direction 1)")

            # --- the op against the two-kernel op (#1, both directions a launch)
            with torch.no_grad():
                lean_out = lc.bilstm_apply_fused(params, x, lengths)
                split_out = lc.bilstm_apply_kernel(params, x, lengths)
            if not torch.equal(lean_out, out):
                raise AssertionError("bilstm_apply_fused: with and without a graph differ")
            if out[pads].abs().max().item() != 0.0:
                raise AssertionError("bilstm_apply_fused: non-zero output at padded frames")
            errs["op vs bilstm_apply_kernel"] = rel_err(out, split_out)
            same_out = torch.equal(out, split_out)

            # --- its gradients: against the Function on the plain versions,
            # and against the two-kernel op's through #4 and #5
            _, split_grads = op_grads(torch, lc.bilstm_apply_kernel, params, x, lengths, r)
            saved_fns = (lc.bilstm_scan_fused, lc.lstm_bwd)
            lc.bilstm_scan_fused, lc.lstm_bwd = lc.bilstm_scan_fused_plain, lc.lstm_bwd_plain
            try:
                _, plain_grads = op_grads(torch, lc.bilstm_apply_fused, params, x, lengths, r)
            finally:
                lc.bilstm_scan_fused, lc.lstm_bwd = saved_fns
            for n, g, pg, sg in zip(names, grads, plain_grads, split_grads):
                errs[f"{n} vs plain"] = rel_err(g, pg)
                errs[f"{n} vs split"] = rel_err(g, sg)
            if grads[0][pads].abs().max().item() != 0.0:
                raise AssertionError("bilstm_apply_fused: d_x non-zero at padded frames")

            # --- times: the kernels alone, then the fused op against the
            # two-kernel op, forward and forward + backward
            reps = 10
            with torch.no_grad():
                ms3 = cuda_median_ms(torch, lambda: lc.lstm_scan_cs(x_proj, w_hh, lengths, rev),
                                     reps)
                ms7 = cuda_median_ms(torch, lambda: lc.bilstm_scan_fused(xp, w_hh, lengths), reps)
                ms1 = cuda_median_ms(torch, lambda: lc.lstm_scan(x_proj, w_hh, lengths, rev),
                                     reps)
                op_fused = cuda_median_ms(
                    torch, lambda: lc.bilstm_apply_fused(params, x, lengths), reps)
                op_split = cuda_median_ms(
                    torch, lambda: lc.bilstm_apply_kernel(params, x, lengths), reps)
            fb_fused = cuda_median_ms(
                torch, lambda: op_grads(torch, lc.bilstm_apply_fused, params, x, lengths, r), 5)
            fb_split = cuda_median_ms(
                torch, lambda: op_grads(torch, lc.bilstm_apply_kernel, params, x, lengths, r), 5)
            frames = int(lengths.sum())
            flops = 2 * frames * 2 * 4 * H * H
            bound3 = bound_ms(flops, valid_bytes(frames, x_proj)
                              + nbytes(w_hh, lengths, hs3, cs3), dtype)
            bound7 = bound_ms(flops, valid_bytes(frames, x_proj)
                              + nbytes(w_hh, lengths, hs7, cs7), dtype)
            library_ms = nn_lstm_ms(torch, x, lengths, dtype, "infer")
            shown = ", ".join(f"{k} {a:.2e} ({rr:.1e})" for k, (a, rr) in errs.items())
            log(f"[{card}] lstm_scan_cs + bilstm_scan_fused + bilstm_apply_fused {dtype_name} "
                f"B={batch} ({n_launch} launches, lstm_bwd {n_adjoint}) T={seq_len} "
                f"D={FUSED_IN_DIM} H={H}: #3's hs "
                f"bit-equal to lstm_scan's and cs to lstm_scan_train's; the op bit-equal to "
                f"bilstm_apply_kernel: {same_out}; max_abs_err (of max): {shown}; tolerance "
                f"{tol:g} of max")
            log(f"    lstm_scan_cs {ms3:.3f} ms (lstm_scan {ms1:.3f})  plain {plain3:.3f} ms  "
                f"bound {bound3[0]:.3f} ms ({bound3[1]});  bilstm_scan_fused {ms7:.3f} ms  plain "
                f"{plain7:.3f} ms  bound {bound7[0]:.3f} ms ({bound7[1]});  nn.LSTM under "
                f"no_grad {fmt_ms(library_ms)} ms")
            log(f"    fused op against the two-kernel op: forward {op_fused:.3f} / "
                f"{op_split:.3f} ms, forward + backward {fb_fused:.3f} / {fb_split:.3f} ms")
            bad = {k: rr for k, (_, rr) in errs.items() if not rr <= tol}
            if bad:
                raise AssertionError(f"fused op {dtype_name} B={batch} T={seq_len}: errors over "
                                     f"{tol} of max: {bad}")
            suffix = FUSED_RECORD_CASES.get((seq_len, batch))
            if dtype_name == "bfloat16" and suffix is not None:
                records["lstm_scan_cs" + suffix] = {
                    "name": "lstm_scan_cs" + suffix, "route": "cuda", "source": TC_STREAMS_SOURCE,
                    "replaces": PALLAS + ":98", "launches": counts["lstm_scan_cs"],
                    "max_abs_err": max(errs["#3 hs"][0], errs["#3 cs"][0]), "ms": ms3,
                    "plain_ms": plain3, "bound_ms": bound3[0], "bound_by": bound3[1],
                    "library_ms": library_ms}
                records["bilstm_scan_fused" + suffix] = {
                    "name": "bilstm_scan_fused" + suffix, "route": "cuda",
                    "source": TC_STREAMS_SOURCE,
                    "replaces": PALLAS + ":1063", "launches": counts["bilstm_scan_fused"],
                    "max_abs_err": max(errs["#7 hs"][0], errs["#7 cs"][0]), "ms": ms7,
                    "plain_ms": plain7, "bound_ms": bound7[0], "bound_by": bound7[1],
                    "library_ms": library_ms}
            del grads, plain_grads, split_grads, hs3, cs3, hs7, cs7, p_hs3, p_cs3, p_hs7, p_cs7
            torch.cuda.empty_cache()
    # a layer too wide for one launch of both directions raises; nothing splits it quietly
    wide = torch.zeros(4, 2, 3, 4 * WIDE_H, device=DEVICE)
    try:
        lc.bilstm_scan_fused(wide, torch.zeros(2, WIDE_H, 4 * WIDE_H, device=DEVICE),
                             torch.ones(3, dtype=torch.int32, device=DEVICE))
    except ValueError as err:
        if "bilstm_apply_kernel" not in str(err):
            raise
    else:
        raise AssertionError(f"bilstm_scan_fused served H={WIDE_H}")
    log(f"[{card}] bilstm_scan_fused at H={WIDE_H} raises and names bilstm_apply_kernel; "
        f"launches of the driven runs (the op forward and backward and lstm_scan_cs, no YAML "
        f"key of either package routes to them): {driven}")
    return records


def http_phase(torch, card: str, exp: str, feats: list) -> dict:
    """The HTTP entry at base-LAS full width on the card: a ``Transcriber``
    with a background warm-up ladder behind ``AsrHttpServer`` on a free
    loopback port; returns the launches of the served requests."""
    import base64
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.server import AsrHttpServer
    from attention_based_e2e_asr_dnn_tpu_torch.serving import Transcriber

    def call(url, payload=None, raw=None):
        data = raw if raw is not None else (None if payload is None
                                            else json.dumps(payload).encode())
        req = urllib.request.Request(url, data=data,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as err:
            return err.code, err.read()

    t0 = time.perf_counter()
    t = Transcriber(exp, auto_warmup=(512, 1536))
    server = AsrHttpServer(t, port=0, max_wait_ms=100.0).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        if call(f"{base}/healthz") != (200, b'{"ok": true}'):
            raise AssertionError("http: /healthz")
        first = call(f"{base}/readyz")[0]  # 503 unless the ladder's largest bucket has run
        if not t.wait_ready(timeout=600):
            raise AssertionError("http: the warm-up did not get ready")
        ready_s = time.perf_counter() - t0
        if first not in (200, 503) or call(f"{base}/readyz")[0] != 200:
            raise AssertionError("http: /readyz after wait_ready")
        t.wait_warm(timeout=600)
        if t._warm != {512, 1536}:
            raise AssertionError(f"http: warm buckets {t._warm}")
        lc.reset_launch_counts()
        url = f"{base}/v1/transcribe"
        b64 = base64.b64encode(feats[3].astype("<f4").tobytes()).decode()
        bodies = [{"features": feats[0].tolist()},
                  {"instances": [{"features": f.tolist()} for f in feats[1:3]]},
                  {"features_b64": b64},
                  {"instances": [{"features_b64": b64}, {"features": feats[4].tolist()}]},
                  {"features": feats[5].tolist()}]
        groups = [[0], [1, 2], [3], [3, 4], [5]]  # the utterances of each body

        def texts(reply):
            code, body = reply
            body = json.loads(body)
            if code != 200:
                raise AssertionError(f"http: {code} {body}")
            return [body["transcript"]] if "transcript" in body else body["transcripts"]

        # one request at a time: each is a batch of its own, so the reply is
        # Transcriber.transcribe of the same utterances, shape for shape
        alone = [s for body in bodies for s in texts(call(url, body))]
        counts = dict(lc.LAUNCHES)
        want = [s for group in groups for s in t.transcribe([feats[i] for i in group])]
        if alone != want:
            raise AssertionError(f"http: {alone} != Transcriber.transcribe's {want}")
        # then all at once: the queue batches them together, in a time bucket
        # of the longest, where bfloat16 products of another shape may round
        # another way: well-formed, and how many equal the replies above
        t1 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as pool:
            together = [s for reply in pool.map(lambda b: call(url, b), bodies)
                        for s in texts(reply)]
        wall = time.perf_counter() - t1
        vocab = set("ABCDEFGHIJKLMNOPQRSTUVWXYZ' ")
        if len(together) != 7 or not all(set(s) <= vocab for s in together):
            raise AssertionError(f"http: concurrent replies malformed: {together}")
        same = sum(a == b for a, b in zip(together, alone))
        code, body = call(url, raw=b"{not json")
        if code != 400 or call(url, {"features": [[1.0] * 14] * 5})[0] != 400:
            raise AssertionError("http: a bad body did not give 400")
        meta = json.loads(call(f"{base}/v1/meta")[1])
        if (meta["input_dim"], meta["batch_size"], meta["corrector"]) != (15, 32, False):
            raise AssertionError(f"http: /v1/meta {meta}")
        lines = dict(ln.rsplit(" ", 1) for ln in call(f"{base}/metrics")[1].decode().splitlines()
                     if ln and not ln.startswith("#"))
        if not (float(lines['asr_requests_total{status="200"}']) == 10
                and float(lines['asr_requests_total{status="400"}']) == 2
                and float(lines["asr_utterances_total"]) == 14
                and float(lines["asr_in_flight"]) == 0):
            raise AssertionError(f"http: /metrics {lines}")
    finally:
        server.close()
    if not all(counts[k] > 0 for k in ("lstm_scan_fusedin", "lstm_scan")):
        raise AssertionError(f"http: the requests launched no lean kernel: {counts}")
    log(f"[{card}] serve over HTTP base-LAS bf16 (AsrHttpServer over Transcriber(auto_warmup="
        f"(512, 1536)), loopback): ready {ready_s:.2f} s after construction (the first "
        f"/readyz gave {first}); 5 POSTs (single, instances, features_b64; 7 utterances) one "
        f"at a time: transcripts equal to Transcriber.transcribe; the same 5 at once in "
        f"{wall:.3f} s: {same}/7 equal to those; bad bodies 400; /metrics counts 10 x 200, "
        f"2 x 400, 14 utterances; launches of the 5 sequential requests {counts}")
    return counts


def train_config(lstm_impl: str = "pallas", decoder_impl: str = "pallas",
                 model: str = "base-LAS", **listener):
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import las_config_from_dicts

    return las_config_from_dicts(
        {**MODELS[model]["listener_configs"], "lstm_impl": lstm_impl, **listener},
        {**MODELS[model]["speller_configs"], "decoder_impl": decoder_impl})


def train_batch(torch, batch: int, seq_len: int, labels: int, seed: int):
    """A seeded batch in one length bucket: frames within the last 256 of
    ``seq_len`` but at least 8, so that every row keeps an encoder frame
    after the pyramid's three halvings (over a row without one the fused
    decoder attends uniformly and the scan decoder not at all, in the JAX
    package too); labels within the last 32 of ``labels``."""
    gen = torch.Generator().manual_seed(seed)
    lx = torch.randint(max(seq_len - 255, 8), seq_len + 1, (batch,), generator=gen)
    ly = torch.randint(labels - 31, labels + 1, (batch,), generator=gen)
    lx[0], ly[0] = seq_len, labels
    x = torch.randn(batch, seq_len, 15, generator=gen)
    x[torch.arange(seq_len)[None, :] >= lx[:, None]] = 0.0
    y = torch.randint(1, 29, (batch, labels), generator=gen)
    y[torch.arange(labels)[None, :] >= ly[:, None]] = 29
    lx, y, ly = (t.to(torch.int32) for t in (lx, y, ly))
    return tuple(t.to(DEVICE) for t in (x, lx, y, ly))


def build_trainer(torch, cfg, compute_dtype, seed: int):
    """Seeded parameters, optimizer, state and step, as ``bench.py`` of the
    JAX package builds them (``BENCH_ARCH`` base or scaled)."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import las_apply, las_init
    from attention_based_e2e_asr_dnn_tpu_torch.training.optim import build_optimizer
    from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
        create_train_state,
        make_train_step,
    )

    params = las_init(cfg, torch.Generator().manual_seed(seed))
    opt = build_optimizer("adamw", {"lr": 1e-3, "weight_decay": 5e-6, "amsgrad": True},
                          grad_norm=5.0)
    state = create_train_state(params, opt, seed=seed + 1, device=DEVICE)

    def apply_fn(p, x, lx, **kwargs):
        return las_apply(p, cfg, x, lx, **kwargs)

    step = make_train_step(apply_fn, opt, compute_dtype=compute_dtype, use_specaug=True)
    return opt, state, step


class forbid_plain:
    """While active, every plain version in ``ops/lstm_cuda.py`` and
    ``ops/speller_cuda.py`` raises."""

    NAMES = {"lstm_cuda": ("_scan_plain", "lstm_scan_plain", "lstm_scan_fusedin_plain",
                           "lstm_scan_train_plain", "lstm_scan_fusedin_train_plain",
                           "lstm_bwd_dw_plain", "lstm_bwd_plain", "_bwd_plain",
                           "lstm_scan_cs_plain", "bilstm_scan_fused_plain"),
             "speller_cuda": ("_decode_steps", "speller_decode_plain",
                              "speller_decode_train_plain", "_cell_adjoint",
                              "speller_decode_bwd_plain")}

    def __enter__(self):
        import importlib

        def refuse(*args, **kwargs):
            raise AssertionError("a plain version ran inside the train step")

        self.saved = []
        for module, names in self.NAMES.items():
            mod = importlib.import_module(f"attention_based_e2e_asr_dnn_tpu_torch.ops.{module}")
            for n in names:
                self.saved.append((mod, n, getattr(mod, n)))
                setattr(mod, n, refuse)

    def __exit__(self, *exc):
        for mod, n, fn in self.saved:
            setattr(mod, n, fn)


def step_split(torch, cfg, state, opt, x, lx, y, ly, tf_rate, lr) -> tuple:
    """One pass of the train step's pieces, as the step runs them: the
    listener forward, the speller forward and loss, the backward in two
    stages (down to the encoder output, then the listener) and the
    optimizer. Returns (the device ms of each piece by CUDA events, the host
    ms to enqueue it): a device time much above the host's is the card's
    work, one close to it a wait on the host."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
        draw_train_noise,
        listener_apply,
        speller_apply,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.training.loss import masked_ce_loss

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    host = []
    spell_params = list(state.params["speller"].parameters())
    listen_params = list(state.params["listener"].parameters())
    with forbid_plain():
        draws = draw_train_noise(cfg, x.shape[0], y.shape[1], state.generator, x.device)
        torch.cuda.synchronize()

        def mark(i):
            marks[i].record()
            host.append(time.perf_counter())

        mark(0)
        enc_h, enc_l = listener_apply(state.params["listener"], cfg.listener,
                                      x.to(torch.bfloat16), lx, True, draws.listener_masks)
        mark(1)
        out = speller_apply(state.params["speller"], cfg.speller, enc_h, enc_l, y, tf_rate,
                            False, True, draws)
        loss, _ = masked_ce_loss(out.logits, y, ly)
        mark(2)
        *d_spell, d_enc = torch.autograd.grad(loss, [*spell_params, enc_h])
        mark(3)
        d_listen = torch.autograd.grad(enc_h, listen_params, d_enc)
        mark(4)
        with torch.no_grad():  # the parameters' order: listener, speller
            opt.update([*d_listen, *d_spell], state.opt_state, [*listen_params, *spell_params],
                       lr)
        mark(5)
        torch.cuda.synchronize()
    return ([marks[i].elapsed_time(marks[i + 1]) for i in range(5)],
            [1e3 * (host[i + 1] - host[i]) for i in range(5)])


def train_phase(torch, card: str, decoder_impl: str, min_steps: int,
                model: str = "base-LAS") -> tuple:
    """A trainer that takes a few steps at the full width of ``model`` with
    the listener on its kernels and the decoder on ``decoder_impl``; returns
    (the launches of the timed steps, {"s_per_step": their median,
    "split_ms": the step's split}). scaled-LAS trains with ``remat``: each
    listener layer's first pass is a lean kernel, its backward pass the
    training forward again and then ``lstm_bwd`` with the outside dW_hh."""
    from attention_based_e2e_asr_dnn_tpu_torch.models import las
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import speller_apply
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    cfg = train_config("pallas", decoder_impl, model)
    fused = decoder_impl == "pallas"
    remat, heads = cfg.listener.remat, cfg.speller.att_heads
    wide = cfg.listener.uniform_hid_dim > H
    opt, state, step = build_trainer(torch, cfg, torch.bfloat16, SEED)
    x, lx, y, ly = train_batch(torch, TRAIN_B, TRAIN_T, TRAIN_L, SEED)
    n_params = sum(p.numel() for p in state.params.parameters())
    tf_rate, lr = 0.9, 1e-3

    with forbid_plain():
        state, warm, _ = step(state, x, lx, y, ly, tf_rate, lr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        las.reset_decode_routes()
        lc.reset_launch_counts()
        sc.reset_launch_counts()
        metrics, times = [], []
        first_loss = warm["loss"].item()  # the first step taken on this batch

        def fell() -> bool:
            # below the warm-up step's loss. Not asked of the wide model,
            # whose loss these few steps need not bring back below the
            # untrained model's: its train CLI phase holds that the loss
            # falls from one epoch to the next.
            return wide or metrics[-1]["loss"] < first_loss

        while len(metrics) < min_steps or (len(metrics) < 10 and not fell()):
            t0 = time.perf_counter()
            state, m, att_map = step(state, x, lx, y, ly, tf_rate, lr)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics.append({k: v.item() for k, v in m.items()})
        counts = {**lc.LAUNCHES, **sc.LAUNCHES}
        row_groups = dict(lc.ADJOINT_ROW_GROUPS)
        peak = torch.cuda.max_memory_allocated()
        routes = las.decode_route_report()
    n_steps = len(metrics)
    # a layer's launches a step: the forward and the adjoint one per 128 rows
    # with both directions (bf16)
    fwd = forward_launches(torch, torch.bfloat16, TRAIN_B, cfg.listener.uniform_hid_dim)
    chunks = adjoint_launches(torch, torch.bfloat16, TRAIN_B, cfg.listener.uniform_hid_dim,
                              not wide)
    want = {**dict.fromkeys(counts, 0),
            "lstm_scan_fusedin": fwd * n_steps if remat else 0,
            "lstm_scan": 3 * fwd * n_steps if remat else 0,
            "lstm_scan_fusedin_train": fwd * n_steps,
            "lstm_scan_train": 3 * fwd * n_steps,
            "lstm_bwd" if wide else "lstm_bwd_dw": 4 * chunks * n_steps,
            # the whole batch in one launch of each decoder kernel
            "speller_decode_train": n_steps if fused else 0,
            "speller_decode_bwd": n_steps if fused else 0}
    if counts != want:
        raise AssertionError(f"train: launches {counts} != {want} for {n_steps} steps")
    # the adjoint's launches by row groups: at B=128 two chains of 64 rows a
    # launch up to H=512, one chain of all rows above
    groups = 1 if wide else 2
    if row_groups != {**dict.fromkeys(row_groups, 0), groups: 4 * chunks * n_steps}:
        raise AssertionError(f"train: adjoint launches by row groups {row_groups}, not "
                             f"{4 * chunks * n_steps} of {groups}")
    if routes != {f"B={TRAIN_B},Te={TRAIN_T // 8}": "cuda" if fused else "scan"}:
        raise AssertionError(f"train decoder_impl {decoder_impl}: decode routes {routes}")
    if fused:
        # what the kernels lack takes the step loop, as in the JAX package: it
        # warns and records the route "scan" for its shape
        enc = torch.zeros(2, 8, cfg.listener.enc_out_dim, device=DEVICE)
        enc_l = torch.full((2,), 8, dtype=torch.int32, device=DEVICE)
        for lacking in ({"init_force": True, "train": True}, {"train": False}):
            las.reset_decode_routes()
            with torch.no_grad():
                out = speller_apply(state.params["speller"], cfg.speller, enc, enc_l, y[:2],
                                    **lacking)
            if las.decode_route_report() != {"B=2,Te=8": "scan"}:
                raise AssertionError(f"train: {lacking} took {las.decode_route_report()}")
            if not bool(torch.isfinite(out.logits).all()):
                raise AssertionError(f"train: {lacking} on the scan loop is not finite")
    if not all(m["finite"] for m in metrics) or not bool(warm["finite"]):
        raise AssertionError(f"train: a step was not finite: {metrics}")
    losses = [m["loss"] for m in metrics]
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        raise AssertionError(f"train: losses {losses}")
    if not fell():
        raise AssertionError(f"train: the loss did not fall below the warm-up step's "
                             f"{first_loss} in {n_steps} steps: {losses}")
    if att_map.shape != (heads, TRAIN_T // 8, TRAIN_L + 1):
        raise AssertionError(f"train: att_map {tuple(att_map.shape)}")
    if int(state.opt_state.count) != n_steps + 1 or state.step != n_steps + 1:
        raise AssertionError("train: the optimizer did not count every step")
    sec = statistics.median(times)
    log(f"[{card}] train {model} bf16 B={TRAIN_B} T={TRAIN_T} L={TRAIN_L} "
        f"({n_params / 1e6:.1f}M parameters; lstm_impl pallas, decoder_impl {decoder_impl}, "
        f"remat {remat}; SpecAugment, "
        f"dropout, tf_rate {tf_rate}, AdamW amsgrad lr {lr}, clip 5, NaN guard): 1 warm-up + "
        f"{n_steps} steps, median {sec:.3f} s/step (all: {[round(t, 3) for t in times]}), "
        f"{TRAIN_B / sec:.2f} utt/s, peak device memory {peak / 2**20:.1f} MiB")
    log(f"    loss warm-up {first_loss:.4f}, then {[round(v, 4) for v in losses]}; "
        f"grad_norm {[round(m['grad_norm'], 3) for m in metrics]}; decode routes {routes}; "
        f"launches {counts}; adjoint launches by row groups {row_groups}")

    # where a step's time goes: the same pieces the step runs, CUDA events
    # between them; one pass untimed, then the median of three
    passes = [step_split(torch, cfg, state, opt, x, lx, y, ly, tf_rate, lr)
              for _ in range(4)]
    split = [statistics.median(p[0][i] for p in passes[1:]) for i in range(5)]
    worst = [max(p[0][i] for p in passes[1:]) for i in range(5)]
    host = [statistics.median(p[1][i] for p in passes[1:]) for i in range(5)]
    log(f"    split of one step (CUDA events, median of 3 passes after one; SpecAugment and "
        f"the parameter update left out): listener forward {split[0]:.1f} ms"
        f"{' (the lean kernels: remat)' if remat else ''}, speller forward + loss "
        f"{split[1]:.1f} ms, backward {split[2] + split[3]:.1f} ms (speller {split[2]:.1f}, "
        f"listener {split[3]:.1f}{', its layers recomputed first' if remat else ''}), "
        f"optimizer {split[4]:.1f} ms; the largest of the 3 passes "
        f"{[round(v, 1) for v in worst]} ms; host ms to enqueue each piece "
        f"{[round(v, 1) for v in host]}; the untimed pass's device ms "
        f"{[round(v, 1) for v in passes[0][0]]}, host ms {[round(v, 1) for v in passes[0][1]]}")
    del state, opt, step
    torch.cuda.empty_cache()
    if remat:
        # the memory remat saves: the same step keeping every layer's streams
        _, state, step = build_trainer(
            torch, train_config("pallas", decoder_impl, model, remat=False), torch.bfloat16, SEED)
        with forbid_plain():
            state, _, _ = step(state, x, lx, y, ly, tf_rate, lr)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, m, _ = step(state, x, lx, y, ly, tf_rate, lr)
            torch.cuda.synchronize()
            sec_off = time.perf_counter() - t0
        peak_off = torch.cuda.max_memory_allocated()
        if not bool(m["finite"]):
            raise AssertionError(f"train {model} remat false: step not finite")
        log(f"    the same step with remat false: {sec_off:.3f} s, peak device memory "
            f"{peak_off / 2**20:.1f} MiB against {peak / 2**20:.1f} MiB with remat "
            f"({(peak_off - peak) / 2**20:.1f} MiB saved), loss {m['loss'].item():.4f}")
        del state, step
        torch.cuda.empty_cache()
    return counts, {"s_per_step": sec, "split_ms": split}


def train_parity_phase(torch, card: str, model: str = "base-LAS") -> dict:
    """One float32 step at the full width of ``model`` through both kernel
    tiers, (base-LAS) through the listener kernels with the scan decoder, and
    through the plain loops under autograd, from the same weights, batch and
    draws. Returns the LSTM and speller kernels' launches in the kernel routes'
    steps."""
    from attention_based_e2e_asr_dnn_tpu_torch.data.specaug import draw_specaug
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import draw_train_noise
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    batch, seq_len, labels, lr = 40, 256, 32, 1e-3
    x, lx, y, ly = train_batch(torch, batch, seq_len, labels, SEED + 2)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    draws = draw_train_noise(train_config(model=model), batch, labels, gen, DEVICE,
                             specaug=draw_specaug(batch, 6, 200, False, gen, DEVICE))
    routes = {"lstm_impl pallas + decoder_impl pallas": ("pallas", "pallas"),
              "lstm_impl pallas + decoder_impl scan": ("pallas", "scan"),
              "plain": ("scan", "scan")}
    if model != "base-LAS":
        del routes["lstm_impl pallas + decoder_impl scan"]
    results, launches = {}, {}
    for name, impls in routes.items():
        _, state, step = build_trainer(torch, train_config(*impls, model), torch.float32, SEED)
        lc.reset_launch_counts()
        sc.reset_launch_counts()
        state, m, _ = step(state, x, lx, y, ly, 0.9, lr, draws=draws)
        torch.cuda.synchronize()
        for kernel, n in (*lc.LAUNCHES.items(), *sc.LAUNCHES.items()):
            launches[kernel] = launches.get(kernel, 0) + n
        results[name] = ({k: v.item() for k, v in m.items()},
                         [p.detach() for p in state.params.parameters()])
    mp, pp = results.pop("plain")
    # Tolerances. loss and grad_norm: float32 sums in another order, 1e-4
    # relative (the fused decoder also keeps its gates and carries in float32
    # where the loop's are float32 too). Parameters: the first AdamW step
    # moves an element by lr * g / (|g| + eps), i.e. by +-lr whatever |g| is,
    # so an element whose gradient is rounding noise around zero may move the
    # other way: no element may differ by more than 2 * lr, and no more than
    # one in a thousand by more than 1e-5.
    for name, (mk, pk) in results.items():
        worst = max((a - b).abs().max().item() for a, b in zip(pk, pp))
        off = sum(((a - b).abs() > 1e-5).sum().item() for a, b in zip(pk, pp))
        total = sum(a.numel() for a in pk)
        log(f"[{card}] train parity {model} float32 B={batch} T={seq_len} L={labels}, {name} vs "
            f"lstm_impl scan + decoder_impl scan, one step, shared draws: loss "
            f"{mk['loss']:.6f} / {mp['loss']:.6f}, grad_norm {mk['grad_norm']:.6f} / "
            f"{mp['grad_norm']:.6f}; parameters max_abs_diff {worst:.3e} (bound 2 x lr = "
            f"{2 * lr:g}), {off} of {total} elements off by more than 1e-5 (allowed "
            f"{total // 1000})")
        for key in ("loss", "grad_norm"):
            if not abs(mk[key] - mp[key]) <= 1e-4 * abs(mp[key]):
                raise AssertionError(f"train parity {name}: {key} {mk[key]} vs {mp[key]}")
        if not (mk["finite"] and mp["finite"] and mk["n_tokens"] == mp["n_tokens"]):
            raise AssertionError(f"train parity {name}: metrics {mk} vs {mp}")
        if not (worst <= 2 * lr * 1.01 and off <= total // 1000):
            raise AssertionError(f"train parity {name}: parameters differ by {worst}, {off} "
                                 f"elements off")
    return launches


def make_experiment(torch, root: str) -> str:
    """A base-LAS experiment folder with seeded full-width random params."""
    import numpy as np

    from attention_based_e2e_asr_dnn_tpu_torch import EOS_IDX, SOS_IDX, VOCAB
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
        las_config_from_dicts,
        las_init,
        las_to_jax_params,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import save_checkpoint

    cfg = las_config_from_dicts(BASE_LAS_MODEL["listener_configs"],
                                BASE_LAS_MODEL["speller_configs"])
    snap = {"TRN_FOLDER": "data/train-clean-100", "compute_dtype": "bfloat16",
            "VOCAB": list(VOCAB), "SOS_IDX": SOS_IDX, "EOS_IDX": EOS_IDX,
            "model": {"tag": "base-LAS", "configs": BASE_LAS_MODEL}}
    os.makedirs(os.path.join(root, "ckpts"))
    with open(os.path.join(root, "config.json"), "w") as fh:
        json.dump(snap, fh)
    rng = np.random.default_rng(SEED)
    for epoch in (1, 2):
        params = las_to_jax_params(las_init(cfg, torch.Generator().manual_seed(SEED + epoch)))
        # non-zero learned initial states, as a trained model has
        for key in ("init_h1", "init_c1", "init_h2", "init_c2"):
            params["speller"][key] = rng.uniform(-0.5, 0.5, params["speller"][key].shape
                                                 ).astype("float32")
        save_checkpoint(os.path.join(root, "ckpts", f"min-loss-ld-ppl-epoch[{epoch}].ckpt"),
                        {"params": params, "epoch": epoch})
    return root


def make_test_set(root: str, rng) -> str:
    """A test set in the reference layout: mfcc/*.npy and the submission
    template transcript/random_submission.csv."""
    import numpy as np

    for sub in ("mfcc", "transcript"):
        os.makedirs(os.path.join(root, sub))
    for i, n in enumerate(rng.integers(MIN_FRAMES, MAX_FRAMES + 1, N_TEST_UTTS)):
        np.save(os.path.join(root, "mfcc", f"utt{i:04d}.npy"),
                rng.standard_normal((int(n), 15)).astype(np.float32))
    with open(os.path.join(root, "transcript", "random_submission.csv"), "w") as fh:
        fh.write("id,label\n" + "".join(f"{i},X\n" for i in range(N_TEST_UTTS)))
    return root


def infer_phase(torch, card: str, exp: str, data: str, work: str) -> dict:
    """The port's infer CLI on the card, early_stop true then false; returns
    the launches of both runs."""
    from attention_based_e2e_asr_dnn_tpu_torch import infer
    from attention_based_e2e_asr_dnn_tpu_torch.models import las
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    n_batches = -(-N_TEST_UTTS // INFER_BATCH)
    n_ckpts = 3  # two best checkpoints and their average
    launches = {"lstm_scan_fusedin": 0, "lstm_scan": 0, "speller_decode": 0}
    for early_stop in (True, False):
        cfg_path = os.path.join(work, f"infer-{early_stop}.yml")
        with open(cfg_path, "w") as fh:
            fh.write(f"SOME_FOLDER: {data}\nexp_folder: {exp}\nbatch_size: {INFER_BATCH}\n"
                     f"pad_time_multiple: 256\nrun_all: true\nepoch_num: null\n"
                     f"run_avg: true\nearly_stop: {str(early_stop).lower()}\n")
        las.reset_decode_routes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lc.reset_launch_counts()
        sc.reset_launch_counts()
        t0 = time.perf_counter()
        infer.main(infer.build_argparser().parse_args(["-c", cfg_path, "--device", "cuda"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**lc.LAUNCHES, **sc.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        routes = las.decode_route_report()
        fwd = forward_launches(torch, torch.bfloat16, INFER_BATCH, H, 15)  # 64 rows: 1
        want = {**dict.fromkeys(counts, 0),  # none of the training kernels
                "lstm_scan_fusedin": fwd * n_batches * n_ckpts,
                "lstm_scan": 3 * fwd * n_batches * n_ckpts,
                "speller_decode": 0 if early_stop else n_batches * n_ckpts}
        if counts != want:
            raise AssertionError(f"infer early_stop={early_stop}: launches {counts} != {want}")
        if not early_stop and (not routes or set(routes.values()) != {"cuda"}):
            raise AssertionError(f"infer early_stop=false: decode routes {routes}")
        for name in ("min-loss-ld-ppl-epoch[1]", "min-loss-ld-ppl-epoch[2]", "avg-all"):
            check_preds(os.path.join(exp, "preds", f"{name}-tst.csv"), N_TEST_UTTS,
                        f"infer early_stop={early_stop}")
        decoded = N_TEST_UTTS * n_ckpts
        log(f"[{card}] infer base-LAS bf16 early_stop={str(early_stop).lower()}: {decoded} "
            f"utts ({MIN_FRAMES}-{MAX_FRAMES} frames; {n_ckpts} checkpoints x {n_batches} "
            f"batches of {INFER_BATCH}) in {wall:.3f} s (whole CLI run), "
            f"{decoded / wall:.2f} utt/s, {wall / (n_batches * n_ckpts) * 1e3:.1f} ms/batch, "
            f"peak device memory {peak / 2**20:.1f} MiB; routes {routes}; launches {counts}")
        for k in launches:
            launches[k] += counts[k]
    return launches


N_CLI_TRAIN, N_CLI_DEV, N_CLI_TEST, CLI_BATCH = 256, 64, 64, 32


class Tee(io.StringIO):
    """Keeps what is written and passes it on to ``stream``."""

    def __init__(self, stream):
        super().__init__()
        self.stream = stream

    def write(self, text):
        self.stream.write(text)
        return super().write(text)

    def flush(self):
        self.stream.flush()


def train_cli_phase(torch, card: str, work: str) -> tuple:
    """The ``train`` CLI in-process on the card at scaled-LAS width: a seeded
    corpus from the port's generator, ``configs/scaled-las.yml`` with
    ``parallel.use: false`` (``lazy_data: true`` as it stands: the features
    stay on disk), its folders pointed at the corpus, ``batch_size`` 32 and 2
    epochs; then the CLI again with
    ``finetune.use: true`` on the last checkpoint it wrote, for one more
    epoch. Returns (the first run's experiment folder, the corpus, the
    launches of the first run)."""
    import yaml

    from attention_based_e2e_asr_dnn_tpu_torch import train
    from attention_based_e2e_asr_dnn_tpu_torch.models import las
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
    from attention_based_e2e_asr_dnn_tpu_torch.tools.make_synthetic_data import generate
    from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import (
        list_best_checkpoints,
        load_checkpoint,
    )

    corpus = os.path.join(work, "corpus")
    generate(corpus, n_train=N_CLI_TRAIN, n_dev=N_CLI_DEV, n_test=N_CLI_TEST, seed=SEED)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", "scaled-las.yml")) as fh:
        cfg = yaml.safe_load(fh)
    for block, written in cfg["model"]["configs"].items():
        if written != {key: SCALED_LAS_MODEL[block][key] for key in written}:
            raise AssertionError(f"configs/scaled-las.yml's {block} are not the ones the "
                                 f"kernel and train phases ran")
    cfg["parallel"]["use"] = False
    if cfg["lazy_data"] is not True:
        raise AssertionError("configs/scaled-las.yml no longer sets lazy_data: true")
    cfg.update(batch_size=CLI_BATCH, epochs=2,
               TRN_FOLDER=os.path.join(corpus, "train-clean-100"),
               DEV_FOLDER=os.path.join(corpus, "dev-clean"),
               TST_FOLDER=os.path.join(corpus, "test-clean"),
               EXP_FOLDER=os.path.join(work, "experiments"),
               MST_FOLDER=os.path.join(work, "milestones"))

    def run(name, cfg):
        path = os.path.join(work, name)
        with open(path, "w") as fh:
            yaml.safe_dump(cfg, fh)
        return train.main(train.build_argparser().parse_args(["-c", path]))

    las.reset_decode_routes()
    lc.reset_launch_counts()
    sc.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with forbid_plain():
        trainer = run("train.yml", cfg)
    counts = {**lc.LAUNCHES, **sc.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    routes = las.decode_route_report()
    folder = trainer.saving_dir
    trn, dev = trainer.train_history, trainer.dev_history
    with open(os.path.join(folder, "log.json")) as fh:
        logged = json.load(fh)
    with open(os.path.join(folder, "config.json")) as fh:
        snap = json.load(fh)
    finite = all(v == v and abs(v) != float("inf")
                 for v in trn["loss"] + dev["loss"] + dev["ld"])
    if not (len(trn["loss"]) == 2 and finite and trn["loss"][1] < trn["loss"][0]):
        raise AssertionError(f"train CLI: histories {trn} {dev}")
    if logged != [trn, dev] or snap["model"]["configs"] != SCALED_LAS_MODEL:
        raise AssertionError("train CLI: log.json or the config snapshot is off")
    datasets = [type(b.dataset).__name__ for b in (trainer.trn_batcher, trainer.dev_batcher)]
    if datasets != ["LazyAsrTrainDevDataset"] * 2 or snap["lazy_data"] is not True:
        raise AssertionError(f"train CLI: lazy_data: true ran on {datasets}")
    # what CheckpointManager keeps: the best-tagged saves, at most max_savings
    kept = sorted(os.listdir(os.path.join(folder, "ckpts")))
    best = list_best_checkpoints(os.path.join(folder, "ckpts"))
    if not (kept == best == sorted(trainer.ckpt.saved_files) and
            1 <= len(kept) <= cfg["max_savings"] and
            all(k.startswith("min-") and k.endswith("].ckpt") for k in kept)):
        raise AssertionError(f"train CLI: ckpts/ holds {kept}, the manager kept "
                             f"{trainer.ckpt.saved_files}")
    if not routes or set(routes.values()) != {"cuda"}:
        raise AssertionError(f"train CLI: decode routes {routes}")
    idle = [k for k in ("lstm_scan_fusedin", "lstm_scan", "lstm_scan_fusedin_train",
                        "lstm_scan_train", "lstm_bwd", "speller_decode",
                        "speller_decode_train", "speller_decode_bwd") if counts[k] <= 0]
    if idle or counts["lstm_bwd_dw"] != 0:
        raise AssertionError(f"train CLI: launches {counts}")
    n_batches = (-(-N_CLI_TRAIN // CLI_BATCH), -(-N_CLI_DEV // CLI_BATCH))
    log(f"[{card}] train CLI scaled-LAS bf16 ({N_CLI_TRAIN} train / {N_CLI_DEV} dev "
        f"utterances, batch_size {CLI_BATCH}: {n_batches[0]} + {n_batches[1]} batches an "
        f"epoch): train loss {[round(v, 4) for v in trn['loss']]}, dev loss "
        f"{[round(v, 4) for v in dev['loss']]}, dev LD {[round(v, 3) for v in dev['ld']]}; "
        f"epoch seconds {[round(t, 2) for t in trainer.epoch_seconds]} (train "
        f"{[round(t, 2) for t in trainer.train_seconds]}, dev "
        f"{[round(t, 2) for t in trainer.eval_seconds]}); peak device memory "
        f"{peak / 2**20:.1f} MiB; ckpts {kept}; routes {routes}; launches {counts}; "
        f"lazy_data: true, batches assembled from disk by {datasets[0]}")

    # resume: one more epoch from the last checkpoint
    last = os.path.join(folder, "ckpts", kept[-1])
    saved = load_checkpoint(last)
    cfg["finetune"] = {"use": True, "reinit_lr": False, "checkpoint": last}
    cfg["epochs"] = saved["epoch"] + 1
    cfg["EXP_FOLDER"] = os.path.join(work, "experiments-resumed")
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        resumed = run("resume.yml", cfg)
    lines = tee.getvalue().splitlines()
    first = [ln for ln in lines if ln.startswith(f"[epoch {saved['epoch']}]")]
    if not (any(f"at epoch[{saved['epoch']}]" in ln for ln in lines) and len(first) == 1 and
            f"tf {saved['tf_rate']:.2f} lr {saved['current_lr']:.2e}" in first[0] and
            resumed.epoch == saved["epoch"] + 1 and
            resumed.train_history["loss"][:-1] == saved["train_loss"] and
            resumed.train_history["loss"][-1] < saved["train_loss"][-1] and
            int(resumed.state.opt_state.count) > saved["batch"]):
        raise AssertionError(f"train CLI resume: {lines}")
    log(f"[{card}] train CLI resumed from {kept[-1]} at epoch {saved['epoch']} with lr "
        f"{saved['current_lr']:g}, tf_rate {saved['tf_rate']:g}: one epoch in "
        f"{resumed.epoch_seconds[-1]:.2f} s, train loss "
        f"{resumed.train_history['loss'][-1]:.4f}")
    del trainer, resumed
    torch.cuda.empty_cache()
    return folder, corpus, counts


def train_to_infer_phase(torch, card: str, folder: str, corpus: str, work: str) -> None:
    """The port's ``infer`` CLI on the corpus's test split from the experiment
    folder the Trainer wrote: every best checkpoint and their average,
    ``early_stop: false`` (the fused decode kernel) at scaled-LAS width."""
    from attention_based_e2e_asr_dnn_tpu_torch import infer
    from attention_based_e2e_asr_dnn_tpu_torch.models import las
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
    from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import list_best_checkpoints

    names = [os.path.splitext(c)[0]
             for c in list_best_checkpoints(os.path.join(folder, "ckpts"))] + ["avg-all"]
    cfg_path = os.path.join(work, "infer-trained.yml")
    with open(cfg_path, "w") as fh:
        fh.write(f"SOME_FOLDER: {os.path.join(corpus, 'test-clean')}\nexp_folder: {folder}\n"
                 f"batch_size: {CLI_BATCH}\npad_time_multiple: 256\nrun_all: true\n"
                 f"epoch_num: null\nrun_avg: true\nearly_stop: false\n")
    las.reset_decode_routes()
    lc.reset_launch_counts()
    sc.reset_launch_counts()
    t0 = time.perf_counter()
    with forbid_plain():
        infer.main(infer.build_argparser().parse_args(["-c", cfg_path]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**lc.LAUNCHES, **sc.LAUNCHES}
    routes = las.decode_route_report()
    n_batches = -(-N_CLI_TEST // CLI_BATCH) * len(names)
    fwd = forward_launches(torch, torch.bfloat16, CLI_BATCH, WIDE_H, 15)  # both directions: 1
    want = {**dict.fromkeys(counts, 0), "lstm_scan_fusedin": fwd * n_batches,
            "lstm_scan": 3 * fwd * n_batches, "speller_decode": n_batches}
    if counts != want or not routes or set(routes.values()) != {"cuda"}:
        raise AssertionError(f"train -> infer: launches {counts} != {want}, routes {routes}")
    vocab = set("ABCDEFGHIJKLMNOPQRSTUVWXYZ' ")
    lengths = []
    for name in names:
        with open(os.path.join(folder, "preds", f"{name}-tst.csv")) as fh:
            lines = fh.read().split("\n")
        rows = [ln.split(",", 1) for ln in lines[1:-1]]
        if (lines[0] != "id,label" or lines[-1] != "" or
                [r[0] for r in rows] != [str(i) for i in range(N_CLI_TEST)] or
                not all(len(r) == 2 and set(r[1]) <= vocab for r in rows)):
            raise AssertionError(f"train -> infer: {name}-tst.csv malformed")
        lengths.append(sum(len(r[1]) for r in rows) / len(rows))
    log(f"[{card}] train -> infer scaled-LAS bf16 early_stop=false: {N_CLI_TEST} test "
        f"utterances x {len(names)} checkpoints ({names}) in {wall:.3f} s; mean transcript "
        f"{[round(v, 1) for v in lengths]} chars; routes {routes}; launches {counts}")


def serve_phase(torch, card: str, exp: str, feats: list) -> tuple:
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.serving import (
        StreamingTranscriber,
        Transcriber,
    )

    t = Transcriber(exp, batch_size=B, pad_time_multiple=128, device="cuda")
    t.warmup([max(len(f) for f in feats)])
    n_batches = -(-len(feats) // B)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lc.reset_launch_counts()
    t0 = time.perf_counter()
    texts = t.transcribe(feats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(lc.LAUNCHES)
    want = {**dict.fromkeys(counts, 0), "lstm_scan_fusedin": n_batches,
            "lstm_scan": 3 * n_batches}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want} for {n_batches} batches")

    stream = StreamingTranscriber(t, max_wait_ms=50.0)
    try:
        futs = [stream.submit(f) for f in feats[:4]]
        streamed = [f.result(timeout=600) for f in futs]
    finally:
        stream.close()
    vocab = set("ABCDEFGHIJKLMNOPQRSTUVWXYZ' ")
    if len(streamed) != 4 or not all(set(s) <= vocab for s in streamed):
        raise AssertionError("streamed transcripts malformed")
    launches = dict(lc.LAUNCHES)
    if not all(launches[k] > counts[k] for k in ("lstm_scan_fusedin", "lstm_scan")):
        raise AssertionError(f"streaming ran no kernel: {launches}")
    peak = torch.cuda.max_memory_allocated()
    same = sum(a == b for a, b in zip(streamed, t.transcribe(feats[:4])))
    log(f"[{card}] streamed 4 requests; {same}/4 equal to one direct batch of the same 4")
    if len(texts) != len(feats) or not all(set(s) <= vocab for s in texts):
        raise AssertionError("transcripts malformed")
    log(f"[{card}] serve base-LAS bf16: {len(feats)} utts ({MIN_FRAMES}-{MAX_FRAMES} frames) "
        f"in {n_batches} batches of {B}: {wall:.3f} s, {len(feats) / wall:.2f} utt/s, "
        f"{wall / n_batches * 1e3:.1f} ms/batch, peak device memory "
        f"{peak / 2**20:.1f} MiB; mean transcript {sum(map(len, texts)) / len(texts):.1f} chars")
    log(f"[{card}] launches in the served run: {launches}")
    return t, launches


def parity_phase(torch, card: str, t, feats: list) -> None:
    import dataclasses

    import numpy as np

    from attention_based_e2e_asr_dnn_tpu_torch.decoding.greedy import greedy_decode_early_stop
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import listener_apply
    from attention_based_e2e_asr_dnn_tpu_torch.data.batching import pad_to_multiple

    batch = feats[:B]
    t_pad = pad_to_multiple(max(map(len, batch)), 128)
    x = np.zeros((B, t_pad, 15), np.float32)
    for r, f in enumerate(batch):
        x[r, : len(f)] = f
    x = torch.from_numpy(x).cuda()
    lx = torch.tensor([len(f) for f in batch], dtype=torch.int32).cuda()
    kern_cfg = t.cfg.listener
    plain_cfg = dataclasses.replace(kern_cfg, lstm_impl="scan")
    sp = t.params["speller"]
    with torch.inference_mode():
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            enc_k, el = listener_apply(t.params["listener"], kern_cfg, x.to(dtype), lx)
            enc_p, _ = listener_apply(t.params["listener"], plain_cfg, x.to(dtype), lx)
            if not torch.isfinite(enc_k.float()).all():
                raise AssertionError("encoder output not finite")
            err = (enc_k.float() - enc_p.float()).abs().max().item()
            ids_k = greedy_decode_early_stop(sp, t.cfg.speller, enc_k, el)
            ids_p = greedy_decode_early_stop(sp, t.cfg.speller, enc_p, el)
            # ids are PAD after a row's first <eos>: equal rows, equal transcripts
            same = int((ids_k == ids_p).all(dim=1).sum())
            log(f"[{card}] listener kernels vs plain, {dtype_name}: encoder max_abs_err "
                f"{err:.3e}; identical transcripts {same}/{B}")
            if dtype_name == "float32":
                if not err <= TOL["float32"]:
                    raise AssertionError(f"float32 encoder error {err}")
                if not torch.equal(ids_k, ids_p):
                    raise AssertionError("float32 greedy ids differ kernel vs plain")


BEAM = 8


def check_preds(path: str, n_rows: int, what: str) -> list:
    """A submission CSV in template order: ``id,label`` and ``n_rows`` rows
    of in-vocabulary labels; returns the labels."""
    vocab = set("ABCDEFGHIJKLMNOPQRSTUVWXYZ' ")
    with open(path) as fh:
        lines = fh.read().split("\n")
    rows = [ln.split(",", 1) for ln in lines[1:-1]]
    if (lines[0] != "id,label" or lines[-1] != "" or
            [r[0] for r in rows] != [str(i) for i in range(n_rows)] or
            not all(len(r) == 2 and set(r[1]) <= vocab for r in rows)):
        raise AssertionError(f"{what}: {os.path.basename(path)} malformed")
    return [r[1] for r in rows]


def beam_phase(torch, card: str, exp: str, feats: list, data: str, work: str) -> dict:
    """Beam search at base-LAS (phase 15): ``Transcriber(beam_size=8)`` and the
    infer CLI with ``beam_size: 8``, then on one batch the float32 beam ids
    of the listener kernels against those of the plain loops, beam 1
    against greedy, and the dev pass of a beam run (``eval_beam_size``) on
    each tier; returns the launches of the served runs and the dev pass."""
    import dataclasses

    import numpy as np

    from attention_based_e2e_asr_dnn_tpu_torch import infer
    from attention_based_e2e_asr_dnn_tpu_torch.data.batching import pad_to_multiple
    from attention_based_e2e_asr_dnn_tpu_torch.decoding.beam import beam_search
    from attention_based_e2e_asr_dnn_tpu_torch.decoding.greedy import greedy_decode_early_stop
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import listener_apply
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
    from attention_based_e2e_asr_dnn_tpu_torch.serving import Transcriber

    vocab = set("ABCDEFGHIJKLMNOPQRSTUVWXYZ' ")
    launches = {"lstm_scan_fusedin": 0, "lstm_scan": 0}

    def run(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lc.reset_launch_counts()
        sc.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**lc.LAUNCHES, **sc.LAUNCHES}
        for k in launches:
            launches[k] += counts[k]
        return out, wall, counts, torch.cuda.max_memory_allocated()

    t = Transcriber(exp, beam_size=BEAM, batch_size=B, pad_time_multiple=128, device="cuda")
    t.warmup([max(len(f) for f in feats)])
    n_batches = -(-len(feats) // B)
    texts, wall, counts, peak = run(lambda: t.transcribe(feats))
    want = {**dict.fromkeys(counts, 0), "lstm_scan_fusedin": n_batches,
            "lstm_scan": 3 * n_batches}
    if counts != want:
        raise AssertionError(f"beam serve: launches {counts} != {want}")
    if len(texts) != len(feats) or not all(set(s) <= vocab for s in texts):
        raise AssertionError("beam serve: transcripts malformed")
    log(f"[{card}] serve base-LAS bf16 beam {BEAM}: {len(feats)} utts in {n_batches} batches "
        f"of {B}: {wall:.3f} s, {len(feats) / wall:.2f} utt/s, "
        f"{wall / n_batches * 1e3:.1f} ms/batch, peak device memory {peak / 2**20:.1f} MiB; "
        f"mean transcript {sum(map(len, texts)) / len(texts):.1f} chars; launches {counts}")

    cfg_path = os.path.join(work, "infer-beam.yml")
    with open(cfg_path, "w") as fh:
        fh.write(f"SOME_FOLDER: {data}\nexp_folder: {exp}\nbatch_size: {INFER_BATCH}\n"
                 f"pad_time_multiple: 256\nrun_all: true\nepoch_num: null\nrun_avg: true\n"
                 f"beam_size: {BEAM}\n")
    n_ckpts, n_infer = 3, -(-N_TEST_UTTS // INFER_BATCH)
    _, wall, counts, peak = run(lambda: infer.main(
        infer.build_argparser().parse_args(["-c", cfg_path, "--device", "cuda"])))
    fwd = forward_launches(torch, torch.bfloat16, INFER_BATCH, H, 15)
    want = {**dict.fromkeys(counts, 0), "lstm_scan_fusedin": fwd * n_infer * n_ckpts,
            "lstm_scan": 3 * fwd * n_infer * n_ckpts}
    if counts != want:
        raise AssertionError(f"infer beam: launches {counts} != {want}")
    for name in ("min-loss-ld-ppl-epoch[1]", "min-loss-ld-ppl-epoch[2]", "avg-all"):
        check_preds(os.path.join(exp, "preds", f"{name}-tst.csv"), N_TEST_UTTS, "infer beam")
    decoded = N_TEST_UTTS * n_ckpts
    log(f"[{card}] infer base-LAS bf16 beam_size={BEAM}: {decoded} utts ({n_ckpts} "
        f"checkpoints x {n_infer} batches of {INFER_BATCH}) in {wall:.3f} s (whole CLI run), "
        f"{decoded / wall:.2f} utt/s, {wall / (n_infer * n_ckpts) * 1e3:.1f} ms/batch, peak "
        f"device memory {peak / 2**20:.1f} MiB; launches {counts}")

    batch = feats[:B]
    t_pad = pad_to_multiple(max(map(len, batch)), 128)
    x = np.zeros((B, t_pad, 15), np.float32)
    for r, f in enumerate(batch):
        x[r, : len(f)] = f
    x = torch.from_numpy(x).cuda()
    lx = torch.tensor([len(f) for f in batch], dtype=torch.int32).cuda()
    kern_cfg = t.cfg.listener
    plain_cfg = dataclasses.replace(kern_cfg, lstm_impl="scan")
    sp, spl = t.params["speller"], t.cfg.speller
    with torch.inference_mode():
        enc_k, el = listener_apply(t.params["listener"], kern_cfg, x, lx)
        enc_p, _ = listener_apply(t.params["listener"], plain_cfg, x, lx)
        ids_k = beam_search(sp, spl, enc_k, el, BEAM)
        ids_p = beam_search(sp, spl, enc_p, el, BEAM)
        if not np.array_equal(ids_k, ids_p):
            raise AssertionError("float32 beam ids differ, listener kernels against plain")
        same = {}
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            enc, el = listener_apply(t.params["listener"], kern_cfg, x.to(dtype), lx)
            one = beam_search(sp, spl, enc, el, 1)
            greedy = greedy_decode_early_stop(sp, spl, enc, el).cpu().numpy()
            same[name] = int((one == greedy).all(axis=1).sum())
            if same[name] != B:
                raise AssertionError(f"{name}: beam 1 differs from greedy in "
                                     f"{B - same[name]} rows")
    log(f"[{card}] beam {BEAM} float32 ids, listener kernels vs plain loops: equal in "
        f"{B}/{B} rows; beam 1 equal to greedy in {same['float32']}/{B} (float32) and "
        f"{same['bfloat16']}/{B} (bfloat16) rows")
    for name, count in eval_beam_check(torch, card, t, x, lx).items():
        launches[name] = launches.get(name, 0) + count
    return launches


EVAL_LABELS = 64  # the dev labels' horizon, so the loss decode's steps


def eval_beam_check(torch, card: str, t, x, lx) -> dict:
    """The dev pass of a beam run (``make_las_eval_beam_step``, what
    ``train.py`` runs for ``eval_beam_size > 1``) on one batch of phase 4's
    utterances with seeded labels, on the kernel tier of ``t``'s model and
    on the plain tier (``lstm_impl`` and ``decoder_impl`` scan), in float32
    and bfloat16. The kernel tier launches the listener kernels and #8's
    eval form once a batch, for the loss decode, and the beam nothing more
    (the same counts with and without its ids); the loss is held to the
    plain tier's (float32 ``TOL``, bfloat16 ``SPELLER_TRAIN_TOL`` of it)
    and the float32 beam ids equal. Returns the bfloat16 kernel tier's
    launches."""
    import dataclasses

    import numpy as np

    from attention_based_e2e_asr_dnn_tpu_torch.decoding.beam import make_las_eval_beam_step
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    rng = np.random.default_rng(SEED + 5)
    batch = x.shape[0]
    ly = torch.from_numpy(rng.integers(2, EVAL_LABELS + 1, batch)).to(torch.int32)
    ly[0] = EVAL_LABELS
    y = torch.from_numpy(rng.integers(1, 29, (batch, EVAL_LABELS)))
    y[torch.arange(EVAL_LABELS)[None, :] >= ly[:, None].long() - 1] = 29  # <eos>, then PAD
    y, ly = y.cuda(), ly.cuda()
    plain_cfg = dataclasses.replace(
        t.cfg, listener=dataclasses.replace(t.cfg.listener, lstm_impl="scan"),
        speller=dataclasses.replace(t.cfg.speller, decoder_impl="scan"))
    want = {"lstm_scan_fusedin": 1, "lstm_scan": 3, "speller_decode": 1}
    kept, notes = {}, []
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        out = {}
        for tier, cfg in (("kernels", t.cfg), ("plain", plain_cfg)):
            step = make_las_eval_beam_step(cfg, BEAM, compute_dtype=dtype)
            seen = []
            for want_ids in (False, True):
                lc.reset_launch_counts()
                sc.reset_launch_counts()
                metrics, ids = step(t.params, x, lx, y, ly, want_ids=want_ids)
                torch.cuda.synchronize()
                seen.append({k: v for k, v in {**lc.LAUNCHES, **sc.LAUNCHES}.items() if v})
            wanted = want if tier == "kernels" else {}
            if tier == "kernels" and dtype == torch.bfloat16:
                kept = seen[-1]
            if seen != [wanted, wanted]:
                raise AssertionError(f"eval beam {name} {tier}: launches {seen} (without, with "
                                     f"the beam), not {wanted}")
            loss = float(metrics["loss"])
            if not (np.isfinite(loss) and ids.shape == (batch, t.cfg.speller.CHR_MAX_STEPS)):
                raise AssertionError(f"eval beam {name} {tier}: loss {loss}, ids {ids.shape}")
            out[tier] = (loss, ids.numpy())
        (loss_k, ids_k), (loss_p, ids_p) = out["kernels"], out["plain"]
        err = abs(loss_k - loss_p)
        tol = TOL["float32"] if dtype == torch.float32 else SPELLER_TRAIN_TOL[name] * abs(loss_p)
        equal = int((ids_k == ids_p).all(axis=1).sum())
        notes.append(f"{name} loss {loss_k:.6f} vs {loss_p:.6f} (|diff| {err:.3e}, tol "
                     f"{tol:.3e}), beam ids equal in {equal}/{batch} rows")
        if not err <= tol or (dtype == torch.float32 and equal != batch):
            raise AssertionError(f"eval beam {name}: " + notes[-1])
    log(f"[{card}] eval beam step (beam {BEAM}, {EVAL_LABELS}-step loss decode) B={batch}, "
        f"kernel tier vs plain: " + "; ".join(notes) + f"; launches a dev batch {want}, "
        f"none of them the beam's")
    return kept


# the model block of configs/rewriter.yml, both kernel tiers configured (the
# file sets neither, so both default to scan)
KERNEL_TIERS = {"lstm_impl": "pallas", "decoder_impl": "pallas"}
REWRITER_MODEL = {"emb_dim": 256, "enc_lstm_layers": 2, "enc_lstm_hid_dim": 256,
                  "enc_dropouts": [0.2, 0.2], "att_proj_dim": 128, "att_heads": 1,
                  "att_dropout": 0.2, "dec_lstm_layers": 2, "dec_lstm_hid_dim": 256,
                  "dec_lstm_out_dim": 128, "dec_lstm_dropout": 0.2, "CHR_MAX_STEPS": 600,
                  "lstm_impl": "pallas", "decoder_impl": "pallas"}
# configs/lm-infer.yml's batch; prediction lines of 100-600 characters, so
# the encoder length (the text's, with <sos> and <eos>, padded to 32) runs
# to 608; a calibration set of 64 labelled pairs
N_LM_LINES, LM_BATCH, N_CAL = 256, 256, 64
MIN_CHARS, MAX_CHARS, LM_TE = 100, 600, 608
REWRITER_H = 256
WORDS = ("THE", "A", "OF", "AND", "TO", "IN", "HE", "WAS", "THAT", "IT", "HIS", "WITH",
         "AS", "FOR", "HAD", "YOU", "NOT", "BE", "HER", "IS", "BUT", "SAID", "WHICH", "IT'S")


def lm_line(rng, n_chars: int) -> str:
    """About ``n_chars`` characters of words from ``WORDS``."""
    words = []
    while sum(len(w) + 1 for w in words) < n_chars:
        words.append(WORDS[int(rng.integers(len(WORDS)))])
    return " ".join(words)[:n_chars].strip()


def make_lm_experiment(torch, root: str) -> str:
    """A Rewriter experiment folder: configs/rewriter.yml's model block with
    both kernel tiers, its bfloat16 policy, one seeded checkpoint."""
    import numpy as np

    from attention_based_e2e_asr_dnn_tpu_torch import EOS_IDX, SOS_IDX, VOCAB
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import (
        RewriterConfig,
        rewriter_init,
        rewriter_to_jax_params,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import save_checkpoint

    snap = {"compute_dtype": "bfloat16", "VOCAB": list(VOCAB), "SOS_IDX": SOS_IDX,
            "EOS_IDX": EOS_IDX, "model": {"tag": "base-Rewriter", "configs": REWRITER_MODEL}}
    os.makedirs(os.path.join(root, "ckpts"))
    with open(os.path.join(root, "config.json"), "w") as fh:
        json.dump(snap, fh)
    params = rewriter_to_jax_params(rewriter_init(RewriterConfig(**REWRITER_MODEL),
                                                  torch.Generator().manual_seed(SEED)))
    rng = np.random.default_rng(SEED)
    for key in ("init_h1", "init_c1", "init_h2", "init_c2"):
        params["decoder"][key] = rng.uniform(-0.5, 0.5, params["decoder"][key].shape
                                             ).astype("float32")
    save_checkpoint(os.path.join(root, "ckpts", "min-loss-epoch[1].ckpt"),
                    {"params": params, "epoch": 1})
    return root


def make_lm_data(root: str, rng) -> dict:
    """The prediction CSV with its template, and a calibration set: gold
    transcripts (reference layout, <sos>/<eos> tagged) and predictions of
    them with one character in 20 replaced."""
    import numpy as np

    tst = os.path.join(root, "test-clean")
    os.makedirs(os.path.join(tst, "transcript"))
    with open(os.path.join(tst, "transcript", "random_submission.csv"), "w") as fh:
        fh.write("id,label\n" + "".join(f"{i},X\n" for i in range(N_LM_LINES)))
    lines = [lm_line(rng, int(n)) for n in rng.integers(MIN_CHARS, MAX_CHARS + 1, N_LM_LINES)]
    lines[0] = lm_line(rng, MAX_CHARS)
    preds = os.path.join(root, "pred-test.csv")
    with open(preds, "w") as fh:
        fh.write("id,label\n" + "".join(f"{i},{s}\n" for i, s in enumerate(lines)))
    cal_trans = os.path.join(root, "cal-trans")
    os.makedirs(cal_trans)
    cal = []
    for i, n in enumerate(rng.integers(MIN_CHARS, MAX_CHARS + 1, N_CAL)):
        gold = lm_line(rng, int(n))
        np.save(os.path.join(cal_trans, f"{i:04d}.npy"), np.array(["<sos>", *gold, "<eos>"]))
        noisy = [c if rng.random() > 0.05 else "Q" for c in gold]
        cal.append("".join(noisy))
    cal_pred = os.path.join(root, "pred-dev.csv")
    with open(cal_pred, "w") as fh:
        fh.write("id,label\n" + "".join(f"{i},{s}\n" for i, s in enumerate(cal)))
    return {"tst": tst, "preds": preds, "cal_pred": cal_pred, "cal_trans": cal_trans,
            "chars": sum(map(len, lines))}


class capture:
    """Records the arguments of every call of ``module.<name>`` inside the
    block it wraps, calling through; the block's value is the list of
    ``(args, kwargs)``. The module's own code looks the name up at each
    call, so the main path's calls are the ones recorded. With ``limit``,
    only the first ``limit`` calls of the longest time axis seen (dimension
    1 of positional argument ``arg``): a training run's longest batch."""

    def __init__(self, module, name: str, limit: int = 0, arg: int = 0):
        self.module, self.name, self.calls, self.limit, self.arg = module, name, [], limit, arg
        self.longest = 0

    def __enter__(self):
        self.inner = inner = getattr(self.module, self.name)

        def record(*args, **kwargs):
            if not self.limit:
                self.calls.append((args, kwargs))
            else:
                length = args[self.arg].shape[1]
                if length > self.longest:
                    self.longest = length
                    self.calls.clear()
                if length == self.longest and len(self.calls) < self.limit:
                    self.calls.append((args, kwargs))
            return inner(*args, **kwargs)

        setattr(self.module, self.name, record)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def rewriter_scan_record(torch, card: str, what: str, calls: list) -> dict:
    """#1 (``lstm_scan``) held against its plain version (``TOL``) on the
    Rewriter encoder's own layer inputs, recorded in a main-path run
    (``calls`` of ``bilstm_apply_kernel``: layer, x, lengths; both layers
    take ``lstm_scan``, their inputs being wider than 128); timed, with its
    bound and nn.LSTM on the same input, at the call of the most frames.
    Returns the record, its launches to be filled in."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc

    checked = []
    with torch.inference_mode():
        for (layer, x, lengths), _ in calls:
            fwd, bwd, dtype = layer["fwd"], layer["bwd"], x.dtype
            w_ih = torch.cat([fwd["w_ih"], bwd["w_ih"]], dim=1).to(dtype)
            b = torch.cat([fwd["b"], bwd["b"]]).to(dtype)
            args = (torch.matmul(x, w_ih) + b, torch.stack([fwd["w_hh"], bwd["w_hh"]]).to(dtype),
                    lengths, (False, True))
            before = lc.LAUNCHES["lstm_scan"]
            got = lc.lstm_scan(*args)
            n_launch = lc.LAUNCHES["lstm_scan"] - before
            # a two-direction layer call: the plan's launches (float32 up to
            # B=256 at H=256: one, every row and both directions)
            if n_launch != forward_launches(torch, dtype, x.shape[0], args[1].shape[1]):
                raise AssertionError(f"lstm_scan (Rewriter) B={x.shape[0]}: {n_launch} launches")
            err = (got.float() - lc.lstm_scan_plain(*args).float()).abs().max().item()
            checked.append((int(lengths.sum()), err, x, args, got))
    dtype_name = str(x.dtype).split(".")[-1]
    err = max(c[1] for c in checked)
    shapes = sorted({tuple(c[2].shape) for c in checked}, reverse=True)
    frames, _, x, args, got = max(checked, key=lambda c: c[0])
    batch, seq, hid = x.shape[0], x.shape[1], args[1].shape[1]
    with torch.inference_mode():
        ms = cuda_median_ms(torch, lambda: lc.lstm_scan(*args), 10)
        plain_ms = cuda_median_ms(torch, lambda: lc.lstm_scan_plain(*args), 2)
    bound, bound_by = bound_ms(2 * frames * 2 * 4 * hid * hid,
                               valid_bytes(frames, args[0]) + nbytes(args[1], args[2], got),
                               x.dtype)
    library_ms = nn_lstm_ms(torch, x.clone(), args[2], x.dtype, "infer", hidden=hid)
    log(f"[{card}] lstm_scan (Rewriter) {dtype_name}, {what}: {len(calls)} calls at layer "
        f"inputs {shapes}: max_abs_err {err:.3e} (tol {TOL[dtype_name]:g}); timed at B={batch} "
        f"T={seq} D={x.shape[2]} ({frames} frames): kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
        f"bound {bound:.3f} ms ({bound_by})  nn.LSTM {fmt_ms(library_ms)} ms")
    if not calls or not err <= TOL[dtype_name]:
        raise AssertionError(f"lstm_scan (Rewriter) {dtype_name}: {len(calls)} calls, "
                             f"max_abs_err {err}")
    name = f"lstm_scan (Rewriter H={hid}{', float32' if x.dtype == torch.float32 else ''})"
    return {"name": name, "route": "cuda",
            "source": SOURCE if x.dtype == torch.float32 else TC_SOURCE,
            "replaces": KERNELS["lstm_scan"][2], "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms}


def rewriter_decode_check(torch, card: str, what: str, operands: tuple, opts: dict,
                          enc_frames: int, relative: bool = False) -> dict:
    """#8's eval form at the Rewriter's decoder widths held against its plain
    version (``SPELLER_TOL``; with ``relative``, ``SPELLER_TRAIN_TOL`` of the
    largest value): the logits forced along the kernel's own ids,
    and the attention weights; timed, with its bound. Returns a record, its
    launches to be filled in."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import RewriterConfig
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    spl = RewriterConfig(**REWRITER_MODEL).speller_config()
    opts = {k: v for k, v in opts.items() if k != "forced"}
    dtype_name = str(operands[0].dtype).split(".")[-1]
    batch, seq = operands[0].shape[:2]
    with torch.inference_mode():
        before = sc.LAUNCHES["speller_decode"]
        logits, wgts, ids = sc.speller_decode(*operands, **opts)
        torch.cuda.synchronize()
        n_launch = sc.LAUNCHES["speller_decode"] - before
        forced = torch.cat([torch.full_like(ids[:1], -1), ids[:-1]]).contiguous()
        p_logits, p_wgts, _ = sc.speller_decode_plain(*operands, **opts, forced=forced)
        ms = cuda_median_ms(torch, lambda: sc.speller_decode(*operands, **opts), 5)
        plain_ms = cuda_median_ms(torch, lambda: sc.speller_decode_plain(*operands, **opts), 1)
    vocab = spl.dec_vocab_size
    (abs_err, err_rel), (w_err, w_rel) = (rel_err(logits[..., :vocab], p_logits[..., :vocab]),
                                          rel_err(wgts, p_wgts))
    err = abs_err
    tol, w_tol = SPELLER_TOL[dtype_name]
    if relative:  # a trained model's logits: a bf16 step of them is past 0.25 above 64
        tol = w_tol = SPELLER_TRAIN_TOL[dtype_name]
        err, w_err = err_rel, w_rel
    proj, h1, h2 = spl.att_proj_dim, spl.dec_lstm_hid_dim, spl.dec_lstm_out_dim
    per_row = 2 * ((proj + h1) * 4 * h1 + (h1 + h2) * 4 * h2 + h2 * proj + 2 * proj * vocab)
    flops = opts["steps"] * (batch * per_row + 4 * proj * enc_frames)
    moved = nbytes(*(t for t in operands if torch.is_tensor(t)), logits, wgts, ids)
    bound, bound_by = bound_ms(flops, moved, dtype_name)
    log(f"[{card}] speller_decode (Rewriter) {dtype_name}, {what}: B={batch} Te={seq} "
        f"T={opts['steps']} H1={h1} H2={h2} P={proj}, {n_launch} launches: forced logits "
        f"{'error of max' if relative else 'max_abs_err'} {err:.3e} (tol {tol:g}), weights "
        f"{w_err:.3e} (tol {w_tol:g}); kernel "
        f"{ms:.3f} ms  plain {plain_ms:.3f} ms  bound {bound:.3f} ms ({bound_by})")
    if n_launch != (2 if dtype_name == "bfloat16" and batch > 128 else 1):
        raise AssertionError(f"speller_decode (Rewriter) {dtype_name}: {n_launch} launches")
    if not (err <= tol and w_err <= w_tol):
        raise AssertionError(f"speller_decode (Rewriter) {dtype_name}: errors {err}, {w_err}")
    name = f"speller_decode (Rewriter, {dtype_name})"
    source = SPELLER_SOURCE if dtype_name == "float32" else SPELLER_TC_SOURCE
    return {"name": name, "route": "cuda", "source": source, "replaces": SPELLER_REPLACES,
            "launches": 0, "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


def rewriter_bf16_decode_check(torch, card: str) -> None:
    """#8's bfloat16 eval form at the Rewriter's decoder widths, B=256 (two
    launches), Te=608, against its plain version. No bfloat16 path of the
    chain runs it (``lminfer`` decodes in float32, the ``Corrector`` never
    through the eval decode); held for the kernel at these widths."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import RewriterConfig, rewriter_init
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    gen = torch.Generator().manual_seed(SEED + 7)
    lm_cfg = RewriterConfig(**REWRITER_MODEL)
    spl = lm_cfg.speller_config()
    batch, seq = LM_BATCH, LM_TE
    lengths = torch.randint(MIN_CHARS + 2, seq + 1, (batch,), generator=gen)
    lengths[0], lengths[1] = seq, 3
    params = rewriter_init(lm_cfg, gen)["decoder"].cuda()
    enc = torch.randn(batch, seq, 2 * REWRITER_H, generator=gen) * 0.5
    enc[torch.arange(seq)[None, :] >= lengths[:, None]] = 0.0
    with torch.inference_mode():
        operands, _ = sc.decode_operands(params, spl, enc.to(torch.bfloat16).cuda(),
                                         lengths.to(torch.int32).cuda())
    rewriter_decode_check(torch, card, "generated encodings", operands,
                          sc.decode_options(spl), int(lengths.sum()))


LM_MODES = {
    # mode: the infer YAML's decode and gate keys
    "early_stop: false": "early_stop: false\ngate_correction: false\n",
    "greedy": "gate_correction: false\n",
    f"beam_size: {BEAM}": f"beam_size: {BEAM}\ngate_correction: false\n",
    "gate, margin 0.1": "confidence_margin: 0.1\n",
    "auto + span_rewrite": 'confidence_margin: "auto"\nspan_rewrite: true\n',
}


def rewriter_phase(torch, card: str, las_exp: str, feats: list, work: str) -> tuple:
    """The Rewriter chain at configs/rewriter.yml's width (phase 16):
    ``lminfer`` in each of ``LM_MODES`` over ``N_LM_LINES`` generated lines
    (float32, as the JAX CLI decodes), the ``Corrector`` (the experiment's
    bfloat16) behind a ``Transcriber`` on phase 4's utterances, and one
    ``tools/serve_http --corrector`` burst. #1 and #8 are held against their
    plain versions on the inputs that ``lminfer``'s fixed decode and the
    ``Corrector`` gave them, and the ``Corrector`` against one on the plain
    loops. Returns the records of the forms the chain launches and their
    launches, keyed by name."""
    import shutil

    import numpy as np

    from attention_based_e2e_asr_dnn_tpu_torch import VOCAB, VOCAB_MAP, lminfer
    from attention_based_e2e_asr_dnn_tpu_torch.models import las
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
    from attention_based_e2e_asr_dnn_tpu_torch.serving import Corrector, Transcriber

    rng = np.random.default_rng(SEED + 3)
    lm_exp = make_lm_experiment(torch, os.path.join(work, "lm-exp"))
    data = make_lm_data(os.path.join(work, "lm-data"), rng)
    f32_rows = ("lstm_scan (Rewriter H=256, float32)", "speller_decode (Rewriter, float32)")
    bf16_row = "lstm_scan (Rewriter H=256)"
    launches = dict.fromkeys((*f32_rows, bf16_row), 0)
    records = {}
    idle = ("lstm_scan_fusedin", "lstm_scan_train", "lstm_scan_fusedin_train", "lstm_bwd_dw",
            "lstm_bwd", "lstm_scan_cs", "bilstm_scan_fused", "speller_decode_train",
            "speller_decode_bwd")
    for mode, keys in LM_MODES.items():
        cfg_path = os.path.join(work, "lm-infer.yml")
        with open(cfg_path, "w") as fh:
            fh.write(f"TST_DIR: {data['preds']}\nTST_FOLDER: {data['tst']}\n"
                     f"exp_folder: {lm_exp}\nbatch_size: {LM_BATCH}\nrun_all: false\n"
                     f"epoch_num: 1\nrun_avg: false\nCAL_PRED_DIR: {data['cal_pred']}\n"
                     f"CAL_TRANS_DIR: {data['cal_trans']}\n{keys}")
        las.reset_decode_routes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lc.reset_launch_counts()
        sc.reset_launch_counts()
        fixed = mode == "early_stop: false"
        with contextlib.ExitStack() as stack:
            if fixed:  # the kernels' inputs in this run, held below
                enc_calls = stack.enter_context(capture(lc, "bilstm_apply_kernel"))
                dec_calls = stack.enter_context(capture(sc, "speller_decode"))
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(Tee(sys.stdout)) as tee:
                lminfer.main(lminfer.build_argparser().parse_args(["-c", cfg_path,
                                                                   "--device", "cuda"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out = tee.getvalue()
        counts = {**lc.LAUNCHES, **sc.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        if (counts["lstm_scan"] <= 0 or counts["speller_decode"] != int(fixed)
                or any(counts[k] for k in idle)):
            raise AssertionError(f"lminfer {mode}: launches {counts}")
        routes = las.decode_route_report()
        if fixed and set(routes.values()) != {"cuda"}:
            raise AssertionError(f"lminfer {mode}: decode routes {routes}")
        preds = check_preds(os.path.join(lm_exp, "ckpts", "min-loss-epoch[1]-pred.csv"),
                            N_LM_LINES, f"lminfer {mode}")
        gate = [ln.strip() for ln in out.splitlines() if "gate kept" in ln or "auto-cal" in ln]
        launches[f32_rows[0]] += counts["lstm_scan"]
        launches[f32_rows[1]] += counts["speller_decode"]
        log(f"[{card}] lminfer Rewriter float32 {mode}: {N_LM_LINES} lines "
            f"({data['chars']} chars, {MIN_CHARS}-{MAX_CHARS} a line) in {wall:.3f} s (whole CLI "
            f"run{', the calibration set first' if 'auto' in mode else ''}), "
            f"{N_LM_LINES / wall:.2f} lines/s, peak device memory {peak / 2**20:.1f} MiB; "
            f"mean output {sum(map(len, preds)) / len(preds):.1f} chars; {gate}; routes "
            f"{routes}; launches {counts}")
    what = "lminfer early_stop: false"
    records[f32_rows[0]] = rewriter_scan_record(torch, card, what, enc_calls)
    (operands, opts), = dec_calls
    records[f32_rows[1]] = rewriter_decode_check(torch, card, what, operands, opts,
                                                 int(enc_calls[0][0][2].sum()))
    del enc_calls, dec_calls, operands
    rewriter_bf16_decode_check(torch, card)
    torch.cuda.empty_cache()

    # the calibration's host work: the pure-Python edit distance of each
    # prediction to its gold transcript, once for the inputs and once a
    # candidate family; one such pass timed here
    from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import LmTestDataset, _npy_files
    from attention_based_e2e_asr_dnn_tpu_torch.utils.levenshtein import ids_to_str, levenshtein

    cal = [ids_to_str(x, VOCAB, 0, 29) for x in LmTestDataset(data["cal_pred"], VOCAB_MAP)]
    golds = ["".join(str(c) for c in np.load(f)[1:-1]) for f in _npy_files(data["cal_trans"])]
    t0 = time.perf_counter()
    for a, g in zip(cal, golds):
        levenshtein(a, g)
    log(f"[{card}] calibration host work: one pass of Levenshtein over the {len(cal)} "
        f"pairs ({sum(map(len, cal))} / {sum(map(len, golds))} chars) "
        f"{time.perf_counter() - t0:.3f} s (the auto mode takes one pass for the inputs "
        f"and one a candidate family)")

    corrector = Corrector(lm_exp, device="cuda")
    plain = Transcriber(las_exp, batch_size=B, pad_time_multiple=128, device="cuda")
    t = Transcriber(las_exp, batch_size=B, pad_time_multiple=128, corrector=corrector,
                    device="cuda")
    texts = plain.transcribe(feats)
    corrector.correct(texts[:B])  # warm
    torch.cuda.synchronize()
    lc.reset_launch_counts()
    with capture(lc, "bilstm_apply_kernel") as enc_calls:
        t0 = time.perf_counter()
        corrected = corrector.correct(texts)
        torch.cuda.synchronize()
        corr_wall = time.perf_counter() - t0
    corr_counts = dict(lc.LAUNCHES)
    lc.reset_launch_counts()
    t0 = time.perf_counter()
    served = t.transcribe(feats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(lc.LAUNCHES)
    n_batches = -(-len(feats) // B)
    if served != corrected:
        raise AssertionError("Transcriber(corrector=...) differs from correct(transcribe)")
    if counts["lstm_scan"] != 3 * n_batches + corr_counts["lstm_scan"] or not \
            corr_counts["lstm_scan"] > 0:
        raise AssertionError(f"corrector: launches {counts}, the correction's {corr_counts}")
    launches[bf16_row] += corr_counts["lstm_scan"]
    changed = sum(a != b for a, b in zip(texts, corrected))
    log(f"[{card}] Corrector (Rewriter bf16, beam {BEAM}, gate margin 0) over "
        f"{len(feats)} transcripts of base-LAS (mean {sum(map(len, texts)) / len(texts):.1f} "
        f"chars) in {n_batches} batches of {B}: {corr_wall:.3f} s, "
        f"{corr_wall / n_batches * 1e3:.1f} ms/batch; {changed} rewritten; Transcriber with "
        f"it: {wall:.3f} s, {len(feats) / wall:.2f} utt/s, equal to correct(transcribe); "
        f"launches of the correction {corr_counts}")
    records[bf16_row] = rewriter_scan_record(torch, card, "the Corrector's batches", enc_calls)
    del enc_calls
    # the same experiment on the plain loops
    scan_exp = os.path.join(work, "lm-exp-scan")
    shutil.copytree(lm_exp, scan_exp)
    with open(os.path.join(scan_exp, "config.json")) as fh:
        snap = json.load(fh)
    snap["model"]["configs"]["lstm_impl"] = "scan"
    with open(os.path.join(scan_exp, "config.json"), "w") as fh:
        json.dump(snap, fh)
    corrector_parity(torch, card, corrector, Corrector(scan_exp, device="cuda"), texts,
                     corrected)

    launches[bf16_row] += http_corrector_burst(torch, card, las_exp, lm_exp, feats)
    return records, launches


def corrector_parity(torch, card: str, corrector, plain, texts: list, corrected: list) -> None:
    """The ``Corrector`` on the kernels against ``plain``, the same experiment
    on the plain loops, over the same batches of ``texts``: in the
    experiment's bfloat16 the gate's margins of the kernel tier's rewrites,
    scored by each, within ``TOL``, and the served strings counted equal; in
    float32 (the chain of each tier on the same weights) the beam rewrite
    ids equal and their margins within ``TOL``."""
    import dataclasses

    import numpy as np

    from attention_based_e2e_asr_dnn_tpu_torch.constants import EOS_IDX, SOS_IDX, VOCAB_MAP
    from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher
    from attention_based_e2e_asr_dnn_tpu_torch.decoding.rescore import (
        RewriteChain,
        gate_corrections,
    )

    ids = [np.array([SOS_IDX] + [VOCAB_MAP[c] for c in t if c in VOCAB_MAP] + [EOS_IDX],
                    np.int32) for t in texts]
    batches = [(bt.x, bt.lx.astype(np.int32)) for bt in BucketBatcher(
        ids, corrector.batch_size, pad_time_multiple=32, has_labels=False,
        label_pad_id=EOS_IDX).epoch(0)]
    same = sum(a == b for a, b in zip(corrected, plain.correct(texts)))
    bf16_err = 0.0
    for x, lx in batches:
        dec = np.asarray(corrector.chain.step(corrector.params, x, lx))
        (ck, ik), (cp, ip) = (gate_corrections(c.chain.scorer, c.params, x, lx, dec, EOS_IDX,
                                               SOS_IDX)[1:] for c in (corrector, plain))
        bf16_err = max(bf16_err, float(np.abs((ck - ik) - (cp - ip)).max()))
    chains = [RewriteChain(dataclasses.replace(corrector.lm_cfg, lstm_impl=impl),
                           torch.float32, beam_size=BEAM) for impl in ("pallas", "scan")]
    f32_err, rows = 0.0, 0
    for x, lx in batches:
        (ids_k, m_k), (ids_p, m_p) = (ch(corrector.params, x, lx)["rewrite"] for ch in chains)
        if not np.array_equal(ids_k, ids_p):
            raise AssertionError("Corrector float32: beam rewrite ids differ, kernels "
                                 "against plain loops")
        f32_err, rows = max(f32_err, float(np.abs(m_k - m_p).max())), rows + len(lx)
    log(f"[{card}] Corrector kernels vs plain loops over {len(texts)} transcripts in "
        f"{len(batches)} batches: bfloat16 gate margins of the same rewrites max_abs_err "
        f"{bf16_err:.3e} (tol {TOL['bfloat16']:g}), served strings equal in {same}/"
        f"{len(texts)}; float32 beam {BEAM} rewrite ids equal in {rows}/{rows} rows, margins "
        f"max_abs_err {f32_err:.3e} (tol {TOL['float32']:g})")
    if not (bf16_err <= TOL["bfloat16"] and f32_err <= TOL["float32"]):
        raise AssertionError(f"Corrector: margins differ, bfloat16 {bf16_err}, "
                             f"float32 {f32_err}")


def http_corrector_burst(torch, card: str, las_exp: str, lm_exp: str, feats: list) -> int:
    """``tools/serve_http --corrector`` in-process on a free loopback port:
    six POSTs at once; every reply equal to ``Transcriber(corrector=...)``
    on the same utterance alone; returns the Rewriter's ``lstm_scan``
    launches."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.tools import serve_http

    args = serve_http.build_argparser().parse_args(
        [las_exp, "--host", "127.0.0.1", "--port", "0", "--batch-size", str(B),
         "--corrector", lm_exp, "--corrector-margin", "0.05"])
    t, server = serve_http.start(args)
    url = f"http://127.0.0.1:{server.port}/v1/transcribe"
    # the Rewriter's launches: the count's rise inside each correct() (the
    # queue's one dispatcher thread runs the listener and the corrector in
    # turn)
    inner, rewriter = t.corrector.correct, []

    def correct(texts):
        before = lc.LAUNCHES["lstm_scan"]
        out = inner(texts)
        rewriter.append(lc.LAUNCHES["lstm_scan"] - before)
        return out

    t.corrector.correct = correct

    def post(f):
        req = urllib.request.Request(url, data=json.dumps({"features": f.tolist()}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/v1/meta",
                                    timeout=60) as resp:
            meta = json.loads(resp.read())
        if not meta["corrector"]:
            raise AssertionError(f"http --corrector: /v1/meta {meta}")
        lc.reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(6) as pool:
            replies = list(pool.map(post, feats[:6]))
        wall = time.perf_counter() - t0
        counts, per_call = dict(lc.LAUNCHES), list(rewriter)
    finally:
        server.close()
    vocab = set("ABCDEFGHIJKLMNOPQRSTUVWXYZ' ")
    if not all(code == 200 and set(body["transcript"]) <= vocab for code, body in replies):
        raise AssertionError(f"http --corrector: replies {replies}")
    alone = [t.transcribe([f])[0] for f in feats[:6]]
    same = sum(body["transcript"] == a for (_, body), a in zip(replies, alone))
    # each correct() encodes each batch twice (the rewrite, the gate's
    # scorer), one launch a layer for up to 128 rows
    layers = len(t.corrector.params["encoder"])
    if not per_call or any(n <= 0 or n % layers for n in per_call):
        raise AssertionError(f"http --corrector: the Rewriter's launches {per_call} a "
                             f"correct(), {layers} layers; all {counts}")
    log(f"[{card}] serve_http --corrector (margin 0.05) burst of 6 POSTs: {wall:.3f} s; "
        f"{same}/6 equal to the same utterance corrected alone (the queue batches them "
        f"together); the Rewriter's lstm_scan launches {per_call} in {len(per_call)} "
        f"correct() calls; all launches {counts}")
    return sum(per_call)


# ---------------------------------------------------------------------------
# 17. The Rewriter trains: the lmtrain CLI, a resume, lminfer from its folder
# ---------------------------------------------------------------------------

# a generated (prediction, gold) corpus of lines of 100-600 characters, one
# character in 20 of each prediction replaced; configs/rewriter.yml as it
# stands but for its data paths and epochs (bfloat16, batch 64, accu_grad 2)
N_LM_TRAIN, N_LM_DEV, LM_EPOCHS = 512, 64, 3


def make_lm_train_data(root: str, rng) -> dict:
    """Gold transcripts (reference layout: ``.npy`` character arrays with
    <sos> and <eos>) and their predictions (a submission CSV), for train and
    dev; a template of the dev split's rows for ``lminfer``."""
    import numpy as np

    tst = os.path.join(root, "test-clean")
    os.makedirs(os.path.join(tst, "transcript"))
    with open(os.path.join(tst, "transcript", "random_submission.csv"), "w") as fh:
        fh.write("id,label\n" + "".join(f"{i},X\n" for i in range(N_LM_DEV)))
    out = {"tst": tst}
    for split, n in (("train", N_LM_TRAIN), ("dev", N_LM_DEV)):
        trans = os.path.join(root, split, "transcript", "raw")
        os.makedirs(trans)
        preds = []
        sizes = rng.integers(MIN_CHARS, MAX_CHARS + 1, n)
        sizes[0] = MAX_CHARS
        for i, size in enumerate(sizes):
            gold = lm_line(rng, int(size))
            np.save(os.path.join(trans, f"{i:04d}.npy"), np.array(["<sos>", *gold, "<eos>"]))
            preds.append("".join(c if rng.random() > 0.05 else "Q" for c in gold))
        pred = os.path.join(root, split, "pred.csv")
        with open(pred, "w") as fh:
            fh.write("id,label\n" + "".join(f"{i},{s}\n" for i, s in enumerate(preds)))
        out[split] = (trans, pred)
    return out


def lm_lstm_train_records(torch, card: str, layer_calls: list, fwd_calls: list,
                          bwd_calls: list) -> dict:
    """#4 (``lstm_scan_train``) and #5 (``lstm_bwd_dw``) held against their
    plain versions (``TRAIN_TOL``, of max) on the inputs the ``lmtrain``
    CLI's step of its longest batch gave them (the encoder's two layers);
    timed, with their
    bounds and cuDNN's ``nn.LSTM`` on the layer's own input, at layer 1's
    call (D=512). Returns the records, their launches to be filled in."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc

    errs = {}
    with torch.no_grad():
        # the forward layer by layer; the adjoint runs the layers in reverse
        for i, ((x_proj, w_hh, lengths, rev), _) in enumerate(fwd_calls):
            got = lc.lstm_scan_train(x_proj, w_hh, lengths, rev)
            want = lc.lstm_scan_train_plain(x_proj, w_hh, lengths, rev)
            for n, a, b in zip(("hs", "cs", "gates"), got, want):
                errs[f"layer {i} {n}"] = rel_err(a, b)
            del want
        for i, ((gates, cs, hs, dy, w_hh2, lengths2, rev2), _) in enumerate(bwd_calls):
            dpre, dwhh = lc.lstm_bwd_dw(gates, cs, hs, dy, w_hh2, lengths2, rev2)
            p_dpre, p_dwhh = lc.lstm_bwd_dw_plain(gates, cs, hs, dy, w_hh2, lengths2, rev2)
            errs[f"layer {len(bwd_calls) - 1 - i} dpre"] = rel_err(dpre, p_dpre)
            errs[f"layer {len(bwd_calls) - 1 - i} dW_hh"] = rel_err(dwhh, p_dwhh)
            del p_dpre, p_dwhh
        # timed at the last layer (D = 2H): its forward, and its adjoint (the first)
        (x_proj, w_hh, lengths, rev), _ = fwd_calls[-1]
        got = lc.lstm_scan_train(x_proj, w_hh, lengths, rev)
        (gates, cs, hs, dy, _, _, _), _ = bwd_calls[0]
        dpre, dwhh = lc.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev)
        fwd_ms = cuda_median_ms(torch, lambda: lc.lstm_scan_train(x_proj, w_hh, lengths, rev), 10)
        bwd_ms = cuda_median_ms(
            torch, lambda: lc.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev), 10)
        plain_fwd_ms = cuda_median_ms(
            torch, lambda: lc.lstm_scan_train_plain(x_proj, w_hh, lengths, rev), 1)
        plain_bwd_ms = cuda_median_ms(
            torch, lambda: lc.lstm_bwd_dw_plain(gates, cs, hs, dy, w_hh, lengths, rev), 1)
    hidden = w_hh.shape[1]
    batch, seq = x_proj.shape[:2]
    frames = int(lengths.sum())
    flops = 2 * frames * 2 * 4 * hidden * hidden
    fwd_bound = bound_ms(flops, valid_bytes(frames, x_proj) + nbytes(w_hh, lengths, *got),
                         x_proj.dtype)
    bwd_bound = bound_ms(2 * flops, valid_bytes(frames, gates, cs, hs, dy)
                         + nbytes(w_hh, lengths, dpre, dwhh), gates.dtype)
    (_, x, x_lengths), _ = layer_calls[-1]
    lib_fwd = nn_lstm_ms(torch, x, x_lengths, x.dtype, "train", hidden)
    lib_bwd = nn_lstm_ms(torch, x, x_lengths, x.dtype, "backward", hidden)
    tol = TRAIN_TOL["bfloat16"]
    worst = max(errs, key=lambda n: errs[n][1])
    log(f"[{card}] lstm_scan_train + lstm_bwd_dw (Rewriter encoder, H={hidden}) bf16 on the "
        f"lmtrain step's inputs (its longest batch), {len(fwd_calls)} layers: {len(errs)} tensors, largest "
        f"{errs[worst][1]:.1e} of max ({worst}; tolerance {tol:g}); timed at layer "
        f"{len(fwd_calls) - 1} B={batch} T={seq} ({frames} frames): forward {fwd_ms:.3f} ms  "
        f"plain {plain_fwd_ms:.3f} ms  bound {fwd_bound[0]:.3f} ms ({fwd_bound[1]})  nn.LSTM "
        f"forward {fmt_ms(lib_fwd)} ms; adjoint {bwd_ms:.3f} ms  plain {plain_bwd_ms:.3f} ms  "
        f"bound {bwd_bound[0]:.3f} ms ({bwd_bound[1]})  nn.LSTM backward {fmt_ms(lib_bwd)} ms")
    bad = {n: r for n, (_, r) in errs.items() if not r <= tol}
    if not fwd_calls or len(fwd_calls) != len(bwd_calls) or bad:
        raise AssertionError(f"Rewriter LSTM training kernels: {len(fwd_calls)} / "
                             f"{len(bwd_calls)} calls, over tolerance {bad}")
    fwd_name, bwd_name = (f"lstm_scan_train (Rewriter H={hidden})",
                          f"lstm_bwd_dw (Rewriter H={hidden})")
    return {
        fwd_name: {"name": fwd_name, "route": "cuda", "source": TC_SOURCE,
                   "replaces": TRAIN_KERNELS["lstm_scan_train"][2], "launches": 0,
                   "max_abs_err": max(errs[n][0] for n in errs if "dpre" not in n
                                      and "dW" not in n),
                   "ms": fwd_ms, "plain_ms": plain_fwd_ms, "bound_ms": fwd_bound[0],
                   "bound_by": fwd_bound[1], "library_ms": lib_fwd},
        bwd_name: {"name": bwd_name, "route": "cuda", "source": BWD_TC_SOURCE,
                   "replaces": PALLAS + ":382", "launches": 0,
                   "max_abs_err": max(errs[n][0] for n in errs if "dpre" in n),
                   "ms": bwd_ms, "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound[0],
                   "bound_by": bwd_bound[1], "library_ms": lib_bwd},
    }


def lm_speller_train_records(torch, card: str, fwd_calls: list, bwd_calls: list) -> dict:
    """#8's training form and #9 held against their plain versions
    (``SPELLER_TRAIN_TOL``, of max) on the inputs the ``lmtrain`` CLI's step
    of its longest batch gave them (the forward fed its own ids, its masks
    and forcing as drawn); timed, with their bounds. Returns the records, their launches
    to be filled in."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import RewriterConfig
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    (operands, opts), = fwd_calls
    (bwd_args, kw), = bwd_calls
    spl = RewriterConfig(**REWRITER_MODEL).speller_config()
    vocab, proj = spl.dec_vocab_size, spl.att_proj_dim
    h1, h2 = spl.dec_lstm_hid_dim, spl.dec_lstm_out_dim
    with torch.no_grad():
        logits, wgts, ids, saved = sc.speller_decode_train(*operands, **opts)
        p_opts = {**opts, "forced": saved[0]}
        p_logits, p_wgts, _, p_saved = sc.speller_decode_train_plain(*operands, **p_opts)
        errs = {"logits": rel_err(logits[..., :vocab], p_logits[..., :vocab]),
                "weights": rel_err(wgts, p_wgts)}
        errs.update({n: rel_err(a, b) for n, a, b in
                     zip(sc.RESIDUALS[1:], saved[1:], p_saved[1:])})
        del p_logits, p_wgts, p_saved
        got = sc.speller_decode_bwd(*bwd_args, **kw)
        want = sc.speller_decode_bwd_plain(*bwd_args, **kw)
        errs.update({n: rel_err(a, b) for n, a, b in zip(BWD_NAMES, got, want)})
        del want
        fwd_ms = cuda_median_ms(torch, lambda: sc.speller_decode_train(*operands, **opts), 10)
        bwd_ms = cuda_median_ms(torch, lambda: sc.speller_decode_bwd(*bwd_args, **kw), 10)
        plain_fwd_ms = cuda_median_ms(
            torch, lambda: sc.speller_decode_train_plain(*operands, **p_opts), 1)
        plain_bwd_ms = cuda_median_ms(torch, lambda: sc.speller_decode_bwd_plain(*bwd_args,
                                                                                **kw), 1)
    steps, batch = saved[0].shape
    seq = operands[0].shape[1]
    frames = int((operands[2] > -1.0).sum())  # the additive pad bias is 0 at valid frames
    cells = (proj + h1) * 4 * h1 + (h1 + h2) * 4 * h2 + h2 * proj
    fwd_flops = steps * (2 * batch * (cells + 2 * proj * vocab) + 4 * proj * frames)
    bwd_flops = steps * (2 * batch * cells + 4 * proj * frames)
    masks = [t for t in (opts.get("forced"), opts.get("m1"), opts.get("m2")) if t is not None]
    fwd_bound = bound_ms(fwd_flops, nbytes(*operands, *masks, logits, wgts, ids, *saved),
                         operands[0].dtype)
    bwd_bound = bound_ms(bwd_flops, nbytes(*(t for t in bwd_args if t is not None), *got),
                         operands[0].dtype)
    tol = SPELLER_TRAIN_TOL["bfloat16"]
    worst = max(errs, key=lambda n: errs[n][1])
    n_forced = int((opts["forced"][:, 0] >= 0).sum()) if opts.get("forced") is not None else 0
    log(f"[{card}] speller_decode_train + speller_decode_bwd (Rewriter) bf16 on the lmtrain "
        f"step's inputs (its longest batch): B={batch} Te={seq} L={steps} H1={h1} H2={h2} P={proj}, dropout masks "
        f"{'on' if opts.get('m1') is not None else 'off'}, {n_forced} forced steps of {steps}: "
        f"{len(errs)} tensors, largest {errs[worst][1]:.1e} of max ({worst}; tolerance "
        f"{tol:g}); forward {fwd_ms:.3f} ms  plain {plain_fwd_ms:.3f} ms  bound "
        f"{fwd_bound[0]:.3f} ms ({fwd_bound[1]}); adjoint {bwd_ms:.3f} ms  plain "
        f"{plain_bwd_ms:.3f} ms  bound {bwd_bound[0]:.3f} ms ({bwd_bound[1]})")
    bad = {n: r for n, (_, r) in errs.items() if not r <= tol}
    if bad:
        raise AssertionError(f"Rewriter speller training kernels: over tolerance {bad}")
    fwd_name, bwd_name = "speller_decode_train (Rewriter)", "speller_decode_bwd (Rewriter)"
    return {
        fwd_name: {"name": fwd_name, "route": "cuda", "source": SPELLER_TC_SOURCE,
                   "replaces": SPELLER_REPLACES, "launches": 0,
                   "max_abs_err": max(errs[n][0] for n in ("logits", *sc.RESIDUALS[1:])),
                   "ms": fwd_ms, "plain_ms": plain_fwd_ms, "bound_ms": fwd_bound[0],
                   "bound_by": fwd_bound[1], "library_ms": None},
        bwd_name: {"name": bwd_name, "route": "cuda", "source": SPELLER_BWD_TC_SOURCE,
                   "replaces": SPELLER_BWD_REPLACES, "launches": 0,
                   "max_abs_err": max(errs[n][0] for n in BWD_NAMES),
                   "ms": bwd_ms, "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound[0],
                   "bound_by": bwd_bound[1], "library_ms": None},
    }


def rewriter_train_parity(torch, card: str) -> None:
    """One float32 Rewriter train step at ``configs/rewriter.yml``'s widths
    through both kernel tiers against one through the plain loops, from the
    same weights, batch and draws (dropout 0.2, tf_rate 0.9): the tolerances
    of ``train_parity_phase``."""
    import dataclasses

    from attention_based_e2e_asr_dnn_tpu_torch.lmtrain import make_rewriter_apply_factory
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import (
        RewriterConfig,
        draw_rewriter_noise,
        rewriter_init,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.training import optim, steps

    batch, seq, labels, lr = 32, 224, 224, 1e-3
    gen = torch.Generator().manual_seed(SEED + 9)
    lx = torch.randint(MIN_CHARS, seq + 1, (batch,), generator=gen)
    lx[0] = seq
    x = torch.randint(1, 28, (batch, seq), generator=gen)
    x[:, 0] = 0
    x[torch.arange(seq)[None, :] >= lx[:, None]] = 29
    ly = torch.clamp(lx - 1, max=labels)
    y = torch.randint(1, 28, (batch, labels), generator=gen)
    y[torch.arange(labels)[None, :] >= ly[:, None]] = 29
    x, lx, y, ly = (t.to(torch.int32).to(DEVICE) for t in (x, lx, y, ly))
    cfg = RewriterConfig(**REWRITER_MODEL)
    draws = draw_rewriter_noise(cfg, batch, labels,
                                torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    results = {}
    for name, impl in (("lstm_impl pallas + decoder_impl pallas", "pallas"), ("plain", "scan")):
        c = dataclasses.replace(cfg, lstm_impl=impl, decoder_impl=impl)
        opt = optim.build_optimizer("adamw", {"lr": lr, "weight_decay": 5e-6, "amsgrad": True},
                                    grad_norm=10.0)
        step = steps.make_train_step(make_rewriter_apply_factory(c, torch.float32)(1.0), opt)
        params = rewriter_init(cfg, torch.Generator().manual_seed(SEED))  # the same weights
        state = steps.create_train_state(params, opt, seed=SEED, device=DEVICE)
        state, m, _ = step(state, x, lx, y, ly, 0.9, lr, draws=draws)
        torch.cuda.synchronize()
        results[name] = ({k: v.item() for k, v in m.items()},
                         [p.detach().clone() for p in state.params.parameters()])
    (mk, pk), (mp, pp) = results.values()
    worst = max((a - b).abs().max().item() for a, b in zip(pk, pp))
    off = sum(((a - b).abs() > 1e-5).sum().item() for a, b in zip(pk, pp))
    total = sum(a.numel() for a in pk)
    log(f"[{card}] train parity Rewriter float32 B={batch} T={seq} L={labels}, kernels vs "
        f"plain loops, one step, shared draws: loss {mk['loss']:.6f} / {mp['loss']:.6f}, "
        f"grad_norm {mk['grad_norm']:.6f} / {mp['grad_norm']:.6f}; parameters max_abs_diff "
        f"{worst:.3e} (bound 2 x lr = {2 * lr:g}), {off} of {total} elements off by more "
        f"than 1e-5 (allowed {total // 1000})")
    for key in ("loss", "grad_norm"):
        if not abs(mk[key] - mp[key]) <= 1e-4 * abs(mp[key]):
            raise AssertionError(f"Rewriter train parity: {key} {mk[key]} vs {mp[key]}")
    if not (mk["finite"] and mp["finite"] and worst <= 2 * lr * 1.01 and off <= total // 1000):
        raise AssertionError(f"Rewriter train parity: {mk} {mp}, parameters {worst}, {off}")


def lmtrain_phase(torch, card: str, work: str) -> tuple:
    """The ``lmtrain`` CLI in-process on the card (phase 17): the generated
    corpus, ``configs/rewriter.yml`` with both kernel tiers and its data
    paths and epochs replaced, ``LM_EPOCHS`` epochs (the train loss must
    fall); a resumed epoch; ``lminfer`` with ``early_stop: false`` from the
    folder it wrote; #4, #5, #8's training form and #9 held against their
    plain versions on the inputs the CLI's step of its longest batch (Te and
    L 608) gave them, #8's eval
    form on the dev pass's; one float32 Rewriter step through the kernels
    against one through the plain loops. Returns (the experiment folder,
    the corpus, the records, the launches of the first run)."""
    import numpy as np
    import yaml

    from attention_based_e2e_asr_dnn_tpu_torch import lminfer, lmtrain
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
    from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import load_checkpoint

    corpus = make_lm_train_data(os.path.join(work, "lm-corpus"), np.random.default_rng(SEED + 11))
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", "rewriter.yml")) as fh:
        cfg = yaml.safe_load(fh)
    model = cfg["model"]["configs"]
    if {**model, **KERNEL_TIERS} != REWRITER_MODEL:
        raise AssertionError("configs/rewriter.yml's model block is not the one the "
                             "Rewriter phases run")
    model.update(KERNEL_TIERS)
    cfg.update(epochs=LM_EPOCHS, TRN_FOLDER=corpus["train"][0], DEV_FOLDER=corpus["dev"][0],
               TRN_PRED_DIR=corpus["train"][1], DEV_PRED_DIR=corpus["dev"][1],
               EXP_FOLDER=os.path.join(work, "experiments-lm"))

    def run(name, cfg):
        path = os.path.join(work, name)
        with open(path, "w") as fh:
            yaml.safe_dump(cfg, fh)
        return lmtrain.main(lmtrain.build_argparser().parse_args(["-c", path, "--device",
                                                                  DEVICE]))

    lc.reset_launch_counts()
    sc.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        stack.enter_context(forbid_plain())
        # the kernels' inputs in the step of the longest batch (T = 608)
        layers = stack.enter_context(capture(lc, "bilstm_apply_kernel", 2, arg=1))
        fwd = stack.enter_context(capture(lc, "lstm_scan_train", 2))
        bwd = stack.enter_context(capture(lc, "lstm_bwd_dw", 2))
        dfwd = stack.enter_context(capture(sc, "speller_decode_train", 1))
        dbwd = stack.enter_context(capture(sc, "speller_decode_bwd", 1))
        devs = stack.enter_context(capture(sc, "speller_decode", 1))
        trainer = run("lmtrain.yml", cfg)
    counts = {**lc.LAUNCHES, **sc.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    folder = trainer.saving_dir
    trn, dev = trainer.train_history, trainer.dev_history
    finite = all(v == v and abs(v) != float("inf") for v in trn["loss"] + dev["loss"])
    if not (len(trn["loss"]) == LM_EPOCHS and finite and trn["loss"][-1] < trn["loss"][0]):
        raise AssertionError(f"lmtrain CLI: histories {trn} {dev}")
    with open(os.path.join(folder, "config.json")) as fh:
        snap = json.load(fh)
    if snap["model"]["configs"]["CHR_PAD_IDX"] != 29 or snap["compute_dtype"] != "bfloat16":
        raise AssertionError(f"lmtrain CLI: config snapshot {snap['model']}")
    idle = [k for k in ("lstm_scan", "lstm_scan_train", "lstm_bwd_dw", "speller_decode",
                        "speller_decode_train", "speller_decode_bwd") if counts[k] <= 0]
    if idle or counts["lstm_bwd"] or counts["lstm_scan_fusedin_train"]:
        raise AssertionError(f"lmtrain CLI: launches {counts}")
    n_steps = len(trainer.trn_batcher)
    log(f"[{card}] lmtrain CLI Rewriter bf16 ({N_LM_TRAIN} train / {N_LM_DEV} dev pairs of "
        f"{MIN_CHARS}-{MAX_CHARS} chars, batch_size {cfg['batch_size']}, accu_grad "
        f"{cfg['accu_grad']}: {n_steps} steps an epoch): train loss "
        f"{[round(v, 4) for v in trn['loss']]}, dev loss {[round(v, 4) for v in dev['loss']]}, "
        f"dev LD {[round(v, 3) for v in dev['ld']]}; epoch seconds "
        f"{[round(t, 2) for t in trainer.epoch_seconds]} (train "
        f"{[round(t, 2) for t in trainer.train_seconds]}, dev "
        f"{[round(t, 2) for t in trainer.eval_seconds]}); s/step (an epoch's train seconds "
        f"over its steps, the last epoch) {trainer.train_seconds[-1] / n_steps:.4f}; peak "
        f"device memory {peak / 2**20:.1f} MiB; launches {counts}")
    records = lm_lstm_train_records(torch, card, layers, fwd, bwd)
    records.update(lm_speller_train_records(torch, card, dfwd, dbwd))
    (operands, opts), = devs
    records["speller_decode (Rewriter, bfloat16)"] = rewriter_decode_check(
        torch, card, "the lmtrain dev pass", operands, opts,
        int((operands[2] > -1.0).sum()), relative=True)
    del layers, fwd, bwd, dfwd, dbwd, devs, operands
    torch.cuda.empty_cache()

    # resume: one more epoch from the last checkpoint
    kept = sorted(os.listdir(os.path.join(folder, "ckpts")),
                  key=lambda f: int(f.split("epoch[")[1].split("]")[0]))
    last = os.path.join(folder, "ckpts", kept[-1])
    saved = load_checkpoint(last)
    cfg["finetune"] = {"use": True, "reinit_lr": False, "checkpoint": last}
    cfg["epochs"] = saved["epoch"] + 1
    cfg["EXP_FOLDER"] = os.path.join(work, "experiments-lm-resumed")
    resumed = run("lmtrain-resume.yml", cfg)
    if not (resumed.epoch == saved["epoch"] + 1
            and resumed.train_history["loss"][:-1] == saved["train_loss"]
            and int(resumed.state.opt_state.count) > 0):
        raise AssertionError(f"lmtrain resume: {resumed.train_history}")
    log(f"[{card}] lmtrain CLI resumed from {kept[-1]} at epoch {saved['epoch']}: one epoch "
        f"in {resumed.epoch_seconds[-1]:.2f} s, train loss "
        f"{resumed.train_history['loss'][-1]:.4f}")
    del resumed

    # lminfer from the folder the CLI wrote, the dev predictions
    cfg_path = os.path.join(work, "lm-infer-trained.yml")
    with open(cfg_path, "w") as fh:
        fh.write(f"TST_DIR: {corpus['dev'][1]}\nTST_FOLDER: {corpus['tst']}\n"
                 f"exp_folder: {folder}\nbatch_size: {N_LM_DEV}\nrun_all: true\n"
                 f"epoch_num: null\nrun_avg: false\nearly_stop: false\n"
                 f"gate_correction: false\n")
    lc.reset_launch_counts()
    sc.reset_launch_counts()
    t0 = time.perf_counter()
    lminfer.main(lminfer.build_argparser().parse_args(["-c", cfg_path, "--device", DEVICE]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    infer_counts = {**lc.LAUNCHES, **sc.LAUNCHES}
    outs = [f for f in os.listdir(os.path.join(folder, "ckpts")) if f.endswith("-pred.csv")]
    lines = check_preds(os.path.join(folder, "ckpts", outs[0]), N_LM_DEV,
                        "lminfer from the lmtrain folder") if outs else []
    if not lines or infer_counts["lstm_scan"] <= 0 or infer_counts["speller_decode"] <= 0:
        raise AssertionError(f"lmtrain -> lminfer: {outs}, launches {infer_counts}")
    log(f"[{card}] lmtrain -> lminfer early_stop: false, float32: {N_LM_DEV} lines x "
        f"{len(outs)} checkpoints in {wall:.3f} s; mean output "
        f"{sum(map(len, lines)) / len(lines):.1f} chars; launches {infer_counts}")
    rewriter_train_parity(torch, card)
    del trainer
    torch.cuda.empty_cache()
    return folder, corpus, records, counts


# ---------------------------------------------------------------------------
# 18. Export, and serve from the artifacts
# ---------------------------------------------------------------------------

def export_phase(torch, card: str, las_exp: str, lm_exp: str, feats: list, work: str) -> dict:
    """Phase 4's base-LAS experiment exported (greedy, beam 8; one bucket of
    ``B`` rows covering the serve utterances) and phase 17's Rewriter as a
    gated corrector (beam 8, ``B`` rows, Te 608): ``ArtifactTranscriber``'s
    ids equal to the ``Transcriber``'s on the same padded batches, and
    ``ExportedCorrector.correct`` equal to the ``Corrector``'s chain on the
    same batches (the same kernels on the same weights); their agreement with
    ``Transcriber.transcribe`` / ``Corrector.correct`` over their own
    batches, and an int8 artifact's, printed; a ``serve_http --artifact
    --corrector-artifact`` burst over loopback; utt/s and s to ready beside
    the ``Transcriber``'s in the same run. Returns the kernels' launches in
    the artifacts' transcribe and correct runs (the burst's are logged)."""
    import numpy as np

    from attention_based_e2e_asr_dnn_tpu_torch import export
    from attention_based_e2e_asr_dnn_tpu_torch.data.batching import pad_to_multiple
    from attention_based_e2e_asr_dnn_tpu_torch.decoding.rescore import gate_corrections
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.serving import Corrector, Transcriber
    from attention_based_e2e_asr_dnn_tpu_torch.utils.levenshtein import ids_to_str

    t_pad = pad_to_multiple(max(len(f) for f in feats), 128)
    paths = {name: export.export_from_experiment(
        las_exp, os.path.join(work, f"las-{name}.tlas"), batch=B, t_pad=t_pad, beam_size=beam)
        for name, beam in (("greedy", 0), (f"beam {BEAM}", BEAM))}
    paths["int8"] = export.export_from_experiment(
        las_exp, os.path.join(work, "las-int8.tlas"), batch=B, t_pad=t_pad, quantize="int8")
    corr_path = export.export_corrector_from_experiment(
        lm_exp, os.path.join(work, "corrector.tlas"), batch=B, t_pad=LM_TE, beam_size=BEAM)
    sizes = {n: os.path.getsize(p) for n, p in paths.items()}
    launches = {"lstm_scan_fusedin": 0, "lstm_scan": 0}

    def chunks(items):
        return [items[i:i + B] for i in range(0, len(items), B)]

    def padded(chunk):
        x = np.zeros((B, t_pad, 15), np.float32)
        lx = np.ones((B,), np.int32)
        for r, f in enumerate(chunk):
            x[r, : len(f)] = f
            lx[r] = len(f)
        return x, lx

    served = {}
    for name in ("greedy", f"beam {BEAM}"):
        beam = BEAM if name != "greedy" else 0
        t = Transcriber(las_exp, batch_size=B, pad_time_multiple=128, beam_size=beam,
                        device=DEVICE)
        t0 = time.perf_counter()
        art = export.ArtifactTranscriber([paths[name]], device=DEVICE)
        art.warmup()
        ready = time.perf_counter() - t0
        t.transcribe(feats[:B])  # warm
        # the same padded batches through both
        same = 0
        for chunk in chunks(feats):
            x, lx = padded(chunk)
            got = art.buckets[0].decode_ids(x, lx)
            want = t._decode(x, lx)
            if not np.array_equal(got, want):
                raise AssertionError(f"artifact {name}: ids differ from the Transcriber's on "
                                     f"the same batch")
            same += len(chunk)
        times = {"transcriber": [], "artifact": []}
        for who in ("transcriber", "artifact", "artifact", "transcriber"):
            torch.cuda.synchronize()
            lc.reset_launch_counts()
            t0 = time.perf_counter()
            texts = (art if who == "artifact" else t).transcribe(feats)
            torch.cuda.synchronize()
            times[who].append(time.perf_counter() - t0)
            if who == "artifact":
                for k in launches:
                    launches[k] += lc.LAUNCHES[k]
                served[name] = texts
            else:
                direct = texts
        mine = [ids_to_str(r, art.vocab, 0, 29) for c in chunks(feats)
                for r in art.buckets[0].decode_ids(*padded(c))[: len(c)]]
        if mine != served[name]:
            raise AssertionError(f"artifact {name}: transcribe() is not its batches' ids")
        agree = sum(a == b for a, b in zip(served[name], direct))
        rates = {k: len(feats) / statistics.median(v) for k, v in times.items()}
        log(f"[{card}] artifact {name} (B={B}, t_pad {t_pad}, {sizes[name]} bytes): ids equal "
            f"to the Transcriber's on the same {same} padded rows; ready (load, kernels bound, "
            f"one batch) in {ready:.3f} s; {len(feats)} utts: artifact "
            f"{rates['artifact']:.2f} utt/s, Transcriber {rates['transcriber']:.2f} utt/s in "
            f"the same run (median of two turns each); its own batches agree in "
            f"{agree}/{len(feats)} transcripts")
        del t, art
    # int8: the agreement with the float32 artifact, printed
    q = export.ExportedDecoder(paths["int8"], device=DEVICE)
    ref = export.ExportedDecoder(paths["greedy"], device=DEVICE)
    total = equal = 0
    for chunk in chunks(feats):
        x, lx = padded(chunk)
        a, b = q.decode_ids(x, lx)[: len(chunk)], ref.decode_ids(x, lx)[: len(chunk)]
        total, equal = total + a.size, equal + int((a == b).sum())
    log(f"[{card}] artifact int8 ({sizes['int8']} bytes, float32 {sizes['greedy']}): "
        f"{equal}/{total} ids equal to the float32 artifact's (not asserted)")
    del q, ref

    # the corrector: the artifact against the Corrector's chain on the same batches
    corr = export.ExportedCorrector(corr_path, device=DEVICE)
    corrector = Corrector(lm_exp, beam_size=BEAM, batch_size=B, device=DEVICE)
    texts = served["greedy"]
    lc.reset_launch_counts()
    t0 = time.perf_counter()
    corrected = corr.correct(texts)
    torch.cuda.synchronize()
    corr_wall = time.perf_counter() - t0
    launches["lstm_scan (Rewriter H=256)"] = lc.LAUNCHES["lstm_scan"]
    vm = {c: i for i, c in enumerate(corr.meta["vocab"])}
    want = []
    for chunk in chunks(texts):
        x = np.full((B, LM_TE), 29, np.int32)
        lx = np.ones((B,), np.int32)
        for r, s in enumerate(chunk):
            row = [0] + [vm[c] for c in s if c in vm] + [29]
            x[r, : len(row)] = row
            lx[r] = len(row)
        dec = np.asarray(corrector.chain.step(corrector.params, x, lx))
        use = gate_corrections(corrector.chain.scorer, corrector.params, x, lx, dec, 29, 0)[0]
        want += [ids_to_str(dec[r], corr.meta["vocab"], 0, 29) if use[r] else s
                 for r, s in enumerate(chunk)]
    if corrected != want:
        raise AssertionError("ExportedCorrector differs from the Corrector's chain on the "
                             "same batches")
    agree = sum(a == b for a, b in zip(corrected, corrector.correct(texts)))
    log(f"[{card}] corrector artifact (beam {BEAM}, gate, B={B}, t_pad {LM_TE}): "
        f"{len(texts)} transcripts in {corr_wall:.3f} s, equal to the Corrector's chain on "
        f"the same batches; Corrector.correct over its own batches agrees in "
        f"{agree}/{len(texts)}")
    del corrector

    # serve_http --artifact --corrector-artifact over loopback
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from attention_based_e2e_asr_dnn_tpu_torch.tools import serve_http

    args = serve_http.build_argparser().parse_args(
        ["--artifact", paths["greedy"], "--corrector-artifact", corr_path, "--host",
         "127.0.0.1", "--port", "0", "--warmup", "--device", DEVICE])
    t0 = time.perf_counter()
    art, server = serve_http.start(args)
    try:
        if not art.wait_ready(timeout=600):
            raise AssertionError("serve_http --artifact: not ready")
        ready = time.perf_counter() - t0
        url = f"http://127.0.0.1:{server.port}/v1/transcribe"

        def post(f):
            req = urllib.request.Request(
                url, data=json.dumps({"features": f.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.status, json.loads(resp.read())

        lc.reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(6) as pool:
            replies = list(pool.map(post, feats[:6]))
        wall = time.perf_counter() - t0
        counts = dict(lc.LAUNCHES)
    finally:
        server.close()
    vocab = set("ABCDEFGHIJKLMNOPQRSTUVWXYZ' ")
    if not all(code == 200 and set(body["transcript"]) <= vocab for code, body in replies):
        raise AssertionError(f"serve_http --artifact: replies {replies}")
    if counts["lstm_scan_fusedin"] <= 0 or counts["lstm_scan"] <= 0:
        raise AssertionError(f"serve_http --artifact: launches {counts}")
    log(f"[{card}] serve_http --artifact --corrector-artifact: ready in {ready:.3f} s "
        f"(the server bound, the bucket and the corrector run once); a burst of 6 POSTs "
        f"{wall:.3f} s; launches {counts}")
    return launches


# ---------------------------------------------------------------------------
# Phases 19-22: the measurement and tools surface
# ---------------------------------------------------------------------------

BENCH_ARCHS = ("base", "scaled")
# the hand-written kernels as the profiler names them (bf16 forms)
TRACE_KERNELS = ("lstm_scan_tc_kernel", "lstm_bwd_tc_kernel", "speller_decode_tc_kernel",
                 "speller_bwd_tc_kernel")
PROFILE_BATCHES = 3
# the profiled train run: configs/base-las.yml at its batch on long-form
# utterances (the bench's realistic lengths), four steps an epoch
PROFILE_SPLITS, PROFILE_WORDS = (384, 96, 8), (25, 45)
WINDOW = "chip_smoke window"
RECIPE_SPLITS, RECIPE_EPOCHS, RECIPE_MAX_STEPS = (64, 16, 16), 10, 64


def trace_stats(path: str, window: str) -> dict:
    """From a Chrome trace: the window annotation's span, the union of the
    kernel intervals inside it (the device's busy time), its share, the 5
    longest gaps between kernels (start from the window's start, length;
    ms), the kernels by name and the memcpy and host-prefetch events."""
    with open(path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    # the host's annotation; the profiler mirrors it on the device's timeline
    # as a "gpu_user_annotation"
    spans = [e for e in events if e.get("name") == window and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise AssertionError(f"{path}: {len(spans)} '{window}' annotations")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    kernels = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    intervals = sorted((max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                       for e in kernels)
    busy, gaps, edge = 0.0, [], w0
    for start, end in intervals:
        if end <= edge:
            continue
        if start > edge:
            gaps.append((start - edge, edge))
        busy += end - max(start, edge)
        edge = end
    if w1 > edge:
        gaps.append((w1 - edge, edge))
    gaps.sort(reverse=True)
    return {"window_ms": (w1 - w0) / 1e3, "busy_ms": busy / 1e3, "busy_share": busy / (w1 - w0),
            "gaps_ms": [(round((at - w0) / 1e3, 3), round(length / 1e3, 3))
                        for length, at in gaps[:5]],
            "in_gaps": [host_in_gap(events, at, at + length) for length, at in gaps[:3]],
            "kernels": len(kernels),
            "by_name": {k: sum(1 for e in kernels if k in e["name"]) for k in TRACE_KERNELS},
            "memcpy": sum(1 for e in events if str(e.get("cat", "")).lower() == "gpu_memcpy"),
            "host_prefetch": sum(1 for e in events if e.get("cat") == "host_prefetch")}


def host_in_gap(events: list, g0: float, g1: float, top: int = 4) -> list:
    """The host's work during a device gap [g0, g1] (trace microseconds):
    the operators, runtime calls and prefetcher spans that overlap it, by
    name, each with its longest overlap in ms (nested operators each show)."""
    longest: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("cpu_op", "cuda_runtime",
                                                      "host_prefetch"):
            continue
        start = float(e["ts"])
        overlap = min(start + float(e.get("dur", 0)), g1) - max(start, g0)
        if overlap > 0:
            longest[e["name"]] = max(longest.get(e["name"], 0.0), overlap)
    ranked = sorted(longest.items(), key=lambda kv: -kv[1])[:top]
    return [(name[:60], round(us / 1e3, 1)) for name, us in ranked]


def profiled(torch, fn, path: str):
    """``fn()`` under ``torch.profiler`` (CPU and the card) inside one
    window annotation, the trace written to ``path``: (its result, its
    ``trace_stats``). The phase's own profiler, not a feature of the port."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            result = fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    stats = trace_stats(path, WINDOW)
    if stats["kernels"] == 0:
        raise AssertionError(f"{path}: the profiler traced no kernel on the card")
    return result, stats


def fmt_trace(stats: dict) -> str:
    return (f"window {stats['window_ms']:.1f} ms, device busy {stats['busy_ms']:.1f} ms "
            f"({100 * stats['busy_share']:.1f}%, idle {100 * (1 - stats['busy_share']):.1f}%), "
            f"{stats['kernels']} kernels, 5 longest idle gaps (at ms, ms) {stats['gaps_ms']}; "
            f"the host in the 3 longest (operator, ms) {stats['in_gaps']}")


def bench_launches(torch, arch: str) -> dict:
    """The kernels' launches in one bench step, from the plans."""
    from attention_based_e2e_asr_dnn_tpu_torch.tools import bench

    hidden = bench.MODELS[arch]["listener_configs"]["uniform_hid_dim"]
    remat = bench.MODELS[arch]["listener_configs"].get("remat", False)
    wide = hidden > H
    fwd = forward_launches(torch, torch.bfloat16, TRAIN_B, hidden)
    chunks = adjoint_launches(torch, torch.bfloat16, TRAIN_B, hidden, not wide)
    want = {"lstm_scan_fusedin": fwd if remat else 0, "lstm_scan": 3 * fwd if remat else 0,
            "lstm_scan_fusedin_train": fwd, "lstm_scan_train": 3 * fwd,
            "lstm_bwd" if wide else "lstm_bwd_dw": 4 * chunks,
            "speller_decode_train": 1, "speller_decode_bwd": 1}
    return {k: v for k, v in want.items() if v}


def bench_phase(torch, card: str, steps: dict) -> None:
    """Phase 19: ``tools/bench.py`` in-process for both models, its JSON line
    printed; every figure finite, the launches a dense step the plans'; the
    dense s/step beside phases 8 and 10's step of this run."""
    import math

    from attention_based_e2e_asr_dnn_tpu_torch.tools import bench

    for arch, model in zip(BENCH_ARCHS, ("base-LAS", "scaled-LAS")):
        rec = bench.run(arch, TRAIN_B, DEVICE)
        print(json.dumps(rec), flush=True)
        figures = {k: rec[k] for k in ("value", "s_per_step", "value_realistic",
                                       "pad_waste_frac", "mfu", "flops_per_step", "peak_mib",
                                       "power_limit_w")}
        if not all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0
                   for v in figures.values()):
            raise AssertionError(f"bench {arch}: figures {figures}")
        want = bench_launches(torch, arch)
        if rec["launches_per_step"] != want:
            raise AssertionError(f"bench {arch}: launches a step {rec['launches_per_step']} "
                                 f"!= the plans' {want}")
        phase8 = steps[model]
        log(f"[{card}] bench {arch}: dense {rec['s_per_step']:.4f} s/step "
            f"({rec['value']:.2f} utt/s, MFU {rec['mfu']:.4f}, peak {rec['peak_mib']:.1f} MiB) "
            f"beside phase {8 if arch == 'base' else 10}'s median {phase8['s_per_step']:.4f} "
            f"s/step (its split sums to {sum(phase8['split_ms']):.1f} ms); realistic "
            f"{rec['value_realistic']:.2f} utt/s over {rec['realistic_shapes']} "
            f"(pad waste {rec['pad_waste_frac']:.4f}); launches a step {want}")


def trainer_profile_phase(torch, card: str, work: str) -> None:
    """Phase 20, the Trainer's ``profile`` block: the ``train`` CLI for two
    epochs of ``configs/base-las.yml`` at its batch on a generated long-form
    corpus with ``profile: {use: true, epoch: 1, batches: 3}``; the trace
    holds the kernels by name, 3 steps' launches of the decode's adjoint,
    the pinned copies and the prefetcher's thread; the device's busy share
    of the window and its longest idle gaps."""
    import numpy as np
    import yaml

    from attention_based_e2e_asr_dnn_tpu_torch import train
    from attention_based_e2e_asr_dnn_tpu_torch.tools.make_synthetic_data import generate
    from attention_based_e2e_asr_dnn_tpu_torch.utils.profiling import WINDOW as TRAIN_WINDOW

    corpus = os.path.join(work, "longform-corpus")
    n_train, n_dev, n_test = PROFILE_SPLITS
    generate(corpus, n_train=n_train, n_dev=n_dev, n_test=n_test, words_min=PROFILE_WORDS[0],
             words_max=PROFILE_WORDS[1], seed=SEED + 20)
    mfcc = os.path.join(corpus, "train-clean-100", "mfcc")
    frames = [np.load(os.path.join(mfcc, f), mmap_mode="r").shape[0] for f in os.listdir(mfcc)]
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", "base-las.yml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg["parallel"]["use"] = False
    batch = cfg["batch_size"]
    cfg.update(epochs=2, profile={"use": True, "epoch": 1, "batches": PROFILE_BATCHES},
               TRN_FOLDER=os.path.join(corpus, "train-clean-100"),
               DEV_FOLDER=os.path.join(corpus, "dev-clean"),
               TST_FOLDER=os.path.join(corpus, "test-clean"),
               EXP_FOLDER=os.path.join(work, "experiments-profile"),
               MST_FOLDER=os.path.join(work, "milestones-profile"))
    path = os.path.join(work, "profile.yml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        trainer = train.main(train.build_argparser().parse_args(["-c", path, "--device",
                                                                 DEVICE]))
    trace = os.path.join(trainer.saving_dir, "profile", "trace-epoch1.json")
    if f"[profile] trace written to {trainer.saving_dir}/profile" not in tee.getvalue():
        raise AssertionError("profile: the block did not report its trace")
    stats = trace_stats(trace, TRAIN_WINDOW)
    plan = -(-batch // 128)  # one launch a span of up to 128 rows (plan_decode_bwd_tc)
    missing = [k for k, n in stats["by_name"].items() if n == 0]
    if missing or stats["by_name"]["speller_bwd_tc_kernel"] != PROFILE_BATCHES * plan:
        raise AssertionError(f"profile: kernels by name {stats['by_name']} (3 steps of "
                             f"{plan} decode adjoint launches wanted)")
    if stats["memcpy"] == 0 or stats["host_prefetch"] == 0:
        raise AssertionError(f"profile: {stats['memcpy']} copies, {stats['host_prefetch']} "
                             f"prefetcher spans in the trace")
    log(f"[{card}] profile block, train CLI base-LAS bf16 batch {batch}, {PROFILE_BATCHES} "
        f"steps of epoch 1 on {n_train} long-form utterances (frames {min(frames)}-"
        f"{max(frames)}, mean {np.mean(frames):.1f}; pad_time_multiple "
        f"{cfg['pad_time_multiple']}): {fmt_trace(stats)}; "
        f"{stats['kernels'] / PROFILE_BATCHES:.0f} kernels a step; by name "
        f"{stats['by_name']}; {stats['memcpy']} memcpy, {stats['host_prefetch']} prefetcher "
        f"spans; trace {os.path.getsize(trace) / 2**20:.1f} MiB; epochs "
        f"{[round(s, 2) for s in trainer.epoch_seconds]} s")


def serve_infer_profile_phase(torch, card: str, t, feats: list, exp: str, data: str,
                              work: str) -> None:
    """Phase 20, with the phase's own profiler: one ``infer.main`` call
    (``configs/infer.yml``'s keys on phase 14's test set) and one
    ``Transcriber.transcribe`` of phase 4's utterances."""
    from attention_based_e2e_asr_dnn_tpu_torch import infer

    path = os.path.join(work, "infer-profile.yml")
    with open(path, "w") as fh:
        fh.write(f"SOME_FOLDER: {data}\nexp_folder: {exp}\nbatch_size: {INFER_BATCH}\n"
                 f"pad_time_multiple: 256\nrun_all: true\nepoch_num: null\nrun_avg: false\n")
    args = infer.build_argparser().parse_args(["-c", path, "--device", DEVICE])
    _, infer_stats = profiled(torch, lambda: infer.main(args),
                              os.path.join(work, "infer-trace.json"))
    log(f"[{card}] profile infer CLI (early-stop greedy, {N_TEST_UTTS} utts x 2 checkpoints, "
        f"batch {INFER_BATCH}): {fmt_trace(infer_stats)}; the host's share outside the "
        f"device's work {100 * (1 - infer_stats['busy_share']):.1f}%")
    texts, serve_stats = profiled(torch, lambda: t.transcribe(feats),
                                  os.path.join(work, "serve-trace.json"))
    if len(texts) != len(feats):
        raise AssertionError("profile serve: transcripts missing")
    log(f"[{card}] profile Transcriber.transcribe ({len(feats)} utts, batch {B}): "
        f"{fmt_trace(serve_stats)}")


def profile_step_phase(torch, card: str) -> None:
    """Phase 20: ``tools/profile_step``'s rows for both models, the table
    printed; every row finite."""
    import math

    from attention_based_e2e_asr_dnn_tpu_torch.tools import profile_step

    for arch in BENCH_ARCHS:
        rows = profile_step.profile_rows(profile_step.model_for(arch), TRAIN_B, TRAIN_T,
                                         TRAIN_L, DEVICE)
        if not all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows):
            raise AssertionError(f"profile_step {arch}: rows {rows}")
        log(profile_step.format_table(rows, f"[{card}] profile_step {arch} B={TRAIN_B} "
                                            f"T={TRAIN_T} L={TRAIN_L} bf16"))


def dev_phase(card: str, corpus: str, work: str) -> None:
    """Phase 21: ``dev.extract_mini`` on phase 11's generated corpus."""
    from attention_based_e2e_asr_dnn_tpu_torch import dev

    small = os.path.join(work, "small")
    dev.extract_mini(corpus, small, ratio=0.05, seed=SEED)
    got = {split: len(os.listdir(os.path.join(small, split, "mfcc")))
           for split in ("train-clean-100", "dev-clean")}
    if got != {"train-clean-100": max(int(0.05 * N_CLI_TRAIN), 1),
               "dev-clean": max(int(0.05 * N_CLI_DEV), 1)}:
        raise AssertionError(f"dev.extract_mini: {got}")
    log(f"[{card}] dev.extract_mini: {got} utterances copied")


def tools_phase(torch, card: str, exp: str, lm_exp: str, work: str) -> None:
    """Phase 21: ``import_reference_ckpt`` from phase 4's checkpoint out to
    a reference ``.pt``, in, and out again (bit-equal); ``export_serving
    --check`` for the LAS (greedy, beam 8, int8) and the Rewriter;
    ``serving_bench`` on phase 4's experiment."""
    import math
    import warnings

    from attention_based_e2e_asr_dnn_tpu_torch.tools import (
        export_serving,
        import_reference_ckpt,
        serving_bench,
    )

    ckpt = os.path.join(exp, "ckpts", "min-loss-ld-ppl-epoch[2].ckpt")
    pts = [os.path.join(work, f"ref{i}.pt") for i in range(2)]
    imported = os.path.join(work, "imported.ckpt")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the learned initial states have no slot there
        for argv in (["las", ckpt, "-o", pts[0], "--export"], ["las", pts[0], "-o", imported],
                     ["las", imported, "-o", pts[1], "--export"]):
            if import_reference_ckpt.main(argv) != 0:
                raise AssertionError(f"import_reference_ckpt {argv}")
    sds = [torch.load(p, weights_only=True)["model_state_dict"] for p in pts]
    if sds[0].keys() != sds[1].keys() or not all(torch.equal(sds[0][k], sds[1][k])
                                                 for k in sds[0]):
        raise AssertionError("import_reference_ckpt: the round trip changed a tensor")
    log(f"[{card}] import_reference_ckpt: {len(sds[0])} tensors out, in and out again, "
        f"bit-equal")

    for name, extra in (("greedy", []), ("beam8", ["--beam-size", "8"]),
                        ("int8", ["--quantize", "int8"]),
                        ("rewriter", ["--model", "rewriter", "--beam-size", "8"])):
        folder = lm_exp if name == "rewriter" else exp
        t_pad = "256" if name == "rewriter" else "1536"
        tee = Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = export_serving.main([folder, "-o", os.path.join(work, f"{name}.tlas"),
                                      "--batch", str(B), "--t-pad", t_pad, "--check",
                                      "--device", DEVICE, *extra])
        if rc != 0 or "check: artifact" not in tee.getvalue():
            raise AssertionError(f"export_serving --check {name}: rc {rc}")
        log(f"[{card}] export_serving --check {name}: "
            f"{time.perf_counter() - t0:.2f} s")

    rec = serving_bench.run(exp, batch_size=B, device=DEVICE)  # the tool's default stream
    print(json.dumps(rec), flush=True)
    if rec["cold_warm_accuracy_match"] != 1.0 or not all(
            math.isfinite(rec[k]) and rec[k] > 0 for k in ("ready_s", "cold_utt_s",
                                                          "warm_utt_s", "p50_ms", "p99_ms")):
        raise AssertionError(f"serving_bench: {rec}")
    log(f"[{card}] serving_bench n={rec['n']}: ready {rec['ready_s']:.2f} s, cold "
        f"{rec['cold_utt_s']:.2f} utt/s, warm {rec['warm_utt_s']:.2f} utt/s, p50 "
        f"{rec['p50_ms']:.1f} ms, p99 {rec['p99_ms']:.1f} ms, match 1.0")


def recipe_phase(torch, card: str, work: str) -> None:
    """Phase 22: ``full_recipe_run`` (base-LAS, ``RECIPE_EPOCHS`` epochs to
    its first milestone, one Rewriter epoch, ``lminfer`` beam 8 with the
    gate), ``chain_refit`` on its run and milestone (one Rewriter epoch,
    three ``lminfer`` modes), ``best_effort_eval`` from artifacts, on a small
    generated corpus; each prints its record."""
    import math

    from attention_based_e2e_asr_dnn_tpu_torch.tools import (
        best_effort_eval,
        chain_refit,
        full_recipe_run,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.tools.make_synthetic_data import generate

    corpus = os.path.join(work, "recipe-corpus")
    n_train, n_dev, n_test = RECIPE_SPLITS
    generate(corpus, n_train=n_train, n_dev=n_dev, n_test=n_test, seed=SEED + 22)
    quiet = io.StringIO()  # the CLIs' lines; the records are printed below
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(quiet):
        recipe = full_recipe_run.main([
            "--data-dir", corpus, "--work-dir", os.path.join(work, "recipe"),
            "--epochs", str(RECIPE_EPOCHS), "--lm-epochs", "1", "--batch-size", str(CLI_BATCH),
            "--decoder-impl", "pallas", "--max-steps", str(RECIPE_MAX_STEPS),
            "--device", DEVICE])
    t_recipe = time.perf_counter() - t0
    print(json.dumps(recipe), flush=True)
    if not (len(recipe["las_dev_ld_history"]) == RECIPE_EPOCHS and all(
            math.isfinite(v) for v in (recipe["milestone_dev_ld"],
                                       recipe["rewriter_corrected_dev_ld"]))):
        raise AssertionError(f"full_recipe_run: {recipe}")
    run_dir = [os.path.join(work, "recipe", "las", d)
               for d in os.listdir(os.path.join(work, "recipe", "las")) if d != "milestones"][0]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(quiet):
        chain = chain_refit.main([
            "--data-dir", corpus, "--run-dir", run_dir, "--milestones", str(RECIPE_EPOCHS - 1),
            "--lm-epochs", "1", "--batch-size", str(CLI_BATCH), "--lm-max-steps", "120",
            "--work-dir", os.path.join(work, "chain"), "--device", DEVICE])
    t_chain = time.perf_counter() - t0
    print(json.dumps(chain), flush=True)
    modes = chain["milestones"][0]["modes"] if chain["milestones"] else {}
    if set(modes) != set(chain_refit.MODES) or not all(math.isfinite(m["test_ld"])
                                                      for m in modes.values()):
        raise AssertionError(f"chain_refit: {chain}")
    lm_run = os.path.join(work, "chain", f"lm-m{RECIPE_EPOCHS - 1}")
    lm_run = os.path.join(lm_run, sorted(os.listdir(lm_run))[-1])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(quiet):
        best = best_effort_eval.main([
            "--data-dir", corpus, "--run-dir", run_dir, "--lm-run", lm_run,
            "--batch", str(CLI_BATCH), "--work-dir", os.path.join(work, "best"),
            "--device", DEVICE])
    t_best = time.perf_counter() - t0
    print(json.dumps(best), flush=True)
    if not all(math.isfinite(best[k]) for k in ("greedy_dev_ld", "beam_dev_ld",
                                                 "beam_corrector_dev_ld")):
        raise AssertionError(f"best_effort_eval: {best}")
    log(f"[{card}] full_recipe_run ({n_train}/{n_dev}/{n_test} utterances, "
        f"{RECIPE_EPOCHS} epochs, milestone {recipe['milestone']}): dev LD "
        f"{[round(v, 2) for v in recipe['las_dev_ld_history']]}, milestone "
        f"{recipe['milestone_dev_ld']:.3f} -> corrected {recipe['rewriter_corrected_dev_ld']:.3f}; "
        f"{t_recipe:.1f} s. chain_refit: test LD in "
        f"{chain['milestones'][0]['input_test_ld']:.3f}, "
        f"{ {k: round(m['test_ld'], 3) for k, m in modes.items()} }; {t_chain:.1f} s. "
        f"best_effort_eval: greedy {best['greedy_dev_ld']:.3f} | beam "
        f"{best['beam_dev_ld']:.3f} | beam + corrector {best['beam_corrector_dev_ld']:.3f}; "
        f"{t_best:.1f} s")


# ---------------------------------------------------------------------------
# 23: data parallelism (parallel/)
# ---------------------------------------------------------------------------

DP_B, DP_T, DP_L = 64, 768, 96  # the global batch; 32 rows a rank
DP_RANKS = 2
DP_LR = 1e-3
DP_TIMEOUT_S = 300.0  # a rank stuck in a collective fails the phase
DP_TIMED_STEPS = 3
DP_PATH = ("lstm_scan_fusedin_train", "lstm_scan_train", "lstm_bwd_dw", "speller_decode_train",
           "speller_decode_bwd", "lstm_scan_fusedin", "lstm_scan", "speller_decode")


def state_digest(torch, state) -> str:
    """sha256 of every parameter and optimizer-state tensor's bytes."""
    import hashlib

    digest = hashlib.sha256()
    tensors = list(state.params.parameters())
    for leaf in state.opt_state:
        tensors.extend([leaf] if torch.is_tensor(leaf) else leaf or [])
    for t in tensors:
        digest.update(t.detach().contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()


def moment_rel_err(torch, mu, ref_mu) -> tuple:
    """After one AdamW step the first moment is (1 - b1) times the clipped
    gradient, so ||mu - ref_mu|| / ||ref_mu|| is the step's relative gradient
    error against the one-process step's. Returns it, and the same reading of
    a fault control made from ``mu`` itself: the flat gradient buffer handed
    back shifted by one parameter's size (each gradient scattered to another
    parameter's place)."""
    flat = torch.cat([m.detach().float().reshape(-1) for m in mu])
    ref = torch.cat([m.float().reshape(-1) for m in ref_mu]).to(flat.device)
    den = torch.linalg.vector_norm(ref)
    shifted = torch.roll(flat, mu[0].numel())
    return (float(torch.linalg.vector_norm(flat - ref) / den),
            float(torch.linalg.vector_norm(shifted - ref) / den))


def dp_rank(mesh, inputs_path: str) -> dict:
    """One rank of phase 23 (started by ``parallel.dp.spawn``): the DP eval
    step at the initial parameters, one DP train step with its rows of the
    one-process step's draws, its parameters against that step's, then
    ``DP_TIMED_STEPS`` timed steps on its own draws (the state's digest),
    the all-reduce of a gradient-sized buffer alone, and a step with a NaN
    in rank 0's rows (tf 1.0). The kernels' launches over all of it."""
    import numpy as np
    import torch

    from attention_based_e2e_asr_dnn_tpu_torch.models.las import TrainDraws, las_apply
    from attention_based_e2e_asr_dnn_tpu_torch.data.specaug import SpecAugDraws
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
    from attention_based_e2e_asr_dnn_tpu_torch.parallel import dp
    from attention_based_e2e_asr_dnn_tpu_torch.parallel.mesh import shard_rows

    ref = torch.load(inputs_path, weights_only=False)
    cfg = train_config()
    opt, state, _ = build_trainer(torch, cfg, torch.bfloat16, SEED)

    def apply_fn(p, x, lx, **kwargs):
        return las_apply(p, cfg, x, lx, **kwargs)

    step = dp.make_dp_train_step(apply_fn, opt, mesh, compute_dtype=torch.bfloat16,
                                 use_specaug=True)
    eval_step = dp.make_dp_eval_step(apply_fn, mesh, compute_dtype=torch.bfloat16)
    rows = shard_rows(DP_B, mesh)
    x, lx, y, ly = (t[rows].to(mesh.device) for t in ref["batch"])
    d = ref["draws"]  # the global batch's; coins and SpecAugment's (1,) draws are shared
    on = lambda t: None if t is None else t.to(mesh.device)  # noqa: E731
    draws = TrainDraws([on(m[rows]) if m is not None else None for m in d.listener_masks],
                       on(d.coins), on(None if d.m1 is None else d.m1[:, rows]),
                       on(None if d.m2 is None else d.m2[:, rows]),
                       SpecAugDraws(*(on(t) for t in d.specaug)))
    out = {"rank": mesh.rank, "backend": mesh.backend}
    lc.reset_launch_counts()
    sc.reset_launch_counts()
    with forbid_plain():
        metrics, local_ids = eval_step(state.params, x, lx, y, ly)
        out["eval"] = {k: float(v) for k, v in metrics.items()}
        out["eval_ids"] = dp.gather_rows(mesh, local_ids)
        state, m, _ = step(state, x, lx, y, ly, 0.9, DP_LR, draws=draws)
        torch.cuda.synchronize()
        out["parity"] = {k: float(v) for k, v in m.items()}
        worst, off, total = 0.0, 0, 0
        for p, q in zip(state.params.parameters(), ref["params"]):
            diff = (p.detach() - q.to(p.device)).abs()
            worst = max(worst, diff.max().item())
            off += int((diff > 1e-5).sum())
            total += diff.numel()
        out["param_diff"] = (worst, off, total)
        out["mu_rel"], out["mu_rel_shifted"] = moment_rel_err(torch, state.opt_state.mu,
                                                              ref["mu"])
        times = []
        for _ in range(DP_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m, _ = step(state, x, lx, y, ly, 0.9, DP_LR)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if not bool(m["finite"]):
                raise AssertionError(f"rank {mesh.rank}: a timed DP step was not finite")
        out["step_s"] = times
        out["digest"] = state_digest(torch, state)
        # the gradients' all-reduce alone: one flat buffer of every parameter
        # and the loss, as the step sends it
        n = sum(p.numel() for p in state.params.parameters()) + 1
        buf = torch.zeros(n, device=mesh.device)
        ar = []
        for _ in range(6):
            torch.distributed.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dp.all_reduce_sum(buf, mesh)
            torch.cuda.synchronize()
            ar.append(time.perf_counter() - t0)
        out["all_reduce_s"] = ar[1:]
        out["all_reduce_bytes"] = 4 * n
        before = out["digest"]
        xn = x.clone()
        if mesh.rank == 0:
            xn[0, 0, 0] = float("nan")
        state, m, _ = step(state, xn, lx, y, ly, 1.0, DP_LR)
        out["nan_step"] = (bool(m["finite"]), before, state_digest(torch, state))
        torch.cuda.synchronize()
    out["launches"] = {**lc.LAUNCHES, **sc.LAUNCHES}
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return out


def dp_train_phase(torch, card: str, work: str) -> dict:
    """Phase 23's DP train step at base-LAS width: the one-process step and
    eval here (the reference, and its times at 64 and 32 rows), then
    ``DP_RANKS`` gloo ranks on this one card (``dp_rank``). Returns the
    launches of the ranks' runs, summed."""
    import numpy as np

    from attention_based_e2e_asr_dnn_tpu_torch.data.specaug import draw_specaug
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import draw_train_noise, las_apply
    from attention_based_e2e_asr_dnn_tpu_torch.parallel import dp
    from attention_based_e2e_asr_dnn_tpu_torch.training.steps import make_eval_step

    cfg = train_config()
    x, lx, y, ly = train_batch(torch, DP_B, DP_T, DP_L, SEED + 23)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    draws = draw_train_noise(cfg, DP_B, DP_L, gen, DEVICE,
                             specaug=draw_specaug(DP_B, 6, 200, False, gen, DEVICE))
    _, state, step = build_trainer(torch, cfg, torch.bfloat16, SEED)
    eval_step = make_eval_step(lambda p, xs, ls, **kw: las_apply(p, cfg, xs, ls, **kw),
                               compute_dtype=torch.bfloat16)
    with forbid_plain():
        e_metrics, e_ids = eval_step(state.params, x, lx, y, ly)
        state, m, _ = step(state, x, lx, y, ly, 0.9, DP_LR, draws=draws)
        torch.cuda.synchronize()
    one = {k: float(v) for k, v in m.items()}
    one_eval = {k: float(v) for k, v in e_metrics.items()}
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    inputs = os.path.join(work, "dp_inputs.pt")
    torch.save({"batch": [t.cpu() for t in (x, lx, y, ly)],
                "draws": type(draws)([cpu(t) for t in draws.listener_masks], cpu(draws.coins),
                                     cpu(draws.m1), cpu(draws.m2),
                                     type(draws.specaug)(*map(cpu, draws.specaug))),
                "params": [p.detach().cpu() for p in state.params.parameters()],
                "mu": [m.detach().cpu() for m in state.opt_state.mu]}, inputs)
    # the one-process step's time at the global batch and at a rank's rows
    one_s = {}
    with forbid_plain():
        for rows in (DP_B, DP_B // DP_RANKS):
            args = (x[:rows], lx[:rows], y[:rows], ly[:rows])
            state, _, _ = step(state, *args, 0.9, DP_LR)
            times = []
            for _ in range(DP_TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _, _ = step(state, *args, 0.9, DP_LR)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            one_s[rows] = statistics.median(times)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = dp.spawn(dp_rank, DP_RANKS, args=(inputs,), devices=[f"{DEVICE}:0"] * DP_RANKS,
                     timeout_s=DP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    tol = TRAIN_TOL["bfloat16"]
    for r in ranks:
        got = r["parity"]
        for key in ("loss", "grad_norm"):
            if not abs(got[key] - one[key]) <= tol * abs(one[key]):
                raise AssertionError(f"DP rank {r['rank']}: {key} {got[key]} vs the "
                                     f"one-process step's {one[key]} (rtol {tol})")
        if not (got["finite"] and got["n_tokens"] == one["n_tokens"]):
            raise AssertionError(f"DP rank {r['rank']}: metrics {got} vs {one}")
        # Parameters: the first AdamW step moves every element by about
        # +-lr whatever its gradient, so the parameters alone cannot show a
        # gradient scattered to the wrong place (max_abs_diff <= 2 lr holds
        # for any gradient; elements off by more than 1e-5 are printed, not
        # bounded: the sign of a gradient that is bf16 rounding noise around
        # zero may flip). The first moment holds the gradient itself: its
        # relative error against the one-process step's must stay within the
        # bf16 rtol of loss and grad_norm (the shifted-buffer control reads
        # ~1.4 there; a gradient averaged over the ranks halves grad_norm).
        worst, off, total = r["param_diff"]
        if not worst <= 2 * DP_LR * 1.01:
            raise AssertionError(f"DP rank {r['rank']}: parameters differ by {worst}")
        if not r["mu_rel"] <= tol < r["mu_rel_shifted"]:
            raise AssertionError(f"DP rank {r['rank']}: the first moment's relative error "
                                 f"{r['mu_rel']} (shifted-buffer control "
                                 f"{r['mu_rel_shifted']}) against rtol {tol}")
        ev = r["eval"]
        if not (abs(ev["loss"] - one_eval["loss"]) <= tol * abs(one_eval["loss"])
                and ev["n_tokens"] == one_eval["n_tokens"]):
            raise AssertionError(f"DP rank {r['rank']}: eval {ev} vs {one_eval}")
        finite, before, after = r["nan_step"]
        if finite or before != after:
            raise AssertionError(f"DP rank {r['rank']}: the NaN step was not a global no-op")
        idle = [k for k in DP_PATH if r["launches"][k] <= 0]
        if idle or r["backend"] != "gloo":
            raise AssertionError(f"DP rank {r['rank']} ({r['backend']}): never launched {idle}")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("DP: the ranks' parameters or optimizer states differ after "
                             f"{DP_TIMED_STEPS} steps")
    same_ids = [float((r["eval_ids"] == e_ids.cpu().numpy()).all(axis=1).mean()) for r in ranks]
    log(f"[{card}] DP base-LAS bf16, {DP_RANKS} gloo ranks sharing this card, global batch "
        f"B={DP_B} T={DP_T} L={DP_L} ({DP_B // DP_RANKS} rows a rank), both kernel tiers, "
        f"SpecAugment and dropout on, tf 0.9: one step on the one-process step's draws, "
        f"loss {[round(r['parity']['loss'], 5) for r in ranks]} vs {one['loss']:.5f}, "
        f"grad_norm {[round(r['parity']['grad_norm'], 4) for r in ranks]} vs "
        f"{one['grad_norm']:.4f} (rtol {tol}), n_tokens {one['n_tokens']:.0f}; parameters "
        f"max_abs_diff {[r['param_diff'][0] for r in ranks]} (bound 2 x lr), elements off "
        f"by more than 1e-5 {[r['param_diff'][1] for r in ranks]} of "
        f"{ranks[0]['param_diff'][2]}; first moment (the gradient) relative error "
        f"{[r['mu_rel'] for r in ranks]} (rtol {tol}; shifted-buffer control "
        f"{[r['mu_rel_shifted'] for r in ranks]}); DP eval loss "
        f"{[round(r['eval']['loss'], 5) for r in ranks]} vs {one_eval['loss']:.5f}, rows with the one-process ids {same_ids}; after "
        f"{DP_TIMED_STEPS} more steps the ranks' states bit-equal (sha256); a NaN in rank 0's "
        f"rows skipped on both; spawn to results {wall:.1f} s")
    step_ms = [1e3 * statistics.median(r["step_s"]) for r in ranks]
    ar_ms = [1e3 * statistics.median(r["all_reduce_s"]) for r in ranks]
    log(f"[{card}] DP times: the DP step a rank {[round(v, 1) for v in step_ms]} ms (median of "
        f"{DP_TIMED_STEPS}; two processes time-slice the card); its all-reduce of "
        f"{ranks[0]['all_reduce_bytes'] / 2**20:.1f} MiB alone {[round(v, 1) for v in ar_ms]} "
        f"ms (gloo: staged through the host, on one card; not NCCL across cards); the "
        f"one-process step at {DP_B} rows {1e3 * one_s[DP_B]:.1f} ms, at {DP_B // DP_RANKS} "
        f"rows {1e3 * one_s[DP_B // DP_RANKS]:.1f} ms; peak device memory a rank "
        f"{[round(r['peak_mib'], 1) for r in ranks]} MiB; launches a rank "
        f"{[{k: r['launches'][k] for k in DP_PATH} for r in ranks]}")
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


def dp_cli_phase(torch, card: str, corpus: str, work: str) -> dict:
    """The ``train`` CLI with ``parallel: {use: true, data: 1}`` (one rank in
    a group of its own, NCCL) on phase 11's corpus, base-LAS for 2 epochs;
    its checkpoint resumed with ``parallel.use: false`` for one more epoch;
    ``infer`` from its folder. Returns the DP run's launches."""
    import yaml

    from attention_based_e2e_asr_dnn_tpu_torch import infer, train
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
    from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import (
        list_best_checkpoints,
        load_checkpoint,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", "base-las.yml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg.update(batch_size=CLI_BATCH, epochs=2, parallel={"use": True, "data": 1},
               TRN_FOLDER=os.path.join(corpus, "train-clean-100"),
               DEV_FOLDER=os.path.join(corpus, "dev-clean"),
               TST_FOLDER=os.path.join(corpus, "test-clean"),
               EXP_FOLDER=os.path.join(work, "experiments-dp"),
               MST_FOLDER=os.path.join(work, "milestones-dp"))

    def run(name, cfg):
        path = os.path.join(work, name)
        with open(path, "w") as fh:
            yaml.safe_dump(cfg, fh)
        return train.main(train.build_argparser().parse_args(["-c", path, "--device",
                                                               DEVICE]))

    lc.reset_launch_counts()
    sc.reset_launch_counts()
    tee = Tee(sys.stdout)
    with forbid_plain(), contextlib.redirect_stdout(tee):
        summary = run("train-dp.yml", cfg)
    counts = {**lc.LAUNCHES, **sc.LAUNCHES}
    said = [ln for ln in tee.getvalue().splitlines() if ln.startswith("[parallel]")]
    trn, dev = summary.train_history, summary.dev_history
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    if not (said and f"over 1 devices ({backend}" in said[0]):
        raise AssertionError(f"train CLI DP: the [parallel] line is {said}")
    if not (len(trn["loss"]) == 2 and all(v == v and abs(v) != float("inf")
                                          for v in trn["loss"] + dev["loss"] + dev["ld"])):
        raise AssertionError(f"train CLI DP: histories {trn} {dev}")
    idle = [k for k in DP_PATH if counts[k] <= 0]
    if idle:
        raise AssertionError(f"train CLI DP: never launched {idle}")
    kept = list_best_checkpoints(os.path.join(summary.saving_dir, "ckpts"))
    # the newest checkpoint kept, so that the resume continues the DP run as
    # far as it can
    newest = max(kept, key=lambda name: int(name.rsplit("epoch[", 1)[1].split("]")[0]))
    last = os.path.join(summary.saving_dir, "ckpts", newest)
    saved = load_checkpoint(last)
    cfg.update(parallel={"use": False}, epochs=saved["epoch"] + 1,
               finetune={"use": True, "reinit_lr": False, "checkpoint": last},
               EXP_FOLDER=os.path.join(work, "experiments-dp-resumed"))
    with forbid_plain():
        resumed = run("resume-dp.yml", cfg)
    if not (resumed.epoch == saved["epoch"] + 1
            and resumed.train_history["loss"][:-1] == saved["train_loss"]):
        raise AssertionError("train CLI DP: the one-card resume did not continue the DP run")
    infer_cfg = os.path.join(work, "infer-dp.yml")
    with open(infer_cfg, "w") as fh:
        fh.write(f"SOME_FOLDER: {os.path.join(corpus, 'test-clean')}\n"
                 f"exp_folder: {summary.saving_dir}\nbatch_size: {CLI_BATCH}\n"
                 f"pad_time_multiple: 256\nrun_all: false\nepoch_num: {saved['epoch']}\n"
                 f"run_avg: false\n")
    with forbid_plain():
        infer.main(infer.build_argparser().parse_args(["-c", infer_cfg, "--device", DEVICE]))
    preds = f"{os.path.splitext(newest)[0]}-tst.csv"
    with open(os.path.join(summary.saving_dir, "preds", preds)) as fh:
        rows = fh.read().split("\n")[1:-1]
    if len(rows) != N_CLI_TEST:
        raise AssertionError(f"train CLI DP -> infer: {preds} has {len(rows)} rows")
    log(f"[{card}] train CLI base-LAS bf16 parallel data 1 ({said[0]}): train loss "
        f"{[round(v, 4) for v in trn['loss']]}, dev loss {[round(v, 4) for v in dev['loss']]}, "
        f"dev LD {[round(v, 3) for v in dev['ld']]}; ckpts {kept}; resumed from {newest} with "
        f"parallel.use false at epoch {saved['epoch']}, train loss "
        f"{resumed.train_history['loss'][-1]:.4f}; infer wrote {preds} ({len(rows)} rows); "
        f"launches {counts}")
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def dp_lmtrain_phase(torch, card: str, lm_corpus: dict, work: str) -> dict:
    """The ``lmtrain`` CLI with ``parallel: {use: true, data: 1}`` on phase
    17's corpus, both kernel tiers, one epoch. Returns its launches."""
    import yaml

    from attention_based_e2e_asr_dnn_tpu_torch import lmtrain
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", "rewriter.yml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg["model"]["configs"].update(KERNEL_TIERS)
    cfg.update(epochs=1, parallel={"use": True, "data": 1},
               TRN_FOLDER=lm_corpus["train"][0], DEV_FOLDER=lm_corpus["dev"][0],
               TRN_PRED_DIR=lm_corpus["train"][1], DEV_PRED_DIR=lm_corpus["dev"][1],
               EXP_FOLDER=os.path.join(work, "experiments-lm-dp"))
    path = os.path.join(work, "lm-dp.yml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    lc.reset_launch_counts()
    sc.reset_launch_counts()
    with forbid_plain():
        summary = lmtrain.main(lmtrain.build_argparser().parse_args(["-c", path, "--device",
                                                                     DEVICE]))
    counts = {**lc.LAUNCHES, **sc.LAUNCHES}
    losses = summary.train_history["loss"] + summary.dev_history["loss"]
    idle = [k for k in ("lstm_scan_train", "lstm_bwd_dw", "speller_decode_train",
                        "speller_decode_bwd", "lstm_scan", "speller_decode") if counts[k] <= 0]
    if idle or len(losses) != 2 or not all(v == v and abs(v) != float("inf") for v in losses):
        raise AssertionError(f"lmtrain DP: losses {losses}, never launched {idle}")
    log(f"[{card}] lmtrain Rewriter parallel data 1: one epoch, train loss {losses[0]:.4f}, "
        f"dev loss {losses[1]:.4f}; launches {counts}")
    return counts


def dp_probe_phase(card: str) -> None:
    """``tools/dp_probe.py`` in-process: its JSON line."""
    from attention_based_e2e_asr_dnn_tpu_torch.tools import dp_probe

    out = dp_probe.probe()
    if not (out["ok"] and out["backend"] == "nccl"):
        raise AssertionError(f"dp_probe: {out}")
    log(f"[{card}] dp_probe: {json.dumps(out)}")


def dp_serve_phase(torch, card: str, t, exp: str, feats: list, work: str) -> dict:
    """Data-parallel decoding on one card: ``Transcriber(data_parallel=2)``
    refuses (one card visible); the split itself over ``[cuda:0, cuda:0]``
    (two row blocks, two streams) gives phase 4's transcripts exactly, and a
    ``data_parallel=2`` artifact over the same list those of a
    ``data_parallel=1`` artifact. Returns the split runs' launches."""
    from attention_based_e2e_asr_dnn_tpu_torch import export
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.parallel import split
    from attention_based_e2e_asr_dnn_tpu_torch.serving import Transcriber

    if torch.cuda.device_count() == 1:
        try:
            Transcriber(exp, batch_size=B, data_parallel=2, device=DEVICE)
        except ValueError as exc:
            if "data_parallel=2 but only 1 devices visible" not in str(exc):
                raise
        else:
            raise AssertionError("Transcriber(data_parallel=2) did not refuse one card")
    want = t.transcribe(feats)
    t_pad = -(-max(map(len, feats)) // 256) * 256
    paths = {n: export.export_from_experiment(exp, os.path.join(work, f"las-dp{n}.tlas"),
                                              batch=B, t_pad=t_pad, data_parallel=n)
             for n in (1, 2)}
    saved = split.dp_devices
    split.dp_devices = lambda device, n: [torch.device(DEVICE, 0)] * n
    try:
        t2 = Transcriber(exp, batch_size=B, pad_time_multiple=128, data_parallel=2,
                         device=DEVICE)
        lc.reset_launch_counts()
        t0 = time.perf_counter()
        got = t2.transcribe(feats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(lc.LAUNCHES)
        arts = {n: export.ArtifactTranscriber([p], device=DEVICE) for n, p in paths.items()}
        lc.reset_launch_counts()
        art_texts = {n: a.transcribe(feats) for n, a in arts.items()}
        for k, v in lc.LAUNCHES.items():
            counts[k] += v
    finally:
        split.dp_devices = saved
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"the split over two blocks changed {bad} of phase 4's transcripts")
    if art_texts[2] != art_texts[1] or arts[2].buckets[0]._split is None:
        raise AssertionError("the data_parallel=2 artifact's transcripts differ from the "
                             "data_parallel=1 artifact's")
    if not all(counts[k] > 0 for k in ("lstm_scan_fusedin", "lstm_scan")):
        raise AssertionError(f"the split ran no kernel: {counts}")
    agree = sum(a == b for a, b in zip(art_texts[2], want))
    log(f"[{card}] Transcriber(data_parallel=2) refuses one card; the split over [cuda:0, "
        f"cuda:0] ({B // 2} rows a block, a stream each): {len(feats)} utts in {wall:.3f} s, "
        f"transcripts equal to phase 4's; artifact data_parallel=2 (B={B}, t_pad {t_pad}) "
        f"equal to data_parallel=1's ({agree}/{len(feats)} equal to phase 4's own batches); "
        f"launches {counts}")
    del t2, arts
    return counts


# ---------------------------------------------------------------------------
# Phase 24: the two remaining drivers
# ---------------------------------------------------------------------------

FULLSCALE_CORPUS = (256, 32, 32)  # train / dev / test utterances, 25-45 words
FULLSCALE_WORDS = (25, 45)        # make_synthetic_data --words 25 45: long-form
FULLSCALE_BATCH, FULLSCALE_EPOCHS = 32, 2
FULLSCALE_PATH = ("lstm_scan_fusedin_train", "lstm_scan_train", "lstm_bwd_dw",
                  "lstm_scan_fusedin", "lstm_scan", "speller_decode")
CONTROL_PATH = ("speller_decode_train", "speller_decode_bwd")


def fullscale_phase(torch, card: str, work: str) -> dict:
    """``tools/fullscale_run.py`` in both modes on a generated long-form
    corpus; returns the launches of both runs, summed."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
        decode_route_report,
        reset_decode_routes,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
    from attention_based_e2e_asr_dnn_tpu_torch.tools import fullscale_run
    from attention_based_e2e_asr_dnn_tpu_torch.tools.make_synthetic_data import generate

    data = os.path.join(work, "fullscale-data")
    n_train, n_dev, n_test = FULLSCALE_CORPUS
    generate(data, n_train=n_train, n_dev=n_dev, n_test=n_test,
             words_min=FULLSCALE_WORDS[0], words_max=FULLSCALE_WORDS[1], seed=SEED + 24)
    total = {}
    for mode in ("resident", "streamed"):
        lc.reset_launch_counts()
        sc.reset_launch_counts()
        reset_decode_routes()
        t0 = time.perf_counter()
        with forbid_plain():
            result = fullscale_run.main([
                "--data-dir", data, "--epochs", str(FULLSCALE_EPOCHS), "--batch-size",
                str(FULLSCALE_BATCH), "--mode", mode, "--device", DEVICE,
                "--work-dir", os.path.join(work, f"fullscale-{mode}")])
        seconds = time.perf_counter() - t0
        counts = {**lc.LAUNCHES, **sc.LAUNCHES}
        idle = [k for k in FULLSCALE_PATH if counts[k] <= 0]
        if idle:
            raise AssertionError(f"fullscale_run {mode}: never launched {idle}")
        routes = decode_route_report()
        if counts["speller_decode_train"] or counts["speller_decode_bwd"]:
            raise AssertionError(f"fullscale_run {mode}: the fused decoder trained under "
                                 f"init_force ({counts}); the JAX package takes the scan loop")
        values = (result["train_loss_history"] + result["dev_loss_history"]
                  + result["dev_ld_history"])
        if not (len(result["train_loss_history"]) == FULLSCALE_EPOCHS
                and all(v == v and abs(v) != float("inf") for v in values)):
            raise AssertionError(f"fullscale_run {mode}: histories not finite: {result}")
        log(f"[{card}] fullscale_run --mode {mode}: {n_train} utterances, batch "
            f"{FULLSCALE_BATCH}, {FULLSCALE_EPOCHS} epochs in {seconds:.1f} s; train_utt_s "
            f"{result['train_utt_s']:.2f}, epoch_utt_s_end_to_end "
            f"{result['epoch_utt_s_end_to_end']:.2f}, best dev LD {result['best_dev_ld']:.3f}; "
            f"routes {routes}; launches {counts}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def control_fused_check(torch, card: str) -> None:
    """#8's train form and #9 at ``speller_control``'s shapes, on the tool's
    own parameters, inputs and draws: logits and every operand's gradient
    through ``fused_decode`` on the kernels against the same Function over
    the plain versions, both fed the kernel's ids."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import draw_train_noise
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
    from attention_based_e2e_asr_dnn_tpu_torch.tools import speller_control as ctl

    cfg = ctl.scaled_cfg("pallas", ctl.H1, ctl.H2, ctl.PROJ, ctl.EMB, ctl.HEADS)
    spl = cfg.speller
    params, enc_h, enc_l, y, _ = ctl.inputs(cfg, DEVICE, ctl.B, ctl.TE, ctl.L)
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    draws = draw_train_noise(cfg, ctl.B, ctl.L, gen, DEVICE)
    with torch.no_grad():
        operands, _ = sc.decode_operands(params, spl, enc_h, enc_l)
    forced, m1, m2 = sc.decode_draws(spl, y, 0.9, True, draws, enc_h.dtype)
    opts = {**sc.decode_options(spl), "steps": ctl.L}
    logits, _, _, saved = sc.speller_decode_train(*operands, **opts, forced=forced, m1=m1, m2=m2)
    sel = saved[0]
    gen = torch.Generator().manual_seed(SEED + 24)
    d_logits = (torch.randn(logits.shape, generator=gen) * 0.1).to(DEVICE).to(enc_h.dtype)
    d_logits[..., spl.dec_vocab_size:] = 0.0
    outs, grads = {}, {}
    for route in ("kernels", "plain"):
        fns = (sc.speller_decode_train, sc.speller_decode_bwd)
        if route == "plain":
            sc.speller_decode_train = sc.speller_decode_train_plain
            sc.speller_decode_bwd = sc.speller_decode_bwd_plain
        try:
            leaves = [t.detach().requires_grad_(n != "bias")
                      for n, t in zip(OPERAND_NAMES, operands)]
            out = sc.fused_decode(leaves, **opts, forced=sel, m1=m1, m2=m2)
            outs[route] = out[0].detach()
            grads[route] = torch.autograd.grad(out[0], [t for t in leaves if t.requires_grad],
                                               d_logits)
        finally:
            sc.speller_decode_train, sc.speller_decode_bwd = fns
    tol = SPELLER_TRAIN_TOL["bfloat16"]
    vocab = spl.dec_vocab_size
    errs = {"logits": rel_err(outs["kernels"][..., :vocab], outs["plain"][..., :vocab])}
    errs.update({"d_" + n: rel_err(a, b) for n, a, b in zip(
        [n for n in OPERAND_NAMES if n != "bias"], grads["kernels"], grads["plain"])})
    worst = max(errs, key=lambda n: errs[n][1])
    log(f"[{card}] speller_control's fused tier (B={ctl.B}, Te={ctl.TE}, L={ctl.L}, H1 "
        f"{ctl.H1}, {ctl.HEADS} heads, bf16, tf 0.9, dropout 0.3): #8 train form + #9 through the "
        f"Function against the plain versions, {len(errs)} tensors, largest "
        f"{errs[worst][1]:.1e} of max ({worst}; tolerance {tol:g})")
    bad = {n: r for n, (_, r) in errs.items() if not r <= tol}
    if bad:
        raise AssertionError(f"speller_control fused tier: errors over {tol} of max: {bad}")


def fmt_mfu(value) -> str:
    return "not measured" if value is None else f"{value:.4f}"


def speller_control_phase(torch, card: str) -> dict:
    """``tools/speller_control.py`` at its full widths; the fused tier held
    to its plain versions. Returns the launches of the tool's run."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
    from attention_based_e2e_asr_dnn_tpu_torch.tools import speller_control as ctl

    lc.reset_launch_counts()
    sc.reset_launch_counts()
    with forbid_plain():
        result = ctl.main(["--device", DEVICE, "--steps", "4", "--windows", "2"])
    counts = {**lc.LAUNCHES, **sc.LAUNCHES}
    idle = [k for k in CONTROL_PATH if counts[k] <= 0]
    if idle:
        raise AssertionError(f"speller_control: never launched {idle}")
    walls = result["walls_ms"]
    log(f"[{card}] speller_control (bf16, B={ctl.B}, Te={ctl.TE}, L={ctl.L}, peak "
        f"{result['peak_flops']}): " + ", ".join(
            f"{k} {v:.2f} ms (MFU {fmt_mfu(result['mfu'][k])})" for k, v in walls.items())
        + f"; launches {counts}")
    control_fused_check(torch, card)
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Phase 25: tensor, sequence and pipeline parallelism
# ---------------------------------------------------------------------------

PAR_B, PAR_T, PAR_L = 16, 256, 32
PAR_TOL = 2e-5
PAR_MODES = {
    # name: (grid axes and sizes, or a pipeline's (microbatches, dp, tp))
    "TP 1x2": ("2d", (1, 2)),
    "DPxTP 2x2": ("2d", (2, 2)),
    "SP seq 2": ("seq", (1, 2)),
    "SPxTP 1x2x2": ("3d", (1, 2, 2)),
    "PP 2 microbatches": ("pipe", (2, 1, 1)),
    "PPxDPxTP 2x2": ("pipe", (2, 2, 2)),
}


def par_config(steps: int = 600):
    """base-LAS at full width on the scan tiers, every dropout 0."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import las_config_from_dicts

    return las_config_from_dicts(
        {**BASE_LAS_MODEL["listener_configs"], "lstm_impl": "scan", "init_dropout": 0.0,
         "mid_dropout": 0.0, "final_dropout": 0.0},
        {**BASE_LAS_MODEL["speller_configs"], "decoder_impl": "scan", "dec_lstm_dropout": 0.0,
         "att_dropout": 0.0, "dec_emb_dropout": 0.0, "CHR_MAX_STEPS": steps})


def par_mode_step(torch, name: str, cfg, params, batch, lr: float) -> tuple:
    """One step of mode ``name`` on ``[cuda:0] * n`` from ``params``:
    (metrics, the first moment whole in the module's order, seconds, the
    parameter bytes a device holds)."""
    from attention_based_e2e_asr_dnn_tpu_torch.parallel import grid as pgrid
    from attention_based_e2e_asr_dnn_tpu_torch.parallel import mesh as pmesh
    from attention_based_e2e_asr_dnn_tpu_torch.parallel import pipeline as ppipe
    from attention_based_e2e_asr_dnn_tpu_torch.train import make_las_apply_factory
    from attention_based_e2e_asr_dnn_tpu_torch.training.optim import build_optimizer
    from attention_based_e2e_asr_dnn_tpu_torch.training.steps import create_train_state

    import numpy as np

    kind, sizes = PAR_MODES[name]
    card = torch.device(DEVICE, 0) if torch.device(DEVICE).type == "cuda" else DEVICE
    if kind == "pipe":
        n_mb, dp, tp = sizes
        devices = [card] * (2 * dp * tp)
        opt = build_optimizer("adamw", {"lr": lr, "amsgrad": True}, grad_norm=1e30)
        state = ppipe.init_pipeline_state(params, opt, SEED, devices, dp=dp, tp=tp)
        step = ppipe.make_pipeline_train_step(cfg, opt, devices, n_mb,
                                              grad_norm=5.0, dp=dp, tp=tp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, *batch, 1.0, lr)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        mu = []
        for gp, o in ((state.params_listener, state.opt_listener),
                      (state.params_speller, state.opt_speller)):
            mu += pmesh.gather_opt_state(gp, o, card).mu
        return metrics, mu, seconds, (state.params_listener.per_device_bytes()
                                      + state.params_speller.per_device_bytes())
    if kind == "3d":
        grid = pmesh.make_mesh_3d(*sizes, devices=[card] * int(np.prod(sizes)))
    elif kind == "seq":
        grid = pmesh.make_mesh_2d(*sizes, axis_names=("data", "seq"), devices=[card] * 2)
    else:
        grid = pmesh.make_mesh_2d(*sizes, devices=[card] * int(np.prod(sizes)))
    opt = build_optimizer("adamw", {"lr": lr, "amsgrad": True}, grad_norm=5.0)
    state = pmesh.shard_train_state(create_train_state(params, opt, seed=SEED, device=card),
                                    grid)
    step = pgrid.make_grid_train_step(make_las_apply_factory(cfg)(1.0), opt, grid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics, _ = step(state, *batch, 1.0, lr)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    mu = pmesh.gather_opt_state(state.params, state.opt_state, card).mu
    return metrics, mu, seconds, state.params.per_device_bytes()


def par_trainer_check(torch, card: str, cfg, work: str) -> None:
    """One ``Trainer`` epoch with ``shard_state`` at model 2 and one with
    ``pipeline`` (2 microbatches), each on its device list; each checkpoint
    resumed by the one-device Trainer, the parameters equal."""
    from attention_based_e2e_asr_dnn_tpu_torch import constants
    from attention_based_e2e_asr_dnn_tpu_torch.config import Config
    from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher
    from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import AsrTrainDevDataset
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import las_init
    from attention_based_e2e_asr_dnn_tpu_torch.parallel import mesh as pmesh
    from attention_based_e2e_asr_dnn_tpu_torch.tools.make_synthetic_data import generate
    from attention_based_e2e_asr_dnn_tpu_torch.train import make_las_apply_factory
    from attention_based_e2e_asr_dnn_tpu_torch.training.trainer import Trainer

    data = os.path.join(work, "par-data")
    generate(data, n_train=32, n_dev=16, n_test=8, words_min=2, words_max=4, seed=SEED + 25)
    trn_cfg = {"seed": 3, "epochs": 1, "batch_size": 16, "accu_grad": 1, "grad_norm": 5.0,
               "init_force": False, "tf_rate": 1.0, "max_savings": 2, "use_specaug": False,
               "eval_ld_interval": 1, "optimizer": {"name": "adamw", "configs": {"lr": 1e-3}}}
    card_dev = torch.device(DEVICE, 0) if torch.device(DEVICE).type == "cuda" else DEVICE

    def trainer(name, **kwargs):
        sets = [AsrTrainDevDataset(std_dir=os.path.join(data, split),
                                   label_to_idx=constants.VOCAB_MAP, keep_tags=True)
                for split in ("train-clean-100", "dev-clean")]
        trn = BucketBatcher(sets[0], 16, 128, 32, label_pad_id=29, shuffle=True, seed=3)
        dev = BucketBatcher(sets[1], 16, 128, 32, label_pad_id=29)
        return Trainer(init_fn=lambda g: las_init(cfg, g),
                       make_apply=make_las_apply_factory(cfg), trn_batcher=trn,
                       dev_batcher=dev, trncfgs=Config(trn_cfg),
                       saving_dir=os.path.join(work, f"par-{name}"), sos_idx=0, eos_idx=29,
                       device=DEVICE, **kwargs)

    grid = pmesh.make_mesh_2d(1, 2, devices=[card_dev] * 2)
    runs = {
        "shard_state model 2": dict(shard_batch=pmesh.shard_batch_fn(grid),
                                    shard_state=lambda s: pmesh.shard_train_state(s, grid)),
        "pipeline 2 microbatches": dict(pipeline={"cfg": cfg, "n_microbatches": 2,
                                                  "devices": [card_dev] * 2}),
    }
    for name, kwargs in runs.items():
        t0 = time.perf_counter()
        tr = trainer(name.split()[0], **kwargs)
        tr.train_eval(1)
        ckpt = os.path.join(tr.saving_dir, "ckpts", "last.ckpt")
        tr.save(ckpt)
        seconds = time.perf_counter() - t0
        hist = tr.train_history["loss"] + tr.dev_history["loss"] + tr.dev_history["ld"]
        if not all(v == v and abs(v) != float("inf") for v in hist):
            raise AssertionError(f"Trainer {name}: histories {hist}")
        one = trainer(name.split()[0] + "-resumed")
        one.load(ckpt)
        whole = tr.whole_params()
        if not all(torch.equal(p, q.to(p.device)) for p, q in
                   zip(one.state.params.parameters(), whole.parameters())):
            raise AssertionError(f"Trainer {name}: the one-device resume's parameters differ")
        log(f"[{card}] Trainer epoch, {name}: train loss {tr.train_history['loss'][0]:.4f}, "
            f"dev loss {tr.dev_history['loss'][0]:.4f}, dev LD {tr.dev_history['ld'][0]:.3f}, "
            f"{seconds:.1f} s; its checkpoint resumed by the one-device Trainer at epoch "
            f"{one.epoch}, the parameters equal")
        del tr, one, whole
        gc.collect()
        torch.cuda.empty_cache()


def parallel_phase(torch, card: str, work: str) -> None:
    """Phase 25: each mode's step against the one-device scan step; the
    Trainer's epochs and resumes."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import las_init
    from attention_based_e2e_asr_dnn_tpu_torch.parallel import mesh as pmesh
    from attention_based_e2e_asr_dnn_tpu_torch.train import make_las_apply_factory
    from attention_based_e2e_asr_dnn_tpu_torch.training.optim import build_optimizer
    from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
        create_train_state,
        make_train_step,
    )

    cfg = par_config()
    batch = train_batch(torch, PAR_B, PAR_T, PAR_L, SEED + 25)
    lr = 1e-3

    def fresh():
        return las_init(cfg, torch.Generator().manual_seed(SEED))

    opt = build_optimizer("adamw", {"lr": lr, "amsgrad": True}, grad_norm=5.0)
    state = create_train_state(fresh(), opt, seed=SEED, device=DEVICE)
    step = make_train_step(make_las_apply_factory(cfg)(1.0), opt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, ref, _ = step(state, *batch, 1.0, lr)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref = {k: float(v) for k, v in ref.items()}
    ref_mu = torch.cat([m.reshape(-1) for m in state.opt_state.mu])
    bytes_one = pmesh.GridParams(fresh(), pmesh.make_mesh_2d(1, 1, devices=[DEVICE])
                                 ).per_device_bytes()
    bytes_two = pmesh.GridParams(fresh(), pmesh.make_mesh_2d(1, 2, devices=[DEVICE] * 2)
                                 ).per_device_bytes()
    log(f"[{card}] parallel steps, base-LAS scan tiers float32 (TF32 off), B={PAR_B}, "
        f"T={PAR_T}, L={PAR_L}: one-device step {ref_s:.3f} s, loss {ref['loss']:.6f}, "
        f"grad norm {ref['grad_norm']:.6f}; parameter bytes a device holds: model 1 "
        f"{bytes_one}, model 2 {bytes_two}")
    del state
    failures = []
    for name in PAR_MODES:
        metrics, mu, seconds, dev_bytes = par_mode_step(torch, name, cfg, fresh(), batch, lr)
        metrics = {k: float(v) for k, v in metrics.items()}
        flat = torch.cat([m.reshape(-1) for m in mu]).to(ref_mu.device)
        if flat.numel() != ref_mu.numel():
            raise AssertionError(f"{name}: {flat.numel()} moment entries, not {ref_mu.numel()}")
        errs = {"loss": abs(metrics["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1.0),
                "grad_norm": abs(metrics["grad_norm"] - ref["grad_norm"])
                / max(abs(ref["grad_norm"]), 1.0),
                "mu": float(torch.linalg.vector_norm(flat - ref_mu)
                            / torch.linalg.vector_norm(ref_mu))}
        log(f"    {name}: step {seconds:.3f} s, loss {metrics['loss']:.6f}, grad norm "
            f"{metrics['grad_norm']:.6f}; errors against the one-device step " + ", ".join(
                f"{k} {v:.2e}" for k, v in errs.items()) + f"; parameter bytes a device holds "
            f"{dev_bytes}")
        bad = {k: v for k, v in errs.items() if not v <= PAR_TOL}
        if bad:
            failures.append((name, bad))
        gc.collect()
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"parallel steps off the one-device step by more than "
                             f"{PAR_TOL}: {failures}")
    par_trainer_check(torch, card, par_config(64), work)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    try:
        import attention_based_e2e_asr_dnn_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})", file=sys.stderr)
        return 1
    import numpy as np

    from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import smi_name_and_power

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_name_and_power()
    log(card)

    t_start = time.perf_counter()
    with phase("1 build"):
        environment(torch, card)
    with phase("2 lean LSTM kernels"):
        records = kernel_phase(torch, card)
    with phase("6 LSTM training kernels, H=512 and H=1024"):
        train_records = train_kernel_phase(torch, card)
        wide_records = train_kernel_phase(torch, card, WIDE_H)
    # the float32 adjoints' rows, whose main path is the float32 train step
    f32_records = {f32_adjoint_name(h): recs.pop(f32_adjoint_name(h))
                   for h, recs in ((H, train_records), (WIDE_H, wide_records))}
    with phase("12 lstm_scan_cs, bilstm_scan_fused, bilstm_apply_fused"):
        fused_records = fused_kernel_phase(torch, card)

    rng = np.random.default_rng(SEED)
    feats = [rng.standard_normal((int(n), 15)).astype(np.float32)
             for n in rng.integers(MIN_FRAMES, MAX_FRAMES + 1, N_UTTS)]
    with phase("3 + 7 speller kernels"):
        records["speller_decode"] = speller_kernel_phase(torch, card)
        train_records.update(speller_train_kernel_phase(torch, card))
        f32_records["speller_decode_bwd (float32)"] = train_records.pop(
            "speller_decode_bwd (float32)")
    with phase("26 additive attention score; chiu-las train steps"):
        additive_records = additive_score_phase(torch, card)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        exp = make_experiment(torch, os.path.join(root, "exp"))
        with phase("4 + 5 serve, parity"):
            t, launches = serve_phase(torch, card, exp, feats)
            parity_phase(torch, card, t, feats)
        with phase("13 serve over HTTP"):
            http_launches = http_phase(torch, card, exp, feats)
        data = make_test_set(os.path.join(root, "test-clean"), rng)
        with phase("14 infer CLI"):
            infer_launches = infer_phase(torch, card, exp, data, root)
        with phase("15 beam search: serve, infer CLI, parity"):
            beam_launches = beam_phase(torch, card, exp, feats, data, root)
        with phase("16 Rewriter chain: lminfer, Corrector, HTTP, kernels on their inputs"):
            rewriter_records, rewriter_launches = rewriter_phase(torch, card, exp, feats, root)
        with phase("17 Rewriter training: lmtrain CLI, resume, lminfer from its folder"):
            lm_folder, lm_corpus, lm_records, lm_launches = lmtrain_phase(torch, card, root)
        with phase("18 export and serve from artifacts"):
            export_launches = export_phase(torch, card, exp, lm_folder, feats, root)
        with phase("20 profile: the infer CLI and a serve call"):
            serve_infer_profile_phase(torch, card, t, feats, exp, data, root)
        with phase("21 tools: import_reference_ckpt, export_serving --check, serving_bench"):
            tools_phase(torch, card, exp, lm_folder, root)
        with phase("23 data parallelism: the serving split, lmtrain parallel data 1"):
            dp_serve_launches = dp_serve_phase(torch, card, t, exp, feats, root)
            dp_lmtrain_phase(torch, card, lm_corpus, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del t
    gc.collect()  # the HTTP server's reference cycles hold a model on the card
    torch.cuda.empty_cache()
    # base-LAS with every kernel tier engaged; then the earlier route
    steps = {}
    with phase("8 + 9 base-LAS train steps, parity step"):
        train_launches, steps["base-LAS"] = train_phase(torch, card, "pallas", 3)
        train_phase(torch, card, "scan", 2)
        f32_launches = {H: train_parity_phase(torch, card)}
    # scaled-LAS (H=1024, remat): train steps and the parity step, then the
    # train CLI, a resumed run and the infer CLI from the folder it wrote
    with phase("10 scaled-LAS train steps, parity step"):
        wide_launches, steps["scaled-LAS"] = train_phase(torch, card, "pallas", 3,
                                                         "scaled-LAS")
        f32_launches[WIDE_H] = train_parity_phase(torch, card, "scaled-LAS")
    with phase("19 bench: base and scaled, dense and realistic"):
        bench_phase(torch, card, steps)
    with phase("20 profile_step: base and scaled"):
        profile_step_phase(torch, card)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with phase("11 train CLI, resume, infer from its folder"):
            folder, corpus, cli_launches = train_cli_phase(torch, card, root)
            train_to_infer_phase(torch, card, folder, corpus, root)
        with phase("20 profile block: train CLI epochs at base-LAS's batch, long-form"):
            trainer_profile_phase(torch, card, root)
        with phase("21 tools: dev.extract_mini on phase 11's corpus"):
            dev_phase(card, corpus, root)
        with phase("22 recipe and chain: full_recipe_run, chain_refit, best_effort_eval"):
            recipe_phase(torch, card, root)
        with phase("23 data parallelism: DP steps on two ranks, train CLI, dp_probe"):
            dp_launches = dp_train_phase(torch, card, root)
            dp_cli_phase(torch, card, corpus, root)
            dp_probe_phase(card)
        with phase("24 drivers: fullscale_run (resident, streamed), speller_control"):
            fullscale_launches = fullscale_phase(torch, card, root)
            control_launches = speller_control_phase(torch, card)
        with phase("25 tensor, sequence and pipeline parallelism"):
            parallel_phase(torch, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[phase] all: {time.perf_counter() - t_start:.1f} s")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    # launches in the main-path runs: serving (direct, then over HTTP), then
    # infer early_stop true/false, then beam search served and through the
    # infer CLI; the training kernels in the timed steps of the train phase
    # with both kernel tiers
    for name in records:
        records[name]["launches"] = (launches.get(name, 0) + http_launches.get(name, 0)
                                     + infer_launches[name] + beam_launches.get(name, 0)
                                     + export_launches.get(name, 0))
    # the Rewriter's rows: lminfer's modes (float32), the Corrector behind a
    # Transcriber and over HTTP (bfloat16)
    for name, record in rewriter_records.items():
        record["launches"] = rewriter_launches[name]
    records.update(rewriter_records)
    # the Rewriter's training (phase 17: the lmtrain CLI's first run, its dev
    # passes included) and the corrector artifact (phase 18)
    records["lstm_scan (Rewriter H=256)"]["launches"] += (
        lm_launches["lstm_scan"] + export_launches["lstm_scan (Rewriter H=256)"])
    for name, record in lm_records.items():
        record["launches"] = lm_launches[name.split(" (")[0]]
    records.update(lm_records)
    for name, record in train_records.items():
        record["launches"] = train_launches[name]
    records.update(train_records)
    # the wide rows: the timed scaled-LAS train steps and the train CLI's run
    for name, record in wide_records.items():
        kernel = name.split(" (")[0]
        record["launches"] = wide_launches[kernel] + cli_launches[kernel]
        if wide_launches[kernel] <= 0 or cli_launches[kernel] <= 0:
            raise AssertionError(f"{name} never launched in the scaled-LAS steps or the CLI")
    records.update(wide_records)
    # the data-parallel path (phase 23): the ranks' DP steps and eval step,
    # and the serving split's blocks
    for name in DP_PATH:
        records[name]["launches"] += dp_launches[name]
    for name in ("lstm_scan_fusedin", "lstm_scan"):
        records[name]["launches"] += dp_serve_launches[name]
    # the two drivers (phase 24): fullscale_run's training and dev passes,
    # speller_control's fused tier
    for name in FULLSCALE_PATH:
        records[name]["launches"] += fullscale_launches[name]
    for name in CONTROL_PATH:
        records[name]["launches"] += control_launches[name]
    # the float32 adjoints: the float32 parity steps through the kernels (a
    # float32 train run's step), lstm_bwd_dw at H=512 and lstm_bwd at H=1024,
    # the decoder's adjoint in both
    for h in (H, WIDE_H):
        f32_records[f32_adjoint_name(h)]["launches"] = f32_launches[h][
            "lstm_bwd" if h > H else "lstm_bwd_dw"]
    f32_records["speller_decode_bwd (float32)"]["launches"] = sum(
        f32_launches[h]["speller_decode_bwd"] for h in (H, WIDE_H))
    records.update(f32_records)
    # the last two kernels: no YAML key of either package routes to them, so
    # their main path is the op itself, in the driven run at each row's shape
    records.update(fused_records)
    # the additive score's main path: phase 26's chiu-las train steps
    records.update(additive_records)
    for name in records:
        if records[name]["launches"] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
