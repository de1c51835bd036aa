"""Epoch-loop Trainer (counterpart of the JAX ``training/trainer.py``): the
train and eval steps, the host-side schedulers, evaluation, diagnostics and
checkpointing.

The model enters through two callables:

    init_fn(generator) -> parameter module (``ParamTree``)
    make_apply(dropout_scale) -> apply_fn(params, x, lx, dec_y=None,
        tf_rate=1.0, init_force=False, train=False, draws=None, generator=None)

Per epoch (reference ``train_eval``, src/train.py:261-297): the tf-rate and
dropout schedulers step, the train epoch, the attention-map PNG, the eval
epoch (free-running decode and Levenshtein distance), the metric records,
the checkpoint policy, the LD-gated ReduceLROnPlateau.

The Trainer runs on an explicit ``device`` (default ``cuda``; ``cuda`` without
a card raises). Batches reach a card through pinned host memory and a copy
on a side stream, ``prefetch_depth`` batches ahead of the step that uses
them, behind a worker thread that assembles the padded host batches.

A checkpoint is the JAX package's: the parameters as the JAX params tree,
the optimizer state as the flat leaves of the JAX package's optax state in
its order (``training/optim.py::opt_state_to_leaves``), the histories, the
schedulers' state, ``tf_rate``, ``current_lr`` and ``dropout_scale``. Either
package's ``Trainer`` resumes from the other's file.

``eval_beam_step`` (``decoding/beam.py::make_las_eval_beam_step``) takes the
dev pass's loss and beam ids from one listener pass a batch, the beam only
on the epochs that compute the LD.

``profile: {use, epoch, batches}`` traces the first ``batches`` train steps
of epoch ``epoch`` into ``<saving_dir>/profile`` (``utils/profiling.py``):
the profiler stops after the step that reaches the count, at the end of a
shorter epoch, or when a step raises; it changes no number the epoch
computes.

``dp_mesh`` (a ``parallel.mesh.DataMesh``; the JAX Trainer's 1-D ``'data'``
mesh) trains data-parallel, one process a rank (``parallel/dp.py``): the
Trainer runs on the mesh's device, its batchers assemble the rank's rows of
each global batch (``BucketBatcher.set_shard``), the train and eval steps are
``make_dp_train_step`` / ``make_dp_eval_step``, and the dev pass's ids are
gathered to every rank for the edit distance. Parameters and optimizer state
are broadcast from rank 0 at the start and at a resume. Every host-side
decision (the schedulers, the plateau LR, ``eval_ld_interval``, the
checkpoint policy) reads the all-reduced loss and the gathered LD, so it comes
out the same on every rank. Rank 0 alone writes: checkpoints, milestones, the
crash save, attention-map PNGs and the profile trace; the other ranks meet it
at a barrier after each epoch's checkpoint. Every rank prints its log lines
(the ``train`` and ``lmtrain`` CLIs send the other ranks' standard output
nowhere, ``parallel.dp.run_training``).

``shard_state`` (``lambda s: parallel.mesh.shard_train_state(s, grid)``)
and ``shard_batch`` (``parallel.mesh.shard_batch_fn(grid)``) train over a
``DeviceGrid`` of one controller, as the JAX Trainer's 2-D and 3-D meshes do:
tensor parallelism on its ``model`` axis, sequence parallelism on its
``seq`` axis, the batch's rows on its ``data`` axis (``parallel/grid.py``'s
train and eval steps; the Trainer runs on the grid's first device). The
global-norm clip sums the squares of each shard once. ``shard_batch`` alone
keeps every parameter whole on the grid's first device, as the JAX Trainer
keeps the state replicated then.

``pipeline`` (``{"cfg", "n_microbatches", "data", "model", "devices"}``)
trains the two-stage listener | speller pipeline (``parallel/pipeline.py``),
each stage over a (data, model) grid of the device list (default: the
visible cards, or the CPU); refused with ``dp_mesh``, ``init_force`` or the
dropout scheduler, as in the JAX Trainer. Its optimizer has neither a clip
nor accumulation of its own: the step clips by the global norm across the
stages and accumulates inside. The dev pass reads the parameters gathered
onto the first device (``_eval_params``).

Checkpoints are written whole in every mode, in the format above, so that
either package and the one-device Trainer resume from them; a checkpoint
whose optimizer state does not fit the live one (a pipeline's two states
against one, another optimizer) resumes the parameters with a fresh
optimizer state, with a warning.
"""

from __future__ import annotations

import collections
import os
import sys
import time
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.data.batching import ThreadedPrefetcher
from attention_based_e2e_asr_dnn_tpu_torch.models.las import las_to_jax_params
from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build
from attention_based_e2e_asr_dnn_tpu_torch.parallel.dp import (
    broadcast_state,
    gather_rows,
    make_dp_eval_step,
    make_dp_train_step,
)
from attention_based_e2e_asr_dnn_tpu_torch.parallel.grid import (
    grid_devices,
    make_grid_eval_step,
    make_grid_train_step,
)
from attention_based_e2e_asr_dnn_tpu_torch.parallel.mesh import (
    GridParams,
    gather_opt_state,
    shard_train_state,
    unshard_train_state,
)
from attention_based_e2e_asr_dnn_tpu_torch.parallel.pipeline import (
    init_pipeline_state,
    make_pipeline_train_step,
    place_pipeline_state,
)
from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import (
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)
from attention_based_e2e_asr_dnn_tpu_torch.training.optim import (
    CosineWarmupSchedule,
    DropoutScheduler,
    ReduceLROnPlateau,
    TeacherForcingScheduler,
    _tree_get,
    build_optimizer,
    opt_state_from_leaves,
    opt_state_to_leaves,
)
from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from attention_based_e2e_asr_dnn_tpu_torch.utils.levenshtein import batch_levenshtein
from attention_based_e2e_asr_dnn_tpu_torch.utils.logging import MetricLogger
from attention_based_e2e_asr_dnn_tpu_torch.utils.profiling import epoch_profiler
from attention_based_e2e_asr_dnn_tpu_torch.utils.plotting import (
    have_matplotlib,
    pay_attention_multihead,
)

class Trainer:
    def __init__(
        self,
        init_fn: Callable,
        make_apply: Callable[[float], Callable],
        trn_batcher,
        dev_batcher,
        trncfgs,
        saving_dir: str,
        milestone_dir: Optional[str] = None,
        sos_idx: int = 0,
        eos_idx: int = 29,
        compute_dtype=torch.float32,
        logger: Optional[MetricLogger] = None,
        device: str = "cuda",
        eval_beam_step: Optional[Callable] = None,
        dp_mesh=None,
        shard_batch: Optional[Callable] = None,
        shard_state: Optional[Callable] = None,
        pipeline: Optional[dict] = None,
    ):
        self.dp_mesh = dp_mesh
        self.shard_batch = shard_batch
        self.shard_state = shard_state
        self.pipeline_cfg = pipeline
        if dp_mesh is not None and pipeline is not None:
            raise ValueError("dp_mesh (data parallelism, one process a rank) and pipeline are "
                             "mutually exclusive — pipeline takes in-stage DP via parallel.data "
                             "instead")
        # the grid of shard_batch (shard_state's is known once it has placed
        # the state)
        self.grid = getattr(shard_batch, "grid", None)
        # rank 0 (or the one process) writes checkpoints, logs and plots
        self.is_writer = dp_mesh is None or dp_mesh.rank == 0
        self.device = torch.device(device if dp_mesh is None else dp_mesh.device)
        if self.grid is not None:
            self.device = self.grid.gather_device(0)
        if pipeline is not None:
            dp, tp = int(pipeline.get("data", 1) or 1), int(pipeline.get("model", 1) or 1)
            self.pipeline_devices = grid_devices(self.device, 2 * dp * tp,
                                                 pipeline.get("devices"))
            if self.pipeline_devices:
                self.device = torch.device(self.pipeline_devices[0])
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Trainer(device={device!r}): no CUDA device here; "
                               f"pass device='cpu' to train on the CPU")
        # on a card with a kernel tier configured: every kernel source built
        # side by side now, not one after another at first launch
        model_cfgs = getattr(getattr(trncfgs, "model", None), "configs", None) or {}
        cuda_build.build_for(
            self.device, (model_cfgs.get("listener_configs") or {}).get("lstm_impl"),
            (model_cfgs.get("speller_configs") or {}).get("decoder_impl"),
            model_cfgs.get("lstm_impl"), model_cfgs.get("decoder_impl"))  # the Rewriter's
        self.trncfgs = trncfgs
        self.trn_batcher = trn_batcher
        self.dev_batcher = dev_batcher
        self.saving_dir = saving_dir
        self.sos_idx = sos_idx
        self.eos_idx = eos_idx
        self.compute_dtype = compute_dtype
        self.logger = logger or MetricLogger()
        self.make_apply = make_apply
        self.eval_beam_step = eval_beam_step

        # Feature wire format: where the step computes in bf16 anyway,
        # ``feed_dtype: auto`` casts the features on the host, which halves
        # the bytes copied to the card and equals the step's own cast.
        feed = str(getattr(trncfgs, "feed_dtype", "auto"))
        if feed == "auto":
            self.feed_dtype = torch.bfloat16 if compute_dtype == torch.bfloat16 else None
        elif feed in ("float32", "fp32"):
            self.feed_dtype = None
        elif feed in ("bfloat16", "bf16"):
            self.feed_dtype = torch.bfloat16
        else:
            raise ValueError(f"feed_dtype {feed!r}: expected auto, float32 "
                             f"or bfloat16")

        self.accu_grad = int(getattr(trncfgs, "accu_grad", 1))
        self.grad_norm = float(getattr(trncfgs, "grad_norm", 5.0))
        self.init_force_cfg = bool(getattr(trncfgs, "init_force", False))
        self.use_specaug = bool(getattr(trncfgs, "use_specaug", False))
        self.tf_rate = float(getattr(trncfgs, "tf_rate", 1.0))
        if pipeline is not None:
            if self.init_force_cfg:
                raise ValueError("pipeline parallelism does not support init_force (disable "
                                 "one of them)")
            if getattr(trncfgs, "dropout_scheduler", None) and trncfgs.dropout_scheduler.use:
                raise ValueError("pipeline parallelism does not support the dropout scheduler "
                                 "(stage programs use the static model config)")
        self.base_lr = float(trncfgs.optimizer.configs["lr"])
        self.current_lr = self.base_lr
        # the pipeline clips by the global norm across its stages and
        # accumulates inside its step: its optimizer does neither
        self.tx = build_optimizer(trncfgs.optimizer.name, trncfgs.optimizer.configs,
                                  grad_norm=1e30 if pipeline is not None else self.grad_norm,
                                  accum_steps=1 if pipeline is not None else self.accu_grad)

        # schedulers (src/train.py:79-101, 448-474)
        self.batch_scheduler = None
        if getattr(trncfgs, "batch_scheduler", None) and trncfgs.batch_scheduler.use:
            # sized by updates, not batches, so that warm-up and annealing
            # end as configured under gradient accumulation (the JAX
            # package's deviation from the reference)
            self.batch_scheduler = CosineWarmupSchedule(
                num_batches=max(1, len(trn_batcher) // self.accu_grad),
                init_lr=self.base_lr,
                max_epochs=int(getattr(trncfgs, "epochs", 10)),
                **{k: v for k, v in trncfgs.batch_scheduler.configs.items()
                   if k in ("warmup_epochs", "min_lr")},
            )
        self.epoch_scheduler = None
        if getattr(trncfgs, "epoch_scheduler", None) and trncfgs.epoch_scheduler.use:
            self.epoch_scheduler = ReduceLROnPlateau(self.base_lr)
        self.tf_scheduler = None
        if getattr(trncfgs, "tf_rate_scheduler", None) and trncfgs.tf_rate_scheduler.use:
            self.tf_scheduler = TeacherForcingScheduler(
                self.tf_rate, **trncfgs.tf_rate_scheduler.configs)
        self.dropout_scheduler = None
        if getattr(trncfgs, "dropout_scheduler", None) and trncfgs.dropout_scheduler.use:
            self.dropout_scheduler = DropoutScheduler(trncfgs.dropout_scheduler.configs)
        self.dropout_scale = 1.0

        # state: the parameters from ``seed``, the step's noise from ``seed + 1``
        seed = int(getattr(trncfgs, "seed", 0))
        params = init_fn(torch.Generator().manual_seed(seed))
        if pipeline is not None:
            if set(dict(params.named_children())) != {"listener", "speller"}:
                raise ValueError("pipeline parallelism expects a listener|speller model, got "
                                 f"param groups {sorted(dict(params.named_children()))}")
            self.state = init_pipeline_state(
                params, self.tx, seed + 1, self.pipeline_devices,
                dp=int(pipeline.get("data", 1) or 1), tp=int(pipeline.get("model", 1) or 1))
        else:
            self.state = self._placed(create_train_state(params, self.tx, seed=seed + 1,
                                                         device=self.device))
        self.epoch = 0
        self.batch = 0
        self.train_history = {"loss": [], "ppl": []}
        self.dev_history = {"loss": [], "ppl": [], "ld": []}
        # host seconds of each epoch (train + eval + checkpointing), each
        # ending after the device has finished; train_seconds covers the
        # gradient-step loop with its input pipeline, eval_seconds the
        # free-running dev decode with the host's Levenshtein pass
        self.epoch_seconds: list = []
        self.train_seconds: list = []
        self.eval_seconds: list = []

        # device_resident_data: every batch is assembled and copied to the
        # device once, and later epochs train from there. The batches'
        # composition freezes at the epoch-0 plan; their order still
        # reshuffles every epoch. The dev plan never depends on the epoch.
        self.device_resident = bool(getattr(trncfgs, "device_resident_data", False))
        self._resident_train: Optional[list] = None
        self._resident_dev: Optional[list] = None
        self._warned_no_plots = False

        self.ckpt = CheckpointManager(
            os.path.join(saving_dir, "ckpts"), milestone_dir,
            max_savings=int(getattr(trncfgs, "max_savings", 3)), write=self.is_writer)
        if dp_mesh is not None:
            for batcher in (trn_batcher, dev_batcher):
                batcher.set_shard(dp_mesh.rank, dp_mesh.size)
            broadcast_state(self.state, dp_mesh)

        self._build_steps()

        # resume (src/train.py:96-101, 372-391)
        finetune = getattr(trncfgs, "finetune", None)
        if finetune is not None and finetune.use:
            self.load(finetune.checkpoint)
            self.ckpt.reset_best()
            if getattr(finetune, "reinit_lr", False):
                self.current_lr = self.base_lr

    def _placed(self, state):
        """A one-device state placed as this Trainer trains: by
        ``shard_state``, on ``shard_batch``'s grid (every parameter whole),
        or as it is."""
        if self.shard_state is not None:
            state = self.shard_state(state)
        elif self.grid is not None:
            state = shard_train_state(state, self.grid, model_axis=None)
        if isinstance(state.params, GridParams):
            self.grid = state.params.grid
            self.device = self.grid.gather_device(0)
        return state

    # ------------------------------------------------------------------
    def _build_steps(self) -> None:
        apply_fn = self.make_apply(self.dropout_scale)
        specaug = dict(use_specaug=self.use_specaug,
                       specaug_freq=int(getattr(self.trncfgs, "specaug_freq", 6)),
                       specaug_time=int(getattr(self.trncfgs, "specaug_time", 200)),
                       specaug_iid=bool(getattr(self.trncfgs, "specaug_iid", False)))
        if self.pipeline_cfg is not None:
            pipe = self.pipeline_cfg
            pipe_step = make_pipeline_train_step(
                pipe["cfg"], self.tx, self.pipeline_devices,
                n_microbatches=int(pipe.get("n_microbatches", 2)),
                compute_dtype=self.compute_dtype, grad_norm=self.grad_norm,
                accum_steps=self.accu_grad, dp=int(pipe.get("data", 1) or 1),
                tp=int(pipe.get("model", 1) or 1), **specaug)

            def train_step(state, x, lx, y, ly, tf_rate, lr, init_force=False):
                del init_force  # refused at construction
                state, metrics = pipe_step(state, x, lx, y, ly, tf_rate, lr)
                return state, metrics, None

            self.train_step = train_step
            self.eval_step = make_eval_step(apply_fn, compute_dtype=self.compute_dtype)
            return
        if self.grid is not None:
            self.train_step = make_grid_train_step(
                apply_fn, self.tx, self.grid, accum_steps=self.accu_grad,
                compute_dtype=self.compute_dtype, **specaug)
            self.eval_step = make_grid_eval_step(apply_fn, self.grid,
                                                 compute_dtype=self.compute_dtype)
            return
        if self.dp_mesh is not None:
            self.train_step = make_dp_train_step(
                apply_fn, self.tx, self.dp_mesh, accum_steps=self.accu_grad,
                compute_dtype=self.compute_dtype, **specaug)
            self.eval_step = make_dp_eval_step(apply_fn, self.dp_mesh,
                                               compute_dtype=self.compute_dtype)
            return
        self.train_step = make_train_step(
            apply_fn, self.tx, accum_steps=self.accu_grad,
            compute_dtype=self.compute_dtype, **specaug)
        self.eval_step = make_eval_step(apply_fn, compute_dtype=self.compute_dtype)

    # ------------------------------------------------------------------
    def _host_batch(self, bt):
        """Host batch -> (host tensors (x, lx, y, ly), y, ly, indices): <sos>
        stripped (src/train.py:117), ``ly`` zero on repeat-padded rows so that
        they carry no loss, float features in the wire dtype (integer inputs,
        the Rewriter's ids, pass through). Under ``dp_mesh`` the tensors hold
        the rank's rows, and ``y``, ``ly``, ``indices`` stay the global
        batch's."""
        y, ly = bt.y[:, 1:], np.maximum(bt.ly - 1, 0)
        ly = np.where(bt.indices >= 0, ly, 0)
        rows = slice(None) if bt.rows is None else bt.rows
        x = torch.from_numpy(np.ascontiguousarray(bt.x))
        if self.feed_dtype is not None and x.is_floating_point():
            x = x.to(self.feed_dtype)
        host = (x, torch.from_numpy(bt.lx.astype(np.int32)),
                torch.from_numpy(np.ascontiguousarray(y[rows].astype(np.int32))),
                torch.from_numpy(ly[rows].astype(np.int32)))
        return host, y, ly, bt.indices

    def _on_device(self, tensors) -> tuple:
        """The batch's tensors on the Trainer's device, through
        ``shard_batch`` where given (which refuses rows the grid cannot
        split)."""
        dev = tuple(t.to(self.device) for t in tensors)
        return dev if self.shard_batch is None else tuple(self.shard_batch(dev))

    def _convert_batch(self, bt):
        """Host batch -> (device tuple, y, ly, indices), copied in line."""
        host, y, ly, indices = self._host_batch(bt)
        return self._on_device(host), y, ly, indices

    def _prepared_batches(self, batch_iter, on_span=None):
        """Two stages ahead of the step. Stage 1: a worker thread assembles
        padded host batches (``ThreadedPrefetcher``, each batch's span to
        ``on_span`` where given). Stage 2, on a card: each batch goes
        through pinned memory and is copied on a side stream,
        ``prefetch_depth`` batches ahead; the step's stream waits for the
        copy's event, not the host. ``prefetch_depth: 0`` does both in line."""
        depth = int(getattr(self.trncfgs, "prefetch_depth", 2))
        if depth <= 0:
            for bt in batch_iter:
                yield self._convert_batch(bt)
            return
        host_pf = ThreadedPrefetcher(batch_iter, depth=depth, on_span=on_span)
        try:
            if self.device.type != "cuda":
                for bt in host_pf:
                    yield self._convert_batch(bt)
                return
            side = torch.cuda.Stream(self.device)
            in_flight: collections.deque = collections.deque()

            def start(bt):
                host, y, ly, indices = self._host_batch(bt)
                with torch.cuda.stream(side):
                    dev = tuple(t.pin_memory().to(self.device, non_blocking=True)
                                for t in host)
                    done = torch.cuda.Event()
                    done.record(side)
                in_flight.append((dev, done, y, ly, indices))

            def finish():
                dev, done, y, ly, indices = in_flight.popleft()
                current = torch.cuda.current_stream(self.device)
                current.wait_event(done)
                for t in dev:
                    t.record_stream(current)
                return self._on_device(dev), y, ly, indices

            for bt in host_pf:
                start(bt)
                if len(in_flight) > depth:
                    yield finish()
            while in_flight:
                yield finish()
        finally:
            # stop the worker if the consumer left early (a crash save, a
            # KeyboardInterrupt, a test that breaks out of the loop)
            host_pf.close()

    def _resident_batches(self, which: str, epoch: int):
        """The device-resident feed: the epoch-0 plan copied to the device
        once, then read from there (train: a fresh order every epoch)."""
        cache = self._resident_train if which == "train" else self._resident_dev
        if cache is None:
            batcher = self.trn_batcher if which == "train" else self.dev_batcher
            cache = list(self._prepared_batches(batcher.epoch(0)))
            nbytes = sum(t.numel() * t.element_size() for item in cache for t in item[0])
            self.logger.print(f"[data] {which} corpus device-resident: {len(cache)} "
                              f"batches, {nbytes / 2**20:.0f} MiB on {self.device}")
            if which == "train":
                self._resident_train = cache
            else:
                self._resident_dev = cache
        if which == "train" and getattr(self.trn_batcher, "shuffle", False):
            rng = np.random.default_rng(int(getattr(self.trn_batcher, "seed", 0)) + epoch)
            order = rng.permutation(len(cache))
        else:
            order = range(len(cache))
        for i in order:
            yield cache[i]

    def _progress(self, iterable, desc: str):
        """tqdm batch bar when on a tty (reference: src/train.py:110)."""
        try:
            if sys.stderr.isatty():
                from tqdm import tqdm

                return tqdm(iterable, total=len(self.trn_batcher), desc=desc,
                            dynamic_ncols=True, leave=False)
        except ImportError:
            pass
        return iterable

    def train_epoch(self):
        # The metrics stay on the device during the epoch: a float() a batch
        # would make the host wait for every step. The device scalars are
        # folded and read only every ``metric_sync_every`` batches, which
        # also bounds the work queued ahead.
        loss_parts: list = []
        ppl_parts: list = []
        n_batches = 0
        att_map = None
        sync_every = int(getattr(self.trncfgs, "metric_sync_every", 16))
        init_force = self.init_force_cfg and self.epoch < 10  # src/train.py:113
        profiler = (epoch_profiler(getattr(self.trncfgs, "profile", None), self.epoch,
                                   self.saving_dir, self.device)
                    if self.is_writer else None)
        try:
            batch_src = (self._resident_batches("train", self.epoch) if self.device_resident
                         else self._prepared_batches(
                             self.trn_batcher.epoch(self.epoch),
                             on_span=None if profiler is None else profiler.host_span))
            for batch, _, _, _ in self._progress(batch_src, f"train epoch[{self.epoch}]"):
                self.state, metrics, att_map = self.train_step(
                    self.state, *batch, self.tf_rate, self.current_lr, init_force=init_force)
                loss_parts.append(metrics["loss"])
                ppl_parts.append(metrics["ppl"])
                n_batches += 1
                self.batch += 1
                if sync_every > 0 and n_batches % sync_every == 0:
                    loss_parts = [torch.stack(loss_parts).sum()]
                    ppl_parts = [torch.stack(ppl_parts).sum()]
                    float(loss_parts[0])  # bounded in-flight work
                # the per-update LR schedule, on accumulation boundaries (src/train.py:185-188)
                if self.batch_scheduler and self.batch % self.accu_grad == 0:
                    self.current_lr = self.batch_scheduler.step()
                    self.logger.log({"learning-rate": self.current_lr})
                if profiler is not None and n_batches >= profiler.batches:
                    self._end_profile(profiler)
                    profiler = None
            if profiler is not None:  # fewer batches than profile.batches
                self._end_profile(profiler)
                profiler = None
        finally:
            if profiler is not None:  # a step raised: stop, write nothing
                profiler.stop(export=False)
        total_loss = float(torch.stack(loss_parts).sum()) if loss_parts else 0.0
        total_ppl = float(torch.stack(ppl_parts).sum()) if ppl_parts else 0.0
        return total_loss / max(n_batches, 1), total_ppl / max(n_batches, 1), att_map

    def _end_profile(self, profiler) -> None:
        profiler.stop()
        self.logger.print(f"[profile] trace written to {self.saving_dir}/profile")

    def evaluate_epoch(self, compute_ld: bool = True):
        """Free-running dev eval. ``compute_ld=False`` skips the host's
        Levenshtein pass (``eval_ld_interval``) and repeats the last LD."""
        total_loss = total_ppl = total_ld = 0.0
        n_batches = 0
        eval_params = self._eval_params()
        beam_params = None
        if self.eval_beam_step is not None:
            beam_params = (eval_params.whole_module() if isinstance(eval_params, GridParams)
                           else eval_params)
        eval_src = (self._resident_batches("dev", 0) if self.device_resident
                    else self._prepared_batches(self.dev_batcher.epoch(0)))
        for batch, y, ly, indices in eval_src:
            if self.eval_beam_step is not None:
                # one listener pass for the loss and the beam; no beam on an
                # epoch without the LD
                metrics, pred_ids = self.eval_beam_step(beam_params, *batch,
                                                        want_ids=compute_ld)
            else:
                metrics, pred_ids = self.eval_step(eval_params, *batch)
                if self.dp_mesh is not None and compute_ld:
                    pred_ids = gather_rows(self.dp_mesh, pred_ids)
            total_loss += float(metrics["loss"])
            total_ppl += float(metrics["ppl"])
            if compute_ld:
                if torch.is_tensor(pred_ids):
                    pred_ids = pred_ids.cpu().numpy()
                real = indices >= 0
                total_ld += batch_levenshtein(pred_ids[real], y[real],
                                              ly[real], self.sos_idx, self.eos_idx)
            n_batches += 1
        n = max(n_batches, 1)
        if not compute_ld:
            last = self.dev_history["ld"][-1] if self.dev_history["ld"] else 0.0
            return total_loss / n, total_ppl / n, last
        return total_loss / n, total_ppl / n, total_ld / n

    # ------------------------------------------------------------------
    def train_eval(self, epochs: int):
        """The whole loop, with a crash save: on any exception the state goes
        to ``ckpts/emergency-epoch[N].ckpt`` before the exception is raised
        again."""
        try:
            self._train_eval_loop(epochs)
        except (KeyboardInterrupt, Exception):
            if not self.is_writer:
                raise
            path = os.path.join(self.saving_dir, "ckpts",
                                f"emergency-epoch[{self.epoch}].ckpt")
            try:
                self.save(path)
                self.logger.print(f"[crash-save] state written to {path}")
            except Exception as save_exc:  # pragma: no cover
                self.logger.print(f"[crash-save] FAILED: {save_exc}")
            raise

    def _plot(self, att_map) -> None:
        if att_map is None or not self.is_writer:
            return
        if not have_matplotlib():
            if not self._warned_no_plots:
                self._warned_no_plots = True
                self.logger.print("[plot] matplotlib is not installed: attention "
                                  "maps are skipped")
            return
        pay_attention_multihead(att_map.float().cpu().numpy(), epoch=self.epoch,
                                root_dir=os.path.join(self.saving_dir, "imgs"))

    def _train_eval_loop(self, epochs: int):
        while self.epoch < epochs:
            t0 = time.time()
            if self.tf_scheduler:
                self.tf_rate = self.tf_scheduler.step(self.epoch, self.dev_history["ld"])
            if self.dropout_scheduler:
                ratio = self.dropout_scheduler.step(self.epoch)
                if ratio != 1.0:
                    self.dropout_scale *= ratio
                    self.logger.print(
                        f"[epoch {self.epoch}] dropout rates scaled by {ratio}")
                    self._build_steps()

            t_train0 = time.time()
            trn_loss, trn_ppl, att_map = self.train_epoch()
            self.train_seconds.append(time.time() - t_train0)
            self._plot(att_map)
            self.train_history["loss"].append(trn_loss)
            self.train_history["ppl"].append(trn_ppl)

            ld_interval = int(getattr(self.trncfgs, "eval_ld_interval", 1) or 1)
            compute_ld = (ld_interval <= 1 or self.epoch % ld_interval == 0
                          or not self.dev_history["ld"])
            t_eval0 = time.time()
            dev_loss, dev_ppl, dev_ld = self.evaluate_epoch(compute_ld)
            self.eval_seconds.append(time.time() - t_eval0)
            if dev_ld <= 0 and self.dev_history["ld"]:
                dev_ld = self.dev_history["ld"][-1]  # src/train.py:283-285
            self.dev_history["loss"].append(dev_loss)
            self.dev_history["ppl"].append(dev_ppl)
            self.dev_history["ld"].append(dev_ld)

            dt = time.time() - t0
            self.epoch_seconds.append(dt)
            self.logger.print(
                f"[epoch {self.epoch}] trn loss {trn_loss:.4f} ppl {trn_ppl:.3f} | "
                f"dev loss {dev_loss:.4f} ppl {dev_ppl:.3f} ld {dev_ld:.3f} | "
                f"tf {self.tf_rate:.2f} lr {self.current_lr:.2e} | "
                f"{dt:.1f}s (trn {self.train_seconds[-1]:.1f} "
                f"dev {self.eval_seconds[-1]:.1f})")
            self.logger.log({
                "avg_trn_loss": trn_loss, "avg_trn_ppl": trn_ppl,
                "dev_loss": dev_loss, "dev_ppl": dev_ppl, "dev_ld": dev_ld,
            })

            self.ckpt.maybe_save(self.epoch, dev_loss, dev_ld, dev_ppl,
                                 lambda: self._payload(dev_loss, dev_ld, dev_ppl))
            self._barrier()
            self.epoch += 1
            # LD-gated plateau LR (src/train.py:294-297)
            if self.epoch_scheduler and self.dev_history["ld"][-1] <= 20:
                self.current_lr = self.epoch_scheduler.step(dev_ld)
                self.logger.log({"learning-rate": self.current_lr})

    def _eval_params(self):
        """What the dev pass reads: the pipeline's stages gathered onto the
        first device (moved device to device); else the state's parameters
        (``GridParams`` over a grid, read by the grid's eval step)."""
        if self.pipeline_cfg is not None:
            return self.state.whole_params(self.device)
        return self.state.params

    def whole_params(self) -> torch.nn.Module:
        """The parameters as one module on the Trainer's device: the state's
        own, or in a grid or pipeline run a gathered copy."""
        if self.pipeline_cfg is not None:
            return self.state.whole_params(self.device)
        if isinstance(self.state.params, GridParams):
            return self.state.params.whole_module()
        return self.state.params

    def _whole(self):
        """(parameter module, its optimizer leaves as a checkpoint stores
        them): the state gathered whole in every mode."""
        if self.pipeline_cfg is not None:
            st = self.state
            module = self.whole_params()
            leaves = []
            for name, gp, opt in (("listener", st.params_listener, st.opt_listener),
                                  ("speller", st.params_speller, st.opt_speller)):
                leaves += opt_state_to_leaves(module[name], gather_opt_state(gp, opt, self.device),
                                              self.current_lr)
            return module, leaves
        state = self.state
        if isinstance(state.params, GridParams):
            state = unshard_train_state(state)
        return state.params, opt_state_to_leaves(state.params, state.opt_state,
                                                 self.current_lr)

    # ------------------------------------------------------------------
    def _payload(self, dev_loss: float, dev_ld: float, dev_ppl: float) -> dict:
        module, opt_leaves = self._whole()
        return {
            "epoch": self.epoch,
            "batch": self.batch,
            "loss": dev_loss,
            "ld": dev_ld,
            "ppl": dev_ppl,
            "params": las_to_jax_params(module),
            "opt_state": opt_leaves,
            "train_loss": list(self.train_history["loss"]),
            "train_ppl": list(self.train_history["ppl"]),
            "dev_loss": list(self.dev_history["loss"]),
            "dev_ppl": list(self.dev_history["ppl"]),
            "dev_ld": list(self.dev_history["ld"]),
            "tf_rate": self.tf_rate,
            "current_lr": self.current_lr,
            "dropout_scale": self.dropout_scale,
            # the schedulers' state: without it a resumed run would reset the
            # plateau's patience, the tf scheduler's last turn and the cosine
            # step count, and leave the uninterrupted run's trajectory
            "schedulers": {
                "batch": self.batch_scheduler.state_dict()
                if self.batch_scheduler else None,
                "epoch": self.epoch_scheduler.state_dict()
                if self.epoch_scheduler else None,
                "tf": self.tf_scheduler.state_dict()
                if self.tf_scheduler else None,
            },
        }

    def _barrier(self) -> None:
        """Under ``dp_mesh``: every rank waits here for rank 0's writes."""
        if self.dp_mesh is not None:
            torch.distributed.barrier(group=self.dp_mesh.group)

    def save(self, path: str) -> str:
        """Write the state to ``path`` (rank 0 only under ``dp_mesh``)."""
        if not self.is_writer:
            return path
        return save_checkpoint(path, self._payload(
            self.dev_history["loss"][-1] if self.dev_history["loss"] else float("inf"),
            self.dev_history["ld"][-1] if self.dev_history["ld"] else float("inf"),
            self.dev_history["ppl"][-1] if self.dev_history["ppl"] else float("inf"),
        ))

    def load(self, path: str) -> None:
        """Resume from a checkpoint of either package, or from a reference
        ``.pt`` (parameters only; reference load_model, src/train.py:372-391)."""
        loaded = load_checkpoint(path)
        # the state whole on one device, loaded, then placed again
        pipe = self.pipeline_cfg is not None
        grid = not pipe and isinstance(self.state.params, GridParams)
        if pipe:
            st = self.state
            whole = SimpleNamespace(params=st.whole_params(self.device), opt=[
                gather_opt_state(gp, opt, self.device)
                for gp, opt in ((st.params_listener, st.opt_listener),
                                (st.params_speller, st.opt_speller))])
        else:
            state = unshard_train_state(self.state) if grid else self.state
            whole = SimpleNamespace(params=state.params, opt=[state.opt_state])
        with torch.no_grad():
            for name, param in whole.params.named_parameters():
                leaf = np.asarray(_tree_get(loaded["params"], name), dtype=np.float32)
                if leaf.shape != tuple(param.shape):
                    raise ValueError(f"{path}: parameter {name} is {leaf.shape}, the "
                                     f"model's is {tuple(param.shape)}")
                param.copy_(torch.from_numpy(leaf))
        if loaded.get("opt_state") is not None:
            try:
                whole.opt = self._opt_from_leaves(whole, loaded["opt_state"], pipe)
            except ValueError as exc:
                self.logger.print(
                    f"WARNING: {exc}; resuming the parameters only, with a fresh "
                    f"optimizer state.")
        if pipe:
            pipe_cfg = self.pipeline_cfg
            self.state = place_pipeline_state(
                whole.params, self.tx, self.state.generator, self.pipeline_devices,
                dp=int(pipe_cfg.get("data", 1) or 1), tp=int(pipe_cfg.get("model", 1) or 1),
                opt_listener=whole.opt[0], opt_speller=whole.opt[1])
            self.state.step = int(self.state.opt_listener.count)
        else:
            state.opt_state = whole.opt[0]
            self.state = self._placed(state) if grid else state
            self.state.step = int(self.state.opt_state.count)
        # params-only payloads (reference .pt imports) carry no counters
        self.epoch = loaded.get("epoch", self.epoch)
        self.batch = loaded.get("batch", self.batch)
        self.train_history["loss"] = list(loaded.get("train_loss", []))
        self.train_history["ppl"] = list(loaded.get("train_ppl", []))
        self.dev_history["loss"] = list(loaded.get("dev_loss", []))
        self.dev_history["ppl"] = list(loaded.get("dev_ppl", []))
        self.dev_history["ld"] = list(loaded.get("dev_ld", []))
        if "tf_rate" in loaded:
            self.tf_rate = loaded["tf_rate"]
        if "current_lr" in loaded:
            self.current_lr = loaded["current_lr"]
        if loaded.get("dropout_scale", 1.0) != self.dropout_scale:
            self.dropout_scale = loaded["dropout_scale"]
            self._build_steps()
        sched = loaded.get("schedulers") or {}
        if self.batch_scheduler and sched.get("batch"):
            self.batch_scheduler.load_state_dict(sched["batch"])
        if self.epoch_scheduler and sched.get("epoch"):
            self.epoch_scheduler.load_state_dict(sched["epoch"])
        if self.tf_scheduler and sched.get("tf"):
            self.tf_scheduler.load_state_dict(sched["tf"])
        if self.dp_mesh is not None:
            broadcast_state(self.state, self.dp_mesh)
        self.logger.print(f"resumed from [{path}] at epoch[{self.epoch}]")

    @staticmethod
    def _opt_from_leaves(whole, leaves: list, pipe: bool) -> list:
        """A checkpoint's optimizer leaves -> the whole state(s) shaped like
        ``whole.opt``: one, or the pipeline's listener and speller states, the
        listener's leaves first (the JAX tree's key order). Raises
        ``ValueError`` where they do not fit."""
        if not pipe:
            return [opt_state_from_leaves(whole.params, leaves, whole.opt[0])]
        n_l = len(opt_state_to_leaves(whole.params["listener"], whole.opt[0], 0.0))
        n_s = len(opt_state_to_leaves(whole.params["speller"], whole.opt[1], 0.0))
        if len(leaves) != n_l + n_s:
            raise ValueError(f"checkpoint has {len(leaves)} optimizer leaves, the live "
                             f"pipeline state has {n_l + n_s}")
        return [opt_state_from_leaves(whole.params["listener"], leaves[:n_l], whole.opt[0]),
                opt_state_from_leaves(whole.params["speller"], leaves[n_l:], whole.opt[1])]
