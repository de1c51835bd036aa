"""Serving API: load a trained experiment, transcribe feature batches
(counterpart of the JAX ``serving.py``): greedy or beam decoding, and the
gated Rewriter corrector.

    >>> t = Transcriber("experiments/260816-123456", device="cuda")
    >>> t.transcribe([mfcc1, mfcc2, ...])   # list of (T_i, 15) arrays
    ['A DOG RAN', ...]

The experiment's ``config.json`` snapshot rebuilds the model and the
checkpoint loads from the data-only format. Requests are length-sorted into
padded batches of ``batch_size`` rows (the last one repeat-padded), each
padded in time to a multiple of ``pad_time_multiple``, and the original
order is restored.

Warm-up. The JAX ``Transcriber`` compiles one program a (batch, time bucket)
shape, so it warms a ladder of buckets, counts a bucket as warm once its
program exists, and routes a request up to a warm bucket instead of stalling
on a compile. PyTorch runs eagerly and compiles no shape anew, so here "warm"
means that the kernels' libraries are built and bound (``build_all``, the one
cost of a cold start on the card: about a minute of ``nvcc``) and that one
batch of the bucket has run (allocator cache, cuBLAS handles). The interface
is the JAX one: ``auto_warmup`` starts the ladder on a background thread,
largest bucket first; ``wait_ready`` blocks until the largest is warm and
re-raises a failed warm-up; ``wait_warm`` joins the thread; the background
ladder yields to requests in flight. ``_route_bucket`` always returns the
tight bucket: no bucket is cheaper to enter than another, so padding a batch
up to a warm one would only add work.

``Corrector`` wraps a Rewriter experiment as ``lminfer`` runs it, with the
experiment's ``compute_dtype`` (as the JAX ``Corrector`` does); a
``Transcriber`` given one passes every transcript through it, so the
``StreamingTranscriber`` and the HTTP server return corrected text too.

``data_parallel=n`` decodes each batch split over the first n cards
(``parallel/split.py``): the parameters are copied to each, a batch of
``batch_size`` rows (divisible by n) is cut into n row blocks, each decoded
on its card on a stream of its own, and the ids are put back in order. Beam
search, the corrector and the ``StreamingTranscriber`` go through it
unchanged.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch import constants
from attention_based_e2e_asr_dnn_tpu_torch.utils.levenshtein import ids_to_str
from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher, pad_to_multiple
from attention_based_e2e_asr_dnn_tpu_torch.decoding.beam import make_las_beam_step
from attention_based_e2e_asr_dnn_tpu_torch.decoding.greedy import make_las_greedy_step
from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    las_config_from_dicts,
    las_from_jax_params,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build
from attention_based_e2e_asr_dnn_tpu_torch.ops.precision import compute_dtype
from attention_based_e2e_asr_dnn_tpu_torch.parallel import split
from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import (
    average_checkpoints,
    list_best_checkpoints,
    load_checkpoint,
)


def _epoch_of(filename: str) -> int:
    """Epoch number of a 'min-...-epoch[N].ckpt' tag (-1 if untagged)."""
    m = re.search(r"epoch\[(\d+)\]", filename)
    return int(m.group(1)) if m else -1


def _best_checkpoint(ckpt_dir: str) -> str:
    """Highest-epoch best-tag checkpoint (epochs compared as numbers)."""
    cands = sorted(list_best_checkpoints(ckpt_dir), key=_epoch_of)
    if not cands:
        raise FileNotFoundError(f"no min-* checkpoints in {ckpt_dir}")
    return os.path.join(ckpt_dir, cands[-1])


def load_experiment(exp_folder: str, checkpoint: Optional[str] = None,
                    average: bool = False):
    """(config snapshot dict, checkpoint payload) of a trained experiment:
    the named checkpoint, the uniform average of all best ones, or the
    latest best one. A reference experiment's snapshot carries no vocab;
    the fixed constants table fills it in."""
    with open(os.path.join(exp_folder, "config.json")) as fh:
        snap = json.load(fh)
    snap.setdefault("VOCAB", list(constants.VOCAB))
    snap.setdefault("SOS_IDX", constants.SOS_IDX)
    snap.setdefault("EOS_IDX", constants.EOS_IDX)
    ckpt_dir = os.path.join(exp_folder, "ckpts")
    if average:
        payload = average_checkpoints([os.path.join(ckpt_dir, f)
                                       for f in list_best_checkpoints(ckpt_dir)])
    else:
        payload = load_checkpoint(checkpoint or _best_checkpoint(ckpt_dir))
    return snap, payload


class Corrector:
    """The gated Rewriter corrector over a trained LM experiment, the serving
    twin of the ``lminfer`` CLI.

    ``correct(texts)`` rewrites each transcript and keeps a rewrite only
    where the model scores it ``confidence_margin`` average log-probability
    a character above regenerating the input (``decoding/rescore.py``):
    never worse under the model's own likelihood. Fit the margin offline
    (``lminfer`` with ``confidence_margin: "auto"``) and pass the number.
    ``span_rewrite=True`` deploys the prefix-anchored candidates, scored in
    one stacked call with ``decoding.rescore.span_candidate_families``, the
    machinery ``lminfer`` calibrates with; pass the fitted ``span_family``.

    Args:
        exp_folder: Rewriter experiment (config.json + ckpts/).
        checkpoint: explicit checkpoint; default = latest best tag.
        average: uniform-average all best checkpoints instead.
        beam_size: > 1 = beam-search rewrites; 0/1 = early-stop greedy.
        confidence_margin: the gate's threshold; ``gate=False`` keeps every
            rewrite.
        span_rewrite: widen the candidates with prefix-anchored rewrites
            (requires ``gate=True``).
        span_family: the family the gate thresholds: ``"free"``, ``"conf"``,
            ``"best"`` or an ``"fNN"`` fraction anchor of ``span_fracs``.
        device: where the model runs ("cuda", "cuda:1", "cpu").
    """

    def __init__(
        self,
        exp_folder: str,
        checkpoint: Optional[str] = None,
        average: bool = False,
        beam_size: int = 8,
        length_alpha: float = 0.0,
        max_len_factor: float = 3.0,
        batch_size: int = 32,
        confidence_margin: float = 0.0,
        gate: bool = True,
        span_rewrite: bool = False,
        span_family: str = "best",
        span_conf_tau: float = 0.5,
        span_fracs: Sequence[float] = (0.25, 0.5, 0.75, 0.9),
        device: str = "cuda",
    ):
        from attention_based_e2e_asr_dnn_tpu_torch.decoding.rescore import RewriteChain
        from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import (
            RewriterConfig,
            rewriter_from_jax_params,
        )

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Corrector(device={device!r}): no CUDA device here; "
                               f"pass device='cpu' to correct on the CPU")
        if span_rewrite and not gate:
            raise ValueError("span_rewrite requires gate=True (candidate "
                             "selection uses the gate's scorer)")
        snap, payload = load_experiment(exp_folder, checkpoint, average)
        self.lm_cfg = RewriterConfig(**snap["model"]["configs"])
        # the experiment's bfloat16 policy, as the Transcriber honours it
        self.compute_dtype = compute_dtype(snap.get("compute_dtype", "float32"))
        self.batch_size = batch_size
        self.margin = float(confidence_margin)
        # the widest layout a rewrite can need, [SOS] + CHR_MAX_STEPS + [EOS]
        # rounded up to 32 (the JAX Corrector's score width)
        self.chain = RewriteChain(
            self.lm_cfg, self.compute_dtype, beam_size=beam_size, length_alpha=length_alpha,
            max_len_factor=max_len_factor, gate=gate, span_rewrite=span_rewrite,
            span_conf_tau=span_conf_tau, span_fracs=span_fracs,
            score_width=-(-(int(self.lm_cfg.CHR_MAX_STEPS) + 2) // 32) * 32)
        self.family = "rewrite"
        if span_rewrite:
            self.chain.check_family(span_family, " (fit it with lminfer confidence_margin: auto)")
            self.family = span_family
        cuda_build.build_for(self.device, self.lm_cfg.lstm_impl, self.lm_cfg.decoder_impl)
        self.params = rewriter_from_jax_params(payload["params"]).to(self.device)

    def correct(self, texts: Sequence[str]) -> List[str]:
        """Rewrite transcripts; a gated rewrite falls back to its input.
        Characters outside the vocabulary are dropped before encoding."""
        vm, sos, eos = constants.VOCAB_MAP, constants.SOS_IDX, constants.EOS_IDX
        ids = [np.array([sos] + [vm[c] for c in t if c in vm] + [eos], np.int32)
               for t in texts]
        batcher = BucketBatcher(ids, self.batch_size, pad_time_multiple=32,
                                has_labels=False, label_pad_id=eos)
        out: List[Optional[str]] = [None] * len(texts)
        for bt in batcher.epoch(0):
            dec, margins = self.chain(self.params, bt.x, bt.lx.astype(np.int32))[self.family]
            for row, orig in enumerate(bt.indices):
                if orig < 0:
                    continue
                rewrite = ids_to_str(dec[row], constants.VOCAB, sos, eos)
                if margins is not None:
                    keep = float(margins[row]) > self.margin
                    out[orig] = rewrite if keep else texts[orig]
                else:
                    out[orig] = rewrite
        assert all(s is not None for s in out)
        return out  # type: ignore[return-value]


class Transcriber:
    """Persistent speech-to-text server over a trained LAS experiment.

    Args:
        exp_folder: experiment directory (config.json + ckpts/).
        checkpoint: explicit checkpoint path; default = latest best tag.
        average: uniform-average all best checkpoints instead.
        beam_size: > 1 = beam search; 0/1 = early-stop greedy.
        length_alpha: beam search's length normalisation (``len ** alpha``
            at selection; 0 = none, with exact pruning).
        max_len_factor: force-finish a row beyond this many characters per
            encoder frame (0 disables).
        batch_size: decode batch (requests are chunked and padded to it).
        pad_time_multiple: time bucket granularity.
        auto_warmup: frame counts whose buckets a background thread warms,
            largest first (see the module docstring); ``wait_ready`` gates
            traffic on the largest.
        data_parallel: split each decode batch over this many cards (see
            the module docstring); ``batch_size`` must divide evenly.
        corrector: optional ``Corrector``; every ``transcribe`` result
            passes through it before it is returned.
        device: where the model runs ("cuda", "cuda:1", "cpu").
    """

    def __init__(
        self,
        exp_folder: str,
        checkpoint: Optional[str] = None,
        average: bool = False,
        beam_size: int = 0,
        length_alpha: float = 0.0,
        max_len_factor: float = 3.0,
        batch_size: int = 32,
        pad_time_multiple: int = 128,
        auto_warmup: Optional[Sequence[int]] = None,
        data_parallel: int = 1,
        corrector=None,
        device: str = "cuda",
    ):
        if data_parallel > 1:
            split.check_divisible(batch_size, data_parallel)
        self.corrector = corrector
        self.length_alpha = length_alpha
        snap, payload = load_experiment(exp_folder, checkpoint, average)
        model_cfgs = snap["model"]["configs"]
        self.cfg = las_config_from_dicts(model_cfgs["listener_configs"],
                                         model_cfgs["speller_configs"])
        self.vocab = snap["VOCAB"]
        self.sos_idx = snap["SOS_IDX"]
        self.eos_idx = snap["EOS_IDX"]
        self.compute_dtype = compute_dtype(snap.get("compute_dtype", "float32"))
        self.batch_size = batch_size
        self.pad_time_multiple = pad_time_multiple
        self.n_feats = self.cfg.listener.input_dim
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Transcriber(device={device!r}): no CUDA device here; "
                               f"pass device='cpu' to decode on the CPU")
        self.params = las_from_jax_params(payload["params"]).to(self.device)
        if beam_size > 1:
            self._step = make_las_beam_step(
                self.cfg, beam_size=beam_size, length_alpha=length_alpha,
                compute_dtype=self.compute_dtype, max_len_factor=max_len_factor)
        else:
            self._step = make_las_greedy_step(
                self.cfg, compute_dtype=self.compute_dtype,
                max_len_factor=max_len_factor)
        self._split = (split.RowSplit(self._step, self.params,
                                      split.dp_devices(self.device, data_parallel))
                       if data_parallel > 1 else None)

        # warm-bucket registry (see the module docstring for what "warm" is)
        self._warm: set = set()
        self._warm_lock = threading.Lock()
        self._ready_evt = threading.Event()
        # ready = the ladder's LARGEST bucket is warm; a small early request
        # that warms a tight bucket must not flip it
        self._ready_bucket = (max(pad_to_multiple(t, pad_time_multiple)
                                  for t in auto_warmup)
                              if auto_warmup else 0)
        # requests in flight: the background warm-up waits between buckets
        # while there are any, so that it does not queue work on the card in
        # front of live traffic
        self._fg_cv = threading.Condition()
        self._fg_count = 0
        self._warmup_thread: Optional[threading.Thread] = None
        self._warmup_error: Optional[BaseException] = None
        if auto_warmup:
            self._warmup_thread = threading.Thread(
                target=self._warmup_bg, args=(tuple(auto_warmup),), daemon=True)
            self._warmup_thread.start()
        else:
            self._build_kernels()

    def _build_kernels(self) -> None:
        """On a card with a kernel tier configured: every kernel source built
        side by side and bound (a failed build raises)."""
        cuda_build.build_for(self.device, self.cfg.listener.lstm_impl,
                             self.cfg.speller.decoder_impl)

    def _warmup_bg(self, time_buckets) -> None:
        """The background warm-up: the kernels' build, then the ladder. A
        failure must not vanish into a dead daemon thread: it is recorded and
        ``wait_ready`` is released, so that the caller sees the error instead
        of blocking for ever."""
        try:
            self._build_kernels()
            self.warmup(time_buckets, largest_first=True, yield_to_foreground=True)
        except BaseException as exc:  # noqa: BLE001 - raised again in wait_ready
            self._warmup_error = exc
            self._ready_evt.set()

    def _decode(self, x: np.ndarray, lx: np.ndarray) -> np.ndarray:
        if self._split is not None:
            return self._split(x, lx)
        ids = self._step(self.params, torch.from_numpy(x).to(self.device),
                         torch.from_numpy(lx).to(self.device))
        return ids.cpu().numpy()

    def warmup(self, time_buckets: Sequence[int] = (512,),
               largest_first: bool = False,
               yield_to_foreground: bool = False) -> None:
        """Run one full batch per time bucket not warm yet. ``largest_first``
        warms the largest bucket first (the one ``wait_ready`` waits for);
        ``yield_to_foreground`` (the background mode) pauses between buckets
        while requests are in flight."""
        buckets = sorted({pad_to_multiple(t, self.pad_time_multiple)
                          for t in time_buckets}, reverse=largest_first)
        for t_pad in buckets:
            if yield_to_foreground and self._ready_evt.is_set():
                with self._fg_cv:
                    while self._fg_count > 0:
                        self._fg_cv.wait(timeout=5.0)
            with self._warm_lock:
                if t_pad in self._warm:
                    continue
            x = np.zeros((self.batch_size, t_pad, self.n_feats), np.float32)
            self._decode(x, np.full((self.batch_size,), t_pad, np.int32))
            self._mark_warm(t_pad)

    def _mark_warm(self, t_pad: int) -> None:
        with self._warm_lock:
            self._warm.add(t_pad)
        if t_pad >= self._ready_bucket:
            self._ready_evt.set()

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the auto-warm-up's largest bucket is warm: the kernels
        are built and bound and a full batch of that size has run, so no
        request pays a cold start. Returns True when ready, False on timeout;
        raises ``RuntimeError`` if the background warm-up failed. Without
        ``auto_warmup`` it returns True at once."""
        if self._warmup_thread is None:
            return True
        got = self._ready_evt.wait(timeout)
        if self._warmup_error is not None:
            raise RuntimeError(
                "background auto-warmup failed") from self._warmup_error
        return got

    def wait_warm(self, timeout: Optional[float] = None) -> None:
        """Block until the background auto-warm-up ladder has finished."""
        if self._warmup_thread is not None:
            self._warmup_thread.join(timeout)

    def _route_bucket(self, t_need: int) -> int:
        """The execution bucket of a batch that needs ``t_need`` frames:
        always the tight one. The JAX ``Transcriber`` routes up to a warm
        bucket to avoid a compile; PyTorch compiles no shape, so a larger
        bucket would only add padded frames to the recurrence."""
        return pad_to_multiple(t_need, self.pad_time_multiple)

    def transcribe(self, features: Sequence[np.ndarray]) -> List[str]:
        """Transcribe variable-length (T_i, n_feats) float feature arrays."""
        n = len(features)
        order = sorted(range(n), key=lambda i: len(features[i]), reverse=True)
        out: List[Optional[str]] = [None] * n
        with self._fg_cv:
            self._fg_count += 1
        try:
            for start in range(0, n, self.batch_size):
                chunk = order[start: start + self.batch_size]
                rows = chunk + [chunk[-1]] * (self.batch_size - len(chunk))
                t_pad = self._route_bucket(max(len(features[i]) for i in chunk))
                x = np.zeros((self.batch_size, t_pad, self.n_feats), np.float32)
                lx = np.zeros((self.batch_size,), np.int32)
                for r, i in enumerate(rows):
                    f = np.asarray(features[i], np.float32)[:, : self.n_feats]
                    x[r, : len(f)] = f
                    lx[r] = len(f)
                ids = self._decode(x, lx)
                self._mark_warm(t_pad)
                for r, i in enumerate(chunk):
                    out[i] = ids_to_str(ids[r], self.vocab, self.sos_idx, self.eos_idx)
        finally:
            with self._fg_cv:
                self._fg_count -= 1
                self._fg_cv.notify_all()
        if self.corrector is not None:
            out = self.corrector.correct(out)  # type: ignore[arg-type]
        return out  # type: ignore[return-value]


class StreamingTranscriber:
    """Request-queue front end over a Transcriber: ``submit()`` single
    utterances from any thread and get a Future; a dispatcher thread groups
    pending requests into batches (up to ``batch_size``, waiting at most
    ``max_wait_ms`` for stragglers) and runs them through the Transcriber."""

    def __init__(self, transcriber: Transcriber, max_wait_ms: float = 10.0):
        import queue
        import threading

        self.t = transcriber
        self.max_wait_ms = max_wait_ms
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        # submit()'s closed-check+enqueue and close()'s set-closed+sentinel
        # are serialized: an accepted request always lands before the
        # sentinel, so the worker never exits with live requests queued
        self._close_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, features: np.ndarray):
        """Enqueue one (T, n_feats) array; returns a concurrent Future.
        Raises RuntimeError after close()."""
        from concurrent.futures import Future

        fut: Future = Future()
        with self._close_lock:
            if self._closed:
                raise RuntimeError("StreamingTranscriber is closed")
            self._q.put((features, fut))
        return fut

    def close(self) -> None:
        with self._close_lock:
            self._closed = True
            self._q.put(None)
        self._worker.join()

    def _run(self) -> None:
        import queue
        import time

        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            while len(batch) < self.t.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)  # re-signal close after this batch
                    break
                batch.append(nxt)
            # a future the client already cancelled is dropped; a running
            # one can no longer be cancelled, so set_result cannot race it
            batch = [(f, fut) for f, fut in batch
                     if fut.set_running_or_notify_cancel()]
            if not batch:
                continue
            try:
                texts = self.t.transcribe([f for f, _ in batch])
            except Exception as exc:  # the worker must outlive a failed batch
                for _, fut in batch:
                    fut.set_exception(exc)
                continue
            for (_, fut), text in zip(batch, texts):
                fut.set_result(text)
