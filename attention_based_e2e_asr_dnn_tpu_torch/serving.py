"""Serving API: load a trained experiment, transcribe feature batches
(counterpart of the JAX ``serving.py``, greedy decoding).

    >>> t = Transcriber("experiments/260816-123456", device="cuda")
    >>> t.transcribe([mfcc1, mfcc2, ...])   # list of (T_i, 15) arrays
    ['A DOG RAN', ...]

The experiment's ``config.json`` snapshot rebuilds the model and the
checkpoint loads from the data-only format. Requests are length-sorted into
padded batches of ``batch_size`` rows (the last one repeat-padded), each
padded in time to a multiple of ``pad_time_multiple``, and the original
order is restored. PyTorch runs eagerly, so there is no compile ladder:
every batch takes its tight time bucket, and ``warmup`` only runs one batch
per bucket to build the kernels and fill the allocator's cache.

Not ported yet (ROADMAP queue 1, items 9 and 11): beam search, the Rewriter
corrector, data-parallel decoding.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Sequence

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch import constants
from attention_based_e2e_asr_dnn_tpu_torch.utils.levenshtein import ids_to_str
from attention_based_e2e_asr_dnn_tpu_torch.data.batching import pad_to_multiple
from attention_based_e2e_asr_dnn_tpu_torch.decoding.greedy import make_las_greedy_step
from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    las_config_from_dicts,
    las_from_jax_params,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops.precision import compute_dtype
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


class Transcriber:
    """Persistent speech-to-text server over a trained LAS experiment.

    Args:
        exp_folder: experiment directory (config.json + ckpts/).
        checkpoint: explicit checkpoint path; default = latest best tag.
        average: uniform-average all best checkpoints instead.
        beam_size: 0/1 = early-stop greedy (beam search not ported yet).
        max_len_factor: force-finish a row beyond this many characters per
            encoder frame (0 disables).
        batch_size: decode batch (requests are chunked and padded to it).
        pad_time_multiple: time bucket granularity.
        device: where the model runs ("cuda", "cuda:1", "cpu").
    """

    def __init__(
        self,
        exp_folder: str,
        checkpoint: Optional[str] = None,
        average: bool = False,
        beam_size: int = 0,
        max_len_factor: float = 3.0,
        batch_size: int = 32,
        pad_time_multiple: int = 128,
        data_parallel: int = 1,
        corrector=None,
        device: str = "cuda",
    ):
        if beam_size > 1:
            raise NotImplementedError(
                "beam search is not ported yet (ROADMAP queue 1, item 9)")
        if corrector is not None:
            raise NotImplementedError(
                "the Rewriter corrector is not ported yet (ROADMAP queue 1, item 9)")
        if data_parallel > 1:
            raise NotImplementedError(
                "data-parallel decoding is not ported yet (ROADMAP queue 1, item 11)")
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
        self.params = las_from_jax_params(payload["params"]).to(self.device)
        self._step = make_las_greedy_step(
            self.cfg, compute_dtype=self.compute_dtype,
            max_len_factor=max_len_factor)

    def _decode(self, x: np.ndarray, lx: np.ndarray) -> np.ndarray:
        ids = self._step(self.params, torch.from_numpy(x).to(self.device),
                         torch.from_numpy(lx).to(self.device))
        return ids.cpu().numpy()

    def warmup(self, time_buckets: Sequence[int] = (512,)) -> None:
        """Run one full batch per time bucket."""
        for t in sorted({pad_to_multiple(t, self.pad_time_multiple)
                         for t in time_buckets}):
            x = np.zeros((self.batch_size, t, self.n_feats), np.float32)
            self._decode(x, np.full((self.batch_size,), t, np.int32))

    def transcribe(self, features: Sequence[np.ndarray]) -> List[str]:
        """Transcribe variable-length (T_i, n_feats) float feature arrays."""
        n = len(features)
        order = sorted(range(n), key=lambda i: len(features[i]), reverse=True)
        out: List[Optional[str]] = [None] * n
        for start in range(0, n, self.batch_size):
            chunk = order[start: start + self.batch_size]
            rows = chunk + [chunk[-1]] * (self.batch_size - len(chunk))
            t_pad = pad_to_multiple(max(len(features[i]) for i in chunk),
                                    self.pad_time_multiple)
            x = np.zeros((self.batch_size, t_pad, self.n_feats), np.float32)
            lx = np.zeros((self.batch_size,), np.int32)
            for r, i in enumerate(rows):
                f = np.asarray(features[i], np.float32)[:, : self.n_feats]
                x[r, : len(f)] = f
                lx[r] = len(f)
            ids = self._decode(x, lx)
            for r, i in enumerate(chunk):
                out[i] = ids_to_str(ids[r], self.vocab, self.sos_idx, self.eos_idx)
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
