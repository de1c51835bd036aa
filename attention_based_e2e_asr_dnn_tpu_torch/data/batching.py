"""Length-bucketed batching (counterpart of the JAX ``data/batching.py``),
numpy only.

Examples are sorted by feature length (longest first) and chunked into
batches of ``batch_size``; every batch pads time up to a multiple of
``pad_time_multiple`` and labels up to a multiple of ``pad_label_multiple``;
the final batch is filled by repeating its last example, with index -1.
With ``shuffle``, examples shuffle within windows of ``shuffle_window``
batches and the batch order shuffles per epoch, from ``seed + epoch``.
Features pad with 0.0 and transcripts with the EOS/PAD id, as the reference
collate does (src/utils.py:96). The batches equal the JAX package's.

PyTorch runs eagerly, so the buckets bound padding, not compiled programs.
``ThreadedPrefetcher`` assembles batches ahead on a worker thread. A dataset
that exposes ``feature_lengths`` is not read to learn its lengths, and one
that exposes ``assemble(indices, t_pad)`` and ``label(i)`` (the lazy datasets
of ``data/lazy.py``) builds its own padded feature batch, so that no feature
file is read before its batch is due.

A data-parallel rank's batcher (``set_shard(rank, size)``) walks the same global
plan from the same seed and assembles the features of its rows only, rows
``[rank * B/size, (rank + 1) * B/size)`` of each global batch (the JAX shard
order, ``parallel/multihost.py::process_slice``), padded in time as the
global batch is: its ``Batch.x`` and ``lx`` hold those rows, ``rows`` says
which, and ``y``, ``ly`` and ``indices`` stay the global batch's (the dev
pass's edit distance reads them). A lazy dataset reads only its rows' files.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional

import numpy as np

from attention_based_e2e_asr_dnn_tpu_torch.parallel.mesh import row_block


def pad_to_multiple(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


@dataclass
class Batch:
    """One padded batch. ``indices`` are original dataset positions."""

    x: np.ndarray                    # (B, T, F) float32 or (B, T) int32 for LM
    lx: np.ndarray                   # (B,)
    y: Optional[np.ndarray] = None   # (B, L) int32
    ly: Optional[np.ndarray] = None  # (B,)
    indices: Optional[np.ndarray] = None
    rows: Optional[slice] = None     # x and lx hold only these rows (a rank's)


class BucketBatcher:
    """Length-bucketed batch planner over a dataset of variable-length
    examples: feature datasets (x (T, F) float) and id datasets (x (T,)
    int)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        pad_time_multiple: int = 128,
        pad_label_multiple: int = 32,
        label_pad_id: int = 29,
        has_labels: bool = True,
        shuffle: bool = False,
        shuffle_window: int = 4,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_time_multiple = pad_time_multiple
        self.pad_label_multiple = pad_label_multiple
        self.label_pad_id = label_pad_id
        self.has_labels = has_labels
        self.shuffle = shuffle
        self.shuffle_window = shuffle_window
        self.seed = seed
        self.drop_last = drop_last
        self.shard: Optional[slice] = None  # a data-parallel rank's rows
        if hasattr(dataset, "feature_lengths"):
            self._lengths = np.asarray(dataset.feature_lengths, dtype=np.int64)
        else:
            self._lengths = np.array(
                [len(dataset[i][0] if has_labels else dataset[i])
                 for i in range(len(dataset))], dtype=np.int64)
        self._sorted = np.argsort(-self._lengths, kind="stable")

    def set_shard(self, rank: int, size: int) -> None:
        """Assemble only the rows of data-parallel rank ``rank`` of
        ``size`` (see the module docstring)."""
        self.shard = row_block(self.batch_size, int(rank), int(size))

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_plan(self, epoch: int) -> List[np.ndarray]:
        order = self._sorted.copy()
        rng = np.random.default_rng(self.seed + epoch)
        if self.shuffle and self.shuffle_window > 0:
            window = self.shuffle_window * self.batch_size
            for start in range(0, len(order), window):
                seg = order[start: start + window]
                rng.shuffle(seg)
                order[start: start + window] = seg
        batches = [order[i: i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def _assemble(self, idx: np.ndarray) -> Batch:
        take = list(idx)
        n_real = len(take)
        take += [take[-1]] * (self.batch_size - n_real)  # repeat-pad
        indices = np.array(list(idx) + [-1] * (self.batch_size - n_real),
                           dtype=np.int64)
        rows = self.shard
        mine = take if rows is None else take[rows]
        if hasattr(self.dataset, "assemble"):
            # lazy path: the dataset reads and pads the features in one pass
            # (the native thread pool, or numpy); labels come from its
            # in-memory transcripts, so no item's features are loaded twice
            t_pad = pad_to_multiple(int(self._lengths[take].max()), self.pad_time_multiple)
            x, lx = self.dataset.assemble(mine, t_pad)
            ys = [self.dataset.label(i) for i in take] if self.has_labels else None
        else:
            items = [self.dataset[i] for i in take]
            xs = [it[0] for it in items] if self.has_labels else items
            ys = [it[1] for it in items] if self.has_labels else None
            lx = np.array([len(x) for x in xs], dtype=np.int32)
            t_pad = pad_to_multiple(int(lx.max()), self.pad_time_multiple)
            if rows is not None:
                xs, lx = xs[rows], lx[rows]
            if xs[0].ndim == 2:
                x = np.zeros((len(xs), t_pad, xs[0].shape[1]), dtype=np.float32)
            else:
                x = np.full((len(xs), t_pad), self.label_pad_id, dtype=np.int32)
            for b, ex in enumerate(xs):
                x[b, : len(ex)] = ex
        if ys is None:
            return Batch(x=x, lx=lx, indices=indices, rows=rows)

        ly = np.array([len(y) for y in ys], dtype=np.int32)
        l_pad = pad_to_multiple(int(ly.max()), self.pad_label_multiple)
        y = np.full((self.batch_size, l_pad), self.label_pad_id, dtype=np.int32)
        for b, ey in enumerate(ys):
            y[b, : len(ey)] = ey
        return Batch(x=x, lx=lx, y=y, ly=ly, indices=indices, rows=rows)

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        for idx in self._batch_plan(epoch):
            yield self._assemble(idx)

    def __iter__(self) -> Iterator[Batch]:
        return self.epoch(0)


class ThreadedPrefetcher:
    """Wrap a batch iterator and assemble up to ``depth`` batches ahead on a
    worker thread (the role the reference gave DataLoader workers): numpy's
    file reads and padding release the GIL, so they overlap the main thread's
    work. Order is kept; an exception in the worker is raised in the
    consumer; ``close`` stops the worker of an iterator left half-read.
    ``on_span``, where given, is called on the worker's thread with (thread
    id, start, end) on ``time.perf_counter_ns`` of its work on each batch,
    for the Trainer's profile trace."""

    _DONE = object()

    def __init__(self, batch_iter: Iterator, depth: int = 2,
                 on_span: Optional[Callable[[int, int, int], None]] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()

        def put(item) -> bool:
            # bounded, and given up once the consumer has closed us: a worker
            # must not sit on a full queue for ever
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            tid = threading.get_native_id()
            try:
                start = time.perf_counter_ns()
                for item in batch_iter:
                    if on_span is not None:
                        on_span(tid, start, time.perf_counter_ns())
                    if not put(item):
                        return
                    start = time.perf_counter_ns()
            except BaseException as exc:  # raised again on the consumer's side
                put(exc)
                return
            put(self._DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the worker and drop what is queued (idempotent)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=2.0)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            self._thread.join()
            raise StopIteration
        if isinstance(item, BaseException):
            self._thread.join()
            raise item
        return item
