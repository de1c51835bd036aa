"""The Trainer's ``profile`` block (counterpart of the JAX Trainer's
``jax.profiler`` trace): a ``torch.profiler`` trace of the first batches of
one epoch, written as one Chrome trace.

    profile: {use: true, epoch: 0, batches: 5}

traces the first ``batches`` train steps of epoch ``epoch`` into
``<saving_dir>/profile/trace-epoch<epoch>.json`` (open it in Perfetto or
``chrome://tracing``). The CPU is traced always, the card where the Trainer
runs on one (``record_shapes`` off). On a card a trace that holds no device
event raises: a profile of the host alone would read as an idle device.

``torch.profiler`` records the operators of the thread that started it only,
so the ``ThreadedPrefetcher``'s worker, which assembles the padded host
batches, would be missing. The worker reports each batch's span to
``host_span`` (thread id, start and end on ``time.perf_counter_ns``) while
the window is open; the spans that overlap the window are written into the
trace as events of the worker's thread, aligned through the ``profile
window`` annotation that spans the whole window on the main thread. The pinned copies on the side
stream are in the trace as they are (``aten::pin_memory``, ``aten::copy_``
and the device's memcpy on its own stream).

``span(name)`` names a stretch of the train step in any running profiler's
trace (this block's, or the benchmark's): ``las.train_step`` and, inside it,
``las.specaug``, ``las.listener``, ``las.speller.operands``,
``las.speller.decode``, ``las.loss``, ``las.backward`` (with
``las.backward.listener`` and ``las.backward.speller`` on the autograd
engine's thread) and ``las.optimizer``; ``las.launch.<key>`` covers one call
of a ``csrc/`` kernel, ``<key>`` being its ``LAUNCHES`` counter. The spans
sit on the same clock as the card's kernels, so an idle stretch of the card
can be read against the span open on the host at the time.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import List, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

WINDOW = "profile window"
LAUNCH = "las.launch."  # the prefix of a csrc/ kernel call's span

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler is running, else one shared
    null context: an unguarded ``record_function`` pays for its own enter and
    exit even with no profiler on, this costs one test. Spans sit at layer
    boundaries only, never inside a per-timestep loop."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF


class EpochProfiler:
    """One trace over the first ``batches`` steps of an epoch. ``stop``
    ends it (idempotent); with ``export`` it writes the trace and returns
    its path."""

    def __init__(self, out_dir: str, device: torch.device, batches: int, epoch: int):
        from torch.profiler import ProfilerActivity, profile

        self.out_dir = out_dir
        self.device = torch.device(device)
        self.batches = int(batches)
        self.epoch = epoch
        # (native thread id, start ns, end ns) of the host pipeline's work
        self._spans: List[Tuple[int, int, int]] = []
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities, record_shapes=False)
        self._prof.start()
        self._window = record_function(WINDOW)
        self._t0 = time.perf_counter_ns()
        self._window.__enter__()
        self._t1: Optional[int] = None
        self._running = True

    def host_span(self, tid: int, start: int, end: int) -> None:
        """One batch of the prefetcher's work (its worker calls this); kept
        only while the window is open."""
        if self._running:
            self._spans.append((tid, start, end))

    def stop(self, export: bool = True) -> Optional[str]:
        if not self._running:
            return None
        self._running = False
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the window's kernels complete
            self._t1 = time.perf_counter_ns()
            self._window.__exit__(None, None, None)
        finally:
            self._prof.stop()
        if not export:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"trace-epoch{self.epoch}.json")
        self._prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        n_kernels = sum(1 for e in events if str(e.get("cat", "")).lower() == "kernel")
        if self.device.type == "cuda" and n_kernels == 0:
            raise RuntimeError(f"{path}: the profile of {self.batches} steps on "
                               f"{self.device} holds no device event; the profiler "
                               f"did not trace the card")
        events.extend(self._host_events(events))
        with open(path, "w") as fh:
            fh.write(json.dumps(trace))  # one string: json.dump's chunks are slower
        return path

    def _host_events(self, events: list) -> list:
        """The worker's spans that overlap the window, as complete events
        placed by the window annotation's start (trace microseconds) against
        ``_t0``."""
        # the host's annotation (a card's trace mirrors it on the device's
        # timeline as a "gpu_user_annotation")
        window = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"]
        spans = list(self._spans)  # the worker may still be running
        if not window or not spans:
            return []
        anchor = window[0]
        offset_us = float(anchor["ts"]) - self._t0 / 1e3
        out, tids = [], set()
        for tid, start, end in spans:
            if end < self._t0 or start > self._t1:
                continue
            tids.add(tid)
            out.append({"ph": "X", "cat": "host_prefetch", "name": "ThreadedPrefetcher batch",
                        "pid": anchor["pid"], "tid": tid, "ts": offset_us + start / 1e3,
                        "dur": (end - start) / 1e3})
        out += [{"ph": "M", "name": "thread_name", "pid": anchor["pid"], "tid": tid,
                 "args": {"name": "ThreadedPrefetcher"}} for tid in sorted(tids)]
        return out


def epoch_profiler(profile_cfg, epoch: int, saving_dir: str,
                   device: torch.device) -> Optional[EpochProfiler]:
    """An ``EpochProfiler`` when ``profile.use`` is set and ``epoch`` is
    ``profile.epoch`` (default 0); ``profile.batches`` defaults to 5."""
    if profile_cfg is None or not getattr(profile_cfg, "use", False):
        return None
    if epoch != int(getattr(profile_cfg, "epoch", 0)):
        return None
    return EpochProfiler(os.path.join(saving_dir, "profile"), device,
                         int(getattr(profile_cfg, "batches", 5)), epoch)
