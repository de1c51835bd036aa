"""The reduction from a ``torch.profiler`` trace to numbers.

A trace becomes a list of ``Event``s: name, whether it ran on the device
(kernels, copies and sets; not the profiler's device-side annotations),
start and end in microseconds. What the per-layer metrics read is a
``TraceContext``: those events, the host-clock window they cover, the kernel
launches the traced steps made by the benchmark's own count
(``counts.Launch``) and the port's launch counters over the same steps.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

from benchmark import counts

# the port's hand-written kernels (csrc/), by symbol
PORT_KERNELS = re.compile(r"\b(lstm_scan_tc_kernel|lstm_scan_kernel|lstm_bwd_tc_kernel|"
                          r"lstm_bwd_kernel|speller_decode_tc_kernel|speller_decode_kernel|"
                          r"speller_bwd_tc_kernel|speller_bwd_kernel)\b")
NCCL = re.compile(r"nccl", re.IGNORECASE)


class Event(NamedTuple):
    name: str
    device: bool
    start_us: float
    end_us: float


class TraceContext(NamedTuple):
    """What a per-layer metric reads. ``events``: the trace; ``window_us``:
    (start, end) of the traced steps on the trace's clock; ``steps``: how
    many steps (batches) the trace covers; ``launches``: the kernel launches
    those steps make by ``counts``; ``counters``: the port's launch counters
    over the same steps; ``flops``, ``seconds``: the model FLOPs of the
    traced steps and the traced window's seconds; ``chips``; ``kind``:
    the entry's name ("train")."""
    events: List[Event]
    window_us: Tuple[float, float]
    steps: int
    launches: List[counts.Launch]
    counters: Dict[str, int]
    flops: float
    seconds: float
    chips: int
    kind: str


def from_profiler(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = "cuda" in str(e.device_type()).lower()
        if on_device and (e.name().startswith("bench.")
                          or getattr(e, "is_user_annotation", lambda: False)()):
            continue  # the device-side copies of host spans
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), on_device, start, start + e.duration_ns() / 1e3))
    return out


def union_us(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_s(ctx: TraceContext) -> float:
    lo, hi = ctx.window_us
    return union_us(((e.start_us, e.end_us) for e in ctx.events if e.device), lo, hi) / 1e6


def window_s(ctx: TraceContext) -> float:
    return (ctx.window_us[1] - ctx.window_us[0]) / 1e6


def idle_pct(ctx: TraceContext) -> Optional[float]:
    if window_s(ctx) <= 0 or not any(e.device for e in ctx.events):
        return None
    return 100.0 * (1.0 - busy_s(ctx) / window_s(ctx))


def device_events(ctx: TraceContext, pattern: re.Pattern) -> List[Event]:
    lo, hi = ctx.window_us
    return [e for e in ctx.events if e.device and pattern.search(e.name)
            and e.end_us > lo and e.start_us < hi]


def roofline_pct(ctx: TraceContext, pattern: re.Pattern, counters: Sequence[str]) -> Optional[float]:
    """The least time of the launches of ``counters`` over the device time of
    the kernels matching ``pattern``, in percent. Nothing where the trace
    holds no such kernel, or where the kernels traced, the benchmark's count
    and the port's counters disagree on how many launches there were (the
    route is not the one the count describes)."""
    kernels = device_events(ctx, pattern)
    launches = [ln for ln in ctx.launches if ln.counter in counters]
    counted = sum(ctx.counters.get(c, 0) for c in counters)
    if not kernels or len(kernels) != len(launches) or counted != len(launches):
        return None
    seconds = sum(e.end_us - e.start_us for e in kernels) / 1e6
    return 100.0 * sum(ln.bound_s() for ln in launches) / seconds


def other_kernels_ms(ctx: TraceContext) -> Optional[float]:
    """Device ms a step of every kernel that is neither one of the port's
    hand-written kernels nor a collective."""
    if ctx.steps <= 0:
        return None
    lo, hi = ctx.window_us
    spans = [e for e in ctx.events if e.device and e.end_us > lo and e.start_us < hi
             and not PORT_KERNELS.search(e.name) and not NCCL.search(e.name)]
    if not spans:
        return None
    return sum(e.end_us - e.start_us for e in spans) / 1e3 / ctx.steps


def mfu_pct(ctx: TraceContext, kind: str) -> Optional[float]:
    """The traced steps' model FLOPs over the traced window's seconds and
    the chips' bfloat16 peak, in percent."""
    if ctx.kind != kind or ctx.seconds <= 0 or ctx.flops <= 0:
        return None
    return 100.0 * ctx.flops / ctx.seconds / (counts.PEAK_FLOPS["bfloat16"] * ctx.chips)


def breakdown(ctx: TraceContext, top: int = 10) -> dict:
    """The device operations that took most time (seconds summed by name)
    and the longest idle gaps, each named by the innermost host operation
    running when it began."""
    lo, hi = ctx.window_us
    by_name: Dict[str, float] = {}
    dev = sorted((e for e in ctx.events if e.device and e.end_us > lo and e.start_us < hi),
                 key=lambda e: e.start_us)
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end_us - e.start_us) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, cursor = [], lo
    for e in dev:
        if e.start_us > cursor:
            gaps.append((cursor, e.start_us))
        cursor = max(cursor, e.end_us)
    if hi > cursor:
        gaps.append((cursor, hi))
    host = [e for e in ctx.events if not e.device]
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        inside = [h for h in host if h.start_us <= s < h.end_us]
        label = min(inside, key=lambda h: h.end_us - h.start_us).name if inside else "(no host op)"
        named.append([label, (e - s) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
