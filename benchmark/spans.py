"""The port's own spans in a trace, read against the device's idle time.

The port's train step opens named host spans while a profiler runs
(``utils/profiling.py::span``): ``las.train_step`` around the whole step;
inside it ``las.specaug``, ``las.listener``, ``las.speller.operands``,
``las.speller.decode``, ``las.loss``, ``las.backward`` (with
``las.backward.listener`` and ``las.backward.speller`` opened on the
autograd engine's thread) and ``las.optimizer``; and ``las.launch.<key>``
around each call of a ``csrc/`` kernel, ``<key>`` being the call's
``LAUNCHES`` counter. They lie on the trace's one clock with the device's
kernels, so an instant at which the device runs nothing can be put on the
innermost span open on the host then: the shortest open one, on any thread.

Every reading here is None where the trace holds no ``las.train_step`` span
(a program without the spans) or nothing else to read.
"""

from __future__ import annotations

import bisect
import heapq
import re
from typing import Dict, List, Optional, Tuple

from benchmark import traces

PREFIX = "las."
STEP = "las.train_step"
LAUNCH = "las.launch."
OPTIMIZER = "las.optimizer"
# the layers idle time is split into, by the innermost span
GROUPS = ("listener", "speller", "optimizer", "step_glue", "between_steps")
# the host's kernel launch calls (the CUDA runtime's and the `cu*` API's)
LAUNCH_CALLS = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel\w*)$")


def group(name: Optional[str]) -> str:
    """The layer an idle instant belongs to, by the innermost ``las.*``
    span open then (None: no span, the caller's loop between steps)."""
    if name is None:
        return "between_steps"
    if name.startswith(LAUNCH):
        return "speller" if name[len(LAUNCH):].startswith("speller_") else "listener"
    if name in ("las.listener", "las.backward.listener"):
        return "listener"
    if name.startswith("las.speller.") or name == "las.backward.speller":
        return "speller"
    if name == OPTIMIZER:
        return "optimizer"
    return "step_glue"  # las.train_step's, las.backward's own time, las.specaug, las.loss


def host_spans(ctx: traces.TraceContext) -> List[traces.Event]:
    """The ``las.*`` spans on the host, clipped to the traced window."""
    lo, hi = ctx.window_us
    return [e._replace(start_us=max(e.start_us, lo), end_us=min(e.end_us, hi))
            for e in ctx.events if not e.device and e.name.startswith(PREFIX)
            and e.end_us > lo and e.start_us < hi]


def readable(ctx: traces.TraceContext) -> bool:
    """A traced train pass of the program with the spans."""
    return (ctx.kind == "train" and ctx.steps > 0
            and any(not e.device and e.name == STEP for e in ctx.events))


def idle_intervals(ctx: traces.TraceContext) -> List[Tuple[float, float]]:
    """The stretches of the traced window in which no device event runs:
    the complement of their union, as ``traces.idle_pct`` counts it."""
    lo, hi = ctx.window_us
    out, cursor = [], lo
    for s, e in sorted((max(e.start_us, lo), min(e.end_us, hi))
                       for e in ctx.events if e.device and e.end_us > lo and e.start_us < hi):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        out.append((cursor, hi))
    return out


def idle_ms_by_group(ctx: traces.TraceContext) -> Optional[Dict[str, float]]:
    """Device idle ms a step in each of ``GROUPS``: each idle instant goes
    to the group of the innermost ``las.*`` span open then. The groups sum
    to the idle share times the window over the steps."""
    if not readable(ctx) or not any(e.device for e in ctx.events):
        return None
    spans = sorted(host_spans(ctx), key=lambda e: e.start_us)
    idle = idle_intervals(ctx)
    points = sorted({p for e in spans for p in (e.start_us, e.end_us)}
                    | {p for iv in idle for p in iv})
    totals = dict.fromkeys(GROUPS, 0.0)
    open_spans: list = []  # (duration, -start, end, name): the shortest on top
    nxt = j = 0
    for a, b in zip(points, points[1:]):
        while nxt < len(spans) and spans[nxt].start_us <= a:
            e = spans[nxt]
            heapq.heappush(open_spans, (e.end_us - e.start_us, -e.start_us, e.end_us, e.name))
            nxt += 1
        while open_spans and open_spans[0][2] <= a:
            heapq.heappop(open_spans)
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        if j < len(idle) and idle[j][0] <= a:
            totals[group(open_spans[0][3] if open_spans else None)] += b - a
    return {k: v / 1e3 / ctx.steps for k, v in totals.items()}


def idle_ms(ctx: traces.TraceContext, name: str) -> Optional[float]:
    by_group = idle_ms_by_group(ctx)
    return None if by_group is None else by_group[name]


def optimizer_launches(ctx: traces.TraceContext) -> Optional[float]:
    """The host's kernel launches that begin inside ``las.optimizer``, a
    step. Nothing where the trace holds no launch call (no card traced)."""
    if not readable(ctx):
        return None
    calls = [e.start_us for e in ctx.events if not e.device and LAUNCH_CALLS.match(e.name)]
    if not calls:
        return None
    spans = sorted((e.start_us, e.end_us) for e in host_spans(ctx) if e.name == OPTIMIZER)
    starts = [s for s, _ in spans]
    inside = 0
    for t in calls:
        k = bisect.bisect_right(starts, t) - 1
        inside += k >= 0 and t < spans[k][1]
    return inside / ctx.steps


def kernel_call_host_ms(ctx: traces.TraceContext) -> Optional[float]:
    """Host ms a step inside ``las.launch.*`` spans: the kernel calls' checks,
    plans, buffers and C calls. Nothing where the calls' keys and the launch
    counters that moved over the traced steps differ."""
    if not readable(ctx):
        return None
    calls = [e for e in host_spans(ctx) if e.name.startswith(LAUNCH)]
    moved = {k for k, n in ctx.counters.items() if n}
    if not calls or {e.name[len(LAUNCH):] for e in calls} != moved:
        return None
    lo, hi = ctx.window_us
    return traces.union_us(((e.start_us, e.end_us) for e in calls), lo, hi) / 1e3 / ctx.steps
