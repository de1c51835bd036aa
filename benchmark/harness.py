"""What every cell's run shares: the cell resolved from ``BENCHMARK.json`` by
name, the run's context, the traced segment, the checks and the result line.

An entry (``entries/<entry>.py``, named by the mix) gets a ``Run`` and
returns an ``Outcome``; ``finish`` turns it into the one JSON line. What
depends on the model's architecture sits in the configuration's family
(``families/<family>.py``), which the entry asks for by ``family``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from benchmark import traces

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "attention_based_e2e_asr_dnn_tpu")
TRACE_SPAN = "bench.traced_window"
# what a family module (``families/<family>.py``) defines
FAMILY_FUNCTIONS = ("leaf_specs", "feature_width", "dropout_rates", "train_steps", "precision",
                    "control_precision", "train_step_flops", "train_step_launches")


class Cell(NamedTuple):
    root: str                # the checkout the cell was resolved in
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]   # the cell's end-to-end metrics
    per_layer: List[dict]    # the cell's per-layer metrics
    limits: dict


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its configuration
    (``benchmark/configs/<config>.json``, or the file the entry names), its
    mix (``benchmark/traffic/<traffic>.json``), its metrics and its limits
    (``benchmark/limits/<cell>.json``)."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    here = os.path.join(root, "benchmark")
    mix = load_json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    limits_path = os.path.join(here, "limits", f"{name}.json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    return Cell(root, name, w["chips"], config, mix,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)], limits)


def load_file(path: str, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(cell: Cell):
    return load_file(os.path.join(cell.root, "benchmark", "entries", f"{cell.mix['entry']}.py"),
                     f"benchmark_entry_{cell.mix['entry']}")


def family(cell: Cell):
    """The family module of the cell's configuration: ``families/<name>.py``,
    ``name`` being the configuration's ``"family"``, else ``las``."""
    name = cell.config.get("family", "las")
    module = load_file(os.path.join(cell.root, "benchmark", "families", f"{name}.py"),
                       f"benchmark_family_{name}")
    missing = [f for f in FAMILY_FUNCTIONS if not callable(getattr(module, f, None))]
    if missing:
        raise SystemExit(f"family {name!r} does not define {missing}")
    return module


def metric_reader(name: str, root: str = ROOT) -> Callable:
    return load_file(os.path.join(root, "benchmark", "metrics", f"{name}.py"),
                     "benchmark_metric_" + name.replace(".", "_")).read


class Run(NamedTuple):
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float           # host clock at process start
    faults: tuple = ()       # faults planted underneath the timed path (tests)


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


class Outcome(NamedTuple):
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    memory_peak: int
    trace: Optional[traces.TraceContext] = None
    notes: tuple = ()


class Traced:
    """Profile a bounded stretch of steps inside the measured window: on when
    ``start`` is called with tracing asked for, off (after a synchronize)
    at ``stop``; the events stay in memory."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.span = None
        self.events: List[traces.Event] = []

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.span = record_function(TRACE_SPAN)
        self.span.__enter__()

    def stop(self, sync: Callable[[], None]) -> None:
        if self.prof is None:
            return
        sync()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.events = traces.from_profiler(self.prof)
        self.prof = None

    def window_us(self):
        spans = [e for e in self.events if not e.device and e.name == TRACE_SPAN]
        return (spans[0].start_us, spans[0].end_us) if spans else (0.0, 0.0)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> dict:
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def emit_checks(checks: List[Check]) -> Dict[str, dict]:
    for c in checks:
        print(f"check {c.name} {c.value:.6g} limit {c.limit:.6g} "
              f"{'ok' if c.ok() else 'FAILED'}", file=sys.stderr, flush=True)
    return {c.name: {"value": c.value, "limit": c.limit} for c in checks}


def finish(run: Run, out: Outcome, out_stream) -> dict:
    """The result line's object: the end-to-end metrics (untraced run) or
    the per-layer ones (traced run), the device, and the checks last."""
    cell = run.cell
    metrics = {}
    if run.trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.root)(out.trace) if out.trace is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in out.end_to_end:
                metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    device = {**card(), "count": cell.chips, "memory_peak_bytes": out.memory_peak}
    result = {"correct": bool(out.checks) and all(c.ok() for c in out.checks) and out.failed == 0,
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": device}
    if run.trace and out.trace is not None:
        device["busy_s"] = traces.busy_s(out.trace)
        device["window_s"] = traces.window_s(out.trace)
        result["breakdown"] = traces.breakdown(out.trace)
    for note in out.notes:
        print(note, file=sys.stderr)
    result["checks"] = emit_checks(out.checks)
    print(json.dumps(result), file=out_stream, flush=True)
    return result


@contextlib.contextmanager
def stdout_to_stderr():
    """Everything the run prints goes to standard error; the result line
    alone goes to standard output."""
    real = sys.stdout
    sys.stdout = sys.stderr
    try:
        yield real
    finally:
        sys.stdout = real
