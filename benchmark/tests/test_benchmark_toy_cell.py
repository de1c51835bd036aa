"""A new cell from new files alone: a toy configuration, mix and metric
reader in a copy of the benchmark, run end to end on the CPU."""

import hashlib
import io
import json
import os

import pytest

from benchmark import harness, traces
from benchmark.tests import toy


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if "__pycache__" in base:
                continue
            with open(os.path.join(base, f), "rb") as fh:
                out[os.path.relpath(os.path.join(base, f), root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_toy_cell_added_without_editing_a_file(tmp_path):
    root = toy.make_root(str(tmp_path))
    before, after = _digests(toy.ROOT), _digests(root)
    assert all(after[k] == v for k, v in before.items()), "a benchmark file was edited"
    added = sorted(set(after) - set(before))
    assert added == ["benchmark/configs/toy.json", "benchmark/limits/toy.train.json",
                     "benchmark/metrics/toy_kernels.py",
                     "benchmark/traffic/toy-train-longform.json"]
    cell = harness.resolve("toy.train", root)
    assert "toy_kernels" in [m["name"] for m in cell.per_layer]


@pytest.mark.parametrize("trace", [False, True])
def test_toy_cell_runs_and_prints_one_line(tmp_path, trace):
    root = toy.make_root(str(tmp_path))
    outcome, run = toy.run_cell(root, "toy.train", trace=trace)
    assert outcome.attempted >= 1 and outcome.failed == 0
    stream = io.StringIO()
    result = harness.finish(run, outcome, stream)
    line = json.loads(stream.getvalue().strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    if trace:  # no device here: the traced metrics read nothing, the window is there
        assert "setup_s" not in line["metrics"] and line["device"]["window_s"] > 0
    else:
        assert "setup_s" in line["metrics"]
    assert line["correct"] is True


def test_toy_metric_reads_a_synthetic_trace(tmp_path):
    root = toy.make_root(str(tmp_path))
    read = harness.metric_reader("toy_kernels", root)
    ev = [traces.Event("k", True, 0, 1), traces.Event("k", True, 2, 3), traces.Event("op", False, 0, 3)]
    ctx = traces.TraceContext(ev, (0, 3), 2, [], {}, 0.0, 1.0, 1, "train")
    assert read(ctx) == 1.0
    assert read(ctx._replace(events=ev[2:])) is None
