"""BENCHMARK.json resolves, by name, into the data files of the benchmark."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_from_its_files(cell):
    c = harness.resolve(cell)
    assert c.name == cell
    assert os.path.exists(os.path.join(ROOT, "benchmark", "entries", c.mix["entry"] + ".py"))
    assert callable(getattr(harness.entry(c), "run", None))
    family = harness.family(c)
    assert all(callable(getattr(family, f, None)) for f in harness.FAMILY_FUNCTIONS)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names, f"{m['name']} moves a metric {cell} does not report"
        assert callable(harness.metric_reader(m["name"]))
    assert set(c.limits) == {"loss_gap", "grad_gap", "change_gap", "grad_leaf_gap"}


def test_names_keys_and_bounds():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = ([c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"][0]["bound"] <= 0.25


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.resolve("no-such.cell")


def test_config_files_hold_the_repository_yaml_model_blocks():
    yaml = pytest.importorskip("yaml")
    for name, path in (("base-las", "configs/base-las.yml"),):
        with open(os.path.join(ROOT, path)) as fh:
            want = yaml.safe_load(fh)["model"]["configs"]
        with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as fh:
            got = json.load(fh)["model"]
        assert got == want
