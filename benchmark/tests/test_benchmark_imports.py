"""What a run loads: no JAX and no JAX package anywhere; nothing of the
measured program in the reference. Top-level module names are compared
whole, so the port (whose name begins with the JAX package's) passes."""

import ast
import os
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT
JAX_NAMES = {"jax", "jaxlib", "flax", "attention_based_e2e_asr_dnn_tpu"}
PORT = "attention_based_e2e_asr_dnn_tpu_torch"


def _top_level_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _files(sub):
    for base, _, files in os.walk(os.path.join(ROOT, "benchmark", sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_whole_names_are_compared():
    assert PORT.split(".")[0] not in JAX_NAMES
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))


def test_no_source_of_the_benchmark_imports_jax():
    for path in _files(""):
        assert not (_top_level_imports(path) & JAX_NAMES), path


def test_reference_imports_nothing_of_the_program():
    for path in _files("reference"):
        assert PORT not in _top_level_imports(path), path
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.las_ref; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    loaded = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                            check=True).stdout
    assert PORT not in loaded and not any(f"'{n}'" in loaded for n in JAX_NAMES)


def test_a_whole_run_loads_no_jax(tmp_path):
    code = ("import sys; sys.path.insert(0, %r); from benchmark.tests import toy; "
            "from benchmark import harness; root = toy.make_root(%r); "
            "toy.run_cell(root, 'toy.train', trace=True); "
            "print('LOADED', harness.forbidden_modules(), %r in sys.modules)"
            % (ROOT, str(tmp_path), PORT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"}).stdout
    assert "LOADED [] True" in out
