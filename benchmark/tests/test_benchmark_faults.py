"""The comparison fails what it must: a whole run past the look for a card,
with the timed path broken underneath, comes out not correct; and so does the
low-precision control. At a toy size on the CPU with the cells' own limits;
on the card at the cells' own size (``cuda``)."""

import io
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests import toy

@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_a_broken_path_is_not_correct(tmp_path, fault):
    root = toy.make_root(str(tmp_path))
    outcome, run = toy.run_cell(root, "toy.train", faults=(fault,))
    result = harness.finish(run, outcome, io.StringIO())
    assert result["correct"] is False


def test_the_control_separates_from_the_program(tmp_path):
    """At the toy size the control (float8 operands for the toy's bfloat16)
    reads at least three times what the program reads on the checked train
    steps, seed by seed, on one number or more. (The cells' own limits are
    held at their own size on the card: ``test_control_at_the_cells_size``.)"""
    from benchmark import calibrate

    root = toy.make_root(str(tmp_path))
    cell = harness.resolve("toy.train", root)
    for seed in (1, 2, 3):
        control = calibrate.train_control(cell, seed, torch.device("cpu"))
        outcome, _ = toy.run_cell(root, "toy.train", seed=seed)
        program = {c.name: c.value for c in outcome.checks}
        assert any(v > 3 * program[k] for k, (v, _) in control.items()), (control, program)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at their own size on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["base-las.train-longform"])
def test_control_at_the_cells_size(card, cell, tmp_path):
    out = tmp_path / "cal.jsonl"
    subprocess.run([sys.executable, os.path.join(toy.ROOT, "benchmark", "calibrate.py"),
                    "--workload", cell, "--control-seeds", "11", "12", "13", "--out", str(out)],
                   check=True)
    limits = harness.resolve(cell).limits
    for line in out.read_text().splitlines():
        numbers = json.loads(line)["numbers"]
        assert any(v > limits[k] for k, v in numbers.items()), numbers
