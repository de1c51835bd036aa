"""The compared numbers of a training cell by hand: a small leaf is judged
on its own scale as well as on the median leaf's, and leaves that the
reference does not move are left out."""

import pytest

from benchmark import checks

REF = {"big": 1.0, "mid": 0.5, "small": 0.01, "key_bias": 1e-9}


def _numbers(prog_grad, prog_change=REF):
    return {k: v for k, (v, _) in checks.train_numbers(
        [2.0], [2.0], prog_grad, REF, prog_change, REF).items()}


def test_a_wrong_small_leaf_fails_on_its_own_scale():
    got = _numbers({**REF, "small": 0.0})
    assert got["grad_leaf_gap"] == pytest.approx(1.0)
    assert got["grad_gap"] == pytest.approx(0.01 / 0.255)  # the median leaf's scale


def test_a_leaf_the_reference_does_not_move_is_left_out():
    got = _numbers({**REF, "key_bias": 1e-7}, {**REF, "key_bias": 1e-7})
    assert got["grad_leaf_gap"] == 0.0 and got["change_gap"] == 0.0
    assert got["grad_gap"] < 1e-6


def test_the_worst_leaf_is_named():
    out = checks.train_numbers([2.0], [2.0], {**REF, "mid": 0.55}, REF, REF, REF)
    assert out["grad_leaf_gap"] == (pytest.approx(0.1), "mid")
    assert out["loss_gap"][0] == 0.0
