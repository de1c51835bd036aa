"""The plain reference held to the port's CPU path (the kernels' plain
versions) in float32 at a toy size: the checked steps."""


from benchmark.tests import toy


def test_train_steps_agree_in_float32(tmp_path):
    root = toy.make_root(str(tmp_path), dtype="float32")
    outcome, _ = toy.run_cell(root, "toy.train")
    got = {c.name: c.value for c in outcome.checks}
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-4
    assert got["change_gap"] < 1e-3
    assert got["grad_leaf_gap"] < 1e-3
