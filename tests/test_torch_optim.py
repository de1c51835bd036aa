"""PyTorch port, optimizers and schedulers against the JAX package's (optax
0.2.6 underneath): one step of adam / adamw / sgd from one state, a few
steps of amsgrad (where optax and ``torch.optim`` part), clipping on both
sides of its threshold, and the four host-side schedulers on a scripted
history."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu.training import optim as joptim
from attention_based_e2e_asr_dnn_tpu_torch.training import optim as toptim

torch.set_num_threads(1)

SHAPES = {"a": (4, 3), "b": (5,), "c": {"w": (2, 2, 3)}}


def _tree(rng, scale=1.0):
    return jax.tree.map(lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
                        SHAPES, is_leaf=lambda s: isinstance(s, tuple))


def _leaves(tree):
    return [torch.from_numpy(np.array(a)) for a in jax.tree.leaves(tree)]


CASES = {
    "adam": ("adam", {"lr": 1e-2}),
    "adam-l2-amsgrad": ("adam", {"lr": 1e-2, "weight_decay": 0.1, "amsgrad": True,
                                 "betas": (0.8, 0.95), "eps": 1e-6}),
    "adamw": ("adamw", {"lr": 1e-2, "weight_decay": 0.1}),
    "adamw-amsgrad": ("adamw", {"lr": 1e-3, "weight_decay": 5e-6, "amsgrad": True}),
    "sgd": ("sgd", {"lr": 0.1}),
    "sgd-momentum-l2": ("sgd", {"lr": 0.1, "momentum": 0.9, "weight_decay": 0.01}),
    "sgd-nesterov": ("sgd", {"lr": 0.1, "momentum": 0.9, "nesterov": True}),
}


# grad scale 0.1: global norm below the clip of 1.0 (idle); 10: far above
@pytest.mark.parametrize("grad_scale", [0.1, 10.0])
@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_steps_match_optax(case, grad_scale):
    """Four steps from one state with fresh gradients each step and a
    learning rate that moves (a runtime scalar on both sides). float32,
    rtol 1e-5 / atol 1e-7: the same elementwise arithmetic."""
    name, configs = CASES[case]
    rng = np.random.default_rng(0)
    params = _tree(rng)
    tx = joptim.build_optimizer(name, configs, grad_norm=1.0)
    j_params, j_state = jax.tree.map(jnp.asarray, params), None
    j_state = tx.init(j_params)
    opt = toptim.build_optimizer(name, configs, grad_norm=1.0)
    t_params = _leaves(params)
    t_state = opt.init(t_params)
    for n in range(4):
        grads = _tree(rng, grad_scale)
        lr = configs["lr"] * (1.0 - 0.2 * n)
        hp = dict(j_state.hyperparams)
        hp["learning_rate"] = jnp.asarray(lr, jnp.float32)
        j_state = j_state._replace(hyperparams=hp)
        updates, j_state = tx.update(jax.tree.map(jnp.asarray, grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_updates, t_state = opt.update(_leaves(grads), t_state, t_params, lr)
        t_params = [p + u for p, u in zip(t_params, t_updates)]
        assert int(t_state.count) == n + 1
        for ours, ref in zip(t_params, jax.tree.leaves(j_params)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{case} step {n}")


@pytest.mark.parametrize("case,k", [("adamw-amsgrad", 2), ("sgd-momentum-l2", 3)])
def test_accumulation_matches_optax_multisteps(case, k):
    """``accum_steps=k``: seven calls, so two emitting ones and a partial
    third round; the updates of every call, emitting or not."""
    name, configs = CASES[case]
    rng = np.random.default_rng(5)
    params = _tree(rng)
    tx = joptim.build_optimizer(name, configs, grad_norm=1.0, accum_steps=k)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = tx.init(j_params)
    opt = toptim.build_optimizer(name, configs, grad_norm=1.0, accum_steps=k)
    t_params = _leaves(params)
    t_state = opt.init(t_params)
    for n in range(7):
        grads = _tree(rng, 3.0 if n % 2 else 0.1)
        updates, j_state = tx.update(jax.tree.map(jnp.asarray, grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_updates, t_state = opt.update(_leaves(grads), t_state, t_params, configs["lr"])
        emitted = (n + 1) % k == 0
        assert all(bool(u.abs().sum() > 0) == emitted for u in t_updates)
        assert int(t_state.mini_step) == (n + 1) % k == int(j_state.mini_step)
        assert int(t_state.count) == (n + 1) // k
        t_params = [p + u for p, u in zip(t_params, t_updates)]
        for ours, ref in zip(t_params, jax.tree.leaves(j_params)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{case} call {n}")
        for ours, ref in zip(t_state.acc_grads, jax.tree.leaves(j_state.acc_grads)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)


def test_amsgrad_follows_optax_not_torch():
    """From step 2 on ``torch.optim.AdamW(amsgrad=True)`` (maximum of the
    uncorrected second moment) leaves optax's rule (maximum of the
    bias-corrected one); the port stays with optax."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((6,)).astype(np.float32)
    grads = [rng.standard_normal((6,)).astype(np.float32) * s for s in (3.0, 0.1, 0.1)]
    configs = {"lr": 1e-2, "weight_decay": 0.0, "amsgrad": True}
    tx = joptim.build_optimizer("adamw", configs, grad_norm=1e9)
    j_p, j_s = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    opt = toptim.build_optimizer("adamw", configs, grad_norm=1e9)
    t_p = [torch.from_numpy(p0.copy())]
    t_s = opt.init(t_p)
    ref_p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    ref_opt = torch.optim.AdamW([ref_p], lr=1e-2, weight_decay=0.0, amsgrad=True)
    for g in grads:
        u, j_s = tx.update(jnp.asarray(g), j_s, j_p)
        j_p = optax.apply_updates(j_p, u)
        u, t_s = opt.update([torch.from_numpy(g)], t_s, t_p, 1e-2)
        t_p = [t_p[0] + u[0]]
        ref_p.grad = torch.from_numpy(g.copy())
        ref_opt.step()
    np.testing.assert_allclose(t_p[0].numpy(), np.asarray(j_p), rtol=1e-5, atol=1e-7)
    assert np.abs(ref_p.detach().numpy() - np.asarray(j_p)).max() > 1e-4


def test_unknown_keys_and_names_are_refused():
    with pytest.raises(ValueError, match="unsupported config keys"):
        toptim.build_optimizer("adam", {"lr": 1e-3, "fused": True})
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.build_optimizer("lion", {})
    assert toptim.build_optimizer("adamw", {}).lr == 1e-3


def test_opt_state_bridge_round_trips():
    module = torch.nn.ModuleDict({"x": torch.nn.Linear(3, 2)})
    rng = np.random.default_rng(2)
    trees = [{"x": {"weight": rng.standard_normal((2, 3)).astype(np.float32),
                    "bias": rng.standard_normal((2,)).astype(np.float32)}}
             for _ in range(3)]
    state = toptim.opt_state_from_optax(module, 7, *trees)
    assert int(state.count) == 7 and state.count.dtype == torch.int32
    names = [n for n, _ in module.named_parameters()]
    for leaf, name in zip(state.mu, names):
        np.testing.assert_array_equal(leaf.numpy(), trees[0]["x"][name.split(".")[1]])
    back = toptim.opt_state_to_optax(module, state)
    assert back["count"] == 7
    for got, tree in zip((back["mu"], back["nu"], back["nu_max"]), trees):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Schedulers
# ---------------------------------------------------------------------------

def test_cosine_warmup_matches_jax():
    args = dict(num_batches=7, warmup_epochs=1.5, max_epochs=4, init_lr=1e-3, min_lr=1e-6)
    ref, ours = joptim.CosineWarmupSchedule(**args), toptim.CosineWarmupSchedule(**args)
    assert [ours.step() for _ in range(35)] == [ref.step() for _ in range(35)]
    assert ours(3) == ref(3) and ours.state_dict() == ref.state_dict()
    ours.load_state_dict({"step_count": 2})
    assert ours.step_count == 2


def test_reduce_lr_on_plateau_matches_jax():
    history = [30.0, 25.0, 25.0, 25.0, 25.0, 25.0, 24.0, 24.0, 24.0, 24.0, 24.0, 24.0]
    ref = joptim.ReduceLROnPlateau(1e-3, factor=0.5, patience=3)
    ours = toptim.ReduceLROnPlateau(1e-3, factor=0.5, patience=3)
    assert [ours.step(m) for m in history] == [ref.step(m) for m in history]
    assert ours.lr < 1e-3 and ours.state_dict() == ref.state_dict()
    fresh = toptim.ReduceLROnPlateau(1.0)
    fresh.load_state_dict(ours.state_dict())
    assert fresh.state_dict() == ours.state_dict()


def test_teacher_forcing_scheduler_matches_jax():
    ref = joptim.TeacherForcingScheduler(0.9, factor=0.1, interval=2, lowest=0.6)
    ours = toptim.TeacherForcingScheduler(0.9, factor=0.1, interval=2, lowest=0.6)
    history, got, want = [], [], []
    for epoch, ld in enumerate([80, 40, 19, 18, 17, 16, 16, 15, 14, 13, 12, 11, 10, 9, 8, 7]):
        history.append(float(ld))
        got.append(ours.step(epoch, history))
        want.append(ref.step(epoch, history))
    assert got == want and got[0] == 0.9 and min(got) < 0.9
    assert min(got) >= 0.6 - 1e-9   # the floor holds
    assert ours.state_dict() == ref.state_dict()
    fresh = toptim.TeacherForcingScheduler(0.9)
    fresh.load_state_dict(ours.state_dict())
    assert fresh.tf_rate == ours.tf_rate and fresh.last_turn == ours.last_turn


def test_dropout_scheduler_matches_jax():
    table = {"3": 0.5, 10: 2.0}
    ref, ours = joptim.DropoutScheduler(table), toptim.DropoutScheduler(table)
    assert [ours.step(e) for e in range(12)] == [ref.step(e) for e in range(12)]
    assert ours.step(3) == 0.5 and ours.step(4) == 1.0
