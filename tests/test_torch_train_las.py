"""PyTorch port, training: the teacher-forced speller, the training
``las_apply`` and whole train steps against the JAX package at toy sizes in
float32, with the JAX package's random draws replayed into the port.

The two frameworks' generators give different numbers from one seed, so
``replay_train_draws`` below walks the JAX key splits of one train step and
hands the port the very masks, coins and SpecAugment numbers the JAX step
draws from its key."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu.models import las as jlas
from attention_based_e2e_asr_dnn_tpu.training import optim as joptim
from attention_based_e2e_asr_dnn_tpu.training import steps as jsteps
from attention_based_e2e_asr_dnn_tpu_torch.data.specaug import SpecAugDraws
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.training import optim as toptim
from attention_based_e2e_asr_dnn_tpu_torch.training import steps as tsteps

torch.set_num_threads(1)

ATOL_F32 = 2e-5  # the same float32 arithmetic in another order

# The JAX side runs lstm_impl: scan (in float32 its two routes agree,
# tests/test_pallas_lstm.py, and the scan route spares the interpret-mode
# compile); the port runs lstm_impl: pallas, i.e. the autograd Functions over
# the kernels' plain versions. test_torch_train_lstm.py holds those to the
# Pallas route itself.
CFG = jlas.LASConfig(
    listener=jlas.ListenerConfig(input_dim=15, uniform_hid_dim=32, lstm_layers=1,
                                 plstm_layers=2, init_dropout=0.3, mid_dropout=0.3,
                                 final_dropout=0.35, lstm_impl="scan"),
    speller=jlas.SpellerConfig(enc_out_dim=64, att_proj_dim=16, att_heads=2,
                               dec_emb_dim=32, dec_lstm_hid_dim=32,
                               dec_lstm_out_dim=16, dec_lstm_dropout=0.3,
                               CHR_MAX_STEPS=12),
)
NO_DROPOUT = dataclasses.replace(
    CFG, listener=dataclasses.replace(CFG.listener, init_dropout=0.0, mid_dropout=0.0,
                                      final_dropout=0.0),
    speller=dataclasses.replace(CFG.speller, dec_lstm_dropout=0.0))
B, T, L = 6, 24, 9
LX = np.array([24, 17, 4, 20, 24, 9], np.int32)   # 4 frames: length 1 after the pyramid
LY = np.array([9, 6, 1, 7, 9, 3], np.int32)


def _port_cfg(cfg, lstm_impl="pallas"):
    listener = {**dataclasses.asdict(cfg.listener), "lstm_impl": lstm_impl}
    return tlas.LASConfig(listener=tlas.ListenerConfig(**listener),
                          speller=tlas.SpellerConfig(**dataclasses.asdict(cfg.speller)))


def _params(cfg, seed=0):
    params = jax.tree.map(np.asarray, jlas.las_init(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    for key in ("init_h1", "init_c1", "init_h2", "init_c2"):
        params["speller"][key] = rng.uniform(-0.5, 0.5, params["speller"][key].shape
                                             ).astype(np.float32)
    return params


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, 15)).astype(np.float32)
    x[np.arange(T)[None, :] >= LX[:, None]] = 0.0
    y = rng.integers(1, 29, (B, L)).astype(np.int32)
    y[np.arange(L)[None, :] >= LY[:, None]] = 29
    return x, y


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# Replaying the JAX draws
# ---------------------------------------------------------------------------

def replay_las_draws(model_rng, cfg, batch, steps, specaug=None) -> tlas.TrainDraws:
    """The draws of ``las_apply(train=True)`` under ``model_rng``, by the
    JAX package's own key splits (las.py:425, :151; ops/lstm.py:255, :329;
    dropout.py:20; las.py:306-309, :349-355)."""
    lc, sc = cfg.listener, cfg.speller
    rng_listen, rng_spell = jax.random.split(model_rng)
    rng_base, rng_pyr = jax.random.split(rng_listen)
    masks = []

    def stack(rng, rates):
        for rate in rates:
            if rate > 0.0:
                rng, sub = jax.random.split(rng)
                masks.append(np.asarray(jax.random.bernoulli(
                    sub, 1.0 - rate, (batch, 1, lc.enc_out_dim))))
            else:
                masks.append(None)

    stack(rng_base, [lc.mid_dropout if i else lc.init_dropout
                     for i in range(lc.lstm_layers)])
    stack(rng_pyr, [lc.mid_dropout if i < lc.plstm_layers - 1 else lc.final_dropout
                    for i in range(lc.plstm_layers)])
    _, coin_rng, drop_rng = jax.random.split(rng_spell, 3)
    coins = np.asarray(jax.random.uniform(coin_rng, (steps,)))
    m1 = m2 = None
    if sc.dec_lstm_dropout > 0.0:
        keep = 1.0 - sc.dec_lstm_dropout
        pairs = [jax.random.split(k) for k in jax.random.split(drop_rng, steps)]
        m1 = np.stack([np.asarray(jax.random.bernoulli(
            r1, keep, (batch, sc.dec_lstm_hid_dim))) for r1, _ in pairs])
        m2 = np.stack([np.asarray(jax.random.bernoulli(
            r2, keep, (batch, sc.dec_lstm_out_dim))) for _, r2 in pairs])
    as_t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    return tlas.TrainDraws([as_t(m) for m in masks], as_t(coins), as_t(m1), as_t(m2),
                           specaug)


def replay_train_draws(state_rng, cfg, batch, steps, use_specaug, freq=6, time=200):
    """The draws of one ``make_train_step`` step under ``state_rng``
    (steps.py:103; specaug.py:23-25, :40). Returns (next state key, draws)."""
    rng, aug_rng, model_rng = jax.random.split(state_rng, 3)
    spec = None
    if use_specaug:
        def axis(k, param):
            k_w, k_s = jax.random.split(k)
            return (jax.random.uniform(k_w, (1,), minval=0.0, maxval=float(param)),
                    jax.random.uniform(k_s, (1,)))

        k_f, k_t = jax.random.split(aug_rng)
        spec = SpecAugDraws(*(torch.from_numpy(np.array(a))
                              for a in (*axis(k_f, freq), *axis(k_t, time))))
    return rng, replay_las_draws(model_rng, cfg, batch, steps, spec)


# ---------------------------------------------------------------------------
# Dropout and SpecAugment with replayed draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["locked", "elementwise"])
def test_dropout_matches_jax_with_replayed_mask(kind):
    import importlib

    from attention_based_e2e_asr_dnn_tpu_torch.ops import dropout as tdrop

    # the JAX package's ``ops`` re-exports a function of the same name
    jdrop = importlib.import_module("attention_based_e2e_asr_dnn_tpu.ops.dropout")

    x = np.random.default_rng(0).standard_normal((4, 6, 10)).astype(np.float32)
    key, rate = jax.random.key(3), 0.3
    j_fn, t_fn = ((jdrop.locked_dropout, tdrop.locked_dropout) if kind == "locked"
                  else (jdrop.dropout, tdrop.dropout))
    shape = (4, 1, 10) if kind == "locked" else x.shape
    mask = np.array(jax.random.bernoulli(key, 1.0 - rate, shape))
    ref = np.asarray(j_fn(key, jnp.asarray(x), rate, True))
    ours = t_fn(torch.from_numpy(x), rate, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6)
    assert t_fn(torch.from_numpy(x), 0.0) is not None and \
        torch.equal(t_fn(torch.from_numpy(x), 0.0), torch.from_numpy(x))
    # drawn from a generator: the rate holds and kept values are scaled
    drawn = t_fn(torch.ones(64, 5, 200), rate, generator=torch.Generator().manual_seed(0))
    kept = drawn != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.03
    torch.testing.assert_close(drawn[kept], torch.full_like(drawn[kept], 1 / 0.7))
    if kind == "locked":  # one mask for every frame
        assert torch.equal(kept[:, 0], kept[:, 4])


@pytest.mark.parametrize("iid", [False, True])
def test_specaugment_matches_jax_with_replayed_draws(iid):
    from attention_based_e2e_asr_dnn_tpu.data import specaug as jspec
    from attention_based_e2e_asr_dnn_tpu_torch.data import specaug as tspec

    x = np.random.default_rng(1).standard_normal((B, 40, 15)).astype(np.float32) + 3.0
    key = jax.random.key(11)
    ref = np.asarray(jspec.specaugment(key, jnp.asarray(x), 6, 20, iid))
    shape = (B,) if iid else (1,)
    draws = []
    for k, param in zip(jax.random.split(key), (6, 20)):
        k_w, k_s = jax.random.split(k)
        draws += [jax.random.uniform(k_w, shape, minval=0.0, maxval=float(param)),
                  jax.random.uniform(k_s, shape)]
    ours = tspec.specaugment(torch.from_numpy(x), tspec.SpecAugDraws(
        *(torch.from_numpy(np.array(d)) for d in draws)))
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert (ref == 0).any()   # something was masked
    drawn = tspec.draw_specaug(B, 6, 20, iid, torch.Generator().manual_seed(0), "cpu")
    assert all(d.shape == shape for d in drawn)
    assert float(drawn.freq_width.max()) < 6 and float(drawn.time_width.max()) < 20


# ---------------------------------------------------------------------------
# The teacher-forced speller and the training las_apply
# ---------------------------------------------------------------------------

CASES = {
    # name: (config, tf_rate, init_force)
    "no-dropout-tf1": (NO_DROPOUT, 1.0, False),
    "coins-tf0.5": (NO_DROPOUT, 0.5, False),
    "dropout-masks": (CFG, 0.5, False),
    "init-force": (NO_DROPOUT, 0.9, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_training_las_apply_matches_jax(case):
    cfg, tf_rate, init_force = CASES[case]
    params = _params(cfg)
    x, y = _batch()
    key = jax.random.key(5)
    ref = jlas.las_apply(_jax(params), cfg, key, jnp.asarray(x), jnp.asarray(LX),
                         dec_y=jnp.asarray(y), tf_rate=tf_rate, init_force=init_force,
                         train=True)
    draws = replay_las_draws(key, cfg, B, L)
    if case == "coins-tf0.5":  # the coins must split the steps, or the case is idle
        forced = draws.coins[1:] <= tf_rate
        assert forced.any() and not forced.all()
    out = tlas.las_apply(tlas.las_from_jax_params(params), _port_cfg(cfg),
                         torch.from_numpy(x), torch.from_numpy(LX),
                         dec_y=torch.from_numpy(y), tf_rate=tf_rate,
                         init_force=init_force, train=True, draws=draws)
    assert out.logits.shape == (B, L, 30) and out.att_map.shape == (2, T // 4, L + 1)
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(ref.logits),
                               atol=ATOL_F32 * 5)  # logits of magnitude ~5
    np.testing.assert_allclose(out.att_map.detach().numpy(), np.asarray(ref.att_map),
                               atol=ATOL_F32)


def test_training_speller_without_draws_has_no_forcing_or_dropout():
    """No key in the JAX package, no draws here: neither teacher forcing nor
    dropout, whatever the config's rates."""
    params = _params(CFG)
    rng = np.random.default_rng(1)
    enc_l = np.array([6, 4, 1, 5, 6, 2], np.int32)
    enc = rng.standard_normal((B, 6, 64)).astype(np.float32)
    _, y = _batch()
    ref = jlas.speller_apply(_jax(params["speller"]), CFG.speller, None, jnp.asarray(enc),
                             jnp.asarray(enc_l), dec_y=jnp.asarray(y), tf_rate=1.0,
                             train=True)
    out = tlas.speller_apply(tlas.las_from_jax_params(params)["speller"],
                             _port_cfg(CFG).speller, torch.from_numpy(enc),
                             torch.from_numpy(enc_l), dec_y=torch.from_numpy(y),
                             tf_rate=1.0, train=True)
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(ref.logits),
                               atol=ATOL_F32 * 5)


def test_training_with_fused_decoder_raises():
    """``decoder_impl: pallas`` trains (test_torch_speller_train.py holds that
    route to the JAX package); what still raises is training without labels,
    which the JAX package hands to the scan decoder to refuse
    (models/las.py:275-276, :290-291)."""
    cfg = _port_cfg(NO_DROPOUT)
    cfg = dataclasses.replace(cfg, speller=dataclasses.replace(cfg.speller,
                                                               decoder_impl="pallas"))
    x, y = _batch()
    module = tlas.las_from_jax_params(_params(NO_DROPOUT))
    with pytest.raises(ValueError, match="training decode requires dec_y"):
        tlas.las_apply(module, cfg, torch.from_numpy(x), torch.from_numpy(LX), train=True)
    out = tlas.las_apply(module, cfg, torch.from_numpy(x), torch.from_numpy(LX),
                         dec_y=torch.from_numpy(y), train=True)
    assert out.logits.shape == (B, L, 30) and out.logits.requires_grad


def test_drawn_noise_has_the_replayed_layout():
    """``draw_train_noise`` yields the record the replay yields: same fields,
    shapes and dtypes, rates respected within sampling error."""
    gen = torch.Generator().manual_seed(0)
    drawn = tlas.draw_train_noise(_port_cfg(CFG), B, L, gen, "cpu")
    replayed = replay_las_draws(jax.random.key(0), CFG, B, L)
    assert len(drawn.listener_masks) == len(replayed.listener_masks) == 3
    for a, b in zip(drawn.listener_masks + [drawn.coins, drawn.m1, drawn.m2],
                    replayed.listener_masks + [replayed.coins, replayed.m1, replayed.m2]):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert abs(drawn.m1.float().mean().item() - 0.7) < 0.05
    none = tlas.draw_train_noise(_port_cfg(NO_DROPOUT), B, L, gen, "cpu")
    assert none.listener_masks == [None] * 3 and none.m1 is None and none.m2 is None


# ---------------------------------------------------------------------------
# Whole train steps
# ---------------------------------------------------------------------------

OPT_CONFIGS = {"lr": 1e-3, "weight_decay": 5e-6, "amsgrad": True}


def _jax_step_fn(cfg, grad_norm):
    tx = joptim.build_optimizer("adamw", OPT_CONFIGS, grad_norm=grad_norm)

    def apply_fn(p, rng, x, lx, dec_y=None, tf_rate=1.0, init_force=False, train=False):
        return jlas.las_apply(p, cfg, rng, x, lx, dec_y, tf_rate, init_force, train)

    return tx, jsteps.make_train_step(apply_fn, tx, use_specaug=True, specaug_time=10,
                                      donate=False)


def _port_step_fn(cfg, grad_norm):
    opt = toptim.build_optimizer("adamw", OPT_CONFIGS, grad_norm=grad_norm)
    t_cfg = _port_cfg(cfg)

    def apply_fn(p, x, lx, **kwargs):
        return tlas.las_apply(p, t_cfg, x, lx, **kwargs)

    return opt, tsteps.make_train_step(apply_fn, opt, use_specaug=True, specaug_time=10)


def _amsgrad_state(opt_state):
    """The ScaleByAmsgradState inside the injected, chained optax state."""
    found = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda n: hasattr(n, "nu_max")) if hasattr(s, "nu_max")]
    assert len(found) == 1
    return found[0]


def _assert_state_matches(state, j_state, atol, rtol):
    ours = tlas.las_to_jax_params(state.params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                            jax.tree.leaves(jax.tree.map(np.asarray, j_state.params))):
        if "key_map" in str(path) and "'b'" in str(path):
            # A shift of every key by one vector moves all scores of a query
            # alike and the softmax ignores it: this gradient is zero but for
            # rounding, and Adam scales that rounding noise to steps of the
            # order of lr. Only the bound of such steps can be held.
            np.testing.assert_allclose(a, b, atol=2 * OPT_CONFIGS["lr"] * int(state.step),
                                       err_msg=str(path))
            continue
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=str(path))
    ams = _amsgrad_state(j_state.opt_state)
    got = toptim.opt_state_to_optax(state.params, state.opt_state)
    assert got["count"] == int(ams.count)
    for name in ("mu", "nu", "nu_max"):
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got[name]),
                                jax.tree.leaves(jax.tree.map(np.asarray, getattr(ams, name)))):
            np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=f"{name} {path}")


# grad_norm 5.0: the clip is idle (the toy gradient's norm is below it);
# 0.05: the clip is active on every step
@pytest.mark.parametrize("clip", [5.0, 0.05])
def test_two_train_steps_match_jax(clip):
    """Two whole steps, SpecAugment, dropout and coins replayed, AdamW with
    amsgrad: loss, grad_norm, every parameter and every optimizer leaf.
    float32, atol 1e-5 / rtol 1e-4 (summation order through 24 frames and 9
    decoder steps, then Adam's division by a small sqrt(nu))."""
    params = _params(CFG)
    x, y = _batch()
    tx, j_step = _jax_step_fn(CFG, clip)
    j_state = jsteps.create_train_state(_jax(params), tx, jax.random.key(1))
    opt, t_step = _port_step_fn(CFG, clip)
    state = tsteps.create_train_state(tlas.las_from_jax_params(params), opt, device="cpu")
    # both optimizers start from one (zero) state, carried across the bridge
    ams = _amsgrad_state(j_state.opt_state)
    state.opt_state = toptim.opt_state_from_optax(
        state.params, ams.count, *(jax.tree.map(np.asarray, t) for t in
                                   (ams.mu, ams.nu, ams.nu_max)))
    tx_, lx_, y_, ly_ = (torch.from_numpy(a) for a in (x, LX, y, LY))
    for n in range(2):
        key, draws = replay_train_draws(j_state.rng, CFG, B, L, use_specaug=True, time=10)
        j_state, j_metrics, j_att = j_step(j_state, jnp.asarray(x), jnp.asarray(LX),
                                           jnp.asarray(y), jnp.asarray(LY), 0.5, 1e-3)
        state, metrics, att = t_step(state, tx_, lx_, y_, ly_, 0.5, 1e-3, draws=draws)
        assert bool(metrics["finite"]) and bool(j_metrics["finite"])
        assert (float(j_metrics["grad_norm"]) < clip) == (clip == 5.0)
        for name in ("loss", "ppl", "grad_norm", "n_tokens"):
            np.testing.assert_allclose(float(metrics[name]), float(j_metrics[name]),
                                       atol=1e-5, rtol=1e-4, err_msg=f"step {n} {name}")
        np.testing.assert_allclose(att.numpy(), np.asarray(j_att), atol=ATOL_F32)
        _assert_state_matches(state, j_state, atol=1e-5, rtol=1e-4)
    assert state.step == 2


def test_nan_step_is_a_no_op():
    """A NaN planted in x: ``finite`` is False and neither a parameter nor an
    optimizer leaf (the count included) moves, after a good step has made
    the moments non-zero."""
    params = _params(CFG)
    x, y = _batch()
    opt, t_step = _port_step_fn(CFG, 5.0)
    state = tsteps.create_train_state(tlas.las_from_jax_params(params), opt, seed=3,
                                      device="cpu")
    args = [torch.from_numpy(a) for a in (LX, y, LY)]
    state, metrics, _ = t_step(state, torch.from_numpy(x), *args, 0.9, 1e-3)
    assert bool(metrics["finite"]) and int(state.opt_state.count) == 1
    before_p = [p.detach().clone() for p in state.params.parameters()]
    before_s = toptim.opt_state_to_optax(state.params, state.opt_state)
    bad = x.copy()
    bad[0, 0, 0] = np.nan
    state, metrics, _ = t_step(state, torch.from_numpy(bad), *args, 0.9, 1e-3)
    assert not bool(metrics["finite"])
    for p, q in zip(state.params.parameters(), before_p):
        assert torch.equal(p, q)
    after_s = toptim.opt_state_to_optax(state.params, state.opt_state)
    assert after_s["count"] == before_s["count"] == 1
    for name in ("mu", "nu", "nu_max"):
        for a, b in zip(jax.tree.leaves(after_s[name]), jax.tree.leaves(before_s[name])):
            np.testing.assert_array_equal(a, b)
    # and the next good step moves them again
    state, metrics, _ = t_step(state, torch.from_numpy(x), *args, 0.9, 1e-3)
    assert bool(metrics["finite"]) and int(state.opt_state.count) == 2


def test_train_state_defaults_to_the_card():
    opt = toptim.build_optimizer("sgd", {"lr": 0.1})
    module = tlas.las_from_jax_params(_params(NO_DROPOUT))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsteps.create_train_state(module, opt)
    assert tsteps.create_train_state(module, opt, device="cpu").generator.device.type == "cpu"


def test_accum_steps_must_match_the_optimizer():
    with pytest.raises(ValueError, match="accum_steps 2 differs"):
        tsteps.make_train_step(None, toptim.build_optimizer("adam", {}), accum_steps=2)
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        toptim.build_optimizer("adam", {}, accum_steps=0)


def test_accumulating_train_steps_match_jax():
    """``accum_steps=2`` (optax.MultiSteps): three steps, so one emitting
    step between two accumulating ones; parameters move only on the second
    and agree with the JAX step; the inner count goes 0, 1, 1."""
    params = _params(NO_DROPOUT)
    x, y = _batch()
    tx = joptim.build_optimizer("adamw", OPT_CONFIGS, grad_norm=5.0, accum_steps=2)

    def j_apply(p, rng, x, lx, dec_y=None, tf_rate=1.0, init_force=False, train=False):
        return jlas.las_apply(p, NO_DROPOUT, rng, x, lx, dec_y, tf_rate, init_force, train)

    j_step = jsteps.make_train_step(j_apply, tx, accum_steps=2, donate=False)
    j_state = jsteps.create_train_state(_jax(params), tx, jax.random.key(2))
    opt = toptim.build_optimizer("adamw", OPT_CONFIGS, grad_norm=5.0, accum_steps=2)
    t_cfg = _port_cfg(NO_DROPOUT)
    t_step = tsteps.make_train_step(lambda p, x, lx, **kw: tlas.las_apply(p, t_cfg, x, lx, **kw),
                                    opt, accum_steps=2)
    state = tsteps.create_train_state(tlas.las_from_jax_params(params), opt, device="cpu")
    args = [torch.from_numpy(a) for a in (x, LX, y, LY)]
    for n, count in enumerate([0, 1, 1]):
        before = [p.detach().clone() for p in state.params.parameters()]
        key, draws = replay_train_draws(j_state.rng, NO_DROPOUT, B, L, use_specaug=False)
        j_state, j_metrics, _ = j_step(j_state, jnp.asarray(x), jnp.asarray(LX),
                                       jnp.asarray(y), jnp.asarray(LY), 0.5, 1e-3)
        state, metrics, _ = t_step(state, *args, 0.5, 1e-3, draws=draws)
        moved = any(not torch.equal(p, q) for p, q in zip(state.params.parameters(), before))
        assert moved == (n == 1) and int(state.opt_state.count) == count
        assert int(state.opt_state.mini_step) == (n + 1) % 2
        np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]),
                                   atol=1e-5, rtol=1e-4)
        ours = tlas.las_to_jax_params(state.params)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                                jax.tree.leaves(jax.tree.map(np.asarray, j_state.params))):
            tol = 2 * OPT_CONFIGS["lr"] if "key_map" in str(path) and "'b'" in str(path) else 1e-5
            np.testing.assert_allclose(a, b, atol=tol, rtol=1e-4, err_msg=f"step {n} {path}")
