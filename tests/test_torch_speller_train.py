"""PyTorch port, the fused decoder in training: the plain versions of the
training-form decode kernel and of its adjoint kernel (what the wrappers run
for CPU tensors), the autograd Function that joins them, the training
``speller_apply_fused`` and whole train steps with ``decoder_impl: pallas``,
against the JAX package's fused decode kernels in interpret mode, at toy
sizes, with the JAX package's random draws replayed. The kernels themselves
are tested on the card by test_torch_speller_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_las as ttl
from attention_based_e2e_asr_dnn_tpu.models import las as jlas
from attention_based_e2e_asr_dnn_tpu.ops import speller_pallas as jsp
from attention_based_e2e_asr_dnn_tpu.training import loss as jloss
from attention_based_e2e_asr_dnn_tpu.training import steps as jsteps
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
from attention_based_e2e_asr_dnn_tpu_torch.training import loss as tloss
from attention_based_e2e_asr_dnn_tpu_torch.training import optim as toptim
from attention_based_e2e_asr_dnn_tpu_torch.training import steps as tsteps

torch.set_num_threads(1)

# float32: the same float32 arithmetic in another order (the JAX package's
# fused-vs-scan tolerance, tests/test_speller_pallas.py)
ATOL_F32 = 2e-5
# the shapes of tests/test_speller_pallas.py::_setup
B, TE, L, P, H1, H2, VP, V = 3, 11, 6, 16, 20, 12, 32, 30
NAMES = ("k", "v", "bias", "ctx0", "h10", "c10", "h20", "c20", "embw1", "wc1", "whh1",
         "wih2", "whh2", "b2", "wq", "bq", "wcls", "clsb")


def _bf16_steps(ref: np.ndarray, n: int) -> float:
    """``n`` bf16 rounding steps at the magnitude of the largest |ref|."""
    return n * 2.0 ** (np.floor(np.log2(max(np.abs(ref).max(), 1e-30))) - 7)


def _case(seed, heads, tf_rate, drop, dims=(B, TE, L, P, H1, H2)):
    """Operands, forced ids, masks and cotangents from a numpy seed, float32."""
    batch, te, steps, proj, h1, h2 = dims
    rng = np.random.default_rng(seed)

    def u(*shape, k=0.3):
        return rng.uniform(-k, k, shape).astype(np.float32)

    enc_l = rng.integers(te // 2, te + 1, batch)
    enc_l[-1] = 1
    bias = np.where(np.arange(te)[None] >= enc_l[:, None], jsp.NEG, 0.0).astype(np.float32)
    wcls = np.zeros((2 * proj, VP), np.float32)
    wcls[:, :V] = rng.standard_normal((2 * proj, V)) * 0.5
    clsb = np.full(VP, jsp.NEG, np.float32)
    clsb[:V] = u(V)
    ops = {"k": u(batch, te, proj, k=1), "v": u(batch, te, proj, k=1), "bias": bias,
           "ctx0": u(batch, proj), "h10": u(batch, h1), "c10": u(batch, h1),
           "h20": u(batch, h2), "c20": u(batch, h2), "embw1": u(VP, 4 * h1),
           "wc1": u(proj, 4 * h1), "whh1": u(h1, 4 * h1), "wih2": u(h1, 4 * h2),
           "whh2": u(h2, 4 * h2), "b2": u(4 * h2), "wq": u(h2, proj), "bq": u(proj),
           "wcls": wcls, "clsb": clsb}
    coins = rng.permutation(np.linspace(0.05, 0.95, steps))  # forced and free steps mix
    coins[0] = 2.0
    gold = rng.integers(0, V, (steps, batch)).astype(np.int32)
    forced = np.where((coins <= tf_rate)[:, None], gold, -1).astype(np.int32)
    m1 = m2 = None
    if drop > 0.0:
        m1 = (rng.uniform(0, 1, (steps, batch, h1)) < 1 - drop).astype(np.float32) / (1 - drop)
        m2 = (rng.uniform(0, 1, (steps, batch, h2)) < 1 - drop).astype(np.float32) / (1 - drop)
    d_logits = np.zeros((steps, batch, VP), np.float32)
    d_logits[..., :V] = rng.standard_normal((steps, batch, V)) * 0.1
    d_wgts = (rng.standard_normal((steps, batch, heads, te)) * 0.1).astype(np.float32)
    return ops, forced, m1, m2, d_logits, d_wgts


def _jax_args(ops, forced, m1, m2, heads, dtype):
    """(static, the 18 operands, gold, m1, m2) as ``fused_decode`` takes them."""
    batch, _, proj = ops["k"].shape
    j = {n: jnp.asarray(a).astype(dtype) for n, a in ops.items()}
    for n in ("b2", "bq", "clsb"):
        j[n] = j[n][None]
    drop = m1 is not None
    static = (heads, float(1 / np.sqrt(proj // heads)), 0, drop, batch,
              jsp._pick_te_chunk(ops["k"].shape[1]), True)
    ones = lambda h: jnp.ones((1, batch, h), dtype)  # noqa: E731
    return (static, list(j.values()), jnp.asarray(forced.astype(np.float32))[..., None],
            jnp.asarray(m1).astype(dtype) if drop else ones(ops["whh1"].shape[0]),
            jnp.asarray(m2).astype(dtype) if drop else ones(ops["whh2"].shape[0]))


def _port_args(ops, forced, m1, m2, heads, dtype, grad=True):
    t = [torch.from_numpy(ops[n]).to(dtype) for n in NAMES]
    if grad:
        t = [x.requires_grad_(n != "bias") for n, x in zip(NAMES, t)]
    proj = ops["k"].shape[2]
    opts = {"heads": heads, "scale": float(1 / np.sqrt(proj // heads)), "sos_idx": 0,
            "steps": forced.shape[0], "forced": torch.from_numpy(forced),
            "m1": None if m1 is None else torch.from_numpy(m1).to(dtype),
            "m2": None if m2 is None else torch.from_numpy(m2).to(dtype)}
    return t, opts


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else \
        x.detach().float().numpy()


# ---------------------------------------------------------------------------
# The kernels' plain versions and the Function against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_train_forward_streams_match_pallas_kernel(heads, drop):
    """Logits, weights and all eight residual streams of the training form
    against ``_decode_fwd_kernel(save_residuals=True)`` in interpret mode."""
    ops, forced, m1, m2, _, _ = _case(heads, heads, 0.55, drop)
    assert (forced[1:] >= 0).any() and (forced[1:] < 0).any()
    static, j_ops, gold, jm1, jm2 = _jax_args(ops, forced, m1, m2, heads, jnp.float32)
    ref = jsp._fused_forward(static, *j_ops, gold, jm1, jm2)
    t_ops, opts = _port_args(ops, forced, m1, m2, heads, torch.float32, grad=False)
    logits, wgts, ids, saved = sc.speller_decode_train(*t_ops, **opts)
    np.testing.assert_allclose(_np(logits)[..., :V], _np(ref[0])[..., :V], atol=ATOL_F32)
    np.testing.assert_allclose(_np(wgts), np.stack([_np(w) for w in ref[9:]], 2),
                               atol=ATOL_F32)
    assert dict(zip(sc.RESIDUALS, saved)).keys() == set(sc.RESIDUALS)
    # the fed id stands for the Pallas kernel's one-hot
    np.testing.assert_array_equal(saved[0].numpy(), _np(ref[1]).argmax(-1))
    assert saved[0].dtype == torch.int32 and np.all(_np(ref[1]).sum(-1) == 1.0)
    for name, got, want in zip(sc.RESIDUALS[1:], saved[1:], ref[2:9]):
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL_F32, err_msg=name)
    # step t's fed-back id is step t + 1's input where it is not forced
    free = forced[1:] < 0
    np.testing.assert_array_equal(saved[0].numpy()[1:][free], ids.numpy()[:-1][free])


def test_train_form_without_masks_equals_eval_form():
    ops, forced, _, _, _, _ = _case(3, 2, 0.0, 0.0)
    t_ops, opts = _port_args(ops, forced, None, None, 2, torch.float32, grad=False)
    train = sc.speller_decode_train(*t_ops, **opts)
    del opts["m1"], opts["m2"]
    lean = sc.speller_decode(*t_ops, **opts)
    for a, b in zip(train[:3], lean):
        assert torch.equal(a, b)


GRAD_CASES = {
    # name: (heads, tf_rate, dropout, a cotangent on the weights)
    "h1-tf1.0": (1, 1.0, 0.0, False),
    "h1-tf0.55-drop": (1, 0.55, 0.3, False),
    "h1-tf0.0-dw": (1, 0.0, 0.0, True),
    "h2-tf1.0-drop-dw": (2, 1.0, 0.3, True),
    "h2-tf0.55": (2, 0.55, 0.0, False),
    "h2-tf0.55-drop-dw": (2, 0.55, 0.3, True),
    "h2-tf0.0-drop": (2, 0.0, 0.3, False),
}


def _both_vjps(case, dtype, dims=(B, TE, L, P, H1, H2)):
    heads, tf_rate, drop, with_dw = case
    ops, forced, m1, m2, d_logits, d_wgts = _case(7 * heads + int(10 * tf_rate), heads,
                                                  tf_rate, drop, dims)
    static, j_ops, gold, jm1, jm2 = _jax_args(ops, forced, m1, m2, heads, jnp.dtype(dtype))
    (ref_logits, ref_wgts), vjp = jax.vjp(
        lambda *o: jsp.fused_decode(static, *o, gold, jm1, jm2), *j_ops)
    jd = jnp.dtype(dtype)
    ref_grads = vjp((jnp.asarray(d_logits).astype(jd),
                     jnp.asarray(d_wgts if with_dw else 0 * d_wgts).astype(jd)))
    tdt = getattr(torch, dtype)
    t_ops, opts = _port_args(ops, forced, m1, m2, heads, tdt)
    logits, wgts = sc.fused_decode(t_ops, **opts)
    outs, cots = [logits], [torch.from_numpy(d_logits).to(tdt)]
    if with_dw:
        outs.append(wgts)
        cots.append(torch.from_numpy(d_wgts).to(tdt))
    leaves = [x for x in t_ops if x.requires_grad]
    grads = torch.autograd.grad(outs, leaves, cots)
    got = dict(zip([n for n in NAMES if n != "bias"], grads))
    want = {n: g.reshape(ops[n].shape) for n, g in zip(NAMES, ref_grads) if n != "bias"}
    return (logits, wgts), (ref_logits, ref_wgts), got, want


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_function_matches_pallas_vjp(case):
    """The Function on the CPU (the plain versions of both kernels and the
    products around them) against ``fused_decode``'s VJP in interpret mode:
    the outputs and every operand's gradient, float32."""
    (logits, wgts), (ref_logits, ref_wgts), got, want = _both_vjps(GRAD_CASES[case], "float32")
    np.testing.assert_allclose(_np(logits)[..., :V], _np(ref_logits)[..., :V], atol=ATOL_F32)
    np.testing.assert_allclose(_np(wgts), _np(ref_wgts), atol=ATOL_F32)
    assert set(got) == set(want) and len(got) == 17
    for name in got:
        assert np.abs(_np(want[name])).max() > 1e-3, name  # a live gradient
        np.testing.assert_allclose(_np(got[name]), _np(want[name]), atol=ATOL_F32,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["h1-tf0.55-drop", "h2-tf0.55-drop-dw"])
def test_function_matches_pallas_vjp_bfloat16(case):
    """bfloat16: both sides round the same float32 values at the same places
    (streams, dot operands, results), so a gradient differs where a sum taken
    in another order flips a rounding and the flip is carried down the
    recurrence: four bf16 steps of each gradient's largest entry."""
    (logits, wgts), (ref_logits, ref_wgts), got, want = _both_vjps(GRAD_CASES[case], "bfloat16")
    np.testing.assert_allclose(_np(logits)[..., :V], _np(ref_logits)[..., :V],
                               atol=_bf16_steps(_np(ref_logits)[..., :V], 1))
    np.testing.assert_allclose(_np(wgts), _np(ref_wgts), atol=2.0 ** -8)
    for name in got:
        assert got[name].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                   atol=_bf16_steps(_np(want[name]), 4), err_msg=name)


def test_function_matches_pallas_vjp_scaled_dims():
    """The scaled arch's decoder widths (tests/test_speller_pallas.py:340:
    H1 1024, 4 heads of 64), where a gradient sums over far more terms:
    float32 within 1e-4 of each gradient's largest entry."""
    dims = (4, 16, 3, 256, 1024, 256)
    (logits, _), (ref_logits, _), got, want = _both_vjps((4, 0.55, 0.0, True), "float32", dims)
    np.testing.assert_allclose(_np(logits)[..., :V], _np(ref_logits)[..., :V], atol=1e-4)
    for name in got:
        ref = _np(want[name])
        np.testing.assert_allclose(_np(got[name]), ref, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


def test_function_matches_pallas_vjp_widened_dims():
    """A decoder width the bfloat16 kernels take since their widening (H1
    128, H2 256: one cell-1 unit a block in the forward, the cell-2 units
    on twice as many groups as the cell-1 ones in the adjoint), in bfloat16
    with dropout and a cotangent on the weights: four bf16 steps of each
    gradient's largest entry, as the narrow case above."""
    dims = (3, 16, 4, 64, 128, 256)
    (logits, _), (ref_logits, _), got, want = _both_vjps((2, 0.55, 0.3, True), "bfloat16", dims)
    np.testing.assert_allclose(_np(logits)[..., :V], _np(ref_logits)[..., :V],
                               atol=_bf16_steps(_np(ref_logits)[..., :V], 1))
    assert len(got) == 17
    for name in got:
        np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                   atol=_bf16_steps(_np(want[name]), 4), err_msg=name)


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_plain_adjoint_equals_autograd_through_plain_forward(drop):
    """The explicit adjoint (``speller_decode_bwd_plain`` and the Function's
    products) against autograd through the step-by-step forward, float32,
    where nothing is rounded."""
    heads = 2
    ops, forced, m1, m2, d_logits, d_wgts = _case(11, heads, 0.55, drop)
    cots = [torch.from_numpy(d_logits), torch.from_numpy(d_wgts)]
    t_ops, opts = _port_args(ops, forced, m1, m2, heads, torch.float32)
    leaves = [x for x in t_ops if x.requires_grad]
    got = torch.autograd.grad(sc.fused_decode(t_ops, **opts), leaves, cots)
    want = torch.autograd.grad(sc.speller_decode_train_plain(*t_ops, **opts)[:2], leaves, cots)
    for name, a, b in zip([n for n in NAMES if n != "bias"], got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL_F32, err_msg=name)


def test_fused_decode_stays_on_the_eval_form_without_a_gradient(monkeypatch):
    ops, forced, m1, m2, _, _ = _case(5, 1, 0.55, 0.3)
    t_ops, opts = _port_args(ops, forced, m1, m2, 1, torch.float32, grad=False)
    calls = []
    for name in ("speller_decode", "speller_decode_train"):
        monkeypatch.setattr(sc, name, lambda *a, _f=getattr(sc, name), _n=name, **k:
                            (calls.append(_n), _f(*a, **k))[1])
    with_masks = sc.fused_decode(t_ops, **opts)
    no_masks = sc.fused_decode(t_ops, **{**opts, "m1": None, "m2": None})
    assert calls == ["speller_decode_train", "speller_decode"]
    assert not torch.equal(with_masks[0], no_masks[0])
    with torch.no_grad():  # leaves that want a gradient, but none is recorded
        sc.fused_decode([x.clone().requires_grad_(x.is_floating_point()) for x in t_ops],
                        **{**opts, "m1": None, "m2": None})
    assert calls[-1] == "speller_decode"


# ---------------------------------------------------------------------------
# The training speller and whole train steps
# ---------------------------------------------------------------------------

def _fused(cfg, impl="pallas"):
    return dataclasses.replace(cfg, speller=dataclasses.replace(cfg.speller,
                                                                decoder_impl=impl))


def _speller_case(cfg, seed=1):
    params = ttl._params(cfg)
    rng = np.random.default_rng(seed)
    enc_l = np.array([6, 4, 1, 5, 6, 2], np.int32)
    enc = rng.standard_normal((ttl.B, 6, 64)).astype(np.float32)
    _, y = ttl._batch()
    return params, enc, enc_l, y


@pytest.mark.parametrize("case", ["no-dropout-tf1", "coins-tf0.5", "dropout-masks"])
def test_training_speller_apply_fused_matches_jax(case):
    """``speller_apply`` with ``decoder_impl: pallas`` in training against the
    JAX ``speller_apply_fused`` in interpret mode, the draws replayed: the
    logits, the attention map, and the gradients of the masked CE in every
    speller parameter and in the encoder output."""
    cfg, tf_rate, _ = ttl.CASES[case]
    params, enc, enc_l, y = _speller_case(cfg)
    key = jax.random.key(5)
    ly = jnp.asarray(ttl.LY)

    def j_loss(p, eh):
        out = jsp.speller_apply_fused(p, cfg.speller, key, eh, jnp.asarray(enc_l),
                                      jnp.asarray(y), tf_rate, True, interpret=True)
        return jloss.masked_ce_loss(out.logits, jnp.asarray(y), ly)[0], out

    (_, ref), (ref_gp, ref_ge) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        ttl._jax(params["speller"]), jnp.asarray(enc))
    # the fused route splits its key exactly as the scan route does
    # (speller_pallas.py:900-928 against models/las.py:305-356)
    draws = _replay_speller_draws(key, cfg, ttl.B, ttl.L)
    module = tlas.las_from_jax_params(params)["speller"]
    enc_t = torch.from_numpy(enc).requires_grad_(True)
    tlas.reset_decode_routes()
    out = tlas.speller_apply(module, ttl._port_cfg(_fused(cfg)).speller, enc_t,
                             torch.from_numpy(enc_l), dec_y=torch.from_numpy(y),
                             tf_rate=tf_rate, train=True, draws=draws)
    assert tlas.decode_route_report() == {f"B={ttl.B},Te=6": "plain"}
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(ref.logits),
                               atol=ATOL_F32 * 5)  # logits of magnitude ~5
    np.testing.assert_allclose(out.att_map.detach().numpy(), np.asarray(ref.att_map),
                               atol=ATOL_F32)
    loss, _ = tloss.masked_ce_loss(out.logits, torch.from_numpy(y), torch.from_numpy(ttl.LY))
    leaves = dict(module.named_parameters())
    grads = torch.autograd.grad(loss, [enc_t, *leaves.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(ref_ge), atol=ATOL_F32)
    got = dict(zip(leaves, grads[1:]))
    want = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(ref_gp)}
    assert set(got) == set(want)
    for name in got:  # every parameter, the learned initial states included
        np.testing.assert_allclose(got[name].numpy(), want[name], atol=ATOL_F32,
                                   err_msg=name)
        if name != "attention.key_map.b":  # zero but for rounding (a softmax shift)
            assert np.abs(want[name]).max() > 1e-5, name


def _replay_speller_draws(key, cfg, batch, steps):
    """The draws of the speller alone under ``key`` (the model-level replay
    of test_torch_train_las.py splits the listener's keys off first)."""
    sc_ = cfg.speller
    _, coin_rng, drop_rng = jax.random.split(key, 3)
    coins = torch.from_numpy(np.array(jax.random.uniform(coin_rng, (steps,))))
    m1 = m2 = None
    if sc_.dec_lstm_dropout > 0.0:
        keep = 1.0 - sc_.dec_lstm_dropout
        pairs = [jax.random.split(k) for k in jax.random.split(drop_rng, steps)]
        m1 = torch.from_numpy(np.stack([np.asarray(jax.random.bernoulli(
            r1, keep, (batch, sc_.dec_lstm_hid_dim))) for r1, _ in pairs]))
        m2 = torch.from_numpy(np.stack([np.asarray(jax.random.bernoulli(
            r2, keep, (batch, sc_.dec_lstm_out_dim))) for _, r2 in pairs]))
    return tlas.TrainDraws([], coins, m1, m2)


def test_fused_decoder_routes_in_training():
    """``decoder_impl: pallas`` in training takes the fused route and agrees
    with the scan route of the port on the same draws (float32)."""
    cfg = ttl.CFG
    params, enc, enc_l, y = _speller_case(cfg)
    draws = _replay_speller_draws(jax.random.key(2), cfg, ttl.B, ttl.L)
    module = tlas.las_from_jax_params(params)["speller"]
    outs = {}
    for impl in ("pallas", "scan"):
        tlas.reset_decode_routes()
        outs[impl] = tlas.speller_apply(
            module, ttl._port_cfg(_fused(cfg, impl)).speller, torch.from_numpy(enc),
            torch.from_numpy(enc_l), dec_y=torch.from_numpy(y), tf_rate=0.5, train=True,
            draws=draws)
        assert list(tlas.decode_route_report().values()) == [
            "plain" if impl == "pallas" else "scan"]
    assert outs["pallas"].logits.requires_grad
    np.testing.assert_allclose(outs["pallas"].logits.detach().numpy(),
                               outs["scan"].logits.detach().numpy(), atol=ATOL_F32 * 5)
    np.testing.assert_allclose(outs["pallas"].att_map.detach().numpy(),
                               outs["scan"].att_map.detach().numpy(), atol=ATOL_F32)


def test_init_force_takes_scan_with_a_warning(capsys):
    """The kernels do not compute the prior: for CPU tensors ``init_force``
    warns once a shape on stderr and takes the step loop, as the JAX package
    does (models/las.py:271-274), and gives that loop's very numbers."""
    cfg = ttl.NO_DROPOUT
    params, enc, enc_l, y = _speller_case(cfg)
    draws = _replay_speller_draws(jax.random.key(2), cfg, ttl.B, ttl.L)
    module = tlas.las_from_jax_params(params)["speller"]
    args = (torch.from_numpy(enc), torch.from_numpy(enc_l))
    kwargs = dict(dec_y=torch.from_numpy(y), tf_rate=0.9, init_force=True, train=True,
                  draws=draws)
    tlas.reset_decode_routes()
    out = tlas.speller_apply(module, ttl._port_cfg(_fused(cfg)).speller, *args, **kwargs)
    err = capsys.readouterr().err
    assert "fell back to the scan decoder" in err and "init_force" in err
    assert tlas.decode_route_report() == {f"B={ttl.B},Te=6": "scan"}
    ref = tlas.speller_apply(module, ttl._port_cfg(cfg).speller, *args, **kwargs)
    assert torch.equal(out.logits, ref.logits)
    tlas.speller_apply(module, ttl._port_cfg(_fused(cfg)).speller, *args, **kwargs)
    assert "fell back" not in capsys.readouterr().err  # once a shape


def test_dec_y_outside_training_takes_scan(capsys):
    """``train=False`` with ``dec_y`` given: the JAX package lets the scan
    decoder handle it (models/las.py:275-276), which free-runs for
    ``CHR_MAX_STEPS`` steps and ignores ``dec_y``; the port follows for CPU
    tensors, and says so on stderr."""
    cfg = ttl.NO_DROPOUT
    params, enc, enc_l, y = _speller_case(cfg)
    ref = jlas.speller_apply(ttl._jax(params["speller"]), _fused(cfg).speller, None,
                             jnp.asarray(enc), jnp.asarray(enc_l), dec_y=jnp.asarray(y),
                             train=False)
    tlas.reset_decode_routes()
    with torch.inference_mode():
        out = tlas.speller_apply(tlas.las_from_jax_params(params)["speller"],
                                 ttl._port_cfg(_fused(cfg)).speller, torch.from_numpy(enc),
                                 torch.from_numpy(enc_l), dec_y=torch.from_numpy(y),
                                 train=False)
    assert tlas.decode_route_report() == {f"B={ttl.B},Te=6": "scan"}
    assert "dec_y given outside training" in capsys.readouterr().err
    assert out.logits.shape == (ttl.B, cfg.speller.CHR_MAX_STEPS, 30)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits), atol=ATOL_F32 * 5)


@pytest.mark.parametrize("kwargs, names", [
    (dict(train=True, init_force=True, tf_rate=0.9), "init_force"),
    (dict(train=False), "dec_y given outside training"),
], ids=["init_force", "dec_y-outside-training"])
def test_fused_decoder_on_the_card_raises_for_what_the_kernels_lack(kwargs, names, capsys):
    """A pass the fused kernels cannot compute takes the step loop on any
    device, the JAX package's own route for it (its models/las.py): it warns
    once a shape naming what the kernels lack, records the route ``"scan"``
    and gives the very numbers of a ``decoder_impl: scan`` config. The
    device plays no part in the choice, so real tensors on the CPU hold the
    card's route too; tests/test_torch_speller_cuda.py runs it on the card
    inside a train step."""
    cfg = ttl.NO_DROPOUT
    params, enc, enc_l, y = _speller_case(cfg)
    module = tlas.las_from_jax_params(params)["speller"]
    args = (torch.from_numpy(enc), torch.from_numpy(enc_l))
    if kwargs["train"]:
        kwargs = dict(kwargs, draws=_replay_speller_draws(jax.random.key(3), cfg, ttl.B, ttl.L))
    tlas.reset_decode_routes()
    with torch.inference_mode(not kwargs["train"]):
        out = tlas.speller_apply(module, ttl._port_cfg(_fused(cfg)).speller, *args,
                                 dec_y=torch.from_numpy(y), **kwargs)
        err = capsys.readouterr().err
        assert "fell back to the scan decoder" in err and names in err
        assert tlas.decode_route_report() == {f"B={ttl.B},Te=6": "scan"}
        ref = tlas.speller_apply(module, ttl._port_cfg(cfg).speller, *args,
                                 dec_y=torch.from_numpy(y), **kwargs)
    assert torch.equal(out.logits, ref.logits) and torch.equal(out.att_map, ref.att_map)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_train_steps_with_fused_decoder_match_jax(n_steps):
    """Whole train steps with ``decoder_impl: pallas`` (SpecAugment, dropout
    and coins replayed, AdamW with amsgrad) against the JAX step with its
    fused decoder in interpret mode: loss, grad_norm, the attention map,
    every parameter and every optimizer leaf. Tolerances as
    test_torch_train_las.py::test_two_train_steps_match_jax."""
    cfg = _fused(ttl.CFG)
    params = ttl._params(cfg)
    x, y = ttl._batch()
    tx, j_step = ttl._jax_step_fn(cfg, 5.0)
    j_state = jsteps.create_train_state(ttl._jax(params), tx, jax.random.key(1))
    opt, t_step = ttl._port_step_fn(cfg, 5.0)
    state = tsteps.create_train_state(tlas.las_from_jax_params(params), opt, device="cpu")
    ams = ttl._amsgrad_state(j_state.opt_state)
    state.opt_state = toptim.opt_state_from_optax(
        state.params, ams.count, *(jax.tree.map(np.asarray, t) for t in
                                   (ams.mu, ams.nu, ams.nu_max)))
    tx_, lx_, y_, ly_ = (torch.from_numpy(a) for a in (x, ttl.LX, y, ttl.LY))
    jlas._DECODE_ROUTES.clear()
    tlas.reset_decode_routes()
    for n in range(n_steps):
        _, draws = ttl.replay_train_draws(j_state.rng, cfg, ttl.B, ttl.L, use_specaug=True,
                                          time=10)
        j_state, j_metrics, j_att = j_step(j_state, jnp.asarray(x), jnp.asarray(ttl.LX),
                                           jnp.asarray(y), jnp.asarray(ttl.LY), 0.5, 1e-3)
        state, metrics, att = t_step(state, tx_, lx_, y_, ly_, 0.5, 1e-3, draws=draws)
        assert bool(metrics["finite"]) and bool(j_metrics["finite"])
        for name in ("loss", "ppl", "grad_norm", "n_tokens"):
            np.testing.assert_allclose(float(metrics[name]), float(j_metrics[name]),
                                       atol=1e-5, rtol=1e-4, err_msg=f"step {n} {name}")
        np.testing.assert_allclose(att.numpy(), np.asarray(j_att), atol=ATOL_F32)
        ttl._assert_state_matches(state, j_state, atol=1e-5, rtol=1e-4)
    assert state.step == n_steps
    assert set(jlas.decode_route_report().values()) == {"pallas"}
    assert set(tlas.decode_route_report().values()) == {"plain"}
