"""PyTorch port, the fused eval decode: ``speller_decode_plain`` (the CUDA
kernel's plain version, which the wrapper takes for CPU tensors) and the
eval ``speller_apply_fused`` against the JAX package's fused decode kernel in
interpret mode; ``speller_apply``'s routing; ``las_apply``, the loss and the
eval / infer steps against the JAX package, at toy sizes. The kernel itself is
tested on the card by test_torch_speller_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu.models import las as jlas
from attention_based_e2e_asr_dnn_tpu.ops import speller_pallas as jsp
from attention_based_e2e_asr_dnn_tpu.training import loss as jloss
from attention_based_e2e_asr_dnn_tpu.training import steps as jsteps
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda
from attention_based_e2e_asr_dnn_tpu_torch.training import loss as tloss
from attention_based_e2e_asr_dnn_tpu_torch.training import steps as tsteps

torch.set_num_threads(1)

# float32: the same float32 arithmetic in another order (the JAX package's
# fused-vs-scan tolerance, tests/test_speller_pallas.py)
ATOL_F32 = 2e-5
B, TE, P, H1, H2, VP, V, STEPS = 3, 11, 16, 20, 12, 32, 30, 12


def _bf16_step(x: np.ndarray) -> float:
    """One bf16 rounding step at the magnitude of the largest |x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _operands(seed, heads):
    """The decode kernel's operands (speller_pallas.py:933-984 layouts),
    seeded numpy, float32."""
    rng = np.random.default_rng(seed)

    def u(*shape, k=0.3):
        return rng.uniform(-k, k, shape).astype(np.float32)

    enc_l = np.array([TE, 6, 1])
    bias = np.where(np.arange(TE)[None] >= enc_l[:, None], jsp.NEG, 0.0).astype(np.float32)
    wcls = np.zeros((2 * P, VP), np.float32)
    wcls[:, :V] = rng.standard_normal((2 * P, V))
    clsb = np.full(VP, jsp.NEG, np.float32)
    clsb[:V] = u(V)
    return {"k": u(B, TE, P, k=1), "v": u(B, TE, P, k=1), "bias": bias,
            "ctx0": u(B, P), "h10": u(B, H1), "c10": u(B, H1), "h20": u(B, H2),
            "c20": u(B, H2), "embw1": u(VP, 4 * H1), "wc1": u(P, 4 * H1),
            "whh1": u(H1, 4 * H1), "wih2": u(H1, 4 * H2), "whh2": u(H2, 4 * H2),
            "b2": u(4 * H2), "wq": u(H2, P), "bq": u(P), "wcls": wcls, "clsb": clsb}


def _jax_fused_decode(ops, heads, dtype, gold=None):
    """The Pallas kernel in interpret mode on the same operands."""
    j = {n: jnp.asarray(a).astype(dtype) for n, a in ops.items()}
    for n in ("b2", "bq", "clsb"):
        j[n] = j[n][None]
    static = (heads, float(1 / np.sqrt(P // heads)), 0, False, B,
              jsp._pick_te_chunk(TE), True)
    if gold is None:
        gold = np.full((STEPS, B), -1.0, np.float32)
    logits, wgts = jsp.fused_decode(static, *j.values(), jnp.asarray(gold)[..., None],
                                    jnp.ones((1, B, H1), dtype), jnp.ones((1, B, H2), dtype))
    return (np.asarray(logits.astype(jnp.float32)), np.asarray(wgts.astype(jnp.float32)))


def _plain(ops, heads, dtype, forced=None):
    t = {n: torch.from_numpy(a).to(dtype) for n, a in ops.items()}
    logits, wgts, ids = speller_cuda.speller_decode(
        *t.values(), heads=heads, scale=float(1 / np.sqrt(P // heads)), sos_idx=0,
        steps=STEPS, forced=forced)
    return logits.float().numpy(), wgts.float().numpy(), ids.numpy()


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_kernel(heads, dtype):
    ops = _operands(heads, heads)
    ref_logits, ref_wgts = _jax_fused_decode(ops, heads, jnp.dtype(dtype))
    logits, wgts, ids = _plain(ops, heads, getattr(torch, dtype))
    assert logits.shape == (STEPS, B, VP) and wgts.shape == (STEPS, B, heads, TE)
    # the fed-back ids are the first maxima of the real vocabulary
    np.testing.assert_array_equal(ids, ref_logits[..., :V].argmax(-1))
    # bf16: both sides round the same fp32 values; a sum taken in another
    # order can flip the rounding of an output by one bf16 step
    atol = ATOL_F32 if dtype == "float32" else _bf16_step(ref_logits[..., :V])
    np.testing.assert_allclose(logits[..., :V], ref_logits[..., :V], atol=atol, rtol=0)
    np.testing.assert_allclose(wgts, ref_wgts, atol=ATOL_F32 if dtype == "float32"
                               else 2.0 ** -8, rtol=0)
    assert np.all(wgts[:, 2, :, 1:] == 0.0)  # the 1-frame row's pads


def test_forced_ids_match_pallas_gold():
    """The forced-id stream (the Pallas kernel's gold): ids >= 0 are fed,
    -1 runs free; step 0 of the eval form feeds <sos>."""
    heads = 2
    ops = _operands(7, heads)
    forced = np.random.default_rng(7).integers(0, V, (STEPS, B)).astype(np.int32)
    forced[:, 1] = -1
    forced[0] = -1
    forced[5, 0] = -1
    ref_logits, _ = _jax_fused_decode(ops, heads, jnp.float32,
                                      gold=forced.astype(np.float32))
    logits, _, _ = _plain(ops, heads, torch.float32, forced=torch.from_numpy(forced))
    np.testing.assert_allclose(logits[..., :V], ref_logits[..., :V], atol=ATOL_F32, rtol=0)
    free, _, _ = _plain(ops, heads, torch.float32)
    assert not np.allclose(free[..., :V], logits[..., :V])


def test_grid_size_and_te_chunk():
    """The float32 adjoint's blocks (``plan_decode_bwd_f32``: at most 128
    and the card's SMs, column groups dividing H1, H2 and P) and the Te
    chunk."""
    def plan(batch, heads, h1, h2, proj, sms=132):
        return speller_cuda.plan_decode_bwd_f32(batch, 192, proj, heads, h1, h2, sms, 232448)

    assert plan(128, 1, 512, 256, 256).blocks == 128   # base-LAS
    assert plan(32, 4, 1024, 256, 256).blocks == 128   # scaled-LAS
    assert (plan(64, 1, 64, 32, 48).blocks, plan(64, 1, 64, 32, 48).col_groups) == (128, 16)
    assert plan(128, 1, 512, 256, 256, sms=64).blocks == 64
    assert [speller_cuda.pick_te_chunk(t) for t in (192, 96, 11)] == \
        [jsp._pick_te_chunk(t) for t in (192, 96, 11)] == [64, 32, 11]


# -- the eval speller, the model and the steps -------------------------------

LISTENER = jlas.ListenerConfig(input_dim=15, uniform_hid_dim=12, lstm_layers=1,
                               plstm_layers=1, lstm_impl="pallas")


def _cfg(heads, impl="pallas"):
    return jlas.LASConfig(
        listener=LISTENER,
        speller=jlas.SpellerConfig(enc_out_dim=24, att_proj_dim=16, att_heads=heads,
                                   dec_emb_dim=32, dec_lstm_hid_dim=20,
                                   dec_lstm_out_dim=12, CHR_MAX_STEPS=STEPS,
                                   decoder_impl=impl))


def _port_cfg(cfg):
    return tlas.LASConfig(listener=tlas.ListenerConfig(**dataclasses.asdict(cfg.listener)),
                          speller=tlas.SpellerConfig(**dataclasses.asdict(cfg.speller)))


def _params(seed, cfg):
    params = jax.tree.map(np.asarray, jlas.las_init(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    for key in ("init_h1", "init_c1", "init_h2", "init_c2"):
        params["speller"][key] = rng.uniform(-0.5, 0.5, params["speller"][key].shape
                                             ).astype(np.float32)
    return params


def _encoder(seed):
    rng = np.random.default_rng(seed)
    enc_l = np.array([TE, 7, 3], np.int32)
    enc_h = rng.standard_normal((B, TE, 24)).astype(np.float32)
    enc_h[np.arange(TE)[None] >= enc_l[:, None]] = 0.0
    return enc_h, enc_l


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_speller_apply_fused_matches_jax(heads, dtype):
    cfg = _cfg(heads)
    params = _params(heads, cfg)
    enc_h, enc_l = _encoder(heads)
    ref = jsp.speller_apply_fused(jax.tree.map(jnp.asarray, params["speller"]), cfg.speller,
                                  None, jnp.asarray(enc_h).astype(jnp.dtype(dtype)),
                                  jnp.asarray(enc_l), None, train=False, interpret=True)
    module = tlas.las_from_jax_params(params)
    with torch.inference_mode():
        out = speller_cuda.speller_apply_fused(
            module["speller"], _port_cfg(cfg).speller,
            torch.from_numpy(enc_h).to(getattr(torch, dtype)), torch.from_numpy(enc_l))
    ref_logits = np.asarray(ref.logits.astype(jnp.float32))
    ref_att = np.asarray(ref.att_map.astype(jnp.float32))
    assert out.logits.shape == (B, STEPS, V) and out.att_map.shape == (heads, TE, STEPS + 1)
    np.testing.assert_array_equal(out.logits.float().numpy().argmax(-1), ref_logits.argmax(-1))
    if dtype == "float32":
        atol, att_atol = ATOL_F32, ATOL_F32
    else:
        # the t = -1 context comes from the plain attention step, whose bf16
        # softmax rounds at other places than XLA's (one step of its
        # weights): the decode starts a bf16 step apart and stays within two
        # steps of the largest logit, and of weights near 1
        atol, att_atol = 2 * _bf16_step(ref_logits), 2.0 ** -7
    np.testing.assert_allclose(out.logits.float().numpy(), ref_logits, atol=atol, rtol=0)
    np.testing.assert_allclose(out.att_map.float().numpy(), ref_att, atol=att_atol, rtol=0)


@pytest.mark.parametrize("impl", ["pallas", "scan"])
def test_speller_apply_routes_on_decoder_impl(impl):
    """Both routes give the free-running decode (fp32: the fused numerics and
    the step loop's agree); the route report names the one taken."""
    cfg = _port_cfg(_cfg(2, impl))
    module = tlas.las_from_jax_params(_params(3, _cfg(2)))
    enc_h, enc_l = _encoder(3)
    tlas.reset_decode_routes()
    with torch.inference_mode():
        out = tlas.speller_apply(module["speller"], cfg.speller, torch.from_numpy(enc_h),
                                 torch.from_numpy(enc_l))
        assert tlas.decode_route_report() == {
            f"B={B},Te={TE}": "plain" if impl == "pallas" else "scan"}
        ref = tlas.speller_apply(module["speller"],
                                 dataclasses.replace(cfg.speller, decoder_impl="scan"),
                                 torch.from_numpy(enc_h), torch.from_numpy(enc_l))
    # logits reach ~10 (tied N(0, 1) embedding): float32 order differences
    # scale with them
    np.testing.assert_allclose(out.logits.numpy(), ref.logits.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.att_map.numpy(), ref.att_map.numpy(), atol=ATOL_F32, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_ce_loss_matches_jax(dtype):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, V)).astype(np.float32) * 3
    targets = rng.integers(0, V, (3, 7)).astype(np.int32)
    lens = np.array([7, 2, 0], np.int32)
    ref, ref_n = jloss.masked_ce_loss(jnp.asarray(logits).astype(jnp.dtype(dtype)),
                                      jnp.asarray(targets), jnp.asarray(lens))
    loss, n = tloss.masked_ce_loss(torch.from_numpy(logits).to(getattr(torch, dtype)),
                                   torch.from_numpy(targets), torch.from_numpy(lens))
    assert loss.dtype == torch.float32 and float(n) == float(ref_n) == 9.0
    np.testing.assert_allclose(float(loss), float(ref), atol=1e-5, rtol=0)


def _features(seed):
    rng = np.random.default_rng(seed)
    lx = np.array([16, 12, 5], np.int32)
    x = rng.standard_normal((B, 16, 15)).astype(np.float32)
    x[np.arange(16)[None] >= lx[:, None]] = 0.0
    return x, lx


def _jax_apply(cfg):
    def apply_fn(p, rng, x, lx, dec_y=None, tf_rate=1.0, init_force=False, train=False):
        return jlas.las_apply(p, cfg, rng, x, lx, dec_y, tf_rate, init_force, train)
    return apply_fn


@pytest.mark.parametrize("impl", ["pallas", "scan"])
def test_las_apply_and_steps_match_jax(impl):
    cfg = _cfg(2, impl)
    params = _params(8, cfg)
    x, lx = _features(8)
    rng = np.random.default_rng(9)
    y = rng.integers(0, V, (B, STEPS + 4)).astype(np.int32)
    ly = np.array([STEPS + 4, 5, 1], np.int32)  # row 0 past the decode horizon
    jp = jax.tree.map(jnp.asarray, params)
    ref_out = jlas.las_apply(jp, cfg, None, jnp.asarray(x), jnp.asarray(lx))
    ref_metrics, ref_ids = jsteps.make_eval_step(_jax_apply(cfg))(
        jp, jnp.asarray(x), jnp.asarray(lx), jnp.asarray(y), jnp.asarray(ly))
    ref_infer = jsteps.make_infer_step(_jax_apply(cfg))(jp, jnp.asarray(x), jnp.asarray(lx))

    tcfg = _port_cfg(cfg)
    module = tlas.las_from_jax_params(params)

    def apply_fn(p, x_, lx_):
        return tlas.las_apply(p, tcfg, x_, lx_)

    tx, tlx = torch.from_numpy(x), torch.from_numpy(lx)
    with torch.inference_mode():
        out = tlas.las_apply(module, tcfg, tx, tlx)
    metrics, ids = tsteps.make_eval_step(apply_fn)(module, tx, tlx, torch.from_numpy(y),
                                                   torch.from_numpy(ly))
    infer_ids = tsteps.make_infer_step(apply_fn)(module, tx, tlx)
    # logits reach ~10: float32 order differences scale with them
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref_out.logits), atol=1e-4,
                               rtol=0)
    for key in ("loss", "ppl"):
        np.testing.assert_allclose(float(metrics[key]), float(ref_metrics[key]), atol=1e-5,
                                   rtol=1e-6)
    assert float(metrics["n_tokens"]) == float(ref_metrics["n_tokens"]) == STEPS + 6
    assert ids.dtype == infer_ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(infer_ids.numpy(), np.asarray(ref_infer))
