"""PyTorch port, the fused speller-decode CUDA kernels (the eval form, the
training form and the adjoint) against their plain versions on the card. Free
of JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_speller_cuda.py -m cuda --noconftest

Every test here skips without a CUDA device."""

import ctypes

import pytest
import torch

from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    las_config_from_dicts,
    las_init,
    speller_apply,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda

LISTENER = {"input_dim": 15, "uniform_hid_dim": 32, "plstm_layers": 1}
SPELLER = {"att_proj_dim": 64, "att_heads": 2, "dec_emb_dim": 128, "dec_lstm_hid_dim": 128,
           "dec_lstm_out_dim": 64, "CHR_MAX_STEPS": 40, "decoder_impl": "pallas"}
# forced along the kernel's own ids: float32 differs in summation order only;
# bfloat16 outputs and carries are rounded to bf16, so a flipped rounding
# propagates (two bf16 steps of the largest logits, and of weights near 1)
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (0.25, 2.0 ** -7)}
# the additive score's counters share the dict; a dot-product decode moves neither
NO_ADDITIVE = {"speller_additive_scores": 0, "speller_additive_scores_bwd": 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(device, batch=5, te=37, **changes):
    cfg = las_config_from_dicts(LISTENER, {**SPELLER, **changes})
    gen = torch.Generator().manual_seed(batch + te)
    params = las_init(cfg, gen)["speller"].to(device)
    lengths = torch.randint(1, te + 1, (batch,), generator=gen)
    lengths[0] = te
    enc = torch.randn(batch, te, cfg.listener.enc_out_dim, generator=gen) * 0.5
    return cfg.speller, params, enc.to(device), lengths.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 2])
def test_kernel_matches_plain_forced_along_its_ids_on_card(cuda_device, dtype, heads):
    cfg, params, enc, lengths = _setup(cuda_device, att_heads=heads)
    with torch.inference_mode():
        operands, _ = speller_cuda.decode_operands(params, cfg, enc.to(dtype), lengths)
        opts = speller_cuda.decode_options(cfg)
        speller_cuda.reset_launch_counts()
        logits, wgts, ids = speller_cuda.speller_decode(*operands, **opts)
        torch.cuda.synchronize()
        assert speller_cuda.LAUNCHES["speller_decode"] == 1
        forced = torch.cat([torch.full_like(ids[:1], -1), ids[:-1]]).contiguous()
        ref_logits, ref_wgts, ref_ids = speller_cuda.speller_decode_plain(
            *operands, **opts, forced=forced)
    vocab = cfg.dec_vocab_size
    tol, w_tol = TOL[dtype]
    assert logits.dtype == dtype and ids.dtype == torch.int32
    assert logits.shape == (cfg.CHR_MAX_STEPS, 5, 32) and wgts.shape == (40, 5, heads, 37)
    torch.testing.assert_close(logits[..., :vocab].float(), ref_logits[..., :vocab].float(),
                               atol=tol, rtol=0)
    torch.testing.assert_close(wgts.float(), ref_wgts.float(), atol=w_tol, rtol=0)
    pads = torch.arange(37, device=cuda_device)[None, :] >= lengths[:, None]
    assert torch.all(wgts.permute(1, 0, 2, 3)[pads[:, None, None, :].expand(-1, 40, heads, -1)]
                     == 0)
    if dtype == torch.float32:
        assert torch.equal(ids, ref_ids)


@pytest.mark.cuda
def test_forced_ids_on_card(cuda_device):
    cfg, params, enc, lengths = _setup(cuda_device, batch=3)
    gen = torch.Generator().manual_seed(0)
    forced = torch.randint(0, cfg.dec_vocab_size, (40, 3), generator=gen, dtype=torch.int32)
    forced[:, 1] = -1
    forced = forced.to(cuda_device)
    with torch.inference_mode():
        operands, _ = speller_cuda.decode_operands(params, cfg, enc, lengths)
        opts = speller_cuda.decode_options(cfg)
        got = speller_cuda.speller_decode(*operands, **opts, forced=forced)
        want = speller_cuda.speller_decode_plain(*operands, **opts, forced=forced)
    torch.testing.assert_close(got[0][..., :30], want[0][..., :30], atol=1e-4, rtol=0)
    assert torch.equal(got[2][:, 1], want[2][:, 1])


@pytest.mark.cuda
def test_speller_apply_on_card_matches_cpu(cuda_device):
    """The whole eval speller on the card against its CPU route (the plain
    version), float32."""
    cfg, params, enc, lengths = _setup(cuda_device, batch=4, te=16)
    with torch.inference_mode():
        speller_cuda.reset_launch_counts()
        got = speller_apply(params, cfg, enc, lengths)
        torch.cuda.synchronize()
        want = speller_apply(params.cpu(), cfg, enc.cpu(), lengths.cpu())
    assert speller_cuda.LAUNCHES["speller_decode"] == 1
    torch.testing.assert_close(got.logits.cpu(), want.logits, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.att_map.cpu(), want.att_map, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_kernel_rejects_unsupported_shapes_on_card(cuda_device):
    cfg, params, enc, lengths = _setup(cuda_device, batch=2, te=8)
    with torch.inference_mode():
        operands, _ = speller_cuda.decode_operands(params, cfg, enc, lengths)
        opts = speller_cuda.decode_options(cfg)
        bad = list(operands)
        bad[16] = torch.zeros(2 * 64, 40, device=cuda_device)  # wcls (2P, Vp)
        with pytest.raises(ValueError, match="wcls"):
            speller_cuda.speller_decode(*bad, **opts)
        with pytest.raises(ValueError, match="head width"):
            speller_cuda.speller_decode(*operands, **{**opts, "heads": 16})
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            speller_cuda.speller_decode(*[t.half() for t in operands], **opts)
        with pytest.raises(ValueError, match="forced ids"):
            speller_cuda.speller_decode(*operands, **opts,
                                        forced=torch.zeros(3, 2, dtype=torch.int32,
                                                           device=cuda_device))
        # H1 100: not a multiple of 8
        cfg3, params3, enc3, lengths3 = _setup(cuda_device, batch=2, te=8,
                                               dec_lstm_hid_dim=100)
        operands3, _ = speller_cuda.decode_operands(params3, cfg3, enc3, lengths3)
        with pytest.raises(ValueError, match="must be multiples of 8"):
            speller_cuda.speller_decode(*operands3, **opts)
        # the scores of every frame above the device's shared memory
        cfg4, params4, enc4, lengths4 = _setup(cuda_device, batch=1, te=60000)
        operands4, _ = speller_cuda.decode_operands(params4, cfg4, enc4, lengths4)
        with pytest.raises(ValueError, match="device's limit"):
            speller_cuda.speller_decode(*operands4, **opts)


@pytest.mark.cuda
def test_kernel_limits_on_card(cuda_device):
    lim = speller_cuda.kernel_limits(torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert {k: lim[k] for k in speller_cuda.F32_LIMITS} == speller_cuda.F32_LIMITS
    assert lim["max_grid"] <= sms == lim["sms"] and lim["vmax"] >= 32
    assert lim["nthreads"] % 32 == 0 and lim["smem_optin"] >= 48 * 1024
    # the plan's shared-memory formula is the source's
    lib = speller_cuda.load_library()
    for geo in ((608, 128, 1, 256, 128, 16, 32, 3, 2), (192, 256, 4, 1024, 256, 128, 4, 1, 1)):
        assert lib.speller_decode_smem_bytes(*geo) == speller_cuda.decode_f32_smem_bytes(*geo)


# -- the training form and the adjoint ---------------------------------------

# the largest error over the largest magnitude of the plain tensor. float32:
# summation order. bfloat16: the streams are bf16 and a flipped rounding is
# carried along the recurrence: four bf16 steps (4 * 2**-8).
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max() /
            ref.float().abs().max().clamp_min(1e-30)).item()


def _train_inputs(device, dtype, heads, batch=5, te=37, steps=24, drop=0.3, seed=0):
    cfg, params, enc, lengths = _setup(device, batch=batch, te=te, att_heads=heads)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        operands, _ = speller_cuda.decode_operands(params, cfg, enc.to(dtype), lengths)
    opts = {**speller_cuda.decode_options(cfg), "steps": steps}
    forced = torch.randint(0, cfg.dec_vocab_size, (steps, batch), generator=gen,
                           dtype=torch.int32)
    forced[torch.rand(steps, generator=gen) > 0.6] = -1  # free steps among forced ones
    forced[0] = -1
    m1 = m2 = None
    if drop > 0.0:
        keep = 1.0 - drop
        m1 = ((torch.rand(steps, batch, cfg.dec_lstm_hid_dim, generator=gen) < keep)
              .to(dtype) / keep).to(device)
        m2 = ((torch.rand(steps, batch, cfg.dec_lstm_out_dim, generator=gen) < keep)
              .to(dtype) / keep).to(device)
    return cfg, operands, opts, forced.to(device), m1, m2, gen


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 2])
def test_train_kernel_matches_plain_on_card(cuda_device, dtype, heads):
    cfg, operands, opts, forced, m1, m2, _ = _train_inputs(cuda_device, dtype, heads)
    speller_cuda.reset_launch_counts()
    logits, wgts, ids, saved = speller_cuda.speller_decode_train(
        *operands, **opts, forced=forced, m1=m1, m2=m2)
    torch.cuda.synchronize()
    assert speller_cuda.LAUNCHES["speller_decode_train"] == 1
    assert speller_cuda.LAUNCHES["speller_decode"] == 0
    # the plain version fed the kernel's own ids at every step
    sel = saved[0]
    free = forced < 0
    assert torch.equal(sel[~free], forced[~free]) and bool((sel[0] == cfg.CHR_SOS_IDX).all())
    assert torch.equal(sel[1:][free[1:]], ids[:-1][free[1:]])
    p_logits, p_wgts, _, p_saved = speller_cuda.speller_decode_train_plain(
        *operands, **opts, forced=sel, m1=m1, m2=m2)
    tol = REL_TOL[dtype]
    vocab = cfg.dec_vocab_size
    assert _rel_err(logits[..., :vocab], p_logits[..., :vocab]) <= tol
    assert _rel_err(wgts, p_wgts) <= tol
    for name, got, want in zip(speller_cuda.RESIDUALS[1:], saved[1:], p_saved[1:]):
        assert got.dtype == dtype and got.shape == want.shape, name
        assert _rel_err(got, want) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_form_without_masks_is_the_eval_form_on_card(cuda_device, dtype):
    cfg, operands, opts, forced, _, _, _ = _train_inputs(cuda_device, dtype, 2, drop=0.0)
    for f in (None, forced):
        train = speller_cuda.speller_decode_train(*operands, **opts, forced=f)
        lean = speller_cuda.speller_decode(*operands, **opts, forced=f)
        for a, b in zip(train[:3], lean):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,with_dw,drop", [(1, False, 0.3), (2, True, 0.3),
                                                (2, False, 0.0)])
def test_bwd_kernel_matches_plain_on_card(cuda_device, dtype, heads, with_dw, drop):
    cfg, operands, opts, forced, m1, m2, gen = _train_inputs(cuda_device, dtype, heads,
                                                             drop=drop)
    _, wgts, _, saved = speller_cuda.speller_decode_train(*operands, **opts, forced=forced,
                                                          m1=m1, m2=m2)
    k, v, _, _, _, c10, _, c20, _, wc1, whh1, wih2, whh2, _, wq = operands[:15]
    _, gates1, c1, _, gates2, c2, _, _ = saved
    steps, batch, proj = opts["steps"], k.shape[0], k.shape[2]

    def cot(*shape):
        return (torch.randn(*shape, generator=gen) * 0.1).to(cuda_device, dtype)

    dqup, dctxup = cot(steps, batch, proj), cot(steps, batch, proj)
    dwup = cot(*wgts.shape) if with_dw else None
    args = (k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1, gates2, c2, wgts,
            m1, m2, dqup, dctxup, dwup)
    kw = {"heads": opts["heads"], "scale": opts["scale"]}
    speller_cuda.reset_launch_counts()
    got = speller_cuda.speller_decode_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert speller_cuda.LAUNCHES["speller_decode_bwd"] == 1
    want = speller_cuda.speller_decode_bwd_plain(*args, **kw)
    names = ("dpre1", "dpre2", "dq", "dctxtot", "dsc", "dh10", "dc10", "dh20", "dc20", "dctx0")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a, b) <= REL_TOL[dtype], name
    # pads carry no weight, so no score gradient
    assert bool((got[4][wgts == 0] == 0).all())
    # a fixed order of every sum: a second call is bit-equal
    again = speller_cuda.speller_decode_bwd(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_function_grads_on_card_match_cpu(cuda_device):
    """The Function on the card (both kernels and the products around them)
    against the Function on the CPU (the plain versions), float32: every
    operand's gradient, with a cotangent on the weights."""
    cfg, operands, opts, forced, m1, m2, gen = _train_inputs(cuda_device, torch.float32, 2)
    d_logits = torch.randn(opts["steps"], 5, 32, generator=gen) * 0.1
    d_logits[..., cfg.dec_vocab_size:] = 0.0
    d_wgts = torch.randn(opts["steps"], 5, 2, 37, generator=gen) * 0.1
    grads = {}
    for device in (cuda_device, torch.device("cpu")):
        leaves = [t.detach().to(device).requires_grad_(i != 2)  # not the pad bias
                  for i, t in enumerate(operands)]
        outs = speller_cuda.fused_decode(
            leaves, **opts, forced=forced.to(device), m1=m1.to(device), m2=m2.to(device))
        grads[device.type] = torch.autograd.grad(
            outs, [t for t in leaves if t.requires_grad],
            [d_logits.to(device), d_wgts.to(device)])
    for n, (a, b) in enumerate(zip(grads["cuda"], grads["cpu"])):
        assert _rel_err(a.cpu(), b) <= 1e-4, f"operand gradient {n}"


@pytest.mark.cuda
def test_training_speller_apply_on_card_matches_cpu(cuda_device):
    """The training speller with ``decoder_impl: pallas`` on the card against
    its CPU route, float32: logits, attention map and parameter gradients."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import draw_train_noise

    cfg, params, enc, lengths = _setup(cuda_device, batch=4, te=16, dec_lstm_dropout=0.3)
    gen = torch.Generator().manual_seed(3)
    dec_y = torch.randint(1, 29, (4, 12), generator=gen, dtype=torch.int32)
    lcfg = las_config_from_dicts(LISTENER, {**SPELLER, "dec_lstm_dropout": 0.3})
    draws = draw_train_noise(lcfg, 4, 12, gen, "cpu")
    results = {}
    for device in ("cuda", "cpu"):
        p = params.to(device)
        d = type(draws)([], draws.coins.to(device), draws.m1.to(device), draws.m2.to(device))
        speller_cuda.reset_launch_counts()
        out = speller_apply(p, cfg, enc.to(device), lengths.to(device), dec_y.to(device),
                            tf_rate=0.5, train=True, draws=d)
        g = torch.autograd.grad(out.logits.float().square().mean(), list(p.parameters()))
        if device == "cuda":
            assert speller_cuda.LAUNCHES == {"speller_decode": 0, "speller_decode_train": 1,
                                             "speller_decode_bwd": 1, **NO_ADDITIVE}
        results[device] = (out.logits.detach().cpu(), out.att_map.detach().cpu(),
                           [x.cpu() for x in g])
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0], atol=1e-4, rtol=0)
    torch.testing.assert_close(results["cuda"][1], results["cpu"][1], atol=1e-5, rtol=0)
    for a, b in zip(results["cuda"][2], results["cpu"][2]):
        assert _rel_err(a, b) <= 1e-4 or (a - b).abs().max() <= 1e-6


@pytest.mark.cuda
def test_bwd_kernel_rejects_unsupported_shapes_on_card(cuda_device):
    cfg, operands, opts, forced, m1, m2, _ = _train_inputs(cuda_device, torch.float32, 2,
                                                           batch=2, te=8, steps=4)
    _, wgts, _, saved = speller_cuda.speller_decode_train(*operands, **opts, forced=forced,
                                                          m1=m1, m2=m2)
    k, v, _, _, _, c10, _, c20, _, wc1, whh1, wih2, whh2, _, wq = operands[:15]
    _, gates1, c1, _, gates2, c2, _, _ = saved
    dq = torch.zeros(4, 2, 64, device=cuda_device)
    args = [k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1, gates2, c2, wgts, m1, m2,
            dq, dq, None]
    kw = {"heads": 2, "scale": opts["scale"]}
    speller_cuda.speller_decode_bwd(*args, **kw)
    with pytest.raises(ValueError, match="wgts"):  # saved for 2 heads
        speller_cuda.speller_decode_bwd(*args, heads=16, scale=opts["scale"])
    with pytest.raises(ValueError, match="m1 and m2 come together"):
        speller_cuda.speller_decode_bwd(*args[:15], None, *args[16:], **kw)
    with pytest.raises(ValueError, match="dqup"):
        speller_cuda.speller_decode_bwd(*args[:16], dq[:3], dq, None, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        speller_cuda.speller_decode_bwd(*args[:16], dq.double(), dq, None, **kw)
    lim = speller_cuda.bwd_kernel_limits(torch.cuda.current_device())
    assert lim["max_grid"] <= 132 and lim["smem_optin"] >= 48 * 1024


# the model block of configs/base-las.yml
BASE_LAS = (
    {"input_dim": 15, "uniform_hid_dim": 512, "lstm_layers": 1, "plstm_layers": 3,
     "bidirectional": True, "init_dropout": 0.3, "mid_dropout": 0.3, "final_dropout": 0.35,
     "lstm_impl": "pallas"},
    {"att_proj_dim": 256, "att_heads": 1, "dec_emb_dim": 512, "dec_lstm_hid_dim": 512,
     "dec_lstm_out_dim": 256, "dec_lstm_dropout": 0.3, "CHR_MAX_STEPS": 600,
     "dec_vocab_size": 30, "CHR_SOS_IDX": 0, "CHR_PAD_IDX": 29})


@pytest.mark.cuda
def test_init_force_train_step_takes_the_scan_route_on_card(cuda_device, capsys):
    """An ``init_force`` train step at base-LAS width with ``decoder_impl:
    pallas`` warns, records the route ``"scan"`` and equals the same step
    with ``decoder_impl: scan``: the same listener kernels, the same step
    loop, the same draws from the same seed. float32; the parameters within
    1e-6, the loss exactly."""
    from attention_based_e2e_asr_dnn_tpu_torch.models import las
    from attention_based_e2e_asr_dnn_tpu_torch.training.optim import build_optimizer
    from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
        create_train_state,
        make_train_step,
    )

    batch, frames, labels = 8, 256, 32
    gen = torch.Generator().manual_seed(5)
    lx = torch.randint(frames - 64, frames + 1, (batch,), generator=gen).to(torch.int32)
    lx[0] = frames
    x = torch.randn(batch, frames, 15, generator=gen)
    y = torch.randint(1, 29, (batch, labels), generator=gen).to(torch.int32)
    ly = torch.full((batch,), labels, dtype=torch.int32)
    x, lx, y, ly = (t.to(cuda_device) for t in (x, lx, y, ly))
    results = {}
    for impl in ("pallas", "scan"):
        cfg = las_config_from_dicts(BASE_LAS[0], {**BASE_LAS[1], "decoder_impl": impl})
        opt = build_optimizer("adamw", {"lr": 1e-3, "weight_decay": 5e-6, "amsgrad": True},
                              grad_norm=5.0)
        state = create_train_state(las_init(cfg, torch.Generator().manual_seed(11)), opt,
                                   seed=12, device=cuda_device)
        step = make_train_step(lambda p, xx, ll, **kw: las.las_apply(p, cfg, xx, ll, **kw), opt,
                               use_specaug=True)
        las.reset_decode_routes()
        state, metrics, _ = step(state, x, lx, y, ly, 0.9, 1e-3, init_force=True)
        torch.cuda.synchronize()
        results[impl] = (state, metrics, las.decode_route_report())
    err = capsys.readouterr().err
    assert "fell back to the scan decoder" in err and "init_force" in err
    (fused, m_fused, routes), (scan, m_scan, _) = results["pallas"], results["scan"]
    assert routes == {f"B={batch},Te={frames // 8}": "scan"}
    assert bool(m_fused["finite"]) and torch.equal(m_fused["loss"], m_scan["loss"])
    for (name, p), q in zip(fused.params.named_parameters(), scan.params.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-6, msg=name)


# -- the bfloat16 forward on tensor cores (csrc/speller_decode_tc.cu) ---------

@pytest.mark.cuda
@pytest.mark.parametrize("batch,launches", [(64, 1), (128, 1), (130, 2)])
def test_bf16_tensor_core_forward_at_larger_batches_on_card(cuda_device, batch, launches):
    """Both forms at B=64, 128 and 130 (two launches: a span of 128 rows and
    one of 2) against their plain versions, with the launch count."""
    cfg, operands, opts, forced, m1, m2, _ = _train_inputs(
        cuda_device, torch.bfloat16, 2, batch=batch, steps=40)
    vocab = cfg.dec_vocab_size
    tol, w_tol = TOL[torch.bfloat16]
    with torch.inference_mode():
        eval_opts = speller_cuda.decode_options(cfg)
        speller_cuda.reset_launch_counts()
        logits, wgts, ids = speller_cuda.speller_decode(*operands, **eval_opts)
        torch.cuda.synchronize()
        assert speller_cuda.LAUNCHES["speller_decode"] == launches
        own = torch.cat([torch.full_like(ids[:1], -1), ids[:-1]]).contiguous()
        ref_logits, ref_wgts, _ = speller_cuda.speller_decode_plain(*operands, **eval_opts,
                                                                     forced=own)
    torch.testing.assert_close(logits[..., :vocab].float(), ref_logits[..., :vocab].float(),
                               atol=tol, rtol=0)
    torch.testing.assert_close(wgts.float(), ref_wgts.float(), atol=w_tol, rtol=0)
    speller_cuda.reset_launch_counts()
    logits, wgts, ids, saved = speller_cuda.speller_decode_train(
        *operands, **opts, forced=forced, m1=m1, m2=m2)
    torch.cuda.synchronize()
    assert speller_cuda.LAUNCHES["speller_decode_train"] == launches
    sel = saved[0]
    free = forced < 0
    assert torch.equal(sel[~free], forced[~free])
    assert torch.equal(sel[1:][free[1:]], ids[:-1][free[1:]])
    p_logits, p_wgts, _, p_saved = speller_cuda.speller_decode_train_plain(
        *operands, **opts, forced=sel, m1=m1, m2=m2)
    rel_tol = REL_TOL[torch.bfloat16]
    assert _rel_err(logits[..., :vocab], p_logits[..., :vocab]) <= rel_tol
    assert _rel_err(wgts, p_wgts) <= rel_tol
    for name, got, want in zip(speller_cuda.RESIDUALS[1:], saved[1:], p_saved[1:]):
        assert got.shape == want.shape and got.is_contiguous(), name
        assert _rel_err(got, want) <= rel_tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [5, 128, 130])
def test_bf16_forms_bit_equal_and_repeat_on_card(cuda_device, batch):
    """The training form without masks and forcing is the eval form bit for
    bit, and two calls of either repeat bit for bit (no atomics, a fixed
    summation order)."""
    cfg, operands, opts, _, m1, m2, _ = _train_inputs(cuda_device, torch.bfloat16, 2,
                                                      batch=batch, steps=24)
    lean = speller_cuda.speller_decode(*operands, **opts)
    bare = speller_cuda.speller_decode_train(*operands, **opts)
    for a, b in zip(bare[:3], lean):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(speller_cuda.speller_decode(*operands, **opts),
                                                 lean))
    first = speller_cuda.speller_decode_train(*operands, **opts, m1=m1, m2=m2)
    again = speller_cuda.speller_decode_train(*operands, **opts, m1=m1, m2=m2)
    for a, b in zip((*first[:3], *first[3]), (*again[:3], *again[3])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_function_grads_through_the_tensor_core_forward_on_card(cuda_device):
    """A ``_FusedDecode`` step in bfloat16: every operand's gradient through
    the tensor-core forward and the adjoint kernel against the Function on
    the plain versions, both fed the kernel's ids."""
    cfg, operands, opts, forced, m1, m2, gen = _train_inputs(cuda_device, torch.bfloat16, 2,
                                                             batch=6)
    d_logits = (torch.randn(opts["steps"], 6, 32, generator=gen) * 0.1)
    d_logits[..., cfg.dec_vocab_size:] = 0.0
    d_logits = d_logits.to(cuda_device, torch.bfloat16)
    d_wgts = (torch.randn(opts["steps"], 6, 2, 37, generator=gen) * 0.1).to(cuda_device,
                                                                             torch.bfloat16)
    sel = speller_cuda.speller_decode_train(*operands, **opts, forced=forced, m1=m1, m2=m2)[3][0]
    grads = {}
    for route in ("kernels", "plain"):
        saved = (speller_cuda.speller_decode_train, speller_cuda.speller_decode_bwd)
        if route == "plain":
            speller_cuda.speller_decode_train = speller_cuda.speller_decode_train_plain
            speller_cuda.speller_decode_bwd = speller_cuda.speller_decode_bwd_plain
        try:
            speller_cuda.reset_launch_counts()
            leaves = [t.detach().requires_grad_(i != 2) for i, t in enumerate(operands)]
            outs = speller_cuda.fused_decode(leaves, **opts, forced=sel, m1=m1, m2=m2)
            grads[route] = torch.autograd.grad(
                outs, [t for t in leaves if t.requires_grad], [d_logits, d_wgts])
            if route == "kernels":
                assert speller_cuda.LAUNCHES == {"speller_decode": 0, "speller_decode_train": 1,
                                                 "speller_decode_bwd": 1, **NO_ADDITIVE}
        finally:
            speller_cuda.speller_decode_train, speller_cuda.speller_decode_bwd = saved
    for n, (a, b) in enumerate(zip(grads["kernels"], grads["plain"])):
        assert a.dtype == torch.bfloat16
        assert _rel_err(a, b) <= REL_TOL[torch.bfloat16], f"operand gradient {n}"


@pytest.mark.cuda
def test_bf16_plan_mirrors_the_source_on_card(cuda_device):
    """The plan's constants and shared-memory count are the built source's."""
    lib = speller_cuda.load_tc_library()
    lim = speller_cuda.tc_kernel_limits(torch.cuda.current_device())
    assert {k: lim[k] for k in speller_cuda.TC_LIMITS} == speller_cuda.TC_LIMITS
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert lim["sms"] == sms and lim["smem_optin"] >= lim["smem_limit"]
    for rows, te, proj, heads, h1, h2 in [(64, 192, 256, 1, 512, 256),
                                          (128, 192, 256, 4, 1024, 256),
                                          (128, 896, 256, 4, 1024, 256),
                                          (5, 37, 64, 2, 128, 64), (2, 37, 64, 1, 128, 64),
                                          (64, 192, 256, 1, 128, 512),
                                          (128, 192, 1024, 1, 512, 128)]:
        blocks = speller_cuda.tc_blocks(h1, h2, sms)
        assert lib.speller_decode_tc_smem_bytes(rows, te, proj, heads, h1, h2, blocks, 0) == \
            speller_cuda.decode_tc_smem_bytes(rows, te, proj, heads, h1, h2, blocks)[0]
    # the streamed form's layout (cell 1's weights in the ring's stages)
    for rows, te, proj, heads, h1, h2 in [(128, 192, 1024, 1, 1024, 512),
                                          (64, 192, 1024, 4, 1024, 512),
                                          (128, 608, 896, 4, 896, 384),
                                          (128, 192, 256, 4, 1024, 256)]:
        blocks = speller_cuda.tc_blocks(h1, h2, sms)
        assert lib.speller_decode_tc_smem_bytes(rows, te, proj, heads, h1, h2, blocks, 1) == \
            speller_cuda.decode_tc_smem_bytes(rows, te, proj, heads, h1, h2, blocks, True)[0]


@pytest.mark.cuda
def test_bf16_refused_shape_raises_on_card(cuda_device):
    """A bfloat16 shape the tensor-core forward does not take raises a
    ValueError naming the limit; nothing gives way to the float32 source."""
    cfg, params, enc, lengths = _setup(cuda_device, batch=2, te=8, dec_lstm_hid_dim=96)
    with torch.inference_mode():
        operands, _ = speller_cuda.decode_operands(params, cfg, enc.to(torch.bfloat16),
                                                   lengths)
        opts = speller_cuda.decode_options(cfg)
        speller_cuda.reset_launch_counts()
        with pytest.raises(ValueError, match="multiples of 64"):
            speller_cuda.speller_decode(*operands, **opts)
        with pytest.raises(ValueError, match="multiples of 64"):
            speller_cuda.speller_decode_train(*operands, **opts)
    assert sum(speller_cuda.LAUNCHES.values()) == 0


# -- the widened bfloat16 forward and the bfloat16 adjoint on tensor cores ----
# (csrc/speller_decode_tc.cu's geometry of 1-8 cell-1 and 1-4 cell-2 units a
# block; csrc/speller_bwd_tc.cu)

# model blocks past the narrower geometry of 2 cell-2 units a block, on
# base-LAS's other widths
WIDENED = {
    "dec_lstm_out_dim 512": {"dec_lstm_out_dim": 512},
    "dec_lstm_hid_dim 128, dec_lstm_out_dim 256": {"dec_lstm_hid_dim": 128},
    "dec_lstm_hid_dim 1024, dec_lstm_out_dim 128": {"dec_lstm_hid_dim": 1024,
                                                    "dec_lstm_out_dim": 128},
    "att_proj_dim 1024, dec_lstm_out_dim 128": {"att_proj_dim": 1024, "dec_emb_dim": 2048,
                                                "dec_lstm_out_dim": 128},
}
BASE_SPELLER = {"att_proj_dim": 256, "att_heads": 1, "dec_emb_dim": 512,
                "dec_lstm_hid_dim": 512, "dec_lstm_out_dim": 256}


@pytest.mark.cuda
@pytest.mark.parametrize("block", list(WIDENED))
def test_bf16_widened_blocks_on_the_tensor_core_forward_on_card(cuda_device, block):
    """The four model blocks launch the tensor-core forward in bfloat16: the
    eval form at B=64 and the training form at B=128 against their plain
    versions forced along the kernel's ids (logits within the bf16
    tolerance, the training streams within four bf16 steps of their
    largest value), one launch a call."""
    changes = {**BASE_SPELLER, **WIDENED[block]}
    vocab_tol, w_tol = TOL[torch.bfloat16]
    for batch, train in ((64, False), (128, True)):
        cfg, params, enc, lengths = _setup(cuda_device, batch=batch, te=64, **changes)
        with torch.inference_mode():
            operands, _ = speller_cuda.decode_operands(params, cfg, enc.to(torch.bfloat16),
                                                       lengths)
            opts = {**speller_cuda.decode_options(cfg), "steps": 24}
            speller_cuda.reset_launch_counts()
            if not train:
                logits, wgts, ids = speller_cuda.speller_decode(*operands, **opts)
                torch.cuda.synchronize()
                assert speller_cuda.LAUNCHES["speller_decode"] == 1
                own = torch.cat([torch.full_like(ids[:1], -1), ids[:-1]]).contiguous()
                ref_logits, ref_wgts, _ = speller_cuda.speller_decode_plain(
                    *operands, **opts, forced=own)
                v = cfg.dec_vocab_size
                torch.testing.assert_close(logits[..., :v].float(), ref_logits[..., :v].float(),
                                           atol=vocab_tol, rtol=0)
                torch.testing.assert_close(wgts.float(), ref_wgts.float(), atol=w_tol, rtol=0)
                continue
            gen = torch.Generator().manual_seed(batch)
            keep = 0.7
            m1, m2 = (((torch.rand(24, batch, h, generator=gen) < keep).to(torch.bfloat16)
                       / keep).to(cuda_device)
                      for h in (cfg.dec_lstm_hid_dim, cfg.dec_lstm_out_dim))
            logits, wgts, ids, saved = speller_cuda.speller_decode_train(
                *operands, **opts, m1=m1, m2=m2)
            torch.cuda.synchronize()
            assert speller_cuda.LAUNCHES["speller_decode_train"] == 1
            p_logits, p_wgts, _, p_saved = speller_cuda.speller_decode_train_plain(
                *operands, **opts, forced=saved[0], m1=m1, m2=m2)
        v = cfg.dec_vocab_size
        assert _rel_err(logits[..., :v], p_logits[..., :v]) <= REL_TOL[torch.bfloat16]
        assert _rel_err(wgts, p_wgts) <= REL_TOL[torch.bfloat16]
        for name, got, want in zip(speller_cuda.RESIDUALS[1:], saved[1:], p_saved[1:]):
            assert _rel_err(got, want) <= REL_TOL[torch.bfloat16], name


def _bwd_case(device, batch, heads, drop, changes=None, steps=24, seed=0, hold_forward=False,
              te=37, launches=1):
    """The adjoint's operands from a training forward in bfloat16 (with
    ``hold_forward``, that forward's logits, weights and streams held to its
    plain version fed its ids, within four bf16 steps, in ``launches``
    launches)."""
    cfg, params, enc, lengths = _setup(device, batch=batch, te=te,
                                       **{**(changes or {}), "att_heads": heads})
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        operands, _ = speller_cuda.decode_operands(params, cfg, enc.to(torch.bfloat16), lengths)
    opts = {**speller_cuda.decode_options(cfg), "steps": steps}
    m1 = m2 = None
    if drop > 0.0:
        m1, m2 = (((torch.rand(steps, batch, h, generator=gen) < 1 - drop).to(torch.bfloat16)
                   / (1 - drop)).to(device)
                  for h in (cfg.dec_lstm_hid_dim, cfg.dec_lstm_out_dim))
    speller_cuda.reset_launch_counts()
    logits, wgts, _, saved = speller_cuda.speller_decode_train(*operands, **opts, m1=m1, m2=m2)
    if hold_forward:
        torch.cuda.synchronize()
        assert speller_cuda.LAUNCHES["speller_decode_train"] == launches
        p_logits, p_wgts, _, p_saved = speller_cuda.speller_decode_train_plain(
            *operands, **opts, forced=saved[0], m1=m1, m2=m2)
        v = cfg.dec_vocab_size
        assert _rel_err(logits[..., :v], p_logits[..., :v]) <= REL_TOL[torch.bfloat16]
        assert _rel_err(wgts, p_wgts) <= REL_TOL[torch.bfloat16]
        for name, got, want in zip(speller_cuda.RESIDUALS[1:], saved[1:], p_saved[1:]):
            assert _rel_err(got, want) <= REL_TOL[torch.bfloat16], name
    k, v, _, _, _, c10, _, c20, _, wc1, whh1, wih2, whh2, _, wq = operands[:15]
    _, gates1, c1, _, gates2, c2, _, _ = saved
    proj = k.shape[2]

    def cot(*shape):
        return (torch.randn(*shape, generator=gen) * 0.1).to(device, torch.bfloat16)

    args = (k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1, gates2, c2, wgts, m1, m2,
            cot(steps, batch, proj), cot(steps, batch, proj))
    return args, cot(*wgts.shape), {"heads": heads, "scale": opts["scale"]}


BWD_NAMES = ("dpre1", "dpre2", "dq", "dctxtot", "dsc", "dh10", "dc10", "dh20", "dc20", "dctx0")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,launches", [(40, 1), (128, 1), (200, 2)])
@pytest.mark.parametrize("heads,with_dw,drop", [(1, False, 0.3), (4, True, 0.3),
                                                (4, False, 0.0)])
def test_bf16_bwd_tensor_core_matches_plain_on_card(cuda_device, batch, launches, heads,
                                                    with_dw, drop):
    """The bfloat16 adjoint on ``csrc/speller_bwd_tc.cu`` against its plain
    version: every stream and every fp32 carry within four bf16 steps of its
    largest value, one launch a 128-row span, no score gradient at a pad."""
    args, dwup, kw = _bwd_case(cuda_device, batch, heads, drop)
    speller_cuda.reset_launch_counts()
    got = speller_cuda.speller_decode_bwd(*args, dwup if with_dw else None, **kw)
    torch.cuda.synchronize()
    assert speller_cuda.LAUNCHES["speller_decode_bwd"] == launches
    want = speller_cuda.speller_decode_bwd_plain(*args, dwup if with_dw else None, **kw)
    for name, a, b in zip(BWD_NAMES, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a, b) <= REL_TOL[torch.bfloat16], name
    assert bool((got[4][args[13] == 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["dec_lstm_hid_dim 1024, dec_lstm_out_dim 128",
                                   "att_proj_dim 1024, dec_lstm_out_dim 128"])
def test_bf16_bwd_at_widened_blocks_on_card(cuda_device, block):
    """Two groups of columns a block (N = 16 in two phases) at two of the
    widened model blocks, B=40."""
    args, dwup, kw = _bwd_case(cuda_device, 40, 1, 0.3, {**BASE_SPELLER, **WIDENED[block]},
                               steps=16)
    speller_cuda.reset_launch_counts()
    got = speller_cuda.speller_decode_bwd(*args, dwup, **kw)
    torch.cuda.synchronize()
    assert speller_cuda.LAUNCHES["speller_decode_bwd"] == 1
    want = speller_cuda.speller_decode_bwd_plain(*args, dwup, **kw)
    for name, a, b in zip(BWD_NAMES, got, want):
        assert _rel_err(a, b) <= REL_TOL[torch.bfloat16], name


# the decoder block of configs/scaled-las.yml: H1 1024, 4 heads of 64
SCALED_LAS_SPELLER = {**BASE_SPELLER, "dec_lstm_hid_dim": 1024}


@pytest.mark.cuda
@pytest.mark.parametrize("with_dw", [False, True])
def test_bf16_train_forward_and_bwd_at_scaled_las_widths_on_card(cuda_device, with_dw):
    """scaled-LAS's decoder at B=128, dropout 0.3: the training forward,
    then the adjoint on full 128-row tiles with two groups of columns on 64
    of the 128 blocks (N = 16 in phases (c) and (d)), every stream and fp32
    carry within four bf16 steps of its largest value, one launch each."""
    args, dwup, kw = _bwd_case(cuda_device, 128, 4, 0.3, SCALED_LAS_SPELLER,
                               hold_forward=True)
    speller_cuda.reset_launch_counts()
    got = speller_cuda.speller_decode_bwd(*args, dwup if with_dw else None, **kw)
    torch.cuda.synchronize()
    assert speller_cuda.LAUNCHES["speller_decode_bwd"] == 1
    want = speller_cuda.speller_decode_bwd_plain(*args, dwup if with_dw else None, **kw)
    for name, a, b in zip(BWD_NAMES, got, want):
        assert _rel_err(a, b) <= REL_TOL[torch.bfloat16], name


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [40, 200])
def test_bf16_bwd_repeats_bit_for_bit_on_card(cuda_device, batch):
    args, dwup, kw = _bwd_case(cuda_device, batch, 4, 0.3)
    first = speller_cuda.speller_decode_bwd(*args, dwup, **kw)
    again = speller_cuda.speller_decode_bwd(*args, dwup, **kw)
    for name, a, b in zip(BWD_NAMES, first, again):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_bf16_function_grads_at_a_widened_block_on_card(cuda_device):
    """``_FusedDecode``'s 17 gradients in bfloat16 at the block H1 128, H2
    256 (one cell-1 unit a block in the forward): both tensor-core kernels
    against the Function on the plain versions, fed the kernel's ids, within
    four bf16 steps."""
    cfg, params, enc, lengths = _setup(cuda_device, batch=6, te=37,
                                       **{**BASE_SPELLER, **WIDENED[
                                           "dec_lstm_hid_dim 128, dec_lstm_out_dim 256"]})
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        operands, _ = speller_cuda.decode_operands(params, cfg, enc.to(torch.bfloat16), lengths)
    opts = {**speller_cuda.decode_options(cfg), "steps": 16}
    d_logits = torch.randn(16, 6, 32, generator=gen) * 0.1
    d_logits[..., cfg.dec_vocab_size:] = 0.0
    d_logits = d_logits.to(cuda_device, torch.bfloat16)
    d_wgts = (torch.randn(16, 6, 1, 37, generator=gen) * 0.1).to(cuda_device, torch.bfloat16)
    sel = speller_cuda.speller_decode_train(*operands, **opts)[3][0]
    grads = {}
    for route in ("kernels", "plain"):
        saved = (speller_cuda.speller_decode_train, speller_cuda.speller_decode_bwd)
        if route == "plain":
            speller_cuda.speller_decode_train = speller_cuda.speller_decode_train_plain
            speller_cuda.speller_decode_bwd = speller_cuda.speller_decode_bwd_plain
        try:
            speller_cuda.reset_launch_counts()
            leaves = [t.detach().requires_grad_(i != 2) for i, t in enumerate(operands)]
            outs = speller_cuda.fused_decode(leaves, **opts, forced=sel)
            grads[route] = torch.autograd.grad(
                outs, [t for t in leaves if t.requires_grad], [d_logits, d_wgts])
            if route == "kernels":
                assert speller_cuda.LAUNCHES == {"speller_decode": 0, "speller_decode_train": 1,
                                                 "speller_decode_bwd": 1, **NO_ADDITIVE}
        finally:
            speller_cuda.speller_decode_train, speller_cuda.speller_decode_bwd = saved
    assert len(grads["kernels"]) == 17
    for n, (a, b) in enumerate(zip(grads["kernels"], grads["plain"])):
        assert _rel_err(a, b) <= REL_TOL[torch.bfloat16], f"operand gradient {n}"


@pytest.mark.cuda
def test_bf16_bwd_plan_mirrors_the_source_on_card(cuda_device):
    """The adjoint plan's constants, shared-memory count and groups of output
    columns a block are the built source's."""
    lib = speller_cuda.load_bwd_tc_library()
    lim = speller_cuda.bwd_tc_kernel_limits(torch.cuda.current_device())
    assert {k: lim[k] for k in speller_cuda.BWD_TC_LIMITS} == speller_cuda.BWD_TC_LIMITS
    for rows, te, proj, heads, h1, h2 in [(128, 192, 256, 1, 512, 256),
                                          (32, 192, 256, 4, 1024, 256),
                                          (40, 37, 64, 4, 128, 64),
                                          (128, 192, 1024, 1, 1024, 512)]:
        plan = speller_cuda.plan_decode_bwd_tc(rows, te, proj, heads, h1, h2, lim["sms"],
                                               lim["smem_optin"])
        assert lib.speller_bwd_tc_smem_bytes(rows, te, proj, heads, h1, h2, plan.blocks) == \
            plan.launches[0].smem
        # each block's groups of output columns, as the kernel assigns them
        n = lim["max_groups"]
        pairs = (ctypes.c_int * (plan.blocks * n * 2))()
        lib.speller_bwd_tc_groups(h1, h2, proj, plan.blocks, pairs)
        built = [[(speller_cuda.BWD_KINDS[pairs[i]], pairs[i + 1])
                  for i in range(2 * n * b, 2 * n * (b + 1), 2) if pairs[i] >= 0]
                 for b in range(plan.blocks)]
        assert built == plan.groups, (h1, h2, proj)


@pytest.mark.cuda
def test_bf16_bwd_refused_shape_raises_on_card(cuda_device):
    """A bfloat16 adjoint the tensor-core kernel does not take raises a
    ValueError naming the limit; nothing gives way to the float32 source or
    the plain version."""
    def operands(h1, h2, proj, batch=2, te=8, steps=2):
        shapes = [(batch, te, proj), (batch, te, proj), (proj, 4 * h1), (h1, 4 * h1),
                  (h1, 4 * h2), (h2, 4 * h2), (h2, proj), (batch, h1), (batch, h2),
                  (steps, batch, 4 * h1), (steps, batch, h1), (steps, batch, 4 * h2),
                  (steps, batch, h2), (steps, batch, 1, te)]
        z = [torch.zeros(sh, dtype=torch.bfloat16, device=cuda_device) for sh in shapes]
        dq = torch.zeros(steps, batch, proj, dtype=torch.bfloat16, device=cuda_device)
        return z + [None, None, dq, dq, None]

    speller_cuda.reset_launch_counts()
    with pytest.raises(ValueError, match=r"H1 \+ H2 \+ P = 4160 above 4096"):
        speller_cuda.speller_decode_bwd(*operands(2048, 1088, 1024), heads=1, scale=1.0)
    with pytest.raises(ValueError, match="multiples of 64"):
        speller_cuda.speller_decode_bwd(*operands(96, 64, 64), heads=1, scale=1.0)
    assert speller_cuda.LAUNCHES["speller_decode_bwd"] == 0


# decoder blocks the reference takes whose weight tiles leave too little
# shared memory for four ring stages of 128 rows: the bfloat16 forward takes
# a batch of 128 in two 64-row spans (the adjoint keeps one 128-row launch)
SPANS_64 = {
    "H1 768, H2 384, P 1024": {"att_proj_dim": 1024, "dec_emb_dim": 2048,
                               "dec_lstm_hid_dim": 768, "dec_lstm_out_dim": 384},
    "H1 1024, H2 512, P 512": {"att_proj_dim": 512, "dec_emb_dim": 1024,
                               "dec_lstm_hid_dim": 1024, "dec_lstm_out_dim": 512},
}


@pytest.mark.cuda
@pytest.mark.parametrize("block", list(SPANS_64))
def test_bf16_64_row_spans_on_card(cuda_device, block):
    """B=128 at the two blocks, Te 192: the eval form and the training form
    in two 64-row launches against their plain versions fed the kernel's
    ids, then the adjoint of that training forward against its plain
    version."""
    changes = {**BASE_SPELLER, **SPANS_64[block]}
    lim = speller_cuda.tc_kernel_limits(cuda_device.index or 0)
    cfg, params, enc, lengths = _setup(cuda_device, batch=128, te=192, **changes)
    plan = speller_cuda.plan_decode_tc(128, 192, cfg.att_proj_dim, 1, cfg.dec_lstm_hid_dim,
                                       cfg.dec_lstm_out_dim, 32, lim["sms"], lim["smem_optin"])
    assert [(ln.r0, ln.r1) for ln in plan.launches] == [(0, 64), (64, 128)]
    vocab_tol, w_tol = TOL[torch.bfloat16]
    with torch.inference_mode():
        operands, _ = speller_cuda.decode_operands(params, cfg, enc.to(torch.bfloat16), lengths)
        opts = {**speller_cuda.decode_options(cfg), "steps": 24}
        speller_cuda.reset_launch_counts()
        logits, wgts, ids = speller_cuda.speller_decode(*operands, **opts)
        torch.cuda.synchronize()
        assert speller_cuda.LAUNCHES["speller_decode"] == 2
        own = torch.cat([torch.full_like(ids[:1], -1), ids[:-1]]).contiguous()
        ref_logits, ref_wgts, _ = speller_cuda.speller_decode_plain(*operands, **opts,
                                                                     forced=own)
    v = cfg.dec_vocab_size
    torch.testing.assert_close(logits[..., :v].float(), ref_logits[..., :v].float(),
                               atol=vocab_tol, rtol=0)
    torch.testing.assert_close(wgts.float(), ref_wgts.float(), atol=w_tol, rtol=0)
    args, dwup, kw = _bwd_case(cuda_device, 128, 1, 0.3, changes, hold_forward=True, te=192,
                               launches=2)
    speller_cuda.reset_launch_counts()
    got = speller_cuda.speller_decode_bwd(*args, dwup, **kw)
    torch.cuda.synchronize()
    assert speller_cuda.LAUNCHES["speller_decode_bwd"] == 1
    want = speller_cuda.speller_decode_bwd_plain(*args, dwup, **kw)
    for name, a, b in zip(BWD_NAMES, got, want):
        assert _rel_err(a, b) <= REL_TOL[torch.bfloat16], name


# the Rewriter's decoder (configs/rewriter.yml): H1 256, H2 128, P 128, one
# head, over a BiLSTM of 256 a direction; its encoder length is the text's
REWRITER_SPELLER = {"att_proj_dim": 128, "att_heads": 1, "dec_emb_dim": 256,
                    "dec_lstm_hid_dim": 256, "dec_lstm_out_dim": 128}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,batch,launches", [(torch.float32, 256, 1),
                                                  (torch.bfloat16, 256, 2)])
def test_eval_decode_at_the_rewriter_widths_on_card(cuda_device, dtype, batch, launches):
    """The eval form at the Rewriter's widths over a text-length encoder
    (Te 608, lengths down to 1), against the plain version fed the
    kernel's ids."""
    cfg = las_config_from_dicts({**LISTENER, "uniform_hid_dim": 256},
                                {**SPELLER, **REWRITER_SPELLER})
    gen = torch.Generator().manual_seed(11)
    params = las_init(cfg, gen)["speller"].to(cuda_device)
    lengths = torch.randint(1, 609, (batch,), generator=gen)
    lengths[0] = 608
    enc = (torch.randn(batch, 608, 512, generator=gen) * 0.5).to(cuda_device, dtype)
    vocab_tol, w_tol = TOL[dtype]
    with torch.inference_mode():
        operands, _ = speller_cuda.decode_operands(params, cfg.speller, enc,
                                                   lengths.to(cuda_device))
        opts = {**speller_cuda.decode_options(cfg.speller), "steps": 32}
        speller_cuda.reset_launch_counts()
        logits, wgts, ids = speller_cuda.speller_decode(*operands, **opts)
        torch.cuda.synchronize()
        assert speller_cuda.LAUNCHES["speller_decode"] == launches
        own = torch.cat([torch.full_like(ids[:1], -1), ids[:-1]]).contiguous()
        ref_logits, ref_wgts, _ = speller_cuda.speller_decode_plain(*operands, **opts,
                                                                     forced=own)
    v = cfg.speller.dec_vocab_size
    torch.testing.assert_close(logits[..., :v].float(), ref_logits[..., :v].float(),
                               atol=vocab_tol, rtol=0)
    torch.testing.assert_close(wgts.float(), ref_wgts.float(), atol=w_tol, rtol=0)


# decoder blocks whose resident weight tiles leave the ring fewer than four
# stages even of 64 rows: the bfloat16 forward streams cell 1's weights
# through the ring (NC1 4 with NC2 2 and 1, the two pairs the streamed form
# is built for)
STREAMED = {
    "H1 1024, H2 512, P 1024, 1 head": {"att_proj_dim": 1024, "dec_emb_dim": 2048,
                                        "dec_lstm_hid_dim": 1024, "dec_lstm_out_dim": 512},
    "H1 1024, H2 256, P 1024, 4 heads": {"att_proj_dim": 1024, "dec_emb_dim": 2048,
                                         "dec_lstm_hid_dim": 1024, "dec_lstm_out_dim": 256,
                                         "att_heads": 4},
}


@pytest.mark.cuda
@pytest.mark.parametrize("block", list(STREAMED))
def test_bf16_streamed_cell1_weights_on_card(cuda_device, block):
    """B=128 at the two blocks, Te 192: the eval form in one streamed launch
    against its plain version fed the kernel's ids, then the training form
    (held the same way) and the adjoint of it against its plain version."""
    changes = {**BASE_SPELLER, **STREAMED[block]}
    heads = changes.get("att_heads", 1)
    lim = speller_cuda.tc_kernel_limits(cuda_device.index or 0)
    cfg, params, enc, lengths = _setup(cuda_device, batch=128, te=192, **changes)
    plan = speller_cuda.plan_decode_tc(128, 192, cfg.att_proj_dim, heads, cfg.dec_lstm_hid_dim,
                                       cfg.dec_lstm_out_dim, 32, lim["sms"], lim["smem_optin"])
    assert plan.streamed and [(ln.r0, ln.r1) for ln in plan.launches] == [(0, 128)]
    vocab_tol, w_tol = TOL[torch.bfloat16]
    with torch.inference_mode():
        operands, _ = speller_cuda.decode_operands(params, cfg, enc.to(torch.bfloat16), lengths)
        opts = {**speller_cuda.decode_options(cfg), "steps": 24}
        speller_cuda.reset_launch_counts()
        logits, wgts, ids = speller_cuda.speller_decode(*operands, **opts)
        torch.cuda.synchronize()
        assert speller_cuda.LAUNCHES["speller_decode"] == 1
        own = torch.cat([torch.full_like(ids[:1], -1), ids[:-1]]).contiguous()
        ref_logits, ref_wgts, _ = speller_cuda.speller_decode_plain(*operands, **opts,
                                                                     forced=own)
    v = cfg.dec_vocab_size
    torch.testing.assert_close(logits[..., :v].float(), ref_logits[..., :v].float(),
                               atol=vocab_tol, rtol=0)
    torch.testing.assert_close(wgts.float(), ref_wgts.float(), atol=w_tol, rtol=0)
    args, dwup, kw = _bwd_case(cuda_device, 128, heads, 0.3, changes, hold_forward=True,
                               te=192)
    speller_cuda.reset_launch_counts()
    got = speller_cuda.speller_decode_bwd(*args, dwup, **kw)
    torch.cuda.synchronize()
    assert speller_cuda.LAUNCHES["speller_decode_bwd"] == 1
    want = speller_cuda.speller_decode_bwd_plain(*args, dwup, **kw)
    for name, a, b in zip(BWD_NAMES, got, want):
        assert _rel_err(a, b) <= REL_TOL[torch.bfloat16], name


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
def test_bf16_streamed_form_equals_the_resident_form_on_card(cuda_device, monkeypatch, train):
    """At scaled-LAS's decoder (whose resident tiles fit) the streamed form,
    forced by the plan, gives the resident form's bits: the same operands,
    the same k order and the same sums, only the weights' way into shared
    memory differs."""
    cfg, params, enc, lengths = _setup(cuda_device, batch=100, te=64,
                                       **{**SCALED_LAS_SPELLER, "att_heads": 4})
    with torch.inference_mode():
        operands, _ = speller_cuda.decode_operands(params, cfg, enc.to(torch.bfloat16), lengths)
        opts = {**speller_cuda.decode_options(cfg), "steps": 16}
        fn = speller_cuda.speller_decode_train if train else speller_cuda.speller_decode
        resident = fn(*operands, **opts)
        monkeypatch.setattr(speller_cuda, "_tc_spans", lambda *a: (128, True))
        speller_cuda.reset_launch_counts()
        streamed = fn(*operands, **opts)
        torch.cuda.synchronize()
    assert sum(speller_cuda.LAUNCHES.values()) == 1
    for a, b in zip(resident[:3], streamed[:3]):
        assert torch.equal(a, b)
    if train:
        for name, a, b in zip(speller_cuda.RESIDUALS, resident[3], streamed[3]):
            assert torch.equal(a, b), name


# -- the float32 adjoint's plan (csrc/speller_bwd.cu, plan_decode_bwd_f32) ----

@pytest.mark.cuda
def test_f32_bwd_plan_mirrors_the_source_on_card(cuda_device):
    """The float32 adjoint plan's constants and shared-memory count are the
    built source's."""
    lib = speller_cuda.load_bwd_library()
    lim = speller_cuda.bwd_kernel_limits(torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert {k: lim[k] for k in speller_cuda.BWD_F32_LIMITS} == speller_cuda.BWD_F32_LIMITS
    assert lim["sms"] == sms and lim["smem_optin"] >= 48 * 1024
    for shape in [(128, 192, 256, 1, 512, 256), (32, 192, 256, 4, 1024, 256),
                  (5, 37, 64, 2, 128, 64), (8, 704, 256, 4, 1024, 256),
                  (8, 192, 256, 1, 640, 128), (64, 608, 128, 1, 256, 128)]:
        plan = speller_cuda.plan_decode_bwd_f32(*shape, lim["sms"], lim["smem_optin"])
        batch, te, proj, heads, h1, h2 = shape
        dims = (ctypes.c_int * 7)(batch, te, 1, proj, heads, h1, h2)
        geom = speller_cuda.bwd_f32_geometry(plan)
        geom = (ctypes.c_int * len(geom))(*geom)
        assert lib.speller_bwd_smem_bytes(dims, geom) == plan.smem, (shape, plan)


def _f32_bwd_case(device, batch, te, steps, changes, seed=0):
    """The float32 adjoint's operands from a float32 training forward with
    dropout, and cotangents of q, the context and the weights."""
    cfg, params, enc, lengths = _setup(device, batch=batch, te=te, **changes)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        operands, _ = speller_cuda.decode_operands(params, cfg, enc, lengths)
    opts = {**speller_cuda.decode_options(cfg), "steps": steps}
    m1, m2 = (((torch.rand(steps, batch, h, generator=gen) < 0.7).float() / 0.7).to(device)
              for h in (cfg.dec_lstm_hid_dim, cfg.dec_lstm_out_dim))
    _, wgts, _, saved = speller_cuda.speller_decode_train(*operands, **opts, m1=m1, m2=m2)
    k, v, _, _, _, c10, _, c20, _, wc1, whh1, wih2, whh2, _, wq = operands[:15]
    _, gates1, c1, _, gates2, c2, _, _ = saved
    proj = k.shape[2]
    dqup, dctxup = ((torch.randn(steps, batch, proj, generator=gen) * 0.1).to(device)
                    for _ in range(2))
    dwup = (torch.randn(*wgts.shape, generator=gen) * 0.1).to(device)
    args = (k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1, gates2, c2, wgts, m1, m2,
            dqup, dctxup, dwup)
    return args, {"heads": opts["heads"], "scale": opts["scale"]}


# speller blocks the earlier float32 adjoint refused: 5 cell-1 units a block
# on its grid of 128; scaled-LAS's widths past Te = 640 (its shared memory)
F32_REFUSED_BEFORE = {
    "H1 640, H2 128, P 256": (8, 16, {"att_proj_dim": 256, "dec_emb_dim": 512,
                                      "dec_lstm_hid_dim": 640, "dec_lstm_out_dim": 128,
                                      "att_heads": 1}),
    "scaled-LAS at Te=704": (4, 704, {**SCALED_LAS_SPELLER, "att_heads": 4}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("block", list(F32_REFUSED_BEFORE))
def test_f32_bwd_at_shapes_the_earlier_adjoint_refused_on_card(cuda_device, block):
    batch, te, changes = F32_REFUSED_BEFORE[block]
    args, kw = _f32_bwd_case(cuda_device, batch, te, 12, changes)
    speller_cuda.reset_launch_counts()
    got = speller_cuda.speller_decode_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert speller_cuda.LAUNCHES["speller_decode_bwd"] == 1
    want = speller_cuda.speller_decode_bwd_plain(*args, **kw)
    for name, a, b in zip(BWD_NAMES, got, want):
        assert _rel_err(a, b) <= REL_TOL[torch.float32], name
    assert bool((got[4][args[13] == 0] == 0).all())
