"""PyTorch port, the fused speller-decode CUDA kernel against its plain
version on the card. Free of JAX, so it runs on a machine with a card and no
JAX:

    python -m pytest tests/test_torch_speller_cuda.py -m cuda --noconftest

Every test here skips without a CUDA device."""

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
        assert speller_cuda.LAUNCHES == {"speller_decode": 1}
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
        # H1 96 = 32 blocks x 3 units
        cfg3, params3, enc3, lengths3 = _setup(cuda_device, batch=2, te=8,
                                               dec_lstm_hid_dim=96)
        operands3, _ = speller_cuda.decode_operands(params3, cfg3, enc3, lengths3)
        with pytest.raises(ValueError, match="1, 2, 4 or 8"):
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
    assert lim["max_grid"] <= sms and lim["max_units"] >= 1 and lim["vmax"] >= 32
    assert lim["nthreads"] % 32 == 0 and lim["smem_optin"] >= 48 * 1024
