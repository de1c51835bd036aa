"""PyTorch port, the additive attention score's kernel
(``csrc/speller_additive.cu``) and its adjoint against their plain versions
on the card, at the chiu-las cell's shapes. Free of JAX:

    python -m pytest tests/test_torch_speller_additive_cuda.py -m cuda --noconftest

Every test here skips without a CUDA device."""

import pytest
import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_additive as sa
from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda

# of the largest magnitude. bfloat16: the kernel sums in fp32 in another
# order, its tanh is tanh.approx.f32 (~2^-11 relative) and its outputs are
# rounded to bf16, so an entry may land one bf16 step off, 2^-7 of a score
# near 1.5 (first card run: 5.1e-3 on the scores, 3.3e-3 on dk). float32:
# tanhf and the summation order alone (first card run: ~2e-7).
TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _operands(device, batch, te, heads, d, dtype, low):
    gen = torch.Generator(device=device).manual_seed(batch * te + d)
    q = (torch.rand(batch, heads, d, generator=gen, device=device) * 2 - 1).to(dtype)
    k = (torch.rand(batch, te, heads, d, generator=gen, device=device) * 2 - 1).to(dtype)
    v = ((torch.rand(heads, d, generator=gen, device=device) * 2 - 1) / d ** 0.5).to(dtype)
    lx = torch.randint(low, te + 1, (batch,), generator=gen, device=device)
    lx[0] = te
    mask = torch.arange(te, device=device)[None, :] >= lx[:, None]
    ds = torch.randn(batch, heads, te, generator=gen, device=device).to(dtype)
    return q, k, v, mask, ds


def _gap(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("batch,te,heads,d,dtype,low", [
    (128, 512, 4, 256, torch.bfloat16, 237),   # the cell's longer shape
    (128, 384, 4, 256, torch.bfloat16, 237),   # and its shorter one
    (5, 33, 4, 8, torch.bfloat16, 1),          # a d_head of one chunk
    (8, 77, 2, 1024, torch.bfloat16, 5),       # the widest d_head
    (16, 100, 3, 72, torch.float32, 5),        # chunks not a multiple of the warp
    (8, 77, 2, 520, torch.float32, 5),
])
def test_kernel_and_adjoint_match_the_plain_versions(cuda_device, batch, te, heads, d, dtype,
                                                     low):
    q, k, v, mask, ds = _operands(cuda_device, batch, te, heads, d, dtype, low)
    speller_cuda.reset_launch_counts()
    got = sa.additive_scores_forward(q, k, v, mask)
    dq, dk, dv = sa.additive_scores_backward(q, k, v, mask, ds)
    torch.cuda.synchronize()
    assert (speller_cuda.LAUNCHES["speller_additive_scores"],
            speller_cuda.LAUNCHES["speller_additive_scores_bwd"]) == (1, 1)
    want = sa.additive_scores_plain(q, k, v, mask)
    pad = mask[:, None, :].expand_as(want)
    assert bool((got[pad] == torch.finfo(dtype).min).all())
    assert _gap(got[~pad], want[~pad]) <= TOL[dtype]
    assert bool((dk[mask] == 0).all())
    for a, b in zip((dq, dk, dv), sa.additive_scores_bwd_plain(q, k, v, mask, ds)):
        assert a.dtype == b.dtype and _gap(a, b) <= TOL[dtype]


@pytest.mark.cuda
def test_the_function_takes_the_kernels_both_ways(cuda_device):
    q, k, v, mask, ds = _operands(cuda_device, 16, 96, 4, 64, torch.bfloat16, 20)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    speller_cuda.reset_launch_counts()
    out = sa.additive_scores(*leaves, mask)
    grads = torch.autograd.grad(out, leaves, ds)
    assert (speller_cuda.LAUNCHES["speller_additive_scores"],
            speller_cuda.LAUNCHES["speller_additive_scores_bwd"]) == (1, 1)
    for a, b in zip(grads, sa.additive_scores_backward(q, k, v, mask, ds)):
        assert torch.equal(a, b)  # the adjoint is deterministic: no atomics


@pytest.mark.cuda
def test_the_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q, k, v, mask, _ = _operands(cuda_device, 4, 16, 2, 12, torch.bfloat16, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        sa.additive_scores_forward(q, k, v, mask)
    q, k, v, mask, _ = _operands(cuda_device, 4, 16, 2, 16, torch.bfloat16, 2)
    with pytest.raises(ValueError, match="contiguous"):
        sa.additive_scores_forward(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, mask)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sa.additive_scores_forward(q.half(), k.half(), v.half(), mask)
