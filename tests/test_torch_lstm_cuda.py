"""PyTorch port, the LSTM-recurrence CUDA kernels against their plain
versions on the card. Free of JAX, so it runs on a machine with a card and
no JAX:

    python -m pytest tests/test_torch_lstm_cuda.py -m cuda --noconftest

Every test here skips without a CUDA device."""

import pytest
import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_kernels_match_plain_on_card(cuda_device, fused, dtype, atol):
    gen = torch.Generator().manual_seed(7)
    batch, seq_len, hidden, in_dim = 5, 37, 64, (15 if fused else 2 * 4 * 64)
    lengths = torch.tensor([37, 1, 20, 36, 9], dtype=torch.int32, device=cuda_device)
    k = hidden ** -0.5
    w_hh = ((torch.rand(2, hidden, 4 * hidden, generator=gen) * 2 - 1) * k).to(cuda_device, dtype)
    if fused:
        x = torch.randn(batch, seq_len, in_dim, generator=gen).to(cuda_device, dtype)
        w_ih = ((torch.rand(2, in_dim, 4 * hidden, generator=gen) * 2 - 1) * k).to(cuda_device, dtype)
        b = ((torch.rand(2, 4 * hidden, generator=gen) * 2 - 1) * k).to(cuda_device, dtype)
        args = (x, w_ih, b, w_hh, lengths, (False, True))
        kern, plain = lstm_cuda.lstm_scan_fusedin, lstm_cuda.lstm_scan_fusedin_plain
    else:
        x = (torch.rand(batch, seq_len, in_dim, generator=gen) - 0.5).to(cuda_device, dtype)
        args = (x, w_hh, lengths, (False, True))
        kern, plain = lstm_cuda.lstm_scan, lstm_cuda.lstm_scan_plain
    got = kern(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    assert got.dtype == dtype and got.shape == (batch, seq_len, 2 * hidden)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
def test_kernel_rejects_unsupported_shapes_on_card(cuda_device):
    with pytest.raises(ValueError, match="empty batch"):
        lstm_cuda.lstm_scan(torch.zeros(0, 4, 128, device=cuda_device),
                            torch.zeros(1, 32, 128, device=cuda_device),
                            torch.ones(0, dtype=torch.int32), (False,))
    with pytest.raises(ValueError, match="multiple of 32"):
        lstm_cuda.lstm_scan(torch.zeros(2, 4, 80, device=cuda_device),
                            torch.zeros(1, 20, 80, device=cuda_device),
                            torch.ones(2, dtype=torch.int32), (False,))


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_single_direction_and_launch_count_on_card(cuda_device, reverse):
    gen = torch.Generator().manual_seed(8)
    params = {"w_ih": torch.rand(200, 128, generator=gen) - 0.5,
              "w_hh": (torch.rand(32, 128, generator=gen) - 0.5) * 0.3,
              "b": torch.rand(128, generator=gen) - 0.5}
    x = torch.randn(3, 16, 200, generator=gen)
    lengths = torch.tensor([16, 9, 1], dtype=torch.int32)
    ref = lstm_cuda.lstm_apply_kernel(params, x, lengths, reverse)  # CPU: plain
    lstm_cuda.reset_launch_counts()
    got = lstm_cuda.lstm_apply_kernel({k: v.to(cuda_device) for k, v in params.items()},
                                      x.to(cuda_device), lengths.to(cuda_device), reverse)
    assert lstm_cuda.LAUNCHES == {**dict.fromkeys(lstm_cuda.LAUNCHES, 0), "lstm_scan": 1}
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_kernel_rejects_float16_on_card(cuda_device):
    with pytest.raises(ValueError, match="not supported"):
        lstm_cuda.lstm_scan(torch.zeros(2, 4, 128, device=cuda_device, dtype=torch.float16),
                            torch.zeros(1, 32, 128, device=cuda_device, dtype=torch.float16),
                            torch.ones(2, dtype=torch.int32), (False,))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [40, 64, 2000])
@pytest.mark.parametrize("fused", [True, False])
def test_kernels_take_batches_past_32_rows_on_card(cuda_device, batch, fused):
    """A batch wider than the earlier float32 kernel's 32 rows a launch runs
    as the plan's launches (one up to the rows the card holds at once, two
    at B=2000) and equals the plain version."""
    gen = torch.Generator().manual_seed(batch)
    seq_len, hidden = 23, 64
    in_dim = 15 if fused else 2 * 4 * hidden
    lengths = torch.randint(1, seq_len + 1, (batch,), generator=gen).to(torch.int32)
    lengths[0] = seq_len
    lengths = lengths.to(cuda_device)
    k = hidden ** -0.5
    w_hh = ((torch.rand(2, hidden, 4 * hidden, generator=gen) * 2 - 1) * k).to(cuda_device)
    if fused:
        x = torch.randn(batch, seq_len, in_dim, generator=gen).to(cuda_device)
        w_ih = ((torch.rand(2, in_dim, 4 * hidden, generator=gen) * 2 - 1) * k).to(cuda_device)
        b = ((torch.rand(2, 4 * hidden, generator=gen) * 2 - 1) * k).to(cuda_device)
        args = (x, w_ih, b, w_hh, lengths, (False, True))
        kern, plain = lstm_cuda.lstm_scan_fusedin, lstm_cuda.lstm_scan_fusedin_plain
    else:
        x = (torch.rand(batch, seq_len, in_dim, generator=gen) - 0.5).to(cuda_device)
        args = (x, w_hh, lengths, (False, True))
        kern, plain = lstm_cuda.lstm_scan, lstm_cuda.lstm_scan_plain
    lstm_cuda.reset_launch_counts()
    got = kern(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES[kern.__name__] == _forward_launches(
        cuda_device, torch.float32, batch, hidden, 2, in_dim if fused else 0) == (
        2 if batch > 1024 else 1)
    assert got.shape == (batch, seq_len, 2 * hidden)
    torch.testing.assert_close(got, plain(*args), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# The training forward (lstm_scan_train / lstm_scan_fusedin_train) and the
# adjoint (lstm_bwd_dw)
# ---------------------------------------------------------------------------

def _batch_dtypes(batches):
    """(batch, dtype) cases: each of ``batches`` in both dtypes, then the
    bfloat16 forward's own batches: 96 (base-LAS's), 128 (one launch's rows)
    and 129 (two launches)."""
    return ([(b, dt) for dt in (torch.float32, torch.bfloat16) for b in batches]
            + [(b, torch.bfloat16) for b in (96, 128, 129)])


def _forward_launches(device, dtype, batch, hidden, ndir, in_dim=0):
    """The plan's launches for a call (``in_dim``: the fused input's width,
    whose shared memory the float32 plan counts)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return len(lstm_cuda.plan_launches("test", dtype, batch, hidden, ndir, sms, in_dim))


def _adjoint_launches(device, dtype, batch, hidden, ndir, with_dw):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return len(lstm_cuda.plan_bwd_launches("test", dtype, batch, hidden, ndir, sms, with_dw))


def _train_case(device, batch, hidden, dtype, ndir, fused, seed=0):
    gen = torch.Generator().manual_seed(1000 * batch + hidden + seed)
    seq_len = 19
    lengths = torch.randint(1, seq_len + 1, (batch,), generator=gen).to(torch.int32)
    lengths[0], lengths[-1] = seq_len, 1
    k = hidden ** -0.5
    reverse = (False, True)[:ndir]

    def uniform(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * k).to(device, dtype)

    w_hh = uniform(ndir, hidden, 4 * hidden)
    if fused:
        args = (torch.randn(batch, seq_len, 15, generator=gen).to(device, dtype),
                uniform(ndir, 15, 4 * hidden), uniform(ndir, 4 * hidden), w_hh)
    else:
        args = ((torch.rand(batch, seq_len, ndir * 4 * hidden, generator=gen) - 0.5)
                .to(device, dtype), w_hh)
    dy = torch.randn(batch, seq_len, ndir * hidden, generator=gen).to(device, dtype)
    return args, lengths.to(device), reverse, dy


# float32: summation order only. bfloat16: outputs are bf16 and an order
# difference that flips one rounding carries along the recurrence: two bf16
# steps (2 * 2**-8) of the compared tensor's largest magnitude.
def _tol(dtype, ref):
    if dtype == torch.float32:
        return 1e-4
    return 2.0 ** -7 * max(float(ref.float().abs().max()), 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,dtype", _batch_dtypes([5, 32, 40, 64]))
@pytest.mark.parametrize("hidden,ndir", [(64, 1), (64, 2), (512, 2)])
@pytest.mark.parametrize("fused", [True, False])
def test_train_kernels_match_plain_on_card(cuda_device, batch, hidden, ndir, dtype, fused):
    _check_train_kernels(cuda_device, batch, hidden, ndir, dtype, fused)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,dtype", _batch_dtypes([5, 40]))
@pytest.mark.parametrize("hidden,ndir", [(1024, 1), (1024, 2), (768, 2)])
@pytest.mark.parametrize("fused", [True, False])
def test_wide_train_kernels_match_plain_on_card(cuda_device, batch, hidden, ndir, dtype, fused):
    """Above H = 512: the float32 forward stages its exchange in two halves
    and takes one launch a direction, the bfloat16 forward runs 16 units a
    block with both directions in one launch; the adjoint is ``lstm_bwd``
    with the outside dW_hh product."""
    _check_train_kernels(cuda_device, batch, hidden, ndir, dtype, fused)


def _check_train_kernels(cuda_device, batch, hidden, ndir, dtype, fused):
    args, lengths, reverse, dy = _train_case(cuda_device, batch, hidden, dtype, ndir, fused)
    lean, train, train_plain = (
        (lstm_cuda.lstm_scan_fusedin, lstm_cuda.lstm_scan_fusedin_train,
         lstm_cuda.lstm_scan_fusedin_train_plain) if fused else
        (lstm_cuda.lstm_scan, lstm_cuda.lstm_scan_train, lstm_cuda.lstm_scan_train_plain))
    wide = hidden > 512
    # the adjoint's plan: bfloat16 one launch per 128 rows with every
    # direction; float32 every row the card holds, a launch a direction where
    # both do not fit
    n_adjoint = _adjoint_launches(cuda_device, dtype, batch, hidden, ndir, not wide)
    lstm_cuda.reset_launch_counts()
    hs, cs, gates = train(*args, lengths, reverse)
    dpre, d_whh = lstm_cuda._adjoint(gates, cs, hs, dy, args[-1], lengths, reverse)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES[train.__name__] == _forward_launches(
        cuda_device, dtype, batch, hidden, ndir, 15 if fused else 0)
    assert lstm_cuda.LAUNCHES["lstm_bwd" if wide else "lstm_bwd_dw"] == n_adjoint
    assert lstm_cuda.LAUNCHES["lstm_bwd_dw" if wide else "lstm_bwd"] == 0
    # hs of the training forward is the lean forward's, bit for bit
    assert torch.equal(hs, lean(*args, lengths, reverse))
    p_hs, p_cs, p_gates = train_plain(*args, lengths, reverse)
    for got, ref in ((hs, p_hs), (cs, p_cs), (gates, p_gates)):
        assert got.dtype == dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), atol=_tol(dtype, ref), rtol=0)
    # the adjoint on the kernel's own streams, against the plain adjoint on them
    p_dpre, p_dwhh = lstm_cuda.lstm_bwd_dw_plain(gates, cs, hs, dy, args[-1], lengths, reverse)
    assert dpre.dtype == dtype and d_whh.dtype == torch.float32
    torch.testing.assert_close(dpre.float(), p_dpre.float(), atol=_tol(dtype, p_dpre), rtol=0)
    torch.testing.assert_close(d_whh, p_dwhh, atol=_tol(dtype, p_dwhh), rtol=0)
    pads = torch.arange(hs.shape[1], device=cuda_device)[None, :] >= lengths[:, None]
    assert dpre[pads].abs().max().item() == 0.0
    # the kernel without dW_hh against its own plain version and, where both
    # take the width, against the kernel with it; the outside product against
    # the sum inside the kernel
    nodw = lstm_cuda.lstm_bwd(gates, cs, dy, args[-1], lengths, reverse)
    p_nodw = lstm_cuda.lstm_bwd_plain(gates, cs, dy, args[-1], lengths, reverse)
    torch.testing.assert_close(nodw.float(), p_nodw.float(), atol=_tol(dtype, p_nodw), rtol=0)
    torch.testing.assert_close(nodw.float(), dpre.float(), atol=_tol(dtype, dpre), rtol=0)
    torch.testing.assert_close(lstm_cuda.dw_hh_outside(hs, nodw, reverse), p_dwhh,
                               atol=_tol(dtype, p_dwhh), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_functions_backward_on_card(cuda_device, fused):
    """The autograd Functions on CUDA tensors: every gradient against the
    same Function on the CPU (the plain versions), float32."""
    args, lengths, reverse, dy = _train_case(cuda_device, 40, 64, torch.float32, 2, fused)
    fn = lstm_cuda.lstm_scan_fusedin if fused else lstm_cuda.lstm_scan
    leaves = [a.clone().requires_grad_(True) for a in args]
    cpu_leaves = [a.cpu().requires_grad_(True) for a in args]
    lstm_cuda.reset_launch_counts()
    out = fn(*leaves, lengths, reverse)
    got = torch.autograd.grad(out, leaves, dy)
    torch.cuda.synchronize()
    name = "lstm_scan_fusedin_train" if fused else "lstm_scan_train"
    n_fwd = _forward_launches(cuda_device, torch.float32, 40, 64, 2, 15 if fused else 0)
    n_adjoint = _adjoint_launches(cuda_device, torch.float32, 40, 64, 2, True)
    assert lstm_cuda.LAUNCHES == {**dict.fromkeys(lstm_cuda.LAUNCHES, 0),
                                  name: n_fwd, "lstm_bwd_dw": n_adjoint}
    want = torch.autograd.grad(fn(*cpu_leaves, lengths.cpu(), reverse), cpu_leaves, dy.cpu())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)
    with torch.no_grad():  # no gradient wanted: the lean kernel
        fn(*leaves, lengths, reverse)
    assert lstm_cuda.LAUNCHES[name] == n_fwd


@pytest.mark.cuda
def test_adjoint_rejects_unsupported_shapes_on_card(cuda_device):
    def call(hidden, device=cuda_device, batch=2):
        g = torch.zeros(batch, 4, 4 * hidden, device=device)
        h = torch.zeros(batch, 4, hidden, device=device)
        return lstm_cuda._launch_bwd(g, h, h, h, torch.zeros(1, hidden, 4 * hidden, device=device),
                                     torch.ones(batch, dtype=torch.int32), (False,))

    with pytest.raises(ValueError, match="hidden 1024.*takes H <= 512.*lstm_bwd's"):
        call(1024)
    with pytest.raises(ValueError, match="multiple of 64 and at most 1024"):
        lstm_cuda.lstm_bwd(torch.zeros(2, 4, 4 * 2048, device=cuda_device),
                           torch.zeros(2, 4, 2048, device=cuda_device),
                           torch.zeros(2, 4, 2048, device=cuda_device),
                           torch.zeros(1, 2048, 4 * 2048, device=cuda_device),
                           torch.ones(2, dtype=torch.int32), (False,))
    with pytest.raises(ValueError, match="multiple of 32"):
        call(48)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        call(64, device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        lstm_cuda._launch("lstm_scan_train", False, True, torch.zeros(2, 4, 128), None, None,
                          torch.zeros(1, 32, 128), torch.ones(2, dtype=torch.int32), (False,))


def _ragged(batch, seq_len, gen):
    lengths = torch.randint(1, seq_len + 1, (batch,), generator=gen)
    lengths[0], lengths[min(1, batch - 1)] = seq_len, 1
    return lengths.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,dtype", _batch_dtypes([5, 40]))
@pytest.mark.parametrize("hidden,ndir", [(64, 1), (64, 2), (512, 2), (1024, 2)])
def test_scan_cs_streams_are_the_lean_and_train_kernels_on_card(cuda_device, batch, hidden,
                                                                ndir, dtype):
    """``lstm_scan_cs``: hs bit-equal to ``lstm_scan``'s, cs bit-equal to
    ``lstm_scan_train``'s, both close to the plain version."""
    gen = torch.Generator().manual_seed(21 + hidden + batch)
    seq_len = 29
    lengths = _ragged(batch, seq_len, gen).to(cuda_device)
    k = hidden ** -0.5
    w_hh = ((torch.rand(ndir, hidden, 4 * hidden, generator=gen) * 2 - 1) * k).to(cuda_device, dtype)
    x_proj = (torch.rand(batch, seq_len, ndir * 4 * hidden, generator=gen) - 0.5).to(
        cuda_device, dtype)
    rev = (False, True)[:ndir]
    lstm_cuda.reset_launch_counts()
    hs, cs = lstm_cuda.lstm_scan_cs(x_proj, w_hh, lengths, rev)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES["lstm_scan_cs"] == _forward_launches(
        cuda_device, dtype, batch, hidden, ndir)
    with torch.no_grad():
        assert torch.equal(hs, lstm_cuda.lstm_scan(x_proj, w_hh, lengths, rev))
    assert torch.equal(cs, lstm_cuda.lstm_scan_train(x_proj, w_hh, lengths, rev)[1])
    p_hs, p_cs = lstm_cuda.lstm_scan_cs_plain(x_proj, w_hh, lengths, rev)
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(hs.float(), p_hs.float(), atol=atol, rtol=0)
    torch.testing.assert_close(cs.float(), p_cs.float(), atol=2 * atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,dtype", _batch_dtypes([1, 5, 32, 40]))
@pytest.mark.parametrize("hidden", [64, 512])
def test_bilstm_scan_fused_matches_plain_on_card(cuda_device, batch, hidden, dtype):
    """hs and cs at every frame, the padded ones included (direction 0 the
    frozen carry, direction 1 zeros), any batch from one row on."""
    gen = torch.Generator().manual_seed(31 + hidden + batch)
    seq_len = 23
    lengths = _ragged(batch, seq_len, gen).to(cuda_device)
    k = hidden ** -0.5
    w_hh = ((torch.rand(2, hidden, 4 * hidden, generator=gen) * 2 - 1) * k).to(cuda_device, dtype)
    xp = (torch.rand(seq_len, 2, batch, 4 * hidden, generator=gen) - 0.5).to(cuda_device, dtype)
    lstm_cuda.reset_launch_counts()
    hs, cs = lstm_cuda.bilstm_scan_fused(xp, w_hh, lengths)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES["bilstm_scan_fused"] == _forward_launches(
        cuda_device, dtype, batch, hidden, 2)
    assert hs.shape == cs.shape == (seq_len, 2, batch, hidden) and hs.dtype == dtype
    p_hs, p_cs = lstm_cuda.bilstm_scan_fused_plain(xp, w_hh, lengths)
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(hs.float(), p_hs.float(), atol=atol, rtol=0)
    torch.testing.assert_close(cs.float(), p_cs.float(), atol=2 * atol, rtol=0)
    t = torch.arange(seq_len, device=cuda_device)[:, None]
    pads1 = t < seq_len - lengths[None, :].long()                 # direction 1: pads first
    assert hs[:, 1][pads1].abs().max().item() == 0 if pads1.any() else True
    row = min(1, batch - 1)                                       # the length-1 row
    if batch > 1:
        assert torch.equal(hs[-1, 0, row], hs[0, 0, row]) and hs[0, 0, row].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)])
def test_bilstm_apply_fused_forward_backward_on_card(cuda_device, dtype, tol):
    """The op on the kernels against the op on the plain versions (CPU
    tensors) and against the two-kernel op on the card: output and every
    gradient, over the largest entry of the reference."""
    gen = torch.Generator().manual_seed(41)
    batch, seq_len, in_dim, hidden = 40, 19, 160, 64
    lengths = _ragged(batch, seq_len, gen)
    k = hidden ** -0.5

    def one():
        return {"w_ih": (torch.rand(in_dim, 4 * hidden, generator=gen) * 2 - 1) * k,
                "w_hh": (torch.rand(hidden, 4 * hidden, generator=gen) * 2 - 1) * k,
                "b": (torch.rand(4 * hidden, generator=gen) * 2 - 1) * k}

    params = {"fwd": one(), "bwd": one()}
    x = torch.randn(batch, seq_len, in_dim, generator=gen)
    r = torch.randn(batch, seq_len, 2 * hidden, generator=gen)

    def run(fn, device):
        leaves = {d: {n: t.to(device, dtype).requires_grad_(True) for n, t in p.items()}
                  for d, p in params.items()}
        xx = x.to(device, dtype).requires_grad_(True)
        out = fn(leaves, xx, lengths.to(device))
        flat = [xx] + [t for p in leaves.values() for t in p.values()]
        grads = torch.autograd.grad((out.float() * r.to(device)).sum(), flat)
        return [out.detach().float().cpu()] + [g.float().cpu() for g in grads]

    lstm_cuda.reset_launch_counts()
    got = run(lstm_cuda.bilstm_apply_fused, cuda_device)
    assert lstm_cuda.LAUNCHES["bilstm_scan_fused"] == _forward_launches(
        cuda_device, dtype, batch, hidden, 2)
    assert lstm_cuda.LAUNCHES["lstm_bwd"] == _adjoint_launches(
        cuda_device, dtype, batch, hidden, 2, False)
    for ref in (run(lstm_cuda.bilstm_apply_fused, "cpu"),
                run(lstm_cuda.bilstm_apply_kernel, cuda_device)):
        for a, b in zip(got, ref):
            assert (a - b).abs().max() <= tol * b.abs().max()


@pytest.mark.cuda
def test_bilstm_scan_fused_refuses_a_wide_layer_on_card(cuda_device):
    """Above H = 512 in either dtype (in float32 2 x 128 blocks are more than
    the card's SMs): no quiet split."""
    for dtype in (torch.float32, torch.bfloat16):
        xp = torch.zeros(4, 2, 3, 4096, device=cuda_device, dtype=dtype)
        w_hh = torch.zeros(2, 1024, 4096, device=cuda_device, dtype=dtype)
        with pytest.raises(ValueError, match="bilstm_apply_kernel"):
            lstm_cuda.bilstm_scan_fused(xp, w_hh, torch.ones(3, dtype=torch.int32))
    xp = torch.zeros(4, 2, 3, 4096, device=cuda_device)
    w_hh = torch.zeros(2, 1024, 4096, device=cuda_device)
    with pytest.raises(ValueError, match=r"\(T, 2, B, 4H\)"):
        lstm_cuda.bilstm_scan_fused(xp[:, :1].contiguous(), w_hh[:, :64, :256].contiguous(),
                                    torch.ones(3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# The bfloat16 adjoint on tensor cores (csrc/lstm_bwd_tc.cu)
# ---------------------------------------------------------------------------

def _adjoint_case(device, batch, hidden, ndir, seq_len, seed=3,
                  dtype=torch.bfloat16):
    """Saved streams as the training forward leaves them (gates i, f, o in
    (0, 1) and g in (-1, 1)), in ``dtype``, ragged lengths with a full and a
    length-1 row."""
    gen = torch.Generator().manual_seed(seed + 1000 * batch + hidden)
    four_h = 4 * hidden
    gates = torch.rand(batch, seq_len, ndir * four_h, generator=gen)
    for d in range(ndir):
        g = slice(d * four_h + 2 * hidden, d * four_h + 3 * hidden)
        gates[..., g] = gates[..., g] * 2 - 1
    streams = [torch.randn(batch, seq_len, ndir * hidden, generator=gen) for _ in range(3)]
    w_hh = (torch.rand(ndir, hidden, four_h, generator=gen) * 2 - 1) * hidden ** -0.5
    lengths = _ragged(batch, seq_len, gen).to(device)
    cs, hs, dy = (t.to(device, dtype) for t in streams)
    return (gates.to(device, dtype), cs, hs, dy, w_hh.to(device, dtype), lengths,
            (False, True)[:ndir])


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden", [(5, 64), (128, 512), (129, 512), (40, 1024)])
def test_bf16_adjoint_repeats_bit_for_bit_on_card(cuda_device, batch, hidden):
    """Two calls on the same inputs give the same bits: a fixed summation
    order, no atomics, the partial dW_hh of two launches summed in order."""
    gates, cs, hs, dy, w_hh, lengths, rev = _adjoint_case(cuda_device, batch, hidden, 2, 11)
    first = lstm_cuda.lstm_bwd(gates, cs, dy, w_hh, lengths, rev)
    assert torch.equal(first, lstm_cuda.lstm_bwd(gates, cs, dy, w_hh, lengths, rev))
    if hidden <= 512:
        dpre, d_whh = lstm_cuda.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev)
        again = lstm_cuda.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev)
        assert torch.equal(dpre, again[0]) and torch.equal(d_whh, again[1])


def _lengths_across_groups(batch, seq_len, gen):
    """Lengths ragged within each row group of the adjoint's launches (a
    longest and a length-1 row in each) and across them: every group's rows
    at most half the frames but a launch's last group's, which reach all."""
    lengths = torch.empty(batch, dtype=torch.int32)
    for r0, r1 in lstm_cuda.row_chunks(batch, 128):
        groups = lstm_cuda.bwd_tc_row_groups(r1 - r0, 2 if r1 - r0 > 64 else 1)
        for g, (g0, g1) in enumerate(groups):
            high = seq_len if g == len(groups) - 1 else max(1, seq_len // 2)
            lengths[r0 + g0:r0 + g1] = torch.randint(1, high + 1, (g1 - g0,), generator=gen)
            lengths[r0 + g0], lengths[r0 + g1 - 1] = high, 1
    return lengths


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden", [(128, 512), (129, 512), (96, 512), (65, 512),
                                          (64, 512), (33, 512), (96, 256), (128, 64)])
def test_bf16_adjoint_forms_give_the_same_dpre_on_card(cuda_device, batch, hidden):
    """``lstm_bwd``'s dpre is ``lstm_bwd_dw``'s bit for bit (the dW products
    never touch dh's sums), each form repeats bit for bit, and both agree
    with the plain versions. Past 64 rows up to H=512 a launch runs two row
    groups, each a chain of its own, as the counter of launches by row groups
    shows (B=129: a launch of 128 rows in two groups, one of a row in one,
    their partial dW_hh summed in order); the lengths differ within and
    across the groups."""
    seq_len = 13
    gates, cs, hs, dy, w_hh, _, rev = _adjoint_case(cuda_device, batch, hidden, 2, seq_len)
    lengths = _lengths_across_groups(batch, seq_len,
                                     torch.Generator().manual_seed(batch)).to(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = lstm_cuda.plan_bwd_launches("test", torch.bfloat16, batch, hidden, 2, sms, True)
    lstm_cuda.reset_launch_counts()
    nodw = lstm_cuda.lstm_bwd(gates, cs, dy, w_hh, lengths, rev)
    dpre, d_whh = lstm_cuda.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev)
    torch.cuda.synchronize()
    n = 1 if batch <= 128 else 2
    assert lstm_cuda.LAUNCHES["lstm_bwd"] == lstm_cuda.LAUNCHES["lstm_bwd_dw"] == n
    want = dict.fromkeys(lstm_cuda.ADJOINT_ROW_GROUPS, 0)
    for ln in plan:
        want[ln.groups] += 2
    assert lstm_cuda.ADJOINT_ROW_GROUPS == want
    assert plan[0].groups == (2 if batch > 64 and hidden <= 512 else 1)
    assert torch.equal(nodw, dpre)
    assert torch.equal(nodw, lstm_cuda.lstm_bwd(gates, cs, dy, w_hh, lengths, rev))
    again = lstm_cuda.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev)
    assert torch.equal(dpre, again[0]) and torch.equal(d_whh, again[1])
    p_dpre, p_dwhh = lstm_cuda.lstm_bwd_dw_plain(gates, cs, hs, dy, w_hh, lengths, rev)
    torch.testing.assert_close(dpre.float(), p_dpre.float(), atol=_tol(torch.bfloat16, p_dpre),
                               rtol=0)
    torch.testing.assert_close(d_whh, p_dwhh, atol=_tol(torch.bfloat16, p_dwhh), rtol=0)
    pads = torch.arange(seq_len, device=cuda_device)[None, :] >= lengths[:, None]
    assert dpre[pads].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("batch,groups", [(96, 2), (64, 1)])
def test_base_las_train_step_adjoint_row_groups_on_card(cuda_device, batch, groups):
    """A bfloat16 base-LAS train step on the kernel tiers launches the
    listener's adjoint four times, one launch a layer: in two row groups at
    B=96, in one at B=64."""
    import os

    import yaml

    from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
        las_apply,
        las_config_from_dicts,
        las_init,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.training.optim import build_optimizer
    from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
        create_train_state,
        make_train_step,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "base-las.yml")) as fh:
        model = yaml.safe_load(fh)["model"]["configs"]
    cfg = las_config_from_dicts({**model["listener_configs"], "lstm_impl": "pallas"},
                                {**model["speller_configs"], "decoder_impl": "pallas"})
    opt = build_optimizer("adamw", {"lr": 1e-3, "amsgrad": True}, grad_norm=5.0)
    state = create_train_state(las_init(cfg, torch.Generator().manual_seed(3)), opt, seed=4,
                               device=str(cuda_device))
    step = make_train_step(lambda p, xx, ll, **kw: las_apply(p, cfg, xx, ll, **kw), opt,
                           compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(batch)
    frames, labels = 128, 16
    lx = torch.randint(frames // 2, frames + 1, (batch,), generator=gen).to(torch.int32)
    lx[0] = frames
    x = torch.randn(batch, frames, 15, generator=gen)
    y = torch.randint(1, 29, (batch, labels), generator=gen).to(torch.int32)
    ly = torch.randint(1, labels + 1, (batch,), generator=gen).to(torch.int32)
    args = tuple(t.to(cuda_device) for t in (x, lx, y, ly))
    lstm_cuda.reset_launch_counts()
    _, metrics, _ = step(state, *args, 0.9, 1e-3)
    torch.cuda.synchronize()
    assert bool(metrics["finite"])
    assert lstm_cuda.LAUNCHES["lstm_bwd_dw"] == 4
    assert lstm_cuda.ADJOINT_ROW_GROUPS == {**dict.fromkeys(lstm_cuda.ADJOINT_ROW_GROUPS, 0),
                                            groups: 4}


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [768, 1024])
@pytest.mark.parametrize("batch", [5, 128])
def test_bf16_wide_adjoint_is_one_launch_of_both_directions_on_card(cuda_device, hidden, batch):
    """Above H = 512 ``lstm_bwd`` takes 16 units a block and both directions
    in one launch of up to 128 rows, and agrees with its plain version."""
    gates, cs, hs, dy, w_hh, lengths, rev = _adjoint_case(cuda_device, batch, hidden, 2, 7)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = lstm_cuda.plan_bwd_launches("test", torch.bfloat16, batch, hidden, 2, sms, False)
    assert [(ln.d0, ln.nd, ln.units) for ln in plan] == [(0, 2, 16)]
    lstm_cuda.reset_launch_counts()
    dpre = lstm_cuda.lstm_bwd(gates, cs, dy, w_hh, lengths, rev)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES["lstm_bwd"] == 1
    ref = lstm_cuda.lstm_bwd_plain(gates, cs, dy, w_hh, lengths, rev)
    torch.testing.assert_close(dpre.float(), ref.float(), atol=_tol(torch.bfloat16, ref), rtol=0)


# ---------------------------------------------------------------------------
# The float32 adjoint on the CUDA cores (csrc/lstm_bwd.cu)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden", [(5, 64), (128, 512), (129, 512), (300, 256),
                                          (40, 1024)])
def test_fp32_adjoint_repeats_bit_for_bit_on_card(cuda_device, batch, hidden):
    """Two calls on the same inputs give the same bits: a fixed summation
    order, no atomics, the row groups' partial dW_hh summed in order."""
    gates, cs, hs, dy, w_hh, lengths, rev = _adjoint_case(cuda_device, batch, hidden, 2, 11,
                                                          dtype=torch.float32)
    first = lstm_cuda.lstm_bwd(gates, cs, dy, w_hh, lengths, rev)
    assert torch.equal(first, lstm_cuda.lstm_bwd(gates, cs, dy, w_hh, lengths, rev))
    if hidden <= 512:
        dpre, d_whh = lstm_cuda.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev)
        again = lstm_cuda.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev)
        assert torch.equal(dpre, again[0]) and torch.equal(d_whh, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [40, 128, 300])
def test_fp32_adjoint_forms_give_the_same_dpre_on_card(cuda_device, batch):
    """``lstm_bwd``'s dpre is ``lstm_bwd_dw``'s bit for bit (one time loop;
    dW_hh is summed after it), at B=40 and 128 (one launch) and B=300 (more
    row groups and launches, their partial dW_hh summed in order), and both
    agree with the plain versions."""
    gates, cs, hs, dy, w_hh, lengths, rev = _adjoint_case(cuda_device, batch, 512, 2, 13,
                                                          dtype=torch.float32)
    lstm_cuda.reset_launch_counts()
    nodw = lstm_cuda.lstm_bwd(gates, cs, dy, w_hh, lengths, rev)
    dpre, d_whh = lstm_cuda.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev)
    torch.cuda.synchronize()
    n = _adjoint_launches(cuda_device, torch.float32, batch, 512, 2, True)
    assert lstm_cuda.LAUNCHES["lstm_bwd"] == lstm_cuda.LAUNCHES["lstm_bwd_dw"] == n
    assert torch.equal(nodw, dpre)
    p_dpre, p_dwhh = lstm_cuda.lstm_bwd_dw_plain(gates, cs, hs, dy, w_hh, lengths, rev)
    for got, ref in ((dpre, p_dpre), (d_whh, p_dwhh)):
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    pads = torch.arange(gates.shape[1], device=cuda_device)[None, :] >= lengths[:, None]
    assert dpre[pads].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [512, 1024])
def test_fp32_adjoint_is_one_launch_at_the_train_batch_on_card(cuda_device, hidden):
    """At B=128 the float32 adjoint takes every row in one launch: both
    directions at H=512 (R=64 rows x U=16 units a block, 128 blocks), one
    launch a direction at H=1024 (U=8 by shared memory); and it agrees with
    its plain version."""
    gates, cs, hs, dy, w_hh, lengths, rev = _adjoint_case(cuda_device, 128, hidden, 2, 9,
                                                          dtype=torch.float32)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = lstm_cuda.plan_bwd_launches("test", torch.float32, 128, hidden, 2, sms, False)
    want = [(0, 128, 0, 2)] if hidden <= 512 else [(0, 128, 0, 1), (0, 128, 1, 1)]
    assert [(ln.r0, ln.r1, ln.d0, ln.nd) for ln in plan] == want
    lstm_cuda.reset_launch_counts()
    dpre = lstm_cuda.lstm_bwd(gates, cs, dy, w_hh, lengths, rev)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES["lstm_bwd"] == len(want)
    ref = lstm_cuda.lstm_bwd_plain(gates, cs, dy, w_hh, lengths, rev)
    assert (dpre - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("batch,width", [(256, 160), (64, 352), (32, 352), (8, 96)],
                         ids=["lminfer", "corrector-score", "corrector-beam", "http"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_rewriter_encoder_on_the_kernels_on_card(cuda_device, dtype, atol, batch, width):
    """The Rewriter's encoder (configs/rewriter.yml: 2 BiLSTM layers of 256
    over a 256-wide embedding, so both layers take ``lstm_scan`` over inputs
    of 256 and 512) on the kernels against the plain loops, at the batches
    ``lminfer`` (256) and the ``Corrector`` run (32 rows a beam batch, 64 for
    the gate's stacked scorer, a few rows behind the HTTP queue) over texts
    up to ``width`` characters: bf16 one launch a layer per 128 rows,
    float32 one launch a layer (every row and both directions)."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import (
        RewriterConfig,
        rewriter_encode,
        rewriter_init,
    )

    model = dict(emb_dim=256, enc_lstm_layers=2, enc_lstm_hid_dim=256, att_proj_dim=128,
                 att_heads=1, dec_lstm_hid_dim=256, dec_lstm_out_dim=128)
    kern_cfg = RewriterConfig(**model, lstm_impl="pallas")
    plain_cfg = RewriterConfig(**model, lstm_impl="scan")
    gen = torch.Generator().manual_seed(12)
    params = rewriter_init(kern_cfg, gen).to(cuda_device)
    lx = torch.randint(3, width + 1, (batch,), generator=gen).to(torch.int32)
    lx[0], lx[-1] = width, 3
    x = torch.randint(1, 29, (batch, width), generator=gen)
    x[torch.arange(width)[None, :] >= lx[:, None].long()] = 29
    lstm_cuda.reset_launch_counts()
    with torch.inference_mode():
        got, _ = rewriter_encode(params, kern_cfg, x, lx, dtype)
        torch.cuda.synchronize()
        per_layer = -(-batch // 128) if dtype == torch.bfloat16 else 1
        assert per_layer == _forward_launches(cuda_device, dtype, batch, 256, 2)
        assert lstm_cuda.LAUNCHES == {**dict.fromkeys(lstm_cuda.LAUNCHES, 0),
                                      "lstm_scan": 2 * per_layer}
        ref, _ = rewriter_encode(params, plain_cfg, x, lx, dtype)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)
