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
    assert lstm_cuda.LAUNCHES == {"lstm_scan": 1, "lstm_scan_fusedin": 0}
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_kernel_rejects_float16_on_card(cuda_device):
    with pytest.raises(ValueError, match="not supported"):
        lstm_cuda.lstm_scan(torch.zeros(2, 4, 128, device=cuda_device, dtype=torch.float16),
                            torch.zeros(1, 32, 128, device=cuda_device, dtype=torch.float16),
                            torch.ones(2, dtype=torch.int32), (False,))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [40, 64])
@pytest.mark.parametrize("fused", [True, False])
def test_kernels_take_batches_past_32_rows_on_card(cuda_device, batch, fused):
    """A batch wider than one launch's 32 rows runs as one launch per 32 rows
    and equals the plain version."""
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
    assert lstm_cuda.LAUNCHES[kern.__name__] == len(lstm_cuda.row_chunks(batch)) == 2
    assert got.shape == (batch, seq_len, 2 * hidden)
    torch.testing.assert_close(got, plain(*args), atol=1e-4, rtol=0)
