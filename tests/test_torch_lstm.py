"""PyTorch port, LSTM layers: the plain versions and the kernel wrappers'
CPU route against the JAX package (Pallas kernels in interpret mode and the
lax.scan path), and the listener's stacks. The kernels themselves are tested
on the card by test_torch_lstm_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu.models import las as jlas
from attention_based_e2e_asr_dnn_tpu.ops import lstm as jlstm
from attention_based_e2e_asr_dnn_tpu.ops.lstm_pallas import (
    bilstm_apply_pallas,
    lstm_apply_pallas,
)
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm as tlstm
from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda

torch.set_num_threads(1)

# float32: both sides run the same float32 arithmetic in another order
ATOL_F32 = 2e-5
# bfloat16 outputs: one bf16 step near 1.0 (2**-7) covers a rounding flip
ATOL_BF16 = 2.0 ** -7


def _lstm_params(rng, in_dim, hidden):
    k = 1.0 / np.sqrt(hidden)
    return {"w_ih": rng.uniform(-k, k, (in_dim, 4 * hidden)).astype(np.float32),
            "w_hh": rng.uniform(-k, k, (hidden, 4 * hidden)).astype(np.float32),
            "b": rng.uniform(-k, k, (4 * hidden,)).astype(np.float32)}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


LENGTHS = np.array([9, 6, 1, 4], np.int32)


# in_dim 5 takes the fused-input route, 160 the x_proj route (> 128)
@pytest.mark.parametrize("in_dim", [5, 160])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_apply_matches_jax_fp32(in_dim, reverse):
    rng = np.random.default_rng(in_dim + reverse)
    params = _lstm_params(rng, in_dim, 8)
    x = rng.standard_normal((4, 9, in_dim)).astype(np.float32)
    ref_pallas = lstm_apply_pallas(_jax_tree(params), jnp.asarray(x), jnp.asarray(LENGTHS),
                                   reverse=reverse, interpret=True)
    ref_scan = jlstm.lstm_apply(_jax_tree(params), jnp.asarray(x), jnp.asarray(LENGTHS),
                                reverse=reverse)
    ours = tlstm.lstm_apply(_torch_tree(params), torch.from_numpy(x),
                            torch.from_numpy(LENGTHS), reverse=reverse).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref_pallas), atol=ATOL_F32)
    np.testing.assert_allclose(ours, np.asarray(ref_scan), atol=ATOL_F32)
    assert np.all(ours[np.arange(9)[None, :] >= LENGTHS[:, None]] == 0.0)


@pytest.mark.parametrize("in_dim", [5, 160])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_apply_matches_pallas_bf16(in_dim, reverse):
    rng = np.random.default_rng(10 + in_dim + reverse)
    params = _lstm_params(rng, in_dim, 16)
    x = rng.standard_normal((4, 9, in_dim)).astype(np.float32)
    ref = lstm_apply_pallas(_jax_tree(params), jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(LENGTHS), reverse=reverse, interpret=True)
    ours = tlstm.lstm_apply(_torch_tree(params), torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(LENGTHS), reverse=reverse)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               atol=ATOL_BF16)


@pytest.mark.parametrize("in_dim", [5, 160])
def test_bilstm_plain_and_kernel_route_match_jax(in_dim):
    rng = np.random.default_rng(20 + in_dim)
    params = {"fwd": _lstm_params(rng, in_dim, 8), "bwd": _lstm_params(rng, in_dim, 8)}
    x = rng.standard_normal((4, 9, in_dim)).astype(np.float32)
    ref = np.asarray(bilstm_apply_pallas(_jax_tree(params), jnp.asarray(x),
                                         jnp.asarray(LENGTHS), interpret=True))
    plain = tlstm.bilstm_apply(_torch_tree(params), torch.from_numpy(x),
                               torch.from_numpy(LENGTHS)).numpy()
    lstm_cuda.reset_launch_counts()
    routed = lstm_cuda.bilstm_apply_kernel(_torch_tree(params), torch.from_numpy(x),
                                           torch.from_numpy(LENGTHS)).numpy()
    np.testing.assert_allclose(plain, ref, atol=ATOL_F32)
    np.testing.assert_array_equal(routed, plain)
    # a CPU tensor takes the plain version: no kernel launched
    assert not any(lstm_cuda.LAUNCHES.values())


def test_kernel_wrappers_raise_off_cpu_without_cuda():
    """A non-CPU tensor goes to the kernel or raises; never the plain loop."""
    x = torch.empty(2, 4, 3, device="meta")
    w_hh = torch.empty(1, 32, 128, device="meta")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        lstm_cuda.lstm_scan_fusedin(x, torch.empty(1, 3, 128, device="meta"),
                                    torch.empty(1, 128, device="meta"), w_hh,
                                    torch.ones(2, dtype=torch.int32), (False,))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        lstm_cuda.lstm_scan(torch.empty(2, 4, 128, device="meta"), w_hh,
                            torch.ones(2, dtype=torch.int32), (False,))


def test_lstm_cell_step_matches_jax():
    rng = np.random.default_rng(3)
    params = _lstm_params(rng, 12, 8)
    x, h, c = (rng.standard_normal((3, n)).astype(np.float32) for n in (12, 8, 8))
    ref = jlstm.lstm_cell_step(_jax_tree(params), jnp.asarray(x), jnp.asarray(h),
                               jnp.asarray(c))
    ours = tlstm.lstm_cell_step(_torch_tree(params), torch.from_numpy(x),
                                torch.from_numpy(h), torch.from_numpy(c))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL_F32)


def test_pyramidal_stack_rejects_odd_time():
    params = _torch_tree([{"fwd": _lstm_params(np.random.default_rng(0), 6, 8),
                           "bwd": _lstm_params(np.random.default_rng(1), 6, 8)}])
    with pytest.raises(ValueError, match="must be even"):
        tlstm.pyramidal_lstm_stack_apply(params, torch.zeros(2, 5, 3),
                                         torch.tensor([5, 3]))


LISTENER = jlas.ListenerConfig(input_dim=15, uniform_hid_dim=16, lstm_layers=1,
                               plstm_layers=1)


@pytest.mark.parametrize("lstm_impl", ["pallas", "scan"])
def test_listener_apply_matches_jax(lstm_impl):
    """Layer 0 (15 features) and the pyramid layer (64 wide) both take the
    fused-input route; the wide stack below covers the x_proj route."""
    cfg = dataclasses.replace(LISTENER, lstm_impl=lstm_impl)
    params = jax.tree.map(np.asarray, jlas.listener_init(jax.random.key(0), cfg))
    rng = np.random.default_rng(4)
    lengths = np.array([16, 11, 7, 2], np.int32)
    x = rng.standard_normal((4, 16, 15)).astype(np.float32)
    x[np.arange(16)[None, :] >= lengths[:, None]] = 0.0
    ref_h, ref_l = jlas.listener_apply(_jax_tree(params), cfg, None, jnp.asarray(x),
                                       jnp.asarray(lengths))
    t_cfg = tlas.ListenerConfig(**dataclasses.asdict(cfg))
    h, lens = tlas.listener_apply(_torch_tree(params), t_cfg, torch.from_numpy(x),
                                  torch.from_numpy(lengths))
    assert h.shape == (4, 8, 32)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_l))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=ATOL_F32)


@pytest.mark.parametrize("lstm_impl", ["pallas", "scan"])
def test_pyramidal_stack_wide_matches_jax(lstm_impl):
    """Two pyramid layers over 80-wide inputs: 160 > 128 takes x_proj."""
    params = jax.tree.map(np.asarray, jlstm.pyramidal_lstm_stack_init(
        jax.random.key(1), 80, 16, 2))
    rng = np.random.default_rng(5)
    lengths = np.array([16, 13, 5, 1], np.int32)
    x = rng.standard_normal((4, 16, 80)).astype(np.float32)
    ref_h, ref_l = jlstm.pyramidal_lstm_stack_apply(
        _jax_tree(params), None, jnp.asarray(x), jnp.asarray(lengths), 0.0, 0.0,
        impl=lstm_impl)
    h, lens = tlstm.pyramidal_lstm_stack_apply(_torch_tree(params), torch.from_numpy(x),
                                               torch.from_numpy(lengths), impl=lstm_impl)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_l))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=ATOL_F32)
