"""Masked LSTM layers and the listener's stacks (counterpart of the JAX
``ops/lstm.py``), inference form.

Semantics kept from the reference: gate order [i, f, g, o]; the (h, c)
carry freezes where ``t >= length`` and h is zero at padded frames; the
reverse direction of a BiLSTM walks time descending from a zero carry, so
every row starts at its own last valid frame.

Numerics follow the Pallas kernels that base-LAS runs (``lstm_impl:
pallas``), not the JAX ``lax.scan`` path: h and c are carried in float32,
h is rounded to the weight dtype only as the operand of the recurrent
product, gates are float32, and outputs come back in the input dtype. In
float32 the two JAX paths agree, and so does this one.

``lstm_apply`` / ``bilstm_apply`` here are the plain versions: Python time
loops in PyTorch, used on the CPU and as the reference on the card; autograd
differentiates through the loop. ``impl="pallas"`` in the stacks routes each
layer to the CUDA kernels of ``ops/lstm_cuda.py`` instead (whose wrappers
take these same plain loops for CPU tensors), forward and backward.

In training the stacks apply locked dropout after each layer, as the JAX
stacks do. With ``remat`` a layer keeps only its input for the backward
pass and runs its forward again there (the JAX stacks' ``jax.checkpoint`` a
layer): the first pass runs without a graph, so ``impl="pallas"`` launches
the lean kernels (``lstm_scan`` / ``lstm_scan_fusedin``, which write neither
cs nor the gates), and the backward pass launches the training forward and
then the adjoint. The layer has no randomness of its own (the dropout masks
are the stack's inputs), so the second forward repeats the first bit for bit
and the gradients equal those without ``remat``.

The plain loops run direction by direction, so a layer whose ``w_ih`` /
``w_hh`` are column-sharded (``ops/shards.py::ColumnShards``, tensor
parallelism) takes them as they are, each product column-parallel. The
kernels' route (``directions_apply``) refuses such a weight, as the JAX
CLIs refuse the kernel tiers under tensor parallelism.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops.dropout import locked_dropout
from attention_based_e2e_asr_dnn_tpu_torch.ops.shards import ColumnShards, refuse_sharded
from attention_based_e2e_asr_dnn_tpu_torch.utils.profiling import span


def _gates(pre: torch.Tensor, c: torch.Tensor, hidden_dim: int):
    """Fused LSTM gate math. pre: (..., 4H) pre-activation; c: (..., H)."""
    i = torch.sigmoid(pre[..., 0 * hidden_dim: 1 * hidden_dim])
    f = torch.sigmoid(pre[..., 1 * hidden_dim: 2 * hidden_dim])
    g = torch.tanh(pre[..., 2 * hidden_dim: 3 * hidden_dim])
    o = torch.sigmoid(pre[..., 3 * hidden_dim: 4 * hidden_dim])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


# widest input whose projection runs inside the recurrence (the Pallas
# route's threshold, lstm_pallas.py:1024)
FUSED_IN_MAX_DIM = 128


def directions_apply(dirs: Sequence, x: torch.Tensor, lengths: torch.Tensor,
                     reverse: Sequence[bool], fusedin_fn: Callable,
                     scan_fn: Callable) -> torch.Tensor:
    """Run LSTM directions ``dirs`` (each {"w_ih", "w_hh", "b"}) over one
    input: (B, T, D) -> (B, T, len(dirs) * H), directions concatenated.

    The route is the Pallas wrapper's (``lstm_apply_pallas``): an input no
    wider than ``FUSED_IN_MAX_DIM`` is projected inside the recurrence
    (``fusedin_fn``, float32 projection); a wider one takes ``x @ W_ih + b``
    as one product in the compute dtype, all directions at once, then the
    recurrence (``scan_fn``). A kernel cannot take a column-sharded weight:
    one raises the JAX CLIs' tensor-parallel ``ValueError``.
    """
    dtype = x.dtype
    refuse_sharded(list(dirs), "lstm_impl")
    w_hh = torch.stack([p["w_hh"] for p in dirs]).to(dtype)
    if dirs[0]["w_ih"].shape[0] <= FUSED_IN_MAX_DIM:
        w_ih = torch.stack([p["w_ih"] for p in dirs]).to(dtype)
        b = torch.stack([p["b"] for p in dirs]).to(dtype)
        return fusedin_fn(x.contiguous(), w_ih, b, w_hh, lengths, tuple(reverse))
    w_ih = torch.cat([p["w_ih"] for p in dirs], dim=1).to(dtype)
    b = torch.cat([p["b"] for p in dirs]).to(dtype)
    x_proj = torch.matmul(x, w_ih) + b
    return scan_fn(x_proj, w_hh, lengths, tuple(reverse))


def _plain_directions(dirs: Sequence, x: torch.Tensor, lengths: torch.Tensor,
                      reverse: Sequence[bool]) -> torch.Tensor:
    """The plain loops over LSTM directions ``dirs``, with the kernels' route
    (``directions_apply``) and sums, direction by direction: an input no
    wider than ``FUSED_IN_MAX_DIM`` projected in float32, a wider one as
    ``x @ W_ih + b`` in the compute dtype. A weight may be column-sharded."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops.lstm_cuda import _directions_plain

    dtype = x.dtype
    w_hh = [p["w_hh"].to(dtype) for p in dirs]
    if dirs[0]["w_ih"].shape[0] <= FUSED_IN_MAX_DIM:
        def pre_x(d):
            return (x.float() @ dirs[d]["w_ih"].to(dtype).float()
                    + dirs[d]["b"].to(dtype).float())
    else:
        def pre_x(d):
            return (x @ dirs[d]["w_ih"].to(dtype) + dirs[d]["b"].to(dtype)).float()
    return _directions_plain(pre_x, w_hh, lengths, x.shape[1], tuple(reverse), dtype,
                             train=False)


def lstm_apply(params, x: torch.Tensor, lengths: torch.Tensor,
               reverse: bool = False) -> torch.Tensor:
    """One LSTM direction, plain: (B, T, D) -> (B, T, H), zero at pads."""
    return _plain_directions([params], x, lengths, (reverse,))


def bilstm_apply(params, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Bidirectional LSTM, plain: (B, T, D) -> (B, T, 2H) = [fwd, bwd]."""
    return _plain_directions([params["fwd"], params["bwd"]], x, lengths, (False, True))


class _RematLayer(torch.autograd.Function):
    """One layer that saves only its inputs: the forward runs without a
    graph, the backward runs it again under autograd and differentiates."""

    @staticmethod
    def forward(ctx, fn, x, lengths, *leaves):
        ctx.fn = fn
        ctx.save_for_backward(x, lengths, *leaves)
        with torch.no_grad():
            return fn(x, lengths, leaves)

    @staticmethod
    def backward(ctx, d_y):
        with span("las.backward.listener"):
            x, lengths, *leaves = ctx.saved_tensors
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip([x, *leaves], ctx.needs_input_grad[1:2]
                                         + ctx.needs_input_grad[3:])]
            with torch.enable_grad():
                y = ctx.fn(inputs[0], lengths, inputs[1:])
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, d_y))
            d_x, *d_leaves = [next(grads) if t.requires_grad else None for t in inputs]
            return (None, d_x, None, *d_leaves)


def _layer_leaves(layer, bidirectional: bool):
    """A layer's tensors in a fixed order, and the function that puts such a
    list back into the layer's shape."""
    dirs = ("fwd", "bwd") if bidirectional else (None,)
    keys = ("w_ih", "w_hh", "b")
    leaves = [(layer[d] if d else layer)[k] for d in dirs for k in keys]

    def rebuild(flat):
        it = iter(flat)
        parts = [{k: next(it) for k in keys} for _ in dirs]
        return dict(zip(dirs, parts)) if bidirectional else parts[0]

    return leaves, rebuild


def _shard_tensors(leaves):
    """A layer's leaves as plain tensors (a column-sharded weight's blocks in
    its place), and the function that puts them back."""
    tensors, spans = [], []
    for leaf in leaves:
        if isinstance(leaf, ColumnShards):
            spans.append((len(leaf.shards), leaf.gather))
            tensors.extend(leaf.shards)
        else:
            spans.append(None)
            tensors.append(leaf)

    def unflatten(flat):
        it = iter(flat)
        return [next(it) if span is None else ColumnShards([next(it) for _ in range(span[0])],
                                                          span[1])
                for span in spans]

    return tensors, unflatten


def _layer_apply(layer, x, lengths, bidirectional: bool, impl: str, remat: bool = False):
    """One (Bi)LSTM layer: the CUDA kernels ("pallas") or the plain loops;
    with ``remat`` (and a gradient wanted) through ``_RematLayer``."""
    if remat and torch.is_grad_enabled():
        leaves, rebuild = _layer_leaves(layer, bidirectional)
        tensors, unflatten = _shard_tensors(leaves)
        if x.requires_grad or any(t.requires_grad for t in tensors):
            def fn(xx, ll, flat):
                return _layer_apply(rebuild(unflatten(flat)), xx, ll, bidirectional, impl)

            return _RematLayer.apply(fn, x, lengths, *tensors)
    if impl == "pallas":
        from attention_based_e2e_asr_dnn_tpu_torch.ops.lstm_cuda import (
            bilstm_apply_kernel,
            lstm_apply_kernel,
        )

        return (bilstm_apply_kernel(layer, x, lengths) if bidirectional
                else lstm_apply_kernel(layer, x, lengths))
    return (bilstm_apply(layer, x, lengths) if bidirectional
            else lstm_apply(layer, x, lengths))


def _check_train_args(masks, n_layers: int):
    """The per-layer dropout masks of a training pass (None = draw)."""
    if masks is None:
        return [None] * n_layers
    if len(masks) != n_layers:
        raise ValueError(f"{len(masks)} dropout masks for {n_layers} layers")
    return list(masks)


def locked_lstm_stack_apply(params, x: torch.Tensor, lengths: torch.Tensor,
                            bidirectional: bool = True, impl: str = "scan",
                            init_dropout: float = 0.0, mid_dropout: float = 0.0,
                            train: bool = False, masks: Optional[Sequence] = None,
                            generator: Optional[torch.Generator] = None,
                            remat: bool = False):
    """LockedLSTM stack. Per layer: LSTM, then in training locked dropout
    with rate ``init_dropout`` after layer 0 and ``mid_dropout`` after the
    rest, from ``masks[i]`` ((B, 1, D), True = keep) or drawn from
    ``generator``. ``remat``: see the module docstring. Lengths are
    unchanged. Returns (y, lengths)."""
    masks = _check_train_args(masks, len(params))
    for i, layer in enumerate(params):
        x = _layer_apply(layer, x, lengths, bidirectional, impl, remat)
        if train:
            x = locked_dropout(x, mid_dropout if i else init_dropout, masks[i], generator)
    return x, lengths


def pyramidal_lstm_stack_apply(params, x: torch.Tensor, lengths: torch.Tensor,
                               bidirectional: bool = True, impl: str = "scan",
                               mid_dropout: float = 0.0, final_dropout: float = 0.0,
                               train: bool = False, masks: Optional[Sequence] = None,
                               generator: Optional[torch.Generator] = None,
                               remat: bool = False):
    """Pyramidal stack: per layer, concatenate adjacent frames ((B, T, D) ->
    (B, T/2, 2D)), halve lengths with floor division (an odd valid length
    loses its last frame, as in the reference), run the layer, and in
    training apply locked dropout (``mid_dropout`` for inner layers,
    ``final_dropout`` after the last). Returns (y, lengths)."""
    num_layers = len(params)
    masks = _check_train_args(masks, num_layers)
    for i, layer in enumerate(params):
        batch, seq_len, dim = x.shape
        if seq_len % 2 != 0:
            raise ValueError(
                f"pyramidal layer {i}: time axis {seq_len} must be even; pad "
                f"batches to a multiple of 2**{num_layers} frames"
            )
        lengths = lengths // 2
        x = x.reshape(batch, seq_len // 2, 2 * dim)
        x = _layer_apply(layer, x, lengths, bidirectional, impl, remat)
        if train:
            rate = mid_dropout if i < num_layers - 1 else final_dropout
            x = locked_dropout(x, rate, masks[i], generator)
    return x, lengths


def lstm_cell_step(params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One decoder cell step in the compute dtype: x (B, D), h/c (B, H)."""
    dtype = x.dtype
    hidden_dim = params["w_hh"].shape[0]
    pre = (x @ params["w_ih"].to(dtype) + h @ params["w_hh"].to(dtype)
           + params["b"].to(dtype))
    return _gates(pre, c, hidden_dim)
