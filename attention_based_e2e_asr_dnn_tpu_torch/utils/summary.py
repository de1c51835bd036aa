"""Parameter table and a shape/FLOP summary on a real batch's shapes
(counterpart of the JAX ``utils/summary.py``), printed by the ``train`` CLI
before the first epoch.

The JAX package probes the output shapes with ``jax.eval_shape``; PyTorch has
no abstract evaluation that passes through the kernels' wrappers, so the
shapes here follow from the config, and ``shape_flop_summary`` instead holds
every parameter's shape to what the config implies: a listener/speller wiring
mistake raises here, before the first epoch.
"""

from __future__ import annotations

import numpy as np

from attention_based_e2e_asr_dnn_tpu_torch.utils.flops import (
    las_forward_flops,
    las_train_step_flops,
    listener_flops,
    speller_flops,
)


def _jax_keystr(name: str) -> str:
    """``a.0.b`` -> ``['a'][0]['b']``, as ``jax.tree_util.keystr`` prints it."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in name.split("."))


def model_summary(params, title: str = "model") -> str:
    """A per-leaf parameter table (in the JAX params tree's order) and the
    total count."""
    from attention_based_e2e_asr_dnn_tpu_torch.training.optim import _jax_leaf_order

    named = list(params.named_parameters())
    lines = [f"{'param':60s} {'shape':>20s} {'count':>12s}", "-" * 94]
    total = 0
    for i in _jax_leaf_order(params):
        name, leaf = named[i]
        count = int(np.prod(leaf.shape))
        total += count
        lines.append(f"{_jax_keystr(name):60s} {str(tuple(leaf.shape)):>20s} {count:>12,d}")
    lines.append("-" * 94)
    lines.append(f"{title}: {total:,d} parameters ({total/1e6:.2f}M)")
    return "\n".join(lines)


def _check_wiring(params, las_cfg) -> None:
    """Every parameter's shape against a fresh tree of the same config."""
    import torch

    from attention_based_e2e_asr_dnn_tpu_torch.models.las import las_init

    with torch.device("meta"):
        want = {n: tuple(p.shape) for n, p in
                las_init(las_cfg, None).named_parameters()}
    got = {n: tuple(p.shape) for n, p in params.named_parameters()}
    if got != want:
        bad = sorted(n for n in set(got) | set(want) if got.get(n) != want.get(n))
        raise ValueError("parameters do not fit the model config: " + ", ".join(
            f"{n} {got.get(n)} != {want.get(n)}" for n in bad[:8]))


def shape_flop_summary(params, las_cfg, batch: int, time_steps: int,
                       label_len: int, feat_dim: int = 15) -> str:
    """Per-module output shapes and analytic FLOPs on a real batch's shapes."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import decode_route_report

    if feat_dim != las_cfg.listener.input_dim:
        raise ValueError(f"features are {feat_dim} wide, the listener expects "
                         f"{las_cfg.listener.input_dim}")
    if time_steps % las_cfg.listener.time_reduction:
        raise ValueError(f"time axis {time_steps} is no multiple of "
                         f"{las_cfg.listener.time_reduction} (pad_time_multiple)")
    _check_wiring(params, las_cfg)
    enc_time = time_steps // las_cfg.listener.time_reduction
    enc_shape = (batch, enc_time, las_cfg.listener.enc_out_dim)
    logits_shape = (batch, label_len, las_cfg.speller.dec_vocab_size)
    att_shape = (las_cfg.speller.att_heads, enc_time, label_len + 1)
    l_flops = listener_flops(las_cfg, batch, time_steps)
    s_flops = speller_flops(las_cfg, batch, label_len, enc_time)
    fwd = las_forward_flops(las_cfg, batch, time_steps, label_len)
    train_flops = las_train_step_flops(las_cfg, batch, time_steps, label_len)
    lines = [
        f"{'module':24s} {'output shape':>28s} {'GFLOPs (fwd)':>14s}",
        "-" * 68,
        f"{'input':24s} {str((batch, time_steps, feat_dim)):>28s} {'-':>14s}",
        f"{'listener':24s} {str(enc_shape):>28s} {l_flops/1e9:>14.2f}",
        f"{'speller (tf decode)':24s} {str(logits_shape):>28s} {s_flops/1e9:>14.2f}",
        f"{'attention map':24s} {str(att_shape):>28s} {'-':>14s}",
        "-" * 68,
        f"forward: {fwd/1e9:.2f} GFLOPs/batch "
        f"({fwd/batch/1e9:.2f} GFLOPs/utt) | "
        f"train step (fwd+bwd~3x): {train_flops/1e9:.2f} GFLOPs",
    ]
    routes = decode_route_report()
    if routes:
        lines.append("decoder routes (so far): "
                     + ", ".join(f"{k}->{v}" for k, v in routes.items()))
    elif las_cfg.speller.decoder_impl == "pallas":
        lines.append("decoder routes: pallas requested (the fused kernels on the "
                     "card, their plain versions for CPU tensors)")
    return "\n".join(lines)
