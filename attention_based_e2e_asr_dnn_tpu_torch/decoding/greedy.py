"""Early-exit greedy decoding (counterpart of the JAX ``decoding/greedy.py``).

A Python loop replaces the JAX ``lax.while_loop``: it stops once every row
has emitted <eos>, writes PAD after a row is done, force-finishes a row
beyond ``max_len_factor`` characters per encoder frame (computed in
float32), and takes the first maximum on ties (``torch.argmax``).

The all-done test reads a flag back from the device every step. Testing it
only every few steps would give the same ids (rows already done write PAD),
but measured on an H100 it saved nothing: the host issuing the step's small
kernels is the bottleneck, so the device is idle when the flag is read.
"""

from __future__ import annotations

from typing import Optional

import torch

from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    LASConfig,
    SpellerConfig,
    cast_params,
    listener_apply,
    speller_start,
    speller_step,
)


def greedy_decode_early_stop(params, cfg: SpellerConfig, enc_h: torch.Tensor,
                             enc_l: torch.Tensor, max_steps: int = 0,
                             max_len_factor: float = 3.0,
                             anchor_ids: Optional[torch.Tensor] = None,
                             anchor_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Free-running greedy decode with all-finished early exit.

    Returns (B, max_steps) int64 ids, PAD after each row's first <eos>.
    ``max_len_factor`` 0 disables the length cap.

    With ``anchor_ids`` (B, A) raw char ids (no SOS) and ``anchor_len`` (B,)
    ``<= A``, the prefix-anchored decode (the JAX ``greedy_decode_anchored``):
    steps t < ``anchor_len[b]`` emit and feed back ``anchor_ids[b, t]``
    verbatim, argmax afterwards; the length cap does not cut a row while it
    is still forced along its anchor. ``anchor_len`` 0 is the free run.
    """
    max_steps = max_steps or cfg.CHR_MAX_STEPS
    batch, dev = enc_h.shape[0], enc_h.device
    if anchor_ids is not None:
        a_wide = torch.full((batch, max_steps), cfg.CHR_PAD_IDX, dtype=torch.long, device=dev)
        width = min(anchor_ids.shape[1], max_steps)
        a_wide[:, :width] = anchor_ids[:, :width].long()
        anchor_len = torch.clamp(anchor_len.long(), max=max_steps)
    params = cast_params(params, enc_h.dtype)
    cache, state, _ = speller_start(params, cfg, enc_h, enc_l)
    char = torch.full((batch,), cfg.CHR_SOS_IDX, dtype=torch.long, device=dev)
    out = torch.full((batch, max_steps), cfg.CHR_PAD_IDX, dtype=torch.long, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    cap = max_len_factor * enc_l.to(torch.float32)
    for t in range(max_steps):
        if bool(done.all()):
            break
        logits, _, state = speller_step(params, cfg, cache, char, state)
        char = torch.argmax(logits, dim=-1)
        if anchor_ids is not None:
            char = torch.where(t < anchor_len, a_wide[:, t], char)
        char = char.masked_fill(done, cfg.CHR_PAD_IDX)
        out[:, t] = char
        done = done | (char == cfg.CHR_PAD_IDX)
        if max_len_factor > 0:
            over = t + 1 >= cap
            done = done | (over if anchor_ids is None else over & (t >= anchor_len))
    return out


def make_las_greedy_step(las_cfg: LASConfig, compute_dtype=torch.float32,
                         max_steps: int = 0, max_len_factor: float = 3.0):
    """Early-stop greedy decode with the (params, x, lx) -> ids interface."""

    @torch.inference_mode()
    def step(params, x: torch.Tensor, lx: torch.Tensor) -> torch.Tensor:
        if x.is_floating_point():
            x = x.to(compute_dtype)
        enc_h, enc_l = listener_apply(params["listener"], las_cfg.listener, x, lx)
        return greedy_decode_early_stop(params["speller"], las_cfg.speller,
                                        enc_h, enc_l, max_steps,
                                        max_len_factor)

    return step


def make_rewriter_anchored_step(lm_cfg, compute_dtype=torch.float32, max_steps: int = 0,
                                max_len_factor: float = 3.0):
    """Anchored rewrite step: (params, x, lx, anchor_ids, anchor_len) -> ids
    (B, max_steps) on the CPU; the inputs may be numpy arrays. One function
    for every anchor policy: ``anchor_len`` 0 is the full rewrite."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import rewriter_encode

    sp_cfg = lm_cfg.speller_config()

    @torch.inference_mode()
    def step(params, x, lx, anchor_ids, anchor_len) -> torch.Tensor:
        enc_h, enc_l = rewriter_encode(params, lm_cfg, x, lx, compute_dtype)
        dev = enc_h.device
        return greedy_decode_early_stop(
            params["decoder"], sp_cfg, enc_h, enc_l, max_steps, max_len_factor,
            torch.as_tensor(anchor_ids).to(dev), torch.as_tensor(anchor_len).to(dev)).cpu()

    return step


def make_rewriter_greedy_step(lm_cfg, compute_dtype=torch.float32, max_steps: int = 0,
                              max_len_factor: float = 3.0):
    """Early-stop greedy decode for the Rewriter: (params, x ids, lx) -> ids
    (B, max_steps) on the CPU; the inputs may be numpy arrays."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import rewriter_encode

    sp_cfg = lm_cfg.speller_config()

    @torch.inference_mode()
    def step(params, x, lx) -> torch.Tensor:
        enc_h, enc_l = rewriter_encode(params, lm_cfg, x, lx, compute_dtype)
        return greedy_decode_early_stop(params["decoder"], sp_cfg, enc_h, enc_l,
                                        max_steps, max_len_factor).cpu()

    return step
