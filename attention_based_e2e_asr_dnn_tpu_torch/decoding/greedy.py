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
                             max_len_factor: float = 3.0) -> torch.Tensor:
    """Free-running greedy decode with all-finished early exit.

    Returns (B, max_steps) int64 ids, PAD after each row's first <eos>.
    ``max_len_factor`` 0 disables the length cap.
    """
    max_steps = max_steps or cfg.CHR_MAX_STEPS
    batch = enc_h.shape[0]
    params = cast_params(params, enc_h.dtype)
    cache, state, _ = speller_start(params, cfg, enc_h, enc_l)
    char = torch.full((batch,), cfg.CHR_SOS_IDX, dtype=torch.long, device=enc_h.device)
    out = torch.full((batch, max_steps), cfg.CHR_PAD_IDX, dtype=torch.long,
                     device=enc_h.device)
    done = torch.zeros(batch, dtype=torch.bool, device=enc_h.device)
    cap = max_len_factor * enc_l.to(torch.float32)
    for t in range(max_steps):
        if bool(done.all()):
            break
        logits, _, state = speller_step(params, cfg, cache, char, state)
        char = torch.argmax(logits, dim=-1).masked_fill(done, cfg.CHR_PAD_IDX)
        out[:, t] = char
        done = done | (char == cfg.CHR_PAD_IDX)
        if max_len_factor > 0:
            done = done | (t + 1 >= cap)
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
