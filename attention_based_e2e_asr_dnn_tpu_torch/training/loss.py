"""Masked token-mean cross-entropy (counterpart of the JAX
``training/loss.py``; reference: src/train.py:133-136).

loss = sum(CE(logits, y) * non_pad_mask) / n_non_pad_tokens ; ppl = exp(loss)
"""

from __future__ import annotations

import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops.masking import length_mask


def masked_ce_sum(logits: torch.Tensor, targets: torch.Tensor,
                  target_lens: torch.Tensor):
    """logits (B, L, V) vs targets (B, L) with valid lengths (B,).

    Returns (the cross-entropy summed over the valid tokens, their raw count)
    as 0-dim float32 tensors; a batch without a valid token gives (0, 0).
    Cross-entropy in float32 whatever the compute dtype."""
    logits = logits.float()
    mask = length_mask(target_lens, targets.shape[1], dtype=torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return (ce * mask).sum(), mask.sum()


def masked_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                   target_lens: torch.Tensor):
    """The token mean of ``masked_ce_sum``: (loss, n_tokens), ``n_tokens``
    at least 1."""
    ce_sum, n_raw = masked_ce_sum(logits, targets, target_lens)
    n_tokens = torch.clamp(n_raw, min=1.0)
    return ce_sum / n_tokens, n_tokens
