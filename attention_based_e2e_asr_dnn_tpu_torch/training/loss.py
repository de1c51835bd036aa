"""Masked token-mean cross-entropy (counterpart of the JAX
``training/loss.py``; reference: src/train.py:133-136).

loss = sum(CE(logits, y) * non_pad_mask) / n_non_pad_tokens ; ppl = exp(loss)
"""

from __future__ import annotations

import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops.masking import length_mask


def masked_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                   target_lens: torch.Tensor):
    """logits (B, L, V) vs targets (B, L) with valid lengths (B,).

    Returns (loss, n_tokens) as 0-dim float32 tensors. Cross-entropy in
    float32 whatever the compute dtype."""
    logits = logits.float()
    mask = length_mask(target_lens, targets.shape[1], dtype=torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    n_tokens = torch.clamp(mask.sum(), min=1.0)
    return (ce * mask).sum() / n_tokens, n_tokens
