"""Eval and inference steps (counterpart of the JAX ``training/steps.py``).

Each step runs under ``torch.inference_mode``: features are cast to the
compute dtype (integer inputs pass through), the model free-runs for
``CHR_MAX_STEPS`` steps, and greedy ids come back for the host-side
Levenshtein pass or the transcript. PyTorch runs eagerly, so there is no
``jit``; a step is a plain function of (params, inputs).

The train step (SpecAugment, teacher forcing, dropout, the optimizer and the
NaN guard) is not ported yet.
"""

from __future__ import annotations

import torch

from attention_based_e2e_asr_dnn_tpu_torch.training.loss import masked_ce_loss


def _cast_features(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Cast float features to the compute dtype; integer inputs (the
    Rewriter's char ids) pass through untouched."""
    return x.to(compute_dtype) if x.is_floating_point() else x


def make_eval_step(apply_fn, compute_dtype=torch.float32):
    """The free-running eval step (reference: src/train.py:199-258).

    ``apply_fn(params, x, lx)`` returns an object with ``.logits``
    (``las_apply`` with its config bound). The loss is taken on logits and
    labels truncated to the shorter horizon.

        step(params, x, lx, y, ly) -> ({"loss", "ppl", "n_tokens"}, ids)
    """

    @torch.inference_mode()
    def step(params, x, lx, y, ly):
        logits = apply_fn(params, _cast_features(x, compute_dtype), lx).logits
        n = min(logits.shape[1], y.shape[1])
        loss, n_tokens = masked_ce_loss(logits[:, :n], y[:, :n],
                                        torch.clamp(ly, max=n))
        pred_ids = torch.argmax(logits, dim=-1).to(torch.int32)
        return {"loss": loss, "ppl": torch.exp(loss), "n_tokens": n_tokens}, pred_ids

    return step


def make_infer_step(apply_fn, compute_dtype=torch.float32):
    """Greedy inference step: (params, x, lx) -> ids (B, CHR_MAX_STEPS)
    int32, the argmax of the logits in the compute dtype."""

    @torch.inference_mode()
    def step(params, x, lx):
        logits = apply_fn(params, _cast_features(x, compute_dtype), lx).logits
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return step
