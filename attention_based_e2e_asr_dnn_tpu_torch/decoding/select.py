"""Host-side beam-search finalization: the backpointer walk and the choice
of the best hypothesis, numpy only (the port's own copy of the JAX package's
``decoding/select.py``, held equal to it by ``tests/test_torch_beam.py``).
"""

from __future__ import annotations

import numpy as np


def backtrace(tokens: np.ndarray, parents: np.ndarray, beam: int, b: int,
              k: int) -> list:
    """Host-side backpointer walk: (steps, B, K) arrays -> token list."""
    steps = tokens.shape[0]
    seq = []
    cur = k
    for t in range(steps - 1, -1, -1):
        seq.append(int(tokens[t, b, cur]))
        cur = int(parents[t, b, cur])
    return seq[::-1]


def backtrace_all(tokens: np.ndarray, parents: np.ndarray) -> np.ndarray:
    """Vectorized backpointer walk for EVERY (batch, beam) chain at once.

    (steps, B, K) tokens/parents -> (steps, B, K) resolved sequences in
    ``steps`` numpy ops total (the per-chain Python walk was B*K*steps
    iterations — painful at B=128 x K=8 x 600)."""
    steps, batch, K = tokens.shape
    seq = np.empty((steps, batch, K), np.int32)
    cur = np.broadcast_to(np.arange(K, dtype=np.int64), (batch, K)).copy()
    for t in range(steps - 1, -1, -1):
        seq[t] = np.take_along_axis(tokens[t], cur, axis=1)
        cur = np.take_along_axis(parents[t].astype(np.int64), cur, axis=1)
    return seq


def select_best_sequences(
    tokens: np.ndarray,
    parents: np.ndarray,
    final_scores: np.ndarray,
    pad_idx: int,
    length_alpha: float = 0.0,
    max_steps: int = 0,
) -> np.ndarray:
    """Beam-scan outputs -> (B, steps) int32 best sequences.

    Selection: highest score, length-normalized by
    ``(len_until_eos)**length_alpha`` when alpha > 0. Per-slot finished
    flags get reshuffled by top-k every step, so the true hypothesis length
    comes from the BACKTRACED token chain of each final slot.
    """
    tokens = np.asarray(tokens)
    parents = np.asarray(parents)
    final_scores = np.asarray(final_scores)
    max_steps = max_steps or tokens.shape[0]
    batch = final_scores.shape[0]
    seqs = backtrace_all(tokens, parents)           # (steps, B, K)
    if length_alpha > 0.0:
        is_pad = seqs == pad_idx                    # (steps, B, K)
        any_pad = is_pad.any(axis=0)
        lengths = np.where(any_pad, is_pad.argmax(axis=0) + 1,
                           max_steps).astype(np.float64)
        norm = final_scores / (lengths ** length_alpha)
    else:
        norm = final_scores
    best = norm.argmax(axis=1)                      # (B,)
    return seqs[:, np.arange(batch), best].T.astype(np.int32)  # (B, steps)
