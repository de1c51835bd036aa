"""Weights-only int8 quantization for deployment artifacts (a copy of the
JAX package's ``quantize.py``, numpy only; ``tests/test_torch_export.py``
holds the two equal).

``export.py``'s artifacts may store the large parameter matrices as int8:

  * every float matrix (ndim >= 2, size >= ``min_elems``) is stored as a
    symmetric per-output-channel int8 tensor + a float32 scale row
    (`q = round(w / s)`, `s = max|w| per last-axis channel / 127`);
  * small leaves (biases, init states) stay in full precision: they are a
    rounding error of the artifact size and the most quantization-sensitive;
  * the artifact's loader dequantizes to float32 once, before the weights
    go to the device.

What this buys: the artifact file and its host memory shrink toward 4x
(int8 against float32) on the matrix mass. It does not change the decode's
speed: the model computes on the dequantized weights. Quantization error is
bounded per weight by s/2 (half an int8 step of that output channel).
"""

from __future__ import annotations

import numpy as np

# Leaf markers. A quantized leaf is a dict with EXACTLY these keys; no
# model in this package nests a params subtree shaped like that, and the
# checkpoints' tree encoding (training/checkpoints.py) treats it as an
# ordinary two-leaf sub-dict, so artifacts need no format change.
QKEY = "__q8__"
SKEY = "__q8_scale__"

INT8_MAX = 127.0


def is_quantized_leaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {QKEY, SKEY}


def quantize_array(a: np.ndarray) -> dict:
    """Symmetric per-output-channel (last axis) int8 quantization."""
    a32 = np.asarray(a, np.float32)
    amax = np.max(np.abs(a32), axis=tuple(range(a32.ndim - 1)),
                  keepdims=True)
    scale = np.where(amax > 0.0, amax / INT8_MAX, 1.0).astype(np.float32)
    q = np.clip(np.round(a32 / scale), -INT8_MAX, INT8_MAX).astype(np.int8)
    return {QKEY: q, SKEY: scale}


def quantize_tree(params, *, min_elems: int = 4096):
    """Quantize every float leaf with ndim >= 2 and >= ``min_elems``
    elements; return a plain-container pytree mirroring ``params``."""

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [rec(v) for v in t]
        a = np.asarray(t)
        if (a.ndim >= 2 and a.size >= min_elems
                and np.issubdtype(a.dtype, np.floating)):
            return quantize_array(a)
        return a

    return rec(params)


def dequantize_tree(qtree):
    """Rebuild the float params tree: float32 numpy arrays where the leaves
    were quantized (int8 times the channel's scale), the rest as stored."""

    def rec(t):
        if is_quantized_leaf(t):
            return np.asarray(t[QKEY], np.float32) * t[SKEY]
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [rec(v) for v in t]
        return t

    return rec(qtree)


def quantized_nbytes(qtree) -> tuple[int, int]:
    """(quantized_bytes, dequantized_fp32_bytes) over the whole tree —
    the artifact-size story, for logging."""
    qb = fb = 0

    def rec(t):
        nonlocal qb, fb
        if is_quantized_leaf(t):
            qb += t[QKEY].nbytes + t[SKEY].nbytes
            fb += t[QKEY].size * 4
            return
        if isinstance(t, dict):
            for v in t.values():
                rec(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                rec(v)
        else:
            a = np.asarray(t)
            qb += a.nbytes
            fb += a.nbytes

    rec(qtree)
    return qb, fb
