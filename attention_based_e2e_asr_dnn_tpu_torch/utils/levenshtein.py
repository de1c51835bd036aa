"""Levenshtein-distance evaluation metric (the port's own copy of the JAX
package's ``utils/levenshtein.py``).

A C++ batch edit-distance routine bound via ctypes (``native/metrics.cpp``)
when its library has been built, the third-party ``Levenshtein`` extension
when installed, else a pure-Python dynamic program.

``ids_to_str`` skips ``<sos>`` and stops at the first ``<eos>``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterable, List, Sequence

import numpy as np

_NATIVE = None


def _load_native():
    """Try to load the C++ metrics shared library (built by native/Makefile)."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    candidates = [
        os.path.join(here, "_native", "libasrtpu.so"),
        os.path.join(os.path.dirname(here), "native", "libasrtpu.so"),
    ]
    for path in candidates:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.batch_levenshtein_ids.restype = None
                lib.batch_levenshtein_ids.argtypes = [
                    ctypes.POINTER(ctypes.c_int32),  # pred ids   (B, Tp) row-major
                    ctypes.POINTER(ctypes.c_int32),  # gold ids   (B, Tg) row-major
                    ctypes.c_int32,                  # B
                    ctypes.c_int32,                  # Tp
                    ctypes.c_int32,                  # Tg
                    ctypes.POINTER(ctypes.c_int32),  # gold lengths (B,)
                    ctypes.c_int32,                  # sos idx
                    ctypes.c_int32,                  # eos idx
                    ctypes.POINTER(ctypes.c_int32),  # out distances (B,)
                ]
                _NATIVE = lib
                return lib
            except OSError:
                continue
    _NATIVE = False
    return None


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two sequences (pure-Python two-row DP)."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, start=1):
            cur[j] = min(
                prev[j] + 1,            # deletion
                cur[j - 1] + 1,         # insertion
                prev[j - 1] + (ca != cb),  # substitution
            )
        prev = cur
    return prev[-1]


def ids_to_str(idx_seq: Iterable[int], vocab: List[str], sos_idx: int, eos_idx: int) -> str:
    """Id sequence -> string: skip <sos>, stop at first <eos>.

    Parity with the reference decode (reference: src/train.py:432-445,
    src/infer.py:19-32).
    """
    out = []
    for idx in idx_seq:
        idx = int(idx)
        if idx == sos_idx:
            continue
        if idx == eos_idx:
            break
        out.append(vocab[idx])
    return "".join(out)


def _trim_ids(idx_seq: np.ndarray, sos_idx: int, eos_idx: int) -> List[int]:
    """Id sequence with <sos> skipped and truncated at first <eos>."""
    out = []
    for idx in idx_seq:
        idx = int(idx)
        if idx == sos_idx:
            continue
        if idx == eos_idx:
            break
        out.append(idx)
    return out


def batch_levenshtein(
    pred_ids: np.ndarray,
    gold_ids: np.ndarray,
    gold_lens: np.ndarray,
    sos_idx: int,
    eos_idx: int,
) -> float:
    """Mean edit distance over a batch of id sequences.

    Distance on id sequences equals distance on the decoded strings because
    each vocabulary id maps to exactly one character. Parity with the
    reference's ``batch_levenshtein`` (reference: src/train.py:407-420): gold
    sequences are truncated to their true length first, predictions stop at
    the first <eos>.
    """
    pred_ids = np.asarray(pred_ids, dtype=np.int32)
    gold_ids = np.asarray(gold_ids, dtype=np.int32)
    gold_lens = np.asarray(gold_lens, dtype=np.int32)
    batch = pred_ids.shape[0]

    lib = _load_native()
    if lib:
        out = np.zeros((batch,), dtype=np.int32)
        pred_c = np.ascontiguousarray(pred_ids)
        gold_c = np.ascontiguousarray(gold_ids)
        lens_c = np.ascontiguousarray(gold_lens)
        lib.batch_levenshtein_ids(
            pred_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            gold_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(batch),
            ctypes.c_int32(pred_ids.shape[1]),
            ctypes.c_int32(gold_ids.shape[1]),
            lens_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(sos_idx),
            ctypes.c_int32(eos_idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return float(out.sum()) / batch

    try:  # third-party C extension, if available
        import Levenshtein as _L

        total = 0
        for b in range(batch):
            pred = _trim_ids(pred_ids[b], sos_idx, eos_idx)
            gold = _trim_ids(gold_ids[b, : gold_lens[b]], sos_idx, eos_idx)
            pred_s = "".join(chr(i + 33) for i in pred)
            gold_s = "".join(chr(i + 33) for i in gold)
            total += _L.distance(pred_s, gold_s)
        return total / batch
    except ImportError:
        pass

    total = 0
    for b in range(batch):
        pred = _trim_ids(pred_ids[b], sos_idx, eos_idx)
        gold = _trim_ids(gold_ids[b, : gold_lens[b]], sos_idx, eos_idx)
        total += levenshtein(pred, gold)
    return total / batch
