"""ctypes binding for the native C++ npy batch assembler
(``native/npy_loader.cpp``), this package's own copy of the JAX package's
``data/native_loader.py``.

A thread pool parses .npy headers and reads float32 feature matrices
zero-padded straight into one (B, T_pad, F) buffer: the role the reference
gave DataLoader worker processes. The shared library is looked for in
``<package>/_native/`` and then in ``<repo>/native/``; it is built by
``native/Makefile`` and is not tracked, so a fresh checkout has none, and the
numpy path below then serves, with the same batches.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

_LIB = None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB or None
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    candidates = [
        os.path.join(here, "_native", "libasrtpu.so"),
        os.path.join(os.path.dirname(here), "native", "libasrtpu.so"),
    ]
    for path in candidates:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.assemble_batch_f32.restype = ctypes.c_int
                lib.assemble_batch_f32.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_int32,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_int32,
                ]
                _LIB = lib
                return lib
            except OSError:
                continue
    _LIB = False
    return None


def native_available() -> bool:
    return _load() is not None


def assemble_batch(
    paths: List[str], t_pad: int, n_feats: int, n_threads: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Read `paths` (2-D float32 .npy files) into a zero-padded batch.

    Returns (x (B, t_pad, n_feats) float32, lengths (B,) int32). Uses the
    native assembler when built; numpy otherwise.
    """
    batch = len(paths)
    lib = _load()
    if lib is not None:
        blob = b"".join(p.encode() + b"\x00" for p in paths)
        offsets = np.zeros((batch,), np.int64)
        pos = 0
        for i, p in enumerate(paths):
            offsets[i] = pos
            pos += len(p.encode()) + 1
        x = np.zeros((batch, t_pad, n_feats), np.float32)
        lengths = np.zeros((batch,), np.int32)
        rc = lib.assemble_batch_f32(
            blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int32(batch),
            ctypes.c_int64(t_pad),
            ctypes.c_int64(n_feats),
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(n_threads),
        )
        if rc == 0:
            return x, lengths
        # fall through to numpy on any parse error (e.g. non-f4 dtype)

    x = np.zeros((batch, t_pad, n_feats), np.float32)
    lengths = np.zeros((batch,), np.int32)
    for b, p in enumerate(paths):
        arr = np.load(p).astype(np.float32)
        n = min(len(arr), t_pad)
        x[b, :n] = arr[:n, :n_feats]
        lengths[b] = n
    return x, lengths
