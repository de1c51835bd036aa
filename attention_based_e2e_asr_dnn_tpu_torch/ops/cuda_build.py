"""Build a CUDA source of ``csrc/`` into a shared library at first use.

Each source compiles with ``nvcc`` for sm_90a into ``_build/`` under a name
that carries the hash of the source and of the headers (``*.cuh``) beside it,
so an edited source builds anew and an unchanged one is reused. ``nvcc``'s
register and shared-memory report (``-Xptxas -v``) goes to ``<library>.log``
beside the library. The kernels' modules bind the library with ``ctypes``.

A source is built when its module first needs it; ``build_all`` builds every
source of the package at once, one ``nvcc`` process a source side by side,
and binds the libraries. The entry points (``Trainer``, ``infer.main``,
``Transcriber``) call it through ``build_for`` before their first batch when
they run on a card with a kernel tier configured, so that a run does not build
the sources one after another at each kernel's first launch. A failed build
raises; nothing gives way to a plain version.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# one lock a library: a thread that needs a source another thread is building
# (a request during a background warm-up) waits for that build
_LOCKS: dict = {}
_LOCKS_GUARD = threading.Lock()


def library_path(source: str, defines: Sequence[str] = ()) -> str:
    """Where ``source``'s library is (or will be) built, compiled with the
    macros ``defines`` (``-D`` each)."""
    src_dir = os.path.dirname(source)
    headers = sorted(f for f in os.listdir(src_dir) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(defines).encode())
    for path in [source] + [os.path.join(src_dir, f) for f in headers]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    tag = digest.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")


def build_library(source: str, defines: Sequence[str] = ()) -> str:
    """Compile ``source`` (with the macros ``defines``, as an instrumented
    build needs them) unless its library exists; returns the path."""
    so = library_path(source, defines)
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(so, threading.Lock())
    with lock:
        if os.path.exists(so):
            return so
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError(f"building {os.path.basename(source)} needs the CUDA "
                               f"toolkit (nvcc); CUDA_HOME not found")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"),
               "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               *(f"-D{d}" for d in defines), "-o", tmp, source]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(source)} "
                               f"({res.returncode}):\n{res.stderr}")
        with open(so + ".log", "w") as fh:
            fh.write(res.stderr)
        os.replace(tmp, so)
        return so


def build_all() -> List[str]:
    """Build every CUDA source of the package side by side, one ``nvcc``
    process each, and bind the libraries (the modules' loaders), so that no
    kernel's first launch builds or loads anything. Returns the libraries'
    paths."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda, speller_cuda

    sources = (*lstm_cuda.SOURCES, *speller_cuda.SOURCES)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(build_library, sources))
    for load in (*lstm_cuda.LOADERS, *speller_cuda.LOADERS):
        load()
    return libs


def build_for(device, *impls: Optional[str]) -> None:
    """``build_all()`` where ``device`` is a card and one of the configured
    implementations (``lstm_impl``, ``decoder_impl``) is the kernel tier."""
    import torch

    if torch.device(device).type == "cuda" and "pallas" in impls:
        build_all()
