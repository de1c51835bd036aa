"""Build a CUDA source of ``csrc/`` into a shared library at first use.

Each source compiles with ``nvcc`` for sm_90a into ``_build/`` under a name
that carries the hash of the source and of the headers (``*.cuh``) beside it,
so an edited source builds anew and an unchanged one is reused. ``nvcc``'s
register and shared-memory report (``-Xptxas -v``) goes to ``<library>.log``
beside the library. The kernels' modules bind the library with ``ctypes``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def library_path(source: str) -> str:
    """Where ``source``'s library is (or will be) built."""
    src_dir = os.path.dirname(source)
    headers = sorted(f for f in os.listdir(src_dir) if f.endswith(".cuh"))
    digest = hashlib.sha256()
    for path in [source] + [os.path.join(src_dir, f) for f in headers]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    tag = digest.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")


def build_library(source: str) -> str:
    """Compile ``source`` unless its library exists; returns the path."""
    so = library_path(source)
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
           "-o", tmp, source]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {os.path.basename(source)} "
                           f"({res.returncode}):\n{res.stderr}")
    with open(so + ".log", "w") as fh:
        fh.write(res.stderr)
    os.replace(tmp, so)
    return so
