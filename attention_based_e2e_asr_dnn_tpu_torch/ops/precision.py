"""Compute-dtype policy (counterpart of the JAX ``ops/precision.py``).

Parameters stay float32 and are cast to the compute dtype where they are
used; activations run in the compute dtype that the experiment's config
snapshot names (``compute_dtype``, default float32).

A float32 product must run in full float32, as the JAX package's
``Precision.HIGHEST`` does: on the card that means TF32 off, which is
PyTorch's default for matrix products (``torch.backends.cuda.matmul
.allow_tf32`` False).
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """Config name ("float32" | "bfloat16") -> torch dtype."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(
            f"compute_dtype {name!r} not supported; one of {sorted(_DTYPES)}"
        ) from None
