"""Attention-map diagnostics (counterpart of the JAX ``utils/plotting.py``):
per epoch one heat map a head of sample 0's attention weights, saved as
``attention-map-epoch{N}.png``. matplotlib is imported at the call, so the
package imports without it; ``have_matplotlib`` lets the Trainer skip the
maps where it is missing.
"""

from __future__ import annotations

import importlib.util
import math
import os

import numpy as np


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def pay_attention_multihead(att_wgts, epoch: int, root_dir: str = ".") -> str:
    """att_wgts: (num_heads, enc_len, dec_steps) array-like."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    att = np.asarray(att_wgts)
    num_heads = att.shape[0]
    n_rows = max(int(math.sqrt(num_heads)), 1)
    n_cols = math.ceil(num_heads / n_rows)  # cover all heads (5 -> 2x3)
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(10, 10), squeeze=False)
    fig.suptitle(f"Attention Map [Epoch={epoch}]")
    fig.supxlabel("Output Character Count")
    fig.supylabel("Compressed Input Frame Count")
    for r in range(n_rows):
        for c in range(n_cols):
            i = r * n_cols + c
            ax = axes[r][c]
            if i >= num_heads:
                ax.axis("off")
                continue
            im = ax.imshow(att[i], aspect="auto", cmap="coolwarm",
                           interpolation="nearest")
            if num_heads > 1:
                ax.set_title(f"Attention Head #[{i}]")
            fig.colorbar(im, ax=ax, fraction=0.046)
    os.makedirs(root_dir, exist_ok=True)
    img_fp = os.path.join(root_dir, f"attention-map-epoch{epoch}.png")
    fig.savefig(img_fp, dpi=128)
    plt.close(fig)
    return img_fp
