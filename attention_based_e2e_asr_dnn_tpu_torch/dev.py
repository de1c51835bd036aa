"""Development/data tooling (reference: src/dev.py); the port's own copy of
the JAX package's ``dev.py``, held to it by ``tests/test_torch_tools.py``.

    python -m attention_based_e2e_asr_dnn_tpu_torch.dev extract-mini --root-dir ./data --out-dir ./small

``extract_mini`` — copy a random subset of the dataset into a fast-iteration
mini layout; ``uniform_filenames`` — normalize ``_`` -> ``-`` in mfcc
filenames. Fix over the reference (documented): the subset is sampled
WITHOUT replacement and mfcc/transcript pairs stay aligned (the reference's
np.random.choice default could duplicate files, src/dev.py:22).
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np


def extract_mini(root_dir: str = "./data", out_dir: str = "./small",
                 ratio: float = 0.05, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    for split in ("train-clean-100", "dev-clean"):
        subroot = os.path.join(root_dir, split)
        mfcc_dir = os.path.join(subroot, "mfcc")
        all_fns = sorted(f for f in os.listdir(mfcc_dir) if f.endswith(".npy"))
        out_num = max(int(ratio * len(all_fns)), 1)
        fns = rng.choice(all_fns, size=out_num, replace=False)
        for tag in ("mfcc", "transcript/raw"):
            src_dir = os.path.join(subroot, tag)
            dst_dir = src_dir.replace(root_dir, out_dir)
            os.makedirs(dst_dir, exist_ok=True)
            for fn in fns:
                src_fn = fn if tag == "mfcc" else fn.replace("_", "-")
                shutil.copy(
                    os.path.join(src_dir, src_fn),
                    os.path.join(dst_dir, src_fn.replace("_", "-")),
                )


def uniform_filenames(root_dir: str = "./data") -> None:
    for split in ("train-clean-100", "dev-clean", "test-clean"):
        subdir = os.path.join(root_dir, split, "mfcc")
        if not os.path.isdir(subdir):
            continue
        for f in os.listdir(subdir):
            if f.endswith(".npy") and "_" in f:
                os.rename(os.path.join(subdir, f),
                          os.path.join(subdir, f.replace("_", "-")))


def main():
    parser = argparse.ArgumentParser(description="data tooling")
    parser.add_argument("command", choices=["extract-mini", "uniform-filenames"])
    parser.add_argument("--root-dir", default="./data")
    parser.add_argument("--out-dir", default="./small")
    parser.add_argument("--ratio", type=float, default=0.05)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if args.command == "extract-mini":
        extract_mini(args.root_dir, args.out_dir, args.ratio, args.seed)
    else:
        uniform_filenames(args.root_dir)


if __name__ == "__main__":
    main()
