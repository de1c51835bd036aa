"""Dataset loaders for the LAS pipeline (counterpart of the JAX
``data/datasets.py``), numpy only: ``mfcc/*.npy`` features and
``transcript/raw/*.npy`` character transcripts in the reference layout, and
the toy single-array datasets. Datasets only load and index examples;
padding and bucketing are ``data/batching.py``'s.

The JAX package's loaders cannot be imported without JAX (its
``data/__init__`` imports SpecAugment). The Rewriter's LM datasets are not
ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


def _npy_files(directory: str) -> List[str]:
    return sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.endswith(".npy")
    )


class AsrTrainDevDataset:
    """MFCC features + character transcripts (reference: src/utils.py:36-128).

    Loads all ``mfcc/*.npy`` and ``transcript/raw/*.npy`` under ``std_dir``
    into RAM, maps characters to ids, optionally strips <sos>/<eos> tags.
    """

    def __init__(
        self,
        std_dir: Optional[str] = None,
        mfcc_dir: Optional[str] = None,
        trans_dir: Optional[str] = None,
        label_to_idx: Optional[Dict[str, int]] = None,
        keep_tags: bool = True,
        max_utterances: Optional[int] = None,
    ):
        if std_dir:
            mfcc_dir = os.path.join(std_dir, "mfcc")
            trans_dir = os.path.join(std_dir, "transcript", "raw")
        self.label_to_idx = label_to_idx
        mfcc_fns = _npy_files(mfcc_dir)
        trans_fns = _npy_files(trans_dir)
        if max_utterances:
            mfcc_fns = mfcc_fns[:max_utterances]
            trans_fns = trans_fns[:max_utterances]
        self.features = [np.load(f).astype(np.float32) for f in mfcc_fns]
        self.transcripts = []
        for f in trans_fns:
            raw = np.load(f)
            if not keep_tags:
                raw = raw[1:-1]
            self.transcripts.append(
                np.array([label_to_idx[str(c)] for c in raw], dtype=np.int32)
            )
        assert len(self.features) == len(self.transcripts), (
            f"{len(self.features)} features vs {len(self.transcripts)} transcripts"
        )

    def __len__(self) -> int:
        return len(self.features)

    def __getitem__(self, index: int):
        return self.features[index], self.transcripts[index]

    @property
    def feature_lengths(self) -> np.ndarray:
        return np.array([len(f) for f in self.features], dtype=np.int32)


class AsrTestDataset:
    """MFCC features only (reference: src/utils.py:132-182).

    The reference sorts utterances by length descending at load time for
    tight padding; here the Batcher handles length-sorted bucketing, and the
    ORIGINAL file order is preserved so submission CSVs keep template order
    (fixing the reference's length-sorted-output quirk, src/infer.py note in
    SURVEY.md §2).
    """

    def __init__(self, std_dir: str, max_utterances: Optional[int] = None):
        mfcc_fns = _npy_files(os.path.join(std_dir, "mfcc"))
        if max_utterances:
            mfcc_fns = mfcc_fns[:max_utterances]
        self.features = [np.load(f).astype(np.float32) for f in mfcc_fns]

    def __len__(self) -> int:
        return len(self.features)

    def __getitem__(self, index: int):
        return self.features[index]


class ToyTrainDevDataset:
    """Single-array toy dataset (reference: src/utils.py:186-249).

    ``root_dir/{subset}.npy`` holds (N, T, >=15) features, sliced to the
    first 15 dims; ``{subset}_labels.npy`` holds label strings.
    """

    def __init__(self, root_dir: str, subset: str, label_to_idx: Dict[str, int]):
        feats = np.load(os.path.join(root_dir, f"{subset}.npy"))
        self.features = [f.astype(np.float32) for f in feats[:, :, :15]]
        labels = np.load(os.path.join(root_dir, f"{subset}_labels.npy"))
        self.transcripts = [
            np.array([label_to_idx[str(c)] for c in y], dtype=np.int32) for y in labels
        ]

    def __len__(self) -> int:
        return len(self.features)

    def __getitem__(self, index: int):
        return self.features[index], self.transcripts[index]


class ToyTestDataset:
    """Toy features only (reference: src/utils.py:253-290)."""

    def __init__(self, root_dir: str, subset: str = "dev"):
        feats = np.load(os.path.join(root_dir, f"{subset}.npy"))
        self.features = [f.astype(np.float32) for f in feats[:, :, :15]]

    def __len__(self) -> int:
        return len(self.features)

    def __getitem__(self, index: int):
        return self.features[index]
