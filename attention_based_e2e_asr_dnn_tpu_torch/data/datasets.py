"""Dataset loaders for the LAS pipeline (counterpart of the JAX
``data/datasets.py``), numpy only: ``mfcc/*.npy`` features and
``transcript/raw/*.npy`` character transcripts in the reference layout, and
the toy single-array datasets, and the Rewriter's LM datasets (LAS
prediction strings, with gold transcripts for training). Datasets only load
and index examples; padding and bucketing are ``data/batching.py``'s.

The JAX package's loaders cannot be imported without JAX (its
``data/__init__`` imports SpecAugment). The LM datasets read a submission
CSV with the ``csv`` module where the JAX ones use pandas: the same labels,
an empty one staying ``""`` (pandas' ``keep_default_na=False``).
"""

from __future__ import annotations

import csv
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


def _wrap_ids(text: str, label_to_idx: Dict[str, int], sos: int, eos: int) -> np.ndarray:
    return np.array([sos] + [label_to_idx[c] for c in text] + [eos], dtype=np.int32)


def read_prediction_lines(pred_path: str) -> List[str]:
    """The prediction strings of ``pred_path``, by its content: a submission
    CSV (an ``id,label`` header, as ``infer`` writes it next to a template)
    gives its label column, anything else one prediction a line. Blank CSV
    lines are skipped, as pandas skips them."""
    with open(pred_path, "r") as fh:
        first = fh.readline().strip().lower()
    if first.replace(" ", "") == "id,label":
        with open(pred_path, "r", newline="") as fh:
            rows = [row for row in csv.reader(fh) if row]
        col = rows[0].index("label")
        return [row[col] if col < len(row) else "" for row in rows[1:]]
    with open(pred_path, "r") as fh:
        return [line.rstrip("\n") for line in fh]


class LmTrainDevDataset:
    """LAS-prediction strings paired with gold transcripts (reference:
    src/lmtrain.py:30-94). Predictions are wrapped in <sos>...<eos>; gold
    transcripts are the ``.npy`` character arrays, in sorted file order."""

    def __init__(self, trans_dir: str, pred_path: str, label_to_idx: Dict[str, int]):
        sos = label_to_idx["<sos>"]
        eos = label_to_idx["<eos>"]
        self.predictions = [_wrap_ids(line, label_to_idx, sos, eos)
                            for line in read_prediction_lines(pred_path)]
        self.transcripts = [
            np.array([label_to_idx[str(c)] for c in np.load(f)], dtype=np.int32)
            for f in _npy_files(trans_dir)
        ]
        if len(self.predictions) != len(self.transcripts):
            raise ValueError(f"{pred_path}: {len(self.predictions)} predictions for "
                             f"{len(self.transcripts)} transcripts in {trans_dir}")

    def __len__(self) -> int:
        return len(self.predictions)

    def __getitem__(self, index: int):
        return self.predictions[index], self.transcripts[index]


class LmTestDataset:
    """LAS-prediction strings as id arrays wrapped in <sos>...<eos>."""

    def __init__(self, pred_path: str, label_to_idx: Dict[str, int]):
        sos = label_to_idx["<sos>"]
        eos = label_to_idx["<eos>"]
        self.predictions = [_wrap_ids(line, label_to_idx, sos, eos)
                            for line in read_prediction_lines(pred_path)]

    def __len__(self) -> int:
        return len(self.predictions)

    def __getitem__(self, index: int):
        return self.predictions[index]
