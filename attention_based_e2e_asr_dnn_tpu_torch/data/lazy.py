"""Lazy (disk-backed) feature datasets fed by the native C++ batch assembler
(this package's own copy of the JAX package's ``data/lazy.py``).

The reference loads the ENTIRE feature set into RAM at construction
(reference: src/utils.py:69-76) — fine for train-clean-100, not for
production-scale corpora. The lazy path keeps only file paths + lengths
(lengths parsed from .npy headers without reading data) and assembles each
padded batch on demand through ``native/npy_loader.cpp``'s thread pool
(numpy fallback when the library isn't built).

BucketBatcher integration: a dataset exposing ``feature_lengths`` skips the
load-everything length probe, and one exposing ``assemble(indices, t_pad)``
delegates feature-batch construction here.
"""

from __future__ import annotations

import ast
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from attention_based_e2e_asr_dnn_tpu_torch.data.native_loader import assemble_batch


def npy_header_shape(path: str) -> Tuple[int, ...]:
    """Parse a .npy header for its shape without reading the payload."""
    with open(path, "rb") as fh:
        magic = fh.read(8)
        if magic[:6] != b"\x93NUMPY":
            raise ValueError(f"{path}: not a .npy file")
        major = magic[6]
        if major == 1:
            (hlen,) = struct.unpack("<H", fh.read(2))
        else:
            (hlen,) = struct.unpack("<I", fh.read(4))
        header = fh.read(hlen).decode("latin1")
    meta = ast.literal_eval(header)
    return tuple(meta["shape"])


class LazyFeatureSource:
    """Disk-backed (T, F) float32 feature source with native batch assembly."""

    def __init__(self, paths: List[str], n_feats: int = 15,
                 n_threads: int = 0):
        self.paths = list(paths)
        self.n_feats = n_feats
        self.n_threads = n_threads
        self._lengths = np.array(
            [npy_header_shape(p)[0] for p in self.paths], dtype=np.int32
        )

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def feature_lengths(self) -> np.ndarray:
        return self._lengths

    def __getitem__(self, index: int) -> np.ndarray:
        return np.load(self.paths[index]).astype(np.float32)[:, : self.n_feats]

    def assemble(self, indices, t_pad: int):
        """(B,) indices -> ((B, t_pad, F) zero-padded, (B,) lengths)."""
        batch_paths = [self.paths[i] for i in indices]
        return assemble_batch(batch_paths, t_pad, self.n_feats, self.n_threads)


class LazyAsrTestDataset(LazyFeatureSource):
    """Lazy test dataset over a reference-layout ``std_dir/mfcc``."""

    def __init__(self, std_dir: str, n_feats: int = 15,
                 max_utterances: Optional[int] = None):
        mfcc_dir = os.path.join(std_dir, "mfcc")
        paths = sorted(
            os.path.join(mfcc_dir, f)
            for f in os.listdir(mfcc_dir)
            if f.endswith(".npy")
        )
        if max_utterances:
            paths = paths[:max_utterances]
        super().__init__(paths, n_feats)


class LazyAsrTrainDevDataset(LazyFeatureSource):
    """Disk-backed train/dev dataset: features stay on disk (assembled per
    batch by the native thread pool), transcripts — tiny int arrays — load
    eagerly so label batching and length stats need no feature reads.

    Capability upgrade over the reference, which loads EVERY feature into RAM
    at construction (src/utils.py:69-76); same (feature, transcript) item
    contract as ``AsrTrainDevDataset``, plus the ``assemble``/``label``
    protocol the BucketBatcher uses to skip per-item feature loads.
    """

    def __init__(
        self,
        std_dir: str,
        label_to_idx: dict,
        keep_tags: bool = True,
        n_feats: int = 15,
        max_utterances: Optional[int] = None,
    ):
        mfcc_dir = os.path.join(std_dir, "mfcc")
        trans_dir = os.path.join(std_dir, "transcript", "raw")
        paths = sorted(
            os.path.join(mfcc_dir, f)
            for f in os.listdir(mfcc_dir)
            if f.endswith(".npy")
        )
        trans_paths = sorted(
            os.path.join(trans_dir, f)
            for f in os.listdir(trans_dir)
            if f.endswith(".npy")
        )
        if max_utterances:
            paths = paths[:max_utterances]
            trans_paths = trans_paths[:max_utterances]
        super().__init__(paths, n_feats)
        self.transcripts = []
        for f in trans_paths:
            raw = np.load(f)
            if not keep_tags:
                raw = raw[1:-1]
            self.transcripts.append(
                np.array([label_to_idx[str(c)] for c in raw], dtype=np.int32)
            )
        if len(self.transcripts) != len(self.paths):
            raise ValueError(
                f"{len(self.paths)} features vs {len(self.transcripts)} transcripts"
            )

    def __getitem__(self, index: int):
        return super().__getitem__(index), self.transcripts[index]

    def label(self, index: int) -> np.ndarray:
        """Transcript WITHOUT touching the feature file."""
        return self.transcripts[index]
