"""PyTorch port, data and batch splitting: the numpy loaders and the
length-bucketed batcher against the JAX package's, and the listener
kernels' split of a batch into launches of 32 rows (on the CPU, through the
plain versions)."""

import os

import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu.constants import VOCAB_MAP
from attention_based_e2e_asr_dnn_tpu.data import batching as jbatching
from attention_based_e2e_asr_dnn_tpu.data import datasets as jdatasets
from attention_based_e2e_asr_dnn_tpu_torch.data import batching as tbatching
from attention_based_e2e_asr_dnn_tpu_torch.data import datasets as tdatasets
from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Reference layout (mfcc/*.npy, transcript/raw/*.npy) with 11
    utterances of mixed lengths, and a toy single-array dataset."""
    root = str(tmp_path_factory.mktemp("data"))
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "mfcc"))
    os.makedirs(os.path.join(root, "transcript", "raw"))
    for i in range(11):
        np.save(os.path.join(root, "mfcc", f"u{i:02d}.npy"),
                rng.standard_normal((int(rng.integers(3, 40)), 15)).astype(np.float32))
        text = "".join(rng.choice(list("ABC '"), int(rng.integers(1, 9))))
        np.save(os.path.join(root, "transcript", "raw", f"u{i:02d}.npy"),
                np.array(["<sos>"] + list(text) + ["<eos>"]))
    np.save(os.path.join(root, "dev.npy"), rng.standard_normal((5, 9, 20)).astype(np.float32))
    np.save(os.path.join(root, "dev_labels.npy"), np.array(["AB", "C", "A B", "'", "BB"]))
    return root


def _assert_items_equal(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        xa, xb = (a[i], b[i]) if isinstance(a[i], tuple) else ((a[i],), (b[i],))
        for u, v in zip(xa, xb):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("keep_tags", [True, False])
def test_reference_layout_datasets_match_jax(data_dir, keep_tags):
    kw = dict(std_dir=data_dir, label_to_idx=VOCAB_MAP, keep_tags=keep_tags, max_utterances=9)
    ours, ref = tdatasets.AsrTrainDevDataset(**kw), jdatasets.AsrTrainDevDataset(**kw)
    _assert_items_equal(ours, ref)
    np.testing.assert_array_equal(ours.feature_lengths, ref.feature_lengths)
    _assert_items_equal(tdatasets.AsrTestDataset(data_dir), jdatasets.AsrTestDataset(data_dir))


def test_toy_datasets_match_jax(data_dir):
    _assert_items_equal(tdatasets.ToyTrainDevDataset(data_dir, "dev", VOCAB_MAP),
                        jdatasets.ToyTrainDevDataset(data_dir, "dev", VOCAB_MAP))
    ours = tdatasets.ToyTestDataset(data_dir)
    _assert_items_equal(ours, jdatasets.ToyTestDataset(data_dir))
    assert ours[0].shape == (9, 15)


@pytest.mark.parametrize("has_labels", [True, False])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_bucket_batcher_matches_jax(data_dir, shuffle, drop_last, has_labels):
    if has_labels:
        ds = tdatasets.AsrTrainDevDataset(std_dir=data_dir, label_to_idx=VOCAB_MAP)
    else:
        ds = tdatasets.AsrTestDataset(data_dir)
    kw = dict(batch_size=4, pad_time_multiple=8, pad_label_multiple=4,
              has_labels=has_labels, shuffle=shuffle, shuffle_window=2, seed=3,
              drop_last=drop_last)
    ours, ref = tbatching.BucketBatcher(ds, **kw), jbatching.BucketBatcher(ds, **kw)
    assert len(ours) == len(ref) == (2 if drop_last else 3)
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for field in ("x", "lx", "y", "ly", "indices"):
                u, v = getattr(a, field), getattr(b, field)
                assert (u is None) == (v is None)
                if u is not None:
                    assert u.dtype == v.dtype
                    np.testing.assert_array_equal(u, v)
    assert tbatching.pad_to_multiple(17, 8) == jbatching.pad_to_multiple(17, 8) == 24


def test_row_chunks_cover_the_batch_in_launches_of_32():
    assert lstm_cuda.row_chunks(32) == [(0, 32)]
    assert lstm_cuda.row_chunks(40) == [(0, 32), (32, 40)]
    assert lstm_cuda.row_chunks(64) == [(0, 32), (32, 64)]
    assert lstm_cuda.row_chunks(5, rows=2) == [(0, 2), (2, 4), (4, 5)]


@pytest.mark.parametrize("fused", [True, False])
def test_row_split_equals_the_whole_batch(fused):
    """Rows are independent: the plain versions over the launches' row
    ranges, stacked, equal one pass over the whole batch."""
    gen = torch.Generator().manual_seed(4)
    batch, seq_len, hidden = 40, 6, 8
    lengths = torch.randint(1, seq_len + 1, (batch,), generator=gen).to(torch.int32)
    w_hh = torch.rand(2, hidden, 4 * hidden, generator=gen) - 0.5
    if fused:
        x = torch.randn(batch, seq_len, 5, generator=gen)
        w = (torch.rand(2, 5, 4 * hidden, generator=gen) - 0.5,
             torch.rand(2, 4 * hidden, generator=gen) - 0.5)
        fn = lstm_cuda.lstm_scan_fusedin_plain
    else:
        x = torch.randn(batch, seq_len, 8 * hidden, generator=gen)
        w = ()
        fn = lstm_cuda.lstm_scan_plain
    whole = fn(x, *w, w_hh, lengths, (False, True))
    parts = torch.cat([fn(x[r0:r1], *w, w_hh, lengths[r0:r1], (False, True))
                       for r0, r1 in lstm_cuda.row_chunks(batch)])
    assert torch.equal(parts, whole)
