"""PyTorch port, the lazy (disk-backed) input pipeline: the port's own copies
of ``data/lazy.py`` and ``data/native_loader.py`` held to the JAX package's
originals, the lazy batcher's batches against the eager one's byte for byte
(through the numpy assembler and, where it is built, the native library),
``.npy`` header parsing, and ``train.main`` with ``lazy_data: true`` against
``lazy_data: false`` on the CPU."""

import inspect
import os

import numpy as np
import pytest
import torch
import yaml

from attention_based_e2e_asr_dnn_tpu import constants as jconstants
from attention_based_e2e_asr_dnn_tpu.data import lazy as jlazy
from attention_based_e2e_asr_dnn_tpu.data import native_loader as jnative
from attention_based_e2e_asr_dnn_tpu.data.batching import BucketBatcher as JBatcher
from attention_based_e2e_asr_dnn_tpu_torch import train as ttrain
from attention_based_e2e_asr_dnn_tpu_torch.data import lazy, native_loader
from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher, ThreadedPrefetcher
from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import AsrTestDataset, AsrTrainDevDataset
from attention_based_e2e_asr_dnn_tpu_torch.tools import convergence_run, make_synthetic_data

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    make_synthetic_data.generate(str(root), n_train=21, n_dev=8, n_test=8, words_min=2,
                                 words_max=3, seed=2)
    return str(root)


@pytest.fixture
def numpy_assembler(monkeypatch):
    """Both packages' loaders without the native library (``_LIB = False``
    is their own "looked and found none")."""
    monkeypatch.setattr(native_loader, "_LIB", False)
    monkeypatch.setattr(jnative, "_LIB", False)


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        for field in ("x", "lx", "y", "ly", "indices"):
            u, v = getattr(x, field), getattr(y, field)
            assert (u is None) == (v is None), field
            if u is not None:
                assert u.dtype == v.dtype and u.shape == v.shape, field
                assert u.tobytes() == v.tobytes(), field


@pytest.mark.parametrize("name", ["npy_header_shape", "LazyFeatureSource",
                                  "LazyAsrTestDataset", "LazyAsrTrainDevDataset"])
def test_lazy_copy_is_the_original(name):
    """The port's copy differs from the JAX package's module only in the
    package it imports the assembler from."""
    assert inspect.getsource(getattr(lazy, name)) == inspect.getsource(getattr(jlazy, name))


@pytest.mark.parametrize("name", ["_load", "native_available", "assemble_batch"])
def test_native_loader_copy_is_the_original(name):
    assert (inspect.getsource(getattr(native_loader, name))
            == inspect.getsource(getattr(jnative, name)))


@pytest.mark.parametrize("version", [(1, 0), (2, 0)])
def test_npy_header_shape_versions(tmp_path, version):
    arr = np.arange(7 * 15, dtype=np.float32).reshape(7, 15)
    path = str(tmp_path / "a.npy")
    with open(path, "wb") as fh:
        np.lib.format.write_array(fh, arr, version=version)
    assert lazy.npy_header_shape(path) == jlazy.npy_header_shape(path) == (7, 15)
    bad = tmp_path / "b.npy"
    bad.write_bytes(b"not an npy file at all")
    with pytest.raises(ValueError, match="not a .npy file"):
        lazy.npy_header_shape(str(bad))


@pytest.mark.parametrize("shuffle", [False, True])
def test_lazy_batches_equal_eager_batches(corpus, numpy_assembler, shuffle):
    """Train split, labels, a ragged last batch (21 utterances, batches of
    8), two epochs: the lazy batcher's batches are the eager one's byte for
    byte, and the JAX package's lazy batcher gives the same."""
    split = os.path.join(corpus, "train-clean-100")
    vocab = jconstants.VOCAB_MAP
    eager = AsrTrainDevDataset(std_dir=split, label_to_idx=vocab, keep_tags=True)
    ours = lazy.LazyAsrTrainDevDataset(split, vocab, keep_tags=True)
    theirs = jlazy.LazyAsrTrainDevDataset(split, vocab, keep_tags=True)
    assert not native_loader.native_available()
    assert len(ours) == len(eager) == 21
    np.testing.assert_array_equal(ours.feature_lengths, [len(eager[i][0]) for i in range(21)])
    np.testing.assert_array_equal(ours[3][0], eager[3][0])
    np.testing.assert_array_equal(ours.label(3), eager[3][1])
    kw = dict(batch_size=8, pad_time_multiple=64, pad_label_multiple=32, label_pad_id=29,
              shuffle=shuffle, seed=5)
    for epoch in (0, 1):
        _same_batches(BucketBatcher(ours, **kw).epoch(epoch),
                      BucketBatcher(eager, **kw).epoch(epoch))
        _same_batches(BucketBatcher(ours, **kw).epoch(epoch),
                      JBatcher(theirs, **kw).epoch(epoch))
    # through the prefetcher, as the Trainer reads it
    _same_batches(ThreadedPrefetcher(BucketBatcher(ours, **kw).epoch(0)),
                  BucketBatcher(eager, **kw).epoch(0))


def test_lazy_test_set_batches_equal_eager(corpus, numpy_assembler):
    split = os.path.join(corpus, "test-clean")
    ours = lazy.LazyAsrTestDataset(split, max_utterances=7)
    eager = AsrTestDataset(std_dir=split)
    assert len(ours) == 7
    kw = dict(batch_size=4, pad_time_multiple=32, has_labels=False)
    got = list(BucketBatcher(ours, **kw).epoch(0))
    assert [b.y for b in got] == [None, None] and got[-1].indices[-1] == -1
    full = lazy.LazyAsrTestDataset(split)
    _same_batches(BucketBatcher(full, **kw).epoch(0), BucketBatcher(eager, **kw).epoch(0))


def test_native_library_gives_the_numpy_batches(corpus):
    """Where ``native/libasrtpu.so`` is built, its batches equal numpy's."""
    native_loader._LIB = None   # look again
    if not native_loader.native_available():
        pytest.skip("native/libasrtpu.so is not built here (it is not tracked)")
    split = os.path.join(corpus, "train-clean-100", "mfcc")
    paths = sorted(os.path.join(split, f) for f in os.listdir(split))[:6]
    x, lx = native_loader.assemble_batch(paths, 256, 15, 2)
    native_loader._LIB = False
    try:
        x2, lx2 = native_loader.assemble_batch(paths, 256, 15)
    finally:
        native_loader._LIB = None
    assert x.tobytes() == x2.tobytes() and lx.tobytes() == lx2.tobytes()


def test_numpy_assembler_truncates_and_pads(tmp_path, numpy_assembler):
    paths = []
    for i, n in enumerate((5, 12, 9)):
        paths.append(str(tmp_path / f"u{i}.npy"))
        np.save(paths[-1], np.full((n, 20), i + 1, np.float64))     # wider, float64
    x, lx = native_loader.assemble_batch(paths, 10, 15)
    x_ref, lx_ref = jnative.assemble_batch(paths, 10, 15)
    assert x.shape == (3, 10, 15) and x.dtype == np.float32 and lx.tolist() == [5, 10, 9]
    assert x.tobytes() == x_ref.tobytes() and lx.tobytes() == lx_ref.tobytes()
    assert x[0, 5:].max() == 0 and x[1].min() == 2


def test_train_cli_lazy_data_equals_eager(corpus, tmp_path, numpy_assembler):
    """``train.main`` with ``lazy_data: true`` goes through the lazy datasets
    and gives the losses of ``lazy_data: false`` exactly: the batches are the
    same bytes and the seeds the same."""
    histories = {}
    for lazy_data in (True, False):
        exp = tmp_path / f"lazy-{lazy_data}"
        cfg = convergence_run.make_config(corpus, str(exp), 2, batch_size=8, arch="small",
                                          lstm_impl="pallas", decoder_impl="pallas",
                                          max_steps=32)
        cfg["model"]["configs"]["listener_configs"].update(uniform_hid_dim=32, plstm_layers=2)
        cfg["model"]["configs"]["speller_configs"].update(
            att_proj_dim=32, dec_emb_dim=64, dec_lstm_hid_dim=32, dec_lstm_out_dim=32)
        cfg.update(pad_time_multiple=64, compute_dtype="float32", lazy_data=lazy_data)
        os.makedirs(str(exp), exist_ok=True)
        path = os.path.join(str(exp), "train.yml")
        with open(path, "w") as fh:
            yaml.safe_dump(cfg, fh)
        trainer = ttrain.main(ttrain.build_argparser().parse_args(["-c", path, "--device", "cpu"]))
        want = lazy.LazyAsrTrainDevDataset if lazy_data else AsrTrainDevDataset
        assert type(trainer.trn_batcher.dataset) is want
        assert type(trainer.dev_batcher.dataset) is want
        histories[lazy_data] = (trainer.train_history, trainer.dev_history)
    assert histories[True] == histories[False]
    assert len(histories[True][0]["loss"]) == 2
