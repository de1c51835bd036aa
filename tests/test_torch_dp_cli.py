"""PyTorch port, data parallelism through the entry points: the per-rank
batcher, the ``train`` and ``lmtrain`` CLIs with ``parallel: {use: true,
data: 2}`` (two gloo ranks on the CPU, spawned by the CLI itself) against
``parallel.use: false`` runs of the same global batch, checkpoints crossing
between DP and one-process runs, rank 0 as the only writer, what the CLIs
refuse, and the data-parallel decode of ``Transcriber`` and the artifacts
held over a ``[cpu, cpu]`` device list.

The runs are deterministic (dropout off, tf 1.0, no SpecAugment), so a DP
run and a one-process run compute the same function on the same batches; the
histories agree within float32 summation order (rtol 1e-4)."""

import os

import numpy as np
import pytest
import torch
import yaml

from attention_based_e2e_asr_dnn_tpu.training import checkpoints as jckpt
from attention_based_e2e_asr_dnn_tpu_torch import constants
from attention_based_e2e_asr_dnn_tpu_torch import export as texport
from attention_based_e2e_asr_dnn_tpu_torch import lmtrain as tlmtrain
from attention_based_e2e_asr_dnn_tpu_torch import serving as tserving
from attention_based_e2e_asr_dnn_tpu_torch import train as ttrain
from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher
from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import AsrTrainDevDataset
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.parallel import dp as tdp
from attention_based_e2e_asr_dnn_tpu_torch.parallel import split as tsplit
from attention_based_e2e_asr_dnn_tpu_torch.tools import convergence_run, dp_probe
from attention_based_e2e_asr_dnn_tpu_torch.tools import make_synthetic_data
from attention_based_e2e_asr_dnn_tpu_torch.training import checkpoints as tckpt

import torch_dp_ranks as ranks
from test_torch_lmtrain import MODEL as LM_MODEL
from test_torch_lmtrain import _config as _lm_config
from test_torch_lmtrain import _corpus as _lm_corpus
from test_torch_serving import _make_experiment

torch.set_num_threads(1)

HIST_TOL = dict(rtol=1e-4, atol=1e-5)
LISTENER = dict(uniform_hid_dim=32, plstm_layers=2, init_dropout=0.0, mid_dropout=0.0,
                final_dropout=0.0)
SPELLER = dict(att_proj_dim=32, dec_emb_dim=64, dec_lstm_hid_dim=32, dec_lstm_out_dim=32,
               dec_lstm_dropout=0.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    make_synthetic_data.generate(str(root), n_train=24, n_dev=8, n_test=8, words_min=2,
                                 words_max=3, seed=1)
    return str(root)


def _cli_config(corpus, exp, parallel, impl="pallas", **extra):
    """The ``small`` harness config at toy widths, deterministic, both kernel
    tiers (their plain versions on the CPU) unless ``impl`` says scan."""
    cfg = convergence_run.make_config(corpus, str(exp), 2, batch_size=8, arch="small",
                                      lstm_impl=impl, decoder_impl=impl, max_steps=32)
    cfg["model"]["configs"]["listener_configs"].update(LISTENER)
    cfg["model"]["configs"]["speller_configs"].update(SPELLER)
    cfg.update(pad_time_multiple=64, compute_dtype="float32", parallel=parallel,
               tf_rate_scheduler={"use": False, "configs": {}}, **extra)
    os.makedirs(str(exp), exist_ok=True)
    path = os.path.join(str(exp), "train.yml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


def _train(path):
    return ttrain.main(ttrain.build_argparser().parse_args(["-c", path, "--device", "cpu"]))


def _assert_history_close(a, b):
    for key in ("loss", "ppl"):
        np.testing.assert_allclose(a.train_history[key], b.train_history[key], **HIST_TOL)
        np.testing.assert_allclose(a.dev_history[key], b.dev_history[key], **HIST_TOL)
    assert a.dev_history["ld"] == b.dev_history["ld"]


# ---------------------------------------------------------------------------
# The per-rank batcher
# ---------------------------------------------------------------------------

class _RecordingLazy:
    """A lazy dataset (``assemble`` / ``label``) that records which rows'
    features were read."""

    def __init__(self, lengths):
        self.feature_lengths = lengths
        self.read = []

    def __len__(self):
        return len(self.feature_lengths)

    def assemble(self, indices, t_pad):
        self.read.extend(int(i) for i in indices)
        x = np.zeros((len(indices), t_pad, 15), np.float32)
        for b, i in enumerate(indices):
            x[b, : self.feature_lengths[i]] = i + 1
        return x, np.array([self.feature_lengths[i] for i in indices], np.int32)

    def label(self, i):
        return np.arange(1 + i % 5, dtype=np.int32)


def test_a_rank_batcher_assembles_its_rows_of_the_global_batch(corpus):
    """Each rank walks the same global plan from the same seed: its ``x`` and
    ``lx`` are its rows of the global batch (padded in time as that batch
    is), ``y``, ``ly`` and ``indices`` the global batch's; a lazy dataset
    reads only the rank's rows."""
    ds = AsrTrainDevDataset(std_dir=os.path.join(corpus, "train-clean-100"),
                            label_to_idx=constants.VOCAB_MAP, keep_tags=True)
    whole = BucketBatcher(ds, 8, 64, 32, label_pad_id=29, shuffle=True, seed=3)
    for rank in range(2):
        part = BucketBatcher(ds, 8, 64, 32, label_pad_id=29, shuffle=True, seed=3)
        part.set_shard(rank, 2)
        for epoch in (0, 1):
            for g, s in zip(whole.epoch(epoch), part.epoch(epoch)):
                rows = slice(4 * rank, 4 * rank + 4)
                assert s.rows == rows and whole.shard is None
                np.testing.assert_array_equal(s.x, g.x[rows])
                np.testing.assert_array_equal(s.lx, g.lx[rows])
                for name in ("y", "ly", "indices"):
                    np.testing.assert_array_equal(getattr(s, name), getattr(g, name))
    lazy = _RecordingLazy([5, 9, 3, 7, 8, 2])        # the last batch repeat-padded
    part = BucketBatcher(lazy, 4, 4, 4)
    part.set_shard(1, 2)
    batches = list(part.epoch(0))
    order = np.argsort(-np.array(lazy.feature_lengths), kind="stable")
    assert lazy.read == [int(order[2]), int(order[3]), int(order[5]), int(order[5])]
    assert batches[0].x.shape == (2, 12, 15)          # T padded as the global batch's
    assert list(batches[1].indices[2:]) == [-1, -1]   # rank 1's rows: padding only
    with pytest.raises(ValueError, match="batch dim 5 not divisible by data-parallel degree 2"):
        BucketBatcher(lazy, 5).set_shard(0, 2)


# ---------------------------------------------------------------------------
# The train CLI
# ---------------------------------------------------------------------------

def test_train_cli_data_parallel_matches_one_process_and_resumes_across(corpus, tmp_path):
    """``parallel: {use: true, data: 2}`` through the train CLI, one command
    (it spawns its second rank): two epochs whose histories equal a
    ``parallel.use: false`` run's, one experiment folder with its
    checkpoints, and checkpoints that resume in the other kind of run
    either way round and that the JAX package reads."""
    one = _train(_cli_config(corpus, tmp_path / "one", {"use": False}))
    dp = _train(_cli_config(corpus, tmp_path / "dp", {"use": True, "data": 2}))
    assert not isinstance(dp, type(one)) and dp.epoch == one.epoch == 2
    _assert_history_close(dp, one)
    folders = os.listdir(tmp_path / "dp")
    assert sorted(folders) == sorted([os.path.basename(dp.saving_dir), "milestones",
                                      "train.yml"])
    assert sorted(os.listdir(dp.saving_dir)) == ["ckpts", "config.json", "imgs", "log.json",
                                                 "preds"]
    dp_ckpts = sorted(os.listdir(os.path.join(dp.saving_dir, "ckpts")))
    assert dp_ckpts and dp_ckpts == sorted(os.listdir(os.path.join(one.saving_dir, "ckpts")))

    # the DP checkpoint is the one-process run's, leaf for leaf, and the JAX
    # package's reader takes it
    name = dp_ckpts[-1]
    ours = tckpt.load_checkpoint(os.path.join(dp.saving_dir, "ckpts", name))
    theirs = jckpt.load_checkpoint(os.path.join(dp.saving_dir, "ckpts", name))
    ref = tckpt.load_checkpoint(os.path.join(one.saving_dir, "ckpts", name))
    assert ours["epoch"] == theirs["epoch"] == ref["epoch"]
    ours_l, theirs_l, ref_l = (_leaves(t["params"]) for t in (ours, theirs, ref))
    assert [p for p, _ in ours_l] == [p for p, _ in theirs_l] == [p for p, _ in ref_l]
    n_steps = 2 * len(one.train_history["loss"]) * 3
    for (path, a), (_, b), (_, c) in zip(ours_l, theirs_l, ref_l):
        np.testing.assert_array_equal(a, b, err_msg=path)
        # the attention key bias: rounding noise that Adam scales to steps of
        # the order of lr (tests/test_torch_train_las.py)
        atol = 2 * 2e-3 * n_steps if "key_map" in path and path.endswith("b") else 1e-4
        np.testing.assert_allclose(a, c, atol=atol, err_msg=path)

    # resume: a DP checkpoint in a one-process run, a one-process checkpoint
    # in a DP run; each runs the saved epoch again and the next, from the
    # saved histories
    resumed = {}
    for kind, src, parallel in (("to-one", dp, {"use": False}),
                                ("to-dp", one, {"use": True, "data": 2})):
        ckpt = os.path.join(src.saving_dir, "ckpts", name)
        path = _cli_config(corpus, tmp_path / kind, parallel, epochs=3,
                           finetune={"use": True, "reinit_lr": False, "checkpoint": ckpt})
        resumed[kind] = _train(path)
        assert resumed[kind].epoch == 3
        assert len(resumed[kind].dev_history["loss"]) == len(ref["dev_loss"]) + 3 - ref["epoch"]
    _assert_history_close(resumed["to-one"], resumed["to-dp"])


def _leaves(tree, path=""):
    """(path, array) of every leaf of a params tree, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, t in enumerate(tree) for leaf in _leaves(t, f"{path}/{i}")]
    return [(path, np.asarray(tree))]


def test_only_rank_0_writes(corpus, tmp_path):
    """A DP Trainer on two ranks, each given a folder of its own: rank 0's
    holds the checkpoints, the milestone-free epoch's best and the saved
    state; rank 1's was never made. Their dev histories are one."""
    trn = {"seed": 3, "epochs": 1, "batch_size": 8, "accu_grad": 1, "grad_norm": 5.0,
           "tf_rate": 1.0, "max_savings": 2, "use_specaug": False, "eval_ld_interval": 1,
           "optimizer": {"name": "adamw", "configs": {"lr": 5e-3}}}
    cfg = tlas.LASConfig(
        listener=tlas.ListenerConfig(input_dim=15, uniform_hid_dim=8, lstm_layers=1,
                                     plstm_layers=1, init_dropout=0.0, mid_dropout=0.0,
                                     final_dropout=0.0, lstm_impl="pallas"),
        speller=tlas.SpellerConfig(enc_out_dim=16, att_proj_dim=8, att_heads=1,
                                   dec_vocab_size=30, dec_emb_dim=16, dec_lstm_hid_dim=8,
                                   dec_lstm_out_dim=8, dec_lstm_dropout=0.0,
                                   CHR_MAX_STEPS=24))
    (files0, hist0), (files1, hist1) = tdp.spawn(
        ranks.trainer_files, 2, args=(corpus, str(tmp_path), trn, cfg),
        devices=["cpu", "cpu"], timeout_s=120)
    assert files1 == [] and not os.path.exists(tmp_path / "rank1")
    assert "ckpts/last.ckpt" in files0 and any(f.startswith("ckpts/min") for f in files0)
    assert hist0 == hist1


@pytest.mark.parametrize("parallel,impl,exc,match", [
    # tensor, sequence and pipeline parallelism train on the scan loops
    # (tests/test_torch_tp.py, test_torch_sp.py, test_torch_pipeline.py); a
    # batch their grids cannot split raises the JAX message
    ({"use": True, "model": 2, "data": 3}, "scan", ValueError,
     "batch dim 8 not divisible by data-parallel degree 3"),
    ({"use": True, "sequence": 2, "data": 3}, "scan", ValueError,
     "batch dim 8 not divisible by data-parallel degree 3"),
    ({"use": True, "pipeline": 3}, "scan", ValueError, "batch 8 not divisible by 3 microbatches"),
    ({"use": True, "sequence": 2}, "pallas", ValueError,
     "sequence requires the scan implementations"),
    ({"use": True, "pipeline": 2}, "pallas", ValueError,
     "pipeline requires the scan implementations"),
    ({"use": True, "sequence": 2, "pipeline": 2}, "scan", ValueError,
     "sequence and pipeline are mutually exclusive"),
    ({"use": True, "data": 3}, "scan", ValueError, "batch dim 8 not divisible by "
     "data-parallel degree 3"),
], ids=["tensor-scan", "sequence-scan", "pipeline-scan", "sequence-kernels",
        "pipeline-kernels", "sequence-and-pipeline", "indivisible"])
def test_train_cli_parallel_refusals(corpus, tmp_path, parallel, impl, exc, match):
    """Tensor, sequence and pipeline parallelism: the JAX CLI's ValueErrors
    for the kernel tiers and for sequence with pipeline; a batch the grid's
    rows, the microbatches or the ranks cannot split raises the JAX message
    (from the spawned rank under data parallelism)."""
    path = _cli_config(corpus, tmp_path, parallel, impl=impl, epochs=1)
    with pytest.raises((exc, RuntimeError), match=match) as err:
        _train(path)
    assert isinstance(err.value, exc) or parallel.get("data") == 3


# ---------------------------------------------------------------------------
# lmtrain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accu_grad", [1, 2])
def test_lmtrain_data_parallel_matches_one_process(tmp_path, accu_grad):
    """``lmtrain`` with ``data: 2``: one epoch whose train and dev losses are
    the one-process run's (the Rewriter's integer inputs pass the feature
    cast untouched); with ``accu_grad`` 1 and 2 (``configs/rewriter.yml:13``:
    two batches' gradients an update)."""
    corpus = _lm_corpus(str(tmp_path / "c"), n_train=8, n_dev=4)
    runs = {}
    for name, parallel in (("one", {"use": False}), ("dp", {"use": True, "data": 2})):
        cfg = _lm_config(corpus, str(tmp_path / name), parallel=parallel, epochs=1,
                         accu_grad=accu_grad)
        runs[name] = tlmtrain.main(tlmtrain.build_argparser().parse_args(
            ["-c", cfg, "--device", "cpu"]))
    _assert_history_close(runs["dp"], runs["one"])
    assert os.path.exists(os.path.join(runs["dp"].saving_dir, "log.json"))
    assert LM_MODEL["enc_dropouts"] == [0.0, 0.0]


# ---------------------------------------------------------------------------
# Serving and export
# ---------------------------------------------------------------------------

@pytest.fixture
def two_cpus(monkeypatch):
    """The split's device list as two CPU devices (the CPU counts as one
    device, so ``dp_devices`` itself refuses two)."""
    monkeypatch.setattr(tsplit, "dp_devices", lambda device, n: [torch.device("cpu")] * n)


def test_the_split_copies_the_parameters_once_a_distinct_device(tmp_path):
    """``RowSplit`` never moves the module it is given: the blocks on the
    module's own device share it, and each other device gets one copy of its
    own there (``meta`` stands in for a second card)."""
    params = tlas.las_from_jax_params(tserving.load_experiment(
        _make_experiment(str(tmp_path / "exp")), None, False)[1]["params"])
    before = [p.detach().clone() for p in params.parameters()]
    rs = tsplit.RowSplit(None, params, ["cpu", "meta", "cpu", "meta"])
    assert rs.params[0] is params and rs.params[2] is params
    assert rs.params[1] is rs.params[3] and rs.params[1] is not params
    assert all(p.device.type == "cpu" for p in params.parameters())
    assert all(p.device.type == "meta" for p in rs.params[1].parameters())
    assert all(torch.equal(a, b) for a, b in zip(before, params.parameters()))
    assert tsplit.replicate(params, ["cpu", "cpu"]) == [params, params]


def _features(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(6, 40)), 15)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("beam", [0, 4], ids=["greedy", "beam"])
def test_transcriber_split_over_two_devices(tmp_path, two_cpus, beam):
    """``Transcriber(data_parallel=2)`` over ``[cpu, cpu]``: every batch cut
    into two row blocks, each decoded on its device; the transcripts equal
    ``data_parallel=1``'s, greedy and beam, through the streaming front end
    too."""
    exp = _make_experiment(str(tmp_path / "exp"))
    feats = _features(11)
    one = tserving.Transcriber(exp, batch_size=4, pad_time_multiple=16, beam_size=beam,
                               device="cpu")
    two = tserving.Transcriber(exp, batch_size=4, pad_time_multiple=16, beam_size=beam,
                               data_parallel=2, device="cpu")
    assert two._split is not None and len(two._split.devices) == 2
    assert two.transcribe(feats) == one.transcribe(feats)
    stream = tserving.StreamingTranscriber(two)
    try:
        assert [f.result(timeout=60) for f in [stream.submit(f) for f in feats[:3]]] == \
            one.transcribe(feats[:3])
    finally:
        stream.close()
    with pytest.raises(ValueError, match="batch_size 5 not divisible by data_parallel 2"):
        tserving.Transcriber(exp, batch_size=5, data_parallel=2, device="cpu")


def test_data_parallel_artifact_decodes_over_the_split(tmp_path, monkeypatch):
    """An artifact exported with ``data_parallel=2`` records the split; its
    loader raises the JAX message with one device visible, and over
    ``[cpu, cpu]`` its transcripts equal a ``data_parallel=1`` artifact's,
    through ``ArtifactTranscriber`` and the HTTP tool's ``--data-parallel``
    in experiment mode."""
    from attention_based_e2e_asr_dnn_tpu_torch.tools import serve_http

    exp = _make_experiment(str(tmp_path / "exp"))
    plain = texport.export_from_experiment(exp, str(tmp_path / "a1.tlas"), batch=4, t_pad=48)
    dp = texport.export_from_experiment(exp, str(tmp_path / "a2.tlas"), batch=4, t_pad=48,
                                        data_parallel=2)
    with pytest.raises(ValueError, match="data_parallel=2 but only 1 devices visible"):
        texport.ArtifactTranscriber([dp], device="cpu")
    monkeypatch.setattr(tsplit, "dp_devices", lambda device, n: [torch.device("cpu")] * n)
    feats = _features(7, seed=1)
    a1 = texport.ArtifactTranscriber([plain], device="cpu")
    a2 = texport.ArtifactTranscriber([dp], device="cpu")
    assert a2.buckets[0]._split is not None and a1.buckets[0]._split is None
    assert a2.transcribe(feats) == a1.transcribe(feats)
    args = serve_http.build_argparser().parse_args(
        [exp, "--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--batch-size", "4",
         "--pad-time-multiple", "16", "--data-parallel", "2"])
    t, server = serve_http.start(args)
    try:
        assert t._split is not None
        assert t.transcribe(feats) == tserving.Transcriber(
            exp, batch_size=4, pad_time_multiple=16, device="cpu").transcribe(feats)
    finally:
        server.close()


def test_dp_probe_runs_on_the_cpu():
    """``tools/dp_probe.py`` at toy shapes: both losses finite, the kernels'
    counters reported (the CPU runs their plain versions: no launch)."""
    import json

    out = dp_probe.probe("cpu", batch=2, time_steps=32, labels=8, max_steps=8)
    json.dumps(out)  # the line it prints
    assert out["ok"] and out["backend"] == "gloo"
    assert np.isfinite(out["train_loss"]) and np.isfinite(out["eval_loss"])
    assert set(out["launches"]) == set(dp_probe.PATH_KERNELS)
