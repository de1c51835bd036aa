"""PyTorch port, the Trainer's ``profile`` block (``utils/profiling.py``) on
the CPU at toy widths: one Chrome trace under ``<saving_dir>/profile`` in
epoch ``profile.epoch`` only, over ``profile.batches`` steps (or the
epoch's, if it has fewer), one ``las.train_step`` span a step, the
prefetcher's thread in it; the same losses
and parameters as an epoch without it; the profiler stopped when a step
raises; nothing written with ``profile.use: false``; on a card, a trace
without a device event raises; the ``train`` CLI with the block on."""

import json
import os

import pytest
import torch

from attention_based_e2e_asr_dnn_tpu_torch import train as ttrain
from attention_based_e2e_asr_dnn_tpu_torch.utils import profiling

from attention_based_e2e_asr_dnn_tpu_torch import constants
from attention_based_e2e_asr_dnn_tpu_torch.config import Config
from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher
from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import AsrTrainDevDataset
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.tools import make_synthetic_data
from attention_based_e2e_asr_dnn_tpu_torch.training.trainer import Trainer

from test_torch_trainer import TRN, T_TINY, _cli_config, _tiny_params, corpus  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def short(tmp_path_factory):
    """One-word utterances: a profiled CPU step records every operator of
    the plain loops, so the shorter the batch, the faster the trace."""
    root = tmp_path_factory.mktemp("short")
    make_synthetic_data.generate(str(root), n_train=24, n_dev=8, n_test=8, words_min=1,
                                 words_max=1, seed=1)
    return str(root)


def _port_trainer(root, folder, extra=None):
    """test_torch_trainer's port Trainer over batches padded to 32 frames and
    8 labels: three train batches of 8."""
    sets = [AsrTrainDevDataset(std_dir=os.path.join(root, split),
                               label_to_idx=constants.VOCAB_MAP, keep_tags=True)
            for split in ("train-clean-100", "dev-clean")]
    trn = BucketBatcher(sets[0], 8, 32, 8, label_pad_id=29, shuffle=True, seed=3)
    dev = BucketBatcher(sets[1], 8, 32, 8, label_pad_id=29)
    return Trainer(init_fn=lambda generator: tlas.las_from_jax_params(_tiny_params()),
                   make_apply=ttrain.make_las_apply_factory(T_TINY), trn_batcher=trn,
                   dev_batcher=dev, trncfgs=Config({**TRN, **(extra or {})}),
                   saving_dir=str(folder), sos_idx=0, eos_idx=29, device="cpu")

STEP_OP = "aten::isfinite"  # once a train step: the NaN guard's test of the norm


def _events(path):
    with open(path) as fh:
        trace = json.load(fh)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _steps(events):
    return sum(1 for e in events if e.get("name") == STEP_OP and e.get("ph") == "X")


@pytest.mark.parametrize("batches,want", [(1, 1), (5, 3)], ids=["stops-at-count",
                                                                  "epoch-shorter"])
def test_profile_traces_its_epoch_only(short, tmp_path, capsys, batches, want):
    """Epochs 0 and 1 of three batches each, the block in epoch 1: one
    trace, of ``want`` steps."""
    trainer = _port_trainer(short, tmp_path, {"profile": {
        "use": True, "epoch": 1, "batches": batches}})
    for epoch in (0, 1):
        trainer.epoch = epoch
        trainer.train_epoch()
    folder = tmp_path / "profile"
    assert sorted(os.listdir(folder)) == ["trace-epoch1.json"]
    events = _events(folder / "trace-epoch1.json")
    assert _steps(events) == want
    # the step's own span, once a traced step (its device mirror aside)
    assert sum(1 for e in events if e.get("name") == "las.train_step" and e.get("ph") == "X"
               and e.get("cat") == "user_annotation") == want
    assert capsys.readouterr().out.count(f"[profile] trace written to {tmp_path}/profile") == 1
    # the prefetcher's thread, as events of its own, beside the main thread's
    host = [e for e in events if e.get("cat") == "host_prefetch"]
    main_tids = {e["tid"] for e in events if e.get("name") == profiling.WINDOW}
    assert host and {e["tid"] for e in host}.isdisjoint(main_tids)
    assert any(e.get("name") == "thread_name" and e["args"]["name"] == "ThreadedPrefetcher"
               for e in events)
    assert not torch.autograd._profiler_enabled()


def test_profile_changes_no_number(short, tmp_path):
    runs = {}
    for name, extra in (("plain", {}), ("profiled", {"profile": {"use": True, "batches": 1}})):
        trainer = _port_trainer(short, tmp_path / name, extra)
        runs[name] = (trainer, [trainer.train_epoch()[:2]])
        trainer.epoch = 1
        runs[name][1].append(trainer.train_epoch()[:2])
    (a, losses_a), (b, losses_b) = runs["plain"], runs["profiled"]
    assert os.path.exists(tmp_path / "profiled" / "profile" / "trace-epoch0.json")
    assert losses_a == losses_b
    for p, q in zip(a.state.params.parameters(), b.state.params.parameters()):
        assert torch.equal(p, q)


def test_profiler_stops_when_the_step_raises(short, tmp_path):
    trainer = _port_trainer(short, tmp_path, {"profile": {"use": True, "batches": 2}})
    calls = []
    step = trainer.train_step

    def second_fails(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device lost")
        return step(*args, **kwargs)

    trainer.train_step = second_fails
    with pytest.raises(RuntimeError, match="device lost"):
        trainer.train_epoch()
    assert not torch.autograd._profiler_enabled()
    assert not os.path.exists(tmp_path / "profile")
    # the next profile starts cleanly
    trainer.train_step = step
    trainer.train_epoch()
    assert _steps(_events(tmp_path / "profile" / "trace-epoch0.json")) == 2


def test_profile_off_writes_nothing(short, tmp_path):
    trainer = _port_trainer(short, tmp_path, {"profile": {
        "use": False, "epoch": 0, "batches": 2}})
    trainer.train_epoch()
    assert not os.path.exists(tmp_path / "profile")
    assert profiling.epoch_profiler(None, 0, str(tmp_path), torch.device("cpu")) is None


def test_a_card_trace_without_device_events_raises(tmp_path, monkeypatch):
    """The check the card's trace passes: here the CPU build records no
    kernel, so a profiler told it runs on a card must refuse the trace."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    prof = profiling.EpochProfiler(str(tmp_path), torch.device("cuda"), 1, 0)
    torch.ones(3).sum()
    with pytest.raises(RuntimeError, match="holds no device event"):
        prof.stop()
    assert prof.stop() is None  # stopped once, for good


def test_only_the_windows_host_spans_enter_the_trace(tmp_path):
    """Spans that end before the window opens or start after it closes are
    dropped, and a span reported once the profiler has stopped is not kept."""
    import time

    before = time.perf_counter_ns()
    prof = profiling.EpochProfiler(str(tmp_path), torch.device("cpu"), 1, 0)
    tid, now = 7, time.perf_counter_ns()
    prof.host_span(tid, before - 2_000_000, before - 1_000_000)  # ended before
    prof.host_span(tid, before - 1_000, now + 1_000)  # overlaps the start
    prof.host_span(tid, now + 2_000, now + 3_000)  # inside
    prof.host_span(tid, now + 60 * 10**9, now + 61 * 10**9)  # starts after the end
    torch.ones(3).sum()
    path = prof.stop()
    prof.host_span(tid, now, now + 1)
    assert len(prof._spans) == 4
    events = _events(path)
    (window,) = [e for e in events if e.get("name") == profiling.WINDOW]
    host = [e for e in events if e.get("cat") == "host_prefetch"]
    assert [e["dur"] for e in host] == pytest.approx([(now - before + 2_000) / 1e3, 1.0])
    assert all(e["ts"] < window["ts"] + window["dur"] for e in host)


def test_train_cli_with_the_profile_block(corpus, tmp_path):  # noqa: F811
    path = _cli_config(corpus, tmp_path, profile={"use": True, "epoch": 1, "batches": 1})
    trainer = ttrain.main(ttrain.build_argparser().parse_args(["-c", path, "--device", "cpu"]))
    traces = os.listdir(os.path.join(trainer.saving_dir, "profile"))
    assert traces == ["trace-epoch1.json"]
    events = _events(os.path.join(trainer.saving_dir, "profile", traces[0]))
    assert _steps(events) == 1
    assert len(trainer.train_history["loss"]) == 2
