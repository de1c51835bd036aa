"""PyTorch port, checkpoints and serving: the .ckpt format across both
packages, reference .pt import, and Transcriber transcripts against the JAX
Transcriber on one experiment folder; the port serving without JAX."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu import compat, constants
from attention_based_e2e_asr_dnn_tpu.models.las import (
    LASConfig,
    ListenerConfig,
    SpellerConfig,
    las_init,
)
from attention_based_e2e_asr_dnn_tpu.serving import Transcriber as JaxTranscriber
from attention_based_e2e_asr_dnn_tpu.training import checkpoints as jckpt
from attention_based_e2e_asr_dnn_tpu_torch import serving as tserving
from attention_based_e2e_asr_dnn_tpu_torch.training import checkpoints as tckpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LISTENER = {"input_dim": 15, "uniform_hid_dim": 16, "lstm_layers": 1,
            "plstm_layers": 1, "bidirectional": True, "init_dropout": 0.0,
            "mid_dropout": 0.0, "final_dropout": 0.0, "lstm_impl": "pallas"}
SPELLER = {"att_proj_dim": 8, "att_heads": 1, "att_dropout": 0.0,
           "dec_emb_dim": 16, "dec_emb_dropout": 0.0, "dec_lstm_hid_dim": 16,
           "dec_lstm_out_dim": 8, "dec_lstm_dropout": 0.0, "CHR_MAX_STEPS": 12,
           "CHR_PAD_IDX": constants.PAD_IDX, "CHR_SOS_IDX": constants.SOS_IDX,
           "USE_GREEDY": True}
CFG = LASConfig(listener=ListenerConfig(**LISTENER),
                speller=SpellerConfig(enc_out_dim=32, **SPELLER))


def _params(seed):
    params = jax.tree.map(np.asarray, las_init(jax.random.PRNGKey(seed), CFG))
    rng = np.random.default_rng(seed)
    for key in ("init_h1", "init_c1", "init_h2", "init_c2"):
        params["speller"][key] = rng.uniform(-0.5, 0.5, params["speller"][key].shape
                                             ).astype(np.float32)
    return params


def _make_experiment(root, epochs=(1,)):
    os.makedirs(os.path.join(root, "ckpts"))
    snap = {"compute_dtype": "float32", "VOCAB": list(constants.VOCAB),
            "SOS_IDX": constants.SOS_IDX, "EOS_IDX": constants.EOS_IDX,
            "model": {"configs": {"listener_configs": LISTENER,
                                  "speller_configs": SPELLER}}}
    with open(os.path.join(root, "config.json"), "w") as fh:
        json.dump(snap, fh)
    for e in epochs:
        jckpt.save_checkpoint(os.path.join(root, "ckpts", f"min-loss-epoch[{e}].ckpt"),
                              {"params": _params(e), "epoch": e})
    return root


def _assert_trees_equal(a, b):
    flat_a, tree_a = jax.tree.flatten(a)
    flat_b, tree_b = jax.tree.flatten(b)
    assert tree_a == tree_b
    for x, y in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_ckpt_written_by_jax_loads_in_port_and_back(tmp_path):
    params = _params(0)
    opt = [np.arange(3, dtype=np.float32), np.float32(2.0)]
    path = jckpt.save_checkpoint(str(tmp_path / "a.ckpt"),
                                 {"params": params, "opt_state": opt, "epoch": 4})
    ours = tckpt.load_checkpoint(path)
    _assert_trees_equal(ours["params"], params)
    assert ours["epoch"] == 4
    _assert_trees_equal(ours["opt_state"], opt)

    back = tckpt.save_checkpoint(str(tmp_path / "b.ckpt"), ours)
    theirs = jckpt.load_checkpoint(back)
    _assert_trees_equal(theirs["params"], params)
    _assert_trees_equal(theirs["opt_state"], opt)
    assert theirs["epoch"] == 4


def test_reference_pt_loads_like_jax(tmp_path):
    # the reference format has no slot for learned initial states: keep them 0
    params = jax.tree.map(np.asarray, las_init(jax.random.PRNGKey(1), CFG))
    sd = compat.state_dict_from_las_params(params)
    path = str(tmp_path / "min-loss-epoch[3].pt")
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                "epoch": 3}, path)
    ours, theirs = tckpt.load_checkpoint(path), jckpt.load_checkpoint(path)
    _assert_trees_equal(ours["params"], theirs["params"])
    assert ours["epoch"] == theirs["epoch"] == 3


def test_best_listing_and_average_match_jax(tmp_path):
    exp = _make_experiment(str(tmp_path / "exp"), epochs=(1, 2, 10))
    ckpts = os.path.join(exp, "ckpts")
    open(os.path.join(ckpts, "emergency-epoch[11].ckpt"), "w").close()
    assert tckpt.list_best_checkpoints(ckpts) == jckpt.list_best_checkpoints(ckpts)
    paths = [os.path.join(ckpts, f) for f in tckpt.list_best_checkpoints(ckpts)]
    _assert_trees_equal(tckpt.average_checkpoints(paths)["params"],
                        jckpt.average_checkpoints(paths)["params"])
    # the latest best checkpoint by epoch number (10, not 2)
    _, payload = tserving.load_experiment(exp)
    assert payload["epoch"] == 10


def _utterances(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(t), 15)).astype(np.float32)
            for t in rng.integers(5, 40, n)]


def test_transcriber_matches_jax_transcriber(tmp_path):
    exp = _make_experiment(str(tmp_path / "exp"))
    feats = _utterances()
    ref = JaxTranscriber(exp, batch_size=4, pad_time_multiple=16).transcribe(feats)
    port = tserving.Transcriber(exp, batch_size=4, pad_time_multiple=16, device="cpu")
    assert port.transcribe(feats) == ref

    stream = tserving.StreamingTranscriber(port, max_wait_ms=200.0)
    try:
        futs = [stream.submit(f) for f in feats[:3]]
        assert [f.result(timeout=60) for f in futs] == port.transcribe(feats[:3])
    finally:
        stream.close()
    with pytest.raises(RuntimeError, match="closed"):
        stream.submit(feats[0])


@pytest.mark.parametrize("kwargs", [{"data_parallel": 2}])
def test_transcriber_rejects_unported_options(tmp_path, kwargs):
    """``data_parallel`` is ported (tests/test_torch_dp_cli.py holds the
    split): it raises the JAX messages where the CPU, one device, cannot
    hold two blocks and where the batch does not divide."""
    exp = _make_experiment(str(tmp_path / "exp"))
    with pytest.raises(ValueError, match="data_parallel=2 but only 1 devices visible"):
        tserving.Transcriber(exp, device="cpu", batch_size=4, **kwargs)
    with pytest.raises(ValueError, match="batch_size 5 not divisible by data_parallel 2"):
        tserving.Transcriber(exp, device="cpu", batch_size=5, **kwargs)


def test_port_serves_without_jax(tmp_path):
    """The port imports, writes an experiment and transcribes with no JAX
    module loaded."""
    script = textwrap.dedent(f"""
        import json, os, sys
        import numpy as np, torch
        from attention_based_e2e_asr_dnn_tpu_torch import EOS_IDX, SOS_IDX, VOCAB
        from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
            las_config_from_dicts, las_init, las_to_jax_params)
        from attention_based_e2e_asr_dnn_tpu_torch.serving import Transcriber
        from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import save_checkpoint
        torch.set_num_threads(1)
        lis, spl = {LISTENER!r}, {SPELLER!r}
        cfg = las_config_from_dicts(lis, spl)
        root = {str(tmp_path / "exp")!r}
        os.makedirs(os.path.join(root, "ckpts"))
        with open(os.path.join(root, "config.json"), "w") as fh:
            json.dump({{"VOCAB": VOCAB, "SOS_IDX": SOS_IDX, "EOS_IDX": EOS_IDX,
                       "model": {{"configs": {{"listener_configs": lis,
                                              "speller_configs": spl}}}}}}, fh)
        params = las_to_jax_params(las_init(cfg, torch.Generator().manual_seed(0)))
        save_checkpoint(os.path.join(root, "ckpts", "min-ld-epoch[0].ckpt"),
                        {{"params": params}})
        texts = Transcriber(root, batch_size=2, pad_time_multiple=16,
                            device="cpu").transcribe([np.ones((20, 15), np.float32)] * 3)
        assert len(texts) == 3 and all(isinstance(s, str) for s in texts)
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_auto_warmup_ladder_ready_and_warm(tmp_path):
    """The JAX Transcriber's warm-up surface: the background ladder warms
    the largest bucket first, ``wait_ready`` returns once that one is warm,
    ``wait_warm`` joins the ladder, and transcripts are unchanged by it."""
    exp = _make_experiment(str(tmp_path / "exp"))
    feats = _utterances()
    plain = tserving.Transcriber(exp, batch_size=4, pad_time_multiple=16, device="cpu")
    assert plain.wait_ready(timeout=0.0) is True      # no ladder: ready at once
    plain.wait_warm()
    assert plain.corrector is None and plain.length_alpha == 0.0
    t = tserving.Transcriber(exp, batch_size=4, pad_time_multiple=16, device="cpu",
                             auto_warmup=(20, 40, 33), length_alpha=0.6)
    assert t._ready_bucket == 48 and t.length_alpha == 0.6
    assert t.wait_ready(timeout=120) is True
    assert 48 in t._warm
    t.wait_warm(timeout=120)
    assert not t._warmup_thread.is_alive()
    assert t._warm == {32, 48}                        # 20 -> 32, 33 and 40 -> 48
    assert t.transcribe(feats) == plain.transcribe(feats)
    assert t._fg_count == 0
    # a bucket that is warm is not run again
    calls = []
    t._decode = lambda x, lx: calls.append(x.shape) or np.zeros((4, 1), np.int32)
    t.warmup((40, 60))
    assert calls == [(4, 64, 15)]


def test_route_bucket_is_always_the_tight_one(tmp_path):
    """Unlike the JAX Transcriber, which pads a batch up to a warm bucket to
    avoid a compile: PyTorch compiles no shape, so routing up would only add
    padded frames."""
    exp = _make_experiment(str(tmp_path / "exp"))
    t = tserving.Transcriber(exp, batch_size=4, pad_time_multiple=16, device="cpu")
    t.warmup((64,))
    assert t._warm == {64}
    assert [t._route_bucket(n) for n in (1, 16, 17, 40, 64, 65)] == [16, 16, 32, 48, 64, 80]
    t.transcribe(_utterances(3))                      # 5..39 frames: tight buckets
    assert t._warm - {64} and max(t._warm - {64}) <= 48


def test_failed_warmup_resurfaces_in_wait_ready(tmp_path, monkeypatch):
    exp = _make_experiment(str(tmp_path / "exp"))

    def boom(self, x, lx):
        raise ValueError("no kernel for this shape")

    monkeypatch.setattr(tserving.Transcriber, "_decode", boom)
    t = tserving.Transcriber(exp, batch_size=4, pad_time_multiple=16, device="cpu",
                             auto_warmup=(32,))
    with pytest.raises(RuntimeError, match="auto-warmup failed") as err:
        t.wait_ready(timeout=60)
    assert isinstance(err.value.__cause__, ValueError)
    t.wait_warm(timeout=60)
    assert not t._warmup_thread.is_alive() and t._warm == set()


def test_warmup_yields_to_requests_in_flight(tmp_path):
    """Once ready, the background ladder waits between buckets while a
    request is in flight."""
    import threading

    exp = _make_experiment(str(tmp_path / "exp"))
    t = tserving.Transcriber(exp, batch_size=4, pad_time_multiple=16, device="cpu")
    t._ready_evt.set()
    with t._fg_cv:
        t._fg_count = 1                               # a request in flight
    th = threading.Thread(target=t.warmup, args=((16,),),
                          kwargs={"yield_to_foreground": True}, daemon=True)
    th.start()
    th.join(timeout=0.5)
    assert th.is_alive() and t._warm == set()
    with t._fg_cv:
        t._fg_count = 0
        t._fg_cv.notify_all()
    th.join(timeout=60)
    assert not th.is_alive() and t._warm == {16}


def test_transcriber_builds_kernels_only_on_a_card(tmp_path, monkeypatch):
    """``build_for``: nothing on the CPU, nothing without a kernel tier,
    ``build_all`` on a card with one; and ``cuda`` without a card raises."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build

    built = []
    monkeypatch.setattr(cuda_build, "build_all", lambda: built.append(1))
    cuda_build.build_for("cpu", "pallas", "pallas")
    cuda_build.build_for("cuda", "scan", None)
    assert built == []
    cuda_build.build_for("cuda:0", "scan", "pallas")
    assert built == [1]
    exp = _make_experiment(str(tmp_path / "exp"))
    tserving.Transcriber(exp, device="cpu")
    assert built == [1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserving.Transcriber(exp, device="cuda")
