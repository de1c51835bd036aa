"""PyTorch port, the repository's tools in the port, on the CPU at toy
widths: ``dev.py`` held to the JAX package's; ``tools/import_reference_ckpt``
against the repository's tool both ways on the same files;
``tools/export_serving`` with ``--check`` (greedy, beam, int8, the
Rewriter) and its refusals; ``tools/serving_bench``'s record; every tool
that runs a model refusing ``--device cuda`` without a card."""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu import dev as jdev
from attention_based_e2e_asr_dnn_tpu import compat as jcompat
from attention_based_e2e_asr_dnn_tpu.training import checkpoints as jckpt
from attention_based_e2e_asr_dnn_tpu_torch import compat, dev
from attention_based_e2e_asr_dnn_tpu_torch import export as texport
from attention_based_e2e_asr_dnn_tpu_torch import serving as tserving
from attention_based_e2e_asr_dnn_tpu_torch.tools import (
    best_effort_eval,
    bench,
    chain_refit,
    export_serving,
    full_recipe_run,
    import_reference_ckpt,
    profile_step,
    serving_bench,
)
from attention_based_e2e_asr_dnn_tpu_torch.training import checkpoints as tckpt

from test_torch_infer import toy  # noqa: F401  (the fixture)
from test_torch_lminfer import make_lm_experiment

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, T_PAD = 4, 32


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _features(n, seed=3, longest=T_PAD):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(5, longest + 1)), 15)).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def lm_exp(tmp_path_factory):
    return make_lm_experiment(str(tmp_path_factory.mktemp("lm") / "exp"))


# ---------------------------------------------------------------------------
# dev.py
# ---------------------------------------------------------------------------

def _data_tree(root):
    rng = np.random.default_rng(0)
    for split, n in (("train-clean-100", 12), ("dev-clean", 6), ("test-clean", 3)):
        for tag in ("mfcc", "transcript/raw"):
            os.makedirs(os.path.join(root, split, tag))
        for i in range(n):
            name = f"spk_{i:03d}.npy"
            np.save(os.path.join(root, split, "mfcc", name),
                    rng.standard_normal((5 + i, 15)).astype(np.float32))
            np.save(os.path.join(root, split, "transcript/raw", name.replace("_", "-")),
                    np.array(["<sos>", "A", str(i % 10), "<eos>"]))


def _listing(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("ratio,seed", [(0.05, 0), (0.5, 3)])
def test_dev_copy_matches_the_original(tmp_path, ratio, seed):
    data = str(tmp_path / "data")
    _data_tree(data)
    for name, mod in (("jax", jdev), ("port", dev)):
        mod.extract_mini(data, str(tmp_path / f"small-{name}"), ratio=ratio, seed=seed)
    ours, ref = _listing(tmp_path / "small-port"), _listing(tmp_path / "small-jax")
    assert ours == ref and len(ours) > 0
    for name, mod in (("jax", jdev), ("port", dev)):
        copy = str(tmp_path / f"data-{name}")
        shutil.copytree(data, copy)
        mod.uniform_filenames(copy)
    assert _listing(tmp_path / "data-port") == _listing(tmp_path / "data-jax")
    assert not any("_" in f for f in os.listdir(tmp_path / "data-port/train-clean-100/mfcc"))


def test_dev_cli(tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    _data_tree(data)
    monkeypatch.setattr("sys.argv", ["dev", "extract-mini", "--root-dir", data,
                                     "--out-dir", str(tmp_path / "small"), "--ratio", "0.5"])
    dev.main()
    assert len(os.listdir(tmp_path / "small" / "train-clean-100" / "mfcc")) == 6


# ---------------------------------------------------------------------------
# import_reference_ckpt
# ---------------------------------------------------------------------------

def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def _ckpt_of(folder):
    ckpts = tckpt.list_best_checkpoints(os.path.join(folder, "ckpts"))
    return os.path.join(folder, "ckpts", ckpts[-1])


@pytest.mark.parametrize("model", ["las", "rewriter"])
def test_import_reference_ckpt_is_the_jax_tools(toy, lm_exp, tmp_path, model):  # noqa: F811
    """Export a checkpoint to a reference ``.pt`` with each tool: the same
    state_dict; import that ``.pt`` with each: the same params and
    metadata, loadable by either package."""
    ref = _root_tool("import_reference_ckpt")
    ckpt = _ckpt_of(toy[2] if model == "las" else lm_exp)
    pts = {}
    for name, tool in (("jax", ref), ("port", import_reference_ckpt)):
        pts[name] = str(tmp_path / f"{name}.pt")
        with pytest.warns(UserWarning, match="non-zero"):  # the learned initial states
            assert tool.main([model, ckpt, "-o", pts[name], "--export"]) == 0
    sds = {name: torch.load(p, weights_only=True)["model_state_dict"] for name, p in pts.items()}
    assert sds["port"].keys() == sds["jax"].keys()
    for k in sds["jax"]:
        assert torch.equal(sds["port"][k], sds["jax"][k]), k
    ckpts = {}
    for name, tool in (("jax", ref), ("port", import_reference_ckpt)):
        ckpts[name] = str(tmp_path / f"{name}.ckpt")
        assert tool.main([model, pts["jax"], "-o", ckpts[name]]) == 0
    ours, theirs = tckpt.load_checkpoint(ckpts["port"]), jckpt.load_checkpoint(ckpts["jax"])
    _assert_trees_equal(ours["params"], theirs["params"])
    assert {k: v for k, v in ours.items() if k not in ("params", "source")} == \
        {k: v for k, v in theirs.items() if k not in ("params", "source")}
    assert ours["source"] == theirs["source"] == f"reference:{pts['jax']}"
    # the import of the export is the checkpoint, but for the dropped initial states
    original = tckpt.load_checkpoint(ckpt)["params"]
    dec = "speller" if model == "las" else "decoder"
    for key in ("init_h1", "init_c1", "init_h2", "init_c2"):
        original[dec][key] = np.zeros_like(original[dec][key])
    _assert_trees_equal(ours["params"], original)
    _assert_trees_equal(jckpt.load_checkpoint(ckpts["port"])["params"], theirs["params"])


def test_state_dict_export_matches_jax(toy):  # noqa: F811
    params = tckpt.load_checkpoint(_ckpt_of(toy[2]))["params"]
    with pytest.warns(UserWarning):
        ours = compat.state_dict_from_las_params(params)
    with pytest.warns(UserWarning):
        theirs = jcompat.state_dict_from_las_params(params)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


# ---------------------------------------------------------------------------
# export_serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--beam-size", "3"], ["--quantize", "int8"]],
                         ids=["greedy", "beam", "int8"])
def test_export_serving_check_las(toy, tmp_path, capsys, extra):  # noqa: F811
    _, _, exp = toy
    out = str(tmp_path / "las.tlas")
    rc = export_serving.main([exp, "-o", out, "--batch", str(BATCH), "--t-pad", str(T_PAD),
                              "--check", "--device", "cpu", *extra])
    assert rc == 0 and "check: artifact ids match" in capsys.readouterr().out
    beam = int(extra[1]) if extra and extra[0] == "--beam-size" else 0
    feats = _features(7, seed=4)
    ours = texport.ArtifactTranscriber([out], device="cpu").transcribe(feats)
    if extra[:1] != ["--quantize"]:
        direct = tserving.Transcriber(exp, batch_size=BATCH, pad_time_multiple=T_PAD,
                                      beam_size=beam, device="cpu")
        assert ours == direct.transcribe(feats)
    assert texport.load_artifact(out)[0]["quantize"] == ("int8" if "--quantize" in extra
                                                         else "none")


@pytest.mark.parametrize("extra", [[], ["--quantize", "int8"]], ids=["gate", "int8"])
def test_export_serving_check_rewriter(lm_exp, tmp_path, capsys, extra):
    out = str(tmp_path / "corr.tlas")
    rc = export_serving.main([lm_exp, "-o", out, "--model", "rewriter", "--batch", "4",
                              "--t-pad", "32", "--check", "--device", "cpu", *extra])
    assert rc == 0 and "check: artifact corrections match" in capsys.readouterr().out


def test_export_serving_refusals(toy, tmp_path):  # noqa: F811
    _, _, exp = toy
    out = str(tmp_path / "x.tlas")
    # --data-parallel is ported: the split is recorded in the artifact, whose
    # loader needs that many devices (tests/test_torch_dp_cli.py decodes one)
    dp_out = str(tmp_path / "dp.tlas")
    assert export_serving.main([exp, "-o", dp_out, "--data-parallel", "2",
                                "--device", "cpu"]) == 0
    from attention_based_e2e_asr_dnn_tpu_torch.export import load_artifact

    assert load_artifact(dp_out)[0]["data_parallel"] == 2
    for argv in (["--platforms", "cpu"], ["--span-rewrite"], ["--span-conf-tau", "0.3"]):
        with pytest.raises(SystemExit):
            export_serving.main([exp, "-o", out, "--device", "cpu", *argv])
    assert not os.path.exists(out)


# ---------------------------------------------------------------------------
# serving_bench
# ---------------------------------------------------------------------------

def test_serving_bench_record(toy, capsys):  # noqa: F811
    _, _, exp = toy
    ref_keys = {"ready_s", "cold_utt_s", "warm_utt_s", "cold_warm_accuracy_match",
                "p50_ms", "p99_ms", "n"}
    stream = serving_bench.make_stream(5, 15)
    assert [f.shape[0] for f in stream] == [
        f.shape[0] for f in _root_tool("serving_bench").make_stream(5, 15)]
    rec = serving_bench.run(exp, n=5, batch_size=4, pad_time_multiple=768, device="cpu",
                            stream=[f[:40] for f in stream])
    assert set(rec) == ref_keys | {"card", "power_limit_w"}
    assert rec["cold_warm_accuracy_match"] == 1.0 and rec["n"] == 5
    assert (rec["card"], rec["power_limit_w"]) == ("cpu", None)
    assert all(np.isfinite(rec[k]) and rec[k] > 0 for k in ref_keys - {"n"})


# ---------------------------------------------------------------------------
# no card
# ---------------------------------------------------------------------------

def test_every_tool_refuses_cuda_without_a_card(toy, tmp_path, monkeypatch):  # noqa: F811
    root, data, exp = toy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: bench.main([]),
        lambda: profile_step.main([]),
        lambda: export_serving.main([exp, "-o", str(tmp_path / "x.tlas")]),
        lambda: serving_bench.main(["--exp", exp]),
        lambda: full_recipe_run.main(["--data-dir", root]),
        lambda: chain_refit.main(["--data-dir", root, "--run-dir", exp]),
        lambda: best_effort_eval.main(["--data-dir", root, "--run-dir", exp]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.path.exists(tmp_path / "x.tlas")
