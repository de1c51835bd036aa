"""PyTorch port, the recipe and chain tools on the CPU at toy widths:
``tools/full_recipe_run``'s configs and ``dev_ld_of_csv`` against the
repository's (a CSV with an empty label and one of ``007``, which the
port reads without pandas); ``tools/chain_refit`` and
``tools/best_effort_eval`` over a generated corpus and a toy LAS run with a
milestone, one epoch of a toy Rewriter, writing the JAX tools' records; and
the repository's two tools driven over what the port's stages produced,
which must ask for the same configs and exports and write the same
records."""

import csv
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from attention_based_e2e_asr_dnn_tpu_torch import constants
from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    las_config_from_dicts,
    las_init,
    las_to_jax_params,
)
from attention_based_e2e_asr_dnn_tpu_torch.tools import (
    best_effort_eval,
    chain_refit,
    full_recipe_run,
    make_synthetic_data,
)
from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import save_checkpoint

from test_torch_infer import LISTENER, SPELLER
from test_torch_lminfer import LM_MODEL, make_lm_experiment

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_recipe():
    return _load_root_tool("full_recipe_run")


@pytest.mark.parametrize("labels", [
    ["A CAT", "", "007", "THE DOG"],
    ["007", "", "", "X"],
    ["IT'S", "A, B", "\"Q\"", "RAN ON"],
], ids=["empty-and-007", "mostly-empty", "quoted"])
def test_dev_ld_of_csv_is_the_jax_tools(tmp_path, labels):
    trans = tmp_path / "raw"
    trans.mkdir()
    golds = ["A CAT", "B", "OO7", "THE DOGS"]
    for i, gold in enumerate(golds):
        np.save(trans / f"utt{i:03d}.npy", np.array(["<sos>", *gold, "<eos>"]))
    pred = tmp_path / "pred.csv"
    with open(pred, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["id", "label"])
        writer.writerows(enumerate(labels))
    ours = full_recipe_run.dev_ld_of_csv(str(pred), str(trans))
    assert ours == _root_recipe().dev_ld_of_csv(str(pred), str(trans))
    with open(pred, "a") as fh:
        fh.write("4,EXTRA\n")
    with pytest.raises(ValueError, match="5 predictions for 4 transcripts"):
        full_recipe_run.dev_ld_of_csv(str(pred), str(trans))


@pytest.mark.parametrize("epochs,batch,decoder,steps,force", [
    (40, 32, "scan", 120, False), (12, 8, "pallas", 64, True), (3, 16, "scan", 20, False)])
def test_recipe_configs_are_the_jax_tools(tmp_path, epochs, batch, decoder, steps, force):
    ref = _root_recipe()
    args = (str(tmp_path / "data"), str(tmp_path / "exp"))
    assert full_recipe_run.las_recipe_config(*args, epochs, batch, decoder, steps, force) == \
        ref.las_recipe_config(*args, epochs, batch, decoder, steps, force)
    lm = (*args, "trn.csv", "dev.csv", epochs)
    assert full_recipe_run.rewriter_config(*lm) == ref.rewriter_config(*lm)


# ---------------------------------------------------------------------------
# chain_refit and best_effort_eval, end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A generated corpus, a toy LAS run under ``<root>/las/<run>`` with two
    best checkpoints and the milestone ``epoch[0]`` in ``<root>/las/milestones``."""
    root = str(tmp_path_factory.mktemp("recipe"))
    data = os.path.join(root, "data")
    make_synthetic_data.generate(data, n_train=8, n_dev=4, n_test=4, words_min=1,
                                 words_max=2, seed=2)
    run_dir = os.path.join(root, "las", "run")
    os.makedirs(os.path.join(run_dir, "ckpts"))
    os.makedirs(os.path.join(root, "las", "milestones"))
    snap = {"compute_dtype": "float32", "VOCAB": list(constants.VOCAB),
            "SOS_IDX": constants.SOS_IDX, "EOS_IDX": constants.EOS_IDX,
            "TRN_FOLDER": os.path.join(data, "train-clean-100"),
            "model": {"configs": {"listener_configs": LISTENER,
                                  "speller_configs": {**SPELLER, "CHR_MAX_STEPS": 16}}}}
    with open(os.path.join(run_dir, "config.json"), "w") as fh:
        json.dump(snap, fh)
    cfg = las_config_from_dicts(LISTENER, SPELLER)
    for epoch in (0, 1):
        params = las_to_jax_params(las_init(cfg, torch.Generator().manual_seed(epoch)))
        save_checkpoint(os.path.join(run_dir, "ckpts", f"min-loss-epoch[{epoch}].ckpt"),
                        {"params": params, "epoch": epoch})
    shutil.copyfile(os.path.join(run_dir, "ckpts", "min-loss-epoch[0].ckpt"),
                    os.path.join(root, "las", "milestones", "epoch[0].ckpt"))
    return {"root": root, "data": data, "run_dir": run_dir}


def _toy_rewriter_config(*args, recipe=full_recipe_run):
    """The tool's Rewriter recipe at toy widths, float32, one batch."""
    cfg = recipe.rewriter_config(*args)
    cfg["model"]["configs"] = dict(LM_MODEL)
    cfg.update(compute_dtype="float32", batch_size=8)
    return cfg


def _load_root_tool(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _yaml(path):
    with open(path) as fh:
        return yaml.safe_load(fh)


def _moved(obj, old, new):
    """``obj`` with the path prefix ``old`` replaced by ``new`` in its strings."""
    if isinstance(obj, dict):
        return {k: _moved(v, old, new) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_moved(v, old, new) for v in obj]
    return obj.replace(old, new) if isinstance(obj, str) else obj


CHAIN_ARGS = ["--lm-epochs", "1", "--batch-size", "8", "--lm-max-steps", "24", "--lm-beam", "2"]


@pytest.fixture(scope="module")
def chain(run, tmp_path_factory):
    """The port's ``chain_refit`` over milestones 0 and 5 (5 has none), with
    every prediction CSV it scores recorded as it was when scored."""
    work = str(tmp_path_factory.mktemp("chain") / "work")
    out = os.path.join(os.path.dirname(work), "chain.json")
    scored = []
    real = chain_refit.dev_ld_of_csv

    def recording(pred, trans):
        with open(pred) as fh:
            scored.append((pred, trans, fh.read()))
        return real(pred, trans)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chain_refit, "rewriter_config", _toy_rewriter_config)
        mp.setattr(chain_refit, "dev_ld_of_csv", recording)
        result = chain_refit.main([
            "--data-dir", run["data"], "--run-dir", run["run_dir"], "--milestones", "0", "5",
            *CHAIN_ARGS, "--work-dir", work, "--out", out, "--device", "cpu"])
    return {"result": result, "out": out, "work": work, "scored": scored}


def test_chain_refit_writes_the_jax_record(run, chain, monkeypatch):
    monkeypatch.setattr(chain_refit, "rewriter_config", _toy_rewriter_config)
    result = chain["result"]
    with open(chain["out"]) as fh:
        assert json.load(fh) == json.loads(json.dumps(result))
    assert set(result) == {"run_dir", "lm_epochs", "lm_beam", "milestones", "work_dir"}
    (row,) = result["milestones"]  # epoch[5] has no milestone: skipped
    assert set(row) == {"milestone_epoch", "input_dev_ld", "input_test_ld", "modes"}
    assert set(row["modes"]) == set(chain_refit.MODES)
    assert all(set(m) == {"test_ld", "delta"} and np.isfinite(m["test_ld"])
               for m in row["modes"].values())
    preds = os.path.join(run["run_dir"], "preds")
    assert sorted(os.listdir(preds)) == [f"milestone-epoch[0]-{t}.csv"
                                         for t in ("dev", "trn", "tst")]
    # a second run uses the CSVs and the trained corrector again
    again = chain_refit.main([
        "--data-dir", run["data"], "--run-dir", run["run_dir"], "--milestones", "0",
        "--lm-epochs", "1", "--batch-size", "8", "--lm-beam", "2",
        "--work-dir", chain["work"], "--device", "cpu"])
    assert again["milestones"][0]["input_test_ld"] == row["input_test_ld"]


def test_chain_refit_is_the_jax_tools_procedure(run, chain, tmp_path, monkeypatch):
    """The repository's ``tools/chain_refit.py`` on the same run, its stages
    replaced by what the port's stages produced: the corrector's training
    config, each mode's ``lminfer`` config, the milestone CSVs it reads and
    the record it writes (every LD) are the port's."""
    import functools
    import sys

    import attention_based_e2e_asr_dnn_tpu.lminfer as jax_lminfer
    import attention_based_e2e_asr_dnn_tpu.lmtrain as jax_lmtrain

    ref = _load_root_tool("chain_refit")
    work = str(tmp_path / "work")
    port_lm_runs = os.path.join(chain["work"], "lm-m0")
    (port_lm_run,) = os.listdir(port_lm_runs)
    corrected = [text for pred, _, text in chain["scored"]
                 if pred.endswith(os.path.join("ckpts", "avg-all-pred.csv"))]
    assert len(corrected) == len(chain_refit.MODES)
    trained, inferred = [], []

    def lmtrain(args):  # the corrector the port trained, where this config asks
        cfg = _yaml(args.config_file)
        trained.append(cfg)
        shutil.copytree(os.path.join(port_lm_runs, port_lm_run),
                        os.path.join(cfg["EXP_FOLDER"], port_lm_run))

    def lminfer(args):  # the port's corrected CSV of this mode
        cfg = _yaml(args.config_file)
        with open(os.path.join(cfg["exp_folder"], "ckpts", "avg-all-pred.csv"), "w") as fh:
            fh.write(corrected[len(inferred)])
        inferred.append(cfg)

    def no_infer(*args):
        raise AssertionError("the milestone CSVs the port decoded are there to be read")

    monkeypatch.setattr(ref, "rewriter_config",
                        functools.partial(_toy_rewriter_config, recipe=_root_recipe()))
    monkeypatch.setattr(ref, "run_infer", no_infer)
    monkeypatch.setattr(jax_lmtrain, "main", lmtrain)
    monkeypatch.setattr(jax_lminfer, "main", lminfer)
    out = str(tmp_path / "chain.json")
    monkeypatch.setattr(sys, "argv", [
        "chain_refit.py", "--data-dir", run["data"], "--run-dir", run["run_dir"],
        "--milestones", "0", "5", *CHAIN_ARGS, "--work-dir", work, "--out", out])
    ref.main()
    with open(out) as fh:
        jax_record = json.load(fh)
    ours = json.loads(json.dumps(chain["result"]))
    assert jax_record == {**ours, "work_dir": work}
    # the configs it wrote, with its work folder for the port's
    port_cfg = _yaml(os.path.join(chain["work"], "rewriter-m0.yml"))
    assert port_cfg["model"]["configs"]["CHR_MAX_STEPS"] == 24
    assert [_moved(c, work, chain["work"]) for c in trained] == [port_cfg]
    assert [_moved(c, work, chain["work"]) for c in inferred] == [
        _yaml(os.path.join(chain["work"], f"lminfer-m0-{name}.yml"))
        for name in chain_refit.MODES]


def test_best_effort_eval_writes_the_jax_record(best):
    result = best["result"]
    with open(best["out"]) as fh:
        assert json.load(fh) == json.loads(json.dumps(result))
    assert set(result) == {"run_dir", "lm_run", "split", "n_utts", "beam_size",
                           "span_family", "margin", "greedy_dev_ld", "beam_dev_ld",
                           "beam_corrector_dev_ld"}
    assert result["n_utts"] == 4 and all(np.isfinite(result[k]) for k in (
        "greedy_dev_ld", "beam_dev_ld", "beam_corrector_dev_ld"))
    assert sorted(os.listdir(best["work"])) == ["corr.tlas", "las-beam.tlas",
                                                "las-greedy.tlas"]


BEST_ARGS = ["--batch", "4", "--beam-size", "2", "--span-family", "f90", "--margin", "-0.5"]


@pytest.fixture(scope="module")
def best(run, tmp_path_factory):
    """The port's ``best_effort_eval`` on the toy run and a toy Rewriter, with
    the export commands it ran recorded."""
    import subprocess

    root = tmp_path_factory.mktemp("best")
    lm = make_lm_experiment(os.path.join(str(root), "lm"))
    work, out = str(root / "work"), str(root / "best.json")
    commands = []
    real = subprocess.run

    def recording(cmd, *args, **kwargs):
        commands.append(list(cmd))
        return real(cmd, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(subprocess, "run", recording)
        result = best_effort_eval.main([
            "--data-dir", run["data"], "--run-dir", run["run_dir"], "--lm-run", lm,
            *BEST_ARGS, "--work-dir", work, "--out", out, "--device", "cpu"])
    return {"result": result, "out": out, "work": work, "lm": lm, "commands": commands}


def test_best_effort_eval_is_the_jax_tools_procedure(run, best, tmp_path, monkeypatch):
    """The repository's ``tools/best_effort_eval.py`` on the same run, its
    artifacts the port's and read by the port's classes: the exports it asks
    for (read by the port's ``export_serving`` parser) and the record it
    writes (every LD) are the port's."""
    import functools
    import subprocess
    import sys

    import attention_based_e2e_asr_dnn_tpu.export as jax_export

    from attention_based_e2e_asr_dnn_tpu_torch import export as port_export
    from attention_based_e2e_asr_dnn_tpu_torch.tools import export_serving

    ref = _load_root_tool("best_effort_eval")
    commands = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: commands.append(list(cmd)))
    monkeypatch.setattr(jax_export, "ArtifactTranscriber",
                        functools.partial(port_export.ArtifactTranscriber, device="cpu"))
    monkeypatch.setattr(jax_export, "ExportedCorrector",
                        functools.partial(port_export.ExportedCorrector, device="cpu"))
    out = str(tmp_path / "best.json")
    monkeypatch.setattr(sys, "argv", [
        "best_effort_eval.py", "--data-dir", run["data"], "--run-dir", run["run_dir"],
        "--lm-run", best["lm"], *BEST_ARGS, "--work-dir", best["work"], "--out", out])
    ref.main()
    with open(out) as fh:
        assert json.load(fh) == json.loads(json.dumps(best["result"]))

    def asked(cmd, lead):  # what an export command asks for, the device aside
        args = vars(export_serving.build_argparser().parse_args(cmd[lead:]))
        args.pop("device")
        return args

    assert [asked(c, 2) for c in commands] == [asked(c, 3) for c in best["commands"]]
    assert [c[1] for c in commands] == [os.path.join(REPO, "tools", "export_serving.py")] * 3
    assert {tuple(c[1:3]) for c in best["commands"]} == {
        ("-m", "attention_based_e2e_asr_dnn_tpu_torch.tools.export_serving")}
