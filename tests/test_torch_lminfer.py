"""PyTorch port, the Rewriter chain's entry points against the JAX package's
on copies of one toy Rewriter experiment, in float32: the ``lminfer`` CLI's
CSVs byte-identical in every mode (beam, greedy, ``early_stop: false``
through the fused eval decode, fixed margins with and without span rewrites,
``"auto"`` with and without them, ``run_avg``), the LM datasets, the
``Corrector``'s strings and a ``Transcriber`` that corrects its output.
Both kernel tiers are configured, so the CPU runs their plain versions and
the JAX package its Pallas kernels in interpret mode."""

import argparse
import json
import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from attention_based_e2e_asr_dnn_tpu import constants
from attention_based_e2e_asr_dnn_tpu import lminfer as jlminfer
from attention_based_e2e_asr_dnn_tpu.data import datasets as jdatasets
from attention_based_e2e_asr_dnn_tpu.models import rewriter as jrw
from attention_based_e2e_asr_dnn_tpu.serving import Corrector as JaxCorrector
from attention_based_e2e_asr_dnn_tpu.serving import Transcriber as JaxTranscriber
from attention_based_e2e_asr_dnn_tpu.training import checkpoints as jckpt
from attention_based_e2e_asr_dnn_tpu_torch import lminfer as tlminfer
from attention_based_e2e_asr_dnn_tpu_torch import serving as tserving
from attention_based_e2e_asr_dnn_tpu_torch.data import datasets as tdatasets

from test_torch_infer import toy  # noqa: F401  (the fixture)

torch.set_num_threads(1)

LM_MODEL = dict(emb_dim=16, enc_lstm_layers=2, enc_lstm_hid_dim=8, enc_dropouts=[0.0, 0.0],
                att_proj_dim=8, att_heads=2, dec_lstm_hid_dim=16, dec_lstm_out_dim=8,
                dec_lstm_dropout=0.0, CHR_MAX_STEPS=24, lstm_impl="pallas",
                decoder_impl="pallas")
WORDS = ["THE", "CAT", "SAT", "ON", "A", "MAT", "IT'S", "DOG", "RAN"]
N_LINES = 6


def _text(rng, words=(1, 4)):
    return " ".join(rng.choice(WORDS, int(rng.integers(*words))))


def make_lm_experiment(root, seed=0, epochs=(1, 2)):
    """A Rewriter experiment folder: the config snapshot and one seeded best
    checkpoint an epoch (non-zero learned states)."""
    os.makedirs(os.path.join(root, "ckpts"))
    snap = {"compute_dtype": "float32", "VOCAB": list(constants.VOCAB),
            "SOS_IDX": constants.SOS_IDX, "EOS_IDX": constants.EOS_IDX,
            "model": {"tag": "toy-Rewriter", "configs": LM_MODEL}}
    with open(os.path.join(root, "config.json"), "w") as fh:
        json.dump(snap, fh)
    cfg = jrw.RewriterConfig(**LM_MODEL)
    rng = np.random.default_rng(seed)
    for epoch in epochs:
        params = jax.tree.map(lambda a: np.array(a, np.float32),
                              jrw.rewriter_init(jax.random.key(seed + epoch), cfg))
        for key in ("init_h1", "init_c1", "init_h2", "init_c2", "cls_b"):
            params["decoder"][key] = rng.uniform(-0.5, 0.5, params["decoder"][key].shape
                                                 ).astype(np.float32)
        jckpt.save_checkpoint(os.path.join(root, "ckpts", f"min-loss-epoch[{epoch}].ckpt"),
                              {"params": params, "epoch": epoch})
    return root


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """The experiment, a prediction CSV with its template, and a labelled
    calibration set (predictions near their gold transcripts)."""
    root = str(tmp_path_factory.mktemp("lm"))
    exp = make_lm_experiment(os.path.join(root, "exp"))
    rng = np.random.default_rng(1)
    tst = os.path.join(root, "test-clean")
    os.makedirs(os.path.join(tst, "transcript"))
    pd.DataFrame({"id": range(N_LINES), "label": ["X"] * N_LINES}).to_csv(
        os.path.join(tst, "transcript", "random_submission.csv"), index=False)
    preds = os.path.join(root, "pred-test.csv")
    pd.DataFrame({"id": range(N_LINES), "label": [_text(rng) for _ in range(N_LINES)]}
                 ).to_csv(preds, index=False)
    cal_trans = os.path.join(root, "cal-trans")
    os.makedirs(cal_trans)
    cal_lines = []
    for i in range(2 * N_LINES):
        gold = _text(rng, (1, 2))
        np.save(os.path.join(cal_trans, f"{i:03d}.npy"),
                np.array(["<sos>", *gold, "<eos>"]))
        # every other prediction buried in garbage, which the untrained
        # model's short rewrites shorten: the fit has gains to weigh
        cal_lines.append(gold if i % 2 else "ZZXQ JQZX " + gold)
    cal_pred = os.path.join(root, "pred-dev.csv")
    pd.DataFrame({"id": range(2 * N_LINES), "label": cal_lines}).to_csv(cal_pred,
                                                                       index=False)
    return {"root": root, "exp": exp, "tst": tst, "preds": preds, "cal_pred": cal_pred,
            "cal_trans": cal_trans}


def _lm_yaml(root, name, lm, exp, **opts):
    cfg = {"TST_DIR": lm["preds"], "TST_FOLDER": lm["tst"], "exp_folder": exp,
           "batch_size": 4, "run_all": False, "epoch_num": None, "run_avg": False,
           "CAL_PRED_DIR": lm["cal_pred"], "CAL_TRANS_DIR": lm["cal_trans"], **opts}
    path = os.path.join(root, f"{name}.yml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


MODES = {
    "beam": {"epoch_num": 2, "beam_size": 4, "length_alpha": 0.5},
    "greedy-run_all": {"run_all": True},
    "fixed-decode": {"epoch_num": 1, "early_stop": False, "gate_correction": False},
    "margin": {"epoch_num": 2, "confidence_margin": -100.0},
    "margin-span": {"epoch_num": 2, "span_rewrite": True, "span_family": "f50",
                    "confidence_margin": -0.5},
    "auto": {"epoch_num": 2, "confidence_margin": "auto"},
    "auto-span": {"epoch_num": 1, "confidence_margin": "auto", "span_rewrite": True},
    "run_avg": {"epoch_num": 1, "run_avg": True},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_lminfer_writes_the_jax_csvs(lm, tmp_path, capsys, mode):
    outs, logs = {}, {}
    for side in ("jax", "port"):
        exp_copy = shutil.copytree(lm["exp"], str(tmp_path / side))
        cfg = _lm_yaml(str(tmp_path), side, lm, exp_copy, **MODES[mode])
        if side == "jax":
            jlminfer.main(argparse.Namespace(config_file=cfg))
        else:
            tlminfer.main(tlminfer.build_argparser().parse_args(["-c", cfg, "--device", "cpu"]))
        # the calibration's lines (margins to 4 decimals) and the gate's
        # counts; its full-precision margin differs in the last bits
        logs[side] = [ln.split(", margin")[0] for ln in capsys.readouterr().out.splitlines()
                      if "calibrat" in ln or "gate kept" in ln]
        ckpts = os.path.join(exp_copy, "ckpts")
        outs[side] = {f: open(os.path.join(ckpts, f), "rb").read()
                      for f in sorted(os.listdir(ckpts)) if f.endswith("-pred.csv")}
    assert outs["port"] == outs["jax"] and outs["port"]
    assert logs["port"] == logs["jax"]
    for body in outs["port"].values():
        lines = body.decode().splitlines()
        assert lines[0] == "id,label" and len(lines) == N_LINES + 1


def test_lminfer_refusals(lm, tmp_path, monkeypatch):
    exp = lm["exp"]
    bad = _lm_yaml(str(tmp_path), "bad", lm, exp, epoch_num=1, span_family="f50")
    with pytest.raises(ValueError, match="span_rewrite: true"):
        tlminfer.main(tlminfer.build_argparser().parse_args(["-c", bad, "--device", "cpu"]))
    no_cal = _lm_yaml(str(tmp_path), "nocal", lm, exp, epoch_num=1, confidence_margin="auto",
                      CAL_PRED_DIR=None)
    with pytest.raises(ValueError, match="CAL_PRED_DIR"):
        tlminfer.main(tlminfer.build_argparser().parse_args(["-c", no_cal, "--device", "cpu"]))
    missing = _lm_yaml(str(tmp_path), "missing", lm, exp, epoch_num=7)
    with pytest.raises(FileNotFoundError, match=r"epoch\[7\]"):
        tlminfer.main(tlminfer.build_argparser().parse_args(["-c", missing, "--device", "cpu"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlminfer.main(tlminfer.build_argparser().parse_args(["-c", missing]))


def test_lm_datasets_match_jax(tmp_path):
    rows = ["A B", "", 'SAY "HI", OK'.replace('"', "").replace(",", ""), "IT'S"]
    csv_path = str(tmp_path / "pred.csv")
    pd.DataFrame({"id": range(4), "label": rows}).to_csv(csv_path, index=False)
    lines_path = str(tmp_path / "pred.txt")
    with open(lines_path, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    trans = tmp_path / "trans"
    trans.mkdir()
    for i, r in enumerate(rows):
        np.save(str(trans / f"{i}.npy"), np.array(["<sos>", *r, "<eos>"]))
    vm = constants.VOCAB_MAP
    for path in (csv_path, lines_path):
        ours, ref = tdatasets.LmTestDataset(path, vm), jdatasets.LmTestDataset(path, vm)
        assert len(ours) == len(ref) == 4
        for i in range(4):
            np.testing.assert_array_equal(ours[i], ref[i])
        ours = tdatasets.LmTrainDevDataset(str(trans), path, vm)
        ref = jdatasets.LmTrainDevDataset(str(trans), path, vm)
        for i in range(4):
            for a, b in zip(ours[i], ref[i]):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdatasets.LmTestDataset(csv_path, vm)[1], [0, 29])


CORRECTOR_CASES = {
    "beam": dict(beam_size=4),
    "greedy-margin": dict(beam_size=0, confidence_margin=-100.0),
    "span": dict(beam_size=0, span_rewrite=True, span_family="conf", confidence_margin=-0.5),
    "ungated": dict(beam_size=0, gate=False, batch_size=2),
}


@pytest.mark.parametrize("case", list(CORRECTOR_CASES))
def test_corrector_matches_jax(lm, case):
    rng = np.random.default_rng(2)
    texts = [_text(rng) for _ in range(5)] + ["", "A B%"]
    opts = CORRECTOR_CASES[case]
    ref = JaxCorrector(lm["exp"], **opts).correct(texts)
    ours = tserving.Corrector(lm["exp"], device="cpu", **opts).correct(texts)
    assert ours == ref and len(ours) == len(texts)


def test_corrector_refusals(lm):
    with pytest.raises(ValueError, match="span_family 'x'"):
        tserving.Corrector(lm["exp"], span_rewrite=True, span_family="x", device="cpu")
    with pytest.raises(ValueError, match="requires gate=True"):
        tserving.Corrector(lm["exp"], span_rewrite=True, gate=False, device="cpu")


def test_transcriber_with_corrector_matches_jax(toy, lm):  # noqa: F811
    """A Transcriber given a Corrector returns corrected transcripts, so its
    StreamingTranscriber does too."""
    _, _, exp = toy
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((int(n), 15)).astype(np.float32)
             for n in rng.integers(6, 30, 5)]
    opts = dict(batch_size=4, pad_time_multiple=4)
    ref = JaxTranscriber(exp, corrector=JaxCorrector(lm["exp"], beam_size=0,
                                                     confidence_margin=-100.0),
                         **opts).transcribe(feats)
    corrector = tserving.Corrector(lm["exp"], beam_size=0, confidence_margin=-100.0,
                                   device="cpu")
    port = tserving.Transcriber(exp, corrector=corrector, device="cpu", **opts)
    assert port.transcribe(feats) == ref
    plain = tserving.Transcriber(exp, device="cpu", **opts).transcribe(feats)
    assert corrector.correct(plain) == ref
    stream = tserving.StreamingTranscriber(port, max_wait_ms=200.0)
    try:
        futs = [stream.submit(f) for f in feats[:3]]
        assert [f.result(timeout=120) for f in futs] == port.transcribe(feats[:3])
    finally:
        stream.close()
