"""PyTorch port, the ``infer`` CLI against the JAX package's on copies of one
toy experiment: every mode (run_all, epoch_num, run_avg; early_stop true and
false, the latter through the fused eval decode) writes byte-identical float32
submission CSVs. Also the CLI's refusals and the pandas-free CSV writer."""

import argparse
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from attention_based_e2e_asr_dnn_tpu import constants
from attention_based_e2e_asr_dnn_tpu import infer as jinfer
from attention_based_e2e_asr_dnn_tpu.training import checkpoints as jckpt
from attention_based_e2e_asr_dnn_tpu_torch import infer as tinfer
from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    las_config_from_dicts,
    las_init,
    las_to_jax_params,
)

torch.set_num_threads(1)

LISTENER = {"input_dim": 15, "uniform_hid_dim": 12, "lstm_layers": 1,
            "plstm_layers": 1, "bidirectional": True, "lstm_impl": "pallas"}
SPELLER = {"att_proj_dim": 8, "att_heads": 2, "dec_emb_dim": 16, "dec_lstm_hid_dim": 16,
           "dec_lstm_out_dim": 8, "CHR_MAX_STEPS": 10, "decoder_impl": "pallas",
           "dec_vocab_size": len(constants.VOCAB), "CHR_PAD_IDX": constants.PAD_IDX,
           "CHR_SOS_IDX": constants.SOS_IDX}
N_UTTS = 6


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A test set in the reference layout and an experiment folder with two
    best checkpoints (seeded parameters)."""
    root = str(tmp_path_factory.mktemp("toy"))
    rng = np.random.default_rng(0)
    data = os.path.join(root, "test-clean")
    os.makedirs(os.path.join(data, "mfcc"))
    os.makedirs(os.path.join(data, "transcript"))
    for i in range(N_UTTS):
        np.save(os.path.join(data, "mfcc", f"utt{i:03d}.npy"),
                rng.standard_normal((int(rng.integers(6, 30)), 15)).astype(np.float32))
    pd.DataFrame({"id": list(range(N_UTTS)), "label": ["X"] * N_UTTS}).to_csv(
        os.path.join(data, "transcript", "random_submission.csv"), index=False)

    exp = os.path.join(root, "exp")
    os.makedirs(os.path.join(exp, "ckpts"))
    snap = {"TRN_FOLDER": os.path.join(root, "train-clean-100"), "compute_dtype": "float32",
            "VOCAB": list(constants.VOCAB), "SOS_IDX": constants.SOS_IDX,
            "EOS_IDX": constants.EOS_IDX,
            "model": {"configs": {"listener_configs": LISTENER, "speller_configs": SPELLER}}}
    with open(os.path.join(exp, "config.json"), "w") as fh:
        json.dump(snap, fh)
    cfg = las_config_from_dicts(LISTENER, SPELLER)
    for epoch in (1, 2):
        params = las_to_jax_params(las_init(cfg, torch.Generator().manual_seed(epoch)))
        # non-zero learned states and classifier bias, as a trained model has
        for key in ("init_h1", "init_c1", "init_h2", "init_c2", "cls_b"):
            params["speller"][key] = rng.uniform(-0.5, 0.5, params["speller"][key].shape
                                                 ).astype(np.float32)
        jckpt.save_checkpoint(os.path.join(exp, "ckpts", f"min-loss-epoch[{epoch}].ckpt"),
                              {"params": params, "epoch": epoch})
    return root, data, exp


def _infer_yaml(root, name, data, exp, **opts):
    cfg = {"SOME_FOLDER": data, "exp_folder": exp, "batch_size": 4, "pad_time_multiple": 4,
           "run_all": False, "epoch_num": None, "run_avg": False, **opts}
    path = os.path.join(root, f"{name}.yml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


@pytest.mark.parametrize("opts", [
    {"run_all": True},                                          # early-stop greedy
    {"run_all": True, "early_stop": False},                     # fused decode
    {"epoch_num": 2, "run_avg": True, "early_stop": False, "max_len_factor": 0},
], ids=["run_all", "run_all-fixed", "epoch_num-run_avg-fixed"])
def test_infer_main_writes_the_jax_csvs(toy, tmp_path, opts):
    root, data, exp = toy
    outs = {}
    for side in ("jax", "port"):
        exp_copy = shutil.copytree(exp, str(tmp_path / side))
        cfg = _infer_yaml(str(tmp_path), side, data, exp_copy, **opts)
        if side == "jax":
            jinfer.main(argparse.Namespace(config_file=cfg))
        else:
            tinfer.main(tinfer.build_argparser().parse_args(["-c", cfg, "--device", "cpu"]))
        preds = os.path.join(exp_copy, "preds")
        outs[side] = {f: open(os.path.join(preds, f), "rb").read()
                      for f in sorted(os.listdir(preds))}
    expected = ({"min-loss-epoch[1]-tst.csv", "min-loss-epoch[2]-tst.csv"} if opts.get("run_all")
                else {"min-loss-epoch[2]-tst.csv", "avg-all-tst.csv"})
    assert set(outs["port"]) == set(outs["jax"]) == expected
    for name, body in outs["port"].items():
        assert body == outs["jax"][name], name
        lines = body.decode().splitlines()
        assert lines[0] == "id,label" and [ln.split(",")[0] for ln in lines[1:]] == \
            [str(i) for i in range(N_UTTS)]
        assert any(ln.split(",", 1)[1] for ln in lines[1:])  # transcripts, not blanks


def test_infer_main_refusals(toy, tmp_path, monkeypatch):
    root, data, exp = toy
    missing = _infer_yaml(str(tmp_path), "missing", data, exp, epoch_num=7)
    with pytest.raises(FileNotFoundError, match=r"epoch\[7\]"):
        tinfer.main(tinfer.build_argparser().parse_args(["-c", missing, "--device", "cpu"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tinfer.build_argparser().parse_args(["-c", missing])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinfer.main(args)


def test_write_submission_matches_pandas(tmp_path):
    template = str(tmp_path / "template.csv")
    pd.DataFrame({"id": [3, 1, 2, 0], "label": ["X", "Y", "", "Z"],
                  "speaker": ["a", "b,c", "d", "e"]}).to_csv(template, index=False)
    preds = ["A B", "", "IT'S", 'SAY "HI", OK']
    ours = tinfer.write_submission(preds, template, str(tmp_path / "ours" / "o.csv"))
    df = pd.read_csv(template)
    df["label"] = preds
    df.to_csv(str(tmp_path / "ref.csv"), index=False)
    assert open(ours, "rb").read() == open(str(tmp_path / "ref.csv"), "rb").read()
