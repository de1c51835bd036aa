"""The whole reference recipe on a synthetic corpus, on one card (the
counterpart of the repository's ``tools/full_recipe_run.py``): the
reference's stages (README.md:107-154) and its milestone -> Rewriter chain
(src/train.py:323, 366-368) through this package's CLIs.

  1. Train base-LAS with the reference's hyperparameters: dropouts
     0.3/0.3/0.35 (listener) and 0.3 (decoder), SpecAugment, the LD-gated
     teacher-forcing schedule (tf 1.0 -> 0.6), ReduceLROnPlateau, milestone
     checkpoints every 10 epochs; both kernel tiers, bfloat16.
  2. Decode the train and dev sets with an early (imperfect) milestone: the
     reference's step that makes the Rewriter's data.
  3. Train the Rewriter on (milestone predictions, gold transcripts) with
     the ``lmtrain`` CLI.
  4. Correct the milestone's dev predictions with the ``lminfer`` CLI (beam
     and the never-worse gate) and report the dev LD before and after.

One deviation, the JAX tool's too: SpecAugment's time mask scales with the
corpus (synthetic utterances are ~100-400 frames against LibriSpeech's
~1200-1600, so a 200-frame mask would erase whole utterances; the masked
share stays comparable). Prediction CSVs are read with the ``csv`` module
(``data/datasets.py::read_prediction_lines``), not pandas: an empty label
stays ``""`` and ``007`` stays ``007``, as with pandas' ``keep_default_na=
False`` over a column of text.

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.make_synthetic_data --out-dir /tmp/synth
    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.full_recipe_run --data-dir /tmp/synth

Prints one JSON line; ``--device`` (default ``cuda``; ``cuda`` without a
card raises) is where every stage runs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import tempfile

import numpy as np
import torch
import yaml

from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import read_prediction_lines
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import require_device
from attention_based_e2e_asr_dnn_tpu_torch.utils.levenshtein import levenshtein


def las_recipe_config(data_dir: str, exp_dir: str, epochs: int, batch_size: int,
                      decoder_impl: str = "scan", max_steps: int = 120,
                      init_force: bool = False) -> dict:
    """Base-LAS with the reference's training hyperparameters (reference
    config/sample-attention.yml:45-104, README.md:61-104)."""
    return {
        "TRN_FOLDER": os.path.join(data_dir, "train-clean-100"),
        "DEV_FOLDER": os.path.join(data_dir, "dev-clean"),
        "TST_FOLDER": os.path.join(data_dir, "test-clean"),
        "EXP_FOLDER": exp_dir,
        "MST_FOLDER": os.path.join(exp_dir, "milestones"),
        "seed": 416,
        "epochs": epochs,
        "batch_size": batch_size,
        "accu_grad": 1,
        "grad_norm": 5.0,
        "eval_ld_interval": 1,
        "init_force": init_force,
        "tf_rate": 1.0,
        "max_savings": 3,
        "use_specaug": True,
        "specaug_freq": 6,       # reference FrequencyMasking(6)
        "specaug_time": 40,      # scaled mask width (see the module docstring)
        "compute_dtype": "bfloat16",
        "pad_time_multiple": 128,
        "pad_label_multiple": 32,
        "scan_unroll": 8,
        "wandb": {"use": False},
        "finetune": {"use": False, "reinit_lr": False, "checkpoint": None},
        "model": {
            "tag": "recipe-LAS",
            "configs": {
                "listener_configs": {
                    "input_dim": 15, "uniform_hid_dim": 512, "lstm_layers": 1,
                    "plstm_layers": 3, "bidirectional": True,
                    "init_dropout": 0.3, "mid_dropout": 0.3,
                    "final_dropout": 0.35, "lstm_impl": "pallas",
                },
                "speller_configs": {
                    "att_proj_dim": 256, "att_heads": 1, "att_dropout": 0.0,
                    "dec_emb_dim": 512, "dec_emb_dropout": 0.0,
                    "dec_lstm_hid_dim": 512, "dec_lstm_out_dim": 256,
                    "dec_lstm_dropout": 0.3, "CHR_MAX_STEPS": max_steps,
                    "USE_GREEDY": True, "decoder_impl": decoder_impl,
                },
            },
        },
        # the reference's best optimizer: AdamW lr 1e-3 wd 5e-6 amsgrad
        "optimizer": {"name": "adamw",
                      "configs": {"lr": 1e-3, "weight_decay": 5e-6, "amsgrad": True}},
        "batch_scheduler": {"use": False, "configs": {}},
        "epoch_scheduler": {"use": True},
        # staged tf 1.0 -> 0.6 (README stages 2-5), LD-gated
        "tf_rate_scheduler": {"use": True,
                              "configs": {"factor": 0.1, "interval": 4, "lowest": 0.6}},
        # README stage 6: dropouts scaled down late in training
        "dropout_scheduler": {"use": True, "configs": {max(epochs - 10, 1): 0.667}},
    }


def rewriter_config(data_dir: str, exp_dir: str, trn_pred: str, dev_pred: str,
                    epochs: int) -> dict:
    return {
        "TRN_FOLDER": os.path.join(data_dir, "train-clean-100", "transcript", "raw"),
        "DEV_FOLDER": os.path.join(data_dir, "dev-clean", "transcript", "raw"),
        "TST_FOLDER": os.path.join(data_dir, "test-clean"),
        "EXP_FOLDER": exp_dir,
        "TRN_PRED_DIR": trn_pred,
        "DEV_PRED_DIR": dev_pred,
        "seed": 416,
        "epochs": epochs,
        "batch_size": 64,
        "accu_grad": 1,
        "grad_norm": 10.0,
        "eval_ld_interval": 1,
        "tf_rate": 1.0,
        "max_savings": 1,
        "init_force": False,
        "compute_dtype": "bfloat16",
        "pad_label_multiple": 32,
        "wandb": {"use": False},
        "finetune": {"use": False, "reinit_lr": False, "checkpoint": None},
        "model": {
            "tag": "recipe-Rewriter",
            "configs": {
                "emb_dim": 256, "enc_lstm_layers": 2, "enc_lstm_hid_dim": 256,
                "enc_dropouts": [0.2, 0.2], "att_proj_dim": 128,
                "att_heads": 1, "att_dropout": 0.2, "dec_lstm_layers": 2,
                "dec_lstm_hid_dim": 256, "dec_lstm_out_dim": 128,
                "dec_lstm_dropout": 0.2, "CHR_MAX_STEPS": 120,
                # the Rewriter trains on both kernel tiers too
                "lstm_impl": "pallas", "decoder_impl": "pallas",
            },
        },
        "optimizer": {"name": "adamw",
                      "configs": {"lr": 1e-3, "weight_decay": 5e-6, "amsgrad": True}},
        "batch_scheduler": {"use": False, "configs": {}},
        "epoch_scheduler": {"use": True},
        "tf_rate_scheduler": {"use": False, "configs": {}},
        "dropout_scheduler": {"use": False, "configs": {}},
    }


def dev_ld_of_csv(pred_csv: str, trans_dir: str) -> float:
    """Mean Levenshtein distance of a prediction CSV's labels against the
    gold transcripts of ``trans_dir`` (in sorted file order)."""
    preds = read_prediction_lines(pred_csv)
    golds = ["".join(str(c) for c in np.load(os.path.join(trans_dir, f))[1:-1])
             for f in sorted(os.listdir(trans_dir)) if f.endswith(".npy")]
    if len(preds) != len(golds):
        raise ValueError(f"{pred_csv}: {len(preds)} predictions for {len(golds)} "
                         f"transcripts in {trans_dir}")
    return float(np.mean([levenshtein(p, g) for p, g in zip(preds, golds)]))


def run_infer(run_dir: str, some_folder: str, ckpt_path: str, batch_size: int,
              device: str) -> str:
    """Decode a dataset folder with one checkpoint through the ``infer``
    CLI's own worker; returns the prediction CSV's path."""
    from attention_based_e2e_asr_dnn_tpu_torch import infer as infer_mod
    from attention_based_e2e_asr_dnn_tpu_torch.config import Config, load_config
    from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher
    from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import AsrTestDataset
    from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build

    model_cfgs = load_config(os.path.join(run_dir, "config.json"))
    configs = model_cfgs.model.configs
    cuda_build.build_for(torch.device(device),
                         configs["listener_configs"].get("lstm_impl"),
                         configs["speller_configs"].get("decoder_impl"))
    infcfgs = Config({"SOME_FOLDER": some_folder, "exp_folder": run_dir,
                      "use_greedy": True, "beam_size": 0, "early_stop": True,
                      "batch_size": batch_size, "run_all": False, "epoch_num": None,
                      "run_avg": False})
    ds = AsrTestDataset(std_dir=some_folder)
    batcher = BucketBatcher(ds, batch_size, pad_time_multiple=128, has_labels=False)
    base = os.path.basename(os.path.normpath(some_folder))
    tag = "trn" if "train" in base else "dev" if "dev" in base else "tst"
    template = os.path.join(some_folder, "transcript", "random_submission.csv")
    infer_mod.infer_one_checkpoint(
        model_cfgs=model_cfgs, infcfgs=infcfgs, checkpoint_filepath=ckpt_path,
        batcher=batcher, n_examples=len(ds), tag=tag, template_filepath=template,
        vocab=model_cfgs.VOCAB, sos_idx=model_cfgs.SOS_IDX, eos_idx=model_cfgs.EOS_IDX,
        device=torch.device(device))
    return ckpt_path.replace(".ckpt", f"-{tag}.csv").replace("ckpts", "preds")


def epoch_of(name: str) -> int:
    m = re.search(r"epoch\[(\d+)\]", name)
    return int(m.group(1)) if m else -1


def write_yaml(path: str, cfg: dict) -> str:
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="the reference recipe end to end")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--lm-epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--milestone-epoch", type=int, default=9)
    ap.add_argument("--decoder-impl", choices=["scan", "pallas"], default="scan")
    ap.add_argument("--max-steps", type=int, default=120)
    ap.add_argument("--init-force", action="store_true")
    ap.add_argument("--lm-beam", type=int, default=8, help="the corrector's beam")
    ap.add_argument("--lm-margin", type=float, default=0.0,
                    help="the gate's margin (average log-probability a character)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; cuda without a card raises")
    return ap


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    require_device(args.device, "full_recipe_run")
    from attention_based_e2e_asr_dnn_tpu_torch import lminfer as lminfer_mod
    from attention_based_e2e_asr_dnn_tpu_torch import lmtrain as lmtrain_mod
    from attention_based_e2e_asr_dnn_tpu_torch import train as train_mod

    work = args.work_dir or tempfile.mkdtemp(prefix="recipe-")
    os.makedirs(work, exist_ok=True)
    las_exp = os.path.join(work, "las")
    lm_exp = os.path.join(work, "lm")
    device_args = ["--device", args.device]

    # 1. LAS with the reference's recipe
    cfg = las_recipe_config(args.data_dir, las_exp, args.epochs, args.batch_size,
                            args.decoder_impl, args.max_steps, args.init_force)
    cfg_path = write_yaml(os.path.join(work, "las.yml"), cfg)
    trainer = train_mod.main(train_mod.build_argparser().parse_args(["-c", cfg_path,
                                                                     *device_args]))
    run_dir = trainer.saving_dir

    # 2. a milestone -> the Rewriter's data
    mst_dir = os.path.join(las_exp, "milestones")
    # by epoch number: epoch[19] after epoch[9]
    milestones = sorted((f for f in os.listdir(mst_dir) if f.endswith(".ckpt")),
                        key=epoch_of) if os.path.isdir(mst_dir) else []
    if not milestones:
        raise FileNotFoundError(f"no milestone checkpoints in {mst_dir} (one is saved "
                                f"every 10 epochs: run --epochs 10 or more)")
    want = f"epoch[{args.milestone_epoch}].ckpt"
    mst = os.path.join(mst_dir, want if want in milestones else milestones[0])
    # the predictions land under the run (the ckpts -> preds path rewrite)
    mst_local = os.path.join(run_dir, "ckpts", "milestone-" + os.path.basename(mst))
    shutil.copyfile(mst, mst_local)
    trn_pred = run_infer(run_dir, os.path.join(args.data_dir, "train-clean-100"), mst_local,
                         args.batch_size, args.device)
    dev_pred = run_infer(run_dir, os.path.join(args.data_dir, "dev-clean"), mst_local,
                         args.batch_size, args.device)
    dev_trans = os.path.join(args.data_dir, "dev-clean", "transcript", "raw")
    ld_before = dev_ld_of_csv(dev_pred, dev_trans)

    # 3. the Rewriter (lmtrain CLI)
    lm_cfg = rewriter_config(args.data_dir, lm_exp, trn_pred, dev_pred, args.lm_epochs)
    lm_path = write_yaml(os.path.join(work, "rewriter.yml"), lm_cfg)
    lm_trainer = lmtrain_mod.main(lmtrain_mod.build_argparser().parse_args(
        ["-c", lm_path, *device_args]))
    lm_run = lm_trainer.saving_dir

    # 4. correct the dev CSV (lminfer CLI): beam rewrite and the gate
    li_path = write_yaml(os.path.join(work, "lminfer.yml"), {
        "TST_DIR": dev_pred, "TST_FOLDER": os.path.join(args.data_dir, "dev-clean"),
        "exp_folder": lm_run, "use_greedy": True, "batch_size": 64, "run_all": False,
        "epoch_num": None, "run_avg": True, "beam_size": args.lm_beam,
        "gate_correction": True, "confidence_margin": args.lm_margin})
    lminfer_mod.main(lminfer_mod.build_argparser().parse_args(["-c", li_path,
                                                               *device_args]))
    ld_after = dev_ld_of_csv(os.path.join(lm_run, "ckpts", "avg-all-pred.csv"), dev_trans)

    # epoch throughput end to end (train + SpecAugment + dev + checkpoints):
    # the median of the epochs after the first
    steady = trainer.epoch_seconds[1:] or trainer.epoch_seconds
    n_train = len(os.listdir(os.path.join(args.data_dir, "train-clean-100", "mfcc")))
    result = {
        "epoch_seconds_median": float(np.median(steady)),
        "epoch_utt_s_end_to_end": float(n_train / np.median(steady)),
        "las_dev_ld_history": trainer.dev_history["ld"],
        "las_best_dev_ld": min(trainer.dev_history["ld"]),
        "final_tf_rate": trainer.tf_rate,
        "final_lr": trainer.current_lr,
        "milestone": os.path.basename(mst),
        "milestone_dev_ld": ld_before,
        "rewriter_corrected_dev_ld": ld_after,
        "rewriter_delta": ld_before - ld_after,
        "work_dir": work,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
