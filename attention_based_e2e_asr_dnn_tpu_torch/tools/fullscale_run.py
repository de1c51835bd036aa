"""The reference's headline regimen on the long-form synthetic corpus, on the
port (counterpart of the repository's ``tools/fullscale_run.py``).

The reference's published result is 150 epochs on the ~28k-utterance
train-clean-100 corpus. This driver builds the same recipe for the
synthetic train-clean-100-like corpus (``make_synthetic_data --words 25
45``): base-LAS, both kernel tiers (``lstm_impl: pallas``, ``decoder_impl:
pallas``), bfloat16, B=128, SpecAugment 6 / 200, the ``init_force``
alignment prior, the LD-gated staged teacher forcing, ReduceLROnPlateau, the
dropout scheduler and milestones, and drives the port's ``train.main`` with
it:

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.make_synthetic_data \\
        --out-dir <data> --n-train 28000 --n-dev 200 --n-test 200 --words 25 45
    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.fullscale_run \\
        --data-dir <data> --epochs 150 --mode resident [--out <file>]

Modes: ``resident`` (``device_resident_data: true``: every batch copied to
the card once, its composition frozen at the epoch-0 plan) and ``streamed``
(disk -> assembler -> card each step, a fresh composition every epoch).

The Trainer holds ``init_force`` for epochs < 10, so a run of fewer than 10
epochs trains the speller on the scan loop (the prior-biased attention,
which the fused kernels do not compute; the JAX package routes it there
too). Its kernels are then the listener's training forms (#2 / #4's
``lstm_scan_fusedin_train`` and ``lstm_scan_train``, #5's ``lstm_bwd_dw``
at H=512) and the dev decode's (#2 ``lstm_scan_fusedin``, #1
``lstm_scan``, #8's eval form ``speller_decode``); from epoch 10 on the
speller trains on #8's train form and #9.

Prints one JSON line: the mode, the run's shape, the best dev LD, the
epoch and train seconds, ``train_utt_s`` and ``epoch_utt_s_end_to_end``
(utterances over the median steady epoch, the first epoch left out where
there are more), ``card`` and ``power_limit_w``. ``--out`` writes the whole
record, the LD trajectory included, to a file of the caller's choosing; by
default nothing is written.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import yaml

from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import card_and_power, require_device


def max_label_chars(data_dir: str, split: str) -> int:
    """Longest transcript (chars with <sos> / <eos>) in a split: sizes
    ``CHR_MAX_STEPS`` so that the free-running dev decode can emit every
    gold label in full."""
    raw = os.path.join(data_dir, split, "transcript", "raw")
    longest = 0
    for f in os.listdir(raw):
        if f.endswith(".npy"):
            longest = max(longest, len(np.load(os.path.join(raw, f))))
    return longest


def fullscale_config(data_dir: str, exp_dir: str, epochs: int, mode: str,
                     batch_size: int, max_steps: int, seed: int) -> dict:
    """The reference's best-model recipe at full-dataset scale, both kernel
    tiers, the feed mode under test: the JAX tool's dict, key by key."""
    return {
        "TRN_FOLDER": os.path.join(data_dir, "train-clean-100"),
        "DEV_FOLDER": os.path.join(data_dir, "dev-clean"),
        "TST_FOLDER": os.path.join(data_dir, "test-clean"),
        "EXP_FOLDER": exp_dir,
        "MST_FOLDER": os.path.join(exp_dir, "milestones"),
        "seed": seed,
        "epochs": epochs,
        "batch_size": batch_size,
        "accu_grad": 1,
        "grad_norm": 5.0,
        "eval_ld_interval": 1,
        "init_force": True,
        "tf_rate": 1.0,
        "max_savings": 3,
        "use_specaug": True,
        "specaug_freq": 6,
        # long utterances (~1250 frames on average): the reference's
        # 200-frame time mask is the right scale here
        "specaug_time": 200,
        "compute_dtype": "bfloat16",
        "feed_dtype": "auto",
        "lazy_data": True,
        "device_resident_data": mode == "resident",
        "pad_time_multiple": 256,
        "pad_label_multiple": 32,
        "scan_unroll": 8,
        "wandb": {"use": False},
        "finetune": {"use": False, "reinit_lr": False, "checkpoint": None},
        "model": {
            "tag": "fullscale-LAS",
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
                    "USE_GREEDY": True, "decoder_impl": "pallas",
                },
            },
        },
        "optimizer": {"name": "adamw",
                      "configs": {"lr": 1e-3, "weight_decay": 5e-6,
                                  "amsgrad": True}},
        "batch_scheduler": {"use": False, "configs": {}},
        "epoch_scheduler": {"use": True},
        "tf_rate_scheduler": {"use": True,
                              "configs": {"factor": 0.1, "interval": 4,
                                          "lowest": 0.6}},
        "dropout_scheduler": {"use": True,
                              "configs": {max(epochs - 10, 1): 0.667}},
    }


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--work-dir", default=None,
                        help="experiment folder (default: a new temporary folder)")
    parser.add_argument("--epochs", type=int, default=150)
    parser.add_argument("--mode", choices=["resident", "streamed"], default="resident")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--seed", type=int, default=416)
    parser.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    parser.add_argument("--out", default=None,
                        help="write the whole record, the histories included, here "
                             "(default: nowhere)")
    return parser


def run(args) -> dict:
    """Build the config, train, and return the record (histories
    included)."""
    from attention_based_e2e_asr_dnn_tpu_torch import train as train_mod

    require_device(args.device, "fullscale_run")
    work = args.work_dir or tempfile.mkdtemp(prefix="fullscale-")
    os.makedirs(work, exist_ok=True)
    longest = max(max_label_chars(args.data_dir, "train-clean-100"),
                  max_label_chars(args.data_dir, "dev-clean"))
    # the free-running decode's cap: the longest gold label (less the
    # stripped <sos>), rounded up to the label pad multiple
    max_steps = int(np.ceil((longest - 1) / 32) * 32)
    print(f"[fullscale] longest transcript {longest} chars -> CHR_MAX_STEPS {max_steps}")
    cfg = fullscale_config(args.data_dir, os.path.join(work, "las"), args.epochs, args.mode,
                           args.batch_size, max_steps, args.seed)
    cfg_path = os.path.join(work, "fullscale.yml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    trainer = train_mod.main(train_mod.build_argparser().parse_args(
        ["-c", cfg_path, "--device", args.device]))

    n_train = len(os.listdir(os.path.join(args.data_dir, "train-clean-100", "mfcc")))
    steady_tr = trainer.train_seconds[1:] or trainer.train_seconds
    steady_ep = trainer.epoch_seconds[1:] or trainer.epoch_seconds
    las_exp = os.path.join(work, "las")
    run_dir = [os.path.join(las_exp, d) for d in sorted(os.listdir(las_exp))
               if d != "milestones"][0]
    card, power = card_and_power(args.device)
    return {
        "mode": args.mode,
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "seed": args.seed,
        "n_train_utterances": n_train,
        "chr_max_steps": max_steps,
        "dev_ld_history": trainer.dev_history["ld"],
        "dev_loss_history": trainer.dev_history["loss"],
        "train_loss_history": trainer.train_history["loss"],
        "best_dev_ld": float(min(trainer.dev_history["ld"])),
        "best_dev_ld_epoch": int(np.argmin(trainer.dev_history["ld"])),
        "final_tf_rate": trainer.tf_rate,
        "final_lr": trainer.current_lr,
        "train_seconds": trainer.train_seconds,
        "eval_seconds": trainer.eval_seconds,
        "epoch_seconds": trainer.epoch_seconds,
        "steady_train_seconds_median": float(np.median(steady_tr)),
        "steady_epoch_seconds_median": float(np.median(steady_ep)),
        "epoch_utt_s_end_to_end": float(n_train / np.median(steady_ep)),
        "train_utt_s": float(n_train / np.median(steady_tr)),
        "run_dir": run_dir,
        "milestone_dir": os.path.join(las_exp, "milestones"),
        "work_dir": work,
        "device": str(args.device),
        "card": card,
        "power_limit_w": power,
    }


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    result = run(args)
    print(json.dumps({k: v for k, v in result.items() if not k.endswith("_history")}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"[fullscale] result written to {args.out}")
    return result


if __name__ == "__main__":
    main()
