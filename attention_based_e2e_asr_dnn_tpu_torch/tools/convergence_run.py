"""Convergence harness: train LAS with the port's ``train`` CLI on the
synthetic speech-like corpus and verify that the dev Levenshtein distance
collapses toward 0 (the port's copy of the repository's
``tools/convergence_run.py``, same architectures and recipe).

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.convergence_run \
        --arch small --lstm-impl pallas --decoder-impl pallas --epochs 20

The synthetic data (``make_synthetic_data.py`` beside this file) has the
monotonic character-to-frame alignment of speech, so a correct LAS stack
must learn the attention alignment and drive LD down. Without ``--data-dir``
the default corpus (2000 / 200 / 200 utterances, seed 0) is generated into a
temporary folder first. Prints one JSON verdict: the dev-LD trajectory, the
epoch seconds split train / dev, the device, and ``"converged": true`` when
the best dev LD is at most ``--target-ld``. Exit code 0 when converged.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import yaml

ARCHS = {
    # fast certificate (minutes)
    "small": {
        "listener": {"uniform_hid_dim": 256, "plstm_layers": 2,
                     "init_dropout": 0.1, "mid_dropout": 0.1,
                     "final_dropout": 0.1},
        "speller": {"att_proj_dim": 128, "dec_emb_dim": 256,
                    "dec_lstm_hid_dim": 256, "dec_lstm_out_dim": 128,
                    "dec_lstm_dropout": 0.1},
    },
    # multi-head variant (the heads > 1 attention path end to end)
    "multihead": {
        "listener": {"uniform_hid_dim": 256, "plstm_layers": 2,
                     "init_dropout": 0.1, "mid_dropout": 0.1,
                     "final_dropout": 0.1},
        "speller": {"att_proj_dim": 128, "att_heads": 4, "dec_emb_dim": 256,
                    "dec_lstm_hid_dim": 256, "dec_lstm_out_dim": 128,
                    "dec_lstm_dropout": 0.1},
    },
    # scaled LAS (configs/scaled-las.yml): 1024 hid, 4-head attention,
    # listener layers recomputed in the backward pass
    "scaled": {
        "listener": {"uniform_hid_dim": 1024, "plstm_layers": 3,
                     "init_dropout": 0.1, "mid_dropout": 0.1,
                     "final_dropout": 0.1, "remat": True},
        "speller": {"att_proj_dim": 256, "att_heads": 4, "dec_emb_dim": 512,
                    "dec_lstm_hid_dim": 1024, "dec_lstm_out_dim": 256,
                    "dec_lstm_dropout": 0.1},
    },
    # base-LAS (reference config/sample-attention.yml:45-68)
    "base": {
        "listener": {"uniform_hid_dim": 512, "plstm_layers": 3,
                     "init_dropout": 0.1, "mid_dropout": 0.1,
                     "final_dropout": 0.1},
        "speller": {"att_proj_dim": 256, "dec_emb_dim": 512,
                    "dec_lstm_hid_dim": 512, "dec_lstm_out_dim": 256,
                    "dec_lstm_dropout": 0.1},
    },
}


def make_config(data_dir: str, exp_dir: str, epochs: int,
                batch_size: int = 32, arch: str = "small",
                lstm_impl: str = "scan", decoder_impl: str = "scan",
                max_steps: int = 120, init_force: bool = False,
                lr: float = 0.002) -> dict:
    a = ARCHS[arch]
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
        "max_savings": 2,
        "use_specaug": False,
        "compute_dtype": "bfloat16",
        "pad_time_multiple": 128,
        "pad_label_multiple": 32,
        "scan_unroll": 8,
        "wandb": {"use": False},
        "finetune": {"use": False, "reinit_lr": False, "checkpoint": None},
        "model": {
            "tag": f"synth-LAS-{arch}",
            "configs": {
                "listener_configs": {
                    "input_dim": 15, "lstm_layers": 1, "bidirectional": True,
                    "lstm_impl": lstm_impl,
                    **a["listener"],
                },
                "speller_configs": {
                    "att_heads": 1, "att_dropout": 0.0, "dec_emb_dropout": 0.0,
                    "CHR_MAX_STEPS": max_steps, "USE_GREEDY": True,
                    "decoder_impl": decoder_impl,
                    **a["speller"],
                },
            },
        },
        "optimizer": {"name": "adamw",
                      "configs": {"lr": lr, "weight_decay": 1e-6,
                                  "amsgrad": True}},
        "batch_scheduler": {"use": False, "configs": {}},
        "epoch_scheduler": {"use": True},
        "tf_rate_scheduler": {"use": True,
                              "configs": {"factor": 0.1, "interval": 4,
                                          "lowest": 0.7}},
        "dropout_scheduler": {"use": False, "configs": {}},
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data-dir", default=None,
                        help="a corpus of make_synthetic_data.py; generated when absent")
    parser.add_argument("--exp-dir", default=None)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--target-ld", type=float, default=2.0)
    parser.add_argument("--arch", choices=list(ARCHS), default="small")
    parser.add_argument("--decoder-impl", choices=["scan", "pallas"], default="scan")
    parser.add_argument("--lstm-impl", choices=["scan", "pallas"], default="scan")
    parser.add_argument("--max-steps", type=int, default=120,
                        help="eval free-run decode cap (>= max label length)")
    parser.add_argument("--lr", type=float, default=0.002,
                        help="AdamW learning rate (wide archs want lower)")
    parser.add_argument("--init-force", action="store_true",
                        help="block-diagonal attention prior for early epochs")
    parser.add_argument("--device", default="cuda",
                        help="where the model trains: cuda, cuda:N or cpu")
    args = parser.parse_args(argv)

    from attention_based_e2e_asr_dnn_tpu_torch import train as train_mod
    from attention_based_e2e_asr_dnn_tpu_torch.tools.make_synthetic_data import generate

    data_dir = args.data_dir
    if data_dir is None:
        data_dir = tempfile.mkdtemp(prefix="synth-data-")
        generate(data_dir)
    exp_dir = args.exp_dir or tempfile.mkdtemp(prefix="synth-exp-")
    cfg = make_config(data_dir, exp_dir, args.epochs, args.batch_size,
                      args.arch, args.lstm_impl, args.decoder_impl,
                      args.max_steps, args.init_force, args.lr)
    cfg_path = os.path.join(exp_dir, "synth-config.yml")
    os.makedirs(exp_dir, exist_ok=True)
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(cfg, fh)

    trainer = train_mod.main(train_mod.build_argparser().parse_args(
        ["-c", cfg_path, "--device", args.device]))
    lds = trainer.dev_history["ld"]
    best = min(lds)
    device = trainer.device
    if device.type == "cuda":
        import torch

        device = torch.cuda.get_device_name(device)
    result = {
        "arch": args.arch, "lstm_impl": args.lstm_impl, "decoder_impl": args.decoder_impl,
        "device": str(device),
        "dev_ld_history": lds,
        "train_loss_history": trainer.train_history["loss"],
        "train_seconds": trainer.train_seconds,
        "eval_seconds": trainer.eval_seconds,
        "best_dev_ld": best,
        "target": args.target_ld,
        "converged": best <= args.target_ld,
    }
    print(json.dumps(result))
    return 0 if result["converged"] else 1


if __name__ == "__main__":
    sys.exit(main())
