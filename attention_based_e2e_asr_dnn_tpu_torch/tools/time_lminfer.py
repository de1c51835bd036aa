"""Time the ``lminfer`` CLI end to end on the card: the Rewriter's fixed
decode with both kernel tiers, in float32, and print one JSON line.

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.time_lminfer \
        [--lines 256] [--runs 2] [--work DIR]

It writes a Rewriter experiment (``configs/rewriter.yml``'s model block with
``lstm_impl: pallas`` and ``decoder_impl: pallas``, one checkpoint of seeded
random weights) and ``--lines`` prediction lines of 100-600 characters of
words into ``--work`` (a temporary folder by default), then runs
``lminfer.main`` with ``early_stop: false`` at ``configs/lm-infer.yml``'s
batch of 256 and no gate, ``--runs`` times: the first builds and binds the
kernels, the rest are timed (host clock around the whole call, ending in a
synchronize). ``lines_per_s`` is the lines over the median timed call. The
line names the card and its power limit, so two trees can be compared within
one run on one card (copy this tool into the other tree; run them in turns).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch
import yaml

from attention_based_e2e_asr_dnn_tpu_torch import lminfer
from attention_based_e2e_asr_dnn_tpu_torch.config import load_yaml
from attention_based_e2e_asr_dnn_tpu_torch.constants import EOS_IDX, SOS_IDX, VOCAB
from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import (
    RewriterConfig,
    rewriter_init,
    rewriter_to_jax_params,
)
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import require_device, smi_name_and_power
from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORDS = ("THE", "A", "OF", "AND", "TO", "IN", "HE", "WAS", "THAT", "IT", "HIS", "WITH",
         "AS", "FOR", "HAD", "YOU", "NOT", "BE", "HER", "IS", "BUT", "SAID", "WHICH")


def make_experiment(root: str, seed: int) -> str:
    """A Rewriter experiment folder: the model block of configs/rewriter.yml
    with both kernel tiers and one seeded checkpoint."""
    model = dict(load_yaml(os.path.join(REPO, "configs", "rewriter.yml"))["model"]["configs"])
    model.update(lstm_impl="pallas", decoder_impl="pallas")
    snap = {"compute_dtype": "bfloat16", "VOCAB": list(VOCAB), "SOS_IDX": SOS_IDX,
            "EOS_IDX": EOS_IDX, "model": {"tag": "base-Rewriter", "configs": model}}
    os.makedirs(os.path.join(root, "ckpts"))
    with open(os.path.join(root, "config.json"), "w") as fh:
        json.dump(snap, fh)
    params = rewriter_to_jax_params(rewriter_init(RewriterConfig(**model),
                                                  torch.Generator().manual_seed(seed)))
    save_checkpoint(os.path.join(root, "ckpts", "min-loss-epoch[1].ckpt"),
                    {"params": params, "epoch": 1})
    return root


def make_lines(root: str, n_lines: int, seed: int) -> tuple:
    """(the prediction CSV, the test folder with its template, characters)."""
    rng = np.random.default_rng(seed)
    lines = []
    for n in rng.integers(100, 601, n_lines):
        words = []
        while sum(len(w) + 1 for w in words) < n:
            words.append(WORDS[int(rng.integers(len(WORDS)))])
        lines.append(" ".join(words)[:n].strip())
    tst = os.path.join(root, "test-clean")
    os.makedirs(os.path.join(tst, "transcript"))
    with open(os.path.join(tst, "transcript", "random_submission.csv"), "w") as fh:
        fh.write("id,label\n" + "".join(f"{i},X\n" for i in range(n_lines)))
    preds = os.path.join(root, "pred-test.csv")
    with open(preds, "w") as fh:
        fh.write("id,label\n" + "".join(f"{i},{s}\n" for i, s in enumerate(lines)))
    return preds, tst, sum(map(len, lines))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lines", type=int, default=256)
    parser.add_argument("--runs", type=int, default=2)
    parser.add_argument("--seed", type=int, default=11785)
    parser.add_argument("--work", default=None)
    cli = parser.parse_args()
    require_device("cuda", "time_lminfer")
    card = smi_name_and_power()
    work = cli.work or tempfile.mkdtemp(prefix="time-lminfer-")
    exp = make_experiment(os.path.join(work, "lm-exp"), cli.seed)
    preds, tst, chars = make_lines(os.path.join(work, "lm-data"), cli.lines, cli.seed)
    cfg_path = os.path.join(work, "lm-infer.yml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump({"TST_DIR": preds, "TST_FOLDER": tst, "exp_folder": exp,
                        "batch_size": 256, "run_all": False, "epoch_num": 1, "run_avg": False,
                        "early_stop": False, "gate_correction": False}, fh)
    args = lminfer.build_argparser().parse_args(["-c", cfg_path, "--device", "cuda"])
    walls = []
    for _ in range(cli.runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lminfer.main(args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    timed = walls[1:] or walls
    print(json.dumps({"card": card, "lines": cli.lines, "chars": chars,
                      "mode": "early_stop: false, both kernel tiers, float32, batch 256",
                      "walls_s": walls, "lines_per_s": cli.lines / statistics.median(timed)}))


if __name__ == "__main__":
    main()
