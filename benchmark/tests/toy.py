"""A toy cell built as a later change would add one: new files (a
configuration, a mix, a metric reader) and new entries in a copy of
BENCHMARK.json, in a copy of the benchmark; no file of the benchmark edited."""

import json
import os
import shutil

import torch

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TOY_METRIC = '''"""Device kernels a traced step (a toy reader)."""


def read(ctx):
    n = sum(1 for e in ctx.events if e.device)
    return n / ctx.steps if n else None
'''


# the toy cell's own limits, above what the toy reads in bfloat16 (loss
# ~1e-4, gradient ~4e-3, change ~1e-2) and far below what each planted
# fault reads (0.1 to 1)
TOY_LIMITS = {"loss_gap": 0.01, "grad_gap": 0.05, "change_gap": 0.05, "grad_leaf_gap": 0.05}


def make_root(tmp: str, dtype: str = "bfloat16") -> str:
    """A copy of the benchmark in ``tmp`` with the toy cell ``toy.train``
    added, with its own limits."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    with open(os.path.join(ROOT, "benchmark", "configs", "base-las.json")) as fh:
        cfg = json.load(fh)
    m = cfg["model"]
    m["listener_configs"].update(uniform_hid_dim=16)
    m["speller_configs"].update(att_proj_dim=8, dec_emb_dim=16, dec_lstm_hid_dim=16,
                                dec_lstm_out_dim=8, CHR_MAX_STEPS=10, att_heads=2)
    cfg.update(batch_size=4, pad_time_multiple=16, pad_label_multiple=8, compute_dtype=dtype)
    with open(os.path.join(tmp, "benchmark", "configs", "toy.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(ROOT, "benchmark", "traffic", "train-longform.json")) as fh:
        mix = json.load(fh)
    mix.update(utterances=12, words=[1, 3], max_frames=64, batch_size=4)
    with open(os.path.join(tmp, "benchmark", "traffic", "toy-train-longform.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(tmp, "benchmark", "metrics", "toy_kernels.py"), "w") as fh:
        fh.write(TOY_METRIC)
    spec["configs"].append({"name": "toy", "source": "https://example.org/toy",
                            "file": "benchmark/configs/toy.json", "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": "toy.train", "config": "toy",
                              "traffic": "toy-train-longform", "chips": 1, "why": "toy"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in metric:
            metric["workloads"].append("toy.train")
    spec["per_layer"].append({"name": "toy_kernels", "unit": "count", "better": "lower",
                              "source": "device_trace", "layer": "device",
                              "moves": "train_utt_s", "workloads": ["toy.train"]})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    with open(os.path.join(tmp, "benchmark", "limits", "toy.train.json"), "w") as fh:
        json.dump(TOY_LIMITS, fh)
    return tmp


def run_cell(root: str, name: str, seed: int = 2**31 + 11, trace: bool = False,
             faults: tuple = (), seconds: float = 0.0):
    """Drive a whole run of a cell on the CPU, past the harness's look for a
    card: returns (outcome, run)."""
    cell = harness.resolve(name, root)
    run = harness.Run(cell, seed, seconds, trace, torch.device("cpu"), 0.0, faults)
    return harness.entry(cell).run(run), run
