"""Metric logging: stdout, the final ``log.json`` and optional wandb
(counterpart of the JAX ``utils/logging.py``).

wandb is optional as there: where the package or the network is missing the
logger says so once and goes on printing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, use_wandb: bool = False, wandb_configs: Optional[dict] = None,
                 run_config: Optional[dict] = None):
        self.wandb = None
        self.run_name = None
        if use_wandb:
            try:
                import wandb

                wandb.init(**(wandb_configs or {}), config=run_config)
                self.wandb = wandb
                self.run_name = wandb.run.name
            except Exception as exc:  # missing package / no network
                print(f"[logger] wandb unavailable ({exc}); falling back to stdout")

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def print(self, message: str) -> None:
        print(message, flush=True)

    def finish(self) -> None:
        if self.wandb is not None:
            self.wandb.finish()


def dump_log_json(path: str, train_history: dict, dev_history: dict) -> None:
    """Final log.json of metric histories (reference: src/train.py:630-632)."""
    with open(path, "w") as fh:
        json.dump([train_history, dev_history], fh, indent=4)


def experiment_folder(exp_root: str, run_name: Optional[str] = None) -> str:
    """Create experiments/<run-or-timestamp>/{imgs,ckpts,preds}."""
    name = run_name or time.strftime("%Y%m%d-%H%M%S")[2:]
    tgt = os.path.join(exp_root, name)
    for sub in ("imgs", "ckpts", "preds"):
        os.makedirs(os.path.join(tgt, sub), exist_ok=True)
    return tgt
