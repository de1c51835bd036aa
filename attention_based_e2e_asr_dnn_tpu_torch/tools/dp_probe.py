"""Probe: the data-parallel train and eval steps on the kernels (the
counterpart of the repository's ``tools/dp_mosaic_probe.py``, which runs the
JAX shard_map step with both Pallas tiers on a one-device mesh of the TPU).

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.dp_probe

One ``parallel/dp.py`` train step and one eval step in a one-rank process
group on the card (NCCL), at that probe's shapes: ``configs/base-las.yml``'s
model block with both kernel tiers, bfloat16 compute, SpecAugment on,
B=32, T=512, L=64. Prints one JSON line: the train and eval losses and the
launches of each kernel in the two steps (``ops/lstm_cuda.py`` and
``ops/speller_cuda.py``'s counters). On the card every kernel of the step's
path must have launched at least once, or the probe fails; on the CPU
(``probe("cpu", ...)`` at toy shapes, as the tests run it) the kernels' plain
versions run and nothing launches.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    las_apply,
    las_config_from_dicts,
    las_init,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build, lstm_cuda, speller_cuda
from attention_based_e2e_asr_dnn_tpu_torch.parallel.dp import (
    make_dp_eval_step,
    make_dp_train_step,
)
from attention_based_e2e_asr_dnn_tpu_torch.parallel.mesh import close_mesh, make_mesh
from attention_based_e2e_asr_dnn_tpu_torch.tools.bench import MODELS
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import require_device
from attention_based_e2e_asr_dnn_tpu_torch.training.optim import build_optimizer
from attention_based_e2e_asr_dnn_tpu_torch.training.steps import create_train_state

# the kernels a base-LAS train step and its dev pass launch
PATH_KERNELS = ("lstm_scan_fusedin_train", "lstm_scan_train", "lstm_bwd_dw",
                "speller_decode_train", "speller_decode_bwd",
                "lstm_scan_fusedin", "lstm_scan", "speller_decode")


def probe(device: str = "cuda", batch: int = 32, time_steps: int = 512, labels: int = 64,
          max_steps: int = 0) -> dict:
    """One DP train step and one DP eval step in a one-rank group; the
    losses and the launches of each kernel."""
    dev = require_device(device, "dp_probe")
    speller = dict(MODELS["base"]["speller_configs"])
    if max_steps:
        speller["CHR_MAX_STEPS"] = max_steps
    cfg = las_config_from_dicts(MODELS["base"]["listener_configs"], speller)
    cuda_build.build_for(dev, cfg.listener.lstm_impl, cfg.speller.decoder_impl)
    mesh = make_mesh(1, device=dev)
    try:
        opt = build_optimizer("adamw", {"lr": 1e-3}, grad_norm=5.0)
        state = create_train_state(las_init(cfg, torch.Generator().manual_seed(0)), opt,
                                   seed=1, device=mesh.device)

        def apply_fn(p, x, lx, **kwargs):
            return las_apply(p, cfg, x, lx, **kwargs)

        train_step = make_dp_train_step(apply_fn, opt, mesh, compute_dtype=torch.bfloat16,
                                        use_specaug=True)
        eval_step = make_dp_eval_step(apply_fn, mesh, compute_dtype=torch.bfloat16)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(batch, time_steps, 15)).astype(np.float32))
        lx = torch.full((batch,), time_steps, dtype=torch.int32)
        y = torch.from_numpy(rng.integers(0, 30, size=(batch, labels)).astype(np.int32))
        ly = torch.full((batch,), labels, dtype=torch.int32)
        x, lx, y, ly = (t.to(mesh.device) for t in (x, lx, y, ly))
        lstm_cuda.reset_launch_counts()
        speller_cuda.reset_launch_counts()
        state, metrics, _ = train_step(state, x, lx, y, ly, 0.9, 1e-3)
        train_loss = float(metrics["loss"])
        eval_metrics, _ = eval_step(state.params, x, lx, y, ly)
        eval_loss = float(eval_metrics["loss"])
        launches = {**lstm_cuda.LAUNCHES, **speller_cuda.LAUNCHES}
    finally:
        close_mesh()
    if not (np.isfinite(train_loss) and np.isfinite(eval_loss)):
        raise RuntimeError(f"dp_probe: a loss is not finite ({train_loss}, {eval_loss})")
    if dev.type == "cuda":
        idle = [k for k in PATH_KERNELS if launches[k] == 0]
        if idle:
            raise RuntimeError(f"dp_probe: kernels of the step's path never launched: {idle}")
    return {"probe": "data-parallel steps on the kernels", "ok": True,
            "backend": mesh.backend, "train_loss": train_loss, "eval_loss": eval_loss,
            "launches": {k: launches[k] for k in PATH_KERNELS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(probe(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
