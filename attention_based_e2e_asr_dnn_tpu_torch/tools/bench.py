"""Training throughput of the port on one card: the counterpart of the
repository's ``bench.py``, the same step and the same shapes.

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.bench
    BENCH_ARCH=scaled python -m attention_based_e2e_asr_dnn_tpu_torch.tools.bench
    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.bench --device cpu   # a toy check

``BENCH_ARCH`` is ``base`` (``configs/base-las.yml``'s model block) or
``scaled`` (``configs/scaled-las.yml``'s: H=1024, 4 heads, ``remat``);
``BENCH_BATCH`` the batch (default 128). The step is ``bench.py``'s: seeded
parameters, AdamW (amsgrad, lr 1e-3, wd 5e-6), clip 5, bfloat16 compute,
SpecAugment and dropout on, tf_rate 0.9, both kernel tiers.

Dense: one seeded batch of B=128, T=1536, L=192 on the card, 2 warm-up
steps, then 8 timed steps (host clock, ending in
``torch.cuda.synchronize()``). Realistic: ``bench.py``'s bucket plan,
1024 utterance lengths drawn from the long-form synthetic corpus
(``make_synthetic_data``'s generator, 25-45 words), sorted into batches and
padded to multiples of 256 frames and 32 labels; each distinct shape timed
the same way and weighted by its batches.

Prints one JSON line: ``metric``, ``value`` (utt/s dense), ``unit``,
``s_per_step``, ``value_realistic``, ``pad_waste_frac``, ``mfu`` (the
analytic FLOPs of ``utils/flops.py`` over the card's bf16 peak; None where
the peak is unknown), ``flops_per_step``, ``peak_mib`` (dense),
``launches_per_step`` (the kernels' launches in a dense step), ``arch``,
``batch``, ``device``, ``card`` and ``power_limit_w`` (``nvidia-smi``).
There is no ``vs_baseline``: no TPU or CPU number is a yardstick for the
card. A failure in either mode raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    las_apply,
    las_config_from_dicts,
    las_init,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build
from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda, speller_cuda
from attention_based_e2e_asr_dnn_tpu_torch.tools.make_synthetic_data import sample_utterance
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import card_and_power, require_device
from attention_based_e2e_asr_dnn_tpu_torch.training.optim import build_optimizer
from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
    create_train_state,
    make_train_step,
)
from attention_based_e2e_asr_dnn_tpu_torch.utils import flops as flops_mod

TIME_STEPS = 1536
LABEL_LEN = 192
N_FEATS = 15
WARMUP_STEPS = 2
MEASURE_STEPS = 8

# the model blocks of configs/base-las.yml and configs/scaled-las.yml
_BASE_LISTENER = {"input_dim": N_FEATS, "uniform_hid_dim": 512, "lstm_layers": 1,
                  "plstm_layers": 3, "bidirectional": True, "init_dropout": 0.3,
                  "mid_dropout": 0.3, "final_dropout": 0.35, "lstm_impl": "pallas"}
_BASE_SPELLER = {"att_proj_dim": 256, "att_heads": 1, "att_dropout": 0.0,
                 "dec_emb_dim": 512, "dec_emb_dropout": 0.0, "dec_lstm_hid_dim": 512,
                 "dec_lstm_out_dim": 256, "dec_lstm_dropout": 0.3, "CHR_MAX_STEPS": 600,
                 "USE_GREEDY": True, "decoder_impl": "pallas"}
MODELS = {
    "base": {"listener_configs": _BASE_LISTENER, "speller_configs": _BASE_SPELLER},
    "scaled": {"listener_configs": {**_BASE_LISTENER, "uniform_hid_dim": 1024, "remat": True},
               "speller_configs": {**_BASE_SPELLER, "att_heads": 4,
                                   "dec_lstm_hid_dim": 1024}},
}


def sample_realistic_lengths(n_utts: int, seed: int = 0):
    """(frames, chars) per utterance from the long-form synthetic corpus's
    generative process (``make_synthetic_data --words 25 45``, ~1250 frames
    and ~180 characters on average); ``bench.py``'s draw."""
    rng = np.random.default_rng(seed)
    frames, chars = [], []
    for _ in range(n_utts):
        text, durations = sample_utterance(rng, words_min=25, words_max=45)
        frames.append(int(durations.sum()))
        chars.append(len(text))
    return np.array(frames), np.array(chars)


def plan_realistic_batches(batch: int, pad_time: int = 256, pad_label: int = 32,
                           n_utts: int = 1024, seed: int = 0):
    """The ``BucketBatcher`` policy over those lengths: sorted by frames,
    batches of ``batch``, T and L padded up to their multiples. Returns
    [(t_pad, l_pad, lx, ly)] a batch and the padded frames' share."""
    frames, chars = sample_realistic_lengths(n_utts, seed)
    order = np.argsort(frames)
    frames, chars = frames[order], chars[order]
    plans = []
    real_frames = padded_frames = 0
    for i in range(0, n_utts - n_utts % batch, batch):
        fx, cx = frames[i:i + batch], chars[i:i + batch]
        t_pad = int(-(-fx.max() // pad_time) * pad_time)
        l_pad = int(-(-cx.max() // pad_label) * pad_label)
        plans.append((t_pad, l_pad, fx.astype(np.int32), cx.astype(np.int32)))
        real_frames += int(fx.sum())
        padded_frames += t_pad * batch
    return plans, 1.0 - real_frames / padded_frames


def build_step_and_state(model: dict, device: str = "cuda", seed: int = 0):
    """``bench.py``'s step on ``model`` (a model block): parameters from
    ``seed``, the step's noise from ``seed + 1``. Returns (cfg, step, state,
    optimizer)."""
    cfg = las_config_from_dicts(model["listener_configs"], model["speller_configs"])
    cuda_build.build_for(torch.device(device), cfg.listener.lstm_impl,
                         cfg.speller.decoder_impl)
    params = las_init(cfg, torch.Generator().manual_seed(seed))
    opt = build_optimizer("adamw", {"lr": 1e-3, "weight_decay": 5e-6, "amsgrad": True},
                          grad_norm=5.0)
    state = create_train_state(params, opt, seed=seed + 1, device=device)

    def apply_fn(p, x, lx, **kwargs):
        return las_apply(p, cfg, x, lx, **kwargs)

    step = make_train_step(apply_fn, opt, compute_dtype=torch.bfloat16, use_specaug=True)
    return cfg, step, state, opt


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_shape(step, state, t_pad: int, l_pad: int, lx, ly, rng, device):
    """Seconds a step for one (t_pad, l_pad) batch: the inputs on the device
    (the Trainer's prefetch overlaps the copy), ``WARMUP_STEPS`` steps, then
    ``MEASURE_STEPS`` timed steps chained through ``state`` and ending in a
    synchronize. Returns (state, seconds, launches a timed step)."""
    steps = MEASURE_STEPS
    dev = torch.device(device)
    batch = len(lx)
    x = torch.from_numpy(rng.normal(size=(batch, t_pad, N_FEATS)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 30, size=(batch, l_pad)).astype(np.int32)).to(dev)
    lxd = torch.as_tensor(np.asarray(lx, np.int32)).to(dev)
    lyd = torch.as_tensor(np.asarray(ly, np.int32)).to(dev)
    for _ in range(WARMUP_STEPS):
        state, metrics, _ = step(state, x, lxd, y, lyd, 0.9, 1e-3)
    _sync(dev)
    lstm_cuda.reset_launch_counts()
    speller_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics, _ = step(state, x, lxd, y, lyd, 0.9, 1e-3)
    _sync(dev)
    seconds = (time.perf_counter() - t0) / steps
    if not bool(metrics["finite"]):
        raise RuntimeError(f"bench: a step at T={t_pad}, L={l_pad} was not finite")
    launches = {k: v / steps
                for k, v in {**lstm_cuda.LAUNCHES, **speller_cuda.LAUNCHES}.items() if v}
    return state, seconds, launches


def measure_realistic(step, state, batch: int, device):
    """utt/s over the realistic bucket plan: each distinct (t_pad, l_pad)
    timed as the dense batch is and weighted by its batches. Returns (utt/s, pad waste,
    [((t_pad, l_pad), batches)])."""
    plans, waste = plan_realistic_batches(batch)
    counts: dict = {}
    example = {}
    for t_pad, l_pad, lx, ly in plans:
        counts[(t_pad, l_pad)] = counts.get((t_pad, l_pad), 0) + 1
        example[(t_pad, l_pad)] = (lx, ly)
    rng = np.random.default_rng(1)
    total = 0.0
    for (t_pad, l_pad), count in sorted(counts.items()):
        lx, ly = example[(t_pad, l_pad)]
        state, sec, _ = measure_shape(step, state, t_pad, l_pad, lx, ly, rng, device)
        total += sec * count
    return batch * len(plans) / total, waste, sorted(counts.items())


def run(arch: str, batch: int, device: str = "cuda") -> dict:
    """The bench's record for ``arch`` at ``batch`` on ``device``."""
    time_steps, label_len = TIME_STEPS, LABEL_LEN
    if arch not in MODELS:
        raise ValueError(f"BENCH_ARCH must be 'base' or 'scaled', got {arch!r}")
    dev = require_device(device, "bench")
    cfg, step, state, _ = build_step_and_state(MODELS[arch], device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(0)
    state, s_step, launches = measure_shape(
        step, state, time_steps, label_len, np.full((batch,), time_steps, np.int32),
        np.full((batch,), label_len, np.int32), rng, device)
    peak = torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None
    flops = flops_mod.las_train_step_flops(cfg, batch, time_steps, label_len)
    value_realistic, waste, shapes = measure_realistic(step, state, batch, device)
    card, power = card_and_power(device)
    return {
        "metric": "train utterances/sec/card",
        "value": batch / s_step,
        "unit": "utt/s",
        "s_per_step": s_step,
        "value_realistic": value_realistic,
        "pad_waste_frac": waste,
        "realistic_shapes": [[t, l, n] for (t, l), n in shapes],
        "mfu": flops_mod.mfu(flops, s_step, device),
        "flops_per_step": flops,
        "peak_mib": peak,
        "launches_per_step": launches,
        "arch": arch,
        "batch": batch,
        "shape": [batch, time_steps, label_len],
        "device": str(dev),
        "card": card,
        "power_limit_w": power,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="training throughput of the port on one card")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; cuda without a card raises")
    args = ap.parse_args(argv)
    result = run(os.environ.get("BENCH_ARCH", "base"),
                 int(os.environ.get("BENCH_BATCH", "128")), args.device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
