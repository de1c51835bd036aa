"""Where a train step's time goes on the card, piece by piece (the
counterpart of the repository's ``tools/profile_step.py``).

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.profile_step
    PROF_ARCH=scaled python -m attention_based_e2e_asr_dnn_tpu_torch.tools.profile_step
    PROF_DECODER=scan python -m attention_based_e2e_asr_dnn_tpu_torch.tools.profile_step

At ``tools/bench.py``'s shapes and step (B=128, T=1536, L=192, bfloat16,
``PROF_ARCH`` base or scaled, both kernel tiers unless ``PROF_DECODER=scan``)
it times: the full train step; the listener forward, and forward with
backward; the speller forward, and forward with backward, given an encoder
output; the joint forward (loss) and forward with backward, no optimizer;
the full step without the NaN guard; SpecAugment; the optimizer update
alone. Each row: 2 calls of warm-up, then the best of 3 windows of 8 calls,
each window between two CUDA events and ending in
``torch.cuda.synchronize()`` (on the CPU the host clock). A table follows
with each row's MFU (``utils/flops.py``'s FLOPs over the card's bf16 peak)
and the residual of the full step over the sum of its parts. A row that
fails raises.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.data.specaug import draw_specaug, specaugment
from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    draw_train_noise,
    las_apply,
    listener_apply,
    speller_apply,
)
from attention_based_e2e_asr_dnn_tpu_torch.tools import bench
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import card_and_power, require_device
from attention_based_e2e_asr_dnn_tpu_torch.training.loss import masked_ce_loss
from attention_based_e2e_asr_dnn_tpu_torch.training.optim import global_norm
from attention_based_e2e_asr_dnn_tpu_torch.training.steps import make_train_step
from attention_based_e2e_asr_dnn_tpu_torch.utils.flops import (
    las_train_step_flops,
    listener_flops,
    peak_flops_per_chip,
    speller_flops,
)

BATCH, T, L = 128, 1536, 192
WARMUP, STEPS, WINDOWS = 2, 8, 3
PARTS = ("listener fwd+bwd", "speller fwd+bwd", "specaug", "optimizer update")


def time_call(fn: Callable, device: torch.device, warmup: int = WARMUP,
              steps: int = STEPS, windows: int = WINDOWS) -> float:
    """Seconds a call of ``fn``: the best of ``windows`` windows of
    ``steps`` calls after ``warmup``; CUDA events on a card."""
    for _ in range(warmup):
        fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(windows):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            seconds = time.perf_counter() - t0
        best = min(best, seconds / steps)
    return best


def profile_rows(model: dict, batch: int = BATCH, time_steps: int = T,
                 label_len: int = L, device: str = "cuda", warmup: int = WARMUP,
                 steps: int = STEPS, windows: int = WINDOWS) -> List[dict]:
    """The rows, each {"name", "ms", "flops", "mfu"} (``flops`` and ``mfu``
    None for the rows the FLOPs model does not count)."""
    dev = require_device(device, "profile_step")
    dtype = torch.bfloat16
    cfg, full, state, opt = bench.build_step_and_state(model, device)
    params = list(state.params.parameters())
    lparams = list(state.params["listener"].parameters())
    sparams = list(state.params["speller"].parameters())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(batch, time_steps, bench.N_FEATS))
                         .astype(np.float32)).to(dev)
    xb = x.to(dtype)
    lx = torch.full((batch,), time_steps, dtype=torch.int32, device=dev)
    y = torch.from_numpy(rng.integers(0, 30, size=(batch, label_len)).astype(np.int32)).to(dev)
    ly = torch.full((batch,), label_len, dtype=torch.int32, device=dev)
    enc_t = time_steps // cfg.listener.time_reduction
    enc_h = torch.from_numpy(rng.normal(size=(batch, enc_t, cfg.listener.enc_out_dim))
                             .astype(np.float32)).to(dev, dtype)
    enc_l = torch.full((batch,), enc_t, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    draws = draw_train_noise(cfg, batch, label_len, gen, dev)
    spec = draw_specaug(batch, 6, 200, False, gen, dev)
    tf, lr = 0.9, 1e-3

    def apply_fn(p, x_, lx_, **kwargs):
        return las_apply(p, cfg, x_, lx_, **kwargs)

    no_guard = make_train_step(apply_fn, opt, compute_dtype=dtype, use_specaug=True,
                               nan_guard=False)

    def run_full(step):
        def go():
            _, m, _ = step(state, x, lx, y, ly, tf, lr)
            return m["loss"]
        return go

    def listen():
        return listener_apply(state.params["listener"], cfg.listener, xb, lx, True,
                              draws.listener_masks)[0]

    def lst_fwd():
        with torch.no_grad():
            return listen().sum()

    def lst_fwdbwd():
        return global_norm(torch.autograd.grad(listen().sum(), lparams))

    def spell_loss():
        out = speller_apply(state.params["speller"], cfg.speller, enc_h, enc_l, y, tf,
                            False, True, draws)
        return masked_ce_loss(out.logits, y, ly)[0]

    def sp_fwd():
        with torch.no_grad():
            return spell_loss()

    def sp_fwdbwd():
        return global_norm(torch.autograd.grad(spell_loss(), sparams))

    def joint_loss():
        out = las_apply(state.params, cfg, specaugment(x, spec).to(dtype), lx, dec_y=y,
                        tf_rate=tf, train=True, draws=draws)
        return masked_ce_loss(out.logits, y, ly)[0]

    def joint_fwd():
        with torch.no_grad():
            return joint_loss()

    def joint_fwdbwd():
        loss = joint_loss()
        return loss, global_norm(torch.autograd.grad(loss, params))

    def aug():
        return specaugment(x, draw_specaug(batch, 6, 200, False, gen, dev))

    ones = [torch.ones_like(p) for p in params]

    def optimizer():
        with torch.no_grad():
            updates, _ = opt.update(ones, state.opt_state, params, lr)
            return [p + u for p, u in zip(params, updates)][-1]

    lf = listener_flops(cfg, batch, time_steps)
    sf = speller_flops(cfg, batch, label_len, enc_t)
    jf = las_train_step_flops(cfg, batch, time_steps, label_len)
    table = (("full train step", run_full(full), jf), ("listener fwd", lst_fwd, lf),
             ("listener fwd+bwd", lst_fwdbwd, 3 * lf), ("speller fwd", sp_fwd, sf),
             ("speller fwd+bwd", sp_fwdbwd, 3 * sf), ("joint fwd (loss)", joint_fwd, jf // 3),
             ("joint fwd+bwd", joint_fwdbwd, jf), ("full step, no guard", run_full(no_guard), jf),
             ("specaug", aug, None), ("optimizer update", optimizer, None))
    peak = peak_flops_per_chip(dev)
    rows = []
    for name, fn, flops in table:
        seconds = time_call(fn, dev, warmup, steps, windows)
        rows.append({"name": name, "ms": seconds * 1e3, "flops": flops,
                     "mfu": flops / seconds / peak if flops and peak else None})
    return rows


def format_table(rows: List[dict], header: str) -> str:
    lines = [header, f"{'component':<22}{'ms':>10}{'MFU':>8}"]
    for r in rows:
        mfu = f"{r['mfu']:>8.3f}" if r["mfu"] is not None else f"{'-':>8}"
        lines.append(f"{r['name']:<22}{r['ms']:>10.3f}{mfu}")
    known = sum(r["ms"] for r in rows if r["name"] in PARTS)
    lines.append(f"{'sum of parts':<22}{known:>10.3f}")
    lines.append(f"{'residual (full-sum)':<22}{rows[0]['ms'] - known:>10.3f}")
    return "\n".join(lines)


def model_for(arch: str, decoder: Optional[str] = None) -> dict:
    """``bench.MODELS[arch]`` with ``decoder_impl`` set to ``decoder``."""
    if arch not in bench.MODELS:
        raise ValueError(f"PROF_ARCH must be 'base' or 'scaled', got {arch!r}")
    model = bench.MODELS[arch]
    if decoder is None:
        return model
    return {**model, "speller_configs": {**model["speller_configs"], "decoder_impl": decoder}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a train step's pieces timed on the card")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; cuda without a card raises")
    args = ap.parse_args(argv)
    arch = os.environ.get("PROF_ARCH", "base")
    rows = profile_rows(model_for(arch, os.environ.get("PROF_DECODER", "pallas")),
                        device=args.device)
    card, power = card_and_power(args.device)
    print(format_table(rows, f"device: {card} ({power} W)  arch {arch}  B={BATCH} T={T} "
                             f"L={L} dtype=bfloat16"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
