"""The scaled-LAS speller stripped one mechanism at a time, each piece timed
against its FLOP bound, beside the fused kernel tier (counterpart of the
repository's ``tools/speller_control.py``).

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.speller_control [--device cpu] [--out <file>]

Variants (plain PyTorch loops under autograd over L teacher-forced steps,
bfloat16, at the JAX tool's widths: B=128, Te=192, L=192, H1 1024, H2 256,
P 256, emb 512, 4 heads; ``make_variant`` builds them):

  * full        — embed + cell 1 + cell 2 + attention + tied classifier
  * noattn      — the context frozen at its t = -1 value: the same chain
                  without the per-step K/V reads and softmax
  * cells       — the bare two-cell recurrence on a fixed input
  * attn_only   — the per-step attention on a fixed query, no recurrence
  * cls_batched — the classifier over all B x L rows as one product

Each variant's wall is timed forward (and, for the first three, forward +
backward: the global norm of the speller's gradient) and read against its
analytic product FLOPs (``make_flops``, the JAX tool's formulas) over
``utils/flops.py::peak_flops_per_chip`` (989.4 TFLOP/s dense bf16 on the
H100; None elsewhere, and then no MFU). In place of the JAX tool's chunk-cap
A/B (``TPU_LAS_BIGH_BB``, which has no meaning on the card) the fused tier
is timed: ``speller_apply`` with ``decoder_impl: pallas``, tf_rate 0.9 and
dropout 0.3, forward (#8's train form) and forward + backward (#8's train
form, then #9).

Prints one JSON object (the shapes, the peak, ``walls_ms``, ``mfu``, the
card and its power limit). ``--out`` writes it to a file of the caller's
choosing; by default nothing is written. ``--steps`` / ``--windows`` set
the timing (best of ``windows`` windows of ``steps`` calls after 2 warm-up
calls).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    cast_params,
    draw_train_noise,
    las_config_from_dicts,
    las_init,
    speller_apply,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops.attention import (
    cross_attention_precompute,
    cross_attention_step,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops.lstm import lstm_cell_step
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import card_and_power, require_device
from attention_based_e2e_asr_dnn_tpu_torch.training.loss import masked_ce_loss
from attention_based_e2e_asr_dnn_tpu_torch.training.optim import global_norm
from attention_based_e2e_asr_dnn_tpu_torch.utils.flops import peak_flops_per_chip

B, TE, L, F = 128, 192, 192, 15
H1, H2, PROJ, EMB, HEADS, V = 1024, 256, 256, 512, 4, 30
DTYPE = torch.bfloat16
WARMUP = 2
VARIANTS = ("full", "noattn", "cells")


def scaled_cfg(decoder_impl: str, h1: int = H1, h2: int = H2, proj: int = PROJ,
               emb: int = EMB, heads: int = HEADS):
    """The scaled-LAS config of the JAX tool (widths overridable for a toy
    run)."""
    return las_config_from_dicts(
        dict(input_dim=F, uniform_hid_dim=h1, lstm_layers=1, plstm_layers=3,
             init_dropout=0.3, mid_dropout=0.3, final_dropout=0.35,
             lstm_impl="pallas", remat=True),
        dict(att_proj_dim=proj, att_heads=heads, att_dropout=0.0,
             dec_emb_dim=emb, dec_emb_dropout=0.0, dec_lstm_hid_dim=h1,
             dec_lstm_out_dim=h2, dec_lstm_dropout=0.3, CHR_MAX_STEPS=600,
             decoder_impl=decoder_impl))


def make_variant(variant: str, cfg, dtype: torch.dtype = DTYPE) -> Callable:
    """``run(speller_params, enc_h, enc_l, y) -> outputs (L, B, .)``: the
    teacher-forced decode loop with the pieces ``variant`` strips (the JAX
    tool's ``make_variant``): step t feeds the gold embedding of ``y[:, t]``
    and the context into cell 1 (``cells``: a fixed zero input), cell 2;
    ``full`` attends with cell 2's output and classifies [q_proj; context]
    with the tied embedding, ``noattn`` keeps the t = -1 context and
    classifies [h2; context][:, :emb], ``cells`` returns h2."""
    spc = cfg.speller
    heads = spc.att_heads

    def run(sp, enc_h, enc_l, y):
        batch = enc_h.shape[0]
        sp = cast_params(sp, dtype)
        emb = sp["char_emb"]
        width = emb.shape[1]
        cache = cross_attention_precompute(sp["attention"], enc_h, enc_l, heads)

        def init(name):
            return sp[name].expand(batch, sp[name].shape[1])

        h1, c1, h2, c2 = (init(n) for n in ("init_h1", "init_c1", "init_h2", "init_c2"))
        ctx, _, _ = cross_attention_step(sp["attention"], cache, init("init_query"), heads,
                                         spc.legacy_scale)
        gold = emb[y.long()]                                  # (B, L, emb)
        fixed_in = torch.zeros(batch, width + ctx.shape[1], dtype=dtype, device=enc_h.device)
        outs = []
        for t in range(y.shape[1]):
            cell_in = fixed_in if variant == "cells" else torch.cat([gold[:, t], ctx], dim=-1)
            h1, c1 = lstm_cell_step(sp["cell1"], cell_in, h1, c1)
            h2, c2 = lstm_cell_step(sp["cell2"], h1, h2, c2)
            if variant == "full":
                ctx, _, qp = cross_attention_step(sp["attention"], cache, h2, heads,
                                                  spc.legacy_scale)
                outs.append(torch.cat([qp, ctx], dim=-1) @ emb.T)
            elif variant == "noattn":
                outs.append(torch.cat([h2, ctx], dim=-1)[:, :width] @ emb.T)
            else:
                outs.append(h2)
        return torch.stack(outs)

    return run


def make_flops(batch: int = B, te: int = TE, steps: int = L, h1: int = H1, h2: int = H2,
               proj: int = PROJ, emb: int = EMB, vocab: int = V) -> dict:
    """The analytic forward product FLOPs of each variant (the JAX tool's
    ``cell1`` / ``cell2`` / ``attn`` / ``cls`` lines)."""
    cell1 = 2 * batch * (emb + proj + h1) * 4 * h1 * steps
    cell2 = 2 * batch * (h1 + h2) * 4 * h2 * steps
    attn = 2 * batch * (h2 * proj + 2 * te * proj) * steps   # q proj + scores + context
    cls = 2 * batch * (proj + proj) * vocab * steps
    return {"full": cell1 + cell2 + attn + cls, "noattn": cell1 + cell2 + cls,
            "cells": cell1 + cell2, "attn_only": attn, "cls": cls}


def attn_only(sp, cfg, enc_h, enc_l, steps: int, dtype: torch.dtype = DTYPE):
    """The per-step attention on a fixed zero query, no recurrence: the sum
    of every step's context (float32)."""
    spc = cfg.speller
    sp = cast_params(sp, dtype)
    cache = cross_attention_precompute(sp["attention"], enc_h, enc_l, spc.att_heads)
    q = torch.zeros(enc_h.shape[0], spc.dec_lstm_out_dim, dtype=dtype, device=enc_h.device)
    acc = torch.zeros((), device=enc_h.device)
    for _ in range(steps):
        ctx, _, _ = cross_attention_step(sp["attention"], cache, q, spc.att_heads,
                                         spc.legacy_scale)
        acc = acc + ctx.float().sum()
    return acc


def cls_batched(sp, wide, dtype: torch.dtype = DTYPE):
    """The classifier over all rows at once: (B*L, 2P) @ emb^T, summed."""
    return (wide @ sp["char_emb"].to(dtype).T).float().sum()


def bench(fn: Callable, device, steps: int, windows: int) -> float:
    """Seconds a call: the best of ``windows`` windows of ``steps`` calls
    after ``WARMUP`` calls, each window ending when the device has
    finished."""
    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(WARMUP):
        fn()
    sync()
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        sync()
        best = min(best, (time.perf_counter() - t0) / steps)
    return best


def inputs(cfg, device, batch: int = B, te: int = TE, steps: int = L, seed: int = 0):
    """Seeded speller parameters and the decode's inputs: enc_h (B, Te,
    2 H1) normal in the compute dtype, full lengths, labels and their
    lengths."""
    params = las_init(cfg, torch.Generator().manual_seed(seed))["speller"].to(device)
    rng = np.random.default_rng(seed)
    enc_dim = cfg.listener.enc_out_dim
    enc_h = torch.from_numpy(rng.normal(size=(batch, te, enc_dim)).astype(np.float32))
    enc_h = enc_h.to(device).to(DTYPE)
    enc_l = torch.full((batch,), te, dtype=torch.int32, device=device)
    y = torch.from_numpy(rng.integers(0, cfg.speller.dec_vocab_size, size=(batch, steps))
                         .astype(np.int32)).to(device)
    ly = torch.full((batch,), steps, dtype=torch.int32, device=device)
    return params, enc_h, enc_l, y, ly


def fused_fns(params, cfg, enc_h, enc_l, y, ly, seed: int = 8, tf_rate: float = 0.9):
    """(forward, forward + backward) of the fused tier: ``speller_apply``
    with ``decoder_impl: pallas`` in training, one pass's draws (tf_rate
    0.9's coins, dropout 0.3) fixed from ``seed``. The forward returns the
    logits' sum; forward + backward the global norm of the speller's
    gradient of the masked cross-entropy."""
    spc = cfg.speller
    gen = torch.Generator(device=enc_h.device).manual_seed(seed)
    draws = draw_train_noise(cfg, enc_h.shape[0], y.shape[1], gen, enc_h.device)
    leaves = list(params.parameters())

    def fwd():
        with torch.no_grad():
            out = speller_apply(params, spc, enc_h, enc_l, y, tf_rate=tf_rate, train=True,
                                draws=draws)
            return out.logits.float().sum()

    def fwd_bwd():
        out = speller_apply(params, spc, enc_h, enc_l, y, tf_rate=tf_rate, train=True,
                            draws=draws)
        loss = masked_ce_loss(out.logits, y, ly)[0]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return global_norm([g for g in grads if g is not None])

    return fwd, fwd_bwd


def run(device="cuda", steps: int = 8, windows: int = 3, widths: Optional[dict] = None) -> dict:
    """Every variant and the fused tier at the JAX tool's widths (``widths``
    overrides B, Te, L and the model widths for a toy run)."""
    w = {"batch": B, "te": TE, "steps": L, "h1": H1, "h2": H2, "proj": PROJ, "emb": EMB,
         "heads": HEADS, **(widths or {})}
    model = {k: w[k] for k in ("h1", "h2", "proj", "emb", "heads")}
    device = torch.device(device)
    peak = peak_flops_per_chip(device) if device.type == "cuda" else None
    cfg = scaled_cfg("scan", **model)
    params, enc_h, enc_l, y, ly = inputs(cfg, device, w["batch"], w["te"], w["steps"])
    flops = make_flops(w["batch"], w["te"], w["steps"], w["h1"], w["h2"], w["proj"], w["emb"],
                       cfg.speller.dec_vocab_size)
    card, power = card_and_power(device)
    results = {"shapes": dict(B=w["batch"], Te=w["te"], L=w["steps"], h1=w["h1"], h2=w["h2"],
                              proj=w["proj"], heads=w["heads"], emb=w["emb"], dtype="bfloat16"),
               "peak_flops": peak, "flops": flops, "walls_ms": {}, "mfu": {},
               "device": str(device), "card": card, "power_limit_w": power}

    def record(name, seconds, n_flops):
        results["walls_ms"][name] = seconds * 1e3
        results["mfu"][name] = None if peak is None else n_flops / seconds / peak

    leaves = list(params.parameters())
    for variant in VARIANTS:
        fn = make_variant(variant, cfg)
        with torch.no_grad():
            t = bench(lambda: fn(params, enc_h, enc_l, y), device, steps, windows)
        record(f"{variant}_fwd", t, flops[variant])

        def grad_norm(fn=fn):
            out = fn(params, enc_h, enc_l, y).float().sum()
            grads = torch.autograd.grad(out, leaves, allow_unused=True)
            return global_norm([g for g in grads if g is not None])

        record(f"{variant}_fwdbwd", bench(grad_norm, device, steps, windows),
               3 * flops[variant])
    with torch.no_grad():
        record("attn_only_fwd", bench(lambda: attn_only(params, cfg, enc_h, enc_l, w["steps"]),
                                      device, steps, windows), flops["attn_only"])
        wide = torch.from_numpy(np.random.default_rng(1).normal(
            size=(w["batch"] * w["steps"], 2 * w["proj"])).astype(np.float32)).to(device)
        wide = wide.to(DTYPE)
        record("cls_batched", bench(lambda: cls_batched(params, wide), device, steps, windows),
               flops["cls"])
    pcfg = scaled_cfg("pallas", **model)
    fwd, fwd_bwd = fused_fns(params, pcfg, enc_h, enc_l, y, ly)
    record("pallas_fwd", bench(fwd, device, steps, windows), flops["full"])
    record("pallas_fwdbwd", bench(fwd_bwd, device, steps, windows), 3 * flops["full"])
    return results


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    parser.add_argument("--steps", type=int, default=8, help="calls a timed window")
    parser.add_argument("--windows", type=int, default=3, help="timed windows (the best kept)")
    parser.add_argument("--out", default=None,
                        help="write the JSON object here (default: nowhere)")
    return parser


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    require_device(args.device, "speller_control")
    results = run(args.device, args.steps, args.windows)
    print(json.dumps(results))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return results


if __name__ == "__main__":
    main()
