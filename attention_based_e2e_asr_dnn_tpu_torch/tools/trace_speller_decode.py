"""Split a step of the bfloat16 fused decode (``csrc/speller_decode_tc.cu``),
or of its adjoint (``csrc/speller_bwd_tc.cu``, ``--adjoint``), into its
phases on the card and print one JSON line.

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.trace_speller_decode \
        [--adjoint] [--float32]

Builds the source with ``-DDT_TRACE`` beside the normal library (the same
kernels with ``%globaltimer`` stamps at each phase boundary of blocks 0,
G / 2 and G - 1) and launches that build in this process, on the shapes of
``tools/time_speller_kernels.py``: the base-LAS eval decode at B=64 (600
steps) and the training form at B=32 and 128 (192 steps), and the
scaled-LAS training form at B=128. For each block it prints, in
microseconds, the median over the steps (the first and the last left out)
of each stamp's time after block 0's step start (null where the block did
not reach it: a block without a batch row has no attention), and the median
step. The stamps (enum Stamp in the source): a step starts before cell 1's
product; "published" is the release of a phase's counter, "acquired" a wait
for one; the producer's two are its waits for the attention (ctx) and for
cell 1 (h1) of the step.

With ``--adjoint`` it builds ``csrc/speller_bwd_tc.cu`` with ``-DDB_TRACE``
instead and splits a step of the adjoint (192 steps, time running down; the
operands from the training forward) at base-LAS B=32 and 128 and scaled-LAS
B=32 and 128, stamps in the order of ``BWD_STAMPS`` (enum Stamp in that
source): a step starts before the wait for the previous step's (d); then the
attention adjoint (a) and the three products (b) d_q @ wq^T, (c)
dpre2 @ [wih2; whh2]^T, (d) dpre1 @ [whh1; wc1]^T, each "product" at the end
of its wgmma and "published" at its counter's release; the producer's three
are its acquisitions of (a), (b) and (c) before it loads the next product's
input. A block that owns no columns of a product has no stamp there (null).
Every block also stamps its attention adjoint's publish: "attend spread"
gives, per case, the median over the steps of the earliest and the latest
block's publish after block 0's step start and the blocks that were latest
most often (the phase (b) waits for the latest).

With ``--float32`` it builds ``csrc/speller_decode.cu`` with ``-DDF_TRACE``
instead and splits a step of the float32 eval form at the Rewriter's widths
as ``lminfer`` runs it (B=256, Te=608, 600 steps; the shapes of
``time_speller_kernels --rewriter``) and at base-LAS, B=64, stamps in the
order of ``F32_STAMPS`` (enum Stamp in that source): each phase's end in
the block and after its grid barrier ("synced"), and the attention's
sub-phases (of the block's last pass of rows).

With ``--adjoint --float32`` it builds ``csrc/speller_bwd.cu`` with
``-DDA_TRACE`` and splits a step of the float32 adjoint (192 steps, time
running down; the operands from the float32 training forward) at base-LAS
B=128 and scaled-LAS B=32, the shapes of ``chip_smoke.py``'s float32 check,
stamps in the order of ``F32_BWD_STAMPS`` (enum Stamp in that source): a step
starts before the wait for the previous step's (d) of the first item's row
group; then the attention adjoint of the block's items, and for each product
(b), (c), (d) the arrival of its first ring stage ("input") and the release
of its counter ("published"). Beside the stamps, each block's median of the
per-step differences: the waits (for (d) of the last step, then for each
product's input: the row group's counters and the first stage's TMA), the
attention and the three products, and the plan that ran.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.models.las import las_config_from_dicts, las_init
from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
from attention_based_e2e_asr_dnn_tpu_torch.tools.time_speller_kernels import (
    LISTENER,
    SPELLER,
    TE,
    TRAIN_STEPS,
    WIDTHS,
)
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import require_device, smi_name_and_power

# enum Stamp of csrc/speller_decode_tc.cu, in order
STAMPS = ("step", "cell1 product", "cell1 published", "cell2 product", "cell2 published",
          "query published", "q acquired", "q loaded", "scores", "softmax", "context",
          "classifier", "attend published", "producer: attend acquired",
          "producer: cell1 acquired")
# enum Stamp of csrc/speller_bwd_tc.cu, in order
BWD_STAMPS = ("step", "back acquired", "attend published", "cell2 product",
              "cell2 published", "cell1 product", "cell1 published", "back product",
              "back published", "producer: attend acquired", "producer: cell2 acquired",
              "producer: cell1 acquired")
# enum Stamp of csrc/speller_decode.cu, in order
F32_STAMPS = ("step", "cell1", "cell1 synced", "cell2", "cell2 synced", "query",
              "query synced", "q loaded", "scores", "softmax", "context", "classifier",
              "attend")
# enum Stamp of csrc/speller_bwd.cu, in order
F32_BWD_STAMPS = ("step", "back acquired", "attend published", "b input", "b published",
                  "c input", "c published", "d input", "d published")
# (phase, its first stamp, its last) of a float32 adjoint step
F32_BWD_PHASES = (("wait back", "step", "back acquired"),
                  ("attention", "back acquired", "attend published"),
                  ("wait b", "attend published", "b input"), ("(b)", "b input", "b published"),
                  ("wait c", "b published", "c input"), ("(c)", "c input", "c published"),
                  ("wait d", "c published", "d input"), ("(d)", "d input", "d published"))
F32_BWD_CASES = (("base-LAS", 128), ("scaled-LAS", 32))
TRACE_STEPS = 1024  # DT_TRACE_STEPS, DB_TRACE_STEPS, DF_TRACE_STEPS, DA_TRACE_STEPS
MAX_GRID = 128  # DB_MAX_GRID
BLOCKS = ("block 0", "block G/2", "block G-1")
CASES = (("base-LAS", "eval", 64), ("base-LAS", "train", 32), ("base-LAS", "train", 128),
         ("scaled-LAS", "train", 128))
BWD_CASES = (("base-LAS", 32), ("base-LAS", 128), ("scaled-LAS", 32), ("scaled-LAS", 128))


def _split(ns: np.ndarray, steps: int, names: tuple) -> dict:
    """Median step and each stamp's median time after block 0's step start
    (us), the first and last steps left out; null where never stamped."""
    ns = ns[:, :, :steps]
    start = ns[0, 0, 1:-1]

    def after_start(b, e):
        if not ns[b, e, 1:-1].all():
            return None
        return round(float(np.median(ns[b, e, 1:-1] - start)) / 1e3, 3)

    return {"step_us": round(float(np.median(np.diff(ns[0, 0]))) / 1e3, 3),
            **{block: {name: after_start(b, e) for e, name in enumerate(names)}
               for b, block in enumerate(BLOCKS)}}


def trace_adjoint(card: str) -> dict:
    """The adjoint's step split (``--adjoint``)."""
    traced = sc.load_bwd_tc_library(("DB_TRACE",))
    traced.speller_bwd_tc_trace.argtypes = [ctypes.c_void_p]
    traced.speller_bwd_tc_trace.restype = ctypes.c_int
    sc.load_bwd_tc_library = lambda defines=(): traced  # this process launches the traced build
    n_phase = len(BLOCKS) * len(BWD_STAMPS) * TRACE_STEPS
    stamps = np.zeros(n_phase + MAX_GRID * TRACE_STEPS, dtype=np.uint64)

    def read_stamps():  # and zero them on the card
        err = traced.speller_bwd_tc_trace(stamps.ctypes.data)
        if err != 0:
            raise RuntimeError(f"trace_speller_decode: reading the stamps failed with "
                               f"cudaError {err}")
        return stamps.astype(np.int64)

    read_stamps()
    gen = torch.Generator().manual_seed(0)
    out = {"card": card, "kernel": "speller_decode_bwd",
           "unit": "us after block 0's step start", "cases": {}}
    for width, batch in BWD_CASES:
        changes, listener_width = WIDTHS[width][:2]
        cfg = las_config_from_dicts({**LISTENER, "uniform_hid_dim": listener_width},
                                    {**SPELLER, **changes})
        spl = cfg.speller
        params = las_init(cfg, gen)["speller"].cuda()
        lengths = torch.randint(1, TE + 1, (batch,), generator=gen)
        lengths[0], lengths[1] = TE, 1
        enc = torch.randn(batch, TE, cfg.listener.enc_out_dim, generator=gen) * 0.5
        with torch.no_grad():
            operands, _ = sc.decode_operands(params, spl, enc.to(torch.bfloat16).cuda(),
                                             lengths.cuda())
            opts = {**sc.decode_options(spl), "steps": TRAIN_STEPS}
            keep = 1.0 - spl.dec_lstm_dropout
            m1, m2 = (((torch.rand(TRAIN_STEPS, batch, h, generator=gen) < keep)
                       .to(torch.bfloat16) / keep).cuda()
                      for h in (spl.dec_lstm_hid_dim, spl.dec_lstm_out_dim))
            _, wgts, _, saved = sc.speller_decode_train(*operands, **opts, m1=m1, m2=m2)
            k, v, _, _, _, c10, _, c20, _, wc1, whh1, wih2, whh2, _, wq = operands[:15]
            _, gates1, c1, _, gates2, c2, _, _ = saved
            dqup, dctxup = ((torch.randn(TRAIN_STEPS, batch, spl.att_proj_dim, generator=gen)
                             * 0.1).to("cuda", torch.bfloat16) for _ in range(2))

            def run():
                return sc.speller_decode_bwd(k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1,
                                             c1, gates2, c2, wgts, m1, m2, dqup, dctxup, None,
                                             heads=opts["heads"], scale=opts["scale"])

            run()  # a warm-up call, its stamps dropped
            torch.cuda.synchronize()
            read_stamps()
            run()
            torch.cuda.synchronize()
        ns = read_stamps()
        steps = min(TRAIN_STEPS, TRACE_STEPS)
        phases = ns[:n_phase].reshape(len(BLOCKS), len(BWD_STAMPS), TRACE_STEPS)
        case = _split(phases, steps, BWD_STAMPS)
        blocks = min(batch, MAX_GRID)  # the blocks with a batch row
        attend = ns[n_phase:].reshape(MAX_GRID, TRACE_STEPS)[:blocks, 1:steps - 1]
        attend = attend - phases[0, 0, 1:steps - 1]
        latest = np.bincount(attend.argmax(0), minlength=blocks)
        case["attend spread"] = {
            "earliest": round(float(np.median(attend.min(0))) / 1e3, 3),
            "median": round(float(np.median(np.median(attend, 0))) / 1e3, 3),
            "latest": round(float(np.median(attend.max(0))) / 1e3, 3),
            "latest most often (block: steps)": {
                int(b): int(latest[b]) for b in np.argsort(latest)[::-1][:5]}}
        out["cases"][f"adjoint {width} B={batch} T={TRAIN_STEPS}"] = case
    return out


def trace_adjoint_f32(card: str) -> dict:
    """The float32 adjoint's step split (``--adjoint --float32``)."""
    traced = sc.load_bwd_library(("DA_TRACE",))
    traced.speller_bwd_trace.argtypes = [ctypes.c_void_p]
    traced.speller_bwd_trace.restype = ctypes.c_int
    sc.load_bwd_library = lambda defines=(): traced  # this process launches the traced build
    stamps = np.zeros((len(BLOCKS), len(F32_BWD_STAMPS), TRACE_STEPS), dtype=np.uint64)

    def read_stamps():  # and zero them on the card
        err = traced.speller_bwd_trace(stamps.ctypes.data)
        if err != 0:
            raise RuntimeError(f"trace_speller_decode: reading the stamps failed with "
                               f"cudaError {err}")
        return stamps.astype(np.int64)

    read_stamps()
    gen = torch.Generator().manual_seed(0)
    out = {"card": card, "kernel": "speller_decode_bwd float32",
           "unit": "us after block 0's step start", "cases": {}}
    for width, batch in F32_BWD_CASES:
        changes, listener_width = WIDTHS[width][:2]
        cfg = las_config_from_dicts({**LISTENER, "uniform_hid_dim": listener_width},
                                    {**SPELLER, **changes})
        spl = cfg.speller
        params = las_init(cfg, gen)["speller"].cuda()
        lengths = torch.randint(1, TE + 1, (batch,), generator=gen)
        lengths[0], lengths[1] = TE, 1
        enc = torch.randn(batch, TE, cfg.listener.enc_out_dim, generator=gen) * 0.5
        with torch.no_grad():
            operands, _ = sc.decode_operands(params, spl, enc.cuda(), lengths.cuda())
            opts = {**sc.decode_options(spl), "steps": TRAIN_STEPS}
            keep = 1.0 - spl.dec_lstm_dropout
            m1, m2 = (((torch.rand(TRAIN_STEPS, batch, h, generator=gen) < keep).float()
                       / keep).cuda() for h in (spl.dec_lstm_hid_dim, spl.dec_lstm_out_dim))
            _, wgts, _, saved = sc.speller_decode_train(*operands, **opts, m1=m1, m2=m2)
            k, v, _, _, _, c10, _, c20, _, wc1, whh1, wih2, whh2, _, wq = operands[:15]
            _, gates1, c1, _, gates2, c2, _, _ = saved
            dqup, dctxup = ((torch.randn(TRAIN_STEPS, batch, spl.att_proj_dim, generator=gen)
                             * 0.1).cuda() for _ in range(2))

            def run():
                return sc.speller_decode_bwd(k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1,
                                             c1, gates2, c2, wgts, m1, m2, dqup, dctxup, None,
                                             heads=opts["heads"], scale=opts["scale"])

            run()  # a warm-up call, its stamps dropped
            torch.cuda.synchronize()
            read_stamps()
            run()
            torch.cuda.synchronize()
        ns = read_stamps()
        steps = min(TRAIN_STEPS, TRACE_STEPS)
        case = _split(ns, steps, F32_BWD_STAMPS)
        index = {name: e for e, name in enumerate(F32_BWD_STAMPS)}
        for b, block in enumerate(BLOCKS):
            per = ns[b, :, 1:steps - 1]
            case[block]["phases (median us)"] = {
                phase: round(float(np.median(per[index[end]] - per[index[begin]])) / 1e3, 3)
                for phase, begin, end in F32_BWD_PHASES}
        case["plan"] = sc.bwd_f32_plan_for(k, opts["heads"], spl.dec_lstm_hid_dim,
                                           spl.dec_lstm_out_dim)._asdict()
        out["cases"][f"adjoint {width} B={batch} T={TRAIN_STEPS}"] = case
    return out


def trace_float32(card: str) -> dict:
    """The float32 eval form's step split (``--float32``)."""
    from attention_based_e2e_asr_dnn_tpu_torch.tools.time_speller_kernels import (
        REWRITER_SPELLER,
    )

    traced = sc.load_library(("DF_TRACE",))
    traced.speller_decode_trace.argtypes = [ctypes.c_void_p]
    traced.speller_decode_trace.restype = ctypes.c_int
    sc.load_library = lambda defines=(): traced  # this process launches the traced build
    stamps = np.zeros((len(BLOCKS), len(F32_STAMPS), TRACE_STEPS), dtype=np.uint64)

    def read_stamps():  # and zero them on the card
        err = traced.speller_decode_trace(stamps.ctypes.data)
        if err != 0:
            raise RuntimeError(f"trace_speller_decode: reading the stamps failed with "
                               f"cudaError {err}")
        return stamps.astype(np.int64)

    read_stamps()
    gen = torch.Generator().manual_seed(0)
    out = {"card": card, "kernel": "speller_decode float32",
           "unit": "us after block 0's step start", "cases": {}}
    for width, batch, te, low in (("Rewriter", 256, 608, 102), ("base-LAS", 64, TE, 1)):
        changes, listener_width = (REWRITER_SPELLER, 256) if width == "Rewriter" else \
            WIDTHS[width][:2]
        cfg = las_config_from_dicts({**LISTENER, "uniform_hid_dim": listener_width},
                                    {**SPELLER, **changes})
        params = las_init(cfg, gen)["speller"].cuda()
        lengths = torch.randint(low, te - 5, (batch,), generator=gen)
        lengths[0] = te - 6
        enc = torch.randn(batch, te, cfg.listener.enc_out_dim, generator=gen) * 0.5
        with torch.no_grad():
            operands, _ = sc.decode_operands(params, cfg.speller, enc.cuda(), lengths.cuda())
            opts = sc.decode_options(cfg.speller)
            sc.speller_decode(*operands, **opts)  # a warm-up call, its stamps dropped
            torch.cuda.synchronize()
            read_stamps()
            sc.speller_decode(*operands, **opts)
            torch.cuda.synchronize()
        steps = min(opts["steps"], TRACE_STEPS)
        out["cases"][f"eval {width} B={batch} Te={te} T={steps}"] = _split(
            read_stamps(), steps, F32_STAMPS)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--adjoint", action="store_true",
                        help="split a step of the adjoint (csrc/speller_bwd_tc.cu)")
    parser.add_argument("--float32", action="store_true",
                        help="split a step of the float32 eval form (csrc/speller_decode.cu), "
                             "or with --adjoint of the float32 adjoint (csrc/speller_bwd.cu)")
    args = parser.parse_args()
    require_device("cuda", "trace_speller_decode")
    card = smi_name_and_power()
    if args.adjoint and args.float32:
        print(json.dumps(trace_adjoint_f32(card)))
        return
    if args.adjoint:
        print(json.dumps(trace_adjoint(card)))
        return
    if args.float32:
        print(json.dumps(trace_float32(card)))
        return
    traced = sc.load_tc_library(("DT_TRACE",))
    traced.speller_decode_tc_trace.argtypes = [ctypes.c_void_p]
    traced.speller_decode_tc_trace.restype = ctypes.c_int
    sc.load_tc_library = lambda defines=(): traced  # this process launches the traced build
    stamps = np.zeros((len(BLOCKS), len(STAMPS), TRACE_STEPS), dtype=np.uint64)

    def read_stamps():  # and zero them on the card
        err = traced.speller_decode_tc_trace(stamps.ctypes.data)
        if err != 0:
            raise RuntimeError(f"trace_speller_decode: reading the stamps failed with "
                               f"cudaError {err}")
        return stamps.astype(np.int64)

    read_stamps()
    gen = torch.Generator().manual_seed(0)
    out = {"card": card, "unit": "us after block 0's step start", "cases": {}}
    for width, form, batch in CASES:
        changes, listener_width = WIDTHS[width][:2]
        cfg = las_config_from_dicts({**LISTENER, "uniform_hid_dim": listener_width},
                                    {**SPELLER, **changes})
        spl = cfg.speller
        params = las_init(cfg, gen)["speller"].cuda()
        lengths = torch.randint(1, TE + 1, (batch,), generator=gen)
        lengths[0], lengths[1] = TE, 1
        enc = torch.randn(batch, TE, cfg.listener.enc_out_dim, generator=gen) * 0.5
        with torch.no_grad():
            operands, _ = sc.decode_operands(params, spl, enc.to(torch.bfloat16).cuda(),
                                             lengths.cuda())
            opts = sc.decode_options(spl)
            if form == "train":
                opts["steps"] = TRAIN_STEPS
            run = sc.speller_decode_train if form == "train" else sc.speller_decode
            run(*operands, **opts)  # a warm-up call, its stamps dropped
            torch.cuda.synchronize()
            read_stamps()
            run(*operands, **opts)
            torch.cuda.synchronize()
        steps = min(opts["steps"], TRACE_STEPS)
        out["cases"][f"{form} {width} B={batch} T={steps}"] = _split(read_stamps(), steps,
                                                                     STAMPS)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
