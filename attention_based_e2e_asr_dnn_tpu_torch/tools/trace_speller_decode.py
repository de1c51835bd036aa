"""Split a step of the bfloat16 fused decode (``csrc/speller_decode_tc.cu``)
into its phases on the card and print one JSON line.

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.trace_speller_decode

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
"""

from __future__ import annotations

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
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import require_card

# enum Stamp of csrc/speller_decode_tc.cu, in order
STAMPS = ("step", "cell1 product", "cell1 published", "cell2 product", "cell2 published",
          "query published", "q acquired", "q loaded", "scores", "softmax", "context",
          "classifier", "attend published", "producer: attend acquired",
          "producer: cell1 acquired")
TRACE_STEPS = 1024  # DT_TRACE_STEPS
BLOCKS = ("block 0", "block G/2", "block G-1")
CASES = (("base-LAS", "eval", 64), ("base-LAS", "train", 32), ("base-LAS", "train", 128),
         ("scaled-LAS", "train", 128))


def main() -> None:
    card = require_card("trace_speller_decode")
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
        ns = read_stamps()[:, :, :steps]
        start = ns[0, 0, 1:-1]

        def after_start(b, e):
            if not ns[b, e, 1:-1].all():
                return None
            return round(float(np.median(ns[b, e, 1:-1] - start)) / 1e3, 3)

        out["cases"][f"{form} {width} B={batch} T={steps}"] = {
            "step_us": round(float(np.median(np.diff(ns[0, 0]))) / 1e3, 3),
            **{block: {name: after_start(b, e) for e, name in enumerate(STAMPS)}
               for b, block in enumerate(BLOCKS)}}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
