"""Split a step of the float32 LSTM adjoint (``csrc/lstm_bwd.cu``) into its
phases on the card and print one JSON line.

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.trace_lstm_bwd

Builds the source with ``-DB32_TRACE`` beside the normal library (the same
kernels with ``%globaltimer`` stamps at each phase boundary of blocks 0 and
G - 1 of a launch) and launches that build in this process at the train
step's shapes: ``lstm_bwd_dw`` at base-LAS's H=512 and ``lstm_bwd`` at H=512
and at scaled-LAS's H=1024 (where the wrapper makes a launch a direction:
the stamps are the last launch's), B=128, T=1536 over a 15-wide input as
``tools/time_lstm_kernels.py`` builds it (lengths mixed 1..T, a full row and
a length-1 row in every 32), the saved streams from the float32 training
forward. For each block it prints the median, over the steps (the first and
the last left out), of each phase in microseconds: "wait" from the step's
start to the acquired counter (this frame's loads are issued before it),
"first chunk" from there to the first ring stage's arrival, "product" to the
end of the four lanes' sums (the other chunks' staging overlaps it),
"cells" to the dpre stores, "publish" to the counter's release; "step" is
the median from one step's start to the next. With dW_hh, "dW product" is
the tiled product after the time loop, in ms, and the call's own time by
CUDA events beside it.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import (
    median_ms,
    require_device,
    smi_name_and_power,
)

# enum Stamp of csrc/lstm_bwd.cu, in order
STAMPS = ("step", "acquired", "first chunk", "product", "cells", "published")
PHASES = (("wait", 0, 1), ("first chunk", 1, 2), ("product", 2, 3), ("cells", 3, 4),
          ("publish", 4, 5))
TRACE_STEPS = 2048  # B32_TRACE_STEPS
BLOCKS = ("block 0", "block G-1")
CASES = (("lstm_bwd_dw", 512), ("lstm_bwd", 512), ("lstm_bwd", 1024))
BATCH, SEQ_LEN = 128, 1536


def _split(ns: np.ndarray, steps: int) -> dict:
    """Each phase's and the step's median (us), steps 1 .. steps - 2."""
    ns = ns[:, :, :steps]
    out = {"step_us": round(float(np.median(np.diff(ns[0, 0, 1:steps - 1]))) / 1e3, 3)}
    for b, block in enumerate(BLOCKS):
        out[block] = {name: round(float(np.median(ns[b, e1, 1:-1] - ns[b, e0, 1:-1])) / 1e3, 3)
                      for name, e0, e1 in PHASES}
    return out


def main() -> None:
    require_device("cuda", "trace_lstm_bwd")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi_name_and_power()
    traced = lc.load_bwd_library(("B32_TRACE",))
    traced.lstm_bwd_trace.argtypes = [ctypes.c_void_p]
    traced.lstm_bwd_trace.restype = ctypes.c_int
    lc.load_bwd_library = lambda defines=(): traced  # this process launches the traced build
    n_phase = len(BLOCKS) * len(STAMPS) * TRACE_STEPS
    stamps = np.zeros(n_phase + 4, dtype=np.uint64)

    def read_stamps():  # and zero them on the card
        err = traced.lstm_bwd_trace(stamps.ctypes.data)
        if err != 0:
            raise RuntimeError(f"trace_lstm_bwd: reading the stamps failed with cudaError {err}")
        return stamps.astype(np.int64)

    read_stamps()
    out = {"card": card, "kernel": "lstm_bwd float32 (csrc/lstm_bwd.cu)",
           "unit": "us a step, the median over steps", "cases": {}}
    rev = (False, True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for form, hidden in CASES:
        gen = torch.Generator().manual_seed(hidden)
        k = hidden ** -0.5
        w_hh = ((torch.rand(2, hidden, 4 * hidden, generator=gen) * 2 - 1) * k).cuda()
        w_ih = ((torch.rand(2, 15, 4 * hidden, generator=gen) * 2 - 1) * k).cuda()
        b = ((torch.rand(2, 4 * hidden, generator=gen) * 2 - 1) * k).cuda()
        lengths = torch.randint(1, SEQ_LEN + 1, (BATCH,), generator=gen)
        lengths[::32], lengths[1::32] = SEQ_LEN, 1
        lengths = lengths.to(torch.int32).cuda()
        x = torch.randn(BATCH, SEQ_LEN, 15, generator=gen).cuda()
        with torch.no_grad():
            hs, cs, gates = lc.lstm_scan_fusedin_train(x, w_ih, b, w_hh, lengths, rev)
        dy = torch.randn(hs.shape, generator=gen).cuda()
        if form == "lstm_bwd_dw":
            def run():
                return lc.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev)
        else:
            def run():
                return lc.lstm_bwd(gates, cs, dy, w_hh, lengths, rev)
        plan = lc.plan_bwd_launches(form, torch.float32, BATCH, hidden, 2, sms,
                                    form == "lstm_bwd_dw")
        run()  # a warm-up call, its stamps dropped
        torch.cuda.synchronize()
        read_stamps()
        run()
        torch.cuda.synchronize()
        ns = read_stamps()
        case = _split(ns[:n_phase].reshape(len(BLOCKS), len(STAMPS), TRACE_STEPS),
                      min(SEQ_LEN, TRACE_STEPS))
        if form == "lstm_bwd_dw":
            dw = ns[n_phase:].reshape(2, 2)
            case["dW product ms"] = {block: round(float(dw[i, 1] - dw[i, 0]) / 1e6, 3)
                                     for i, block in enumerate(BLOCKS)}
        case["call ms (CUDA events, traced build)"] = round(median_ms(run, 3), 3)
        case["plan"] = [{"rows": ln.rows, "units": ln.units, "stages": ln.stages,
                         "blocks": ln.blocks, "directions": ln.nd} for ln in plan]
        out["cases"][f"{form} H={hidden} B={BATCH} T={SEQ_LEN}"] = case
        del hs, cs, gates, dy, x
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
