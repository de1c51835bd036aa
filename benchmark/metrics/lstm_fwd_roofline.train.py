"""The listener's forward recurrence in the train steps (``lstm_scan_tc_kernel``:
the training forms, and under ``remat`` the lean forms too): the launches'
least time over their device time."""

import re

from benchmark import traces

PATTERN = re.compile(r"\blstm_scan_tc_kernel\b")
COUNTERS = ("lstm_scan", "lstm_scan_fusedin", "lstm_scan_train", "lstm_scan_fusedin_train")


def read(ctx):
    return traces.roofline_pct(ctx, PATTERN, COUNTERS) if ctx.kind == "train" else None
