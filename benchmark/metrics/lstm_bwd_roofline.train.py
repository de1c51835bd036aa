"""The listener's adjoint recurrence in the train steps (``lstm_bwd_tc_kernel``:
``lstm_bwd_dw`` up to H = 512, ``lstm_bwd`` above): the launches' least time
over their device time."""

import re

from benchmark import traces

PATTERN = re.compile(r"\blstm_bwd_tc_kernel\b")
COUNTERS = ("lstm_bwd_dw", "lstm_bwd")


def read(ctx):
    return traces.roofline_pct(ctx, PATTERN, COUNTERS) if ctx.kind == "train" else None
