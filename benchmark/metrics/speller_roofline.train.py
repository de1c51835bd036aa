"""The fused decode's training form and its adjoint in the train steps
(``speller_decode_tc_kernel`` and ``speller_bwd_tc_kernel``): the launches'
least time over their device time."""

import re

from benchmark import traces

PATTERN = re.compile(r"\b(speller_decode_tc_kernel|speller_bwd_tc_kernel)\b")
COUNTERS = ("speller_decode_train", "speller_decode_bwd")


def read(ctx):
    return traces.roofline_pct(ctx, PATTERN, COUNTERS) if ctx.kind == "train" else None
