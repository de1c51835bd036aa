"""The additive attention score's adjoint in the train steps
(``speller_additive_scores_bwd_kernel``, once a decode step and once for the
initial query): the launches' least time over their device time."""

import re

from benchmark import traces

PATTERN = re.compile(r"\bspeller_additive_scores_bwd_kernel\b")
COUNTERS = ("speller_additive_scores_bwd",)


def read(ctx):
    return traces.roofline_pct(ctx, PATTERN, COUNTERS) if ctx.kind == "train" else None
