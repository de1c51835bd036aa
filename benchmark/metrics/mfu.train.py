"""The model FLOPs of the traced train steps (the window's first pass: valid frames, each row's label length, 3 x forward) over the traced window's seconds and the chips' bfloat16 peak."""

from benchmark import traces


def read(ctx):
    return traces.mfu_pct(ctx, "train")
