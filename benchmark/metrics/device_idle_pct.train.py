"""Share of the traced train steps' window in which no operation ran on the card (100 minus the union of the device intervals)."""

from benchmark import traces


def read(ctx):
    return traces.idle_pct(ctx) if ctx.kind == "train" else None
