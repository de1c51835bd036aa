"""Device idle ms a train step while the innermost of the port's spans is ``las.optimizer``: the global norm, the clip, AdamW amsgrad, the NaN guard and the in-place update."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms(ctx, "optimizer")
