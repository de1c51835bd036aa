"""Device idle ms a train step while no span of the port is open: the caller's loop, its draws and the profiler's own buffer requests."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms(ctx, "between_steps")
