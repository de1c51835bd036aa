"""Device idle ms a train step while the innermost of the port's spans is the step's own glue: ``las.train_step``'s and ``las.backward``'s own time (the autograd engine's ops outside the custom Functions), ``las.specaug`` or ``las.loss``."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms(ctx, "step_glue")
