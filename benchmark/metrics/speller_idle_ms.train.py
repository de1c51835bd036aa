"""Device idle ms a train step while the innermost of the port's spans is the speller's: ``las.speller.operands``, ``las.speller.decode``, ``las.backward.speller`` or a ``las.launch.speller_*`` call."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms(ctx, "speller")
