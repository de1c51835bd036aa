"""Device idle ms a train step while the innermost of the port's spans is the listener's: ``las.listener``, ``las.backward.listener`` or a ``las.launch.*`` call of an LSTM kernel."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms(ctx, "listener")
