"""Host ms a train step inside the port's ``las.launch.<key>`` spans: each csrc/ kernel call's checks, plan, buffers and C call; nothing where the calls' keys and the launch counters that moved differ."""

from benchmark import spans


def read(ctx):
    return spans.kernel_call_host_ms(ctx)
