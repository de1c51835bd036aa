"""Device ms a train step of every kernel that is not one of the port's csrc/ kernels and not a collective: the PyTorch products, casts, optimizer and SpecAugment."""

from benchmark import traces


def read(ctx):
    return traces.other_kernels_ms(ctx) if ctx.kind == "train" else None
