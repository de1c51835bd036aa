"""Kernel launches a train step (``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel*`` on the host) that begin inside the port's ``las.optimizer`` span."""

from benchmark import spans


def read(ctx):
    return spans.optimizer_launches(ctx)
