"""optimizer_launches: kernels per step launched inside the program's
``probunet.optimizer`` span, each kernel's launches per call at its
largest over the traces, summed (a count)."""

from perfbench import spans


def read(ctx):
    return spans.launches(ctx.segments, "probunet.optimizer")
