"""optimizer_host_ms: the host's ms per step inside the program's
``probunet.optimizer`` span."""

from perfbench import spans


def read(ctx):
    return spans.host_ms(ctx.segments, "probunet.optimizer")
