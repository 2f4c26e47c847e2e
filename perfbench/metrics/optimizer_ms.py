"""optimizer_ms: device ms per step of the operations launched inside the
program's ``probunet.optimizer`` span (accumulation, clip, the update),
by the pooled estimator."""

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx.segments, "probunet.optimizer")
