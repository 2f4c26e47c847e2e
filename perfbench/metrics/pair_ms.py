"""pair_ms: device ms per call of the operations launched inside the
program's ``probunet.pair`` span (HR gather, stats slice, avg-pool,
bilinear upsample, standardize, cast), by the pooled estimator."""

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx.segments, "probunet.pair")
