"""regression_ms: device ms per call of the operations launched inside the
program's ``probunet.regression`` span (CorrDiff's mean: one pass of the
regression U-Net over the call's inputs, before the residual chains), by
the pooled estimator. A program without that span reads nothing."""

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx.segments, "probunet.regression")
