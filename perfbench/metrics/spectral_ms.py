"""spectral_ms: device ms per call of the operations launched inside the
program's ``probunet.spectral`` spans (FourCastNet's filters, one span a
block: the fp32 cast, rfft2, the kept modes' block products, softshrink,
irfft2, the cast back and the residual add), by the pooled estimator; the
backward's operations are launched in ``probunet.backward``, so this is the
forward's share. A program without that span reads nothing."""

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx.segments, "probunet.spectral")
