"""tokenize_ms: device ms per call of the operations launched inside the
program's ``probunet.tokenize`` span (ClimaX's forward before its blocks:
the per-variable patch embedding, the variable aggregation, the position
and lead-time terms and their dropout), by the pooled estimator; the
backward's operations are launched in ``probunet.backward``, so this is
the forward's share. A program without that span reads nothing."""

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx.segments, "probunet.tokenize")
