"""allreduce_ms: device ms per step of the operations launched inside the
program's ``probunet.allreduce`` span (the gradients' flattening, the NCCL
all-reduce of the flat buffer, which waits for the slowest rank, and the
copy back), by the pooled estimator; nothing where the span launched no
operation."""

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx.segments, "probunet.allreduce") or None
