"""launches_per_step: device kernels per call, each kernel's launches per
call at its largest over the traces, summed (a count)."""

from perfbench import trace


def read(ctx):
    return trace.launches_per_call(ctx.segments)
