"""gn_silu_roofline_pct: the fused GroupNorm+SiLU forward's least time per
call (x read once and the output written once, at the HBM rate) over the
device time of the kernels kernels/gn_silu.json names, in %."""

from perfbench import trace


def read(ctx):
    bound = sum(s["bytes"] / ctx.hbm for s in ctx.counts["gn"])
    return trace.roofline_pct(bound, trace.pooled_ms(
        ctx.segments, trace.kernel_filter(ctx.kernels["gn_silu"])))
