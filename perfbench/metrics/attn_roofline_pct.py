"""attn_roofline_pct: attention's least time per call (each site's larger
of FLOPs at the mode's peak and bytes at the HBM rate, at the real head
dim; forward and, in training, backward) over the device time of the
kernels kernels/attention.json names (the port's and the libraries'), in %."""

from perfbench import trace


def read(ctx):
    bound = sum(max(s["flops"] / ctx.peak_flops, s["bytes"] / ctx.hbm)
                for s in ctx.counts["attn"])
    return trace.roofline_pct(bound, trace.pooled_ms(
        ctx.segments, trace.kernel_filter(ctx.kernels["attention"])))
