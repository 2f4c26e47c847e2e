"""conv_roofline_pct: the convolutions' least time per call (each site's
larger of direct-convolution FLOPs at the mode's peak and bytes at the HBM
rate) over the device time of the kernels launched inside a convolution
op (kernels/conv.json), in %. By op, not by kernel name: cuDNN's names
change with its algorithm."""

from perfbench import trace


def read(ctx):
    bound = sum(max(s["flops"] / ctx.peak_flops, s["bytes"] / ctx.hbm)
                for s in ctx.counts["conv"])
    return trace.roofline_pct(bound, trace.pooled_ms(ctx.segments,
                                                     trace.kernel_filter(ctx.kernels["conv"])))
