"""mfu: the model's FLOPs per call (FlopCounterMode on the reference) over
the traced calls' wall time per call, against the peak of the mode's
arithmetic, in %."""


def read(ctx):
    calls = sum(s.calls for s in ctx.segments)
    wall = sum(s.window_s for s in ctx.segments) / calls
    return 100.0 * ctx.counts["flops"] / wall / ctx.peak_flops
