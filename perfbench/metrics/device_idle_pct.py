"""device_idle_pct: the share of the traced windows' wall time in which no
operation ran on the device (the union of their intervals), in %."""


def read(ctx):
    window = sum(s.window_s for s in ctx.segments)
    return 100.0 * (1.0 - sum(s.busy_s() for s in ctx.segments) / window)
