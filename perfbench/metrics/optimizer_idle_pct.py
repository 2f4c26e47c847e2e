"""optimizer_idle_pct: the device's idle time in the gaps ended by an
operation launched inside the program's ``probunet.optimizer`` span (the
gap rule of ``trace.Segment.idle_gaps``), over the traced windows' wall
time, in %."""

from perfbench import spans


def read(ctx):
    return spans.idle_pct(ctx.segments, "probunet.optimizer")
