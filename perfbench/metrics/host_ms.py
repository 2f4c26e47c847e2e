"""host_ms: the host's time per call inside the program's root span
(``probunet.train_step`` or ``probunet.sample``) on the calling thread, in
ms: in a host-bound cell, how long the host takes to dispatch one call."""

from perfbench import spans


def read(ctx):
    root = next((r for r in spans.ROOTS if spans.present(ctx.segments, r)), None)
    return None if root is None else spans.host_ms(ctx.segments, root)
