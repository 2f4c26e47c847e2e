"""allreduce_exposed_ms: ms per step in which an NCCL kernel
(kernels/allreduce.json) runs on the device and no other kernel does: the
collectives' time that no computation hides, waiting for the slowest rank
included; nothing where the traces hold no NCCL kernel."""

from perfbench import trace


def read(ctx):
    nccl = trace.kernel_filter(ctx.kernels["allreduce"])
    if not any(nccl(s, k) for s in ctx.segments for k in s.kernels()):
        return None
    alone = sum(trace.alone_s(s, nccl) for s in ctx.segments)
    return 1e3 * alone / sum(s.calls for s in ctx.segments)
