"""spectral_roofline_pct: the filters' least time per call over their
device time (``spectral_ms``), in %. Each forward filter call of
``ctx.counts["spectral"]`` costs at least the larger of its block products'
real FLOPs at the fastest fp32-accurate rate (``peaks.json``'s ``tf32x3``:
the products are fp32) and its bytes at the HBM rate (x read once and the
output written once at the activation size, the four weight tensors once).
That is the least work any implementation does: no FFT is counted. A
program without the span, or a job without the counts, reads nothing."""

import json
from pathlib import Path

from perfbench import spans, trace

PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"


def read(ctx):
    sites = ctx.counts.get("spectral")
    ms = spans.device_ms(ctx.segments, "probunet.spectral")
    if not sites or ms is None:
        return None
    with open(PEAKS) as f:
        peak = json.load(f)["flops_per_s"]["tf32x3"]
    bound = sum(max(s["flops"] / peak, s["bytes"] / ctx.hbm) for s in sites)
    return trace.roofline_pct(bound, ms)
