#!/usr/bin/env python3
"""Probe how the launch plan of kernel K1 (GroupNorm+SiLU, ``probunet_torch/
csrc/gn_silu.cu``) sets its device time, on one CUDA card.

    python3 scripts/torch_k1_plan_probe.py

Forces plans that ``ops/gn_silu.py::plan`` would not choose and times each
by device time (torch.profiler), beside the bound (one read and one write
of x at 3.35 TB/s), after holding it against the plain version:

  * strip width: batch 64 of 32x32x384 (100 MB in fp32), channel blocks of
    96 bytes to whole rows, the fewest blocks of 100 KB per cluster;
  * blocks per cluster: the path's small sites (16x16 and 32x32) with the
    plan's channel block, spread over 1 to 8 blocks per cluster.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import GN_TOL, HBM_BYTES_PER_S, device_ms  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1_plan_probe: no CUDA device", file=sys.stderr)
        return 2
    from probunet_torch.ops import gn_silu as K1
    from probunet_torch.ops.norm import num_groups_for

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    chosen = K1.plan

    def probe(x, forced, what):
        b, h, w, c = x.shape
        g = num_groups_for(c)
        gamma = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
        beta = 0.1 * torch.randn(c, device=dev, generator=gen)
        atol, rtol = GN_TOL[str(x.dtype)[6:]]
        K1.plan = lambda *args: forced
        try:
            with torch.inference_mode():
                ref = K1._plain_gn_silu(x, gamma, beta, g)[0].float()
                d = (K1.gn_silu(x, gamma, beta, g).float() - ref).abs()
                if not bool((d <= atol + rtol * ref.abs()).all()):
                    raise AssertionError(f"K1 off its plain version by {d.max().item()}")
                t = device_ms(torch, lambda: K1.gn_silu(x, gamma, beta, g))
        finally:
            K1.plan = chosen
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        print(f"{str(x.dtype)[6:]:8s} {b}x{h}x{w}x{c} {what}: cb {forced.cb} "
              f"({forced.cb * x.element_size()} B rows), {forced.n} blocks per cluster: device "
              f"{t * 1e3:.1f} us, {bound / t:.0%} of the bound {bound * 1e3:.1f} us", flush=True)

    for dtype in (torch.float32, torch.bfloat16):
        isz = dtype.itemsize
        x = torch.randn(64, 32, 32, 384, device=dev, generator=gen).to(dtype)
        for cb in (96 // isz, 192 // isz, 384 // isz, 768 // isz, 1536 // isz):
            if 384 % cb:
                continue
            n = -(-1024 * cb * isz // K1.SLICE_BYTES)
            rows = -(-1024 // n)
            probe(x, K1.Plan(cb, n, rows, True, rows), "strip width")
        for h, c in ((16, 384), (16, 512), (16, 1024), (32, 384)):
            x = torch.randn(8, h, h, c, device=dev, generator=gen).to(dtype)
            cb = chosen(8, h, h, c, num_groups_for(c), isz, 132).cb
            for n in (1, 2, 4, 8):
                rows = -(-h * h // n)
                probe(x, K1.Plan(cb, n, rows, True, rows), "spread")
    return 0


if __name__ == "__main__":
    sys.exit(main())
