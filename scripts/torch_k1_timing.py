#!/usr/bin/env python3
"""Time kernel K1 of the PyTorch port (GroupNorm+SiLU) at every site of one
U-Net forward, on one CUDA card, by device time and by CUDA events.

    python3 scripts/torch_k1_timing.py [--tree DIR]

The 29 unmodulated GroupNorm+SiLU sites of the default U-Net (each block's
norm0 and out_norm) at batch 8, 128x128 are timed one by one in fp32 and
bf16 (device time from torch.profiler, CUDA events over 20 calls), each
beside its bound (one read and one write of x at 3.35 TB/s), and summed per
pass. The blocks' norm1, with the embedding's terms in the launch, is timed
beside the chain it replaces by ``chip_smoke.py`` (phase 6). ``--tree``
imports ``probunet_torch`` from another checkout of the repository (an
earlier commit unpacked with ``git archive``), so that two versions of the
kernel are timed on one card. The last line is a JSON object of the
timings.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="checkout whose probunet_torch is timed")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("torch_k1_timing: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import BATCH, GN_TOL, RES, _counts, cuda_ms, device_ms, peak_rates
    from probunet_torch.ops import gn_silu as K1
    from probunet_torch.ops.norm import num_groups_for

    if os.path.dirname(os.path.abspath(K1.__file__)) != os.path.join(tree, "probunet_torch", "ops"):
        raise AssertionError(f"probunet_torch came from {K1.__file__}, not from {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"{card}; kernel from {tree}", flush=True)
    # the (H, W, C) of the 29 unmodulated sites (each block's norm0 and
    # out_norm) as models.unet.gn_silu_sites gives them and chip_smoke.py's
    # hooks count them; written out, since an earlier tree given by --tree
    # may not have gn_silu_sites
    sites = ([(128, 128, 128)] * 4 + [(128, 128, 256)] * 2 + [(128, 128, 384)]
             + [(64, 64, 128), (64, 64, 384), (64, 64, 512), (64, 64, 640)] + [(64, 64, 256)] * 3
             + [(32, 32, 256), (32, 32, 640), (32, 32, 768), (32, 32, 896)] + [(32, 32, 384)] * 3
             + [(16, 16, 384), (16, 16, 896)] + [(16, 16, 512)] * 4 + [(16, 16, 1024)] * 2)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    hbm = peak_rates()["hbm_bytes_per_s"]
    run = {"card": card, "tree": tree}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = GN_TOL[str(dtype)[6:]]
        tot = {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0}
        per_site = []
        for (h, w, c), mult in _counts(sites).items():
            g = num_groups_for(c)
            x = torch.randn(BATCH, h, w, c, device=dev, generator=gen).to(dtype)
            gamma = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
            beta = 0.1 * torch.randn(c, device=dev, generator=gen)

            def fn():
                return K1.gn_silu(x, gamma, beta, g)

            with torch.inference_mode():
                ref = K1._plain_gn_silu(x, gamma, beta, g)[0].float()
                d = (fn().float() - ref).abs()
                if not bool((d <= atol + rtol * ref.abs()).all()):
                    raise AssertionError(f"K1 off its plain version by {d.max().item()}")
                t = {"ms": cuda_ms(torch, fn), "device_ms": device_ms(torch, fn),
                     "bound_ms": 2 * x.numel() * x.element_size() / hbm * 1e3}
            per_site.append({"site": [BATCH, h, w, c], "count": mult, **t})
            print(f"  {str(dtype)[6:]:8s} {BATCH}x{h}x{w}x{c} x{mult}: device "
                  f"{t['device_ms'] * 1e3:.1f} us ({t['bound_ms'] / t['device_ms']:.0%} of the "
                  f"bound {t['bound_ms'] * 1e3:.1f}), events {t['ms'] * 1e3:.1f} us", flush=True)
            for key in tot:
                tot[key] += mult * t[key]
        tot["bound_share_device"] = tot["bound_ms"] / tot["device_ms"]
        run[str(dtype)[6:]] = {**tot, "sites": per_site}
        print(f"{str(dtype)[6:]} per pass: device {tot['device_ms']:.4f} ms "
              f"({tot['bound_share_device']:.0%} of the bound {tot['bound_ms']:.4f}), events "
              f"{tot['ms']:.4f} ms ({card})", flush=True)
    print(json.dumps(run), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
