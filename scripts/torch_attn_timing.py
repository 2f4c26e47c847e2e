#!/usr/bin/env python3
"""Time kernels K2 and K3 of the PyTorch port (fused attention forward and
backward) at every attention site of one U-Net pass, on one CUDA card, by
device time and by CUDA events, beside scaled_dot_product_attention.

    python3 scripts/torch_attn_timing.py [--tree DIR] [--modes fast,strict_bf16,strict]
        [--sites mc128,mc96] [--plans]

The 11 attention sites of one U-Net pass at batch 8, 128x128: ``mc128``,
the default width (L=1024 with 6 heads of 64 x5, L=256 with 8 heads of 64
x6), ``mc96``, ``--model_channels 96`` (L=1024 with 4 heads of 72 x5, on
the bf16 kernels' exact-width kD = 80 instantiation and the fp32 kernels'
kD = 128, L=256 with 6 heads of 64 x6). Each
runs on the U-Net block's q/k/v views, is checked against its plain
version first, then timed: K2 (``fused_attention`` without gradient, as
serving calls it) and K3 (``attention_bwd`` on K2's output and lse, its
device time also split by kernel: row pass, dK/dV, dQ), device time from
torch.profiler over 50 calls, CUDA events over 20, beside SDPA's forward
and backward on contiguous copies (read as the kernels are: each kernel's
mean launch over the traces times its launches per call) and the bound (4 and 10 L^2 c
FLOP per head against the bf16 tensor-core rate, for strict_bf16's K3 too,
whose dS products run twice; strict (fp32) against three TF32 products).
``--tree`` imports ``probunet_torch`` from another checkout of the
repository (an earlier commit unpacked with ``git archive``), so that two
versions of the kernels are timed on one card. ``--plans`` also times
every block size the bf16 kernels are built for at each site's head width
(``ops/attention.py::plan`` overridden). The last line is a JSON object of
the timings.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (L, heads, head dim) of the 11 attention blocks of one U-Net pass, by width
SITES = {"mc128": [(1024, 6, 64)] * 5 + [(256, 8, 64)] * 6,
         "mc96": [(1024, 4, 72)] * 5 + [(256, 6, 64)] * 6}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT, help="checkout whose probunet_torch is timed")
    ap.add_argument("--modes", default="fast,strict_bf16", help="attention modes to time")
    ap.add_argument("--sites", default="mc128", help="U-Net widths whose sites are timed")
    ap.add_argument("--plans", action="store_true", help="also time every bf16 block size")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, ROOT)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_attn_timing: no CUDA device", file=sys.stderr)
        return 2
    # the measuring helpers of this checkout's chip_smoke.py, whichever tree is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from probunet_torch.ops import _build
    from probunet_torch.ops import attention as K2

    if os.path.dirname(os.path.abspath(K2.__file__)) != os.path.join(tree, "probunet_torch", "ops"):
        raise AssertionError(f"probunet_torch came from {K2.__file__}, not from {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"{card}; kernels from {tree}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    run = {"card": card, "tree": tree}
    for width, mode in ((w, m) for w in args.sites.split(",") for m in args.modes.split(",")):
        dname, fast = cs.ATTN_MODES[mode]
        dtype = getattr(torch, dname)
        tot = {"fwd": {}, "bwd": {}}
        per_site = []
        for (L, nh, c), mult in cs._counts(SITES[width]).items():
            y = torch.randn(cs.BATCH, L, 3, nh, c, device=dev, generator=gen).to(dtype)
            q, k, v = y.unbind(2)   # the block's views: row stride 3 heads c
            do = torch.randn(cs.BATCH, L, nh, c, device=dev, generator=gen).to(dtype)
            with torch.no_grad():
                out, lse = K2._launch(q, k, v, with_lse=True)
                got = K2.attention_bwd(q, k, v, out, lse, do, fast)
                ref = K2._plain_attention(q, k, v, fast)
                ref_b = K2._plain_attention_bwd(q, k, v, do, fast)
            err = (K2.fused_attention(q, k, v, fast).float() - ref.float()).abs().max().item()
            rel = max((g.float() - r.float()).abs().max().item()
                      / max(1e-3, r.float().abs().max().item()) for g, r in zip(got, ref_b))
            if err > cs.ATTN_TOL[mode] or rel > cs.ATTN_BWD_TOL[dname]:
                raise AssertionError(f"{mode} L={L}: K2 err {err}, K3 rel err {rel}")
            qs, ks, vs = (a.permute(0, 2, 1, 3).contiguous().requires_grad_() for a in (q, k, v))
            os_ = F.scaled_dot_product_attention(qs, ks, vs)
            dos = do.permute(0, 2, 1, 3).contiguous()

            def fwd():
                return K2.fused_attention(q, k, v, fast)

            def bwd():
                return K2.attention_bwd(q, k, v, out, lse, do, fast)

            def sdpa():
                return F.scaled_dot_product_attention(qs, ks, vs)

            def sdpa_bwd():
                return torch.autograd.grad(os_, (qs, ks, vs), dos, retain_graph=True)

            site = {"site": [cs.BATCH, L, nh, c], "count": mult, "k2_max_abs_err": err,
                    "k3_max_rel_err": rel}
            for leg, fn, lib, flops_per in (("fwd", fwd, sdpa, 4), ("bwd", bwd, sdpa_bwd, 10)):
                flops = flops_per * cs.BATCH * nh * L * L * float(c)
                nbytes = (4 if leg == "fwd" else 8) * cs.BATCH * L * nh * float(c) * q.element_size()
                split = {}
                with torch.inference_mode() if leg == "fwd" else torch.no_grad():
                    t = {"ms": cs.cuda_ms(torch, fn),
                         "device_ms": cs.device_ms(torch, fn, whole=True, split=split)}
                if leg == "bwd":
                    t.update(cs.k3_split(split))
                t["library_ms"] = cs.cuda_ms(torch, lib)
                t["library_device_ms"] = cs.device_ms(torch, lib, whole=True)
                t["bound_ms"] = cs.attn_bound(flops, nbytes,
                                              "strict" if mode == "strict" else "fast")["bound_ms"]
                t["flops"] = flops
                site[leg] = t
                for key, val in t.items():
                    tot[leg][key] = tot[leg].get(key, 0.0) + mult * val
                by_kernel = (f" (row pass {t['row_pass_device_ms'] * 1e3:.1f}, dK/dV "
                             f"{t['dkdv_device_ms'] * 1e3:.1f}, dQ {t['dq_device_ms'] * 1e3:.1f})"
                             if leg == "bwd" else "")
                print(f"  {width} {mode:11s} {leg} B={cs.BATCH} L={L} heads={nh} c={c} x{mult}: "
                      f"device {t['device_ms'] * 1e3:.1f} us{by_kernel} "
                      f"({flops / t['device_ms'] / 1e9:.0f} TFLOP/s, "
                      f"{t['bound_ms'] / t['device_ms']:.0%} of the bound "
                      f"{t['bound_ms'] * 1e3:.1f}), events {t['ms'] * 1e3:.1f} us; SDPA device "
                      f"{t['library_device_ms'] * 1e3:.1f} us, events {t['library_ms'] * 1e3:.1f}",
                      flush=True)
            if args.plans and hasattr(K2, "plan") and dtype == torch.bfloat16:
                site["plans"] = time_plans(torch, K2, _build, q, k, v, out, lse, do, fast,
                                           cs.device_ms, c)
            per_site.append(site)
        for leg, t in tot.items():
            t["tflops"] = t["flops"] / t["device_ms"] / 1e9
            t["bound_share_device"] = t["bound_ms"] / t["device_ms"]
            by_kernel = (f" (row pass {t['row_pass_device_ms']:.4f}, dK/dV "
                         f"{t['dkdv_device_ms']:.4f}, dQ {t['dq_device_ms']:.4f})"
                         if leg == "bwd" else "")
            print(f"{width} {mode} {leg} per pass: device {t['device_ms']:.4f} ms{by_kernel} "
                  f"({t['tflops']:.0f} TFLOP/s; {t['bound_share_device']:.0%} of the bound "
                  f"{t['bound_ms']:.4f}), events {t['ms']:.4f}; SDPA device "
                  f"{t['library_device_ms']:.4f}, events {t['library_ms']:.4f} ({card})",
                  flush=True)
        run[f"{width}_{mode}"] = {**tot, "sites": per_site}
    print(json.dumps(run), flush=True)
    return 0


# the K2 block shapes (block rows, K/V tile rows) built at each bf16 head
# width; K3 with dS split also at 128 rows at kD = 64 (elsewhere 64 rows)
BUILT = {64: [(64, 64), (64, 128), (128, 128)], 80: [(64, 64), (128, 128)], 96: [(64, 64)],
         128: [(64, 64)]}


def time_plans(torch, K2, _build, q, k, v, out, lse, do, fast, device_ms, c):
    """Device ms of K2 and K3 at this site under each block shape the bf16
    kernels are built for at its head width (the plan overridden): K2 at
    each (rows, tile) of BUILT; K3 with dS split at 64 and, at kD = 64, 128
    rows (fast mode's K3 is built for 64 rows only)."""
    b, L, h, w = q.shape
    kd = K2._kd(w) if hasattr(K2, "_kd") else 64
    base = K2.plan(b, h, L, _build.num_sms(q.device.index), kd)
    shapes = BUILT.get(kd, [(64, 64)])
    res = {}
    real = K2.plan
    try:
        for i, (rows, tile) in enumerate(shapes):
            bwd_rows = 128 if rows == 128 and not fast and kd == 64 else 64
            K2.plan = lambda *a, rows=rows, tile=tile, bwd_rows=bwd_rows: base._replace(
                fwd_rows=rows, fwd_tile=tile, bwd_split_rows=bwd_rows)
            with torch.no_grad():
                f = device_ms(torch, lambda: K2._launch(q, k, v, with_lse=False), whole=True)
                g = device_ms(torch, lambda: K2.attention_bwd(q, k, v, out, lse, do, fast),
                              whole=True)
            res[f"{rows}x{tile}"] = {"fwd_device_ms": f, "bwd_device_ms": g,
                                     "bwd_rows": bwd_rows}
            mark = " (the plan)" if (rows, tile) == base[:2] else ""
            print(f"    kD {kd} plan rows {rows} tile {tile}: K2 device {f * 1e3:.1f} us{mark}; "
                  f"K3 at {bwd_rows} rows device {g * 1e3:.1f} us", flush=True)
    finally:
        K2.plan = real
    return res


if __name__ == "__main__":
    sys.exit(main())
