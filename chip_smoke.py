#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts on an NVIDIA GPU.

    python3 chip_smoke.py          # one CUDA card, no arguments

Builds the port's hand-written kernels from ``probunet_torch/csrc`` and
drives the serving path (``probunet_torch.serve.downscale``) at the full
width of the 128x128 Probabilistic U-Net (103,541,083 parameters, seeded
random weights), in strict fp32 and in fast bf16 mode. Phases:

  1. card and build: nvidia-smi name and power limit; nvcc for sm_90a with
     ptxas registers, shared memory and spills;
  2. K1 GroupNorm+SiLU against its plain version at every (H, W, C) of the
     path at batch 8, fp32 and bf16;
  3. K2 attention against its plain version at the path's (B, L, heads),
     strict and fast, plus a ragged L;
  4. the main path: a checkpoint, then ``downscale`` of synthetic 128x128
     days with 16 members in both modes; files read back and checked;
     launch counters must show 29 K1 and 11 K2 launches per batch;
  5. the path against the plain path: one input, two members, the same
     weights and eps, on the card and on the CPU;
  6. timings with CUDA events: each kernel, its plain version, one PyTorch
     call computing the same function (a yardstick the port never calls),
     the bound; the serving rate; a profile of one batch.

Any failed phase raises, so the script exits non-zero and prints no
result. The line before the last is the ``kernels`` JSON object, the last
line ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12       # CUDA cores, no tensor cores
BF16_FLOPS = 989e12      # tensor cores

RES, BATCH, MEMBERS = 128, 8, 16
DAYS = 32                # four batches of 8 test days
K1_PER_BATCH, K2_PER_BATCH = 29, 11
EXPECTED_PARAMS = 103_541_083
GN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 2 ** -8)}   # (atol, rtol)
# strict: fp32 FMAs in another order than the plain einsum; fast: the plain
# version rounds the logits to bf16, the kernel keeps them fp32
ATTN_TOL = {"strict": 2e-5, "fast": 2e-2}
# the whole path, card against CPU, strict fp32: cuDNN and oneDNN sum the
# convolutions in other orders through ~60 layers of random weights
PATH_TOL = 1e-3


def log(msg=""):
    print(msg, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from probunet_torch.ops import _build

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)

    # ---- 1. card and build -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_log = _build.build()
    log(f"[1] built {_build.LIB_PATH.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line or "Compiling" in line:
            log("    " + line.strip())
    _build.lib()

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        result = run_phases(torch, dev, card)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": result}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Mean ms per call of ``fn`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def census(torch, model, x):
    """(H, W, C) of every GroupNorm+SiLU site and (L, heads) of every
    attention block in one forward of ``model`` on ``x``, by hooks."""
    from probunet_torch.models.layers import GroupNormSiLU
    from probunet_torch.models.unet import UNetBlock

    gn, attn, hooks = [], [], []
    for m in model.modules():
        if isinstance(m, GroupNormSiLU):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: gn.append((args[0].shape[2], args[0].shape[3],
                                             args[0].shape[1]))))
        elif isinstance(m, UNetBlock) and m.heads:
            hooks.append(m.register_forward_hook(
                lambda mod, args, out: attn.append((out.shape[2] * out.shape[3], mod.heads))))
    with torch.inference_mode():
        model.unet(x)
    for h in hooks:
        h.remove()
    return gn, attn


def fill_weights(torch, model, seed=0):
    """Every parameter ~ N(0, 1) / sqrt(fan_in), fan_in the product of an
    OIHW or (out, in) weight's trailing dims (1 for a bias), as bench.py
    fills the JAX model: zero-init convs would hide most of each block."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            fan_in = max(1, math.prod(p.shape[1:]))
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))


def run_phases(torch, dev, card):
    import numpy as np
    import torch.nn.functional as F

    from probunet_torch.config import Config
    from probunet_torch.data.dataset import ClimexDataset
    from probunet_torch.data.netcdf import NetCDFFile
    from probunet_torch.data.synthetic import generate_climex_like
    from probunet_torch.ops import attention as K2
    from probunet_torch.ops import gn_silu as K1
    from probunet_torch.ops.norm import group_stats, num_groups_for
    from probunet_torch.serve import downscale
    from probunet_torch.train.checkpoint import save_checkpoint
    from probunet_torch.train.loop import build_probunet
    from probunet_torch.train.steps import make_sample_fn
    from probunet_torch.utils.device import full_fp32

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1)

    datadir = os.path.join(WORK, "data")
    generate_climex_like(datadir, years=(2000,), grid=RES, days_per_year=DAYS)
    cfg = Config(datadir=datadir, years_test=(2000, 2001), coords=(0, RES, 0, RES),
                 resolution=(RES, RES), standardization="pertimestep",
                 batch_size=BATCH, num_samples=MEMBERS)
    fast_cfg = cfg.replace(compute_dtype="bfloat16", fast_attention=True)
    model = build_probunet(cfg, device="meta").to_empty(device=dev).eval()
    fill_weights(torch, model)
    nparams = sum(p.numel() for p in model.parameters())
    log(f"[4] model: {RES}x{RES} Probabilistic U-Net, {nparams:,} parameters")
    if nparams != EXPECTED_PARAMS:
        raise AssertionError(f"expected {EXPECTED_PARAMS:,} parameters, got {nparams:,}")
    gn_sites, attn_sites = census(torch, model, torch.randn(BATCH, RES, RES, 3, device=dev))
    log(f"[2] K1 sites per forward: {len(gn_sites)}; [3] K2 sites: {len(attn_sites)}")
    if (len(gn_sites), len(attn_sites)) != (K1_PER_BATCH, K2_PER_BATCH):
        raise AssertionError("unexpected kernel sites on the path")

    # ---- 2. K1 against its plain version -------------------------------------
    k1_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = GN_TOL[str(dtype).split(".")[1]]
        worst = 0.0
        for (h, w, c) in sorted(set(gn_sites)):
            g = num_groups_for(c)
            x = (torch.randn(BATCH, h, w, c, device=dev, generator=gen) + 0.5).to(dtype)
            gamma = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
            beta = 0.1 * torch.randn(c, device=dev, generator=gen)
            with torch.inference_mode():
                out, mean, rstd = K1.gn_silu(x, gamma, beta, g, return_stats=True)
                ref = K1._plain_gn_silu(x, gamma, beta, g)[0]
                rmean, rrstd = group_stats(x, g)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            worst = max(worst, d.max().item())
            ok = bool((d <= atol + rtol * ref.float().abs()).all())
            ok &= torch.allclose(mean, rmean, rtol=1e-5, atol=1e-5)
            ok &= torch.allclose(rstd, rrstd, rtol=1e-5, atol=1e-5)
            log(f"[2] K1 {str(dtype)[6:]:8s} {BATCH}x{h}x{w}x{c} G={g}: max abs err "
                f"{d.max().item():.3e} (atol {atol}, rtol {rtol:.3g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("K1 disagrees with its plain version")
        k1_err[dtype] = worst

    # ---- 3. K2 against its plain version -------------------------------------
    k2_err = {}
    shapes = sorted(set(attn_sites), reverse=True) + [(64, 8)]
    for mode, dtype in (("strict", torch.float32), ("fast", torch.bfloat16)):
        worst = 0.0
        for b, (L, nh) in [(BATCH, s) for s in shapes] + [(2, (100, 2))]:
            y = torch.randn(b, L, nh, 64, 3, device=dev, generator=gen).to(dtype)
            q, k, v = y[..., 0], y[..., 1], y[..., 2]   # stride-3 views, as in the block
            with torch.inference_mode():
                out = K2.fused_attention(q, k, v, mode == "fast")
                ref = K2._plain_attention(q, k, v, mode == "fast")
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = ATTN_TOL[mode]
            ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
            worst = max(worst, err)
            log(f"[3] K2 {mode:6s} B={b} L={L} heads={nh}: max abs err {err:.3e} "
                f"(tol {tol}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("K2 disagrees with its plain version")
        k2_err[mode] = worst

    # ---- 4. the main path ----------------------------------------------------
    ckpt = os.path.join(WORK, "ckpt")
    save_checkpoint(ckpt, model)
    nb = DAYS // BATCH
    K1.gn_silu.launches = 0
    K2.fused_attention.launches = 0
    outs, secs = {}, {}
    for name, c in (("strict", cfg), ("fast", fast_cfg)):
        secs[name] = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs[name] = downscale(c, ckpt, os.path.join(WORK, f"out_{name}.nc"),
                               batch_seconds=secs[name], device=dev)
        wall = time.perf_counter() - t0
        n1, n2 = K1.gn_silu.launches, K2.fused_attention.launches
        log(f"[4] downscale {name}: {DAYS} days x {MEMBERS} members in {wall:.2f} s "
            f"(netCDF output), per batch {[round(s, 3) for s in secs[name]]} s, peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches so far K1 {n1}, K2 {n2}")
    launches = {"gn": K1.gn_silu.launches, "attn": K2.fused_attention.launches}
    want = (2 * nb * K1_PER_BATCH, 2 * nb * K2_PER_BATCH)
    if (launches["gn"], launches["attn"]) != want:
        raise AssertionError(f"launches {launches}, expected {want} "
                             f"({K1_PER_BATCH} K1 and {K2_PER_BATCH} K2 per batch)")
    for name, path in outs.items():
        with NetCDFFile(path) as f:
            for var in cfg.variables:
                a = f.read_var(var)
                spread = float(a.std(axis=1).mean())
                if a.shape != (DAYS, MEMBERS, RES, RES) or not np.isfinite(a).all() \
                        or not spread > 0:
                    raise AssertionError(f"{name} {var}: shape {a.shape}, spread {spread}")
                log(f"[4] {name} {var}: shape {a.shape}, finite, mean {a.mean():.4g}, "
                    f"member spread {spread:.4g}")
    with NetCDFFile(outs["strict"]) as f, NetCDFFile(outs["fast"]) as g:
        for var in cfg.variables:
            a, b = f.read_var(var), g.read_var(var)
            log(f"[4] fast vs strict {var}: max abs diff {np.abs(a - b).max():.4g} "
                f"(field max {np.abs(a).max():.4g})")

    # ---- 5. the path against the plain path -------------------------------------
    ds = ClimexDataset(cfg.datadir, years=[2000], coords=cfg.coords,
                       standardization=cfg.standardization, device=dev)
    ds_cpu = ClimexDataset(hr=ds.hr_np, timestamps=ds.timestamps_np,
                           standardization=cfg.standardization, device="cpu")
    cpu_model = build_probunet(cfg, device="meta").to_empty(device="cpu").eval()
    cpu_model.load_state_dict(model.state_dict())
    eps = torch.randn(2, 1, cfg.latent_dim, generator=torch.Generator().manual_seed(5))
    idx = torch.tensor([3])
    with full_fp32():
        got = make_sample_fn(model, 4, cfg.standardization, 2)(
            ds.hr_device(), ds.stats, idx.to(dev), eps=eps)[0].cpu()
    t0 = time.perf_counter()
    ref = make_sample_fn(cpu_model, 4, cfg.standardization, 2)(
        ds_cpu.hr_device(), ds_cpu.stats, idx, eps=eps)[0]
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    log(f"[5] path on the card vs plain path on the CPU (b=1, K=2, {time.perf_counter() - t0:.1f}"
        f" s on the CPU): max abs err / max |ref| = {rel:.3e} (tol {PATH_TOL})")
    if not rel <= PATH_TOL:
        raise AssertionError("the path on the card disagrees with the plain path")
    del cpu_model

    # ---- 6. timings ----------------------------------------------------------
    def time_k1(dtype):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        for (h, w, c), mult in _counts(gn_sites).items():
            g = num_groups_for(c)
            x = torch.randn(BATCH, h, w, c, device=dev, generator=gen).to(dtype)
            gamma = torch.ones(c, device=dev)
            beta = torch.zeros(c, device=dev)
            xc = x.permute(0, 3, 1, 2)            # NCHW view, channels_last
            with torch.inference_mode():
                t = {"ms": cuda_ms(torch, lambda: K1.gn_silu(x, gamma, beta, g)),
                     "plain_ms": cuda_ms(torch, lambda: K1._plain_gn_silu(x, gamma, beta, g)),
                     "library_ms": cuda_ms(torch, lambda: F.silu(F.group_norm(
                         xc, g, gamma.to(dtype), beta.to(dtype), 1e-5)))}
            t["bound_ms"] = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            log(f"[6] K1 {str(dtype)[6:]:8s} {BATCH}x{h}x{w}x{c} x{mult}: kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, F.group_norm+silu "
                f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f}")
            for key in tot:
                tot[key] += mult * t[key]
        tot["bound_by"] = "bytes"
        return tot

    def time_k2(mode):
        dtype = torch.float32 if mode == "strict" else torch.bfloat16
        peak = FP32_FLOPS if mode == "strict" else BF16_FLOPS
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "copy_ms": 0.0}
        flops_t = bytes_t = 0.0
        for (L, nh), mult in _counts(attn_sites).items():
            y = torch.randn(BATCH, L, nh, 64, 3, device=dev, generator=gen).to(dtype)
            q, k, v = y[..., 0], y[..., 1], y[..., 2]
            # SDPA gets contiguous (B, heads, L, 64) copies, made untimed: its
            # best case (on the stride-3 views it takes its slow math path)
            qs, ks, vs = (a.permute(0, 2, 1, 3).contiguous() for a in (q, k, v))
            with torch.inference_mode():
                t = {"ms": cuda_ms(torch, lambda: K2.fused_attention(q, k, v, mode == "fast")),
                     "plain_ms": cuda_ms(torch, lambda: K2._plain_attention(
                         q, k, v, mode == "fast")),
                     "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                         qs, ks, vs)),
                     "copy_ms": cuda_ms(torch, lambda: [K2._to_bh(a) for a in (q, k, v)])}
            flops = 4.0 * BATCH * nh * L * L * 64
            nbytes = 4.0 * BATCH * L * nh * 64 * y.element_size()
            t["bound_ms"] = max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3
            flops_t += mult * flops
            bytes_t += mult * nbytes
            log(f"[6] K2 {mode:6s} B={BATCH} L={L} heads={nh} x{mult}: kernel {t['ms']:.4f} ms "
                f"(of which the q/k/v copy {t['copy_ms']:.4f}), plain {t['plain_ms']:.4f}, "
                f"SDPA {t['library_ms']:.4f}, bound {t['bound_ms']:.4f}; kernel "
                f"{flops / t['ms'] / 1e9:.1f} TFLOP/s")
            for key in tot:
                tot[key] += mult * t[key]
        tot["bound_by"] = "operations" if flops_t / peak > bytes_t / HBM_BYTES_PER_S else "bytes"
        return tot

    k1_t = {"fp32": time_k1(torch.float32), "bf16": time_k1(torch.bfloat16)}
    k2_t = {"strict": time_k2("strict"), "fast": time_k2("fast")}
    for name, tt in list(k1_t.items()) + list(k2_t.items()):
        log(f"[6] per forward at b{BATCH} ({name}): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in tt.items()))

    hr_all = ds.hr_device()
    rates = {}
    for name, c in (("strict", cfg), ("fast", fast_cfg)):
        dtype = torch.bfloat16 if name == "fast" else torch.float32
        m = build_probunet(c, device="meta").to_empty(device=dev).eval()
        m.load_state_dict(model.state_dict())
        fn = make_sample_fn(m, 4, cfg.standardization, MEMBERS, dtype)
        e = torch.randn(MEMBERS, BATCH, cfg.latent_dim)
        batches = [torch.arange(i * BATCH, (i + 1) * BATCH, device=dev) for i in range(nb)]
        with full_fp32():
            for i in range(2):
                fn(hr_all, ds.stats, batches[i % nb], eps=e)
            torch.cuda.synchronize()
            reps = 8
            t0 = time.perf_counter()
            for i in range(reps):
                fn(hr_all, ds.stats, batches[i % nb], eps=e)
            torch.cuda.synchronize()
            per = (time.perf_counter() - t0) / reps
            rates[name] = (BATCH / per, BATCH * MEMBERS / per)
            log(f"[6] sampler {name}: {per * 1e3:.2f} ms per batch of {BATCH} inputs x "
                f"{MEMBERS} members at {RES}x{RES}: {rates[name][0]:.2f} inputs/s, "
                f"{rates[name][1]:.1f} members/s ({card})")
            profile_batch(torch, fn, hr_all, ds.stats, batches[0], e, name)
        del m

    def entry(name, source, replaces, n, err, tol, t, extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "tolerance": tol,
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"], **extra}

    per = f"sum over the {{}} sites of one U-Net forward at b{BATCH}, {RES}x{RES}"
    return [
        entry("gn_silu_fwd", "probunet_torch/csrc/gn_silu.cu",
              "probunet_tpu/ops/pallas_gn.py:72", launches["gn"],
              k1_err[torch.float32], GN_TOL["float32"], k1_t["fp32"],
              {"timed": per.format(K1_PER_BATCH) + ", fp32", "bf16": k1_t["bf16"],
               "bf16_max_abs_err": k1_err[torch.bfloat16]}),
        entry("attention_fwd", "probunet_torch/csrc/attention_fwd.cu",
              "probunet_tpu/ops/pallas_attn.py:69", launches["attn"],
              k2_err["strict"], ATTN_TOL["strict"], k2_t["strict"],
              {"timed": per.format(K2_PER_BATCH) + ", strict fp32", "fast": k2_t["fast"],
               "fast_max_abs_err": k2_err["fast"]}),
    ]


def _counts(sites):
    out = {}
    for s in sites:
        out[s] = out.get(s, 0) + 1
    return out


def profile_batch(torch, fn, hr_all, stats, idx, eps, name):
    """Device time of one sampler batch by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(hr_all, stats, idx, eps=eps)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(getattr(e, "self_device_time_total", 0) for e in events)
    if not total:
        log(f"[6] profile {name}: the profiler saw no device time")
        return
    log(f"[6] profile {name}: device time {total / 1e3:.2f} ms in one batch; top kernels:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"      {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
