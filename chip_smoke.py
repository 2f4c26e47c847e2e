#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts on an NVIDIA GPU.

    python3 chip_smoke.py          # one CUDA card, no arguments

Builds the port's hand-written kernels from ``probunet_torch/csrc`` and
drives the serving path (``probunet_torch.serve.downscale``) and the
training step (``probunet_torch.train.steps.make_probunet_train_step``) at
the full width of the 128x128 Probabilistic U-Net (103,541,083 parameters,
seeded random weights), in strict fp32 and in fast bf16 mode, then the
trainer, then the EDM diffusion downscaler (100,349,315 parameters) served,
stepped and trained. Phases:

  1. card and build: nvidia-smi name and power limit; nvcc for sm_90a with
     ptxas registers, shared memory and spills; ``cuobjdump -sass`` of the
     library: the tensor-core instructions (HMMA, HGMMA) of every attention
     kernel, each of which must have some; K1's plan at the path's largest
     site, its threads, shared memory, registers, spills and cluster
     residency (cudaOccupancyMaxActiveClusters);
  2. K1 GroupNorm+SiLU against its plain version, output and (B, G) mean
     and rstd, at every (H, W, C) of the path at batch 8 and at edge shapes
     (C = 6 without vectors, H*W = 1, B = 1, a view off a 16-byte boundary,
     one shape streamed through shared memory), fp32 and bf16; two calls
     bit-equal; every site of the path planned on chip;
  3. K2 attention against its plain version at the path's (B, L, heads)
     and at L = 100, 1 and 65, strict, fast and strict with bf16
     activations, on the U-Net block's views (read in place), on stride-3
     views (copied first) and on contiguous tensors;
  4. the main path: a checkpoint, then ``downscale`` of synthetic 128x128
     days with 16 members in both modes; files read back and checked;
     launch counters must show 29 K1 and 11 K2 launches per batch, and
     ``kernel_layout`` no copy of q/k/v;
  5. the path against the plain path: one input, two members, the same
     weights and eps, on the card and on the CPU;
  6. timings with CUDA events and by device time (torch.profiler): each
     kernel (K1 per site with its share of the bound; K2 on the block's own
     views, so no q/k/v copy; the wrapper's layout step on those views and
     the copy it makes of stride-3 views, timed), its plain version, one
     PyTorch call computing the same function (a yardstick the port never
     calls), the bound (strict attention: the smaller of the fp32 CUDA-core
     and the 3xTF32 tensor-core bound); the serving rate; a profile of one
     batch;
  7. K3 attention backward against its plain version, and K2's row
     log-sum-exp against logsumexp, in the cases of phase 3; strict mode
     with bf16 activations also against rounded dS (DS_SPLIT_TOL);
  8. the training path: the model with its own init, 10 AdamW steps at b8
     in each mode on a fixed batch and eps with dropout 0.1; launch
     counters must show 29 K1, 11 K2 and 11 K3 launches per step and no
     copy before them; loss and
     gradient norm finite, the loss falling; peak device memory;
  9. one training step on the card against the plain step on the CPU: b=1,
     dropout 0, the same filled weights and eps; loss, gradient norm, every
     gradient and the parameters after the AdamW step;
 10. timings: K3 per U-Net backward on the block's views (kernel, plain,
     bound, the backward of scaled_dot_product_attention as yardstick, by
     events and by device time), K2 with its lse, the
     training rate over 10 steps after 3 warm-up steps, a profile of one
     step;
 11. the trainer (``probunet_torch.train.loop.train_probunet``, the model
     with its own init) on synthetic netCDF (3 train years of 8 days, one
     val and one test year): 2 epochs of 3 steps with eval, CRPS (4
     members) and a metrics record per step, strict and fast; the records'
     keys; launch counters: 29 K1, 11 K2 and 11 K3 per step (plus 29 K1
     and 11 K2 per eval and CRPS batch); ``downscale`` from the trainer's
     checkpoint; exact resume (deterministic cuDNN: 2 steps, then resumed
     to 6, against 6 uninterrupted, parameters bit-equal); streaming
     ingest against resident (2 epochs, the same train and val losses);
     remat on a fixed batch, strict and fast (loss and every gradient
     against the step without it, 57 K1, 22 K2 and 11 K3 launches); the
     trainer's samples/s beside phase 10's bare step, streaming samples/s,
     peak memory, memory held by the forward and ms per step with and
     without remat;
 12. the EDM diffusion downscaler at full width (``ds_model="edm"``; its
     U-Net runs fp32 in both modes, fast mode only sets fast attention):
     card against CPU (the denoiser at b=1, a 4-step Heun chain at b=1, K=2
     from given noise, one DSM step at b=1 with dropout 0 and given sigma
     and noise: loss, gradient norm, every gradient); K2 and K3 on fp32
     operands with fast=True at the path's sites at b8 (the strict limits,
     and bit-equal to fast=False), K1 at every site and K2 at the 128 rows
     of a b8, K=16 pass; ``downscale(ds_model="edm")`` from a checkpoint at
     b2, K=4, 18 steps, strict and fast: 35 x 29 = 1015 K1 and 35 x 11 = 385
     K2 launches per batch, no q/k/v copy, files finite with members that
     differ, ms per batch of the sampler alone, inputs/s and members/s; one
     denoiser pass at 8 and at 128 rows, both modes, by CUDA events and
     device time, and 35 times the 128-row pass printed as the computed
     (not run) cost of one b8 K=16 Heun batch; 3 + 10 DSM steps at b8,
     dropout 0.1, sigma and noise fixed, strict and fast: 29 K1, 11 K2 and
     11 K3 launches per step, the loss falling, ms per step, samples/s, peak
     memory and a profile; ``train_edm`` on phase 11's data, 2 epochs of 3
     steps with eval and CRPS (depth cuts: ``crps_samples`` 2 and
     ``edm_steps`` 4), its records' keys and launch counts, then
     ``downscale`` from its checkpoint.

Any failed phase raises, so the script exits non-zero and prints no
result. The line before the last is the ``kernels`` JSON object, the last
line ``{"ok": true, "device": {...}}``.
"""

import ctypes
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
TF32_FLOPS = 495e12      # tensor cores; strict attention runs 3 TF32 products per fp32 one

RES, BATCH, MEMBERS = 128, 8, 16
DAYS = 32                # four batches of 8 test days
K1_PER_BATCH, K2_PER_BATCH = 29, 11
K3_PER_STEP = 11          # one K3 launch per attention block in the backward
TRAIN_STEPS, WARMUP_STEPS = 10, 3
EXPECTED_PARAMS = 103_541_083
GN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 2 ** -8)}   # (atol, rtol)
# strict: 3xTF32 products against fp32 einsums; fast (and strict with bf16
# activations, whose output is bf16 too): the plain version rounds the
# logits and the weights to bf16 at other points than the kernel
ATTN_TOL = {"strict": 2e-5, "fast": 2e-2, "strict_bf16": 2e-2}
# (q/k/v dtype name, fast) of each attention mode
ATTN_MODES = {"strict": ("float32", False), "fast": ("bfloat16", True),
              "strict_bf16": ("bfloat16", False)}
# the U-Net block's (qkv, head, channel) views (read in place), stride-3
# views of an interleaved qkv tensor (copied first), contiguous tensors
LAYOUTS = ("block", "stride3", "contiguous")
EDGE_SHAPES = [(2, (100, 2)), (2, (1, 2)), (2, (65, 3))]   # (B, (L, heads)) off the path
# (B, H, W, C, what) of K1 off the path; "unaligned" views x 4 bytes past a
# 16-byte boundary (the scalar kernel), "streamed" plans off chip (x read twice)
K1_EDGE = [(3, 5, 7, 6, "C=6, no vectors"), (4, 1, 1, 128, "H*W=1"), (1, 32, 32, 384, "B=1"),
           (2, 16, 16, 256, "unaligned"), (1, 256, 256, 64, "streamed")]
# the whole path, card against CPU, strict fp32: cuDNN and oneDNN sum the
# convolutions in other orders through ~60 layers of random weights
PATH_TOL = 1e-3
# K3 against its plain version, max |err| / max(1e-3, max |ref|): the
# tolerances of tests/test_pallas_attn.py:48; fp32 sums in another order
# (strict), bf16 results and weights rounded at other points (bf16)
ATTN_BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# strict mode with bf16 activations keeps dS in fp32 (as two bf16 terms):
# its dq and dk against the plain strict backward with K3's D
# (plain_dq_dk), ||err||_2 / ||ref||_2, must stay under this limit, which
# rounding dS to bf16 (the same kernel in fast mode, and plain_dq_dk with
# dS rounded) must exceed on the same inputs, so the check tells them apart
DS_SPLIT_TOL = 6e-4
# one training step, card against CPU, strict fp32 (phase 9): the loss and
# the gradient norm relative to their size, each gradient relative to its
# tensor's largest entry (cuDNN's and oneDNN's backward convolutions sum in
# other orders through ~60 layers and back); parameters after the AdamW step
# in absolute terms (fp32 rounding of the weights), compared only where the
# gradient is clear of the gradient error: Adam's first step moves each
# element by about lr * sign(g), so where |g| lies within that error of
# zero the two sides can part by 2 lr
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_PARAM_TOL = 1e-4, 1e-3, 1e-6
# phase 11: 3 train years of 8 days at batch 8 give 3 steps per epoch
TRAINER_DAYS, TRAINER_EPOCHS, REMAT_TIMED_STEPS = 8, 2, 4
# the keys of each metrics record the JAX loop writes (tests/test_torch_trainer.py
# holds the port's records against the JAX loop's): one per step
# (log_every=1), then per epoch the eval record and the CRPS record
STEP_KEYS = {"train_loss", "recon_loss", "kl_div", "beta", "grad_norm", "samples_per_sec",
             "step", "time"}
EPOCH_KEYS = {"epoch", "epoch_train_loss", "val_loss", "val_recon_loss", "val_kl_div", "val-loss",
              "val_beta", "step", "time"}
CRPS_KEYS = {f"{k}_{v}" for k in ("crps", "ensmean_mae") for v in ("pr", "tasmin", "tasmax")} | {
    "crps_batches_evaluated", "step", "time"}
# remat, strict, deterministic cuDNN: the recompute replays the forward's
# work, so loss and gradients agree to fp32 summation order at most: loss
# relative, each gradient's max|err| relative to its tensor's largest entry
REMAT_TOL = 1e-5
# streaming against resident ingest (deterministic cuDNN, pertimestep
# statistics per sample either way): the train and val losses, relative
STREAM_TOL = 1e-6
# phase 12, EDM: the denoiser (the same U-Net, 6 input channels, the noise
# embedding) at full width; the Heun sampler's S steps run 2 S - 1 passes;
# serving at b2 with K=4 members folds 8 chains into each pass, a b8 K=16
# batch 128; the card-vs-CPU chain and the trainer's CRPS chain take 4 steps
EDM_EXPECTED_PARAMS = 100_349_315
EDM_STEPS, EDM_CHAIN_STEPS = 18, 4
EDM_SERVE_BATCH, EDM_SERVE_MEMBERS = 2, 4
EDM_STEP_KEYS = {"train_loss", "grad_norm", "samples_per_sec", "step", "time"}
EDM_EPOCH_KEYS = {"epoch", "epoch_train_loss", "val_loss", "val-loss", "step", "time"}


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
    sass = sass_census(_build)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        result = run_phases(torch, dev, card, sass)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": result}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def sass_census(_build):
    """Tensor-core instructions (HMMA: mma.sync, HGMMA: wgmma) per attention
    kernel function in the built library, by ``cuobjdump -sass``. Raises if
    a function is missing or has none: every mode of K2 and K3 runs on the
    tensor cores."""
    import re

    dump = subprocess.run([_build.find_tool("cuobjdump"), "-sass", str(_build.LIB_PATH)],
                          capture_output=True, text=True, check=True).stdout
    types = {"f": "fp32", "13__nv_bfloat16": "bf16"}
    counts, cur = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            m = re.search(r"(attention_(?:fwd|bwd_dkdv|bwd_dq|bwd_rowdot))I(f|13__nv_bfloat16)"
                          r"(?:Lb([01]))?E", line)
            cur = None
            if m:
                mode = {None: "", "0": ", strict", "1": ", fast"}[m.group(3)]
                cur = f"{m.group(1)}<{types[m.group(2)]}{mode}>"
                counts[cur] = {"HMMA": 0, "HGMMA": 0}
        elif cur is not None:
            op = re.search(r"\b(HGMMA|HMMA)\.", line)
            if op:
                counts[cur][op.group(1)] += 1
    for name, c in sorted(counts.items()):
        log(f"[1] SASS {name}: {c['HMMA']} HMMA, {c['HGMMA']} HGMMA")
    want = 2 + 3 + 3 + 2   # fwd x2 dtypes; dkdv, dq x (fp32, bf16 strict, bf16 fast); rowdot x2
    if len(counts) != want or any(c["HMMA"] + c["HGMMA"] == 0 for c in counts.values()):
        raise AssertionError(f"expected {want} attention kernels, each with tensor-core "
                             f"instructions; found {counts}")
    return counts


def k1_kernel_info(torch, K1, site, num_sms):
    """K1's plan at ``site`` (H, W, C) at batch 8 and what the kernel of
    that plan is on this card, fp32 and bf16: threads, dynamic and static
    shared bytes, registers, spilled bytes and the clusters of the plan that
    can be resident at once (cudaOccupancyMaxActiveClusters). Raises if no
    cluster fits."""
    from probunet_torch.ops import _build
    from probunet_torch.ops.norm import num_groups_for

    h, w, c = site
    g = num_groups_for(c)
    keys = ("max_active_clusters", "threads", "dynamic_smem", "registers", "local_bytes",
            "static_smem")
    info = {"site": [BATCH, h, w, c]}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        p = K1.plan(BATCH, h, w, c, g, dtype.itemsize, num_sms)
        buf = (ctypes.c_int * len(keys))()
        _build.check(_build.lib().probunet_gn_silu_query(
            int(dtype == torch.bfloat16), 16 // dtype.itemsize, c, g, p.cb, p.n, p.chunk_rows,
            buf), "gn_silu query")
        d = {**p._asdict(), **dict(zip(keys, buf)), "blocks": BATCH * c // p.cb * p.n}
        info[name] = d
        log(f"[1] K1 {name} at {BATCH}x{h}x{w}x{c}: cb {p.cb} ({c // p.cb} channel blocks), "
            f"clusters of {p.n} x {d['threads']} threads, {p.rows} rows per block, on chip "
            f"{p.on_chip}; {d['dynamic_smem']} B dynamic + {d['static_smem']} B static shared "
            f"per block, {d['registers']} registers, {d['local_bytes']} B spilled; "
            f"{d['max_active_clusters']} clusters resident at once "
            f"({d['max_active_clusters'] * p.n} blocks on {num_sms} SMs) of {d['blocks'] // p.n}")
        if d["max_active_clusters"] < 1:
            raise AssertionError("no K1 cluster of the largest site fits on the card")
    return info


def qkv_views(torch, layout, b, L, nh, dtype, dev, gen):
    """q, k, v of shape (b, L, nh, 64) in ``layout`` (see LAYOUTS)."""
    if layout == "block":
        return torch.randn(b, L, 3, nh, 64, device=dev, generator=gen).to(dtype).unbind(2)
    if layout == "stride3":
        y = torch.randn(b, L, nh, 64, 3, device=dev, generator=gen).to(dtype)
        return y[..., 0], y[..., 1], y[..., 2]
    return tuple(torch.randn(b, L, nh, 64, device=dev, generator=gen).to(dtype)
                 for _ in range(3))


def device_ms(torch, fn, reps=50, traces=5, warm=True):
    """Mean device time per call of ``fn`` in ms: the kernels' own time from
    torch.profiler, free of the host's launch pace. A trace that comes back
    with no device activity (the profiler now and then loses the records of
    a window of short kernels) is logged and taken again, up to ``traces``
    times. ``warm=False`` skips the warm-up call (``fn`` ran just before)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    if warm:
        fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
        if total:
            return total / 1e3 / reps
        log("    torch.profiler saw no device time in this trace; tracing again")
    raise AssertionError(f"torch.profiler saw no device time in {traces} traces")


def attn_bound(flops, nbytes, mode):
    """The bound terms in ms of one attention site's work, ``flops`` and
    ``nbytes``: fast against the bf16 tensor-core rate; strict (fp32, or
    bf16 activations with fp32 products) against the smaller of the fp32
    CUDA-core time and three TF32 tensor-core products. Summed over sites."""
    mem = nbytes / HBM_BYTES_PER_S * 1e3
    if mode == "fast":
        ops = flops / BF16_FLOPS * 1e3
        return {"bound_ms": max(ops, mem), "ops_ms": ops, "bytes_ms": mem}
    fp32, tf32x3 = flops / FP32_FLOPS * 1e3, 3 * flops / TF32_FLOPS * 1e3
    return {"bound_ms": max(min(fp32, tf32x3), mem), "ops_ms": min(fp32, tf32x3),
            "bytes_ms": mem, "bound_fp32_ms": max(fp32, mem), "bound_3xtf32_ms": max(tf32x3, mem)}


def attn_totals(tot, flops):
    """Per-pass totals of summed site timings: what bounds them, which strict
    bound is the row's, and the kernel's rate."""
    tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
    if "bound_3xtf32_ms" in tot:
        tot["bound_rule"] = "3xtf32" if tot["bound_3xtf32_ms"] <= tot["bound_fp32_ms"] else "fp32"
    tot["tflops"] = flops / tot["ms"] / 1e9
    tot["device_tflops"] = flops / tot["device_ms"] / 1e9
    return tot


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


def census(torch, model, forward):
    """(H, W, C) of every GroupNorm+SiLU site and (L, heads) of every
    attention block of ``model`` in one call of ``forward()``, by hooks."""
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
        forward()
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


def run_phases(torch, dev, card, sass):
    import numpy as np
    import torch.nn.functional as F

    from probunet_torch.config import Config
    from probunet_torch.data.dataset import ClimexDataset
    from probunet_torch.data.netcdf import NetCDFFile
    from probunet_torch.data.synthetic import generate_climex_like
    from probunet_torch.models.unet import build_unet_plan, gn_silu_sites
    from probunet_torch.ops import attention as K2
    from probunet_torch.ops import gn_silu as K1
    from probunet_torch.ops.norm import group_stats, num_groups_for
    from probunet_torch.serve import downscale
    from probunet_torch.train.checkpoint import save_checkpoint
    from probunet_torch.train.loop import build_probunet
    from probunet_torch.train.state import TrainState
    from probunet_torch.train.steps import make_sample_fn
    from probunet_torch.utils.device import full_fp32

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1)
    clock = [time.perf_counter()]

    def mark(phase):
        now = time.perf_counter()
        log(f"[{phase}] phase wall time {now - clock[0]:.1f} s")
        clock[0] = now

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
    x_census = torch.randn(BATCH, RES, RES, 3, device=dev)
    gn_sites, attn_sites = census(torch, model, lambda: model.unet(x_census))
    log(f"[2] K1 sites per forward: {len(gn_sites)}; [3] K2 sites: {len(attn_sites)}")
    if (len(gn_sites), len(attn_sites)) != (K1_PER_BATCH, K2_PER_BATCH):
        raise AssertionError("unexpected kernel sites on the path")
    if sorted(gn_sites) != sorted(gn_silu_sites(*build_unet_plan(
            (RES, RES), 4, cfg.model_channels, cfg.channel_mult, cfg.num_blocks,
            cfg.attn_resolutions), (RES, RES))):
        raise AssertionError("the hooks' K1 sites differ from models.unet.gn_silu_sites")
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k1_info = k1_kernel_info(torch, K1, max(gn_sites, key=math.prod), num_sms)

    # ---- 2. K1 against its plain version -------------------------------------
    for dtype in (torch.float32, torch.bfloat16):
        off = [site for site in gn_sites if not K1.plan(
            BATCH, *site, num_groups_for(site[2]), dtype.itemsize, num_sms).on_chip]
        if off:
            raise AssertionError(f"K1 sites planned off chip in {dtype}: {off}")
    log(f"[2] K1: all {len(gn_sites)} sites of the path planned on chip in fp32 and bf16")
    k1_err = {}
    cases = [(BATCH, h, w, c, "path") for (h, w, c) in sorted(set(gn_sites))] + K1_EDGE
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = GN_TOL[str(dtype).split(".")[1]]
        worst = 0.0
        for (b, h, w, c, what) in cases:
            g = num_groups_for(c)
            p = K1.plan(b, h, w, c, g, dtype.itemsize, num_sms)
            x = (torch.randn(b, h, w, c, device=dev, generator=gen) + 0.5).to(dtype)
            if what == "unaligned":   # one element into a fresh buffer
                x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(b, h, w, c)
            gamma = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
            beta = 0.1 * torch.randn(c, device=dev, generator=gen)
            with torch.inference_mode():
                out, mean, rstd = K1.gn_silu(x, gamma, beta, g, return_stats=True)
                again = K1.gn_silu(x, gamma, beta, g, return_stats=True)
                ref = K1._plain_gn_silu(x, gamma, beta, g)[0]
                rmean, rrstd = group_stats(x, g)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            worst = max(worst, d.max().item())
            stats_err = max((mean - rmean).abs().max().item(), (rstd - rrstd).abs().max().item())
            same = all(torch.equal(a, b_) for a, b_ in zip(again, (out, mean, rstd)))
            ok = bool((d <= atol + rtol * ref.float().abs()).all()) and same
            ok &= torch.allclose(mean, rmean, rtol=1e-5, atol=1e-5)
            ok &= torch.allclose(rstd, rrstd, rtol=1e-5, atol=1e-5)
            ok &= (what == "streamed") != p.on_chip
            ok &= (what == "unaligned") == bool(x.data_ptr() % 16)
            log(f"[2] K1 {str(dtype)[6:]:8s} {b}x{h}x{w}x{c} G={g} ({what}; cb {p.cb}, cluster "
                f"{p.n}, {p.rows} rows/block, {'on chip' if p.on_chip else 'streamed'}): max abs "
                f"err {d.max().item():.3e} (atol {atol}, rtol {rtol:.3g}), mean/rstd "
                f"{stats_err:.2e}, two calls bit-equal {same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("K1 disagrees with its plain version")
        k1_err[dtype] = worst

    mark(2)

    # ---- 3. K2 against its plain version -------------------------------------
    k2_err = {}
    shapes = [(BATCH, s) for s in sorted(set(attn_sites), reverse=True)] + EDGE_SHAPES
    for mode, (dname, fast) in ATTN_MODES.items():
        dtype, tol, worst = getattr(torch, dname), ATTN_TOL[mode], 0.0
        for layout in LAYOUTS:
            for b, (L, nh) in shapes:
                q, k, v = qkv_views(torch, layout, b, L, nh, dtype, dev, gen)
                with torch.inference_mode():
                    out = K2.fused_attention(q, k, v, fast)
                    ref = K2._plain_attention(q, k, v, fast)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
                worst = max(worst, err)
                log(f"[3] K2 {mode:11s} {layout:10s} B={b} L={L} heads={nh}: max abs err "
                    f"{err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("K2 disagrees with its plain version")
        k2_err[mode] = worst

    mark(3)

    # ---- 4. the main path ----------------------------------------------------
    ckpt = os.path.join(WORK, "ckpt")
    save_checkpoint(ckpt, TrainState(model, None))   # parameters only, as serving holds them
    nb = DAYS // BATCH
    K1.gn_silu.launches = 0
    K2.fused_attention.launches = 0
    K2.attention_bwd.launches = 0
    K2.kernel_layout.copies = 0
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
    launches = {"gn": K1.gn_silu.launches, "attn": K2.fused_attention.launches,
                "attn_bwd": K2.attention_bwd.launches}
    copies = K2.kernel_layout.copies
    want = (2 * nb * K1_PER_BATCH, 2 * nb * K2_PER_BATCH, 0)
    log(f"[4] q/k/v copies before the attention launches: {copies}")
    if (launches["gn"], launches["attn"], launches["attn_bwd"]) != want or copies:
        raise AssertionError(f"launches {launches}, expected {want} "
                             f"({K1_PER_BATCH} K1 and {K2_PER_BATCH} K2 per batch); "
                             f"{copies} tensors copied before a launch, expected 0")
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

    mark(4)

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
    mark(5)

    # ---- 6. timings ----------------------------------------------------------
    def time_k1(dtype):
        tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "library_device_ms": 0.0, "bound_ms": 0.0}
        for (h, w, c), mult in _counts(gn_sites).items():
            g = num_groups_for(c)
            x = torch.randn(BATCH, h, w, c, device=dev, generator=gen).to(dtype)
            gamma = torch.ones(c, device=dev)
            beta = torch.zeros(c, device=dev)
            xc = x.permute(0, 3, 1, 2)            # NCHW view, channels_last
            gl, bl = gamma.to(dtype), beta.to(dtype)

            def run():
                return K1.gn_silu(x, gamma, beta, g)

            def lib():
                return F.silu(F.group_norm(xc, g, gl, bl, 1e-5))

            with torch.inference_mode():
                t = {"ms": cuda_ms(torch, run), "device_ms": device_ms(torch, run),
                     "plain_ms": cuda_ms(torch, lambda: K1._plain_gn_silu(x, gamma, beta, g)),
                     "library_ms": cuda_ms(torch, lib), "library_device_ms": device_ms(torch, lib)}
            t["bound_ms"] = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
            log(f"[6] K1 {str(dtype)[6:]:8s} {BATCH}x{h}x{w}x{c} x{mult}: kernel "
                f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}: "
                f"{t['bound_ms'] / t['device_ms']:.0%} of the bound), plain "
                f"{t['plain_ms']:.4f}, F.group_norm+silu {t['library_ms']:.4f} (device "
                f"{t['library_device_ms']:.4f}), bound {t['bound_ms']:.4f}")
            for key in tot:
                tot[key] += mult * t[key]
        tot["bound_by"] = "bytes"
        tot["bound_share_device"] = tot["bound_ms"] / tot["device_ms"]
        tot["bound_share_events"] = tot["bound_ms"] / tot["ms"]
        return tot

    def time_k2(mode):
        dtype = getattr(torch, ATTN_MODES[mode][0])
        tot, flops_t = {}, 0.0
        for (L, nh), mult in _counts(attn_sites).items():
            # the block's own views of its qkv conv output: read in place
            q, k, v = qkv_views(torch, "block", BATCH, L, nh, dtype, dev, gen)
            q3, k3, v3 = qkv_views(torch, "stride3", BATCH, L, nh, dtype, dev, gen)
            # SDPA gets contiguous (B, heads, L, 64) copies, made untimed: its
            # best case (on strided views it takes its slow math path)
            qs, ks, vs = (a.permute(0, 2, 1, 3).contiguous() for a in (q, k, v))

            def run():
                return K2.fused_attention(q, k, v, mode == "fast")

            def lib():
                return F.scaled_dot_product_attention(qs, ks, vs)

            with torch.inference_mode():
                K2.kernel_layout.copies = 0
                # copy_ms: what the wrapper's layout step costs on these views
                t = {"ms": cuda_ms(torch, run), "device_ms": device_ms(torch, run),
                     "copy_ms": cuda_ms(torch, lambda: [K2.kernel_layout(a) for a in (q, k, v)])}
                if K2.kernel_layout.copies:
                    raise AssertionError("the block's q/k/v views were copied")
                t.update({"plain_ms": cuda_ms(torch, lambda: K2._plain_attention(
                              q, k, v, mode == "fast")),
                          "library_ms": cuda_ms(torch, lib),
                          "library_device_ms": device_ms(torch, lib),
                          "stride3_copy_ms": cuda_ms(torch, lambda: [
                              K2.kernel_layout(a) for a in (q3, k3, v3)]),
                          "stride3_ms": cuda_ms(torch, lambda: K2.fused_attention(
                              q3, k3, v3, mode == "fast"))})
            flops = 4.0 * BATCH * nh * L * L * 64
            nbytes = 4.0 * BATCH * L * nh * 64 * q.element_size()
            t.update(attn_bound(flops, nbytes, mode))
            flops_t += mult * flops
            log(f"[6] K2 {mode:6s} B={BATCH} L={L} heads={nh} x{mult}: kernel {t['ms']:.4f} ms "
                f"(device {t['device_ms']:.4f}; layout step {t['copy_ms']:.4f}, no copy; on "
                f"stride-3 views with the copy {t['stride3_ms']:.4f}, the copy alone "
                f"{t['stride3_copy_ms']:.4f}), plain {t['plain_ms']:.4f}, SDPA "
                f"{t['library_ms']:.4f} (device {t['library_device_ms']:.4f}), bound "
                f"{t['bound_ms']:.4f}; kernel "
                f"{flops / t['ms'] / 1e9:.1f} TFLOP/s by events, "
                f"{flops / t['device_ms'] / 1e9:.1f} by device time")
            for key, val in t.items():
                tot[key] = tot.get(key, 0.0) + mult * val
        return attn_totals(tot, flops_t)

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
            profile(torch, lambda: fn(hr_all, ds.stats, batches[0], eps=e),
                    f"sampler {name}", "one batch")
        del m
    mark(6)

    train = training_phases(torch, dev, cfg, ds, ds_cpu, attn_sites, gen, mark)
    trainer = trainer_phase(torch, dev, card, train["rates"], mark)
    edm = edm_phase(torch, dev, card, ds, ds_cpu, gen, mark)

    def entry(name, source, replaces, n, err, tol, t, extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "tolerance": tol,
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"], **extra}

    per = f"sum over the {{}} sites of one U-Net forward at b{BATCH}, {RES}x{RES}"
    by_path = {key: {"serve": launches[key], "train": train["launches"][key],
                     "trainer": trainer["launches"][key],
                     **{f"edm_{path}": n[key] for path, n in edm["launches"].items()}}
               for key in ("gn", "attn", "attn_bwd")}
    launches = {key: sum(by_path[key].values()) for key in by_path}
    return [
        entry("gn_silu_fwd", "probunet_torch/csrc/gn_silu.cu",
              "probunet_tpu/ops/pallas_gn.py:72", launches["gn"],
              k1_err[torch.float32], GN_TOL["float32"], k1_t["fp32"],
              {"timed": per.format(K1_PER_BATCH) + ", fp32", "device_ms": k1_t["fp32"]["device_ms"],
               "library_device_ms": k1_t["fp32"]["library_device_ms"], "fp32": k1_t["fp32"],
               "bf16": k1_t["bf16"], "bf16_max_abs_err": k1_err[torch.bfloat16],
               "launches_by_path": by_path["gn"], "largest_site": k1_info,
               "edm_128_rows_max_abs_err": edm["k1_err"]}),
        entry("attention_fwd", "probunet_torch/csrc/attention_fwd.cu",
              "probunet_tpu/ops/pallas_attn.py:69", launches["attn"],
              k2_err["strict"], ATTN_TOL["strict"], k2_t["strict"],
              {"timed": per.format(K2_PER_BATCH) + ", strict fp32, on the block's views",
               "strict": k2_t["strict"], "fast": k2_t["fast"],
               "max_abs_err_by_mode": k2_err, "launches_by_path": by_path["attn"],
               "edm_fp32_fast_max_abs_err": edm["k2_err"], "edm": edm["report"],
               "with_lse": train["k2_lse"],
               "sass": {n: c for n, c in sass.items() if n.startswith("attention_fwd")}}),
        entry("attention_bwd", "probunet_torch/csrc/attention_bwd.cu",
              "probunet_tpu/ops/pallas_attn.py:91", launches["attn_bwd"],
              train["k3_err"]["float32"], ATTN_BWD_TOL, train["k3_t"]["strict"],
              {"timed": f"sum over the {K2_PER_BATCH} sites of one U-Net backward at b{BATCH}, "
                        f"{RES}x{RES}, strict fp32, on the block's views",
               "strict": train["k3_t"]["strict"], "fast": train["k3_t"]["fast"],
               "max_rel_err": train["k3_rel"], "strict_bf16_ds_check": train["ds_check"],
               "launches_by_path": by_path["attn_bwd"],
               "edm_fp32_fast_max_rel_err": edm["k3_rel"],
               "training": train["rates"], "trainer": trainer["report"],
               "sass": {n: c for n, c in sass.items() if n.startswith("attention_bwd")}}),
    ]


def training_phases(torch, dev, cfg, ds, ds_cpu, attn_sites, gen, mark):
    """Phases 7-10: K3 on its own, the training path, the step against the
    plain step on the CPU, and the timings. Returns the launch counts of the
    training path, K3's errors and times, K2's time with its lse, and the
    training rates."""
    import torch.nn.functional as F

    from probunet_torch.ops import attention as K2
    from probunet_torch.ops import gn_silu as K1
    from probunet_torch.train.loop import build_probunet, init_probunet_state
    from probunet_torch.train.state import create_train_state, make_optimizer
    from probunet_torch.train.steps import beta_schedule, make_probunet_train_step
    from probunet_torch.utils.device import full_fp32

    # ---- 7. K3 against its plain version -------------------------------------
    k3_abs, k3_rel = {}, {}
    ds_seen = {"kernel": 0.0, "kernel_rounded": math.inf, "plain_rounded": math.inf,
               "kernel_vs_plain_version": 0.0}
    shapes = [(BATCH, s) for s in sorted(set(attn_sites), reverse=True)] + EDGE_SHAPES
    for mode, (dname, fast) in ATTN_MODES.items():
        dtype = getattr(torch, dname)
        tol = ATTN_BWD_TOL[dname]
        for layout in LAYOUTS:
            for b, (L, nh) in shapes:
                q, k, v = qkv_views(torch, layout, b, L, nh, dtype, dev, gen)
                do = torch.randn(b, L, nh, 64, device=dev, generator=gen).to(dtype)
                with torch.no_grad():
                    out, lse = K2._launch(*map(K2.kernel_layout, (q, k, v)), with_lse=True)
                    got = K2.attention_bwd(q, k, v, out, lse, do, fast)
                    ref = K2._plain_attention_bwd(q, k, v, do, fast)
                    k2 = (k / 8).to(dtype) if fast else k.float() / 8
                    ref_lse = torch.logsumexp(torch.einsum("bqhc,bkhc->bhqk", q.float(),
                                                           k2.float()), dim=-1).reshape(b * nh, L)
                torch.cuda.synchronize()
                errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(got, ref)]
                rels = [e / max(1e-3, r.float().abs().max().item()) for e, r in zip(errs, ref)]
                lse_err = (lse - ref_lse).abs().max().item()
                ok = max(rels) <= tol and lse_err <= 1e-4 and all(g.dtype == dtype for g in got)
                k3_abs[mode] = max(k3_abs.get(mode, 0.0), max(errs))
                k3_rel[mode] = max(k3_rel.get(mode, 0.0), max(rels))
                log(f"[7] K3 {mode:11s} {layout:10s} B={b} L={L} heads={nh}: max abs err "
                    f"dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, / max|ref| "
                    f"{max(rels):.3e} (tol {tol}); K2 lse max abs err {lse_err:.3e} (tol 1e-4) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("K3 or K2's lse disagrees with its plain version")
                if mode == "strict_bf16" and L > 1:   # at L=1 dS is exactly 0
                    split_ds_check(torch, K2, q, k, v, out, lse, do, got, ref, ds_seen,
                                   f"{layout:10s} B={b} L={L} heads={nh}")
    log(f"[7] K3 strict_bf16 dS check, over all cases: dq/dk err of the kernel at most "
        f"{ds_seen['kernel']:.3e}; with dS rounded at least {ds_seen['kernel_rounded']:.3e} "
        f"(kernel), {ds_seen['plain_rounded']:.3e} (plain); limit {DS_SPLIT_TOL}; the kernel "
        f"against _plain_attention_bwd at most {ds_seen['kernel_vs_plain_version']:.3e}")
    mark(7)

    # ---- 8. the training path --------------------------------------------------
    train_cfgs = {"strict": cfg.replace(dropout=0.1),
                  "fast": cfg.replace(dropout=0.1, compute_dtype="bfloat16", fast_attention=True,
                                      opt_state_dtype="bfloat16")}
    hr_all = ds.hr_device()
    fixed_idx = torch.arange(BATCH, device=dev)
    fixed_eps = torch.randn(BATCH, cfg.latent_dim, generator=torch.Generator().manual_seed(3))
    runs, counts = {}, {"gn": 0, "attn": 0, "attn_bwd": 0}
    for name, c in train_cfgs.items():
        dtype = torch.bfloat16 if c.compute_dtype == "bfloat16" else torch.float32
        tx = make_optimizer(c.lr, c.weight_decay, c.accum, c.optimizer, None, c.opt_state_dtype)
        state = init_probunet_state(c, build_probunet(c, device="meta"), tx, device=dev)
        step = make_probunet_train_step(
            state.model, c.lowres_scale, c.standardization,
            beta_schedule(c.beta_schedule, c.beta, c.beta_warmup_steps), dtype, c.accum)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K1.gn_silu.launches = K2.fused_attention.launches = K2.attention_bwd.launches = 0
        K2.kernel_layout.copies = 0
        t0 = time.perf_counter()
        ms = [step(state, hr_all, ds.stats, fixed_idx, c.seed, eps=fixed_eps.to(dev))
              for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = (K1.gn_silu.launches, K2.fused_attention.launches, K2.attention_bwd.launches)
        copies = K2.kernel_layout.copies
        want = (TRAIN_STEPS * K1_PER_BATCH, TRAIN_STEPS * K2_PER_BATCH, TRAIN_STEPS * K3_PER_STEP)
        losses = [m["train_loss"].item() for m in ms]
        norms = [m["grad_norm"].item() for m in ms]
        log(f"[8] train {name}: {TRAIN_STEPS} steps at b{BATCH} in {wall:.2f} s; launches K1 "
            f"{n[0]}, K2 {n[1]}, K3 {n[2]} (expected {want}); q/k/v/out/dO copies before "
            f"the attention launches {copies}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"[8] train {name}: loss {[round(x, 1) for x in losses]}")
        log(f"[8] train {name}: grad norm {[round(x, 2) for x in norms]}; kl "
            f"{ms[-1]['kl_div'].item():.4g}, beta {ms[-1]['beta']}")
        if n != want or copies:
            raise AssertionError(f"training launches {n}, expected {want} ({K1_PER_BATCH} K1, "
                                 f"{K2_PER_BATCH} K2 and {K3_PER_STEP} K3 per step); {copies} "
                                 f"tensors copied before a launch, expected 0")
        if not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"{name}: non-finite loss or gradient norm")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: the loss did not fall on a fixed batch")
        for key, val in zip(("gn", "attn", "attn_bwd"), n):
            counts[key] += val
        runs[name] = (state, step, c)
    mark(8)

    # ---- 9. one step on the card against the plain step on the CPU ---------------
    c9 = cfg.replace(dropout=0.0)
    card_model = build_probunet(c9, device="meta").to_empty(device=dev)
    fill_weights(torch, card_model, seed=9)
    cpu_model = build_probunet(c9, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict(card_model.state_dict())
    eps1 = torch.randn(1, cfg.latent_dim, generator=torch.Generator().manual_seed(4))
    res = {}
    for where, m, d in (("card", card_model, ds), ("cpu", cpu_model, ds_cpu)):
        state = create_train_state(m, make_optimizer(c9.lr, c9.weight_decay))
        idx = torch.tensor([3], device=d.device)
        t0 = time.perf_counter()
        metrics = make_probunet_train_step(m, c9.lowres_scale, c9.standardization)(
            state, d.hr_device(), d.stats, idx, 0, eps=eps1)
        loss = metrics["train_loss"].item()
        res[where] = (loss, metrics["grad_norm"].item(),
                      {k: p.grad.detach().cpu() for k, p in m.named_parameters()},
                      {k: p.detach().cpu() for k, p in m.named_parameters()})
        log(f"[9] one step on the {where}: {time.perf_counter() - t0:.1f} s, loss {loss:.6g}, "
            f"grad norm {res[where][1]:.6g}")
    (l_c, n_c, g_c, p_c), (l_r, n_r, g_r, p_r) = res["card"], res["cpu"]
    loss_rel, norm_rel = abs(l_c - l_r) / abs(l_r), abs(n_c - n_r) / n_r
    grad_rel, worst, param_err, compared = 0.0, "", 0.0, 0
    for k in g_r:
        scale = g_r[k].abs().max().item()
        if scale == 0.0:   # map_layer* and the emb-fed affine weights: zero on both sides
            if g_c[k].abs().max().item() != 0.0:
                raise AssertionError(f"{k}: gradient should be zero")
            continue
        rel = (g_c[k] - g_r[k]).abs().max().item() / scale
        if rel > grad_rel:
            grad_rel, worst = rel, k
        clear = g_r[k].abs() > 10 * STEP_GRAD_TOL * scale
        compared += int(clear.sum())
        if clear.any():
            param_err = max(param_err, (p_c[k] - p_r[k])[clear].abs().max().item())
    total = sum(p.numel() for p in p_r.values())
    ok = (loss_rel <= STEP_LOSS_TOL and norm_rel <= STEP_LOSS_TOL
          and grad_rel <= STEP_GRAD_TOL and param_err <= STEP_PARAM_TOL)
    log(f"[9] card vs CPU (b=1, {RES}x{RES}, strict fp32): loss rel err {loss_rel:.3e}, grad "
        f"norm rel err {norm_rel:.3e} (tol {STEP_LOSS_TOL}); worst gradient max|err| / max|g| "
        f"{grad_rel:.3e} ({worst}; tol {STEP_GRAD_TOL}); parameters after AdamW max abs err "
        f"{param_err:.3e} (tol {STEP_PARAM_TOL}) over the {compared:,} of {total:,} elements "
        f"whose gradient is clear of the error {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the training step on the card disagrees with the plain step")
    del card_model, cpu_model, res
    mark(9)

    # ---- 10. timings -------------------------------------------------------------
    def time_k3(mode):
        dtype, fast = getattr(torch, ATTN_MODES[mode][0]), ATTN_MODES[mode][1]
        tot, flops_t = {}, 0.0
        for (L, nh), mult in _counts(attn_sites).items():
            q, k, v = qkv_views(torch, "block", BATCH, L, nh, dtype, dev, gen)
            do = torch.randn(BATCH, L, nh, 64, device=dev, generator=gen).to(dtype)
            with torch.no_grad():
                out, lse = K2._launch(q, k, v, with_lse=True)   # the block's views, in place
            # the yardstick: SDPA's backward on contiguous (B, heads, L, 64)
            # copies, made untimed, its forward outside the timed region
            qs, ks, vs = (a.permute(0, 2, 1, 3).contiguous().requires_grad_() for a in (q, k, v))
            os_ = F.scaled_dot_product_attention(qs, ks, vs)
            dos = do.permute(0, 2, 1, 3).contiguous()

            def run():
                return K2.attention_bwd(q, k, v, out, lse, do, fast)

            def lib():
                return torch.autograd.grad(os_, (qs, ks, vs), dos, retain_graph=True)

            with torch.no_grad():
                t = {"ms": cuda_ms(torch, run), "device_ms": device_ms(torch, run),
                     "plain_ms": cuda_ms(torch, lambda: K2._plain_attention_bwd(q, k, v, do, fast),
                                         reps=5)}
            t["library_ms"] = cuda_ms(torch, lib)
            t["library_device_ms"] = device_ms(torch, lib)
            flops = 10.0 * BATCH * nh * L * L * 64
            # q, k, v, o, dO read and dq, dk, dv written once, plus the fp32 lse
            nbytes = 8.0 * BATCH * L * nh * 64 * q.element_size() + 4.0 * BATCH * nh * L
            t.update(attn_bound(flops, nbytes, mode))
            flops_t += mult * flops
            log(f"[10] K3 {mode:6s} B={BATCH} L={L} heads={nh} x{mult}: kernel {t['ms']:.4f} ms "
                f"(device {t['device_ms']:.4f}), plain {t['plain_ms']:.4f}, SDPA backward "
                f"{t['library_ms']:.4f} (device {t['library_device_ms']:.4f}), bound "
                f"{t['bound_ms']:.4f}; kernel {flops / t['ms'] / 1e9:.1f} TFLOP/s by events, "
                f"{flops / t['device_ms'] / 1e9:.1f} by device time (of the 10 L^2 64 FLOP "
                f"per head)")
            for key, val in t.items():
                tot[key] = tot.get(key, 0.0) + mult * val
        return attn_totals(tot, flops_t)

    def time_k2_lse(mode):
        dtype = getattr(torch, ATTN_MODES[mode][0])
        tot = {"ms": 0.0, "without_lse_ms": 0.0}
        for (L, nh), mult in _counts(attn_sites).items():
            q, k, v = qkv_views(torch, "block", BATCH, L, nh, dtype, dev, gen)
            tot["ms"] += mult * cuda_ms(torch, lambda: K2._launch(q, k, v, with_lse=True))
            tot["without_lse_ms"] += mult * cuda_ms(torch, lambda: K2._launch(q, k, v, False))
        return tot

    with full_fp32():
        k3_t = {mode: time_k3(mode) for mode in ("strict", "fast")}
        k2_lse = {mode: time_k2_lse(mode) for mode in ("strict", "fast")}
    for name, tt in list(k3_t.items()) + [(f"K2 {m}", v) for m, v in k2_lse.items()]:
        log(f"[10] per U-Net pass at b{BATCH} ({name}): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in tt.items()))

    rates = {}
    batches = [torch.arange(i * BATCH, (i + 1) * BATCH, device=dev) for i in range(DAYS // BATCH)]
    for name, (state, step, c) in runs.items():
        for i in range(WARMUP_STEPS):
            step(state, hr_all, ds.stats, batches[i % len(batches)], c.seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS):
            m = step(state, hr_all, ds.stats, batches[i % len(batches)], c.seed)
        torch.cuda.synchronize()
        per = (time.perf_counter() - t0) / TRAIN_STEPS
        rates[name] = {"ms_per_step": per * 1e3, "samples_per_s": BATCH / per,
                       "final_loss": m["train_loss"].item()}
        log(f"[10] train {name}: {per * 1e3:.2f} ms per step of {BATCH} samples at {RES}x{RES}:"
            f" {BATCH / per:.2f} samples/s over {TRAIN_STEPS} steps after {WARMUP_STEPS} "
            f"warm-up steps")
        profile(torch, lambda: step(state, hr_all, ds.stats, batches[0], c.seed),
                f"train step {name}", "one step", phase=10, top=16)
    mark(10)
    return {"launches": counts, "k3_err": {"float32": k3_abs["strict"]}, "k3_rel": k3_rel,
            "k3_t": k3_t, "k2_lse": k2_lse, "rates": rates,
            "ds_check": {**ds_seen, "limit": DS_SPLIT_TOL}}


def trainer_phase(torch, dev, card, bare_rates, mark):
    """Phase 11: the trainer end to end (see the module docstring). Returns
    its launch counts (the strict and fast runs) and its report."""
    import numpy as np

    from probunet_torch.config import Config
    from probunet_torch.data.synthetic import generate_climex_like
    from probunet_torch.ops import attention as K2
    from probunet_torch.ops import gn_silu as K1
    from probunet_torch.serve import downscale
    from probunet_torch.train.loop import build_probunet, init_probunet_state, train_probunet
    from probunet_torch.train.state import make_optimizer
    from probunet_torch.train.steps import _pair, make_probunet_train_step
    from probunet_torch.utils.device import full_fp32

    def counters():
        return (K1.gn_silu.launches, K2.fused_attention.launches, K2.attention_bwd.launches,
                K2.kernel_layout.copies)

    def reset_counters():
        K1.gn_silu.launches = K2.fused_attention.launches = K2.attention_bwd.launches = 0
        K2.kernel_layout.copies = 0

    datadir = os.path.join(WORK, "trainer_data")
    generate_climex_like(datadir, years=range(2000, 2005), grid=RES, days_per_year=TRAINER_DAYS)
    base = Config(datadir=datadir, years_train=(2000, 2003), years_val=(2003, 2004),
                  years_test=(2004, 2005), coords=(0, RES, 0, RES), resolution=(RES, RES),
                  standardization="pertimestep", batch_size=BATCH, num_epochs=TRAINER_EPOCHS,
                  eval_crps=True, crps_samples=4, log_every=1, num_samples=2)
    fast = base.replace(compute_dtype="bfloat16", fast_attention=True, opt_state_dtype="bfloat16")
    steps_per_epoch = 3 * TRAINER_DAYS // BATCH
    n_steps = TRAINER_EPOCHS * steps_per_epoch
    n_evals = TRAINER_EPOCHS * 2   # one val batch and one CRPS batch per epoch

    def run(tag, c, **kw):
        c = c.replace(plotdir=os.path.join(WORK, tag, "plots"),
                      checkpoints_dir=os.path.join(WORK, tag, "ckpt"), **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_probunet(c, make_plots=False)   # on the card: its default device
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(c.plotdir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["train_loss"] for r in recs if "train_loss" in r]
        if not losses or not all(math.isfinite(v) for r in recs for v in r.values()):
            raise AssertionError(f"trainer {tag}: non-finite metrics or no step records")
        ckpt = os.path.join(c.checkpoints_dir, "probunet")
        if not os.path.isfile(os.path.join(ckpt, "state", "state.pt")):
            raise AssertionError(f"trainer {tag}: no checkpoint in {ckpt}")
        log(f"[11] trainer {tag}: {res['state'].step} steps in {wall:.2f} s (init, data, eval, "
            f"CRPS and checkpoints included), losses {[round(v, 1) for v in losses]}, peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return res, recs, ckpt

    def epoch_rates(recs):
        """samples/s of each epoch: StepTimer (CUDA-synced) at its last step."""
        steps = [r for r in recs if "train_loss" in r]
        return [steps[i]["samples_per_sec"] for i in range(steps_per_epoch - 1, len(steps),
                                                          steps_per_epoch)]

    report = {"card": card}
    # ---- the trainer, strict and fast, as a user runs it -------------------------
    reset_counters()
    rates, ckpts = {}, {}
    for name, c in (("strict", base), ("fast", fast)):
        res, recs, ckpt = run(name, c)
        kinds = [STEP_KEYS if "train_loss" in r else CRPS_KEYS if "crps_pr" in r else EPOCH_KEYS
                 for r in recs]
        want = ([STEP_KEYS] * steps_per_epoch + [EPOCH_KEYS, CRPS_KEYS]) * TRAINER_EPOCHS
        if [set(r) for r in recs] != want or kinds != want:
            raise AssertionError(f"trainer {name}: metrics records {[sorted(r) for r in recs]}")
        if any(r["crps_batches_evaluated"] != 1 for r in recs if "crps_pr" in r):
            raise AssertionError(f"trainer {name}: CRPS over the wrong number of batches")
        if res["state"].step != n_steps or len(res["val_losses"]) != TRAINER_EPOCHS:
            raise AssertionError(f"trainer {name}: {res['state'].step} steps")
        rates[name] = epoch_rates(recs)
        bare = bare_rates[name]["samples_per_s"]
        log(f"[11] trainer {name}: {rates[name][-1]:.2f} samples/s in epoch {TRAINER_EPOCHS} "
            f"(StepTimer, CUDA-synced, metrics fetched every step; epoch 1 {rates[name][0]:.2f}), "
            f"phase 10's bare step {bare:.2f} samples/s: {rates[name][-1] / bare - 1:+.1%} ({card})")
        ckpts[name] = ckpt
        del res
        torch.cuda.empty_cache()
    n = counters()
    launches = {"gn": n[0], "attn": n[1], "attn_bwd": n[2]}
    per_eval = (K1_PER_BATCH, K2_PER_BATCH, 0)
    want = tuple(2 * (n_steps * k + n_evals * e)
                 for k, e in zip((K1_PER_BATCH, K2_PER_BATCH, K3_PER_STEP), per_eval)) + (0,)
    log(f"[11] trainer launches, strict + fast: K1 {n[0]}, K2 {n[1]}, K3 {n[2]}, q/k/v copies "
        f"{n[3]}; expected {want}: per step {K1_PER_BATCH} K1, {K2_PER_BATCH} K2, "
        f"{K3_PER_STEP} K3 over {n_steps} steps, per eval or CRPS batch {K1_PER_BATCH} K1 and "
        f"{K2_PER_BATCH} K2 over {n_evals}, per run")
    if n != want:
        raise AssertionError("trainer launch counts differ")
    out = downscale(base, ckpts["strict"], os.path.join(WORK, "from_trainer.nc"), years=[2004],
                    num_samples=2)
    from probunet_torch.data.netcdf import NetCDFFile
    with NetCDFFile(out) as f:
        a = f.read_var("pr")
    if a.shape != (TRAINER_DAYS, 2, RES, RES) or not np.isfinite(a).all():
        raise AssertionError(f"downscale from the trainer's checkpoint: {a.shape}")
    log(f"[11] downscale restored the strict trainer's checkpoint (parameters, optimizer "
        f"state and step saved): {a.shape} finite")
    for name in ckpts:
        shutil.rmtree(os.path.join(WORK, name), ignore_errors=True)
    report.update(rates=rates, bare=bare_rates, launches=launches)
    mark(11)

    # ---- exact resume and streaming ingest, deterministic cuDNN --------------------
    torch.backends.cudnn.deterministic = True
    try:
        full, full_recs, _ = run("det_full", base)
        run("det_part", base, max_steps=2)
        resumed, _, _ = run("det_resumed", base,
                            resume=os.path.join(WORK, "det_part", "ckpt", "probunet"))
        diff = max((a - b).abs().max().item() for a, b in zip(
            full["state"].model.state_dict().values(), resumed["state"].model.state_dict().values()))
        log(f"[11] exact resume: 2 steps, checkpoint, resumed to {resumed['state'].step}, against "
            f"{full['state'].step} uninterrupted: parameters max abs diff {diff:.3e} "
            f"(bit-equal required) {'ok' if diff == 0 else 'FAIL'}")
        if diff != 0 or resumed["state"].step != full["state"].step:
            raise AssertionError("the resumed run differs from the uninterrupted one")
        del full, resumed
        stream, stream_recs, _ = run("stream", base, device_resident_data=False)
        del stream

        def losses(recs):   # every step's loss, then every epoch's val loss
            return ([r["train_loss"] for r in recs if "train_loss" in r]
                    + [r["val_loss"] for r in recs if "val_loss" in r])

        s_loss, r_loss = losses(stream_recs), losses(full_recs)
        rel = max(abs(a - b) / abs(b) for a, b in zip(s_loss, r_loss))
        # both rates over epoch 2 (3 steps), after each run's first steps
        s_rate, r_rate = epoch_rates(stream_recs)[1], epoch_rates(full_recs)[1]
        log(f"[11] streaming ingest, {n_steps} steps and {TRAINER_EPOCHS} evals: losses {s_loss} "
            f"against resident {r_loss}, max rel diff {rel:.3e} (tol {STREAM_TOL}) "
            f"{'ok' if rel <= STREAM_TOL else 'FAIL'}")
        log(f"[11] streaming {s_rate:.2f} samples/s against resident {r_rate:.2f} (epoch 2, "
            f"strict, deterministic cuDNN): {s_rate / r_rate - 1:+.1%}; epoch 1 "
            f"{epoch_rates(stream_recs)[0]:.2f} against {epoch_rates(full_recs)[0]:.2f} ({card})")
        if len(s_loss) != len(r_loss) or len(s_loss) != n_steps + TRAINER_EPOCHS \
                or not rel <= STREAM_TOL:
            raise AssertionError("streaming ingest differs from resident ingest")
        report.update(resume_max_abs_diff=diff, stream_loss_rel=rel,
                      stream_samples_per_s=s_rate, resident_samples_per_s=r_rate)
    finally:
        torch.backends.cudnn.deterministic = False
        for tag in ("det_full", "det_part", "det_resumed", "stream"):
            shutil.rmtree(os.path.join(WORK, tag), ignore_errors=True)
        torch.cuda.empty_cache()
    mark(11)

    # ---- remat on a fixed batch, strict and fast -------------------------------------
    from probunet_torch.data.dataset import ClimexDataset

    ds = ClimexDataset(datadir, years=[2000], coords=base.coords,
                       standardization=base.standardization, device=dev)
    idx = torch.arange(BATCH, device=dev)
    eps = torch.randn(BATCH, base.latent_dim, generator=torch.Generator().manual_seed(6)).to(dev)
    want = {False: (K1_PER_BATCH, K2_PER_BATCH, K3_PER_STEP),
            True: (2 * K1_PER_BATCH - 1, 2 * K2_PER_BATCH, K3_PER_STEP)}
    report["remat"] = {}
    for mode, mc in (("strict", base), ("fast", fast)):
        dtype = torch.bfloat16 if mode == "fast" else torch.float32
        seen = {}
        for remat in (False, True):
            c = mc.replace(dropout=0.1, remat=remat)
            tx = make_optimizer(c.lr, c.weight_decay, c.accum, c.optimizer, None,
                                c.opt_state_dtype)
            state = init_probunet_state(c, build_probunet(c, device="meta"), tx, dev)
            fill_weights(torch, state.model, seed=11)   # no zero-init conv hides a block
            step = make_probunet_train_step(state.model, c.lowres_scale, c.standardization,
                                            compute_dtype=dtype)
            torch.backends.cudnn.deterministic = True
            reset_counters()
            m = step(state, ds.hr_device(), ds.stats, idx, c.seed, eps=eps)
            torch.cuda.synchronize()
            torch.backends.cudnn.deterministic = False
            counts = counters()
            grads = {k: p.grad.detach().clone() for k, p in state.model.named_parameters()}
            step(state, ds.hr_device(), ds.stats, idx, c.seed, eps=eps)   # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(REMAT_TIMED_STEPS):
                t0 = time.perf_counter()
                step(state, ds.hr_device(), ds.stats, idx, c.seed, eps=eps)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = float(np.median(times))
            peak = torch.cuda.max_memory_allocated() / 2**30
            # what the forward holds for the backward: allocated bytes at its end
            for p in state.model.parameters():
                p.grad = None
            x, y = _pair(ds.hr_device(), ds.stats, idx, c.lowres_scale, c.standardization, dtype)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            with full_fp32():
                total = state.model.elbo(x, y, 1.0, generator=torch.Generator(dev).manual_seed(0),
                                         eps=eps)[0]
            torch.cuda.synchronize()
            held = (torch.cuda.memory_allocated() - before) / 2**30
            total.backward()
            seen[remat] = {"loss": m["train_loss"].item(), "grads": grads,
                           "launches": counts[:3], "copies": counts[3], "ms_per_step": ms,
                           "step_ms": times, "peak_gib": peak, "forward_holds_gib": held}
            log(f"[11] {mode} {'remat' if remat else 'no remat'} (b{BATCH}, {RES}x{RES}): first "
                f"step launches K1 {counts[0]}, K2 {counts[1]}, K3 {counts[2]}, copies "
                f"{counts[3]}; {ms:.2f} ms per step (median of {[round(t, 1) for t in times]}), "
                f"peak device memory {peak:.2f} GiB; the forward holds {held:.2f} GiB for the "
                f"backward ({card})")
            del state, step, m, grads, total, x, y
            torch.cuda.empty_cache()
        plain, rem = seen[False], seen[True]
        loss_rel = abs(rem["loss"] - plain["loss"]) / abs(plain["loss"])
        grad_rel, worst = 0.0, "none"
        for k, g in plain["grads"].items():
            scale = g.abs().max().item()
            err = (rem["grads"][k] - g).abs().max().item()
            rel = err / scale if scale else err
            if rel > grad_rel:
                grad_rel, worst = rel, k
        ok = (loss_rel <= REMAT_TOL and grad_rel <= REMAT_TOL and rem["copies"] == 0
              and plain["copies"] == 0 and all(seen[r]["launches"] == want[r] for r in seen))
        log(f"[11] {mode}: remat against no remat (dropout 0.1, the same seed, deterministic "
            f"cuDNN): loss rel err {loss_rel:.3e}, worst gradient max|err| / max|g| "
            f"{grad_rel:.3e} ({worst}; tol {REMAT_TOL}); launches {rem['launches']} (expected "
            f"{want[True]}); {rem['ms_per_step'] / plain['ms_per_step'] - 1:+.1%} ms per step, "
            f"peak {plain['peak_gib']:.2f} -> {rem['peak_gib']:.2f} GiB, held by the forward "
            f"{plain['forward_holds_gib']:.2f} -> {rem['forward_holds_gib']:.2f} GiB "
            f"{'ok' if ok else 'FAIL'} ({card})")
        if not ok:
            raise AssertionError(f"{mode}: remat disagrees with the step without it")
        report["remat"][mode] = {"loss_rel": loss_rel, "grad_rel": grad_rel, **{
            name: {k: v for k, v in r.items() if k != "grads"}
            for name, r in (("off", plain), ("on", rem))}}
    mark(11)
    return {"launches": launches, "report": report}


def edm_phase(torch, dev, card, ds, ds_cpu, gen, mark):
    """Phase 12: the EDM diffusion downscaler (see the module docstring).
    Returns its launch counts by path (serve, train, trainer), the worst
    errors of the kernels in its new cases, and its report."""
    import numpy as np

    from probunet_torch.config import Config
    from probunet_torch.data.dataset import ClimexDataset
    from probunet_torch.data.netcdf import NetCDFFile
    from probunet_torch.models.unet import build_unet_plan, gn_silu_sites
    from probunet_torch.ops import attention as K2
    from probunet_torch.ops import gn_silu as K1
    from probunet_torch.ops.norm import num_groups_for
    from probunet_torch.serve import downscale
    from probunet_torch.train.checkpoint import save_checkpoint
    from probunet_torch.train.loop import build_edm_model, init_edm_state, train_edm
    from probunet_torch.train.state import TrainState, create_train_state, make_optimizer
    from probunet_torch.train.steps import make_edm_sample_fn, make_edm_train_step
    from probunet_torch.utils.device import full_fp32

    def counters():
        return (K1.gn_silu.launches, K2.fused_attention.launches, K2.attention_bwd.launches,
                K2.kernel_layout.copies)

    def reset_counters():
        K1.gn_silu.launches = K2.fused_attention.launches = K2.attention_bwd.launches = 0
        K2.kernel_layout.copies = 0

    def as_launches(n):
        return {"gn": n[0], "attn": n[1], "attn_bwd": n[2]}

    cfg = Config(ds_model="edm", coords=(0, RES, 0, RES), resolution=(RES, RES),
                 standardization="pertimestep", batch_size=BATCH, edm_steps=EDM_STEPS)
    modes = {"strict": cfg, "fast": cfg.replace(compute_dtype="bfloat16", fast_attention=True)}
    report = {"card": card}

    # ---- the model, its kernel sites, card against CPU -----------------------------
    c0 = cfg.replace(dropout=0.0)
    card_model = build_edm_model(c0, device="meta").to_empty(device=dev).eval()
    fill_weights(torch, card_model, seed=12)
    cpu_model = build_edm_model(c0, device="meta").to_empty(device="cpu").eval()
    cpu_model.load_state_dict(card_model.state_dict())
    nparams = sum(p.numel() for p in card_model.parameters())
    g = torch.Generator().manual_seed(12)
    x1, cond1 = (torch.randn(1, RES, RES, 3, generator=g) for _ in range(2))
    sig1 = torch.tensor([1.7])
    gn_sites, attn_sites = census(torch, card_model, lambda: card_model(
        x1.to(dev), sig1.to(dev), condition_img=cond1.to(dev)))
    log(f"[12] EDM denoiser: {RES}x{RES}, {nparams:,} parameters; K1 sites per pass "
        f"{len(gn_sites)}, K2 sites {len(attn_sites)}")
    plan_sites = gn_silu_sites(*build_unet_plan((RES, RES), 6, cfg.model_channels,
                                                cfg.channel_mult, cfg.num_blocks,
                                                cfg.attn_resolutions), (RES, RES))
    if nparams != EDM_EXPECTED_PARAMS or sorted(gn_sites) != sorted(plan_sites) \
            or (len(gn_sites), len(attn_sites)) != (K1_PER_BATCH, K2_PER_BATCH):
        raise AssertionError(f"EDM: {nparams:,} parameters (expected {EDM_EXPECTED_PARAMS:,}), "
                             f"or unexpected kernel sites")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    with full_fp32(), torch.inference_mode():
        got = card_model(x1.to(dev), sig1.to(dev), condition_img=cond1.to(dev)).cpu()
        ref = cpu_model(x1, sig1, condition_img=cond1)
    denoiser_rel = rel(got, ref)
    noise = torch.randn(2, RES, RES, 3, generator=g)
    idx = torch.tensor([3])
    t0 = time.perf_counter()
    got = make_edm_sample_fn(card_model, 4, cfg.standardization, 2, EDM_CHAIN_STEPS)(
        ds.hr_device(), ds.stats, idx.to(dev), noise=noise)[0].cpu()
    ref = make_edm_sample_fn(cpu_model, 4, cfg.standardization, 2, EDM_CHAIN_STEPS)(
        ds_cpu.hr_device(), ds_cpu.stats, idx, noise=noise)[0]
    chain_rel = {var: rel(got[..., i], ref[..., i]) for i, var in enumerate(cfg.variables)}
    sigma1, noise1 = torch.tensor([0.9]), torch.randn(1, RES, RES, 3, generator=g)
    res = {}
    for where, m, d in (("card", card_model, ds), ("cpu", cpu_model, ds_cpu)):
        state = create_train_state(m, make_optimizer(c0.lr, c0.weight_decay))
        metrics = make_edm_train_step(m, 4, cfg.standardization)(
            state, d.hr_device(), d.stats, idx.to(d.device), 0, sigma=sigma1, noise=noise1)
        res[where] = (metrics["train_loss"].item(), metrics["grad_norm"].item(),
                      {k: p.grad.detach().cpu() for k, p in m.named_parameters()})
    (l_c, n_c, g_c), (l_r, n_r, g_r) = res["card"], res["cpu"]
    loss_rel, norm_rel = abs(l_c - l_r) / abs(l_r), abs(n_c - n_r) / n_r
    grad_rel, worst = 0.0, ""
    for k, ref_g in g_r.items():
        scale = ref_g.abs().max().item()
        err = (g_c[k] - ref_g).abs().max().item()
        r = err / scale if scale else err
        if r > grad_rel:
            grad_rel, worst = r, k
    ok = (denoiser_rel <= PATH_TOL and max(chain_rel.values()) <= PATH_TOL
          and loss_rel <= STEP_LOSS_TOL and norm_rel <= STEP_LOSS_TOL
          and grad_rel <= STEP_GRAD_TOL)
    log(f"[12] card vs CPU, strict fp32 ({time.perf_counter() - t0:.1f} s): denoiser (b=1) max "
        f"abs err / max |ref| {denoiser_rel:.3e}; {EDM_CHAIN_STEPS}-step Heun chain (b=1, K=2, "
        f"the same noise) per variable {', '.join(f'{v} {e:.3e}' for v, e in chain_rel.items())}"
        f" (tol {PATH_TOL}); one DSM step (b=1, dropout 0, the same sigma and noise): loss "
        f"{l_c:.6g} vs {l_r:.6g}, rel err {loss_rel:.3e}, grad norm rel err {norm_rel:.3e} (tol "
        f"{STEP_LOSS_TOL}), worst gradient max|err| / max|g| {grad_rel:.3e} ({worst}; tol "
        f"{STEP_GRAD_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the EDM path on the card disagrees with the plain path")
    report["card_vs_cpu"] = {"denoiser_rel": denoiser_rel, "chain_rel": chain_rel,
                             "step_loss_rel": loss_rel, "step_grad_norm_rel": norm_rel,
                             "step_grad_rel": grad_rel}
    ckpt = os.path.join(WORK, "edm_ckpt")
    save_checkpoint(ckpt, TrainState(card_model, None))
    del cpu_model, res, g_c, g_r
    mark(12)

    # ---- the kernels in the EDM path's new cases ---------------------------------
    # K2/K3 on fp32 operands with fast=True (the U-Net stays fp32 in fast
    # mode): the strict math, so the strict limits, and bit-equal to fast=False
    k2_err = k3_rel = 0.0
    for L, nh in sorted(set(attn_sites), reverse=True):
        q, k, v = qkv_views(torch, "block", BATCH, L, nh, torch.float32, dev, gen)
        do = torch.randn(BATCH, L, nh, 64, device=dev, generator=gen)
        with torch.no_grad(), full_fp32():
            out = K2.fused_attention(q, k, v, True)
            ref = K2._plain_attention(q, k, v, True)
            o, lse = K2._launch(q, k, v, with_lse=True)
            got = K2.attention_bwd(q, k, v, o, lse, do, True)
            strict = K2.attention_bwd(q, k, v, o, lse, do, False)
            refb = K2._plain_attention_bwd(q, k, v, do, True)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rels = [(a - r).abs().max().item() / max(1e-3, r.abs().max().item())
                for a, r in zip(got, refb)]
        same = torch.equal(out, o) and all(torch.equal(a, b) for a, b in zip(got, strict))
        ok = (torch.allclose(out, ref, atol=ATTN_TOL["strict"], rtol=ATTN_TOL["strict"])
              and max(rels) <= ATTN_BWD_TOL["float32"] and same)
        k2_err, k3_rel = max(k2_err, err), max(k3_rel, max(rels))
        log(f"[12] K2/K3 fp32 with fast=True, B={BATCH} L={L} heads={nh}: K2 max abs err {err:.3e}"
            f" (tol {ATTN_TOL['strict']}), K3 max|err| / max|ref| {max(rels):.3e} (tol "
            f"{ATTN_BWD_TOL['float32']}); bit-equal to fast=False {same} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K2/K3 on fp32 operands with fast=True disagree")
    # K1 at every site and K2 at the 128 rows of a b8, K=16 chain's pass
    rows = BATCH * MEMBERS
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    atol, rtol = GN_TOL["float32"]
    k1_err = 0.0
    for h, w, c in sorted(set(gn_sites)):
        gr = num_groups_for(c)
        p = K1.plan(rows, h, w, c, gr, 4, num_sms)
        x = torch.randn(rows, h, w, c, device=dev, generator=gen) + 0.5
        gamma = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
        beta = 0.1 * torch.randn(c, device=dev, generator=gen)
        with torch.inference_mode():
            out = K1.gn_silu(x, gamma, beta, gr)
            ref = K1._plain_gn_silu(x, gamma, beta, gr)[0]
        torch.cuda.synchronize()
        d = (out - ref).abs()
        ok = bool((d <= atol + rtol * ref.abs()).all())
        k1_err = max(k1_err, d.max().item())
        log(f"[12] K1 fp32 {rows}x{h}x{w}x{c} (cb {p.cb}, cluster {p.n}, {p.rows} rows/block, "
            f"{'on chip' if p.on_chip else 'streamed'}): max abs err {d.max().item():.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K1 disagrees with its plain version at 128 rows")
        del x, out, ref, d
    for L, nh in sorted(set(attn_sites), reverse=True):
        q, k, v = qkv_views(torch, "block", rows, L, nh, torch.float32, dev, gen)
        with torch.inference_mode(), full_fp32():
            out = K2.fused_attention(q, k, v, True)
            ref = K2._plain_attention(q, k, v, True)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ok = torch.allclose(out, ref, atol=ATTN_TOL["strict"], rtol=ATTN_TOL["strict"])
        k2_err = max(k2_err, err)
        log(f"[12] K2 fp32, fast=True, B={rows} L={L} heads={nh}: max abs err {err:.3e} (tol "
            f"{ATTN_TOL['strict']}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K2 disagrees with its plain version at 128 rows")
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    mark(12)

    # ---- serving: downscale from the checkpoint, b2, K=4, 18 steps ---------------------
    sb, sk = EDM_SERVE_BATCH, EDM_SERVE_MEMBERS
    sds = ClimexDataset(hr=ds.hr_np[:sb], timestamps=ds.timestamps_np[:sb],
                        standardization=cfg.standardization, device=dev)
    passes = 2 * EDM_STEPS - 1
    serve_n = np.zeros(3, np.int64)
    report["serve"] = {}
    for name, c in modes.items():
        reset_counters()
        t0 = time.perf_counter()
        path = downscale(c, ckpt, os.path.join(WORK, f"edm_{name}.nc"), dataset=sds,
                         num_samples=sk, batch_size=sb, device=dev)
        wall = time.perf_counter() - t0
        n = counters()
        want = (passes * K1_PER_BATCH, passes * K2_PER_BATCH, 0, 0)
        serve_n += n[:3]
        with NetCDFFile(path) as f:
            fields = {var: f.read_var(var) for var in cfg.variables}
        spread = {var: float(a.std(axis=1).mean()) for var, a in fields.items()}
        ok = n == want and all(a.shape == (sb, sk, RES, RES) and np.isfinite(a).all()
                               for a in fields.values()) and min(spread.values()) > 0
        # the sampler alone on one batch, data on the card, no file I/O
        dtype = torch.bfloat16 if c.compute_dtype == "bfloat16" else torch.float32
        m = build_edm_model(c, device="meta").to_empty(device=dev).eval()
        m.load_state_dict(card_model.state_dict())
        fn = make_edm_sample_fn(m, 4, c.standardization, sk, EDM_STEPS, compute_dtype=dtype)
        e = torch.randn(sk * sb, RES, RES, 3, device=dev, generator=gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn(sds.hr_device(), sds.stats, torch.arange(sb, device=dev), noise=e)
        torch.cuda.synchronize()
        per = time.perf_counter() - t1
        report["serve"][name] = {"downscale_wall_s": wall, "ms_per_batch": per * 1e3,
                                 "inputs_per_s": sb / per, "members_per_s": sb * sk / per,
                                 "launches": n[:3], "copies": n[3]}
        log(f"[12] EDM downscale {name} (b{sb}, K={sk}, {EDM_STEPS} steps): {wall:.2f} s for one "
            f"batch (restore and netCDF output included); launches K1 {n[0]}, K2 {n[1]}, K3 "
            f"{n[2]}, q/k/v copies {n[3]} (expected {want}); members finite, spread "
            f"{', '.join(f'{v} {s:.4g}' for v, s in spread.items())}; the sampler alone "
            f"{per * 1e3:.1f} ms per batch: {sb / per:.3f} inputs/s, {sb * sk / per:.3f} "
            f"members/s ({card}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"EDM serving {name}: launches {n}, expected {want}, or bad "
                                 f"output")
        modes[name] = (c, m, dtype)
    mark(12)

    # ---- one denoiser pass at 8 and 128 rows -------------------------------------------
    report["pass_ms"] = {}
    for r in (sb * sk, rows):
        x = torch.randn(r, RES, RES, 3, device=dev, generator=gen)
        cond = torch.randn(r, RES, RES, 3, device=dev, generator=gen)
        sig = torch.full((r,), 2.5, device=dev)
        for name, (c, m, dtype) in modes.items():
            cd = cond.to(dtype)

            def run():
                return m(x, sig, condition_img=cd)

            with torch.inference_mode(), full_fp32():
                ev = cuda_ms(torch, run, reps=1 if r == rows else 5, warmup=1)
                dv = device_ms(torch, run, reps=1, warm=False)
            t = {"ms": ev, "device_ms": dv}
            if r == rows:
                t.update(heun_batch_computed_ms=passes * ev,
                         heun_batch_computed_device_ms=passes * dv)
            report["pass_ms"][f"{name}_{r}_rows"] = t
            log(f"[12] one denoiser pass, {name}, {r} rows: {ev:.2f} ms by events, {dv:.2f} ms of "
                f"device time ({card})" + (
                    f"; computed, not run: {passes} passes = one b{BATCH} K={MEMBERS} Heun batch "
                    f"of {EDM_STEPS} steps, {passes * ev / 1e3:.2f} s ({passes * dv / 1e3:.2f} s "
                    f"of device time)" if r == rows else ""))
        del x, cond, cd
    for name in modes:
        modes[name] = modes[name][0]
    del m, fn
    torch.cuda.empty_cache()
    mark(12)

    # ---- training: DSM steps at b8, dropout 0.1, fixed sigma and noise ---------------
    g = torch.Generator().manual_seed(13)
    sigma = torch.exp(-1.2 + 1.2 * torch.randn(BATCH, generator=g)).to(dev)
    noise = torch.randn(BATCH, RES, RES, 3, generator=g).to(dev)
    fixed_idx = torch.arange(BATCH, device=dev)
    train_n = np.zeros(3, np.int64)
    report["train"] = {}
    for name, mc in modes.items():
        c = mc.replace(dropout=0.1, opt_state_dtype="bfloat16" if name == "fast" else "float32")
        dtype = torch.bfloat16 if c.compute_dtype == "bfloat16" else torch.float32
        tx = make_optimizer(c.lr, c.weight_decay, c.accum, c.optimizer, None, c.opt_state_dtype)
        state = init_edm_state(c, build_edm_model(c, device="meta"), tx, device=dev)
        step = make_edm_train_step(state.model, c.lowres_scale, c.standardization,
                                   compute_dtype=dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = [step(state, ds.hr_device(), ds.stats, fixed_idx, c.seed, sigma=sigma, noise=noise)
              for _ in range(WARMUP_STEPS)]
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        ms += [step(state, ds.hr_device(), ds.stats, fixed_idx, c.seed, sigma=sigma, noise=noise)
               for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        per = (time.perf_counter() - t0) / TRAIN_STEPS
        n = counters()
        train_n += n[:3]
        want = (TRAIN_STEPS * K1_PER_BATCH, TRAIN_STEPS * K2_PER_BATCH,
                TRAIN_STEPS * K3_PER_STEP, 0)
        losses = [m_["train_loss"].item() for m_ in ms]
        norms = [m_["grad_norm"].item() for m_ in ms]
        peak = torch.cuda.max_memory_allocated() / 2**30
        ok = (n == want and all(math.isfinite(v) for v in losses + norms)
              and losses[-1] < losses[0])
        report["train"][name] = {"ms_per_step": per * 1e3, "samples_per_s": BATCH / per,
                                 "peak_gib": peak, "losses": losses}
        log(f"[12] EDM train {name}: {WARMUP_STEPS} warm-up + {TRAIN_STEPS} DSM steps at b{BATCH},"
            f" {RES}x{RES}, dropout 0.1, fixed sigma and noise: {per * 1e3:.2f} ms per step, "
            f"{BATCH / per:.2f} samples/s over the {TRAIN_STEPS}; launches K1 {n[0]}, K2 {n[1]}, "
            f"K3 {n[2]}, copies {n[3]} (expected {want}); peak device memory {peak:.2f} GiB; "
            f"loss {[round(v, 3) for v in losses]} ({card}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"EDM training {name}: launches {n}, expected {want}, or the "
                                 f"loss did not fall")
        profile(torch, lambda: step(state, ds.hr_device(), ds.stats, fixed_idx, c.seed,
                                    sigma=sigma, noise=noise),
                f"EDM train step {name}", "one step", phase=12, top=12)
        del state, step, ms
        torch.cuda.empty_cache()
    mark(12)

    # ---- the trainer, then serving from its checkpoint ---------------------------------
    base = Config(ds_model="edm", datadir=os.path.join(WORK, "trainer_data"),
                  years_train=(2000, 2003), years_val=(2003, 2004), years_test=(2004, 2005),
                  coords=(0, RES, 0, RES), resolution=(RES, RES), standardization="pertimestep",
                  batch_size=BATCH, num_epochs=TRAINER_EPOCHS, eval_crps=True, crps_samples=2,
                  edm_steps=EDM_CHAIN_STEPS, log_every=1, num_samples=2,
                  plotdir=os.path.join(WORK, "edm_trainer", "plots"),
                  checkpoints_dir=os.path.join(WORK, "edm_trainer", "ckpt"))
    reset_counters()
    t0 = time.perf_counter()
    res = train_edm(base, make_plots=False)   # on the card: its default device
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = counters()
    with open(os.path.join(base.plotdir, "metrics_edm.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps_per_epoch = 3 * TRAINER_DAYS // BATCH
    n_steps = TRAINER_EPOCHS * steps_per_epoch
    crps_passes = 2 * EDM_CHAIN_STEPS - 1
    # per epoch: one eval batch (one pass), one CRPS batch (a chain)
    evals = TRAINER_EPOCHS * (1 + crps_passes)
    want = (n_steps * K1_PER_BATCH + evals * K1_PER_BATCH,
            n_steps * K2_PER_BATCH + evals * K2_PER_BATCH, n_steps * K3_PER_STEP, 0)
    kinds = [set(r) for r in recs]
    want_kinds = (([EDM_STEP_KEYS] * steps_per_epoch + [EDM_EPOCH_KEYS, CRPS_KEYS])
                  * TRAINER_EPOCHS)
    finite = all(math.isfinite(v) for r in recs for v in r.values())
    ckpt = os.path.join(base.checkpoints_dir, "edm")
    ok = (n == want and kinds == want_kinds and finite and res["state"].step == n_steps
          and os.path.isfile(os.path.join(ckpt, "state", "state.pt")))
    seen = "the JAX loop's keys" if kinds == want_kinds else [sorted(k) for k in kinds]
    log(f"[12] train_edm: {res['state'].step} steps, eval and CRPS ({base.crps_samples} members,"
        f" {EDM_CHAIN_STEPS} steps) in {wall:.2f} s; losses "
        f"{[round(r['train_loss'], 3) for r in recs if 'train_loss' in r]}, val "
        f"{[round(v, 4) for v in res['val_losses']]}; launches K1 {n[0]}, K2 {n[1]}, K3 {n[2]}, "
        f"copies {n[3]} (expected {want}); records: {seen} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("train_edm: launches, records or checkpoint differ")
    trainer_n = np.array(n[:3])
    del res
    out = downscale(base, ckpt, os.path.join(WORK, "edm_from_trainer.nc"), years=[2004],
                    num_samples=2)
    with NetCDFFile(out) as f:
        a = f.read_var("pr")
    if a.shape != (TRAINER_DAYS, 2, RES, RES) or not np.isfinite(a).all() \
            or not a.std(axis=1).mean() > 0:
        raise AssertionError(f"EDM downscale from the trainer's checkpoint: {a.shape}")
    log(f"[12] downscale (ds_model edm) restored the trainer's checkpoint: {a.shape} finite, "
        f"members differ")
    report["trainer_s"] = wall
    shutil.rmtree(os.path.join(WORK, "edm_trainer"), ignore_errors=True)
    torch.cuda.empty_cache()
    mark(12)
    return {"launches": {"serve": as_launches(serve_n.tolist()),
                         "train": as_launches(train_n.tolist()),
                         "trainer": as_launches(trainer_n.tolist())},
            "k1_err": k1_err, "k2_err": k2_err, "k3_rel": k3_rel, "report": report}


def rms_rel(got, ref):
    """||got - ref||_2 / ||ref||_2 in fp32."""
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def plain_dq_dk(torch, q, k, v, out, do, fast):
    """dq, dk of the plain backward on bf16 q/k/v/dO with fp32 dS (rounded
    to bf16 when ``fast``), and with D = rowsum(dO o O) taken from K2's
    output ``out`` as K3 takes it: the plain version's D, rowsum(dP o P) in
    fp32, parts from it by ~1e-3 in these legs, as much as rounding dS."""
    qf, kf, vf, dof = (a.float() for a in (q, k, v, do))
    p = torch.softmax(torch.einsum("bqhc,bkhc->bhqk", qf, kf / 8), dim=-1)
    dp = torch.einsum("bqhc,bkhc->bhqk", dof, vf)
    ds = p * (dp - (dof * out.float()).sum(-1).transpose(1, 2)[..., None])
    if fast:
        ds = ds.to(q.dtype).float()
    return (torch.einsum("bhqk,bkhc->bqhc", ds, kf).div(8).to(q.dtype),
            torch.einsum("bhqk,bqhc->bkhc", ds, qf).div(8).to(q.dtype))


def split_ds_check(torch, K2, q, k, v, out, lse, do, got, ref, seen, case):
    """K3 strict with bf16 activations (``got``) keeps dS in fp32: its dq
    and dk lie within DS_SPLIT_TOL of the plain strict backward with K3's D
    (:func:`plain_dq_dk`), and rounding dS to bf16 (the kernel in fast mode,
    the same plain backward with dS rounded, on the same inputs) lands
    beyond it. Also logs the reading against the plain version (``ref``).
    Records the readings in ``seen``; raises if the limit does not tell the
    two apart."""
    with torch.no_grad():
        rounded = K2.attention_bwd(q, k, v, out, lse, do, True)
        exact = plain_dq_dk(torch, q, k, v, out, do, False)
        plain_rounded = plain_dq_dk(torch, q, k, v, out, do, True)
    err = max(rms_rel(g, r) for g, r in zip(got, exact))
    err_rounded = min(rms_rel(g, r) for g, r in zip(rounded, exact))
    gap = min(rms_rel(g, r) for g, r in zip(plain_rounded, exact))
    err_plain = max(rms_rel(g, r) for g, r in zip(got[:2], ref[:2]))
    seen["kernel"] = max(seen["kernel"], err)
    seen["kernel_rounded"] = min(seen["kernel_rounded"], err_rounded)
    seen["plain_rounded"] = min(seen["plain_rounded"], gap)
    seen["kernel_vs_plain_version"] = max(seen["kernel_vs_plain_version"], err_plain)
    ok = err <= DS_SPLIT_TOL < min(err_rounded, gap)
    log(f"[7] K3 strict_bf16 {case}: dq/dk ||err|| / ||ref|| against the plain strict "
        f"backward with K3's D {err:.3e} (limit {DS_SPLIT_TOL}); with dS rounded to bf16 "
        f"{err_rounded:.3e} (kernel, fast mode), {gap:.3e} (plain); the kernel against "
        f"_plain_attention_bwd {err_plain:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the dS check does not separate strict_bf16 from rounded dS")


def _counts(sites):
    out = {}
    for s in sites:
        out[s] = out.get(s, 0) + 1
    return out


def profile(torch, fn, name, what, phase=6, top=12):
    """Device time of one call of ``fn`` by kernel name (torch.profiler).
    User-annotated ranges (an optimizer's step) span kernels and gaps on
    the device timeline; they are left out of the kernel sum."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    total = sum(getattr(e, "self_device_time_total", 0) for e in events)
    if not total:
        log(f"[{phase}] profile {name}: the profiler saw no device time")
        return
    log(f"[{phase}] profile {name}: device time {total / 1e3:.2f} ms in {what}; top kernels:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"      {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
