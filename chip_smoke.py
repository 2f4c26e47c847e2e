#!/usr/bin/env python3
"""Quickest proof that the PyTorch port starts on an NVIDIA GPU.

    python3 chip_smoke.py          # one CUDA card, no arguments

Builds the port's hand-written kernels from ``probunet_torch/csrc`` and
drives the serving path (``probunet_torch.serve.downscale``) and the
training step (``probunet_torch.train.steps.make_probunet_train_step``) at
the full width of the 128x128 Probabilistic U-Net (103,541,083 parameters,
seeded random weights), in strict fp32 and in fast bf16 mode, then the
trainer, then the EDM diffusion downscaler (100,349,315 parameters) served,
stepped and trained, then the baselines (the deterministic U-Net,
22,792,579 parameters, LinearCNN, BCSD and the conv-VAE) trained and the
conv-VAE served, then the prob-U-Net trained, served and BCSD run over
several processes (two ranks sharing the card, one NCCL rank), then with
the tile's height sharded over the ranks (``--parallel_mode spatial`` and
``2d``), then the prob-U-Net at ``--model_channels 96``, whose attention
heads of 72 run the bf16 kernels' exact-width kD = 80 instantiation (the
fp32 kernels' kD = 128), then the convolutions in 3xTF32 against IEEE
fp32, then CorrDiff's denoiser at 448x448 (``ds_model=corrdiff``, two
DDPM++ U-Nets of 79,985,411 parameters), whose one 256-wide head runs the
fp32 kernel's kD = 256 build. It checks every kernel against its plain
version, the launch counts, the kernels' resources, and the paths against
the CPU, and times the kernels alone and the paths no cell of the
benchmark runs; the rates of the calls the cells run (BENCHMARK.json,
``perfbench/``) are the benchmark's. Phases:

  1. card and build: nvidia-smi name and power limit; nvcc for sm_90a with
     ptxas registers, shared memory and spills; ``cuobjdump -sass`` of the
     library: the tensor-core and TMA instructions of every attention
     kernel, HGMMA (wgmma) and UTMALDG (TMA loads) in each kernel that does
     products, fp32 (3xTF32) and bf16, and HMMA (mma.sync) in none, or it
     fails; K1's plan at the path's largest site, its threads, shared
     memory, registers, spills and cluster residency
     (cudaOccupancyMaxActiveClusters), registers, spills and residency
     also of the instantiations with the embedding's terms (``K1.MODS``); the bf16 attention kernels of the
     plan at each attention site, at the exact widths kD = 80 and 96
     (EXACT_SITES: every block shape built there), the row pass with each,
     and the fp32 kernels of ``fp32_plan`` at kD = 64 and 128, their
     threads, shared memory (held against the plan's), registers and
     spills (none allowed); the fp32 forward at kD = 256 in phase 18;
  2. K1 GroupNorm+SiLU against its plain version, output and (B, G) mean
     and rstd, at every (H, W, C) of the path at batch 8 and at edge shapes
     (C = 6 without vectors, H*W = 1, B = 1, a view off a 16-byte boundary,
     one shape streamed through shared memory), fp32 and bf16; two calls
     bit-equal; every site of the path planned on chip; then at the same
     shapes (the unaligned view apart) with the residual block's terms in
     the launch, (scale, shift) and shift_in, each (B, C) and (1, C),
     against the plain version, bit-equal reruns, each launch counted by
     modulation;
  3. K2 attention against its plain version at the path's (B, L, heads)
     and at L = 100, 1, 65, 2048 and 4096, strict, fast and strict with
     bf16 activations, on the U-Net block's views (read in place), on
     stride-3 views (copied first) and on contiguous tensors; a second call
     bit-equal to the first;
  4. the main path: a checkpoint, then ``downscale`` of synthetic 128x128
     days with 16 members in both modes; files read back and checked;
     the launch counter (``ops/_build.py::launches``) must show 57 K1 (29
     unmodulated, 28 with the blocks' (scale, shift)) and 11 K2 launches
     per batch, and ``kernel_layout`` no copy of q/k/v;
  5. the path against the plain path: one input, two members, the same
     weights and eps, on the card and on the CPU;
  6. timings with CUDA events and by device time (torch.profiler): each
     kernel (K1 per site with its share of the bound; at the blocks' norm1
     sites K1 with per-sample (scale, shift) beside the unmodulated K1 and
     the plain chain it replaces, by device time; K2 on the block's own
     views, so no q/k/v copy; the wrapper's layout step on those views and
     the copy it makes of stride-3 views, timed), its plain version, one
     PyTorch call computing the same function (a yardstick the port never
     calls), the bound (strict attention: the smaller of the fp32 CUDA-core
     and the 3xTF32 tensor-core bound; the peaks of perfbench/peaks.json);
     the strict sampler's rate and a profile of one of its batches;
  7. K3 attention backward against its plain version, and K2's row
     log-sum-exp against logsumexp, in the cases of phase 3, a second K3
     call bit-equal to the first; strict mode with bf16 activations also
     against rounded dS (DS_SPLIT_TOL);
  8. the training path: the model with its own init, 10 AdamW steps at b8
     in each mode on a fixed batch and eps with dropout 0.1; launch
     counters must show 57 K1, 11 K2 and 11 K3 launches per step and no
     copy before them, and in fast mode (bf16 AdamW state) one fused
     AdamW launch per step and no foreach update (neither in strict); loss
     and gradient norm finite, the loss falling; peak device memory;
  9. one training step on the card against the plain step on the CPU: b=1,
     dropout 0, the same filled weights and eps; loss, gradient norm, every
     gradient and the parameters after the AdamW step;
 10. timings: K3 per U-Net backward on the block's views (kernel, its
     device time split by kernel: row pass, dK/dV, dQ; plain, bound, the
     backward of scaled_dot_product_attention as yardstick, by events and
     by device time), K2 with its lse;
 11. the trainer (``probunet_torch.train.loop.train_probunet``, the model
     with its own init) on synthetic netCDF (3 train years of 8 days, one
     val and one test year): 2 epochs of 3 steps with eval, CRPS (4
     members) and a metrics record per step, strict and fast; the records'
     keys; launch counters: 57 K1, 11 K2 and 11 K3 per step (plus 57 K1
     and 11 K2 per eval and CRPS batch); ``downscale`` from the trainer's
     checkpoint; exact resume (deterministic cuDNN: 2 steps, then resumed
     to 6, against 6 uninterrupted, parameters bit-equal); streaming
     ingest against resident (2 epochs, the same train and val losses);
     remat on a fixed batch, strict and fast (loss and every gradient
     against the step without it, 113 K1, 22 K2 and 11 K3 launches); the
     trainer's samples/s beside the bare step's (the step without remat),
     streaming samples/s, peak memory, memory held by the forward and ms
     per step with and without remat;
 12. the EDM diffusion downscaler at full width (``ds_model="edm"``; its
     U-Net runs fp32 in both modes, fast mode only sets fast attention):
     card against CPU (the denoiser at b=1, a 4-step Heun chain at b=1, K=2
     from given noise, one DSM step at b=1 with dropout 0 and given sigma
     and noise: loss, gradient norm, every gradient); K2 and K3 on fp32
     operands with fast=True at the path's sites at b8 (the strict limits,
     and bit-equal to fast=False), K1 at every site and K2 at the 128 rows
     of a b8, K=16 pass; ``downscale(ds_model="edm")`` from a checkpoint at
     b2, K=4, 18 steps, strict and fast: 35 x 57 = 1995 K1 (35 x 28
     ``scale_shift``) and 35 x 11 = 385
     K2 launches per batch, no q/k/v copy, files finite with members that
     differ, in fast mode ms per batch of the sampler alone, inputs/s and
     members/s (strict is the cell ``edm_mc128.serve_b2_k4``); one
     denoiser pass at 8 and at 128 rows, both modes, by CUDA events and
     device time, and 35 times the 128-row pass printed as the computed
     (not run) cost of one b8 K=16 Heun batch; 3 + 10 DSM steps at b8,
     dropout 0.1, sigma and noise fixed, strict and fast: 57 K1, 11 K2 and
     11 K3 launches per step, the loss falling, ms per step, samples/s, peak
     memory and a profile; ``train_edm`` on phase 11's data, 2 epochs of 3
     steps with eval and CRPS (depth cuts: ``crps_samples`` 2 and
     ``edm_steps`` 4), its records' keys and launch counts, then
     ``downscale`` from its checkpoint.
 13. the baselines (``ds_model`` deterministic_unet, linearcnn, bcsd,
     vae): card against CPU, strict fp32 (the deterministic U-Net forward at
     full width, b=1, id and cyclic labels, within 1e-3 of the largest
     value; one deterministic step at b=1, dropout 0, cyclic: loss and
     gradient norm 1e-4 relative, each gradient 1e-3 of its tensor's
     largest entry; LinearCNN's forward; the conv-VAE's ELBO with a given z;
     ``bcsd`` and ``run_bcsd`` with chunk 7 on overlapping days, and two
     card runs of ``run_bcsd`` bit-equal); K1 against its plain version at
     every (H, W, C, G) site of the deterministic U-Net at b8 (C from 64 to
     512, 4 to 16 channels per group), fp32 and bf16, each site's plan
     printed and required on chip, and K1's times there; 3 + 10
     deterministic steps at b8, cyclic labels (``map_label`` live), dropout
     0.1, a fixed batch, strict and fast: exactly 57 K1, 0 K2 and 0 K3
     launches per step and 57 K1 per eval batch, the loss falling, ms per
     step, samples/s, peak memory and a profile; ``train_baseline`` on
     phase 11's data for each ``ds_model``, 2 epochs of 3 steps: the JAX
     loop's record keys, finite MAE, the launch counts (513 K1 for the
     U-Net: 6 steps, 2 eval batches, 1 MAE batch); ``downscale(ds_model=
     "vae")`` from its checkpoint at b8, K=16: finite members that differ,
     the sampler's inputs/s and members/s.
 14. several processes (``probunet_torch.parallel``): K1's plan at every
     site at a rank's 4 rows (printed, on chip required); one rank over
     NCCL in this process: float64 ``allreduce_sum`` exact where float32
     is not, ``allgather_counts`` exact above 2**24,
     ``global_perpixel_stats`` on the card against the CPU's, the cost of
     drawing the dropout masks of the global batch, and 3 training steps
     at b8 (dropout 0.1, deterministic cuDNN) through the flat gradient
     all-reduce bit-equal to the same steps with no process group; then
     two ranks on the card over gloo, child processes of this script
     (``--mp-rank``), each running ``train_probunet`` at full width on its
     shard of 2 train years of phase 11's data (b8 global, 4 rows a rank,
     2 epochs of 2 steps, eval and CRPS), against
     this process's run with ``data_shards=2``: the step-1 loss within
     1e-5, every loss, gradient norm and the val loss within 5e-3, the
     final parameters' update within MP_PARAM_TOL, 57 K1, 11 K2 and 11 K3
     launches per step on each rank (plus 57 K1 and 11 K2 per eval and
     CRPS batch), one checkpoint; the elements whose updates parted by
     more than lr, with each side's gradients of them at steps 1-3
     (AdamW's first moments in runs stopped after each step); a negative
     control, the ranks drawing local-shape dropout (planted in the
     children only), which must exceed MP_PARAM_TOL; a two-rank resume
     chain (stopped after steps 1, 2 and 3, then resumed to the end),
     bit-equal to the uninterrupted run; ``downscale`` of 24 of
     phase 4's days at b8, K=16 (3 batches: ranks own 2 and 1) merged
     from the part files, fast mode array-equal to this process's file,
     strict within MP_STRICT_SERVE_TOL, the parts gone; ``run_bcsd``
     within BCSD_TOL of one process. Each rank's peak memory and ms per
     step beside this process's (the ranks share the card: not a scaling
     figure).
 15. spatial (H-axis) model parallelism (``probunet_torch.parallel.spatial*``;
     K1 does not run there, K2 and K3 run strict on the gathered coarse
     maps): (a) one rank over NCCL in this process,
     ``make_spatial_probunet_train_step`` at full width, 128x128, b8,
     strict, dropout 0, a given z, against the unsharded ``elbo_with_z``
     and its backward on the same weights and batch (loss, gradient norm,
     every gradient, phase 9's limits); exactly 0 K1, 11 K2 and 11 K3
     launches per step and no q/k/v copy; (b) two gloo ranks sharing the
     card (``--sp-rank`` children): ``train_probunet(parallel_mode=
     "spatial")`` at full width, b8, 2 epochs of 2 steps with eval and CRPS,
     against this process's unsharded run (step-1 loss within 1e-5, the run
     within 5e-3), 0 / 11 / 11 launches per step on each rank (0 / 11 / 0
     per eval and CRPS batch), one checkpoint; (c) a 256x256 tile of
     BASELINE's multi-variable configuration (beta annealed) on the two
     ranks with remat, the largest batch among 4 and 2 whose unsharded step
     fits: 3 steps strict and fast, finite and falling losses, the K2 and
     K3 launches per step counted from ``build_unet_plan``, ms per step and
     peak memory per rank beside one unsharded process at the same size;
     (d) four gloo ranks, ``--parallel_mode 2d --mesh_shape 2,-1``, b4
     global, 2 steps against one process with ``data_shards=2``. Ranks
     sharing one card give no scaling figure.
 16. the prob-U-Net at ``model_channels=96`` (59,645,627 parameters, full
     depth, phase 4's data): its 32x32 level is 288 wide, 4 heads of 72,
     which run the bf16 kernels' exact-width kD = 80 instantiation and the
     fp32 kernels' kD = 128 (5 of the 11 attention sites; the 16x16
     level's 6 run 6 heads of 64). The kD = 80 and kD = 128 kernels'
     threads, shared memory, registers and spills (none allowed);
     (a) the sampler and one strict training step card against CPU, phase
     5's and phase 9's limits; (b) the sampler at b8, K=16 and 5 training
     steps at b8, dropout 0.1, in strict and fast mode, with counts set to
     0 before each and exactly 57 K1 + 11 K2 per pass, 57 / 11 / 11 per
     step, by head width 5 at kD = 80 (fast) or 128 (strict) and 6 at 64,
     no copy, finite output; ms per batch and step, device time, peak
     memory; (c) K2 and K3 (and K2's lse) against their plain versions at
     head dims 65, 72, 80, 88, 96 (kD = 80 / 96 in bf16), 100, 120 and 127
     (kD = 128; 65, 100 and 127 copied zero-padded), L = 64, 256, 1024 and
     100, every layout and mode (phase 3's and 7's limits, two calls
     bit-equal, the copies counted, the strict_bf16 dS check), and at the
     path's own site; in bf16 at 65-96 also against the kD = 128 kernels
     on the same inputs (K3, and K2 at kD = 128's block shape: bit-equal;
     K2 at its own plan: within the fast limit); (d) K2 and K3 per U-Net
     pass over the path's sites, strict and fast (K3 split by kernel),
     beside SDPA and its backward on the same tensors, the kD = 128
     kernels on the same inputs, and the bound at the real head dim; the
     exact-width sites apart. The kernels line gets an entry for each of
     K2 and K3 at the exact widths.
 17. the convolutions (``ops/conv.py``: an fp32 sampler's forward in
     3xTF32, an fp32 training step's forward and weight gradient in IEEE
     fp32, its input gradient in 3xTF32): the split kernel
     (``csrc/tf32_split.cu``) bit-equal to its plain version, hi and the
     pair, on activations (channels_last, contiguous, C = 6) and OIHW
     weights in each order the convolutions use, and timed on the level-0
     activation beside its bound (4 bytes read or written per element and
     part); one strict training step at b8 whose every convolution takes
     the strict paths (the counter's ``conv2d`` paths: an IEEE forward at
     every site, some as transposed convolutions, the weight gradient at
     every site, the 3xTF32 input gradient where the input needs one, two
     split launches each, no ``F.conv2d``, ``cudnn.allow_tf32`` as before); one
     EDM pass (8 rows) all in 3xTF32, and the device time of its
     non-vectorized elementwise kernels (BROADCAST_KERNEL) by the module
     and the ops that launched them; the EDM pass again with all but
     PRESSURE_FREE of the card taken, bit-equal or not, in 3xTF32 and in
     IEEE fp32; the step's and the pass's convolutions replayed on their
     shapes through the port's paths and through IEEE fp32 ``F.conv2d``
     and its backward (the yardstick, ``library_ms``): device ms, events
     ms, launches, the leading kernels, the memory a call takes beyond
     its inputs and outputs (cuDNN's workspace), and no FFT or complex
     kernel in the 3xTF32 forward, or it fails.
 18. CorrDiff (``ds_model=corrdiff``) at the benchmark cell's widths,
     448x448 (159,970,822 parameters, seeded random weights): the fp32 K2
     at kD = 256 (``attention_fwd_f32_wide``: threads, shared memory held
     against ``fp32_plan(256)``, registers, no spill); (a) K2 at kD = 256
     against its plain version, O and the row lse, at the path's site (b2,
     L = 784, one head of 256) and at KD256_CASES, every layout, within the
     strict limit, a second call bit-equal, each launch counted at fp32 kD
     256; (b) K1 at every distinct site of the path (b2 and b1,
     on chip and streamed, as ``gn_silu.plan`` picks) against its plain
     version, fp32, eps 1e-6, unmodulated and with a per-sample shift
     added (``shift_in``), two calls bit-equal; (c) the path's sites by hooks
     against ``gn_silu_sites`` and the plan's 6 attention
     blocks, then the launch counter reset just before one denoiser pass
     at 2 rows and one regression pass at 1 row: 111 K1 each, by plan as
     ``gn_silu.plan`` gives them and by modulation 55 ``shift_in``, 6 K2 at
     fp32 kD 256 and none else, no K3, no copy, finite output; a profile
     of the pass, and its BROADCAST_KERNEL time by launching module and
     ops; (d) K2 at the site by CUDA events and device time beside
     its plain version, SDPA (fp32, TF32 off) and the bound. The kernels
     line gets an ``attention_fwd_kd256`` entry and K1's entry the path's
     launches by plan.
 19. the bf16 AdamW update (``csrc/adamw_bf16.cu``) on the 128x128
     prob-U-Net's 103,541,083 parameters in their own layouts: the
     kernel's threads, registers and spills (none allowed); 3 updates
     against the foreach path on a copy with the same gradients, p, mu and
     nu bit-equal after each, one launch a step; the kernel alone by
     device time and CUDA events, and the host's ms a call (the table
     built and written each call), beside the foreach path and the bytes
     bound (24 bytes an element). The kernels line gets an
     ``adamw_bf16`` entry.
 20. dropout's compare, scale and select (``csrc/dropout.cu``) alone:
     each (dtype, mode) instantiation's threads, registers and spills (none
     allowed); at ClimaX's MLP-hidden site (64 x 2,048 x 4,096, bf16,
     element mode), its drop_path site (64 x 2,048 x 1,024, bf16, row mode)
     and the U-Net's level-0 site (b8, 128 channels at 128x128, fp32,
     channels_last against the NHWC draw) the output and input gradient
     bit-equal to the plain chain's, then both directions of the kernel
     and of the plain chain by device time and CUDA events, beside the
     bytes bound; the host's time a call of each, forward and backward, at
     a small site. Phases 8 and 11-15 hold every training path's dropout
     counts to one element launch each way a U-Net block and a step (two
     forwards under remat; spatial ranks copy each forward's uniforms).
     The kernels line gets a ``dropout`` entry with the counts by path.

Every device time of a kernel or of SDPA (phases 6, 10, 16-20) comes from one
estimator, ``device_ms(whole=True)``: each kernel's mean launch pooled over
five traces times its launches per call, which records the profiler loses
late in a long run do not bias. Any failed phase
raises, so the script exits non-zero and prints no result. The line before the last is the ``kernels`` JSON object, the last
line ``{"ok": true, "device": {...}}``.
"""

import contextlib
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

# the launch counter's kernels (probunet_torch/ops/_build.py::launches) the
# checks read: K1, K2 and K3, then the tensors copied before an attention launch
KERNELS = ("gn_silu", "attention_fwd", "attention_bwd")
COUNTED = KERNELS + ("kernel_layout",)

RES, BATCH, MEMBERS = 128, 8, 16
DAYS = 32                # four batches of 8 test days
K1_PER_BATCH, K2_PER_BATCH = 57, 11
# of the K1 launches a forward, the 28 blocks' norm1 take the embedding's
# (scale, shift) in the launch (counted under "scale_shift"); the blocks'
# norm0 and out_norm are unmodulated ("none")
K1_MOD_PER_BATCH = {"none": 29, "scale_shift": 28}
K3_PER_STEP = 11          # one K3 launch per attention block in the backward
TRAIN_STEPS, WARMUP_STEPS = 10, 3
EXPECTED_PARAMS = 103_541_083
GN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 2 ** -8)}   # (atol, rtol)
# K1 with the embedding's terms in the launch: bf16 outputs reach past 4,
# where one rounding of two fp32 results apart is up to one ulp, 2^-7
GN_MOD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 2 ** -7)}
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
# (B, (L, heads)) off the path: ragged, single-row and long sequences
EDGE_SHAPES = [(2, (100, 2)), (2, (1, 2)), (2, (65, 3)), (1, (2048, 2)), (1, (4096, 2))]
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
# phase 13, the baselines: the deterministic U-Net of the reference at
# 128x128 (width 64, no attention), 22,792,579 parameters with id labels
# (map_label, 2 x 256, with cyclic); BCSD card against CPU: fp32 day-of-year
# sums in another order, then a ratio, relative to the largest prediction
BASELINE_PARAMS = 22_792_579
BCSD_TOL = 1e-5
VARS = ("pr", "tasmin", "tasmax")
# phase 14, several processes: two ranks share the card over gloo (NCCL
# refuses two ranks on one device), each with its rows of the b8 global
# batch; the one-process run with data_shards 2 computes the same global
# batches. Limits of tests/test_multihost_e2e.py: the step-1 loss (the same
# parameters and batch; only the order of the gradient's sum over the two
# half batches differs) and the trajectory and val loss (that noise
# compounds through the optimizer), relative
MP_RANKS, MP_STEP1_TOL, MP_TRAJ_TOL = 2, 1e-5, 5e-3
# the final parameters: ||update_2ranks - update_1process|| / ||update_1process||
# over every parameter (update = final - initial). Read 9.54e-3 (PERF.md
# section 6): 8,879 elements, deep conv0 weights, part by more than lr. Their
# gradient is 0 until step 3 (the zero-initialized out_conv and conv1 stand
# before them), and at step 3 it lies within the two sides' rounding (median
# |g| 5.4e-7, opposite signs in 98 %; cuDNN's fp32 algorithms differ at 4
# rows and at 8), so AdamW's first bias-corrected step sends each ~0.6 lr one
# way on one side and the other way on the other. The planted fault of
# local-shape dropout reads 0.275; the limit sits between the two readings
MP_PARAM_TOL = 5e-2
# strict (fp32) serving, max abs diff / max |value| of the merged file against
# one process's: cuDNN picks its fp32 convolution algorithm by the free memory
# (the workspace must fit), and ranks sharing a card see less, so a rank may
# sum in another order: 3.05e-5 K on 284 K read (1e-7). A wrong draw, batch
# or statistic moves values by the members' spread, which phase 14 prints
MP_STRICT_SERVE_TOL = 1e-5
MP_TRAIN_YEARS = 2          # an even count: equal shards, 2 steps per epoch at b8
MP_GRAD_STEPS = (1, 2, 3)   # the steps whose gradients phase 14 reads from checkpoints
MP_SERVE_DAYS = 24          # 3 batches of 8 of phase 4's days: rank 0 serves 2, rank 1 one
# phase 15, spatial (H-axis) model parallelism. (a) one NCCL rank, the
# sharded step against the unsharded ELBO with z on the same weights and
# batch: phase 9's limits (loss and gradient norm relative, each gradient
# relative to its tensor's largest entry; the sharded path runs plain
# GroupNorm with one-pass fp32 sums where the unsharded one runs K1, and
# cuDNN convolves the halo-padded rows with its own algorithms). (b) and (d)
# hold sharded trainer runs against one process computing the same global
# batches, with phase 14's limits (MP_STEP1_TOL, MP_TRAJ_TOL). (c) a tile
# of BASELINE's multi-variable 256x256 configuration on two ranks with remat
SP_RANKS, SP_2D_RANKS, SP_TILE, SP_TILE_STEPS = 2, 4, 256, 3
# the largest batch among these whose unsharded strict step (remat) peaks
# under SP_TILE_PEAK_GIB alone: two ranks each hold about half of it
SP_TILE_BATCHES, SP_TILE_PEAK_GIB = (4, 2), 36.0
# phase 16, the prob-U-Net at --model_channels 96 (full depth, phase 4's
# data): the 288-wide 32x32 level's 5 attention blocks run 4 heads of 72
# (the kernels' kD = 128 instantiation), the 384-wide 16x16 level's 6 run
# 6 heads of 64; (L, heads, c) -> blocks per U-Net pass
MC96, MC96_PARAMS = 96, 59_645_627
MC96_SITES = {(1024, 4, 72): 5, (256, 6, 64): 6}
MC96_STEPS, MC96_BATCHES, MC96_WARMUP = 5, 4, 2
# (c) head dims past 64 (kD = 128): 72 (this path), 80, 96 and 120 (heads
# of other widths: rows of whole 16-byte bf16 chunks, read in place), 100
# and 127 (copied, zero-padded to 104 and 128), at these lengths (100
# ragged), b2 with 2 heads, and the path's site itself
MC96_HEAD_DIMS = (65, 72, 80, 88, 96, 100, 120, 127)
MC96_LENGTHS = (64, 256, 1024, 100)
# (L, heads) at b8 whose plans take every block shape built at the exact
# widths kD = 80 / 96 (phase 1): the path's 32x32 site, one 64-row tile
EXACT_SITES = [(1024, 4), (64, 4)]
# phase 17: the device memory left free when the EDM pass runs again under
# pressure (cuDNN falls back to another algorithm when a workspace does not fit)
PRESSURE_FREE = 3 * 2 ** 30
# the split kernel against its plain version: bit for bit
SPLIT_TOL = 0.0
# phase 18, CorrDiff at the cell's widths (perfbench/configs/corrdiff_cwb448.json):
# a denoiser pass at 2 rows (the cell's b1 x K2), a regression pass at 1; per
# pass 111 K1 sites and 6 attention blocks of one 256-wide head over 28x28
CORRDIFF_RES, CORRDIFF_ROWS, CORRDIFF_PARAMS = 448, 2, 159_970_822
CORRDIFF_K1_PER_PASS, CORRDIFF_K2_PER_PASS = 111, 6
# the 55 DDPM++ blocks' norm1 add the embedding's shift in the launch
CORRDIFF_K1_MOD_PER_PASS = {"none": 56, "shift_in": 55}
# PyTorch's non-vectorized elementwise kernel (broadcasts, strided operands):
# phases 17 and 18 give its device time by the module and op that launched it
BROADCAST_KERNEL = "elementwise_kernel<128, 2"
# (B, L, heads, c) of K2 at kD = 256: the path's site, one row, a ragged
# 32-row tile with two heads, a narrower head read in place (200) and one
# copied zero-padded (129 -> 136)
KD256_SITE = (2, 784, 1, 256)
KD256_CASES = [KD256_SITE, (1, 1, 1, 256), (1, 65, 2, 256), (2, 100, 1, 200), (2, 100, 1, 129)]
# phase 19, the bf16 AdamW update (csrc/adamw_bf16.cu) on the prob-U-Net's
# parameter list (EXPECTED_PARAMS): the fused launch against the foreach path
# over ADAMW_STEPS steps, bit-equal; its bound reads p, grad and nu in fp32
# and mu in bf16 and writes p, mu and nu, ADAMW_BYTES an element
ADAMW_STEPS = 3
ADAMW_BYTES = 24
ADAMW_HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01, lr=1e-3)
# phase 20, dropout's select (csrc/dropout.cu) alone: (name, shape, dtype,
# mode) at ClimaX's MLP-hidden site, its drop_path site and the U-Net's
# level-0 site (NCHW, channels_last), all at the configurations' rate 0.1
DROPOUT_SITES = [("climax_mlp_hidden", (64, 2048, 4096), "bfloat16", "element"),
                 ("climax_drop_path", (64, 2048, 1024), "bfloat16", "row"),
                 ("unet_level0", (BATCH, 128, RES, RES), "float32", "element")]
DROPOUT_RATE = 0.1
# and its host cost a call, forward and backward through autograd, beside
# the plain chain's: a site small enough that the card keeps ahead of the host
DROPOUT_HOST_SITE, DROPOUT_HOST_REPS = (2, 64, 8, 8), 200
# dropout in the training phases: one element site a U-Net block (UNetBlock),
# 28 in each U-Net they train (prob-U-Net, EDM denoiser, deterministic
# baseline); no row site. dropout_check holds each path's counts to them and
# keeps them here for the kernels line's dropout entry
DROPOUT_PER_STEP = 28
DROPOUT_BY_PATH = {}


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
    """Tensor-core and TMA instructions per attention kernel function in the
    built library, by ``cuobjdump -sass``: HMMA (mma.sync), HGMMA (wgmma),
    UTMALDG (a TMA tensor load). Raises unless every kernel that does
    products has HGMMA and UTMALDG and none has HMMA: the fp32 ``_f32``
    kernels (forward, row pass, dK/dV and dQ at each head width) and the
    bf16 ``_sm90`` forward, dK/dV and dQ kernels of each plan; the bf16 row
    pass (``attention_bwd_prep_sm90``) does no product. The fp32 forward at
    kD = 256 is ``attention_fwd_f32_wide``."""
    import re

    dump = subprocess.run([_build.find_tool("cuobjdump"), "-sass", str(_build.LIB_PATH)],
                          capture_output=True, text=True, check=True).stdout
    arg = {"Lb0E": "false", "Lb1E": "true"}
    counts, cur = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            m = re.search(r"\d(attention_[a-z0-9_]+?)(?:I((?:Li\d+E|Lb[01]E)+)E)?E", line)
            cur = None
            if m:
                args = re.findall(r"Li\d+E|Lb[01]E", m.group(2) or "")
                cur = m.group(1) + (f"<{', '.join(arg.get(a, a[2:-1]) for a in args)}>"
                                    if args else "")
                counts[cur] = {"HMMA": 0, "HGMMA": 0, "UTMALDG": 0}
        elif cur is not None:
            op = re.search(r"\b(HGMMA|HMMA|UTMALDG)\.", line)
            if op:
                counts[cur][op.group(1)] += 1
    for name, c in sorted(counts.items()):
        log(f"[1] SASS {name}: {c['HMMA']} HMMA, {c['HGMMA']} HGMMA, {c['UTMALDG']} UTMALDG")
    fp32 = [n for n in counts if "_f32<" in n or "_f32_wide<" in n]
    sm90 = [n for n in counts if "_sm90<" in n and "_prep_" not in n]
    # fp32 at head widths kD = 64 and 128: fwd, the row pass, dq x 2, dkdv x
    # (one kernel at 64; a dV and a dK pass at 128); at kD = 256 the forward
    # alone (attention_fwd_f32_wide). bf16 at kD = 64, 80, 96
    # and 128: fwd x (3 block shapes at 64, 2 at 80, 1 at 96 and 128); dkdv
    # x (fast at 64 rows, split dS at 64 and 128 rows at kD = 64; fast and
    # split at 80 and 96; at kD = 128 a dV pass and a dK pass fast and
    # split); dq x (3 at 64, fast and split at 80, 96 and 128); the row
    # pass x 4
    want = {"fp32": 3 * 2 + 3 + 1, "sm90": 7 + 10 + 9, "all": 10 + 26 + 4}
    bad = [n for n in fp32 + sm90 if not (counts[n]["HGMMA"] and counts[n]["UTMALDG"])]
    bad += [n for n, c in counts.items() if c["HMMA"]]
    if (len(fp32), len(sm90), len(counts)) != (want["fp32"], want["sm90"], want["all"]) or bad:
        raise AssertionError(f"expected {want} attention kernels, each that multiplies with "
                             f"HGMMA and UTMALDG and none with HMMA; found {counts}, at fault: "
                             f"{bad}")
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
        by_mod = {}
        for mod, mod_name in enumerate(K1.MODS):
            buf = (ctypes.c_int * len(keys))()
            _build.check(_build.lib().probunet_gn_silu_query(
                int(dtype == torch.bfloat16), 16 // dtype.itemsize, c, g, p.cb, p.n,
                p.chunk_rows, mod, buf), "gn_silu query")
            by_mod[mod_name] = dict(zip(keys, buf))
        d = {**p._asdict(), **by_mod["none"], "blocks": BATCH * c // p.cb * p.n,
             "by_mod": {k: {"registers": v["registers"], "local_bytes": v["local_bytes"],
                            "max_active_clusters": v["max_active_clusters"]}
                        for k, v in by_mod.items()}}
        info[name] = d
        log(f"[1] K1 {name} at {BATCH}x{h}x{w}x{c}: cb {p.cb} ({c // p.cb} channel blocks), "
            f"clusters of {p.n} x {d['threads']} threads, {p.rows} rows per block, on chip "
            f"{p.on_chip}; {d['dynamic_smem']} B dynamic + {d['static_smem']} B static shared "
            f"per block, {d['registers']} registers, {d['local_bytes']} B spilled; "
            f"{d['max_active_clusters']} clusters resident at once "
            f"({d['max_active_clusters'] * p.n} blocks on {num_sms} SMs) of {d['blocks'] // p.n}"
            f"; by modulation (registers, spilled bytes, clusters resident): "
            + ", ".join(f"{k} ({v['registers']}, {v['local_bytes']}, {v['max_active_clusters']})"
                        for k, v in d["by_mod"].items()))
        if min(v["max_active_clusters"] for v in d["by_mod"].values()) < 1:
            raise AssertionError("no K1 cluster of the largest site fits on the card")
    return info


def attn_kernel_info(torch, K2, sites, num_sms, kd=64, phase=1):
    """The bf16 attention kernels of the plan at each (L, heads) site at
    batch BATCH and head width ``kd``: block sizes, threads, dynamic shared
    bytes (checked against the plan's own figure), registers and spilled
    bytes, as the built library reports them (cudaFuncGetAttributes).
    Raises if a kernel spills or the plan's shared memory disagrees with the
    kernel's."""
    from probunet_torch.ops import _build

    lib, out, info = _build.lib(), (ctypes.c_int * 5)(), []
    keys = ("threads", "dynamic_smem", "registers", "local_bytes", "static_smem")

    def query(fn, *args):
        _build.check(fn(*args, out), "attention query")
        return dict(zip(keys, out))

    # K3's kernels: dK/dV and dQ; at kD = 128 the dK/dV kernel's dV and dK
    # passes; the row pass (no dynamic shared memory)
    bwd = ((0, "dkdv"), (1, "dq")) if kd != 128 else ((0, "dv"), (2, "dk"), (1, "dq"))
    for L, nh in sites:
        p = K2.plan(BATCH, nh, L, num_sms, kd)
        kernels = {"fwd": (query(lib.probunet_attention_fwd_query, p.fwd_rows, p.fwd_tile, kd),
                           p.fwd_smem),
                   "row_pass": (query(lib.probunet_attention_bwd_query, 3, 64, 0, kd), 0)}
        for split, rows in ((0, p.bwd_rows), (1, p.bwd_split_rows)):
            for k, name in bwd:
                d = query(lib.probunet_attention_bwd_query, k, rows, split, kd)
                kernels[f"{name}{'_split' if split else ''}"] = (d, K2._bwd_smem(rows, k != 1, kd))
        for name, (d, planned) in kernels.items():
            log(f"[{phase}] attention {name} at {BATCH}x{L}x{nh} (plan {p[:4]}"
                f"{'' if kd == 64 else f', kD {kd}'}): {d['threads']} "
                f"threads, {d['dynamic_smem']} B dynamic shared (plan {planned}), "
                f"{d['registers']} registers, {d['local_bytes']} B spilled")
            if d["dynamic_smem"] != planned or d["local_bytes"]:
                raise AssertionError(f"attention {name}: {d}, plan's shared bytes {planned}")
        info.append({"site": [BATCH, L, nh], "plan": p._asdict(),
                     **{name: d for name, (d, _) in kernels.items()}})
    return info


def f32_kernel_info(torch, K2, kd, phase=1):
    """The fp32 attention kernels of ``fp32_plan(kd)`` (at kd 256 the
    forward alone): threads, dynamic shared bytes (checked against the
    plan's own figure), registers and spilled bytes, as the built library
    reports them. Raises if a kernel spills or the plan's shared memory
    disagrees with the kernel's."""
    from probunet_torch.ops import _build

    lib, out, p = _build.lib(), (ctypes.c_int * 5)(), K2.fp32_plan(kd)
    keys = ("threads", "dynamic_smem", "registers", "local_bytes", "static_smem")
    _build.check(lib.probunet_attention_fwd_f32_query(kd, p.fwd_tile, out), "attention query")
    kernels = {"fwd": (dict(zip(keys, out)), p.fwd_smem)}
    bwd = [(3, "row_pass", p.prep_smem), (0, "dkdv" if kd == 64 else "dv", p.dkdv_smem),
           (1, "dq", p.dq_smem)] + ([(2, "dk", p.dk_smem)] if kd == 128 else [])
    for k, name, planned in bwd if p.bwd_tile else []:
        _build.check(lib.probunet_attention_bwd_f32_query(k, kd, p.bwd_tile, out),
                     "attention query")
        kernels[name] = (dict(zip(keys, out)), planned)
    for name, (d, planned) in kernels.items():
        log(f"[{phase}] attention fp32 {name} at kD {kd} (K/V tiles {p.fwd_tile} rows, K3 "
            f"tiles {p.bwd_tile}): {d['threads']} threads, {d['dynamic_smem']} B dynamic shared "
            f"(plan {planned}), {d['registers']} registers, {d['local_bytes']} B spilled")
        if d["dynamic_smem"] != planned or d["local_bytes"]:
            raise AssertionError(f"attention fp32 {name}: {d}, plan's shared bytes {planned}")
    return {"plan": p._asdict(), **{name: d for name, (d, _) in kernels.items()}}


# K3's kernels by name in a profile: the row pass, dK/dV (both passes at
# kD = 128), dQ
K3_KERNELS = (("row_pass", r"attention_bwd_(prep|rowdot)"), ("dkdv", r"attention_bwd_dkdv"),
              ("dq", r"attention_bwd_dq"))


def k3_split(split):
    """K3's device ms per call by kernel (K3_KERNELS) from device_ms's
    ``split``; anything else under ``other``."""
    import re

    out = {name: 0.0 for name, _ in K3_KERNELS}
    out["other"] = 0.0
    for key, ms in split.items():
        name = next((n for n, pat in K3_KERNELS if re.search(pat, key)), "other")
        out[name] += ms
    return {f"{name}_device_ms": ms for name, ms in out.items()}


def qkv_views(torch, layout, b, L, nh, dtype, dev, gen, c=64):
    """q, k, v of shape (b, L, nh, c) in ``layout`` (see LAYOUTS)."""
    if layout == "block":
        return torch.randn(b, L, 3, nh, c, device=dev, generator=gen).to(dtype).unbind(2)
    if layout == "stride3":
        y = torch.randn(b, L, nh, c, 3, device=dev, generator=gen).to(dtype)
        return y[..., 0], y[..., 1], y[..., 2]
    return tuple(torch.randn(b, L, nh, c, device=dev, generator=gen).to(dtype)
                 for _ in range(3))


def _device_events(torch, prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.count]


def device_ms(torch, fn, reps=50, traces=5, warm=True, whole=False, split=None, _again=2):
    """Mean device time per call of ``fn`` in ms: the kernels' own time from
    torch.profiler over ``traces`` traces of ``reps`` calls, free of the
    host's launch pace. A trace with no device activity (the profiler now
    and then loses the records of a window of short kernels) is logged and
    taken again, up to five times. Without ``whole``, the largest of the
    traces' sums (lost records only lower a sum). With ``whole`` (for a call
    that launches a fixed set of kernels: the port's own, SDPA), the sum over
    the call's kernels of each one's launches per call times its mean launch
    pooled over the traces: late in a long run the profiler drops a share of
    a trace's records and delivers a few of earlier work, which thin the
    mean but do not bias it, and leave the launches per call (each kernel's
    count over ``reps``, rounded, at its largest in any trace; a kernel of
    earlier work rounds to 0 and is left out) as they are; where every
    kernel rounds to 0, the profiler lost most of the call's records, and
    the traces are taken again, twice at most. ``split``, a dict, gets each
    kernel's ms per call. ``warm=False`` skips the warm-up call (``fn`` ran
    just before)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    if warm:
        fn()
    torch.cuda.synchronize()
    runs, empty = [], 0
    while len(runs) < traces and empty < 5:
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _device_events(torch, prof)
        if events:
            runs.append({e.key: (e.self_device_time_total, e.count) for e in events})
        else:
            empty += 1
            log(f"    torch.profiler saw no device time in a trace of {reps} calls; tracing again")
    if not runs:
        raise AssertionError(f"torch.profiler saw no device time in {empty} traces")
    if whole:
        per = {}
        for key in {k for r in runs for k in r}:
            seen = [r[key] for r in runs if key in r]
            n = max(round(count / reps) for _, count in seen)
            if n:
                per[key] = sum(t for t, _ in seen) / sum(c for _, c in seen) / 1e3 * n
        if not per and _again:
            log(f"    torch.profiler kept fewer than half of every kernel's launches in "
                f"{len(runs)} traces of {reps} calls; tracing again")
            return device_ms(torch, fn, reps, traces, False, whole, split, _again - 1)
    else:
        per = max(({k: t / 1e3 / reps for k, (t, _) in r.items()} for r in runs),
                  key=lambda d: sum(d.values()))
    if split is not None:
        split.update(per)
    return sum(per.values())


def peak_rates():
    """The card's peak rates, as the benchmark takes them
    (perfbench/peaks.json): ``hbm_bytes_per_s`` and ``flops_per_s`` by
    type."""
    with open(os.path.join(ROOT, "perfbench", "peaks.json")) as f:
        return json.load(f)


def attn_bound(flops, nbytes, mode):
    """The bound terms in ms of one attention site's work, ``flops`` and
    ``nbytes``: fast against the bf16 tensor-core rate; strict (fp32, or
    bf16 activations with fp32 products) against the smaller of the fp32
    CUDA-core time and three TF32 tensor-core products. Summed over sites."""
    p = peak_rates()
    mem = nbytes / p["hbm_bytes_per_s"] * 1e3
    if mode == "fast":
        ops = flops / p["flops_per_s"]["bf16"] * 1e3
        return {"bound_ms": max(ops, mem), "ops_ms": ops, "bytes_ms": mem}
    fp32 = flops / p["flops_per_s"]["fp32"] * 1e3
    tf32x3 = 3 * flops / p["flops_per_s"]["tf32"] * 1e3
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
    tot["bound_share_device"] = tot["bound_ms"] / tot["device_ms"]
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


def time_k1(torch, sites, dtype, dev, gen, phase):
    """K1 at each distinct (H, W, C) of ``sites`` at batch BATCH in
    ``dtype``: the kernel by CUDA events and by device time, its plain
    version, F.group_norm + silu (a yardstick the port never calls) and the
    bound (x read once, the output written once, at the HBM rate); logged
    per site and summed over ``sites`` (one forward)."""
    import torch.nn.functional as F

    from probunet_torch.ops import gn_silu as K1
    from probunet_torch.ops.norm import num_groups_for

    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "library_device_ms": 0.0, "bound_ms": 0.0}
    for (h, w, c), mult in _counts(sites).items():
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
            t = {"ms": cuda_ms(torch, run), "device_ms": device_ms(torch, run, whole=True),
                 "plain_ms": cuda_ms(torch, lambda: K1._plain_gn_silu(x, gamma, beta, g)),
                 "library_ms": cuda_ms(torch, lib),
                 "library_device_ms": device_ms(torch, lib, whole=True)}
        t["bound_ms"] = 2 * x.numel() * x.element_size() / peak_rates()["hbm_bytes_per_s"] * 1e3
        log(f"[{phase}] K1 {str(dtype)[6:]:8s} {BATCH}x{h}x{w}x{c} x{mult}: kernel "
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


def k1_modulated_check(torch, K1, dev, cases, gen, num_sms, eps=1e-5, phase=2):
    """K1 with the embedding's terms in its launch against its plain
    version at each (B, H, W, C, what) of ``cases``, fp32 and bf16: (scale,
    shift) and shift_in, each per sample (B, C) and shared (1, C); output
    and statistics, two calls bit-equal, each launch counted under its
    modulation. Returns the largest error by dtype; raises on a miss."""
    from probunet_torch.ops import _build
    from probunet_torch.ops.norm import group_stats, num_groups_for

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = GN_MOD_TOL[str(dtype).split(".")[1]]
        worst[str(dtype)[6:]] = 0.0
        for (b, h, w, c, what) in cases:
            g = num_groups_for(c)
            p = K1.plan(b, h, w, c, g, dtype.itemsize, num_sms)
            x = (torch.randn(b, h, w, c, device=dev, generator=gen) + 0.5).to(dtype)
            gamma = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
            beta = 0.1 * torch.randn(c, device=dev, generator=gen)
            for mod in ("scale_shift", "shift_in"):
                for rows in sorted({b, 1}, reverse=True):
                    s, t = (0.5 * torch.randn(rows, c, device=dev, generator=gen)
                            for _ in range(2))
                    kw = {"scale": s, "shift": t} if mod == "scale_shift" else {"shift_in": t}
                    _build.reset_launches()
                    with torch.inference_mode():
                        out, mean, rstd = K1.gn_silu(x, gamma, beta, g, eps, True, **kw)
                        again = K1.gn_silu(x, gamma, beta, g, eps, True, **kw)
                        ref, rmean, rrstd = K1._plain_gn_silu(x, gamma, beta, g, eps, **kw)
                        u = x.float() + t[:, None, None, :] if mod == "shift_in" else x
                        smean, srstd = group_stats(u, g, eps)
                    torch.cuda.synchronize()
                    d = (out.float() - ref.float()).abs()
                    worst[str(dtype)[6:]] = max(worst[str(dtype)[6:]], d.max().item())
                    same = all(torch.equal(a, b_) for a, b_ in zip(again, (out, mean, rstd)))
                    ok = bool((d <= atol + rtol * ref.float().abs()).all()) and same
                    ok &= torch.allclose(mean, smean, rtol=1e-5, atol=1e-5)
                    ok &= torch.allclose(rstd, srstd, rtol=1e-5, atol=1e-5)
                    ok &= torch.equal(rmean, smean) and torch.equal(rrstd, srstd)
                    ok &= _build.launches("gn_silu") == _build.launches("gn_silu", mod) == 2
                    log(f"[{phase}] K1 {mod} ({rows}, {c}) {str(dtype)[6:]:8s} {b}x{h}x{w}x{c} "
                        f"({what}; {'on chip' if p.on_chip else 'streamed'}): max abs err "
                        f"{d.max().item():.3e} (atol {atol}, rtol {rtol:.3g}), two calls "
                        f"bit-equal {same} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"K1 {mod} disagrees with its plain version")
    return worst


def time_k1_mod(torch, sites, dtype, dev, gen, phase):
    """The blocks' norm1 at each distinct (H, W, C) of ``sites`` at batch
    BATCH in ``dtype``, by device time: K1 with per-sample (scale, shift) in
    its launch beside the unmodulated K1 at the same shape and the chain it
    replaces (the plain norm, then the terms and SiLU as separate PyTorch
    operations on the block's NCHW view); logged per site, summed over
    ``sites`` (one forward)."""
    from probunet_torch.ops import gn_silu as K1
    from probunet_torch.ops.norm import group_norm, num_groups_for

    tot = {"modulated_device_ms": 0.0, "unmodulated_device_ms": 0.0, "chain_device_ms": 0.0,
           "bound_ms": 0.0}
    for (h, w, c), mult in _counts(sites).items():
        g = num_groups_for(c)
        x = torch.randn(BATCH, h, w, c, device=dev, generator=gen).to(dtype)
        gamma = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
        beta = 0.1 * torch.randn(c, device=dev, generator=gen)
        s, t = (0.5 * torch.randn(BATCH, c, device=dev, generator=gen) for _ in range(2))
        st, tt = (v.to(dtype)[:, :, None, None] for v in (s, t))

        def chain():
            y = group_norm(x, gamma, beta, g).permute(0, 3, 1, 2) * (st + 1) + tt
            return y * torch.sigmoid(y)

        with torch.inference_mode():
            t_ = {"modulated_device_ms": device_ms(
                      torch, lambda: K1.gn_silu(x, gamma, beta, g, scale=s, shift=t), whole=True),
                  "unmodulated_device_ms": device_ms(
                      torch, lambda: K1.gn_silu(x, gamma, beta, g), whole=True),
                  "chain_device_ms": device_ms(torch, chain)}
        t_["bound_ms"] = 2 * x.numel() * x.element_size() / peak_rates()["hbm_bytes_per_s"] * 1e3
        log(f"[{phase}] K1 norm1 {str(dtype)[6:]:8s} {BATCH}x{h}x{w}x{c} x{mult}: (scale, shift) "
            f"in the launch {t_['modulated_device_ms']:.4f} ms device, unmodulated "
            f"{t_['unmodulated_device_ms']:.4f}, the plain chain {t_['chain_device_ms']:.4f}, "
            f"bound {t_['bound_ms']:.4f}")
        for key in tot:
            tot[key] += mult * t_[key]
    return tot


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
    from probunet_torch.ops import _build
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
    attn_info = attn_kernel_info(torch, K2, sorted(set(attn_sites)), num_sms)
    # the exact widths (64 < c <= 96) at the model_channels 96 path's 32x32
    # site and at one 64-row tile, which take each built block shape
    attn_info_exact = {f"kd{kd}": attn_kernel_info(torch, K2, EXACT_SITES, num_sms, kd)
                       for kd in (80, 96)}
    attn_info_f32 = {f"kd{kd}": f32_kernel_info(torch, K2, kd) for kd in (64, 128)}

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
    k1_mod_err = k1_modulated_check(torch, K1, dev, [c for c in cases if c[4] != "unaligned"],
                                    gen, num_sms)

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
                    again = K2.fused_attention(q, k, v, fast)
                    ref = K2._plain_attention(q, k, v, fast)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                same = torch.equal(out, again)
                ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol) and same
                worst = max(worst, err)
                log(f"[3] K2 {mode:11s} {layout:10s} B={b} L={L} heads={nh}: max abs err "
                    f"{err:.3e} (tol {tol}), two calls bit-equal {same} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("K2 disagrees with its plain version, or two calls "
                                         "differ")
        k2_err[mode] = worst

    mark(3)

    # ---- 4. the main path ----------------------------------------------------
    ckpt = os.path.join(WORK, "ckpt")
    save_checkpoint(ckpt, TrainState(model, None))   # parameters only, as serving holds them
    nb = DAYS // BATCH
    _build.reset_launches()
    outs, secs = {}, {}
    for name, c in (("strict", cfg), ("fast", fast_cfg)):
        secs[name] = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs[name] = downscale(c, ckpt, os.path.join(WORK, f"out_{name}.nc"),
                               batch_seconds=secs[name], device=dev)
        wall = time.perf_counter() - t0
        n1, n2 = _build.launches("gn_silu"), _build.launches("attention_fwd")
        log(f"[4] downscale {name}: {DAYS} days x {MEMBERS} members in {wall:.2f} s "
            f"(netCDF output), per batch {[round(s, 3) for s in secs[name]]} s, peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches so far K1 {n1}, K2 {n2}")
    launches = {k: _build.launches(k) for k in KERNELS}
    copies = _build.launches("kernel_layout")
    want = (2 * nb * K1_PER_BATCH, 2 * nb * K2_PER_BATCH, 0)
    serve_mods = {k: _build.launches("gn_silu", k) for k in K1_MOD_PER_BATCH}
    want_mods = {k: 2 * nb * v for k, v in K1_MOD_PER_BATCH.items()}
    log(f"[4] q/k/v copies before the attention launches: {copies}; K1 by modulation "
        f"{serve_mods} (expected {want_mods})")
    if tuple(launches.values()) != want or copies or serve_mods != want_mods:
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
    sample_card_vs_cpu(torch, model, cfg, ds, ds_cpu, dev, 5)
    mark(5)

    # ---- 6. timings ----------------------------------------------------------
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
                _build.reset_launches()
                # copy_ms: what the wrapper's layout step costs on these views
                t = {"ms": cuda_ms(torch, run), "device_ms": device_ms(torch, run, whole=True),
                     "copy_ms": cuda_ms(torch, lambda: [K2.kernel_layout(a) for a in (q, k, v)])}
                if _build.launches("kernel_layout"):
                    raise AssertionError("the block's q/k/v views were copied")
                t.update({"plain_ms": cuda_ms(torch, lambda: K2._plain_attention(
                              q, k, v, mode == "fast")),
                          "library_ms": cuda_ms(torch, lib),
                          "library_device_ms": device_ms(torch, lib, whole=True),
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

    k1_t = {"fp32": time_k1(torch, gn_sites, torch.float32, dev, gen, 6),
            "bf16": time_k1(torch, gn_sites, torch.bfloat16, dev, gen, 6)}
    # the blocks' norm1: the census's entries between each block's norm0
    # and the next (gn_silu_sites' order), the out_norm last
    norm1_sites = gn_silu_sites(*build_unet_plan(
        (RES, RES), 4, cfg.model_channels, cfg.channel_mult, cfg.num_blocks,
        cfg.attn_resolutions), (RES, RES))[1:-1:2]
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        k1_t[name]["norm1"] = time_k1_mod(torch, norm1_sites, dtype, dev, gen, 6)
    k2_t = {"strict": time_k2("strict"), "fast": time_k2("fast")}
    for name, tt in list(k1_t.items()) + list(k2_t.items()):
        log(f"[6] per forward at b{BATCH} ({name}): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in tt.items()))
    for name, tt in k1_t.items():
        log(f"[6] K1 norm1 per forward at b{BATCH} ({name}, {len(norm1_sites)} sites): "
            + ", ".join(f"{k} {v:.4f}" for k, v in tt["norm1"].items()))

    # the strict sampler (the fast one is the cell probunet_mc128.serve_fast_k16's)
    hr_all = ds.hr_device()
    fn = make_sample_fn(model, 4, cfg.standardization, MEMBERS, torch.float32)
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
        log(f"[6] sampler strict: {per * 1e3:.2f} ms per batch of {BATCH} inputs x {MEMBERS} "
            f"members at {RES}x{RES}: {BATCH / per:.2f} inputs/s, {BATCH * MEMBERS / per:.1f} "
            f"members/s ({card})")
        profile(torch, lambda: fn(hr_all, ds.stats, batches[0], eps=e), "sampler strict",
                "one batch")
    mark(6)

    train = training_phases(torch, dev, cfg, ds, ds_cpu, attn_sites, gen, mark)
    trainer = trainer_phase(torch, dev, card, mark)
    edm = edm_phase(torch, dev, card, ds, ds_cpu, gen, mark)
    baseline = baseline_phase(torch, dev, card, ds, ds_cpu, gen, mark)
    multi = multiprocess_phase(torch, dev, card, gn_sites, mark)
    spatial = spatial_phase(torch, dev, card, ds, mark)
    mc96 = mc96_phase(torch, dev, card, ds, ds_cpu, gen, mark)
    conv = conv_phase(torch, dev, card, mark)
    corrdiff = corrdiff_phase(torch, dev, card, gen, mark)
    adamw = adamw_phase(torch, dev, card, mark)
    drop = dropout_phase(torch, dev, card, mark)

    def entry(name, source, replaces, n, err, tol, t, extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "tolerance": tol,
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"], **extra}

    per = f"sum over the {{}} sites of one U-Net forward at b{BATCH}, {RES}x{RES}"
    by_path = {key: {"serve": launches[key], "train": train["launches"][key],
                     "trainer": trainer["launches"][key],
                     **{f"edm_{path}": n[key] for path, n in edm["launches"].items()},
                     **{f"baseline_{path}": n[key] for path, n in baseline["launches"].items()},
                     **{f"multiprocess_{path}": n[key] for path, n in multi["launches"].items()},
                     **{f"spatial_{path}": n[key] for path, n in spatial["launches"].items()},
                     **{path: n[key] for path, n in mc96["launches"].items()},
                     **{f"corrdiff_{path}": n[key] for path, n in corrdiff["launches"].items()}}
               for key in KERNELS}
    launches = {key: sum(by_path[key].values()) for key in by_path}
    return [
        entry("gn_silu_fwd", "probunet_torch/csrc/gn_silu.cu",
              "probunet_tpu/ops/pallas_gn.py:72", launches["gn_silu"],
              k1_err[torch.float32], GN_TOL["float32"], k1_t["fp32"],
              {"timed": per.format(K1_PER_BATCH) + ", fp32", "device_ms": k1_t["fp32"]["device_ms"],
               "library_device_ms": k1_t["fp32"]["library_device_ms"], "fp32": k1_t["fp32"],
               "bf16": k1_t["bf16"], "bf16_max_abs_err": k1_err[torch.bfloat16],
               "launches_by_path": by_path["gn_silu"], "largest_site": k1_info,
               "modulated_max_abs_err": k1_mod_err,
               "launches_by_mod": {"serve": serve_mods,
                                   **{f"edm_serve_{m}": r["k1_by_mod"]
                                      for m, r in edm["report"]["serve"].items()},
                                   **{f"corrdiff_{path}": r["k1_by_mod"] for path, r in
                                      corrdiff["report"]["passes"].items()}},
               "edm_128_rows_max_abs_err": edm["k1_err"],
               "corrdiff": {"by_plan": {path: r["k1_by_plan"] for path, r in
                                        corrdiff["report"]["passes"].items()},
                            "sites": corrdiff["report"]["k1_sites"],
                            "max_abs_err": corrdiff["k1_err"]},
               "baseline": {"timed": per.format(K1_PER_BATCH).replace(
                                "U-Net", "deterministic U-Net"),
                            "fp32": baseline["k1_t"]["fp32"], "bf16": baseline["k1_t"]["bf16"],
                            "max_abs_err": baseline["k1_err"], "report": baseline["report"]}}),
        entry("attention_fwd", "probunet_torch/csrc/attention_fwd.cu",
              "probunet_tpu/ops/pallas_attn.py:69", launches["attention_fwd"],
              k2_err["strict"], ATTN_TOL["strict"], k2_t["strict"],
              {"timed": per.format(K2_PER_BATCH) + ", strict fp32, on the block's views",
               "strict": k2_t["strict"], "fast": k2_t["fast"],
               "max_abs_err_by_mode": k2_err, "launches_by_path": by_path["attention_fwd"],
               "edm_fp32_fast_max_abs_err": edm["k2_err"], "edm": edm["report"],
               "with_lse": train["k2_lse"], "bf16_kernels_by_site": attn_info,
               "fp32_kernels": attn_info_f32,
               "mc96": {"timed": f"sum over the {sum(MC96_SITES.values())} sites of one "
                                 f"model_channels {MC96} U-Net forward at b{BATCH}",
                        "strict": mc96["report"]["timings"]["k2_strict"],
                        "fast": mc96["report"]["timings"]["k2_fast"],
                        "kd80_kernels": mc96["report"]["kd80_kernels"],
                        "kd128_kernels": mc96["report"]["kd128_kernels"],
                        "max_err": mc96["report"]["max_err"]},
               "sass": {n: c for n, c in sass.items() if n.startswith("attention_fwd")}}),
        entry("attention_bwd", "probunet_torch/csrc/attention_bwd.cu",
              "probunet_tpu/ops/pallas_attn.py:91", launches["attention_bwd"],
              train["k3_err"]["float32"], ATTN_BWD_TOL, train["k3_t"]["strict"],
              {"timed": f"sum over the {K2_PER_BATCH} sites of one U-Net backward at b{BATCH}, "
                        f"{RES}x{RES}, strict fp32, on the block's views",
               "strict": train["k3_t"]["strict"], "fast": train["k3_t"]["fast"],
               "max_rel_err": train["k3_rel"], "strict_bf16_ds_check": train["ds_check"],
               "launches_by_path": by_path["attention_bwd"],
               "edm_fp32_fast_max_rel_err": edm["k3_rel"],
               "trainer": trainer["report"],
               "multiprocess": multi["report"], "spatial": spatial["report"],
               "mc96": {"timed": f"sum over the {sum(MC96_SITES.values())} sites of one "
                                 f"model_channels {MC96} U-Net backward at b{BATCH}",
                        "strict": mc96["report"]["timings"]["k3_strict"],
                        "fast": mc96["report"]["timings"]["k3_fast"],
                        **{k: v for k, v in mc96["report"].items() if k != "timings"}},
               "sass": {n: c for n, c in sass.items() if n.startswith("attention_bwd")}}),
        *exact_width_entries(entry, mc96, attn_info_exact),
        entry("attention_fwd_kd256", "probunet_torch/csrc/attention_fwd.cu",
              "probunet_tpu/ops/pallas_attn.py:69",
              sum(p["fp32_kd256"] for p in corrdiff["report"]["passes"].values()),
              corrdiff["k2_err"]["out"], ATTN_TOL["strict"], corrdiff["k2_t"],
              {"timed": f"CorrDiff's attention site (B={KD256_SITE[0]}, L={KD256_SITE[1]}, one "
                        f"head of {KD256_SITE[3]}), strict fp32, on the block's views; "
                        f"{CORRDIFF_K2_PER_PASS} such sites a pass",
               "device_ms": corrdiff["k2_t"]["device_ms"],
               "plain_device_ms": corrdiff["k2_t"]["plain_device_ms"],
               "library_device_ms": corrdiff["k2_t"]["library_device_ms"],
               "lse_max_abs_err": corrdiff["k2_err"]["lse"],
               "launches_by_path": {path: p["fp32_kd256"] for path, p in
                                    corrdiff["report"]["passes"].items()},
               "corrdiff": corrdiff["report"],
               "sass": {n: c for n, c in sass.items()
                        if n.startswith("attention_fwd_f32_wide")}}),
        entry("tf32_split", "probunet_torch/csrc/tf32_split.cu",
              "none: the 3xTF32 parts of cuDNN's fp32 convolutions' operands",
              sum(conv["launches"].values()), conv["max_abs_err"], SPLIT_TOL, conv["split"],
              {"timed": f"the level-0 activation ({BATCH}x128x{RES}x{RES} fp32) split into "
                        f"hi and [lo, hi]; bit-equal to the plain version",
               "device_ms": conv["split"]["device_ms"], "launches_by_path": conv["launches"],
               "convolutions": conv["report"]}),
        entry("adamw_bf16", "probunet_torch/csrc/adamw_bf16.cu",
              "none: the bf16-state AdamW update (train/state.py::AdamWBf16State)",
              adamw["launches"]["fused"] + train["adamw"]["fused"], 0.0, 0.0, adamw["t"],
              {"timed": f"one update of the {EXPECTED_PARAMS:,} parameters of the {RES}x{RES} "
                        f"prob-U-Net ({adamw['layouts']['tensors']} tensors); bit-equal to the "
                        f"foreach path",
               "device_ms": adamw["t"]["device_ms"],
               "plain_device_ms": adamw["t"]["plain_device_ms"],
               "host_ms": adamw["t"]["host_ms"], "plain_host_ms": adamw["t"]["plain_host_ms"],
               "launches_by_path": {"train_fast": train["adamw"]["fused"],
                                    "phase19": adamw["launches"]["fused"]},
               "kernel": adamw["info"]}),
        entry("dropout", "probunet_torch/csrc/dropout.cu",
              "none: dropout's compare, scale and select (models/layers.py; the JAX package's "
              "flax nn.Dropout, fused by XLA)", drop["launches"] + sum(
                  n for got in DROPOUT_BY_PATH.values() for k, n in got.items()
                  if not k.endswith("copy")), 0.0, 0.0,
              drop["sites"]["climax_mlp_hidden"]["fwd"],
              {"timed": "each site forward and backward, the kernel alone and the plain chain; "
                        "bit-equal to the plain chain",
               "device_ms": drop["sites"]["climax_mlp_hidden"]["fwd"]["device_ms"],
               "host": drop["host"],
               "launches_by_path": {**DROPOUT_BY_PATH, "phase20": drop["launches"]},
               "sites": drop["sites"], "kernels": drop["info"]}),
    ]


def exact_width_entries(entry, mc96, info):
    """The kernels line's entries of the exact-width bf16 instantiations of
    K2 and K3 (kD = 80 / 96, head dims 65-96): their launches on the
    model_channels 96 path (phase 16 (b)), their largest error against the
    plain versions at c = 65-96 in fast mode (phase 16 (c)), and their
    times, bound and SDPA's at the path's exact-width sites in fast mode
    (phase 16 (d)), beside the kD = 128 kernels' on the same inputs."""
    launches = {leg: sum(n["by_kd"][leg].get(("bf16", kd), 0)
                         for n in mc96["launches"].values() for kd in (80, 96))
                for leg in ("fwd", "bwd")}
    rep = mc96["report"]
    out = []
    for leg, name, src, replaces, err, tol in (
            ("fwd", "attention_fwd_exact_width", "probunet_torch/csrc/attention_fwd.cu",
             "probunet_tpu/ops/pallas_attn.py:69", rep["exact_max_err"]["fwd"], ATTN_TOL["fast"]),
            ("bwd", "attention_bwd_exact_width", "probunet_torch/csrc/attention_bwd.cu",
             "probunet_tpu/ops/pallas_attn.py:91", rep["exact_max_err"]["bwd"],
             ATTN_BWD_TOL["bfloat16"])):
        t = rep["timings"][f"k{2 if leg == 'fwd' else 3}_fast"]["exact_width_sites"]
        out.append(entry(name, src, replaces, launches[leg], err, tol, t, {
            "timed": f"sum over the {sum(n for (_, _, c), n in MC96_SITES.items() if c > 64)} "
                     f"head dim 72 sites (kD = 80) of one model_channels {MC96} U-Net "
                     f"{'forward' if leg == 'fwd' else 'backward'} at b{BATCH}, fast (bf16)",
            "device_ms": t["device_ms"], "library_device_ms": t["library_device_ms"],
            "kd128_device_ms": t["kd128_device_ms"], "fast": t,
            "vs_kd128": rep["exact_vs_kd128"], "kernels": info}))
    return out


def sample_card_vs_cpu(torch, model, cfg, ds, ds_cpu, dev, phase):
    """The sampler on the card (``model``) against the plain path on the
    CPU (a copy of its weights): one input, two members, the same eps,
    strict fp32; returns max abs err / max |ref|, raises past PATH_TOL."""
    from probunet_torch.train.loop import build_probunet
    from probunet_torch.train.steps import make_sample_fn
    from probunet_torch.utils.device import full_fp32

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
    log(f"[{phase}] path on the card vs plain path on the CPU (b=1, K=2, "
        f"{time.perf_counter() - t0:.1f} s on the CPU): max abs err / max |ref| = {rel:.3e} "
        f"(tol {PATH_TOL})")
    if not rel <= PATH_TOL:
        raise AssertionError("the path on the card disagrees with the plain path")
    return rel


def step_card_vs_cpu(torch, dev, cfg, ds, ds_cpu, phase):
    """One strict training step (b=1, dropout 0, filled weights, the same
    eps) on the card against the plain step on the CPU, with phase 9's
    limits (STEP_*_TOL); returns the readings, raises past a limit."""
    from probunet_torch.train.loop import build_probunet
    from probunet_torch.train.state import create_train_state, make_optimizer
    from probunet_torch.train.steps import make_probunet_train_step

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
        log(f"[{phase}] one step on the {where}: {time.perf_counter() - t0:.1f} s, loss "
            f"{loss:.6g}, grad norm {res[where][1]:.6g}")
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
    log(f"[{phase}] card vs CPU (b=1, {RES}x{RES}, strict fp32): loss rel err {loss_rel:.3e}, "
        f"grad norm rel err {norm_rel:.3e} (tol {STEP_LOSS_TOL}); worst gradient max|err| / "
        f"max|g| {grad_rel:.3e} ({worst}; tol {STEP_GRAD_TOL}); parameters after AdamW max abs "
        f"err {param_err:.3e} (tol {STEP_PARAM_TOL}) over the {compared:,} of {total:,} elements"
        f" whose gradient is clear of the error {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the training step on the card disagrees with the plain step")
    return {"loss_rel": loss_rel, "norm_rel": norm_rel, "grad_rel": grad_rel,
            "worst_grad": worst, "param_err": param_err}


def training_phases(torch, dev, cfg, ds, ds_cpu, attn_sites, gen, mark):
    """Phases 7-10: K3 on its own, the training path, the step against the
    plain step on the CPU, and the kernels' timings. Returns the launch
    counts of the training path, K3's errors and times, and K2's time with
    its lse."""
    import torch.nn.functional as F

    from probunet_torch.ops import _build
    from probunet_torch.ops import attention as K2
    from probunet_torch.train.loop import build_probunet, init_probunet_state
    from probunet_torch.train.state import make_optimizer
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
                    again = K2.attention_bwd(q, k, v, out, lse, do, fast)
                    ref = K2._plain_attention_bwd(q, k, v, do, fast)
                    k2 = (k / 8).to(dtype) if fast else k.float() / 8
                    ref_lse = torch.logsumexp(torch.einsum("bqhc,bkhc->bhqk", q.float(),
                                                           k2.float()), dim=-1).reshape(b * nh, L)
                torch.cuda.synchronize()
                errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(got, ref)]
                rels = [e / max(1e-3, r.float().abs().max().item()) for e, r in zip(errs, ref)]
                lse_err = (lse - ref_lse).abs().max().item()
                same = all(torch.equal(g, a) for g, a in zip(got, again))
                ok = max(rels) <= tol and lse_err <= 1e-4 and all(g.dtype == dtype for g in got)
                ok &= same
                k3_abs[mode] = max(k3_abs.get(mode, 0.0), max(errs))
                k3_rel[mode] = max(k3_rel.get(mode, 0.0), max(rels))
                log(f"[7] K3 {mode:11s} {layout:10s} B={b} L={L} heads={nh}: max abs err "
                    f"dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, / max|ref| "
                    f"{max(rels):.3e} (tol {tol}); K2 lse max abs err {lse_err:.3e} (tol 1e-4); "
                    f"two calls bit-equal {same} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("K3 or K2's lse disagrees with its plain version, "
                                         "or two K3 calls differ")
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
    counts = dict.fromkeys(KERNELS, 0)
    for name, c in train_cfgs.items():
        dtype = torch.bfloat16 if c.compute_dtype == "bfloat16" else torch.float32
        tx = make_optimizer(c.lr, c.weight_decay, c.accum, c.optimizer, None, c.opt_state_dtype)
        state = init_probunet_state(c, build_probunet(c, device="meta"), tx, device=dev)
        step = make_probunet_train_step(
            state.model, c.lowres_scale, c.standardization,
            beta_schedule(c.beta_schedule, c.beta, c.beta_warmup_steps), dtype, c.accum)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        ms = [step(state, hr_all, ds.stats, fixed_idx, c.seed, eps=fixed_eps.to(dev))
              for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = tuple(map(_build.launches, KERNELS))
        copies = _build.launches("kernel_layout")
        adamw = {k: _build.launches("adamw_bf16", k) for k in ("fused", "foreach")}
        drop_ok = dropout_check(8, f"train_{name}", dropout_counts(_build), TRAIN_STEPS)
        want = (TRAIN_STEPS * K1_PER_BATCH, TRAIN_STEPS * K2_PER_BATCH, TRAIN_STEPS * K3_PER_STEP)
        losses = [m["train_loss"].item() for m in ms]
        norms = [m["grad_norm"].item() for m in ms]
        log(f"[8] train {name}: {TRAIN_STEPS} steps at b{BATCH} in {wall:.2f} s; launches K1 "
            f"{n[0]}, K2 {n[1]}, K3 {n[2]} (expected {want}); q/k/v/out/dO copies before "
            f"the attention launches {copies}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"[8] train {name}: the bf16 AdamW update's fused launches {adamw['fused']}, "
            f"foreach updates {adamw['foreach']}")
        log(f"[8] train {name}: loss {[round(x, 1) for x in losses]}")
        log(f"[8] train {name}: grad norm {[round(x, 2) for x in norms]}; kl "
            f"{ms[-1]['kl_div'].item():.4g}, beta {ms[-1]['beta']}")
        if n != want or copies:
            raise AssertionError(f"training launches {n}, expected {want} ({K1_PER_BATCH} K1, "
                                 f"{K2_PER_BATCH} K2 and {K3_PER_STEP} K3 per step); {copies} "
                                 f"tensors copied before a launch, expected 0")
        if not drop_ok:
            raise AssertionError(f"{name}: dropout launches {DROPOUT_BY_PATH[f'train_{name}']}")
        fused = TRAIN_STEPS if c.opt_state_dtype == "bfloat16" else 0
        if (adamw["fused"], adamw["foreach"]) != (fused, 0):
            raise AssertionError(f"{name}: expected {fused} fused AdamW launches (one a step) "
                                 f"and no foreach update, got {adamw}")
        if fused:
            counts_adamw = adamw
        if not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"{name}: non-finite loss or gradient norm")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: the loss did not fall on a fixed batch")
        for key, val in zip(KERNELS, n):
            counts[key] += val
        del state, step, ms
    mark(8)

    # ---- 9. one step on the card against the plain step on the CPU ---------------
    step_card_vs_cpu(torch, dev, cfg, ds, ds_cpu, 9)
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

            split = {}
            with torch.no_grad():
                t = {"ms": cuda_ms(torch, run),
                     "device_ms": device_ms(torch, run, whole=True, split=split),
                     "plain_ms": cuda_ms(torch, lambda: K2._plain_attention_bwd(q, k, v, do, fast),
                                         reps=5)}
            t.update(k3_split(split))
            t["library_ms"] = cuda_ms(torch, lib)
            t["library_device_ms"] = device_ms(torch, lib, whole=True)
            flops = 10.0 * BATCH * nh * L * L * 64
            # q, k, v, o, dO read and dq, dk, dv written once, plus the fp32 lse
            nbytes = 8.0 * BATCH * L * nh * 64 * q.element_size() + 4.0 * BATCH * nh * L
            t.update(attn_bound(flops, nbytes, mode))
            flops_t += mult * flops
            log(f"[10] K3 {mode:6s} B={BATCH} L={L} heads={nh} x{mult}: kernel {t['ms']:.4f} ms "
                f"(device {t['device_ms']:.4f}: row pass {t['row_pass_device_ms']:.4f}, dK/dV "
                f"{t['dkdv_device_ms']:.4f}, dQ {t['dq_device_ms']:.4f}), plain "
                f"{t['plain_ms']:.4f}, SDPA backward "
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
    mark(10)
    return {"launches": counts, "adamw": counts_adamw,
            "k3_err": {"float32": k3_abs["strict"]}, "k3_rel": k3_rel,
            "k3_t": k3_t, "k2_lse": k2_lse, "ds_check": {**ds_seen, "limit": DS_SPLIT_TOL}}


def trainer_phase(torch, dev, card, mark):
    """Phase 11: the trainer end to end (see the module docstring). Returns
    its launch counts (the strict and fast runs) and its report."""
    import numpy as np

    from probunet_torch.config import Config
    from probunet_torch.data.synthetic import generate_climex_like
    from probunet_torch.ops import _build
    from probunet_torch.serve import downscale
    from probunet_torch.train.loop import build_probunet, init_probunet_state, train_probunet
    from probunet_torch.train.state import make_optimizer
    from probunet_torch.train.steps import _pair, make_probunet_train_step
    from probunet_torch.utils.device import full_fp32

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
    _build.reset_launches()
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
        ckpts[name] = ckpt
        del res
        torch.cuda.empty_cache()
    n = tuple(map(_build.launches, COUNTED))
    launches = dict(zip(KERNELS, n))
    if not dropout_check(11, "trainer", dropout_counts(_build), 2 * n_steps):
        raise AssertionError("trainer dropout launch counts differ")
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
    report.update(rates=rates, launches=launches)
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
    report["remat"], report["bare_samples_per_s"] = {}, {}
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
            _build.reset_launches()
            m = step(state, ds.hr_device(), ds.stats, idx, c.seed, eps=eps)
            torch.cuda.synchronize()
            torch.backends.cudnn.deterministic = False
            counts = tuple(map(_build.launches, COUNTED))
            drop_ok = dropout_check(11, f"trainer_{mode}_{'remat' if remat else 'no_remat'}",
                                    dropout_counts(_build), 1, remat=remat)
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
            seen[remat] = {"loss": m["train_loss"].item(), "grads": grads, "dropout_ok": drop_ok,
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
        grad_rel, worst = worst_grad(rem["grads"], plain["grads"])
        ok = (loss_rel <= REMAT_TOL and grad_rel <= REMAT_TOL and rem["copies"] == 0
              and plain["copies"] == 0 and all(seen[r]["launches"] == want[r] for r in seen)
              and all(seen[r]["dropout_ok"] for r in seen))
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
            name: {k: v for k, v in r.items() if k not in ("grads", "dropout_ok")}
            for name, r in (("off", plain), ("on", rem))}}
        bare = 1e3 * BATCH / plain["ms_per_step"]
        report["bare_samples_per_s"][mode] = bare
        log(f"[11] trainer {mode}: {rates[mode][-1]:.2f} samples/s in epoch {TRAINER_EPOCHS} "
            f"(StepTimer, CUDA-synced, metrics fetched every step; epoch 1 "
            f"{rates[mode][0]:.2f}), the bare step without remat above {bare:.2f} samples/s: "
            f"{rates[mode][-1] / bare - 1:+.1%} ({card})")
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
    from probunet_torch.ops import _build
    from probunet_torch.ops import attention as K2
    from probunet_torch.ops import gn_silu as K1
    from probunet_torch.ops.norm import num_groups_for
    from probunet_torch.serve import downscale
    from probunet_torch.train.checkpoint import save_checkpoint
    from probunet_torch.train.loop import build_edm_model, init_edm_state, train_edm
    from probunet_torch.train.state import TrainState, create_train_state, make_optimizer
    from probunet_torch.train.steps import make_edm_sample_fn, make_edm_train_step
    from probunet_torch.utils.device import full_fp32

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

    with full_fp32(), torch.inference_mode():
        got = card_model(x1.to(dev), sig1.to(dev), condition_img=cond1.to(dev)).cpu()
        ref = cpu_model(x1, sig1, condition_img=cond1)
    denoiser_rel = max_rel(got, ref)
    noise = torch.randn(2, RES, RES, 3, generator=g)
    idx = torch.tensor([3])
    t0 = time.perf_counter()
    got = make_edm_sample_fn(card_model, 4, cfg.standardization, 2, EDM_CHAIN_STEPS)(
        ds.hr_device(), ds.stats, idx.to(dev), noise=noise)[0].cpu()
    ref = make_edm_sample_fn(cpu_model, 4, cfg.standardization, 2, EDM_CHAIN_STEPS)(
        ds_cpu.hr_device(), ds_cpu.stats, idx, noise=noise)[0]
    chain_rel = {var: max_rel(got[..., i], ref[..., i]) for i, var in enumerate(cfg.variables)}
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
    grad_rel, worst = worst_grad(g_c, g_r, "")
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
        _build.reset_launches()
        t0 = time.perf_counter()
        path = downscale(c, ckpt, os.path.join(WORK, f"edm_{name}.nc"), dataset=sds,
                         num_samples=sk, batch_size=sb, device=dev)
        wall = time.perf_counter() - t0
        n = tuple(map(_build.launches, COUNTED))
        want = (passes * K1_PER_BATCH, passes * K2_PER_BATCH, 0, 0)
        mods = {k: _build.launches("gn_silu", k) for k in K1_MOD_PER_BATCH}
        want_mods = {k: passes * v for k, v in K1_MOD_PER_BATCH.items()}
        serve_n += n[:3]
        with NetCDFFile(path) as f:
            fields = {var: f.read_var(var) for var in cfg.variables}
        spread = {var: float(a.std(axis=1).mean()) for var, a in fields.items()}
        ok = n == want and mods == want_mods and all(
            a.shape == (sb, sk, RES, RES) and np.isfinite(a).all()
            for a in fields.values()) and min(spread.values()) > 0
        report["serve"][name] = {"downscale_wall_s": wall, "launches": n[:3], "copies": n[3],
                                 "k1_by_mod": mods}
        dtype = torch.bfloat16 if c.compute_dtype == "bfloat16" else torch.float32
        m = build_edm_model(c, device="meta").to_empty(device=dev).eval()
        m.load_state_dict(card_model.state_dict())
        rate = ""
        if name == "fast":   # the strict sampler's rate is the cell edm_mc128.serve_b2_k4's
            # the sampler alone on one batch, data on the card, no file I/O
            fn = make_edm_sample_fn(m, 4, c.standardization, sk, EDM_STEPS, compute_dtype=dtype)
            e = torch.randn(sk * sb, RES, RES, 3, device=dev, generator=gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn(sds.hr_device(), sds.stats, torch.arange(sb, device=dev), noise=e)
            torch.cuda.synchronize()
            per = time.perf_counter() - t1
            report["serve"][name].update(ms_per_batch=per * 1e3, inputs_per_s=sb / per,
                                         members_per_s=sb * sk / per)
            rate = (f"; the sampler alone {per * 1e3:.1f} ms per batch: {sb / per:.3f} "
                    f"inputs/s, {sb * sk / per:.3f} members/s")
            del fn
        log(f"[12] EDM downscale {name} (b{sb}, K={sk}, {EDM_STEPS} steps): {wall:.2f} s for one "
            f"batch (restore and netCDF output included); launches K1 {n[0]}, K2 {n[1]}, K3 "
            f"{n[2]}, q/k/v copies {n[3]} (expected {want}); K1 by modulation {mods} (expected "
            f"{want_mods}); members finite, spread "
            f"{', '.join(f'{v} {s:.4g}' for v, s in spread.items())}{rate} ({card}) "
            f"{'ok' if ok else 'FAIL'}")
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
    del m
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
        _build.reset_launches()
        t0 = time.perf_counter()
        ms += [step(state, ds.hr_device(), ds.stats, fixed_idx, c.seed, sigma=sigma, noise=noise)
               for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        per = (time.perf_counter() - t0) / TRAIN_STEPS
        n = tuple(map(_build.launches, COUNTED))
        train_n += n[:3]
        want = (TRAIN_STEPS * K1_PER_BATCH, TRAIN_STEPS * K2_PER_BATCH,
                TRAIN_STEPS * K3_PER_STEP, 0)
        drop_ok = dropout_check(12, f"edm_train_{name}", dropout_counts(_build), TRAIN_STEPS)
        losses = [m_["train_loss"].item() for m_ in ms]
        norms = [m_["grad_norm"].item() for m_ in ms]
        peak = torch.cuda.max_memory_allocated() / 2**30
        ok = (n == want and drop_ok and all(math.isfinite(v) for v in losses + norms)
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
    _build.reset_launches()
    t0 = time.perf_counter()
    res = train_edm(base, make_plots=False)   # on the card: its default device
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = tuple(map(_build.launches, COUNTED))
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
    return {"launches": {"serve": dict(zip(KERNELS, serve_n.tolist())),
                         "train": dict(zip(KERNELS, train_n.tolist())),
                         "trainer": dict(zip(KERNELS, trainer_n.tolist()))},
            "k1_err": k1_err, "k2_err": k2_err, "k3_rel": k3_rel, "report": report}


def baseline_phase(torch, dev, card, ds, ds_cpu, gen, mark):
    """Phase 13: the baselines (see the module docstring). Returns their K1
    launch counts by path, K1's worst errors and its times at the
    deterministic U-Net's sites, and the report."""
    import numpy as np

    from probunet_torch.config import Config
    from probunet_torch.data.dataset import ClimexDataset
    from probunet_torch.data.netcdf import NetCDFFile
    from probunet_torch.data.transforms import make_pair, time_features
    from probunet_torch.models.baselines import bcsd
    from probunet_torch.models.unet import build_unet_plan, gn_silu_sites
    from probunet_torch.ops import _build
    from probunet_torch.ops import gn_silu as K1
    from probunet_torch.ops.norm import group_stats, num_groups_for
    from probunet_torch.serve import downscale
    from probunet_torch.train.loop import (build_baseline_model, build_probunet,
                                           init_probunet_state, run_bcsd, train_baseline)
    from probunet_torch.train.state import create_train_state, make_optimizer
    from probunet_torch.train.steps import (make_deterministic_eval_step,
                                            make_deterministic_train_step, make_sample_fn)
    from probunet_torch.utils.device import full_fp32

    cfg = Config(ds_model="deterministic_unet", coords=(0, RES, 0, RES), resolution=(RES, RES),
                 standardization="pertimestep", batch_size=BATCH, timetransform="cyclic")
    report = {"card": card}

    # ---- card against CPU, strict fp32, the same filled weights ----------------------
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(21)
    x1, y1 = (torch.randn(1, RES, RES, 3, generator=g) for _ in range(2))
    idx1 = torch.tensor([5])
    ts1 = ds_cpu.timestamps_device()[idx1]
    fwd_rel, nparams = {}, {}
    for tt in ("id", "cyclic"):
        c0 = cfg.replace(timetransform=tt, dropout=0.0)
        card_m = build_baseline_model(c0, device="meta").to_empty(device=dev).eval()
        fill_weights(torch, card_m, seed=21)
        cpu_m = build_baseline_model(c0, device="meta").to_empty(device="cpu").eval()
        cpu_m.load_state_dict(card_m.state_dict())
        nparams[tt] = sum(p.numel() for p in card_m.parameters())
        labels = time_features(ts1, tt)
        with full_fp32(), torch.inference_mode():
            got = card_m(x1.to(dev), class_labels=labels.to(dev)).cpu()
            ref = cpu_m(x1, class_labels=labels)
        fwd_rel[tt] = max_rel(got, ref)
    xb = torch.randn(BATCH, RES, RES, 3, device=dev, generator=gen)
    gn_sites, attn_sites = census(torch, card_m, lambda: card_m(
        xb, class_labels=time_features(ds.timestamps_device()[:BATCH], "cyclic")))
    plan_sites = gn_silu_sites(*build_unet_plan((RES, RES), 3, cfg.baseline_channels,
                                                cfg.channel_mult, cfg.num_blocks, (), False),
                               (RES, RES))
    log(f"[13] deterministic U-Net: {RES}x{RES}, width {cfg.baseline_channels}, "
        f"{nparams['id']:,} parameters ({nparams['cyclic']:,} with cyclic labels); K1 sites per "
        f"forward {len(gn_sites)}, attention blocks {len(attn_sites)}")
    if (nparams["id"], nparams["cyclic"]) != (BASELINE_PARAMS, BASELINE_PARAMS + 512) \
            or sorted(gn_sites) != sorted(plan_sites) or len(gn_sites) != K1_PER_BATCH \
            or attn_sites:
        raise AssertionError("deterministic U-Net: unexpected parameter count or kernel sites")
    # one training step, cyclic labels (map_label live), b=1, dropout 0
    res = {}
    for where, m, d in (("card", card_m, ds), ("cpu", cpu_m, ds_cpu)):
        state = create_train_state(m, make_optimizer(cfg.lr, cfg.weight_decay))
        i = idx1.to(d.device)
        metrics = make_deterministic_train_step(m, 4, cfg.standardization,
                                                timetransform="cyclic")(
            state, d.hr_device(), d.stats, i, d.timestamps_device()[i], 0)
        grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters()}
        norm = math.sqrt(sum(float(v.double().square().sum()) for v in grads.values()))
        res[where] = (metrics["train_loss"].item(), norm, grads)
    (l_c, n_c, g_c), (l_r, n_r, g_r) = res["card"], res["cpu"]
    loss_rel, norm_rel = abs(l_c - l_r) / abs(l_r), abs(n_c - n_r) / n_r
    grad_rel, worst = worst_grad(g_c, g_r, "")
    del card_m, cpu_m, res, g_c, g_r
    # LinearCNN's forward; the conv-VAE's ELBO with a given z
    lin = {}
    for where in ("card", "cpu"):
        m = build_baseline_model(cfg.replace(ds_model="linearcnn"), device="meta")
        lin[where] = m.to_empty(device=dev if where == "card" else "cpu").eval()
    fill_weights(torch, lin["card"], seed=22)
    lin["cpu"].load_state_dict(lin["card"].state_dict())
    vae = {}
    for where in ("card", "cpu"):
        m = build_probunet(cfg.replace(ds_model="vae"), device="meta")
        vae[where] = m.to_empty(device=dev if where == "card" else "cpu").eval()
    fill_weights(torch, vae["card"], seed=23)
    vae["cpu"].load_state_dict(vae["card"].state_dict())
    z = torch.randn(1, cfg.latent_dim, generator=g)
    with full_fp32(), torch.inference_mode():
        lin_rel = max_rel(lin["card"](x1.to(dev)).cpu(), lin["cpu"](x1))
        e_c = [v.item() for v in vae["card"].elbo_with_z(x1.to(dev), y1.to(dev), z.to(dev))]
        e_r = [v.item() for v in vae["cpu"].elbo_with_z(x1, y1, z)]
    elbo_rel = max(abs(a - b) / abs(b) for a, b in zip(e_c, e_r))
    # BCSD: the function, and run_bcsd over in-memory splits whose days of
    # the year overlap (train days 0-23, val 8-31, test 0-7), twice on the card
    ts_np, hr_np = ds.timestamps_np, ds.hr_np
    bc, bcpu = {}, {}
    for where, device, out in (("card", dev, bc), ("cpu", "cpu", bcpu)):
        splits = {"train": slice(0, 24), "val": slice(8, 32), "test": slice(0, 8)}
        datasets = {k: ClimexDataset(hr=hr_np[s], timestamps=ts_np[s], device=device)
                    for k, s in splits.items()}
        hr_d = datasets["train"].hr_device()
        lri = make_pair(hr_d, 4, "none", None)["lrinterp"]
        doy = torch.from_numpy(datasets["train"].dayofyear).to(device)
        out["fn"] = bcsd(hr_d, lri, lri, doy, doy).cpu()
        out["run"] = run_bcsd(cfg, datasets, chunk=7, device=device)
        if where == "card":
            out["again"] = run_bcsd(cfg, datasets, chunk=7, device=device)
    bcsd_rel = max(max_rel(bc["fn"], bcpu["fn"]), *(
        max_rel(torch.from_numpy(bc["run"][s]["preds"]), torch.from_numpy(bcpu["run"][s]["preds"]))
        for s in ("val", "test")))
    bcsd_same = all(np.array_equal(bc["run"][s]["preds"], bc["again"][s]["preds"])
                    for s in ("val", "test"))
    ok = (max(fwd_rel.values()) <= PATH_TOL and loss_rel <= STEP_LOSS_TOL
          and norm_rel <= STEP_LOSS_TOL and grad_rel <= STEP_GRAD_TOL and lin_rel <= PATH_TOL
          and elbo_rel <= STEP_LOSS_TOL and bcsd_rel <= BCSD_TOL and bcsd_same
          and float(bc["fn"].abs().max()) > 0)
    log(f"[13] card vs CPU, strict fp32 ({time.perf_counter() - t0:.1f} s): deterministic U-Net "
        f"forward (b=1) max abs err / max |ref| id {fwd_rel['id']:.3e}, cyclic "
        f"{fwd_rel['cyclic']:.3e}, LinearCNN {lin_rel:.3e} (tol {PATH_TOL}); one deterministic "
        f"step (b=1, dropout 0, cyclic): loss {l_c:.6g} vs {l_r:.6g}, rel err {loss_rel:.3e}, "
        f"grad norm rel err {norm_rel:.3e} (tol {STEP_LOSS_TOL}), worst gradient max|err| / "
        f"max|g| {grad_rel:.3e} ({worst}; tol {STEP_GRAD_TOL}); conv-VAE ELBO with a given z "
        f"{e_c[0]:.6g} vs {e_r[0]:.6g}, worst rel err of (total, recon, kl) {elbo_rel:.3e} (tol "
        f"{STEP_LOSS_TOL}); bcsd and run_bcsd (chunk 7, padded tail) preds max abs err / max "
        f"|ref| {bcsd_rel:.3e} (tol {BCSD_TOL}), two card runs bit-equal {bcsd_same} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the baselines on the card disagree with the plain path")
    report["card_vs_cpu"] = {"forward_rel": fwd_rel, "linearcnn_rel": lin_rel,
                             "step_loss_rel": loss_rel, "step_grad_norm_rel": norm_rel,
                             "step_grad_rel": grad_rel, "vae_elbo_rel": elbo_rel,
                             "bcsd_rel": bcsd_rel, "bcsd_bit_equal": bcsd_same}
    del lin, vae, bc, bcpu
    mark(13)

    # ---- K1 against its plain version at every site, b8 ---------------------------------
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k1_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = GN_TOL[str(dtype).split(".")[1]]
        worst = 0.0
        for h, w, c in sorted(set(gn_sites)):
            gr = num_groups_for(c)
            p = K1.plan(BATCH, h, w, c, gr, dtype.itemsize, num_sms)
            x = (torch.randn(BATCH, h, w, c, device=dev, generator=gen) + 0.5).to(dtype)
            gamma = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
            beta = 0.1 * torch.randn(c, device=dev, generator=gen)
            with torch.inference_mode():
                out, mean, rstd = K1.gn_silu(x, gamma, beta, gr, return_stats=True)
                ref = K1._plain_gn_silu(x, gamma, beta, gr)[0]
                rmean, rrstd = group_stats(x, gr)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            worst = max(worst, d.max().item())
            ok = (bool((d <= atol + rtol * ref.float().abs()).all()) and p.on_chip
                  and torch.allclose(mean, rmean, rtol=1e-5, atol=1e-5)
                  and torch.allclose(rstd, rrstd, rtol=1e-5, atol=1e-5))
            log(f"[13] K1 {str(dtype)[6:]:8s} {BATCH}x{h}x{w}x{c} G={gr} ({c // gr} channels per "
                f"group; cb {p.cb}, {c // p.cb} channel blocks, cluster {p.n}, {p.rows} "
                f"rows/block, {'on chip' if p.on_chip else 'streamed: NOT on chip'}): max abs "
                f"err {d.max().item():.3e} (atol {atol}, rtol {rtol:.3g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("K1 disagrees with its plain version, or a site of the "
                                     "deterministic U-Net is not planned on chip")
        k1_err[str(dtype)[6:]] = worst
    k1_t = {"fp32": time_k1(torch, gn_sites, torch.float32, dev, gen, 13),
            "bf16": time_k1(torch, gn_sites, torch.bfloat16, dev, gen, 13)}
    for name, tt_ in k1_t.items():
        log(f"[13] K1 per deterministic U-Net forward at b{BATCH} ({name}): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in tt_.items()))
    mark(13)

    # ---- the training path: 3 + 10 steps at b8, cyclic labels, dropout 0.1 ---------------
    fixed_idx = torch.arange(BATCH, device=dev)
    ts_b = ds.timestamps_device()[fixed_idx]
    train_n, eval_n = np.zeros(3, np.int64), np.zeros(3, np.int64)
    report["train"] = {}
    for name, mc in (("strict", cfg), ("fast", cfg.replace(compute_dtype="bfloat16",
                                                           opt_state_dtype="bfloat16"))):
        c = mc.replace(dropout=0.1)
        dtype = torch.bfloat16 if c.compute_dtype == "bfloat16" else torch.float32
        tx = make_optimizer(c.lr, c.weight_decay, c.accum, c.optimizer, None, c.opt_state_dtype)
        state = init_probunet_state(c, build_baseline_model(c, device="meta"), tx, dev)
        step = make_deterministic_train_step(state.model, c.lowres_scale, c.standardization,
                                             dtype, timetransform=c.timetransform)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = [step(state, ds.hr_device(), ds.stats, fixed_idx, ts_b, c.seed)
              for _ in range(WARMUP_STEPS)]
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        ms += [step(state, ds.hr_device(), ds.stats, fixed_idx, ts_b, c.seed)
               for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        per = (time.perf_counter() - t0) / TRAIN_STEPS
        n = tuple(map(_build.launches, COUNTED))
        train_n += n[:3]
        drop_ok = dropout_check(13, f"baseline_train_{name}", dropout_counts(_build),
                                TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        _build.reset_launches()
        ev = make_deterministic_eval_step(state.model, c.lowres_scale, c.standardization,
                                          c.variables, timetransform=c.timetransform)(
            ds.hr_device(), ds.stats, fixed_idx, ts_b)
        torch.cuda.synchronize()
        ne = tuple(map(_build.launches, COUNTED))
        eval_n += ne[:3]
        losses = [m_["train_loss"].item() for m_ in ms]
        want = (TRAIN_STEPS * K1_PER_BATCH, 0, 0, 0)
        ok = (n == want and ne == (K1_PER_BATCH, 0, 0, 0) and drop_ok
              and all(math.isfinite(v) for v in losses)
              and all(math.isfinite(v.item()) for v in ev.values()) and losses[-1] < losses[0])
        report["train"][name] = {"ms_per_step": per * 1e3, "samples_per_s": BATCH / per,
                                 "peak_gib": peak, "losses": losses}
        log(f"[13] deterministic train {name}: {WARMUP_STEPS} warm-up + {TRAIN_STEPS} steps at "
            f"b{BATCH}, {RES}x{RES}, cyclic labels, dropout 0.1, a fixed batch: {per * 1e3:.2f} ms "
            f"per step, {BATCH / per:.2f} samples/s over the {TRAIN_STEPS}; launches K1 {n[0]}, K2 "
            f"{n[1]}, K3 {n[2]}, copies {n[3]} (expected {want}); one eval batch K1 {ne[0]}, K2 "
            f"{ne[1]} (expected {K1_PER_BATCH}, 0); peak device memory {peak:.2f} GiB; loss "
            f"{[round(v, 4) for v in losses]} ({card}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"deterministic training {name}: launches {n} / {ne}, or the "
                                 f"loss did not fall")
        profile(torch, lambda: step(state, ds.hr_device(), ds.stats, fixed_idx, ts_b, c.seed),
                f"deterministic train step {name}", "one step", phase=13, top=12)
        del state, step, ms
        torch.cuda.empty_cache()
    mark(13)

    # ---- train_baseline through its entry, then serving the conv-VAE ----------------------
    base = Config(datadir=os.path.join(WORK, "trainer_data"), years_train=(2000, 2003),
                  years_val=(2003, 2004), years_test=(2004, 2005), coords=(0, RES, 0, RES),
                  resolution=(RES, RES), standardization="pertimestep", batch_size=BATCH,
                  num_epochs=TRAINER_EPOCHS, log_every=1, num_samples=2, timetransform="cyclic")
    steps_per_epoch = 3 * TRAINER_DAYS // BATCH
    n_steps = TRAINER_EPOCHS * steps_per_epoch
    det_step = {"train_loss", "step", "time", "samples_per_sec",
                *(f"train_loss_var{i}" for i in range(3))}
    det_epoch = {"epoch", "epoch_train_loss", "step", "time", *(f"eval_{v}" for v in VARS)}
    want_keys = {
        "deterministic_unet": ([det_step] * steps_per_epoch + [det_epoch]) * TRAINER_EPOCHS
        + [{"step", "time", *(f"mae_{v}" for v in VARS)}],
        "vae": ([STEP_KEYS] * steps_per_epoch + [EPOCH_KEYS]) * TRAINER_EPOCHS}
    want_keys["linearcnn"] = want_keys["deterministic_unet"]
    # the U-Net per run: each step, one val batch per epoch, one batch of the final MAE
    want_gn = {"deterministic_unet": (n_steps + TRAINER_EPOCHS + 1) * K1_PER_BATCH}
    trainer_n = np.zeros(3, np.int64)
    report["trainer"] = {}
    for ds_model in ("deterministic_unet", "linearcnn", "vae", "bcsd"):
        c = base.replace(ds_model=ds_model, plotdir=os.path.join(WORK, "bl", ds_model, "plots"),
                         checkpoints_dir=os.path.join(WORK, "bl", ds_model, "ckpt"))
        _build.reset_launches()
        t0 = time.perf_counter()
        res = train_baseline(c, make_plots=False)   # on the card: its default device
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = tuple(map(_build.launches, COUNTED))
        trainer_n += n[:3]
        want_n = (want_gn.get(ds_model, 0), 0, 0, 0)
        if ds_model == "bcsd":
            mae = {f"{s}_{v}": x for s in ("val", "test") for v, x in res[s]["mae"].items()}
            ok = set(res) == {"val", "test"} and res["test"]["preds"].shape == (
                TRAINER_DAYS, RES, RES, 3) and all(math.isfinite(x) for x in mae.values())
            seen = "val and test"
        else:
            fname = "metrics.jsonl" if ds_model == "vae" else "metrics_baseline.jsonl"
            with open(os.path.join(c.plotdir, fname)) as f:
                recs = [json.loads(line) for line in f]
            kinds = [set(r) for r in recs]
            seen = "the JAX loop's keys" if kinds == want_keys[ds_model] else [
                sorted(k) for k in kinds]
            finite = all(math.isfinite(v) for r in recs for v in r.values())
            mae = res.get("mae", {})
            ckpt = os.path.join(c.checkpoints_dir, ds_model, "state", "state.pt")
            ok = (kinds == want_keys[ds_model] and finite and res["state"].step == n_steps
                  and os.path.isfile(ckpt) and all(math.isfinite(x) for x in mae.values()))
        ok &= n == want_n
        report["trainer"][ds_model] = {"wall_s": wall, "launches": n[:3], "mae": mae}
        log(f"[13] train_baseline {ds_model}: {wall:.2f} s ({TRAINER_EPOCHS} epochs of "
            f"{steps_per_epoch} steps, eval, init, data and checkpoints included); MAE "
            f"{', '.join(f'{k} {v:.4g}' for k, v in mae.items()) or 'n/a'}; launches K1 {n[0]}, "
            f"K2 {n[1]}, K3 {n[2]} (expected {want_n}); records: {seen} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"train_baseline {ds_model}: launches, records, checkpoint or "
                                 f"MAE differ")
        del res
        torch.cuda.empty_cache()
    vae_cfg = base.replace(ds_model="vae")
    vae_ckpt = os.path.join(WORK, "bl", "vae", "ckpt", "vae")
    t0 = time.perf_counter()
    out = downscale(vae_cfg, vae_ckpt, os.path.join(WORK, "vae_serve.nc"), years=[2004],
                    num_samples=MEMBERS, batch_size=BATCH)
    wall = time.perf_counter() - t0
    with NetCDFFile(out) as f:
        fields = {var: f.read_var(var) for var in VARS}
    spread = {var: float(a.std(axis=1).mean()) for var, a in fields.items()}
    ok = all(a.shape == (TRAINER_DAYS, MEMBERS, RES, RES) and np.isfinite(a).all()
             for a in fields.values()) and min(spread.values()) > 0
    # the sampler alone, data on the card, no file I/O
    m = build_probunet(vae_cfg, device="meta").to_empty(device=dev).eval()
    from probunet_torch.train.checkpoint import restore_checkpoint
    from probunet_torch.train.state import TrainState
    restore_checkpoint(vae_ckpt, TrainState(m, None))
    sds = ClimexDataset(vae_cfg.datadir, years=[2004], coords=vae_cfg.coords,
                        standardization=vae_cfg.standardization, device=dev)
    fn = make_sample_fn(m, 4, vae_cfg.standardization, MEMBERS)
    with full_fp32():
        per = cuda_ms(torch, lambda: fn(sds.hr_device(), sds.stats, fixed_idx), reps=10,
                      warmup=2) / 1e3
    report["serve"] = {"downscale_wall_s": wall, "ms_per_batch": per * 1e3,
                       "inputs_per_s": BATCH / per, "members_per_s": BATCH * MEMBERS / per}
    log(f"[13] downscale vae (b{BATCH}, K={MEMBERS}, num_filters {vae_cfg.num_filters}) from "
        f"the trainer's checkpoint: {wall:.2f} s for one batch (restore and netCDF output "
        f"included); members finite, spread {', '.join(f'{v} {s:.4g}' for v, s in spread.items())}"
        f"; the sampler alone {per * 1e3:.2f} ms per batch (CUDA events): {BATCH / per:.1f} "
        f"inputs/s, {BATCH * MEMBERS / per:.1f} members/s ({card}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("conv-VAE serving: bad output")
    shutil.rmtree(os.path.join(WORK, "bl"), ignore_errors=True)
    del m, fn, sds
    torch.cuda.empty_cache()
    mark(13)
    return {"launches": {"train": dict(zip(KERNELS, train_n.tolist())),
                         "eval": dict(zip(KERNELS, eval_n.tolist())),
                         "trainer": dict(zip(KERNELS, trainer_n.tolist()))},
            "k1_err": k1_err, "k1_t": k1_t, "report": report}


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mp_configs():
    """Phase 14's configs, as this process and the rank children build
    them: (training, serving fast, serving strict, BCSD)."""
    from probunet_torch.config import Config

    root = os.path.join(WORK, "p14")
    data = os.path.join(WORK, "trainer_data")   # phase 11's files
    y0 = 2000
    # pertimestep, as phase 11: half the synthetic pr values are 0, so some
    # pixels' perpixel std over 16 days is ~0 and their standardized values blow up
    train = Config(datadir=data, years_train=(y0, y0 + MP_TRAIN_YEARS), years_val=(2003, 2004),
                   years_test=(2004, 2005), coords=(0, RES, 0, RES), resolution=(RES, RES),
                   standardization="pertimestep", batch_size=BATCH, num_epochs=TRAINER_EPOCHS,
                   eval_crps=True, crps_samples=4, log_every=1, num_samples=2)
    # serving in both modes: fast (bf16) array-equal to one process, strict
    # (fp32) within MP_STRICT_SERVE_TOL
    strict = train.replace(datadir=os.path.join(WORK, "data"), years_test=(2000, 2001),
                           num_samples=MEMBERS)
    fast = strict.replace(compute_dtype="bfloat16", fast_attention=True)
    # BCSD predicts by day of year: val and test on days the train years cover
    bcsd = train.replace(years_val=(y0, y0 + MP_TRAIN_YEARS), years_test=(y0 + 1, y0 + 2))
    return root, train, fast, strict, bcsd


def mp_rank(spec_path):
    """One rank of phase 14 (``python3 chip_smoke.py --mp-rank <spec>``):
    joins the gloo process group from the environment on cuda:0, runs the
    trainer (uninterrupted; a resume chain stopped after each of
    MP_GRAD_STEPS, then to the end; once with the planted fault of
    ``local_dropout``), serving in both modes and BCSD,
    and writes what it measured to ``rank<r>.json`` beside the spec."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from probunet_torch.data.dataset import ClimexDataset
    from probunet_torch.ops import _build
    from probunet_torch.parallel.multihost import maybe_initialize_distributed, process_info
    from probunet_torch.serve import downscale
    from probunet_torch.train.engine import load_datasets
    from probunet_torch.train.loop import run_bcsd, train_probunet

    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device("cuda", 0)
    maybe_initialize_distributed(dev, "gloo")
    rank = process_info()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True   # the resume is compared bit for bit
    root, cfg, serve_cfg, strict_cfg, bcsd_cfg = mp_configs()
    out = {"rank": rank}

    def train(tag, **kw):
        c = cfg.replace(plotdir=os.path.join(root, tag, "plots"),
                        checkpoints_dir=os.path.join(root, tag, "ckpt"), **kw)
        _build.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_probunet(c, make_plots=False, device=dev)
        torch.cuda.synchronize()
        out[tag] = {"wall_s": time.perf_counter() - t0, "steps": res["state"].step,
                    "launches": {k: _build.launches(k) for k in KERNELS},
                    "dropout": dropout_counts(_build),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del res
        torch.cuda.empty_cache()

    train("mp_full")
    for t in MP_GRAD_STEPS:   # a resume chain, one step a run
        train(f"mp_part{t}", max_steps=t,
              resume=os.path.join(root, f"mp_part{t - 1}", "ckpt", "probunet") if t > 1 else "")
    train("mp_resumed", resume=os.path.join(root, f"mp_part{MP_GRAD_STEPS[-1]}", "ckpt",
                                            "probunet"))
    with local_dropout():
        train("mp_fault", eval_crps=False)

    full = ClimexDataset(serve_cfg.datadir, years=[2000], coords=serve_cfg.coords,
                         standardization=serve_cfg.standardization, device=dev)
    days = ClimexDataset(hr=full.hr_np[:MP_SERVE_DAYS], timestamps=full.timestamps_np[:MP_SERVE_DAYS],
                         lat=full.lat, lon=full.lon, standardization=serve_cfg.standardization,
                         lowres_scale=serve_cfg.lowres_scale, device=dev)
    for tag, c in (("serve", serve_cfg), ("serve_strict", strict_cfg)):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        downscale(c, spec["serve_checkpoint"], os.path.join(root, f"mp_{tag}.nc"),
                  dataset=days, device=dev)
        out[tag] = {"wall_s": time.perf_counter() - t0,
                    "launches": {k: _build.launches(k) for k in KERNELS}}

    res = run_bcsd(bcsd_cfg, load_datasets(bcsd_cfg, dev), device=dev)
    if rank == 0:
        np.savez(os.path.join(root, "mp_bcsd.npz"), **{s: r["preds"] for s, r in res.items()})
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


@contextlib.contextmanager
def local_dropout():
    """A planted fault for phase 14's negative control: every dropout mask
    drawn over the rank's local rows, not as its rows of the global batch's
    mask (``shard`` ignored), so the ranks train another model than one
    process does. Patches ``models.unet`` in this process only."""
    import probunet_torch.models.unet as U

    plain = U.dropout
    U.dropout = lambda x, rate, training, generator=None, shard=(0, 1): plain(
        x, rate, training, generator)
    try:
        yield
    finally:
        U.dropout = plain


def global_draw_cost(torch, dev, cfg, card):
    """The cost of drawing dropout masks for the global batch: one training
    forward at a rank's rows records every dropout draw's shape, then the
    draws of one step are timed (CUDA events, 20 after 3) at a rank's rows
    alone and as rank 0 of MP_RANKS (MP_RANKS times the numbers)."""
    import probunet_torch.models.unet as U
    from probunet_torch.models.layers import rand_rows
    from probunet_torch.train.loop import build_probunet

    model = build_probunet(cfg, device="meta").to_empty(device=dev).train()
    shapes, plain = [], U.dropout

    def record(x, rate, training, generator=None, shard=(0, 1)):
        b, c, h, w = x.shape
        shapes.append((b, h, w, c))
        return plain(x, rate, training, generator, shard)

    U.dropout = record
    try:
        with torch.no_grad():
            model.unet(torch.zeros(BATCH // MP_RANKS, RES, RES, 3, device=dev))
    finally:
        U.dropout = plain
    del model
    g = torch.Generator(dev).manual_seed(0)
    out = {}
    for world in (1, MP_RANKS):
        out[f"world{world}_ms"] = cuda_ms(torch, lambda: [rand_rows(sh, g, dev, (0, world))
                                                         for sh in shapes])
    elems = sum(math.prod(sh) for sh in shapes)
    log(f"[14] dropout draws of one step at {BATCH // MP_RANKS} rows ({len(shapes)} masks, "
        f"{elems:,} uniforms): {out['world1_ms']:.3f} ms alone, {out[f'world{MP_RANKS}_ms']:.3f} "
        f"ms as rows of the {BATCH}-row global draw (CUDA events, {card})")
    return out


def multiprocess_phase(torch, dev, card, gn_sites, mark):
    """Phase 14 (see the module docstring). Returns the launch counts of
    its paths and its report."""
    import numpy as np
    import torch.distributed as dist

    from probunet_torch.data.dataset import ClimexDataset
    from probunet_torch.data.netcdf import NetCDFFile
    from probunet_torch.data.pipeline import compute_lr_stats_streaming
    from probunet_torch.ops import _build
    from probunet_torch.ops import gn_silu as K1
    from probunet_torch.ops.norm import num_groups_for
    from probunet_torch.parallel import mesh
    from probunet_torch.parallel.multihost import (allgather_counts, allreduce_sum,
                                                   global_perpixel_stats)
    from probunet_torch.serve import downscale
    from probunet_torch.train.engine import load_datasets
    from probunet_torch.train.loop import (build_probunet, init_probunet_state, run_bcsd,
                                           train_probunet)
    from probunet_torch.train.state import make_optimizer
    from probunet_torch.train.steps import make_probunet_train_step

    root, cfg, serve_cfg, strict_cfg, bcsd_cfg = mp_configs()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    report = {"card": card}
    launches = {}
    rows = BATCH // MP_RANKS

    # ---- K1's plan at a rank's rows ---------------------------------------------------
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for h, w, c in sorted(set(gn_sites)):
        p = K1.plan(rows, h, w, c, num_groups_for(c), 4, num_sms)
        log(f"[14] K1 plan at {rows} rows, site {h}x{w}x{c}: {p._asdict()}")
        if not p.on_chip:
            raise AssertionError(f"K1 site {(h, w, c)} at {rows} rows planned off chip")
    log(f"[14] K1: all {len(set(gn_sites))} distinct sites planned on chip at {rows} rows (fp32)")

    # ---- one rank over NCCL --------------------------------------------------------------
    torch.backends.cudnn.deterministic = True
    mesh.init_process_group({"init_method": f"tcp://localhost:{_free_port()}", "world_size": 1,
                             "rank": 0}, dev)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, expected nccl")
        x = 273.0 + 1e-9 * np.arange(4096.0)
        lossy = not np.array_equal(x.astype(np.float32).astype(np.float64), x)
        (s1,) = allreduce_sum(x)
        counts = allgather_counts(16_777_217)
        ok = lossy and np.array_equal(s1, x) and counts.tolist() == [16_777_217]
        log(f"[14] NCCL, 1 rank: float64 allreduce_sum bit-exact on values float32 rounds: "
            f"{np.array_equal(s1, x)}; allgather_counts(2**24 + 1) = {counts.tolist()} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("a float64 collective lost bits over NCCL")
        hr_np = ClimexDataset(cfg.datadir, years=[2000, 2001], coords=cfg.coords,
                              device="cpu").hr_np
        got = global_perpixel_stats(hr_np, cfg.lowres_scale, dev)
        want = compute_lr_stats_streaming(hr_np, cfg.lowres_scale, "perpixel", device="cpu")
        rel = [float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-3)))
               for g, w in zip(got, want)]
        log(f"[14] NCCL, 1 rank: global_perpixel_stats (pooled on the card, moments summed in "
            f"float64 over NCCL) against the CPU's streaming statistics: mean {rel[0]:.3e}, std "
            f"{rel[1]:.3e} max rel diff (tol 2e-4: each side pools in fp32) "
            f"{'ok' if max(rel) <= 2e-4 else 'FAIL'}")
        if max(rel) > 2e-4:
            raise AssertionError("global_perpixel_stats on the card differ from the CPU's")
        ds = ClimexDataset(serve_cfg.datadir, years=[2000], coords=serve_cfg.coords,
                           standardization=serve_cfg.standardization, device=dev)
        runs = []
        for dp in (None, mesh.DataParallel()):
            state = init_probunet_state(cfg, build_probunet(cfg, device="meta"),
                                        make_optimizer(), device=dev)
            step = make_probunet_train_step(state.model, cfg.lowres_scale, cfg.standardization,
                                            dp=dp)
            _build.reset_launches()
            ms = [step(state, ds.hr_device(), ds.stats,
                       torch.arange(BATCH, device=dev) + BATCH * (i % 2), 11) for i in range(3)]
            ms = [{k: float(v) for k, v in m.items()} for m in ms]
            n = tuple(map(_build.launches, COUNTED))
            runs.append((ms, {k: v.clone() for k, v in state.model.state_dict().items()}, n))
            del state, step
        (m0, p0, _), (m1, p1, n1) = runs
        diff = max((a - b).abs().max().item() for a, b in zip(p0.values(), p1.values()))
        log(f"[14] NCCL, 1 rank: 3 steps at b{BATCH} through the flat all-reduce, losses "
            f"{[round(m['train_loss'], 3) for m in m1]}, gradient norms "
            f"{[round(m['grad_norm'], 3) for m in m1]}; against no process group: metrics "
            f"equal {m0 == m1}, parameters max abs diff {diff:.3e} (bit-equal required); "
            f"launches {n1[:3]}")
        if m0 != m1 or diff != 0 or tuple(n1[:3]) != (3 * K1_PER_BATCH, 3 * K2_PER_BATCH,
                                                       3 * K3_PER_STEP):
            raise AssertionError("the one-rank NCCL steps differ from the steps without a group")
        launches["nccl_steps"] = dict(zip(KERNELS, n1))
        del runs, p0, p1, ds
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    report["rng"] = global_draw_cost(torch, dev, cfg, card)
    mark(14)

    # ---- this process: the references --------------------------------------------------
    ref_dir = os.path.join(root, "ref")
    c = cfg.replace(plotdir=os.path.join(ref_dir, "plots"),
                    checkpoints_dir=os.path.join(ref_dir, "ckpt"), data_shards=MP_RANKS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_probunet(c, make_plots=False, device=dev)
    torch.cuda.synchronize()
    ref_wall, ref_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    del res
    # the same run stopped after each of MP_GRAD_STEPS: AdamW's first moments give
    # each step's gradient
    for t in MP_GRAD_STEPS:
        train_probunet(c.replace(plotdir=os.path.join(root, f"ref{t}", "plots"), max_steps=t,
                                 checkpoints_dir=os.path.join(root, f"ref{t}", "ckpt"),
                                 resume=os.path.join(root, f"ref{t - 1}", "ckpt", "probunet")
                                 if t > 1 else ""),
                       make_plots=False, device=dev)
    init = init_probunet_state(cfg, build_probunet(cfg, device="meta"), make_optimizer(),
                               device="cpu").model.state_dict()
    torch.cuda.empty_cache()
    ref_ckpt = os.path.join(ref_dir, "ckpt", "probunet")
    full = ClimexDataset(serve_cfg.datadir, years=[2000], coords=serve_cfg.coords,
                         standardization=serve_cfg.standardization, device=dev)
    days = ClimexDataset(hr=full.hr_np[:MP_SERVE_DAYS], timestamps=full.timestamps_np[:MP_SERVE_DAYS],
                         lat=full.lat, lon=full.lon, standardization=serve_cfg.standardization,
                         lowres_scale=serve_cfg.lowres_scale, device=dev)
    one_nc, serve_wall = {}, {}
    for tag, sc in (("serve", serve_cfg), ("serve_strict", strict_cfg)):
        one_nc[tag] = os.path.join(root, f"one_{tag}.nc")
        t0 = time.perf_counter()
        downscale(sc, ref_ckpt, one_nc[tag], dataset=days, device=dev)
        serve_wall[tag] = time.perf_counter() - t0
    bcsd_ref = run_bcsd(bcsd_cfg, load_datasets(bcsd_cfg, dev), device=dev)
    torch.backends.cudnn.deterministic = False
    del full, days
    torch.cuda.empty_cache()
    mark(14)

    # ---- two ranks on the card --------------------------------------------------------------
    spec = os.path.join(root, "spec.json")
    with open(spec, "w") as f:
        json.dump({"serve_checkpoint": ref_ckpt}, f)
    port = _free_port()
    procs = []
    for r in range(MP_RANKS):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env.update(COORDINATOR_ADDRESS=f"localhost:{port}", PROBUNET_NUM_PROCESSES=str(MP_RANKS),
                   PROBUNET_PROCESS_ID=str(r))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mp-rank",
                                       spec], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    mp_wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode:
            log(text[-6000:])
            raise AssertionError(f"rank {r} exited with {p.returncode}")
    ranks = []
    for r in range(MP_RANKS):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    log(f"[14] {MP_RANKS} ranks (child processes, gloo on cuda:0) ran 3 trainer runs, serving "
        f"and BCSD in {mp_wall:.1f} s (process start, init and data included)")

    def records(tag):
        with open(os.path.join(root, tag, "plots", "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    failed = []   # every check runs and logs; the phase raises at its end

    def check(ok, what):
        if not ok:
            failed.append(what)

    ref_recs, mp_recs = records("ref"), records("mp_full")
    n_steps = TRAINER_EPOCHS * (MP_TRAIN_YEARS * TRAINER_DAYS // BATCH)
    check([sorted(r) for r in mp_recs] == [sorted(r) for r in ref_recs],
          "the ranks' records differ in keys or count from one process's (rank 0 writes them)")
    worst = {}
    for key in ("train_loss", "recon_loss", "kl_div", "grad_norm", "val_loss"):
        a = np.asarray([r[key] for r in ref_recs if key in r])
        b = np.asarray([r[key] for r in mp_recs if key in r])
        log(f"[14] {key}: one process {a.tolist()}, 2 ranks {b.tolist()}")
        check(np.isfinite(a).all() and np.isfinite(b).all(), f"{key} not finite")
        worst[key] = float(np.max(np.abs(b - a) / np.abs(a)))
    step1 = abs(mp_recs[0]["train_loss"] - ref_recs[0]["train_loss"]) / abs(ref_recs[0]["train_loss"])
    mp_ckpt = os.path.join(root, "mp_full", "ckpt", "probunet")

    def load(tag, where="cpu"):
        return torch.load(os.path.join(root, tag, "ckpt", "probunet", "state", "state.pt"),
                          map_location=where, weights_only=True)

    ref_state, mp_state = load("ref"), load("mp_full")
    ref_p = ref_state["params"]

    def update_gap(params):
        """||update - update_1process|| / ||update_1process|| over every
        parameter, and the elements that moved more than lr apart."""
        num = den = 0.0
        moved = {}
        for k, p0 in init.items():
            if p0.is_floating_point():
                u_ref = ref_p[k].double() - p0.double()
                d = params[k].double() - p0.double() - u_ref
                num += d.square().sum().item()
                den += u_ref.square().sum().item()
                if (d.abs() > cfg.lr).any():
                    moved[k] = d.abs() > cfg.lr
        return math.sqrt(num / den), moved

    upd, moved = update_gap(mp_state["params"])
    total = sum(p.numel() for p in init.values() if p.is_floating_point())
    n_moved = sum(int(m.sum()) for m in moved.values())
    top = sorted(moved, key=lambda k: -int(moved[k].sum()))[:6]
    log(f"[14] parameter updates: {n_moved:,} of {total:,} elements moved more than lr = "
        f"{cfg.lr} apart, in {len(moved)} tensors (most: "
        + ", ".join(f"{k} {int(moved[k].sum()):,}" for k in top) + ")")
    if moved:   # why: each side's gradients of those elements at steps 1-3
        names = [n for n, _ in build_probunet(cfg, device="meta").named_parameters()]

        def grads(tags):
            """(steps, n) gradients of those elements and of every element of
            their tensors at the steps the checkpoints ``tags`` stopped at,
            from AdamW's first moments (m_t = b1 m_t-1 + (1 - b1) g_t)."""
            out, prev = ([], []), (0.0, 0.0)
            for tag in tags:
                st = load(tag, dev)["optimizer"]["inner"]["state"]
                ms = [torch.cat([st[i]["exp_avg"].double()[moved[k] if mask else ...].ravel()
                                 for i, k in enumerate(names) if k in moved])
                      for mask in (True, False)]
                for o, p, m in zip(out, prev, ms):
                    o.append((m - 0.9 * p) / 0.1)
                prev = ms
            return [torch.stack(o) for o in out]

        parts = []
        sides = zip(grads([f"ref{t}" for t in MP_GRAD_STEPS]),
                    grads([f"mp_part{t}" for t in MP_GRAD_STEPS]))
        for gr, gm in sides:   # those elements; every element of their tensors
            nz = (gr != 0) | (gm != 0)
            first = torch.where(nz.any(0), nz.int().argmax(0), len(gr))   # len(gr): none
            seen = first < len(gr)
            cols = torch.arange(gr.shape[1], device=dev)[seen]
            r, m = gr[first[seen], cols], gm[first[seen], cols]
            parts.append({"first_step": [float((first == t).double().mean())
                                         for t in range(len(gr) + 1)],
                          "g": r.abs().median().item(),
                          "gap": ((m - r).abs() / r.abs().clamp_min(1e-30)).median().item(),
                          "flip": float((torch.sign(m) != torch.sign(r)).double().mean())})
            del gr, gm, nz, first, r, m
        del sides
        mv, ev = parts
        log(f"[14] those elements' first step with a nonzero gradient on either side (AdamW "
            f"first moments after steps {MP_GRAD_STEPS}): "
            + ", ".join(f"{t} {a:.1%}" for t, a in zip([*MP_GRAD_STEPS, "later"], mv["first_step"]))
            + " (every element of their tensors: "
            + ", ".join(f"{t} {a:.1%}" for t, a in zip([*MP_GRAD_STEPS, "later"], ev["first_step"]))
            + f"); at that step median |g| {mv['g']:.3e} (every element {ev['g']:.3e}), the "
            f"sides apart by {mv['gap']:.3e} of |g| (median; every element {ev['gap']:.3e}), "
            f"opposite signs in {mv['flip']:.1%} (every element {ev['flip']:.1%})")
        report["moved_elements"] = {"count": n_moved, "moved": mv, "every": ev}
    # the negative control: the ranks drew local-shape dropout (local_dropout)
    fault_upd, _ = update_gap(load("mp_fault")["params"])
    fault_recs = records("mp_fault")
    fault_worst = max(abs(f - r) / abs(r) for k in ("train_loss", "val_loss")
                      for f, r in zip([x[k] for x in fault_recs if k in x],
                                      [x[k] for x in ref_recs if k in x]))
    log(f"[14] negative control, local-shape dropout planted in the ranks: parameter update "
        f"rel diff {fault_upd:.3e} (must exceed MP_PARAM_TOL {MP_PARAM_TOL}; the sound run "
        f"{upd:.3e}), worst loss rel diff {fault_worst:.3e} (MP_TRAJ_TOL {MP_TRAJ_TOL}) "
        f"{'ok' if fault_upd > MP_PARAM_TOL else 'FAIL'}")
    check(fault_upd > MP_PARAM_TOL, "a rank drawing local-shape dropout passes MP_PARAM_TOL")
    ok = (step1 <= MP_STEP1_TOL and max(worst.values()) <= MP_TRAJ_TOL and upd <= MP_PARAM_TOL
          and mp_state["step"] == n_steps)
    log(f"[14] 2 ranks against 1 process with data_shards=2 ({n_steps} steps, b{BATCH} global): "
        f"step-1 loss rel diff {step1:.3e} (tol {MP_STEP1_TOL}); worst rel diff over the run "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (tol {MP_TRAJ_TOL}); parameter update rel diff {upd:.3e} (tol {MP_PARAM_TOL}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, "two ranks differ from one process computing the same batches")
    files = sorted(os.path.relpath(os.path.join(d, f), mp_ckpt)
                   for d, _, fs in os.walk(mp_ckpt) for f in fs)
    log(f"[14] the ranks' checkpoint directory: {files}")
    check(files == [os.path.join("state", "state.pt")], f"checkpoint directory holds {files}")
    res_p = torch.load(os.path.join(root, "mp_resumed", "ckpt", "probunet", "state", "state.pt"),
                       weights_only=True)
    rdiff = max((res_p["params"][k] - v).abs().max().item() for k, v in mp_state["params"].items())
    log(f"[14] two-rank resume chain: stopped after steps {MP_GRAD_STEPS}, resumed to "
        f"{res_p['step']}: parameters max abs "
        f"diff {rdiff:.3e} against the uninterrupted two-rank run (bit-equal required) "
        f"{'ok' if rdiff == 0 and res_p['step'] == n_steps else 'FAIL'}")
    check(rdiff == 0 and res_p["step"] == n_steps,
          "the two-rank resume differs from the uninterrupted run")
    del ref_state, ref_p, mp_state, res_p, init

    per_step = (K1_PER_BATCH, K2_PER_BATCH, K3_PER_STEP)
    per_eval = (K1_PER_BATCH, K2_PER_BATCH, 0)
    n_evals = TRAINER_EPOCHS * 2     # one val and one CRPS batch per epoch
    want = {k: n_steps * s + n_evals * e for k, s, e in zip(KERNELS, per_step, per_eval)}
    for rk in ranks:
        got = {k: rk["mp_full"]["launches"][k] for k in want}
        log(f"[14] rank {rk['rank']} launches in its uninterrupted run: {got}, expected {want} "
            f"(per step {per_step}, per eval or CRPS batch {per_eval}) "
            f"{'ok' if got == want else 'FAIL'}")
        check(got == want, f"rank {rk['rank']}: launches {got}")
        check(dropout_check(14, f"multiprocess_rank{rk['rank']}", rk["mp_full"]["dropout"],
                            n_steps), f"rank {rk['rank']}: dropout {rk['mp_full']['dropout']}")
        launches[f"rank{rk['rank']}_trainer"] = rk["mp_full"]["launches"]
        launches[f"rank{rk['rank']}_serve"] = rk["serve"]["launches"]
        launches[f"rank{rk['rank']}_serve_strict"] = rk["serve_strict"]["launches"]

    def ms_per_step(recs):   # StepTimer (CUDA-synced) at epoch 2's last step
        steps = [r for r in recs if "train_loss" in r]
        return 1e3 * BATCH / steps[-1]["samples_per_sec"]

    for rk in ranks:
        log(f"[14] rank {rk['rank']}: peak device memory {rk['mp_full']['peak_gib']:.2f} GiB, "
            f"trainer wall {rk['mp_full']['wall_s']:.2f} s; one process (data_shards=2): peak "
            f"{ref_peak:.2f} GiB, wall {ref_wall:.2f} s ({card})")
    log(f"[14] ms per step (epoch {TRAINER_EPOCHS}, b{BATCH} global): 2 ranks sharing the card "
        f"over gloo {ms_per_step(mp_recs):.1f}, one process {ms_per_step(ref_recs):.1f}; the "
        f"ranks share one card and move gradients through the host: not a scaling figure ({card})")

    # ---- serving ----------------------------------------------------------------------------
    left = [f for f in os.listdir(root) if ".part" in f]
    serve_rel = {}
    for tag, mode in (("serve", "fast"), ("serve_strict", "strict")):
        with NetCDFFile(one_nc[tag]) as a, NetCDFFile(os.path.join(root, f"mp_{tag}.nc")) as b:
            rel, spread = {}, {}
            for v in VARS:
                fa, fb = a.read_var(v), b.read_var(v)
                d = np.abs(fa - fb)
                rel[v] = float(d.max() / np.abs(fa).max())
                # what a wrong draw moves a value by: the members' spread
                spread[v] = float(fa.std(axis=1).mean() / np.abs(fa).max())
                log(f"[14] serving {mode} {v}: max abs diff {d.max():.3e} (max |value| "
                    f"{np.abs(fa).max():.3e}), differing elements per day "
                    f"{(d > 0).reshape(len(d), -1).sum(axis=1).tolist()}, members' spread "
                    f"{spread[v]:.3e} of max |value|")
            same_t = np.array_equal(a.read_time(), b.read_time())
            same_attrs = all({k: str(x) for k, x in a._f[v].attrs.items()}
                             == {k: str(x) for k, x in b._f[v].attrs.items()} for v in VARS)
            shape = a.read_var("pr").shape
        serve_rel[mode] = max(rel.values())
        tol = 0.0 if mode == "fast" else MP_STRICT_SERVE_TOL
        ok = (serve_rel[mode] <= tol and same_t and same_attrs and not left
              and shape == (MP_SERVE_DAYS, MEMBERS, RES, RES))
        log(f"[14] serving {MP_SERVE_DAYS} days at b{BATCH}, K={MEMBERS}, {mode}, on 2 ranks "
            f"(2 + 1 batches), parts merged by rank 0: {shape}, max abs diff / max |value| "
            f"{serve_rel[mode]:.3e} against one process's file ("
            + ("array-equal required" if mode == "fast" else f"tol {tol}")
            + f"), time {same_t}, attributes {same_attrs}, parts left {left} "
            f"{'ok' if ok else 'FAIL'}; wall {[round(rk[tag]['wall_s'], 2) for rk in ranks]} s "
            f"per rank, one process {serve_wall[tag]:.2f} s ({card})")
        check(ok, f"the merged {mode} serving file differs from one process's")
        for rk, nb in zip(ranks, (2, 1)):
            want_s = dict(zip(KERNELS, (nb * K1_PER_BATCH, nb * K2_PER_BATCH, 0)))
            got_s = {k: rk[tag]["launches"][k] for k in want_s}
            log(f"[14] rank {rk['rank']} {mode} serving launches {got_s}, expected {want_s} for "
                f"{nb} batches")
            check(got_s == want_s, f"rank {rk['rank']} {mode} serving launches {got_s}")

    # ---- BCSD ---------------------------------------------------------------------------------
    got = np.load(os.path.join(root, "mp_bcsd.npz"))
    errs = {s: float(np.abs(got[s] - bcsd_ref[s]["preds"]).max() / np.abs(bcsd_ref[s]["preds"]).max())
            for s in ("val", "test")}
    ok = max(errs.values()) <= BCSD_TOL
    log(f"[14] run_bcsd on 2 ranks (climatologies summed in float64) against 1 process: max abs "
        f"diff / max |pred| {errs} (tol {BCSD_TOL}) {'ok' if ok else 'FAIL'}")
    check(ok, "two-rank BCSD differs from one process")
    if failed:
        raise AssertionError("phase 14: " + "; ".join(failed))
    report.update(step1_rel=step1, worst_rel=worst, update_rel=upd, resume_max_abs_diff=rdiff,
                  ms_per_step_2ranks=ms_per_step(mp_recs), ms_per_step_1process=ms_per_step(ref_recs),
                  peak_gib_ranks=[rk["mp_full"]["peak_gib"] for rk in ranks],
                  peak_gib_1process=ref_peak, bcsd_rel=errs, ranks_wall_s=mp_wall,
                  fault_update_rel=fault_upd, serve_rel=serve_rel)
    shutil.rmtree(root, ignore_errors=True)
    mark(14)
    return {"launches": launches, "report": report}


def sp_configs():
    """Phase 15's trainer configs, as this process and the rank children
    build them: (root, 2-rank spatial run of (b), 4-rank 2d run of (d), the
    256x256 tile's config of (c))."""
    root, train, _, _, _ = mp_configs()   # phase 11's files, 2 train years, b8, eval, CRPS
    root = os.path.join(WORK, "p15")
    spatial = train.replace(parallel_mode="spatial")
    two_d = train.replace(parallel_mode="2d", mesh_shape=(2, -1), batch_size=BATCH // 2,
                          max_steps=2, eval_crps=False)
    # BASELINE.json config 4: multi-variable 256x256 tiles, beta-annealed KL
    tile = train.replace(datadir=os.path.join(WORK, "p15_tile"), resolution=(SP_TILE, SP_TILE),
                         coords=(0, SP_TILE, 0, SP_TILE), remat=True, beta_schedule="linear",
                         beta_warmup_steps=100)
    return root, spatial, two_d, tile


def _tile_data(cfg, dev):
    """Phase 15's 256x256 days on ``dev``."""
    from probunet_torch.data.dataset import ClimexDataset

    return ClimexDataset(cfg.datadir, years=[2000], coords=cfg.coords,
                         standardization=cfg.standardization, device=dev)


def _tile_steps(torch, step_fn):
    """SP_TILE_STEPS calls of ``step_fn`` (one training step on one batch):
    (losses, ms per step after the first, peak GiB of this process)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, t0 = [], None
    for i in range(SP_TILE_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(float(step_fn()["train_loss"]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (SP_TILE_STEPS - 1)
    return losses, ms, torch.cuda.max_memory_allocated() / 2**30


def sp_rank(spec_path):
    """One rank of phase 15 (``python3 chip_smoke.py --sp-rank <spec>``):
    joins the gloo process group from the environment on cuda:0 and runs
    the spec's jobs: "trainer" (train_probunet, ``--parallel_mode
    spatial``), "tile" (the sharded step on the 256x256 tile, strict and
    fast) or "2d" (train_probunet, ``--parallel_mode 2d``); writes what it
    measured to ``sprank<r>.json`` beside the spec."""
    import torch

    sys.path.insert(0, ROOT)
    from probunet_torch.ops import _build
    from probunet_torch.parallel.mesh import DataParallel, SpatialMesh
    from probunet_torch.parallel.multihost import maybe_initialize_distributed, process_info
    from probunet_torch.parallel.spatial_train import (make_spatial_probunet_train_step,
                                                       put_spatial)
    from probunet_torch.train.loop import build_probunet, init_probunet_state, train_probunet
    from probunet_torch.train.state import make_optimizer
    from probunet_torch.train.steps import beta_schedule

    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device("cuda", 0)
    maybe_initialize_distributed(dev, "gloo")
    rank = process_info()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    root, spatial_cfg, two_d_cfg, tile_cfg = sp_configs()
    out = {"rank": rank}
    for job in spec["jobs"]:
        if job in ("trainer", "2d"):
            c = spatial_cfg if job == "trainer" else two_d_cfg
            c = c.replace(plotdir=os.path.join(root, job, "plots"),
                          checkpoints_dir=os.path.join(root, job, "ckpt"))
            _build.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = train_probunet(c, make_plots=False, device=dev)
            torch.cuda.synchronize()
            out[job] = {"wall_s": time.perf_counter() - t0, "steps": res["state"].step,
                        "launches": {k: _build.launches(k) for k in KERNELS},
                        "copies": _build.launches("kernel_layout"),
                        "dropout": dropout_counts(_build),
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            del res
        else:   # the 256x256 tile
            mesh = SpatialMesh(1)
            c = tile_cfg.replace(batch_size=spec["tile_batch"])
            pair = _tile_data(c, dev).batch(torch.arange(c.batch_size, device=dev))
            x, y = (put_spatial(pair[k], mesh) for k in ("inputs", "targets"))
            out["tile"] = {}
            for mode, dtype in (("strict", torch.float32), ("fast", torch.bfloat16)):
                state = init_probunet_state(c, build_probunet(c, device="meta"), make_optimizer(),
                                            device=dev)
                step = make_spatial_probunet_train_step(
                    state.model, mesh, beta_schedule(c.beta_schedule, c.beta,
                                                     c.beta_warmup_steps),
                    dtype, remat=True, dp=DataParallel())
                _build.reset_launches()
                losses, ms, peak = _tile_steps(torch, lambda: step(state, x, y, c.seed))
                out["tile"][mode] = {"losses": losses, "ms": ms, "peak_gib": peak,
                                     "launches": {k: _build.launches(k) for k in KERNELS},
                                     "copies": _build.launches("kernel_layout"),
                                     "dropout": dropout_counts(_build)}
                del state, step
            del pair, x, y
        torch.cuda.empty_cache()
    with open(os.path.join(root, f"sprank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _run_ranks(n, spec, root, timeout=600):
    """Start ``n`` phase-15 rank children on ``spec``, wait for them (kill
    them at ``timeout``), and return their results in rank order."""
    path = os.path.join(root, f"spec{n}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = _free_port()
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env.update(COORDINATOR_ADDRESS=f"localhost:{port}", PROBUNET_NUM_PROCESSES=str(n),
                   PROBUNET_PROCESS_ID=str(r))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sp-rank",
                                       path], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode:
            log(text[-6000:])
            raise AssertionError(f"phase 15 rank {r} of {n} exited with {p.returncode}")
    ranks = []
    for r in range(n):
        with open(os.path.join(root, f"sprank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks, wall


def spatial_phase(torch, dev, card, ds, mark):
    """Phase 15 (see the module docstring). Returns the launch counts of
    its paths and its report."""
    import numpy as np
    import torch.distributed as dist

    from probunet_torch.data.synthetic import generate_climex_like
    from probunet_torch.models.unet import build_unet_plan
    from probunet_torch.ops import _build
    from probunet_torch.parallel import mesh as M
    from probunet_torch.parallel.spatial_train import make_spatial_probunet_train_step
    from probunet_torch.train.loop import build_probunet, init_probunet_state, train_probunet
    from probunet_torch.train.state import create_train_state, make_optimizer
    from probunet_torch.train.steps import beta_schedule, make_probunet_train_step
    from probunet_torch.utils.device import full_fp32

    root, spatial_cfg, two_d_cfg, tile_cfg = sp_configs()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    report, launches, failed = {"card": card}, {}, []

    def check(ok, what):
        if not ok:
            failed.append(what)

    # ---- (a) one NCCL rank: the sharded step against the unsharded ELBO ---------------
    cfg = spatial_cfg.replace(dropout=0.0)
    model = build_probunet(cfg, device="meta").to_empty(device=dev)
    fill_weights(torch, model, seed=15)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    pair = ds.batch(torch.arange(BATCH, device=dev))
    x, y = pair["inputs"], pair["targets"]
    z = torch.randn(BATCH, cfg.latent_dim, generator=torch.Generator().manual_seed(15)).to(dev)
    M.init_process_group({"init_method": f"tcp://localhost:{_free_port()}", "world_size": 1,
                          "rank": 0}, dev)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, expected nccl")
        state = create_train_state(model, make_optimizer(cfg.lr, cfg.weight_decay))
        step = make_spatial_probunet_train_step(model, M.SpatialMesh(1), remat=False,
                                                dp=M.DataParallel())
        step(state, x, y, 0, z=z)   # warm-up: cuDNN picks its algorithms
        model.load_state_dict(init)
        state = create_train_state(model, make_optimizer(cfg.lr, cfg.weight_decay))
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, x, y, 0, z=z)
        torch.cuda.synchronize()
        sharded_ms = (time.perf_counter() - t0) * 1e3
        n_a = tuple(map(_build.launches, COUNTED))
        got = (float(m["train_loss"]), float(m["grad_norm"]),
               {k: p.grad.detach().clone() for k, p in model.named_parameters()})
    finally:
        dist.destroy_process_group()
    model.load_state_dict(init)
    with full_fp32():
        for p in model.parameters():
            p.grad = None
        total, _, _ = model.train().elbo_with_z(x, y, z, cfg.beta)
        total.backward()
    ref_g = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
             for k, p in model.named_parameters()}
    ref_norm = math.sqrt(sum(float(g.double().square().sum()) for g in ref_g.values()))
    ref_loss = total.item()
    loss_rel = abs(got[0] - ref_loss) / abs(ref_loss)
    norm_rel = abs(got[1] - ref_norm) / ref_norm
    grad_rel, worst = worst_grad(got[2], ref_g)
    ok = loss_rel <= STEP_LOSS_TOL and norm_rel <= STEP_LOSS_TOL and grad_rel <= STEP_GRAD_TOL
    log(f"[15] (a) one NCCL rank, make_spatial_probunet_train_step at full width, {RES}x{RES}, "
        f"b{BATCH}, strict, dropout 0, given z, against the unsharded elbo_with_z and its "
        f"backward on the same weights: loss rel err {loss_rel:.3e}, grad norm rel err "
        f"{norm_rel:.3e} (tol {STEP_LOSS_TOL}); worst gradient max|err| / max|g| {grad_rel:.3e} "
        f"({worst}; tol {STEP_GRAD_TOL}) {'ok' if ok else 'FAIL'}; one step {sharded_ms:.1f} ms")
    check(ok, "(a) the sharded step disagrees with the unsharded ELBO")
    want = (0, K2_PER_BATCH, K3_PER_STEP, 0)
    log(f"[15] (a) launches of one sharded step (K1, K2, K3, q/k/v copies): {tuple(n_a)}, "
        f"expected {want} {'ok' if tuple(n_a) == want else 'FAIL'}")
    check(tuple(n_a) == want, f"(a) launches {tuple(n_a)}")
    launches["nccl_step"] = dict(zip(KERNELS, n_a))
    report["nccl_step"] = {"loss_rel": loss_rel, "norm_rel": norm_rel, "grad_rel": grad_rel,
                           "ms": sharded_ms}
    del model, state, step, init, got, ref_g, total, x, y, pair
    torch.cuda.empty_cache()
    mark(15)

    # ---- this process: the references of (b), (c) and (d) --------------------------------
    ref_cfg = spatial_cfg.replace(parallel_mode="data", plotdir=os.path.join(root, "ref", "plots"),
                                  checkpoints_dir=os.path.join(root, "ref", "ckpt"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_probunet(ref_cfg, make_plots=False, device=dev)
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    ref2_cfg = two_d_cfg.replace(parallel_mode="data", data_shards=2,
                                 plotdir=os.path.join(root, "ref2d", "plots"),
                                 checkpoints_dir=os.path.join(root, "ref2d", "ckpt"))
    train_probunet(ref2_cfg, make_plots=False, device=dev)
    torch.cuda.empty_cache()
    generate_climex_like(tile_cfg.datadir, years=(2000,), grid=SP_TILE,
                         days_per_year=max(SP_TILE_BATCHES))
    enc, dec, _ = build_unet_plan((SP_TILE, SP_TILE), 3, tile_cfg.model_channels,
                                  tile_cfg.channel_mult, tile_cfg.num_blocks,
                                  tile_cfg.attn_resolutions)
    n_attn = sum(1 for s in enc + dec if s.attention and s.out_channels // 64)
    tile_ds = _tile_data(tile_cfg, dev)
    tile_one, tile_b = {}, None
    for b in SP_TILE_BATCHES:
        c = tile_cfg.replace(batch_size=b)
        idx = torch.arange(b, device=dev)
        try:
            for mode, dtype in (("strict", torch.float32), ("fast", torch.bfloat16)):
                state = init_probunet_state(c, build_probunet(c, device="meta"), make_optimizer(),
                                            device=dev)
                one = make_probunet_train_step(state.model, c.lowres_scale, c.standardization,
                                               beta_schedule(c.beta_schedule, c.beta,
                                                             c.beta_warmup_steps), dtype)
                losses, ms, peak = _tile_steps(torch, lambda: one(
                    state, tile_ds.hr_device(), tile_ds.stats, idx, c.seed))
                tile_one[mode] = {"losses": losses, "ms": ms, "peak_gib": peak}
                del state, one
                torch.cuda.empty_cache()
        except torch.cuda.OutOfMemoryError:
            log(f"[15] (c) one process at {SP_TILE}x{SP_TILE} b{b}: out of memory")
            tile_one = {}
            torch.cuda.empty_cache()
            continue
        if tile_one["strict"]["peak_gib"] <= SP_TILE_PEAK_GIB:
            tile_b = b
            break
        log(f"[15] (c) one process at b{b}: strict peak {tile_one['strict']['peak_gib']:.2f} "
            f"GiB over {SP_TILE_PEAK_GIB}: two ranks would not fit")
    if tile_b is None:
        raise AssertionError(f"phase 15 (c): no batch of {SP_TILE_BATCHES} fits")
    del tile_ds
    torch.cuda.empty_cache()
    mark(15)

    # ---- (b) and (c): two gloo ranks sharing the card ---------------------------------------
    ranks, wall = _run_ranks(SP_RANKS, {"jobs": ["trainer", "tile"], "tile_batch": tile_b}, root)
    log(f"[15] {SP_RANKS} ranks (child processes, gloo on cuda:0) ran the spatial trainer and "
        f"the {SP_TILE}x{SP_TILE} tile in {wall:.1f} s (process start, init and data included)")

    def records(tag):
        with open(os.path.join(root, tag, "plots", "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    def compare(tag, ref_tag, n_steps):
        ref_recs, recs = records(ref_tag), records(tag)
        check([sorted(r) for r in recs] == [sorted(r) for r in ref_recs],
              f"({tag}) the ranks' records differ in keys or count from one process's")
        worst = {}
        for key in ("train_loss", "recon_loss", "kl_div", "grad_norm", "val_loss"):
            a = np.asarray([r[key] for r in ref_recs if key in r])
            b_ = np.asarray([r[key] for r in recs if key in r])
            if not len(a):
                continue
            log(f"[15] ({tag}) {key}: one process {a.tolist()}, ranks {b_.tolist()}")
            check(len(a) == len(b_) and np.isfinite(b_).all(), f"({tag}) {key}")
            worst[key] = float(np.max(np.abs(b_ - a) / np.abs(a)))
        steps = [r for r in recs if "train_loss" in r]
        step1 = (abs(steps[0]["train_loss"] - ref_recs[0]["train_loss"])
                 / abs(ref_recs[0]["train_loss"]))
        ok = (step1 <= MP_STEP1_TOL and max(worst.values()) <= MP_TRAJ_TOL
              and len(steps) == n_steps)
        log(f"[15] ({tag}) against one process ({n_steps} steps): step-1 loss rel diff "
            f"{step1:.3e} (tol {MP_STEP1_TOL}); worst rel diff over the run "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
            + f" (tol {MP_TRAJ_TOL}) {'ok' if ok else 'FAIL'}")
        check(ok, f"({tag}) the sharded run differs from one process")
        ckpt = os.path.join(root, tag, "ckpt", "probunet")
        files = sorted(os.path.relpath(os.path.join(d, f), ckpt)
                       for d, _, fs in os.walk(ckpt) for f in fs)
        check(files == [os.path.join("state", "state.pt")], f"({tag}) checkpoint holds {files}")
        return {"step1_rel": step1, "worst_rel": worst,
                "ms_per_step": 1e3 * BATCH / steps[-1]["samples_per_sec"]}

    n_steps = TRAINER_EPOCHS * (2 * TRAINER_DAYS // BATCH)
    report["trainer"] = compare("trainer", "ref", n_steps)
    n_evals = TRAINER_EPOCHS * 2     # one val and one CRPS batch per epoch
    want = dict(zip(KERNELS, (0, (n_steps + n_evals) * K2_PER_BATCH, n_steps * K3_PER_STEP)))
    for rk in ranks:
        got_l = rk["trainer"]["launches"]
        ok = got_l == want and rk["trainer"]["copies"] == 0
        log(f"[15] (b) rank {rk['rank']} launches {got_l}, expected {want} (per step 0 / "
            f"{K2_PER_BATCH} / {K3_PER_STEP}, per eval or CRPS batch 0 / {K2_PER_BATCH} / 0), "
            f"q/k/v copies {rk['trainer']['copies']}; peak {rk['trainer']['peak_gib']:.2f} GiB, "
            f"wall {rk['trainer']['wall_s']:.1f} s {'ok' if ok else 'FAIL'}")
        check(ok, f"(b) rank {rk['rank']} launches {got_l}")
        check(dropout_check(15, f"spatial_trainer_rank{rk['rank']}", rk["trainer"]["dropout"],
                            n_steps, copied=True), f"(b) rank {rk['rank']} dropout")
        launches[f"rank{rk['rank']}_trainer"] = got_l
    ref_ms = 1e3 * BATCH / [r for r in records("ref") if "train_loss" in r][-1]["samples_per_sec"]
    log(f"[15] (b) ms per step (epoch {TRAINER_EPOCHS}, b{BATCH}): 2 ranks sharing the card over "
        f"gloo {report['trainer']['ms_per_step']:.1f}, one process {ref_ms:.1f}"
        f"; one process's peak {ref_peak:.2f} GiB; the ranks share one card and stage every "
        f"halo, gather and the gradient through the host: not a scaling figure ({card})")

    per_step = dict(zip(KERNELS, (0, 2 * n_attn, n_attn)))   # remat: K2 twice
    report["tile"] = {"batch": tile_b, "one_process": tile_one, "ranks": {}}
    for mode in ("strict", "fast"):
        for rk in ranks:
            t = rk["tile"][mode]
            want_t = {k: SP_TILE_STEPS * v for k, v in per_step.items()}
            ok = (np.isfinite(t["losses"]).all() and t["losses"][-1] < t["losses"][0]
                  and t["launches"] == want_t and t["copies"] == 0)
            log(f"[15] (c) {SP_TILE}x{SP_TILE} tile, b{tile_b}, {mode}, remat, rank {rk['rank']} "
                f"of {SP_RANKS}: losses {[round(v, 1) for v in t['losses']]}, {t['ms']:.1f} ms "
                f"per step, peak {t['peak_gib']:.2f} GiB; launches {t['launches']} = "
                f"{SP_TILE_STEPS} x {per_step} (from build_unet_plan: {n_attn} attention "
                f"blocks, K2 twice with remat) {'ok' if ok else 'FAIL'}")
            check(ok, f"(c) {mode} rank {rk['rank']}")
            check(dropout_check(15, f"spatial_tile_{mode}_rank{rk['rank']}", t["dropout"],
                                SP_TILE_STEPS, remat=True, copied=True),
                  f"(c) {mode} rank {rk['rank']} dropout")
            launches[f"rank{rk['rank']}_tile_{mode}"] = t["launches"]
            report["tile"]["ranks"].setdefault(mode, []).append(
                {k: t[k] for k in ("ms", "peak_gib", "losses")})
        o = tile_one[mode]
        log(f"[15] (c) one process, unsharded, same tile and batch, {mode}, remat: "
            f"{o['ms']:.1f} ms per step, peak {o['peak_gib']:.2f} GiB, losses "
            f"{[round(v, 1) for v in o['losses']]} ({card})")
    mark(15)

    # ---- (d) four gloo ranks, 2d (2 x 2) --------------------------------------------------
    ranks4, wall4 = _run_ranks(SP_2D_RANKS, {"jobs": ["2d"]}, root)
    log(f"[15] (d) {SP_2D_RANKS} ranks, --parallel_mode 2d --mesh_shape 2,-1, in {wall4:.1f} s")
    report["2d"] = compare("2d", "ref2d", two_d_cfg.max_steps)
    want4 = dict(zip(KERNELS, (0, 2 * K2_PER_BATCH, 2 * K3_PER_STEP)))
    for rk in ranks4:
        got_l = rk["2d"]["launches"]
        log(f"[15] (d) rank {rk['rank']} launches {got_l}, expected {want4}; peak "
            f"{rk['2d']['peak_gib']:.2f} GiB {'ok' if got_l == want4 else 'FAIL'}")
        check(got_l == want4, f"(d) rank {rk['rank']} launches {got_l}")
        check(dropout_check(15, f"spatial_2d_rank{rk['rank']}", rk["2d"]["dropout"],
                            two_d_cfg.max_steps, copied=True), f"(d) rank {rk['rank']} dropout")
        launches[f"rank{rk['rank']}_2d"] = got_l
    if failed:
        raise AssertionError("phase 15: " + "; ".join(failed))
    shutil.rmtree(root, ignore_errors=True)
    mark(15)
    return {"launches": launches, "report": report}


def mc96_phase(torch, dev, card, ds, ds_cpu, gen, mark):
    """Phase 16: the prob-U-Net at model_channels 96 (see MC96_*): the
    kD = 128 kernels' registers and spills, (a) one strict step and the
    sampler card against CPU, (b) the sampler at b8 K=16 and training steps
    at b8, strict and fast, with exact launch counts, (c) K2 and K3 against
    their plain versions at every MC96_HEAD_DIMS, (d) K2 and K3 per U-Net
    pass over this path's sites beside SDPA and the bound. Returns the
    launch counts of (b) by path, the errors and the report."""
    import torch.nn.functional as F

    from probunet_torch.config import Config
    from probunet_torch.ops import _build
    from probunet_torch.ops import attention as K2
    from probunet_torch.train.loop import build_probunet, init_probunet_state
    from probunet_torch.train.state import make_optimizer
    from probunet_torch.train.steps import (beta_schedule, make_probunet_train_step,
                                            make_sample_fn)
    from probunet_torch.utils.device import full_fp32

    cfg = Config(datadir=os.path.join(WORK, "data"), years_test=(2000, 2001),
                 coords=(0, RES, 0, RES), resolution=(RES, RES), standardization="pertimestep",
                 batch_size=BATCH, num_samples=MEMBERS, model_channels=MC96)
    modes = {"strict": cfg, "fast": cfg.replace(compute_dtype="bfloat16", fast_attention=True,
                                                opt_state_dtype="bfloat16")}
    model = build_probunet(cfg, device="meta").to_empty(device=dev).eval()
    fill_weights(torch, model, seed=16)
    nparams = sum(p.numel() for p in model.parameters())
    gn_sites, attn_sites = census(torch, model, lambda: model.unet(
        torch.randn(BATCH, RES, RES, 3, device=dev)))
    dims = sorted({(m.qkv.weight.shape[0] // 3 // m.heads, m.heads) for m in model.modules()
                   if getattr(m, "heads", 0)})
    sites = {(L, nh, c): n for (L, nh), n in _counts(attn_sites).items()
             for c, h in dims if h == nh}
    log(f"[16] model_channels {MC96}: {RES}x{RES} Probabilistic U-Net, {nparams:,} parameters; "
        f"{len(gn_sites)} K1 sites, attention sites (L, heads, head dim) x blocks: {sites}")
    if nparams != MC96_PARAMS or sites != MC96_SITES or len(gn_sites) != K1_PER_BATCH:
        raise AssertionError(f"expected {MC96_PARAMS:,} parameters, {K1_PER_BATCH} K1 sites "
                             f"and attention at {MC96_SITES}")
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    wide = [(L, nh) for L, nh, c in MC96_SITES if c > 64]
    kd80 = attn_kernel_info(torch, K2, wide, num_sms, kd=80, phase=16)
    kd128 = attn_kernel_info(torch, K2, wide, num_sms, kd=128, phase=16)
    report = {"card": card, "params": nparams, "sites": {str(k): v for k, v in sites.items()},
              "kd80_kernels": kd80, "kd128_kernels": kd128,
              "kd128_fp32_kernels": f32_kernel_info(torch, K2, 128, 16)}
    mark(16)

    # ---- (a) the sampler and one strict step, card against CPU ----------------------
    report["sample_card_vs_cpu"] = sample_card_vs_cpu(torch, model, cfg, ds, ds_cpu, dev, 16)
    report["step_card_vs_cpu"] = step_card_vs_cpu(torch, dev, cfg, ds, ds_cpu, 16)
    mark(16)

    # ---- (b) the path: the sampler at b8 K=16, training steps at b8 ------------------
    hr_all = ds.hr_device()
    batches = [torch.arange(i * BATCH, (i + 1) * BATCH, device=dev)
               for i in range(DAYS // BATCH)]
    by_path, rates = {}, {}

    def by_kd(want):
        """K2's ("fwd") and K3's ("bwd") launches counted at each (dtype,
        kd) of ``want``'s."""
        return {leg: {key: _build.launches(kernel, *key) for key in want[leg]}
                for leg, kernel in (("fwd", "attention_fwd"), ("bwd", "attention_bwd"))}

    for name, c in modes.items():
        dtype = torch.bfloat16 if name == "fast" else torch.float32
        m = build_probunet(c, device="meta").to_empty(device=dev).eval()
        m.load_state_dict(model.state_dict())
        fn = make_sample_fn(m, 4, cfg.standardization, MEMBERS, dtype)
        e = torch.randn(MEMBERS, BATCH, cfg.latent_dim)
        with full_fp32():
            for i in range(MC96_WARMUP):
                fn(hr_all, ds.stats, batches[i], eps=e)
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            outs = [fn(hr_all, ds.stats, batches[i], eps=e) for i in range(MC96_BATCHES)]
            torch.cuda.synchronize()
            per = (time.perf_counter() - t0) / MC96_BATCHES
            want_kd = {"fwd": mc96_by_kd(K2, dtype == torch.bfloat16, MC96_BATCHES), "bwd": {}}
            n, kds = tuple(map(_build.launches, COUNTED)), by_kd(want_kd)
            device = profile(torch, lambda: fn(hr_all, ds.stats, batches[0], eps=e),
                             f"mc96 sampler {name}", "one batch", phase=16, top=8)
        by_path[f"mc96_serve_{name}"] = dict(zip(KERNELS, n), by_kd=kds)
        want = (MC96_BATCHES * K1_PER_BATCH, MC96_BATCHES * K2_PER_BATCH, 0, 0)
        finite = all(bool(torch.isfinite(o[0]).all()) for o in outs)
        shape = tuple(outs[0][0].shape)
        rates[f"sampler_{name}"] = {"ms_per_batch": per * 1e3, "device_ms": device,
                                    "inputs_per_s": BATCH / per}
        log(f"[16] sampler {name}: {per * 1e3:.2f} ms per batch of {BATCH} inputs x {MEMBERS} "
            f"members (device {device} ms), output {shape}, finite {finite}; launches K1 "
            f"{n[0]}, K2 {n[1]}, K3 {n[2]}, copies {n[3]} (expected {want}); by head width "
            f"{kds} (expected {want_kd}) ({card})")
        if n != want or kds != want_kd or not finite or shape != (BATCH, MEMBERS, RES, RES, 3):
            raise AssertionError("the mc96 sampler's launches or output are off")
        del m, outs
    for name, c in modes.items():
        dtype = torch.bfloat16 if name == "fast" else torch.float32
        c = c.replace(dropout=0.1)
        tx = make_optimizer(c.lr, c.weight_decay, c.accum, c.optimizer, None, c.opt_state_dtype)
        state = init_probunet_state(c, build_probunet(c, device="meta"), tx, device=dev)
        step = make_probunet_train_step(
            state.model, c.lowres_scale, c.standardization,
            beta_schedule(c.beta_schedule, c.beta, c.beta_warmup_steps), dtype, c.accum)
        for i in range(MC96_WARMUP):
            step(state, hr_all, ds.stats, batches[i], c.seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        ms = [step(state, hr_all, ds.stats, batches[i % len(batches)], c.seed)
              for i in range(MC96_STEPS)]
        torch.cuda.synchronize()
        per = (time.perf_counter() - t0) / MC96_STEPS
        want_kd = {leg: mc96_by_kd(K2, dtype == torch.bfloat16, MC96_STEPS)
                   for leg in ("fwd", "bwd")}
        n, kds = tuple(map(_build.launches, COUNTED)), by_kd(want_kd)
        losses = [x["train_loss"].item() for x in ms]
        peak = torch.cuda.max_memory_allocated() / 2**30
        device = profile(torch, lambda: step(state, hr_all, ds.stats, batches[0], c.seed),
                         f"mc96 train step {name}", "one step", phase=16, top=8)
        by_path[f"mc96_train_{name}"] = dict(zip(KERNELS, n), by_kd=kds)
        want = (MC96_STEPS * K1_PER_BATCH, MC96_STEPS * K2_PER_BATCH, MC96_STEPS * K3_PER_STEP, 0)
        rates[f"train_{name}"] = {"ms_per_step": per * 1e3, "device_ms": device,
                                  "samples_per_s": BATCH / per, "peak_gib": peak,
                                  "losses": losses}
        log(f"[16] train {name}: {per * 1e3:.2f} ms per step of {BATCH} samples (device "
            f"{device} ms), peak {peak:.2f} GiB, loss {[round(x, 1) for x in losses]}; launches "
            f"K1 {n[0]}, K2 {n[1]}, K3 {n[2]}, copies {n[3]} (expected {want}); by head width "
            f"{kds} (expected {want_kd}) ({card})")
        if n != want or kds != want_kd or not all(math.isfinite(x) for x in losses):
            raise AssertionError("the mc96 training step's launches or losses are off")
        del state, step, ms
    report["rates"] = rates
    mark(16)

    # ---- (c) K2 and K3 against their plain versions at head dims past 64 -----------------
    cases = [(2, L, 2, c) for c in MC96_HEAD_DIMS for L in MC96_LENGTHS]
    cases += [(BATCH, L, nh, c) for L, nh, c in MC96_SITES if c > 64]
    worst, vs128, exact_err = {}, {}, {"fwd": 0.0, "bwd": 0.0}
    ds_seen = {"kernel": 0.0, "kernel_rounded": math.inf, "plain_rounded": math.inf,
               "kernel_vs_plain_version": 0.0}
    for mode, (dname, fast) in ATTN_MODES.items():
        dtype = getattr(torch, dname)
        for b, L, nh, c in cases:
            errs = {"fwd": 0.0, "bwd": 0.0, "lse": 0.0}
            for layout in LAYOUTS if b == 2 else ("block",):
                q, k, v = qkv_views(torch, layout, b, L, nh, dtype, dev, gen, c)
                do = torch.randn(b, L, nh, c, device=dev, generator=gen).to(dtype)
                with torch.no_grad():
                    _build.reset_launches()
                    out = K2.fused_attention(q, k, v, fast)
                    again = K2.fused_attention(q, k, v, fast)
                    copies = _build.launches("kernel_layout")
                    ref = K2._plain_attention(q, k, v, fast)
                    lo, lse = K2._launch(*map(K2.kernel_layout, (q, k, v)), with_lse=True, c=c)
                    got = K2.attention_bwd(q, k, v, lo, lse, do, fast)
                    got2 = K2.attention_bwd(q, k, v, lo, lse, do, fast)
                    ref_b = K2._plain_attention_bwd(q, k, v, do, fast)
                    # the kernels scale the fp32 logits of the bf16 operands in every
                    # mode (fast mode's plain version rounds K / sqrt(c) to bf16 first,
                    # which moves the lse by ~1e-3 where 1 / sqrt(c) is no power of 2)
                    ref_lse = torch.logsumexp(torch.einsum(
                        "bqhc,bkhc->bhqk", q.float(), k.float() / math.sqrt(c)),
                        dim=-1).reshape(b * nh, L)
                torch.cuda.synchronize()
                e_f = (out.float() - ref.float()).abs().max().item()
                e_b = max((g.float() - r.float()).abs().max().item()
                          / max(1e-3, r.float().abs().max().item()) for g, r in zip(got, ref_b))
                e_l = (lse - ref_lse).abs().max().item()
                same = torch.equal(out, again) and all(
                    torch.equal(x, y) for x, y in zip(got, got2))
                in_place = c == K2.kernel_width(c) and layout != "stride3"
                ok = (e_f <= ATTN_TOL[mode] and torch.allclose(
                          out.float(), ref.float(), atol=ATTN_TOL[mode], rtol=ATTN_TOL[mode])
                      and e_b <= ATTN_BWD_TOL[dname] and e_l <= 1e-4 and same
                      and out.shape == q.shape and all(g.shape == q.shape for g in got)
                      and copies == (0 if in_place else 6))
                if not ok:
                    raise AssertionError(
                        f"[16] K2/K3 {mode} {layout} B={b} L={L} heads={nh} c={c}: fwd err "
                        f"{e_f:.3e} (tol {ATTN_TOL[mode]}), bwd {e_b:.3e} (tol "
                        f"{ATTN_BWD_TOL[dname]}), lse {e_l:.3e}, bit-equal {same}, copies "
                        f"{copies}")
                if mode == "strict_bf16" and L > 1:
                    split_ds_check(torch, K2, q, k, v, lo, lse, do, got, ref_b, ds_seen,
                                   f"{layout:10s} B={b} L={L} heads={nh} c={c}", 16)
                if dname == "bfloat16" and K2._kd(K2.kernel_width(c)) != 128:
                    for key, val in exact_vs_kd128(torch, K2, q, k, v, do, fast, c).items():
                        vs128[key] = max(vs128.get(key, 0.0), val)
                errs = {"fwd": max(errs["fwd"], e_f), "bwd": max(errs["bwd"], e_b),
                        "lse": max(errs["lse"], e_l)}
            kd = K2._kd(K2.kernel_width(c)) if dname == "bfloat16" else K2._fp32_kd(c)
            log(f"[16] K2/K3 {mode:11s} B={b} L={L:4d} heads={nh} c={c:3d} (kD "
                f"{kd}; {'every layout' if b == 2 else 'block views'}): "
                f"max abs err fwd {errs['fwd']:.3e} (tol {ATTN_TOL[mode]}), dq/dk/dv / max|ref|"
                f" {errs['bwd']:.3e} (tol {ATTN_BWD_TOL[dname]}), lse {errs['lse']:.3e}; two "
                f"calls bit-equal ok")
            for key, val in errs.items():
                worst[f"{mode}_{key}"] = max(worst.get(f"{mode}_{key}", 0.0), val)
            if mode == "fast" and kd in (80, 96):
                exact_err = {key: max(val, errs[key]) for key, val in exact_err.items()}
    log(f"[16] strict_bf16 dS check over (c): the kernel at most {ds_seen['kernel']:.3e}, dS "
        f"rounded at least {ds_seen['kernel_rounded']:.3e} (kernel) / "
        f"{ds_seen['plain_rounded']:.3e} (plain); limit {DS_SPLIT_TOL}")
    log(f"[16] the exact widths (kD = 80 / 96, c = 65-96, bf16) against the kD = 128 kernels on "
        f"the same inputs, largest difference: K2 at its own plan {vs128['k2_own_plan']:.3e} "
        f"(within {ATTN_TOL['fast']}: other K/V tiles), K2 at kD = 128's block shape "
        f"{vs128['k2_kd128_shape']:.3e} and K3 on the same forward {vs128['k3_same_inputs']:.3e} "
        f"(expected 0)")
    if vs128["k2_own_plan"] > ATTN_TOL["fast"] or vs128["k2_kd128_shape"] or \
            vs128["k3_same_inputs"]:
        raise AssertionError(f"[16] the exact-width kernels part from kD = 128: {vs128}")
    report["max_err"], report["ds_check"] = worst, {**ds_seen, "limit": DS_SPLIT_TOL}
    report["exact_vs_kd128"], report["exact_max_err"] = vs128, exact_err
    mark(16)

    # ---- (d) K2 and K3 per U-Net pass over this path's sites ------------------------------
    def time_sites(mode, backward):
        """The pass totals of one leg in one mode, and those of the sites
        that run an exact width (kD = 80 / 96; bf16 only)."""
        dname, fast = ATTN_MODES[mode]
        dtype, tot, exact = getattr(torch, dname), {}, {}
        for (L, nh, c), mult in MC96_SITES.items():
            kd = K2._kd(K2.kernel_width(c)) if dname == "bfloat16" else None
            q, k, v = qkv_views(torch, "block", BATCH, L, nh, dtype, dev, gen, c)
            qs, ks, vs = (a.permute(0, 2, 1, 3).contiguous() for a in (q, k, v))
            if backward:
                do = torch.randn(BATCH, L, nh, c, device=dev, generator=gen).to(dtype)
                with torch.no_grad():
                    out, lse = K2._launch(q, k, v, with_lse=True)
                qs, ks, vs = (a.requires_grad_() for a in (qs, ks, vs))
                os_ = F.scaled_dot_product_attention(qs, ks, vs)
                dos = do.permute(0, 2, 1, 3).contiguous()

                def run():
                    return K2.attention_bwd(q, k, v, out, lse, do, fast)

                def run128():
                    return K2._launch_bwd(q, k, v, out, lse, do, fast, kd=128)

                def plain():
                    return K2._plain_attention_bwd(q, k, v, do, fast)

                def lib():
                    return torch.autograd.grad(os_, (qs, ks, vs), dos, retain_graph=True)
                flops, tensors = 10.0 * BATCH * nh * L * L * c, 8
            else:
                def run():
                    return K2.fused_attention(q, k, v, fast)

                def run128():
                    return K2._launch(q, k, v, with_lse=False, kd=128)

                def plain():
                    return K2._plain_attention(q, k, v, fast)

                def lib():
                    return F.scaled_dot_product_attention(qs, ks, vs)
                flops, tensors = 4.0 * BATCH * nh * L * L * c, 4
            split = {}
            with torch.no_grad():
                t = {"ms": cuda_ms(torch, run),
                     "device_ms": device_ms(torch, run, whole=True, split=split),
                     "plain_ms": cuda_ms(torch, plain, reps=5)}
                # the kD = 128 kernels on the same inputs, where the site runs an
                # exact width (elsewhere the site's own kernels)
                split128 = {}
                t["kd128_device_ms"] = (device_ms(torch, run128, whole=True, split=split128)
                                        if kd in (80, 96) else t["device_ms"])
            if backward:
                t.update(k3_split(split))
                if kd in (80, 96):
                    t.update({f"kd128_{k_}": v_ for k_, v_ in k3_split(split128).items()})
                else:
                    t.update({f"kd128_{k_}": v_ for k_, v_ in k3_split(split).items()})
            t["library_ms"] = cuda_ms(torch, lib)
            t["library_device_ms"] = device_ms(torch, lib, whole=True)
            # q, k, v (and o, dO; dq, dk, dv) read or written once at the real c, and
            # K3's fp32 lse
            nbytes = tensors * BATCH * L * nh * c * q.element_size() + (
                4.0 * BATCH * nh * L if backward else 0.0)
            t.update(attn_bound(flops, nbytes, mode))
            t["flops"] = flops
            by_kernel = (f": row pass {t['row_pass_device_ms']:.4f}, dK/dV "
                         f"{t['dkdv_device_ms']:.4f}, dQ {t['dq_device_ms']:.4f}"
                         if backward else "")
            log(f"[16] {'K3' if backward else 'K2'} {mode:6s} B={BATCH} L={L} heads={nh} c={c} "
                f"x{mult} (kD {kd or K2._fp32_kd(c)}): kernel {t['ms']:.4f} ms (device "
                f"{t['device_ms']:.4f}{by_kernel}; the kD = 128 kernels "
                f"{t['kd128_device_ms']:.4f}), plain {t['plain_ms']:.4f}, "
                f"SDPA{' backward' if backward else ''} {t['library_ms']:.4f} (device "
                f"{t['library_device_ms']:.4f}), bound {t['bound_ms']:.4f}; "
                f"{flops / t['device_ms'] / 1e9:.1f} TFLOP/s by device time")
            for key, val in t.items():
                tot[key] = tot.get(key, 0.0) + mult * val
                if kd in (80, 96):
                    exact[key] = exact.get(key, 0.0) + mult * val
        tot = attn_totals(tot, tot.pop("flops"))
        if exact:
            tot["exact_width_sites"] = attn_totals(exact, exact.pop("flops"))
        return tot

    with full_fp32():
        timings = {f"{'k3' if bwd else 'k2'}_{mode}": time_sites(mode, bwd)
                   for bwd in (False, True) for mode in ("strict", "fast")}
    for name, tt in timings.items():
        log(f"[16] per U-Net pass at b{BATCH}, mc {MC96} ({name}): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in tt.items()
            if k != "exact_width_sites"))
        if "exact_width_sites" in tt:
            log("[16]   of which the exact-width sites (kD = 80, c = 72): " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in tt["exact_width_sites"].items()))
    report["timings"] = timings
    mark(16)
    return {"launches": by_path, "report": report}


def conv_phase(torch, dev, card, mark):
    """Phase 17: the convolutions (ops/conv.py; see the module docstring).
    Returns the split kernel's entry fields and the phase's report."""
    import torch.nn.functional as F

    from probunet_torch.config import Config
    from probunet_torch.ops import _build
    from probunet_torch.ops import conv as C
    from probunet_torch.train.loop import build_edm_model, build_probunet, init_probunet_state
    from probunet_torch.train.state import make_optimizer
    from probunet_torch.train.steps import make_probunet_train_step
    from probunet_torch.utils.device import full_fp32

    report = {"card": card}
    gen = torch.Generator(device=dev).manual_seed(17)
    flag0 = torch.backends.cudnn.allow_tf32
    aten = torch.ops.aten

    def conv_calls():
        return {k: _build.launches("conv2d", k) for k in C.PATHS}

    # ---- the split kernel against its plain version, bit for bit ---------------------
    cases = [((BATCH, 128, RES, RES), "channels_last"), ((BATCH, 512, 16, 16), "channels_last"),
             ((2, 6, RES, RES), "channels_last"), ((BATCH, 128, 32, 32), "contiguous"),
             ((256, 128, 3, 3), "weight"), ((768, 256, 1, 1), "weight")]
    uses = ((C.X_FWD, 1), (C.W_FWD, 1), (C.DY_DGRAD, 1), (C.W_DGRAD, 0))
    split_err = 0.0
    for shape, layout in cases:
        x = torch.randn(shape, device=dev, generator=gen) * 3
        if layout == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last)
        for order, dim in uses:
            got = C.split(x, order, dim)
            want = C._plain_split(x, order, dim)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                split_err = max(split_err, (g - w).abs().max().item())
                if not (torch.equal(g.view(torch.int32), w.view(torch.int32))
                        and g.is_contiguous(memory_format=torch.channels_last)):
                    raise AssertionError(f"the split kernel differs from its plain version at "
                                         f"{shape} {layout} {order} dim {dim}")
    if split_err > SPLIT_TOL:
        raise AssertionError(f"the split kernel's max |got - want| {split_err} > {SPLIT_TOL}")
    log(f"[17] tf32 split kernel bit-equal to its plain version in {len(cases) * len(uses)} "
        f"cases, hi and the pair (activations channels_last and contiguous, C = 6 "
        f"unvectorized, OIHW weights); max |got - want| {split_err}")
    x0 = torch.randn(BATCH, 128, RES, RES, device=dev, generator=gen).contiguous(
        memory_format=torch.channels_last)
    nbytes = 4 * x0.numel() * 4   # read S, write hi and the pair: 3S

    def split0():
        return C.split(x0, C.X_FWD, 1)

    split_t = {"ms": cuda_ms(torch, split0),
               "device_ms": device_ms(torch, split0, whole=True),
               "plain_ms": cuda_ms(torch, lambda: C._plain_split(x0, C.X_FWD, 1), reps=5),
               "bound_ms": nbytes / peak_rates()["hbm_bytes_per_s"] * 1e3, "bound_by": "bytes",
               "library_ms": None}
    log(f"[17] split of the level-0 activation ({BATCH}x128x{RES}x{RES} fp32 -> hi and "
        f"[lo, hi]): kernel {split_t['ms']:.4f} ms (device {split_t['device_ms']:.4f}), plain "
        f"{split_t['plain_ms']:.4f}, bound {split_t['bound_ms']:.4f} (bytes; "
        f"{split_t['bound_ms'] / split_t['device_ms']:.0%} of it)")
    del x0
    mark(17)

    # ---- the sites of one strict training step and of one EDM pass --------------------
    sites = []
    orig = {name: getattr(C, name) for name in ("forward_ieee", "forward_3x")}

    def meta(t):
        return (tuple(t.shape), t.is_contiguous(memory_format=torch.channels_last))

    def recorder(name):
        def rec(x, w, b, stride, padding):
            sites.append((meta(x), tuple(w.shape), b is not None, stride, padding,
                          x.requires_grad))
            return orig[name](x, w, b, stride, padding)
        return rec

    cfg = Config(coords=(0, RES, 0, RES), resolution=(RES, RES), dropout=0.1)
    state = init_probunet_state(cfg, build_probunet(cfg, device="meta"),
                                make_optimizer(cfg.lr, cfg.weight_decay), device=dev)
    step = make_probunet_train_step(state.model, cfg.lowres_scale, cfg.standardization)
    hr = torch.rand(2 * BATCH, RES, RES, 3, device=dev, generator=gen) + 1
    stats = (hr.mean(0), hr.std(0))
    idx = torch.arange(BATCH, device=dev)
    step(state, hr, stats, idx, 0)
    _build.reset_launches()
    C.forward_ieee = recorder("forward_ieee")
    try:
        step(state, hr, stats, idx, 1)
        torch.cuda.synchronize()
    finally:
        C.forward_ieee = orig["forward_ieee"]
    step_calls = conv_calls()
    train_sites = list(sites)
    n_fwd, n_dgrad = len(train_sites), sum(1 for s in train_sites if s[-1])
    log(f"[17] strict training step (b{BATCH}, {RES}x{RES}): conv2d by path {step_calls}; "
        f"{n_fwd} sites, {n_dgrad} of them with an input that needs a gradient; "
        f"cudnn.allow_tf32 after it {torch.backends.cudnn.allow_tf32}")
    if (step_calls["plain"] or step_calls["tf32x3_fwd"]
            or step_calls["ieee_fwd"] + step_calls["ieee_fwd_transposed"] != n_fwd
            or step_calls["ieee_wgrad"] != n_fwd or step_calls["tf32x3_dgrad"] != n_dgrad
            or not step_calls["ieee_fwd_transposed"] or step_calls["split"] != 2 * n_dgrad
            or torch.backends.cudnn.allow_tf32 != flag0):
        raise AssertionError("the strict step's convolutions did not take the strict paths, "
                             "or the cuDNN TF32 flag was not restored")
    del state, step, hr, stats

    sites.clear()
    ecfg = Config(ds_model="edm", coords=(0, RES, 0, RES), resolution=(RES, RES), dropout=0.0)
    edm = build_edm_model(ecfg, device="meta").to_empty(device=dev).eval()
    fill_weights(torch, edm, seed=17)
    xe = torch.randn(BATCH, RES, RES, 3, device=dev, generator=gen)
    ce = torch.randn(BATCH, RES, RES, 3, device=dev, generator=gen)
    sig = torch.full((BATCH,), 1.7, device=dev)

    def edm_pass():
        with full_fp32(), torch.inference_mode():
            return edm(xe, sig, condition_img=ce)

    _build.reset_launches()
    C.forward_3x = recorder("forward_3x")
    try:
        edm_pass()
    finally:
        C.forward_3x = orig["forward_3x"]
    edm_calls = conv_calls()
    edm_sites = list(sites)
    log(f"[17] EDM pass ({BATCH} rows): {len(edm_sites)} sites; conv2d by path {edm_calls}")
    if (edm_calls["tf32x3_fwd"] != len(edm_sites) or edm_calls["plain"]
            or edm_calls["split"] != 2 * len(edm_sites)):
        raise AssertionError("the EDM pass's convolutions did not all run in 3xTF32")
    edm_pass()
    broadcast = kernel_owners(torch, edm, edm_pass, BROADCAST_KERNEL, "EDM pass", 17)

    # ---- the bits under memory pressure: the pass again with all but
    # PRESSURE_FREE bytes of the card taken, 3xTF32 and IEEE fp32 ---------------------
    def pressured(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
        filler = torch.empty(max(0, free - PRESSURE_FREE), dtype=torch.uint8, device=dev)
        try:
            return fn()
        finally:
            del filler
            torch.cuda.empty_cache()

    pressure = {"tf32x3": torch.equal(edm_pass(), pressured(edm_pass))}
    C.forward_3x = lambda x, w, b, stride, padding: F.conv2d(x, w, b, stride, padding)
    try:
        pressure["ieee"] = torch.equal(edm_pass(), pressured(edm_pass))
    finally:
        C.forward_3x = orig["forward_3x"]
    report["bit_equal_under_memory_pressure"] = pressure
    log(f"[17] EDM pass with {PRESSURE_FREE / 2**30:.1f} GiB of the card left free against "
        f"the card free: bit-equal in 3xTF32 {pressure['tf32x3']}, in IEEE fp32 (cuDNN's "
        f"FFT path, whose workspace then does not fit) {pressure['ieee']}")
    del edm

    # ---- both paths replayed on the recorded shapes -----------------------------------
    def tensor(m):
        shape, cl = m
        t = torch.randn(shape, device=dev, generator=gen)
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    def replay(site_list, train):
        """([the port's call], [IEEE fp32's call]) a site: the training
        step's forward, input gradient where the input needs one, weight
        and bias gradient (the port: forward_ieee, dgrad_3x, IEEE wgrad,
        dy.sum; IEEE: F.conv2d and the one convolution_backward its
        autograd makes), or a sampler's forward (forward_3x; F.conv2d)."""
        port, ieee = [], []
        for xm, wshape, has_b, stride, padding, need_x in site_list:
            x, w = tensor(xm), torch.randn(wshape, device=dev, generator=gen)
            b = torch.randn(wshape[0], device=dev, generator=gen) if has_b else None
            if not train:
                port.append(lambda x=x, w=w, b=b, s=stride, p=padding:
                            C.forward_3x(x, w, b, s, p))
                ieee.append(lambda x=x, w=w, b=b, s=stride, p=padding: F.conv2d(x, w, b, s, p))
                continue
            out = [(xm[0][i + 2] + 2 * padding[i] - wshape[i + 2]) // stride[i] + 1
                   for i in (0, 1)]
            dy = tensor(((xm[0][0], wshape[0], *out), True))

            def ours(x=x, w=w, b=b, s=stride, p=padding, dy=dy, need_x=need_x):
                C.forward_ieee(x, w, b, s, p)
                if need_x:
                    C.dgrad_3x(dy, x, w, s, p)
                C._backward(False, dy, x, w, s, p, (False, True, False))
                return dy.sum((0, 2, 3))

            port.append(ours)
            ieee.append(lambda x=x, w=w, b=b, s=stride, p=padding, dy=dy, need_x=need_x: (
                F.conv2d(x, w, b, s, p),
                aten.convolution_backward(dy, x, w, [w.shape[0]], s, p, (1, 1), False, (0, 0),
                                          1, (need_x, True, True))))
        return port, ieee

    def kernels_of(fn):
        """{kernel: launches} of one call of ``fn``."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {e.key: e.count for e in _device_events(torch, prof)}

    def peak_above(op):
        """Device memory one call takes beyond what it started with and
        what it returns: cuDNN's workspace (and the 3xTF32 path's parts)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        out = op()
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated() - m0
        del out
        return torch.cuda.max_memory_allocated() - m0 - kept

    timings = {}
    for what, site_list, train in (("train_step", train_sites, True),
                                   ("edm_pass", edm_sites, False)):
        port, ieee = replay(site_list, train)
        t = {"sites": len(site_list)}
        for path, ops in (("port", port), ("ieee", ieee)):
            def fn(ops=ops):
                for op in ops:
                    op()
            with full_fp32(), torch.no_grad():
                split = {}
                t[f"{path}_device_ms"] = device_ms(torch, fn, reps=2, traces=2, whole=True,
                                                   split=split)
                t[f"{path}_ms"] = cuda_ms(torch, fn, reps=2, warmup=1)
                names = kernels_of(fn)
                t[f"{path}_launches"] = sum(names.values())
                t[f"{path}_kernels"] = {k[:100]: round(v, 3) for k, v in sorted(
                    split.items(), key=lambda kv: -kv[1])[:8]}
                t[f"{path}_fft_kernels"] = sorted(k[:100] for k in names
                                                  if "fft" in k.lower() or "cf32" in k)
                peaks = sorted(peak_above(op) for op in ops)
                t[f"{path}_peak_above_bytes"] = {"max": peaks[-1],
                                                 "median": peaks[len(peaks) // 2]}
        t["speedup_device"] = t["ieee_device_ms"] / t["port_device_ms"]
        timings[what] = t
        log(f"[17] {what} convolutions ({t['sites']} sites), device ms: the port "
            f"{t['port_device_ms']:.2f} (events {t['port_ms']:.2f}, {t['port_launches']} "
            f"launches), IEEE fp32 F.conv2d and its backward (library_ms) "
            f"{t['ieee_device_ms']:.2f} (events {t['ieee_ms']:.2f}, {t['ieee_launches']} "
            f"launches): x{t['speedup_device']:.2f}; memory a site's call takes beyond its "
            f"inputs and outputs (max, median MiB): the port "
            f"{t['port_peak_above_bytes']['max'] / 2**20:.1f}, "
            f"{t['port_peak_above_bytes']['median'] / 2**20:.1f}, IEEE "
            f"{t['ieee_peak_above_bytes']['max'] / 2**20:.1f}, "
            f"{t['ieee_peak_above_bytes']['median'] / 2**20:.1f}; FFT or complex kernels: "
            f"the port {t['port_fft_kernels']}, IEEE {len(t['ieee_fft_kernels'])}")
        for path in ("port", "ieee"):
            for k, v in t[f"{path}_kernels"].items():
                log(f"      {path:4s} {v:9.3f} ms  {k}")
        if t["port_fft_kernels"] and not train:
            raise AssertionError(f"the 3xTF32 forward ran FFT kernels: "
                                 f"{t['port_fft_kernels']}")
        del port, ieee
    report["timings"] = timings
    report["step_calls"], report["edm_pass_calls"] = step_calls, edm_calls
    report["edm_broadcast_owners"] = broadcast
    if torch.backends.cudnn.allow_tf32 != flag0:
        raise AssertionError("cudnn.allow_tf32 not restored after phase 17")
    mark(17)
    return {"split": split_t, "report": report, "max_abs_err": split_err,
            "launches": {"train_step": step_calls["split"], "edm_pass": edm_calls["split"]}}


def corrdiff_phase(torch, dev, card, gen, mark):
    """Phase 18: CorrDiff at the cell's widths (see CORRDIFF_* and
    KD256_*): the kD = 256 kernel's registers and spills, (a) K2 at kD = 256
    against its plain version, (b) K1 at every distinct site of the path
    against its plain version, (c) one denoiser and one regression pass with exact
    launch counts by head width and by K1 plan, (d) K2 at the path's site
    beside its plain version, SDPA and the bound. Returns the errors, the
    timings, the launches by pass and the report."""
    import torch.nn.functional as F

    from probunet_torch.config import Config
    from probunet_torch.models.unet import build_unet_plan, gn_silu_sites
    from probunet_torch.ops import _build
    from probunet_torch.ops import attention as K2
    from probunet_torch.ops import gn_silu as K1
    from probunet_torch.ops.norm import num_groups_for
    from probunet_torch.train.loop import build_corrdiff_model

    res, tol = (CORRDIFF_RES, CORRDIFF_RES), ATTN_TOL["strict"]
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    report = {"card": card, "kd256_kernels": f32_kernel_info(torch, K2, 256, 18)}

    # ---- (a) K2 at kD = 256 against its plain version --------------------------------
    worst = {"out": 0.0, "lse": 0.0}
    for b, L, nh, c in KD256_CASES:
        for layout in LAYOUTS:
            q, k, v = qkv_views(torch, layout, b, L, nh, torch.float32, dev, gen, c)
            _build.reset_launches()
            with torch.inference_mode():
                out = K2.fused_attention(q, k, v)
                again = K2.fused_attention(q, k, v)
                ref = K2._plain_attention(q, k, v, False)
                _, lse = K2._launch(*map(K2.kernel_layout, (q, k, v)), with_lse=True, c=c)
                ref_lse = torch.logsumexp(
                    torch.einsum("bqhc,bkhc->bhqk", q, k) / math.sqrt(c), -1).reshape(b * nh, L)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            same = torch.equal(out, again)
            n = _build.launches("attention_fwd", "fp32", 256)
            ok = (torch.allclose(out, ref, atol=tol, rtol=tol) and lse_err <= tol and same
                  and n == 3 and out.shape == (b, L, nh, c))
            worst = {"out": max(worst["out"], err), "lse": max(worst["lse"], lse_err)}
            log(f"[18] K2 fp32 kD 256 {layout:10s} B={b} L={L} heads={nh} c={c}: max abs err "
                f"O {err:.3e}, lse {lse_err:.3e} (tol {tol}), two calls bit-equal {same}, "
                f"fp32_kd256 launches {n} of 3 {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("K2 at kD = 256 disagrees with its plain version, two "
                                     "calls differ, or its launches were not counted")
    report["kd256_max_abs_err"] = worst
    mark(18)

    # ---- (b) K1 at every distinct site of the path -------------------------------------
    enc, dec, final_c = build_unet_plan(res, 6, 128, (1, 2, 2, 2, 2), 4, (28,), True, True)
    plan_sites = gn_silu_sites(enc, dec, final_c, res)

    def by_plan(rows):
        on = [K1.plan(rows, *s, num_groups_for(s[2]), 4, num_sms).on_chip for s in plan_sites]
        return {"on_chip": sum(on), "streamed": len(on) - sum(on)}

    sites = sorted(set(plan_sites))
    atol, rtol = GN_TOL["float32"]
    k1_worst = 0.0
    for rows in (CORRDIFF_ROWS, 1):
        for h, w, c in sites:
            g = num_groups_for(c)
            p = K1.plan(rows, h, w, c, g, 4, num_sms)
            x = torch.randn(rows, h, w, c, device=dev, generator=gen) + 0.5
            gamma = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
            beta = 0.1 * torch.randn(c, device=dev, generator=gen)
            # unmodulated (norm0, the aux_norm) and with the block's shift added (norm1)
            shift = 0.5 * torch.randn(rows, c, device=dev, generator=gen)
            for mod, kw in (("none", {}), ("shift_in", {"shift_in": shift})):
                with torch.inference_mode():
                    out = K1.gn_silu(x, gamma, beta, g, 1e-6, **kw)
                    again = K1.gn_silu(x, gamma, beta, g, 1e-6, **kw)
                    ref = K1._plain_gn_silu(x, gamma, beta, g, 1e-6, **kw)[0]
                torch.cuda.synchronize()
                d = (out - ref).abs()
                same = torch.equal(out, again)
                ok = bool((d <= atol + rtol * ref.abs()).all()) and same
                k1_worst = max(k1_worst, d.max().item())
                log(f"[18] K1 {mod} fp32 {rows}x{h}x{w}x{c} G={g} eps 1e-6 (cb {p.cb}, cluster "
                    f"{p.n}, {p.rows} rows/block, {'on chip' if p.on_chip else 'streamed'}): max "
                    f"abs err {d.max().item():.3e} (atol {atol}, rtol {rtol:.3g}), two calls "
                    f"bit-equal {same} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("K1 at a CorrDiff site disagrees with its plain "
                                         "version, or two calls differ")
                del out, again, ref, d
            del x
    report["k1_sites"] = [list(s) for s in sites]
    report["k1_max_abs_err"] = k1_worst
    mark(18)

    # ---- (c) the path: one denoiser pass, one regression pass --------------------------
    cfg = Config(ds_model="corrdiff", resolution=res, model_channels=128,
                 channel_mult=(1, 2, 2, 2, 2), num_blocks=4, attn_resolutions=(28,))
    model = build_corrdiff_model(cfg, device="meta").to_empty(device=dev).eval()
    fill_weights(torch, model, seed=18)
    nparams = sum(p.numel() for p in model.parameters())
    r = torch.randn(CORRDIFF_ROWS, *res, cfg.nvars, device=dev, generator=gen)
    cond = torch.randn(CORRDIFF_ROWS, *res, cfg.nvars, device=dev, generator=gen)
    sigma = torch.full((CORRDIFF_ROWS,), 1.0, device=dev)
    gn_sites, attn_sites = census(torch, model, lambda: model(r, sigma, condition_img=cond))
    log(f"[18] CorrDiff: two {res[0]}x{res[1]} DDPM++ U-Nets, {nparams:,} parameters; a pass "
        f"has {len(gn_sites)} K1 sites ({len(sites)} distinct shapes) and attention "
        f"sites (L, heads) {sorted(set(attn_sites))} x {len(attn_sites)}")
    if (nparams != CORRDIFF_PARAMS or sorted(gn_sites) != sorted(plan_sites)
            or len(gn_sites) != CORRDIFF_K1_PER_PASS
            or attn_sites != [(784, 1)] * CORRDIFF_K2_PER_PASS):
        raise AssertionError(f"expected {CORRDIFF_PARAMS:,} parameters, the plan's "
                             f"{CORRDIFF_K1_PER_PASS} K1 sites and {CORRDIFF_K2_PER_PASS} "
                             f"attention sites of (784, 1)")
    passes, launches = {}, {}
    for name, rows, fn in (
            ("denoiser_pass", CORRDIFF_ROWS, lambda: model(r, sigma, condition_img=cond)),
            ("regression_pass", 1, lambda: model.regression(cond[:1]))):
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = tuple(map(_build.launches, COUNTED))
            kd256 = _build.launches("attention_fwd", "fp32", 256)
            plans = {k: _build.launches("gn_silu", k) for k in ("on_chip", "streamed")}
            mods = {k: _build.launches("gn_silu", k) for k in K1.MODS}
            device = profile(torch, fn, f"CorrDiff {name.replace('_', ' ')} at {rows} rows",
                             "one pass", phase=18, top=8)
            owners = kernel_owners(torch, model, fn, BROADCAST_KERNEL,
                                   f"CorrDiff {name.replace('_', ' ')}", 18)
        want = (CORRDIFF_K1_PER_PASS, CORRDIFF_K2_PER_PASS, 0, 0)
        want_plan = by_plan(rows)
        want_mods = {k: CORRDIFF_K1_MOD_PER_PASS.get(k, 0) for k in K1.MODS}
        finite = bool(torch.isfinite(out).all())
        launches[name] = dict(zip(KERNELS, n))
        passes[name] = {"rows": rows, "ms": wall * 1e3, "device_ms": device,
                        "launches": {**launches[name], "copies": n[3]}, "fp32_kd256": kd256,
                        "k1_by_plan": plans, "k1_by_mod": mods, "broadcast_owners": owners}
        log(f"[18] {name} at {rows} rows: {wall * 1e3:.1f} ms (device {device} ms), output "
            f"{tuple(out.shape)}, finite {finite}; launches K1 {n[0]}, K2 {n[1]}, K3 {n[2]}, "
            f"copies {n[3]} (expected {want}); K2 at fp32 kD 256 {kd256} (expected "
            f"{CORRDIFF_K2_PER_PASS}); K1 by plan {plans} (expected {want_plan}), by modulation "
            f"{mods} (expected {want_mods}) ({card})")
        if (n != want or kd256 != CORRDIFF_K2_PER_PASS or plans != want_plan or not finite
                or mods != want_mods
                or tuple(out.shape) != (rows, *res, cfg.nvars)):
            raise AssertionError(f"CorrDiff's {name}: launches or output are off")
        del out
    report["passes"] = passes
    del model
    mark(18)

    # ---- (d) K2 at the path's site, timed ----------------------------------------------
    b, L, nh, c = KD256_SITE
    q, k, v = qkv_views(torch, "block", b, L, nh, torch.float32, dev, gen, c)
    qs, ks, vs = (a.permute(0, 2, 1, 3).contiguous() for a in (q, k, v))

    def run():
        return K2.fused_attention(q, k, v)

    def plain():
        return K2._plain_attention(q, k, v, False)

    def lib():
        return F.scaled_dot_product_attention(qs, ks, vs)

    with torch.inference_mode():
        _build.reset_launches()
        t = {"ms": cuda_ms(torch, run), "device_ms": device_ms(torch, run, whole=True),
             "plain_ms": cuda_ms(torch, plain), "plain_device_ms": device_ms(torch, plain,
                                                                            whole=True),
             "library_ms": cuda_ms(torch, lib), "library_device_ms": device_ms(torch, lib,
                                                                              whole=True)}
        if _build.launches("kernel_layout"):
            raise AssertionError("the block's q/k/v views were copied")
    flops = 4.0 * b * nh * L * L * c
    t.update(attn_bound(flops, 4.0 * b * L * nh * c * 4, "strict"))
    attn_totals(t, flops)
    t["pass_device_ms"] = CORRDIFF_K2_PER_PASS * t["device_ms"]
    log(f"[18] K2 fp32 kD 256 at B={b} L={L} heads={nh} c={c} (block views): kernel "
        f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}, {t['bound_share_device']:.1%} of the "
        f"bound; a pass of {CORRDIFF_K2_PER_PASS} {t['pass_device_ms']:.4f}), plain "
        f"{t['plain_ms']:.4f} (device {t['plain_device_ms']:.4f}), SDPA {t['library_ms']:.4f} "
        f"(device {t['library_device_ms']:.4f}), bound {t['bound_ms']:.5f} ({t['bound_rule']}, "
        f"{t['bound_by']}); {t['device_tflops']:.1f} TFLOP/s by device time ({card})")
    mark(18)
    return {"k2_err": worst, "k1_err": k1_worst, "k2_t": t, "launches": launches,
            "report": report}


def adamw_phase(torch, dev, card, mark):
    """Phase 19: the bf16 AdamW update on the 128x128 prob-U-Net's parameter
    list (EXPECTED_PARAMS, in the model's own layouts: channels_last
    convolution weights): the kernel's threads, registers and spills (none
    allowed); ADAMW_STEPS updates by ``AdamWBf16State`` (the fused launch)
    against ``adamw_bf16._plain_update`` (the foreach path) on a copy with
    the same gradients, p, mu and nu bit-equal after each, one launch a
    step; then both timed alone, device time and CUDA events, and the
    host's ms a call (the fused one builds and writes its table each call),
    beside the bytes bound. Returns the kernel's entry fields."""
    from probunet_torch.config import Config
    from probunet_torch.ops import _build
    from probunet_torch.ops import adamw_bf16 as A
    from probunet_torch.train.loop import build_probunet
    from probunet_torch.train.state import AdamWBf16State

    out = (ctypes.c_int * 5)()
    _build.check(_build.lib().probunet_adamw_bf16_query(out), "adamw_bf16 query")
    info = dict(zip(("threads", "registers", "spill_bytes", "chunk", "blocks_per_sm"), out))
    log(f"[19] adamw_bf16 kernel: {info['threads']} threads, {info['registers']} registers, "
        f"{info['spill_bytes']} bytes spilled, chunks of {info['chunk']}, "
        f"{info['blocks_per_sm']} blocks an SM")
    if info["spill_bytes"]:
        raise AssertionError("the adamw_bf16 kernel spills")

    model = build_probunet(Config(coords=(0, RES, 0, RES), resolution=(RES, RES)),
                           device="meta").to_empty(device=dev)
    fill_weights(torch, model)
    params = list(model.parameters())
    n = sum(p.numel() for p in params)
    if n != EXPECTED_PARAMS:
        raise AssertionError(f"expected {EXPECTED_PARAMS:,} parameters, got {n:,}")
    layouts = {"tensors": len(params), "channels_last": sum(not p.is_contiguous() for p in params)}
    gen = torch.Generator(device=dev).manual_seed(19)
    ref = [p.detach().clone() for p in params]
    ref_states = [{"mu": torch.zeros_like(r, dtype=torch.bfloat16),
                   "nu": torch.zeros_like(r, dtype=torch.float32)} for r in ref]
    for p, r in zip(params, ref):
        p.grad = torch.empty_like(p)
        r.grad = p.grad
    h = ADAMW_HYPER
    opt = AdamWBf16State(params, lr=h["lr"], betas=(h["b1"], h["b2"]), eps=h["eps"],
                         weight_decay=h["weight_decay"])

    def plain(count):
        A._plain_update(ref, ref_states, h["b1"], h["b2"], 1 - h["b1"] ** count,
                        1 - h["b2"] ** count, h["eps"], h["weight_decay"], h["lr"])

    _build.reset_launches()
    for step in range(1, ADAMW_STEPS + 1):
        for p in params:
            p.grad.normal_(generator=gen)
        opt.step()
        plain(step)
        torch.cuda.synchronize()
        same = [all(torch.equal(a, b) for a, b in pairs) for pairs in (
            zip(params, ref), ((opt.state[p]["mu"], st["mu"]) for p, st in zip(params, ref_states)),
            ((opt.state[p]["nu"], st["nu"]) for p, st in zip(params, ref_states)))]
        log(f"[19] step {step} on {n:,} parameters in {layouts['tensors']} tensors "
            f"({layouts['channels_last']} channels_last): fused against foreach bit-equal "
            f"p {same[0]}, mu {same[1]}, nu {same[2]}")
        if not all(same):
            raise AssertionError("the fused AdamW update differs from the foreach path")
    launches = {k: _build.launches("adamw_bf16", k) for k in ("fused", "foreach")}
    log(f"[19] launches over {ADAMW_STEPS} steps: {launches}")
    if launches != {"fused": ADAMW_STEPS, "foreach": 0}:
        raise AssertionError(f"expected one fused launch a step, got {launches}")

    def host_ms(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / reps * 1e3

    nbytes = ADAMW_BYTES * n
    t = {"bound_ms": nbytes / peak_rates()["hbm_bytes_per_s"] * 1e3, "bound_by": "bytes",
         "library_ms": None, "bytes": nbytes,
         "ms": cuda_ms(torch, opt.step), "device_ms": device_ms(torch, opt.step, whole=True),
         "host_ms": host_ms(opt.step, 20),
         "plain_ms": cuda_ms(torch, lambda: plain(ADAMW_STEPS), reps=5, warmup=1),
         "plain_device_ms": device_ms(torch, lambda: plain(ADAMW_STEPS), reps=3, traces=3,
                                      whole=True),
         "plain_host_ms": host_ms(lambda: plain(ADAMW_STEPS), 5)}
    t["bound_share_device"] = t["bound_ms"] / t["device_ms"]
    t["device_tb_per_s"] = nbytes / t["device_ms"] / 1e9
    log(f"[19] adamw_bf16 on {n:,} parameters: kernel {t['ms']:.4f} ms by events (device "
        f"{t['device_ms']:.4f}, {t['device_tb_per_s']:.2f} TB/s), host {t['host_ms']:.3f} ms a "
        f"call; foreach {t['plain_ms']:.3f} ms (device {t['plain_device_ms']:.3f}), host "
        f"{t['plain_host_ms']:.3f} ms a call; bound {t['bound_ms']:.4f} ms ({nbytes / 1e9:.3f} "
        f"GB at HBM), {100 * t['bound_share_device']:.1f} % of it")
    del opt, model, params, ref, ref_states
    mark(19)
    return {"t": t, "info": info, "layouts": layouts, "launches": launches}


def dropout_phase(torch, dev, card, mark):
    """Phase 20: dropout's compare, scale and select (``csrc/dropout.cu``)
    at DROPOUT_SITES: the instantiations' resources (no spill allowed); at
    each site the kernel path (``ops/dropout.apply``, one launch each way)
    against the plain chain (``ops/dropout.plain`` and its autograd
    backward), output and input gradient bit-equal; then the kernel alone
    each way (the wrapper's launch on preallocated operands) and the plain
    chain each way (compare, divide and select; select and divide), by
    device time and CUDA events, beside the bytes the kernel needs: element
    forward u, x, y and the mask's bits, backward the bits, dy and dx; row
    mode x of the kept rows, y and the (B, 1) uniforms. Returns the entry's
    fields."""
    from probunet_torch.models.layers import nchw
    from probunet_torch.ops import _build
    from probunet_torch.ops import dropout as D

    info = {}
    for dtype in ("float32", "bfloat16"):
        for mode, code in (("element_fwd", D.ELEMENT_FWD), ("element_bwd", D.ELEMENT_BWD),
                           ("row", D.ROW)):
            out = (ctypes.c_int * 5)()
            _build.check(_build.lib().probunet_dropout_query(int(dtype == "bfloat16"), code, out),
                         "dropout query")
            info[f"{dtype}_{mode}"] = dict(zip(("threads", "registers", "spill_bytes",
                                                "blocks_per_sm", "max_blocks"), out))
    for name, i in info.items():
        log(f"[20] dropout kernel {name}: {i['threads']} threads, {i['registers']} registers, "
            f"{i['spill_bytes']} bytes spilled, {i['blocks_per_sm']} blocks an SM, grid at most "
            f"{i['max_blocks']} blocks")
    if any(i["spill_bytes"] for i in info.values()):
        raise AssertionError("a dropout kernel spills")

    keep = 1.0 - DROPOUT_RATE
    hbm = peak_rates()["hbm_bytes_per_s"]
    gen = torch.Generator(device=dev).manual_seed(20)
    sites, launches = {}, 0
    for name, shape, dtype_name, mode in DROPOUT_SITES:
        dtype = getattr(torch, dtype_name)
        size = dtype.itemsize
        if len(shape) == 4:   # NCHW channels_last, u the NCHW view of the NHWC draw
            b, c, h, w = shape
            x, u, dy = (nchw(t) for t in (
                torch.randn(b, h, w, c, device=dev, generator=gen).to(dtype),
                torch.rand(b, h, w, c, device=dev, generator=gen),
                torch.randn(b, h, w, c, device=dev, generator=gen).to(dtype)))
        else:
            x = torch.randn(shape, device=dev, generator=gen).to(dtype)
            dy = torch.randn(shape, device=dev, generator=gen).to(dtype)
            u = torch.rand(shape if mode == "element" else (shape[0], 1), device=dev,
                           generator=gen)
        n = x.numel()
        _build.reset_launches()
        xi, rx = x.clone().requires_grad_(), x.clone().requires_grad_()
        y = D.apply(xi, u, keep)
        y.backward(dy)
        ref = D.plain(rx, u, keep)
        ref.backward(dy)
        torch.cuda.synchronize()
        view = torch.int16 if dtype == torch.bfloat16 else torch.int32
        same = {"y": torch.equal(y.detach().view(view), ref.detach().view(view)),
                "dx": torch.equal(xi.grad.view(view), rx.grad.view(view))}
        counted = {key: _build.launches("dropout", *key.split("_", 1)) for key in
                   (f"fwd_{mode}", f"bwd_{mode}")}
        counted["copies"] = _build.launches("dropout", "u_copy") + _build.launches("dropout",
                                                                                 "dy_copy")
        launches += _build.launches("dropout")
        del xi, rx, y, ref
        log(f"[20] {name} {tuple(shape)} {dtype_name} {mode}: kernel against the plain chain "
            f"bit-equal {same}, launches {counted}")
        if not all(same.values()) or counted != {f"fwd_{mode}": 1, f"bwd_{mode}": 1,
                                                 "copies": 0}:
            raise AssertionError(f"dropout kernel at {name}: bits {same}, launches {counted}")

        zero = torch.zeros((), dtype=dtype, device=dev)
        if mode == "element":
            bits = D._mask_words(n, dev)
            mask = u < keep
            kernel = {"fwd": lambda: D._launch(x, u, bits, keep, D.ELEMENT_FWD),
                      "bwd": lambda: D._launch(dy, None, bits, keep, D.ELEMENT_BWD)}
            need = {"fwd": n * (4 + 2 * size) + bits.numel() * 4,
                    "bwd": n * 2 * size + bits.numel() * 4}
        else:
            bits = None
            mask = u.reshape(shape[0], *(1,) * (len(shape) - 1)) < keep
            kept = int((u < keep).sum())
            kernel = {"fwd": lambda: D._launch(x, u, None, keep, D.ROW),
                      "bwd": lambda: D._launch(dy, u, None, keep, D.ROW)}
            need = {d: n * size * (1 + kept / shape[0]) + 4 * shape[0] for d in ("fwd", "bwd")}
        plain = {"fwd": lambda: D.plain(x, u, keep),
                 "bwd": lambda: torch.where(mask, dy, zero) / keep}
        reps = 10 if n > 2 ** 27 else 50
        site = {"shape": list(shape), "dtype": dtype_name, "mode": mode, "elements": n,
                "bit_equal": same}
        for d in ("fwd", "bwd"):
            t = {"bytes": need[d], "bound_ms": need[d] / hbm * 1e3, "bound_by": "bytes",
                 "library_ms": None,
                 "ms": cuda_ms(torch, kernel[d], reps=reps),
                 "device_ms": device_ms(torch, kernel[d], reps=reps, traces=3, whole=True),
                 "plain_ms": cuda_ms(torch, plain[d], reps=reps),
                 "plain_device_ms": device_ms(torch, plain[d], reps=reps, traces=3, whole=True)}
            t["bound_share_device"] = t["bound_ms"] / t["device_ms"]
            t["device_tb_per_s"] = need[d] / t["device_ms"] / 1e9
            site[d] = t
            log(f"[20] {name} {d}: kernel {t['ms']:.4f} ms by events (device "
                f"{t['device_ms']:.4f}, {t['device_tb_per_s']:.2f} TB/s, "
                f"{100 * t['bound_share_device']:.1f} % of the {t['bound_ms']:.4f} ms bound, "
                f"{need[d] / 1e9:.3f} GB); plain chain {t['plain_ms']:.4f} ms (device "
                f"{t['plain_device_ms']:.4f}) ({card})")
        sites[name] = site
        del x, u, dy, bits, mask
        torch.cuda.empty_cache()

    # the host's time a call, forward and backward through autograd, of the
    # kernel path and of the plain chain it replaced: the issuing alone (the
    # clock stops before the sync), the median over 5 batches of calls
    b, c, h, w = DROPOUT_HOST_SITE
    x = torch.randn(b, c, h, w, device=dev, generator=gen).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    dy = torch.randn_like(x)
    u = nchw(torch.rand(b, h, w, c, device=dev, generator=gen))

    def host_us(fn):
        fn()
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DROPOUT_HOST_REPS):
                fn()
            runs.append((time.perf_counter() - t0) / DROPOUT_HOST_REPS * 1e6)
        torch.cuda.synchronize()
        return sorted(runs)[2]

    host = {"site": list(DROPOUT_HOST_SITE),
            "kernel_us": host_us(lambda: torch.autograd.grad(D.apply(x, u, keep), x, dy)),
            "plain_us": host_us(lambda: torch.autograd.grad(D.plain(x, u, keep), x, dy))}
    host["per_step_ms"] = DROPOUT_PER_STEP * (host["kernel_us"] - host["plain_us"]) / 1e3
    log(f"[20] host time a call, forward and backward, at {DROPOUT_HOST_SITE} fp32: kernel path "
        f"{host['kernel_us']:.1f} us, plain chain {host['plain_us']:.1f} us; over the "
        f"{DROPOUT_PER_STEP} sites of a U-Net training step {host['per_step_ms']:+.3f} ms ({card})")
    mark(20)
    return {"sites": sites, "info": info, "launches": launches, "host": host}


def mc96_by_kd(K2, bf16, passes):
    """K2's (or K3's) launches by (dtype, head width) over ``passes`` U-Net
    passes of the model_channels 96 path, bf16 or fp32: its 32x32 sites (4
    heads of 72) on the bf16 kernels' kD = 80 or the fp32 kernels' 128, its
    16x16 sites (6 of 64) on kD = 64."""
    out = {}
    for (L, nh, c), n in MC96_SITES.items():
        w = K2.kernel_width(c)
        key = ("bf16", K2._kd(w)) if bf16 else ("fp32", K2._fp32_kd(w))
        out[key] = out.get(key, 0) + n * passes
    return out


@contextlib.contextmanager
def kd128_shape(K2, kd):
    """K2 at head width ``kd`` takes kD = 128's block shape (64-row blocks
    and K/V tiles) inside the block."""
    real = K2.plan

    def plan(b, heads, L, num_sms, kd_=64):
        p = real(b, heads, L, num_sms, kd_)
        return p._replace(fwd_rows=64, fwd_tile=64) if kd_ == kd else p

    K2.plan = plan
    try:
        yield
    finally:
        K2.plan = real


def exact_vs_kd128(torch, K2, q, k, v, do, fast, c):
    """The largest differences of the exact-width bf16 kernels (kD = 80 / 96
    at 64 < c <= 96) from the kD = 128 ones on the same inputs: K2 at its
    own plan (whose K/V tiles may be 128 rows, so the online softmax
    rescales at other bounds), K2 at kD = 128's block shape, and K3 on the
    same forward output and lse (both expected 0: the columns past c and
    the k16 steps past the head add exact zeros)."""
    kd = K2._kd(K2.kernel_width(c))
    kq, kk, kv, kdo = map(K2.kernel_layout, (q, k, v, do))
    with torch.no_grad():
        own = K2._launch(kq, kk, kv, True, c=c)
        wide = K2._launch(kq, kk, kv, True, c=c, kd=128)
        with kd128_shape(K2, kd):
            same = K2._launch(kq, kk, kv, True, c=c)
        g = K2._launch_bwd(kq, kk, kv, wide[0], wide[1], kdo, fast, c)
        g128 = K2._launch_bwd(kq, kk, kv, wide[0], wide[1], kdo, fast, c, kd=128)

    def diff(a, b):
        return (a.float() - b.float()).abs().max().item()

    return {"k2_own_plan": max(diff(own[0], wide[0]), diff(own[1], wide[1])),
            "k2_kd128_shape": max(diff(same[0], wide[0]), diff(same[1], wide[1])),
            "k3_same_inputs": max(diff(x, y) for x, y in zip(g, g128))}


def max_rel(a, b):
    """max |a - b| / max |b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def worst_grad(got, ref, default="none"):
    """(max over tensors of max|got - ref| / max|ref|, that tensor's name);
    an all-zero reference counts its absolute error."""
    worst, name = 0.0, default
    for k, r in ref.items():
        scale = r.abs().max().item()
        err = (got[k] - r).abs().max().item()
        e = err / scale if scale else err
        if e > worst:
            worst, name = e, k
    return worst, name


def rms_rel(got, ref):
    """||got - ref||_2 / ||ref||_2 in fp32."""
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def plain_dq_dk(torch, q, k, v, out, do, fast):
    """dq, dk of the plain backward on bf16 q/k/v/dO with fp32 dS (rounded
    to bf16 when ``fast``), and with D = rowsum(dO o O) taken from K2's
    output ``out`` as K3 takes it: the plain version's D, rowsum(dP o P) in
    fp32, parts from it by ~1e-3 in these legs, as much as rounding dS."""
    qf, kf, vf, dof = (a.float() for a in (q, k, v, do))
    c = q.shape[-1]
    r = math.sqrt(c)   # 8 at c = 64
    p = torch.softmax(torch.einsum("bqhc,bkhc->bhqk", qf, kf / r), dim=-1)
    dp = torch.einsum("bqhc,bkhc->bhqk", dof, vf)
    ds = p * (dp - (dof * out.float()[..., :c]).sum(-1).transpose(1, 2)[..., None])
    if fast:
        ds = ds.to(q.dtype).float()
    return (torch.einsum("bhqk,bkhc->bqhc", ds, kf).div(r).to(q.dtype),
            torch.einsum("bhqk,bqhc->bkhc", ds, qf).div(r).to(q.dtype))


def split_ds_check(torch, K2, q, k, v, out, lse, do, got, ref, seen, case, phase=7):
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
    log(f"[{phase}] K3 strict_bf16 {case}: dq/dk ||err|| / ||ref|| against the plain strict "
        f"backward with K3's D {err:.3e} (limit {DS_SPLIT_TOL}); with dS rounded to bf16 "
        f"{err_rounded:.3e} (kernel, fast mode), {gap:.3e} (plain); the kernel against "
        f"_plain_attention_bwd {err_plain:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the dS check does not separate strict_bf16 from rounded dS")


def dropout_counts(_build):
    """Dropout's launches and copies since the last reset of the counter."""
    got = {f"{d}_{m}": _build.launches("dropout", d, m)
           for d in ("fwd", "bwd") for m in ("element", "row")}
    return {**got, **{k: _build.launches("dropout", k) for k in ("u_copy", "dy_copy")}}


def dropout_check(phase, path, got, steps, remat=False, copied=False):
    """Whether ``got`` (:func:`dropout_counts`) is what ``steps`` training
    steps of DROPOUT_PER_STEP element sites launch: one launch each way a
    site, two forwards where remat recomputes every block, no row launch,
    no gradient copied, and each forward's uniforms copied where
    ``copied`` (a spatial rank's H rows of the draw). Logs the counts and
    keeps them in DROPOUT_BY_PATH under ``path``."""
    fwd = steps * DROPOUT_PER_STEP * (2 if remat else 1)
    want = {"fwd_element": fwd, "bwd_element": steps * DROPOUT_PER_STEP, "fwd_row": 0,
            "bwd_row": 0, "u_copy": fwd if copied else 0, "dy_copy": 0}
    ok = got == want
    DROPOUT_BY_PATH[path] = got
    log(f"[{phase}] {path}: dropout {got}, expected {want} ({steps} steps of "
        f"{DROPOUT_PER_STEP} sites{', remat' if remat else ''}) {'ok' if ok else 'FAIL'}")
    return ok


def _counts(sites):
    out = {}
    for s in sites:
        out[s] = out.get(s, 0) + 1
    return out


def profile(torch, fn, name, what, phase=6, top=12):
    """Device time of one call of ``fn`` by kernel name (torch.profiler),
    logged; returns the total in ms (None if the trace holds none).
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
        return None
    log(f"[{phase}] profile {name}: device time {total / 1e3:.2f} ms in {what}; top kernels:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"      {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:90]}")
    return total / 1e3


def kernel_owners(torch, model, fn, pattern, name, phase, top=8):
    """Device ms of one call of ``fn`` in the kernels whose name holds
    ``pattern``, by what launched them: the innermost module of ``model``
    (each module's forward a profiler range while this runs) and the ATen
    ops from that module down to the launching op (torch.profiler's op
    tree). Logged; returns {"module: op > ... > op": ms}."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    open_, hooks = [], []

    def enter(mod, args):
        open_.append(record_function(f"module::{type(mod).__name__}"))
        open_[-1].__enter__()

    def leave(mod, args, out):
        open_.pop().__exit__(None, None, None)

    for m in model.modules():
        hooks += [m.register_forward_pre_hook(enter), m.register_forward_hook(leave)]
    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    owners = {}
    for e in prof.events():
        us = sum(k.duration for k in e.kernels if pattern in k.name)
        if not us:
            continue
        ops, p = [e.name], e.cpu_parent
        while p is not None and not p.name.startswith("module::"):
            ops.append(p.name)
            p = p.cpu_parent
        key = f"{p.name[8:] if p is not None else '(no module)'}: {' > '.join(reversed(ops))}"
        owners[key] = owners.get(key, 0.0) + us / 1e3
    total = sum(owners.values())
    log(f"[{phase}] {name}: {total:.3f} ms device in kernels named '{pattern}', by owner:")
    for key, ms in sorted(owners.items(), key=lambda kv: -kv[1])[:top]:
        log(f"      {ms:9.3f} ms  {ms / total if total else 0:6.1%}  {key[:110]}")
    return owners


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--mp-rank":   # a rank child of phase 14
        sys.exit(mp_rank(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--sp-rank":   # a rank child of phase 15
        sys.exit(sp_rank(sys.argv[2]))
    sys.exit(main())
