#!/usr/bin/env python3
"""Time variants of the bf16 attention kernels K2 and K3 at their exact head
widths (kD = 80 / 96, ``probunet_torch/csrc/attention_{fwd,bwd}.cu``)
beside the checkout's own, built side by side and timed in one process on
one CUDA card.

    python3 scripts/torch_attn_variants.py [--variants no_tail,overlap_dv,dq_three_blocks]

Each variant is the checkout's ``csrc`` with one edit, built with the
library's own nvcc flags into ``build/attn_variants/<name>/`` (every
source by its own nvcc, all at once) and loaded in place of the library:

  * ``no_tail``: the output products on the tail atom (O += P V, dV, dK,
    dQ over columns 64 .. kD - 1, the m64nTk16 wgmmas) left out. Its
    results are wrong past column 63; it shows what those products cost.
  * ``overlap_dv``: the dK/dV kernel issues dV += P^T dO as soon as P^T is
    in registers and forms dS while it runs, then issues dK.
  * ``dq_three_blocks``: the dQ kernel at kD = 80 / 96 streams two stages
    (62 / 75 KB a block) and asks ptxas for three blocks an SM.

The checkout's kernels (``base``) are timed first and last, the variants
between. At each site (b8: the model_channels 96 path's L=1024 with 4
heads of 72, L=1024 with 4 heads of 96, the default path's L=1024 with 6
heads of 64): K2 fast and K3 fast and with dS split, device time from
torch.profiler (chip_smoke.py's estimator), K3 split by kernel, and the
largest difference from ``base``. Prints each kernel's registers and
spills, and ptxas's wgmma serialization warnings. The last line is a JSON
object of the timings.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from probunet_torch.ops import _build  # noqa: E402
from probunet_torch.ops import attention as K2  # noqa: E402

SITES = [(1024, 4, 72), (1024, 4, 96), (1024, 6, 64)]


def _edit(path, old, new, count=1):
    src = open(path).read()
    if src.count(old) != count:
        raise AssertionError(f"{os.path.basename(path)}: expected {count} of {old[:60]!r}")
    open(path, "w").write(src.replace(old, new))


def no_tail(csrc):
    bwd, fwd = os.path.join(csrc, "attention_bwd.cu"), os.path.join(csrc, "attention_fwd.cu")
    src = open(bwd).read()
    lines = [ln for ln in src.splitlines(keepends=True) if "mma_rs_tail<64, kTl>" in ln]
    if len(lines) != 5:
        raise AssertionError(f"attention_bwd.cu: expected 5 tail products, found {len(lines)}")
    open(bwd, "w").write("".join(ln for ln in src.splitlines(keepends=True)
                                 if "mma_rs_tail<64, kTl>" not in ln))
    _edit(fwd, "        Wgmma<kT>::rs_t(acc_t, pa[k], dv_t[0] + k * desc_mn_tail_step<kT>);",
          '        asm volatile("");')
    _edit(fwd, "  if constexpr (kT != 0) mma_rs_tail<BN, kT>(acc_t, pa, "
               "tail<KD>(Vs(j % kFwdStages), BN));\n", "")


def overlap_dv(csrc):
    path = os.path.join(csrc, "attention_bwd.cu")
    _edit(path, """    if constexpr (kDK) {
      reg_fence(ds);
      grads<SPLIT>(""", """    if constexpr (PASS == kPassBoth) {
      reg_fence(ds);
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = exp2_fast(fmaf(p[i], c, -lse2(i)));
      to_a<64>(p, pa);
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < kA; ++a) mma_rs<64>(dv_acc[a], pa, atom(dOs(s), a, 64));
      if constexpr (kTl != 0) mma_rs_tail<64, kTl>(dv_t, pa, tail<KD>(dOs(s), 64));
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < 32; ++i) ds[i] = p[i] * (ds[i] - st[64 + 8 * (i / 4) + 2 * t + i % 2]);
      if constexpr (SPLIT) to_a<64>(ds, hi, lo);
      else to_a<64>(ds, hi);
    } else if constexpr (kDK) {
      reg_fence(ds);
      grads<SPLIT>(""")
    _edit(path, """    if constexpr (kDV) {
#pragma unroll
      for (int a = 0; a < kA; ++a) mma_rs<64>(dv_acc[a], pa, atom(dOs(s), a, 64));""",
          """    if constexpr (kDV && PASS != kPassBoth) {
#pragma unroll
      for (int a = 0; a < kA; ++a) mma_rs<64>(dv_acc[a], pa, atom(dOs(s), a, 64));""")


def dq_three_blocks(csrc):
    path = os.path.join(csrc, "attention_bwd.cu")
    _edit(path, "template <int NWG, bool STATS, int KD> struct BwdSmem {\n",
          "template <int NWG, bool STATS, int KD> struct BwdSmem {\n"
          "  static constexpr int kBwdStages = !STATS && kTail<KD> != 0 ? 2 : sm90::kBwdStages;\n")
    for old, new in (
            ("  own_full = reinterpret_cast<uint64_t*>(smem + BwdSmem<NWG, STATS, KD>::bars);",
             "  constexpr int kBwdStages = BwdSmem<NWG, STATS, KD>::kBwdStages;\n"
             "  own_full = reinterpret_cast<uint64_t*>(smem + BwdSmem<NWG, STATS, KD>::bars);"),
            ("  constexpr int kT = Smem::kT;\n  mbar_expect_tx(own_full",
             "  constexpr int kT = Smem::kT, kBwdStages = Smem::kBwdStages;\n"
             "  mbar_expect_tx(own_full"),
            ("  constexpr int kT = Smem::kT, kA = kAtoms<KD>, kTl = kTail<KD>;\n  extern __shared__"
             " unsigned char smem_raw[];\n  unsigned char* smem = align1024(smem_raw);\n  uint64_t"
             " *own_full, *full, *empty;\n  bwd_barriers<NWG, false, KD>",
             "  constexpr int kT = Smem::kT, kA = kAtoms<KD>, kTl = kTail<KD>;\n"
             "  constexpr int kBwdStages = Smem::kBwdStages;\n  extern __shared__"
             " unsigned char smem_raw[];\n  unsigned char* smem = align1024(smem_raw);\n  uint64_t"
             " *own_full, *full, *empty;\n  bwd_barriers<NWG, false, KD>"),
            ("__global__ void __launch_bounds__(kBlockThreads<NWG>, 1)\n"
             "    attention_bwd_dq_sm90(",
             "__global__ void __launch_bounds__(kBlockThreads<NWG>, kTail<KD> != 0 ? 3 : 1)\n"
             "    attention_bwd_dq_sm90(")):
        _edit(path, old, new)


VARIANTS = {"no_tail": no_tail, "overlap_dv": overlap_dv, "dq_three_blocks": dq_three_blocks}


def build(names):
    """Each variant's library, built side by side: {name: (ctypes handle, ptxas log)}."""
    nvcc = _build.find_tool("nvcc")
    out_root = os.path.join(ROOT, "build", "attn_variants")
    procs = []
    for name in names:
        d = os.path.join(out_root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, os.path.join(d, "csrc"))
        if name != "base":
            VARIANTS[name](os.path.join(d, "csrc"))
        for cu in sorted(os.listdir(os.path.join(d, "csrc"))):
            if cu.endswith(".cu"):
                obj = os.path.join(d, cu[:-3] + ".o")
                procs.append((name, obj, subprocess.Popen(
                    [nvcc, *_build.NVCC_FLAGS, "-c", os.path.join(d, "csrc", cu), "-o", obj],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs = {}, {}
    for name, obj, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out[-8000:]}")
        logs[name] = logs.get(name, "") + out
        objs.setdefault(name, []).append(obj)
    libs = {}
    for name in names:
        path = os.path.join(out_root, name, "libprobunet_kernels.so")
        subprocess.run([nvcc, "-shared", "-o", path, *objs[name]], check=True,
                       capture_output=True)
        h = ctypes.CDLL(path)
        for fn, argtypes in _build._SIGNATURES.items():
            getattr(h, fn).argtypes = argtypes
            getattr(h, fn).restype = ctypes.c_int
        h.probunet_error_string.argtypes = [ctypes.c_int]
        h.probunet_error_string.restype = ctypes.c_char_p
        libs[name] = (h, logs[name])
    return libs


def registers(h):
    """(registers, spilled bytes) of each bf16 K2/K3 kernel at the exact widths."""
    out, res = (ctypes.c_int * 5)(), {}
    for kd in (80, 96):
        rows = (128, 128) if kd == 80 else (64, 64)
        _build.check(h.probunet_attention_fwd_query(*rows, kd, out), "query")
        res[f"kd{kd}_fwd"] = (out[2], out[3])
        for split in (0, 1):
            for k, name in ((0, "dkdv"), (1, "dq")):
                _build.check(h.probunet_attention_bwd_query(k, 64, split, kd, out), "query")
                res[f"kd{kd}_{name}{'_split' if split else ''}"] = (out[2], out[3])
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS), help="variants to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_attn_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    names = ["base"] + [n for n in args.variants.split(",") if n]
    t0 = time.perf_counter()
    libs = build(names)
    print(f"built {len(names)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (h, log) in libs.items():
        warn = sorted(set(re.findall(r"\((C751[0-8])\)[^\n]*function '([^']+)'", log)))
        print(f"{name}: registers, spilled bytes {registers(h)}; wgmma warnings {warn}",
              flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {}
    for L, nh, c in SITES:
        q, k, v = cs.qkv_views(torch, "block", cs.BATCH, L, nh, torch.bfloat16, dev, gen, c)
        do = torch.randn(cs.BATCH, L, nh, c, device=dev, generator=gen).to(torch.bfloat16)
        data[(L, nh, c)] = (q, k, v, do)
    run, ref = {"card": card}, {}
    for label in names + ["base_again"]:
        name = label.replace("_again", "")
        _build._lib = libs[name][0]
        for (L, nh, c), (q, k, v, do) in data.items():
            key = f"{label} L={L} heads={nh} c={c}"
            with torch.no_grad():
                out, lse = K2._launch(q, k, v, True)
                t = {"k2_device_ms": cs.device_ms(torch, lambda: K2._launch(q, k, v, False),
                                                  whole=True)}
                for fast in (True, False):
                    grads = K2._launch_bwd(q, k, v, out, lse, do, fast)
                    ref.setdefault((L, nh, c, fast), (out, grads))
                    r_out, r_grads = ref[(L, nh, c, fast)]
                    diff = max((a.float() - b.float()).abs().max().item()
                               for a, b in zip((out, *grads), (r_out, *r_grads)))
                    split = {}
                    leg = "k3_fast" if fast else "k3_split"
                    t[f"{leg}_device_ms"] = cs.device_ms(
                        torch, lambda: K2._launch_bwd(q, k, v, out, lse, do, fast), whole=True,
                        split=split)
                    t.update({f"{leg}_{k_}": v_ for k_, v_ in cs.k3_split(split).items()})
                    t[f"{leg}_max_diff_from_base"] = diff
            run.setdefault(label, {})[f"L={L} heads={nh} c={c}"] = t
            print(f"{key}: K2 fast {t['k2_device_ms'] * 1e3:.2f} us; K3 fast "
                  f"{t['k3_fast_device_ms'] * 1e3:.2f} (dK/dV "
                  f"{t['k3_fast_dkdv_device_ms'] * 1e3:.2f}, "
                  f"dQ {t['k3_fast_dq_device_ms'] * 1e3:.2f}), split "
                  f"{t['k3_split_device_ms'] * 1e3:.2f} (dK/dV "
                  f"{t['k3_split_dkdv_device_ms'] * 1e3:.2f}, dQ "
                  f"{t['k3_split_dq_device_ms'] * 1e3:.2f}); largest difference from base "
                  f"{max(t['k3_fast_max_diff_from_base'], t['k3_split_max_diff_from_base']):.3e}"
                  f" ({card})", flush=True)
    print(json.dumps(run), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
