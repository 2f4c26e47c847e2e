"""Build and load the port's hand-written CUDA kernels.

``csrc/*.cu`` have a plain C interface. At first use each source is compiled
by its own ``nvcc`` process (all started together) for ``sm_90a``, the
objects are linked into ``build/kernels/libprobunet_kernels.so`` at the repo
root, and the library is loaded with ``ctypes``. No PyTorch header is
compiled, so a cold build takes seconds. A source newer than the library
triggers a rebuild. Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libprobunet_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
#: Launches since the last :func:`reset_launches`, keyed by kernel and
#: variant: ("gn_silu", "on_chip" | "streamed", a ``gn_silu.MODS`` name);
#: ("gn_silu_bwd",) a call of K1's plain backward (any device);
#: ("attention_fwd" | "attention_bwd", "bf16" | "fp32", kd) K2 and K3;
#: ("kernel_layout",) a tensor copied before an attention launch (any
#: device); ("conv2d", one of ``conv.PATHS``) a call of that path ("plain"
#: on any device) or a split-kernel launch ("split"); ("adamw_bf16",
#: "fused" | "foreach") the bf16 AdamW update's launch, an update on its
#: plain path (the CPU); ("dropout", "fwd" | "bwd", "element" | "row") a
#: dropout launch, ("dropout", "u_copy" | "dy_copy") its uniforms or
#: gradient made dense in the kernel's order. CPU calls of the plain K1, K2,
#: K3, split and dropout count nothing.
LAUNCHES: collections.Counter = collections.Counter()
_vp, _int, _i64, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # x, gamma, beta, out, mean, rstd, B, HW, C, G, cb, cluster, rows,
    # chunk_rows, eps, is_bf16, vec, mod (0 none, 1 scale_shift, 2
    # shift_in), mscale, mshift, their batch strides, stream
    "probunet_gn_silu_fwd": [_vp] * 6 + [_int] * 8 + [_float, _int, _int, _int, _vp, _vp, _int,
                                                      _int, _vp],
    # is_bf16, vec, C, G, cb, cluster, chunk_rows, mod, out (int[6])
    "probunet_gn_silu_query": [_int] * 8 + [_vp],
    # q, k, v, o, lse, B, H, L, head_dim (the row width the kernels read),
    # (b, l, h) element strides of q, k and v, scale, is_bf16, block_rows,
    # tile_rows, kd (the kernels' head width), stream
    "probunet_attention_fwd": [_vp] * 5 + [_int] * 4 + [_i64] * 9 + [_float] + [_int] * 4 + [_vp],
    # the bf16 kernel: block_rows, tile_rows, kd (64, 80, 96 or 128), out (int[5])
    "probunet_attention_fwd_query": [_int] * 3 + [_vp],
    # the fp32 kernel: kd, tile_rows, out (int[5])
    "probunet_attention_fwd_f32_query": [_int] * 2 + [_vp],
    # q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, L, head_dim, (b, l, h)
    # element strides of q, k, v, o and dout, scale, is_bf16, fast, rows
    # (bf16: block rows; fp32: streamed tile rows), kd, stream
    "probunet_attention_bwd": [_vp] * 10 + [_int] * 4 + [_i64] * 15 + [_float] + [_int] * 4
                              + [_vp],
    # a bf16 kernel (0 dK/dV or, at kd 128, its dV pass; 1 dQ; 2 the dK pass
    # at kd 128; 3 the row pass), block_rows, split, kd (64, 80, 96 or 128),
    # out (int[5])
    "probunet_attention_bwd_query": [_int] * 4 + [_vp],
    # an fp32 kernel (0-2 as above, 3 the row pass), kd, rows, out (int[5])
    "probunet_attention_bwd_f32_query": [_int] * 3 + [_vp],
    # x, hi_out, out, d0..d3 (the 4-D view read), its element
    # strides s0..s3, nslots, lo_mask, slot_outer, vec, stream
    "probunet_tf32_split": [_vp] * 3 + [_int] * 4 + [_i64] * 4 + [_int] * 4 + [_vp],
    # table, ntensors, nchunks, b1, 1 - b1, b2, 1 - b2, 1 / bc1, 1 / bc2, eps,
    # weight decay, -lr, stream
    "probunet_adamw_bf16": [_vp, _int, _int] + [_float] * 9 + [_vp],
    # out (int[5]): threads, registers, spilled bytes, chunk, blocks per SM
    "probunet_adamw_bf16_query": [_vp],
    # in, out, u, bits, n, row, keep, 1 / keep, is_bf16, mode (0 element
    # forward, 1 element backward, 2 row), vec, stream
    "probunet_dropout": [_vp] * 4 + [_i64] * 2 + [_float] * 2 + [_int] * 3 + [_vp],
    # is_bf16, mode, out (int[5]): threads, registers, spilled bytes, blocks
    # per SM, the grid's cap
    "probunet_dropout_query": [_int] * 2 + [_vp],
}


def launches(kernel: str, *variant) -> int:
    """The count in :data:`LAUNCHES` of ``kernel`` over the keys that hold
    every value of ``variant``: ``launches("gn_silu")`` every K1 launch,
    ``launches("gn_silu", "streamed")`` by plan, ``launches("gn_silu",
    "shift_in")`` by modulation, ``launches("attention_fwd", "fp32", 256)``
    K2's at kD = 256, ``launches("conv2d", "plain")`` one path."""
    return sum(n for key, n in LAUNCHES.items()
               if key[0] == kernel and all(v in key[1:] for v in variant))


def reset_launches() -> None:
    """Set every count of :data:`LAUNCHES` to zero."""
    LAUNCHES.clear()


def find_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name),
                 shutil.which(name)):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"{name} not found (set CUDA_HOME or put it on PATH); "
                       "the port's kernels are built from probunet_torch/csrc at first use")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def is_stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    cu, cuh = _sources()
    return any(p.stat().st_mtime > built for p in cu + cuh)


def build() -> str:
    """Compile every ``csrc/*.cu`` in parallel and link the shared library.
    Returns the compiler's output (ptxas registers, shared memory, spills);
    raises with that output if any step fails."""
    nvcc = find_tool("nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{p.stem}.{tag}.o" for p in cu]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(cu, objs)]
    log, failed = [], []
    for src, proc in zip(cu, procs):
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{LIB_PATH.name}.{tag}"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError("linking the kernel library failed:\n" + link.stdout)
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new
    return "\n".join(log)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    if _lib is None:
        if is_stale():
            build()
        handle = ctypes.CDLL(str(LIB_PATH))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.probunet_error_string.argtypes = [ctypes.c_int]
        handle.probunet_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


@functools.lru_cache(maxsize=None)
def num_sms(index: int) -> int:
    """SM count of CUDA device ``index``, asked once per device."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if code:
        msg = _lib.probunet_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def stream_handle(device) -> ctypes.c_void_p:
    """The current PyTorch CUDA stream on ``device`` as a C pointer. Asks
    for the raw handle (the call Triton's launcher makes) rather than
    building a ``torch.cuda.Stream`` object on every kernel launch."""
    import torch

    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device.index))
