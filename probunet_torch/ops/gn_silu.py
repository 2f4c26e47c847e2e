"""Fused GroupNorm + SiLU — kernel K1 of the port, and its backward.

``gn_silu`` launches the hand-written CUDA kernel ``csrc/gn_silu.cu`` for a
CUDA tensor and runs :func:`_plain_gn_silu`, the same function in plain
PyTorch, for a CPU tensor. It replaces
``probunet_tpu/ops/pallas_gn.py::_kernel``. The kernel is bound by bytes: at
best it reads x once and writes the output once (2N). One launch per call:
a thread-block cluster per (sample, channel block of whole groups) holds the
block's (H*W, Cb) slice of x in its blocks' shared memory, merges the group
statistics across the cluster through distributed shared memory, in rank
order, and normalizes from the shared copy. A slice too large for a cluster
is streamed through shared memory twice by the same kernel (3N). The source
note in the ``.cu`` file gives the details; :func:`plan` sizes the clusters
on the host, once per shape.

When an input requires a gradient the forward runs inside an
``autograd.Function`` whose backward is :func:`_plain_gn_silu_bwd` on every
device, as the JAX package's backward (``pallas_gn.py::_gn_silu_bwd``) is
plain XLA and no Pallas kernel.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from probunet_torch.ops import _build
from probunet_torch.ops.norm import group_stats

#: bytes of x one block holds in shared memory: with the block's scratch it
#: stays under half of an SM's 228 KB, so two blocks share an SM and one's
#: stores overlap the other's loads
SLICE_BYTES = 100 * 1024
#: blocks per cluster at most (16 needs the non-portable cluster size)
MAX_CLUSTER = 16
#: row segment (Cb channels of one row of x) a plan prefers at least, bytes;
#: 32 (one sector) is required wherever C allows it
ROW_BYTES = 64


def _plain_gn_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float = 1e-5):
    """Plain version: two-pass fp32 statistics, fp32 normalize + affine + SiLU,
    cast to x's dtype. Returns (out, mean, rstd) with (B, G) fp32 stats."""
    b, h, w, c = x.shape
    mean, rstd = group_stats(x, groups, eps)
    cg = c // groups
    xf = x.float().reshape(b, h * w, c)
    y = ((xf - mean.repeat_interleave(cg, dim=1)[:, None, :])
         * rstd.repeat_interleave(cg, dim=1)[:, None, :]
         * weight.float() + bias.float())
    out = (y * torch.sigmoid(y)).reshape(b, h, w, c).to(x.dtype)
    return out, mean, rstd


def _plain_gn_silu_bwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       mean: torch.Tensor, rstd: torch.Tensor, g: torch.Tensor, groups: int):
    """(dx, dweight, dbias) of GroupNorm + SiLU for the output gradient
    ``g``, from the saved (B, G) fp32 statistics: ``_gn_silu_bwd`` line for
    line, fp32 math, dx in x's dtype, dweight and dbias in the parameters'."""
    b, h, w, c = x.shape
    cg = c // groups
    xf = x.float().reshape(b, h * w, c)
    gf = g.float().reshape(b, h * w, c)
    mean_c = mean.repeat_interleave(cg, dim=1)[:, None, :]
    rstd_c = rstd.repeat_interleave(cg, dim=1)[:, None, :]
    xhat = (xf - mean_c) * rstd_c
    wf = weight.float()[None, None, :]
    y = xhat * wf + bias.float()[None, None, :]

    sig = torch.sigmoid(y)
    dy = gf * (sig * (1 + y * (1 - sig)))     # d silu(y)/dy

    dweight = (dy * xhat).sum(dim=(0, 1)).to(weight.dtype)
    dbias = dy.sum(dim=(0, 1)).to(bias.dtype)

    dxhat = dy * wf
    # group means of dxhat and dxhat * xhat
    m1 = dxhat.reshape(b, h * w, groups, cg).mean(dim=(1, 3))
    m2 = (dxhat * xhat).reshape(b, h * w, groups, cg).mean(dim=(1, 3))
    m1_c = m1.repeat_interleave(cg, dim=1)[:, None, :]
    m2_c = m2.repeat_interleave(cg, dim=1)[:, None, :]
    dx = rstd_c * (dxhat - m1_c - xhat * m2_c)
    return dx.reshape(b, h, w, c).to(x.dtype), dweight, dbias


class Plan(NamedTuple):
    """How one call is cut: clusters of ``n`` blocks, one per (sample,
    channel block of ``cb`` channels); each block takes ``rows`` of the H*W
    rows, ``chunk_rows`` of them at a time in shared memory."""

    cb: int
    n: int
    rows: int
    on_chip: bool      # the unit's slice stays in the cluster: x read once
    chunk_rows: int    # == rows when on_chip


def _vec(c: int, itemsize: int) -> int:
    """Elements per 16-byte access where C allows it, else 1."""
    vec = 16 // itemsize
    return 1 if c % vec else vec


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, c: int, groups: int, itemsize: int, num_sms: int) -> Plan:
    """The launch plan of K1 for one shape; pure and cached.

    Cb holds whole groups and whole 16-byte vectors, and divides C. Rows of
    at least 32 bytes are required where C allows them, and ROW_BYTES
    preferred: the smallest such Cb whose slice fits a cluster of at most
    MAX_CLUSTER blocks of SLICE_BYTES each is taken, which also gives the
    most units and, with the fewest blocks that hold the slice, the
    smallest clusters (each block of a cluster adds latency: spreading a
    small unit over more blocks measured slower on the H100). When no Cb
    fits, the unit is streamed (``on_chip`` False) in chunks of SLICE_BYTES,
    by as many blocks per unit as give every SM one block."""
    hw, cg = h * w, c // groups
    base = math.lcm(cg, _vec(c, itemsize))
    cands = [base * k for k in range(1, c // base + 1) if (c // base) % k == 0]
    wide = [cb for cb in cands if cb * itemsize >= 32] or cands

    def max_rows(cb):
        return SLICE_BYTES // (cb * itemsize)

    fits = [cb for cb in wide if max_rows(cb) and math.ceil(hw / max_rows(cb)) <= MAX_CLUSTER]
    cb = min(fits or wide, key=lambda cb: (-min(cb * itemsize, ROW_BYTES), cb))
    on_chip = bool(fits)
    if on_chip:
        n = math.ceil(hw / max_rows(cb))
    else:
        n = min(MAX_CLUSTER, hw, math.ceil(num_sms / (b * (c // cb))))
    rows = math.ceil(hw / n)
    n = math.ceil(hw / rows)
    chunk = rows if on_chip else max(1, max_rows(cb))
    return Plan(cb, n, rows, on_chip, chunk)


_num_sms = _build.num_sms


def _launch(x, weight, bias, groups, eps):
    b, h, w, c = x.shape
    dev = x.device
    p = plan(b, h, w, c, groups, x.element_size(), _num_sms(dev.index))
    gamma = weight.to(dev, torch.float32).contiguous()
    beta = bias.to(dev, torch.float32).contiguous()
    out = torch.empty_like(x)
    mean = torch.empty(b, groups, device=dev, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    vec = _vec(c, x.element_size())
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    code = _build.lib().probunet_gn_silu_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), b, h * w, c, groups, p.cb, p.n, p.rows, p.chunk_rows, eps,
        int(x.dtype == torch.bfloat16), vec, _build.stream_handle(dev))
    _build.check(code, "gn_silu kernel")
    gn_silu.launches += 1
    plan_key = "on_chip" if p.on_chip else "streamed"
    gn_silu.launches_by_plan[plan_key] = gn_silu.launches_by_plan.get(plan_key, 0) + 1
    return out, mean, rstd


def _forward(x, weight, bias, groups, eps):
    if x.device.type == "cpu":
        return _plain_gn_silu(x, weight, bias, groups, eps)
    return _launch(x, weight, bias, groups, eps)


class _GNSiLU(torch.autograd.Function):
    """K1 forward (saving x and the statistics), plain backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        out, mean, rstd = _forward(x, weight, bias, groups, eps)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.groups = groups
        ctx.mark_non_differentiable(mean, rstd)
        return out, mean, rstd

    @staticmethod
    def backward(ctx, g, _gmean, _grstd):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        gn_silu.bwd_calls += 1
        return (*_plain_gn_silu_bwd(x, weight, bias, mean, rstd, g, ctx.groups), None, None)


def gn_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
            eps: float = 1e-5, return_stats: bool = False):
    """GroupNorm + SiLU over NHWC ``x`` (B, H, W, C), fp32 or bf16, C
    divisible by ``groups``; ``weight``/``bias`` are (C,). Returns ``out`` in
    x's dtype, and ``(out, mean, rstd)`` with (B, G) fp32 stats when
    ``return_stats``. Differentiable in x, weight and bias. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if x.ndim != 4 or x.shape[-1] % groups:
        raise ValueError(f"gn_silu needs NHWC input with C divisible by groups, "
                         f"got shape {tuple(x.shape)} and groups={groups}")
    if x.device.type == "cuda":
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"gn_silu kernel takes fp32 or bf16, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("gn_silu kernel takes a contiguous NHWC tensor")
    elif x.device.type != "cpu":
        raise RuntimeError(f"gn_silu has no path for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        res = _GNSiLU.apply(x, weight, bias, groups, eps)
    else:
        res = _forward(x, weight, bias, groups, eps)
    return res if return_stats else res[0]


gn_silu.launches = 0   # kernel launches; CPU calls of the plain version do not count
# the same by plan: "on_chip" (the slice held in a cluster, x read once) or
# "streamed" (a slice too large for a cluster, read twice), e.g. {"on_chip": 29}
gn_silu.launches_by_plan = {}
gn_silu.bwd_calls = 0  # backward calls (plain PyTorch on every device)
