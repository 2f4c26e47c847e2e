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

The affine map may be modulated per (sample, channel) by the residual
block's embedding terms, (B, C) or (1, C) fp32 operands, so that the block's
``norm1`` is one launch in both of its forms (``models/unet.py::UNetBlock``):
``scale``/``shift`` give ``silu(GN(x) * (1 + scale) + shift)`` (the ADM block,
``adaptive_scale``), ``shift_in`` gives ``silu(GN(x + shift_in))`` (the DDPM++
block). The kernel folds them into its per-channel constants
(``gamma (1 + s)``, ``beta (1 + s) + t``; ``mean - t`` after t is added in the
statistics), so the modulated map is never made.

When an input requires a gradient the forward runs inside an
``autograd.Function`` whose backward is :func:`_plain_gn_silu_bwd` on every
device, as the JAX package's backward (``pallas_gn.py::_gn_silu_bwd``) is
plain XLA and no Pallas kernel.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

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


#: K1's modulations of the affine map, by the C entry point's ``mod``
MODS = ("none", "scale_shift", "shift_in")


def _row(t):
    """A (B|1, C) operand as (B|1, 1, C) fp32, to broadcast over H*W rows."""
    return t.float()[:, None, :]


def _affine(weight, bias, scale, shift):
    """The affine map's weight and bias, modulated by (1 + scale) and shift
    when given: (C,) fp32, or (B|1, 1, C)."""
    wf, bf = weight.float(), bias.float()
    if scale is None:
        return wf, bf
    s1 = 1 + _row(scale)
    return wf * s1, bf * s1 + _row(shift)


def _sum_rows(t, like):
    """(B, H*W, C) ``t`` summed to ``like``'s (B, C) or (1, C), in its dtype."""
    return t.sum(dim=1 if like.shape[0] > 1 else (0, 1)).reshape(like.shape).to(like.dtype)


def _plain_gn_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float = 1e-5, scale=None, shift=None, shift_in=None):
    """Plain version: two-pass fp32 statistics, fp32 normalize + affine + SiLU,
    cast to x's dtype; ``shift_in`` added to x in fp32 before the norm,
    ``scale``/``shift`` modulating the affine map. Returns (out, mean, rstd)
    with (B, G) fp32 stats (of x + shift_in)."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, c)
    if shift_in is not None:
        xf = xf + _row(shift_in)
    mean, rstd = group_stats(xf.reshape(b, h, w, c), groups, eps)
    cg = c // groups
    wf, bf = _affine(weight, bias, scale, shift)
    y = ((xf - mean.repeat_interleave(cg, dim=1)[:, None, :])
         * rstd.repeat_interleave(cg, dim=1)[:, None, :]
         * wf + bf)
    out = (y * torch.sigmoid(y)).reshape(b, h, w, c).to(x.dtype)
    return out, mean, rstd


def _plain_gn_silu_bwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       mean: torch.Tensor, rstd: torch.Tensor, g: torch.Tensor, groups: int,
                       scale=None, shift=None, shift_in=None):
    """(dx, dweight, dbias, dscale, dshift, dshift_in) of GroupNorm + SiLU
    for the output gradient ``g``, from the saved (B, G) fp32 statistics:
    ``_gn_silu_bwd`` line for line, fp32 math, dx in x's dtype, dweight and
    dbias in the parameters', each operand's gradient (None if it is None)
    summed over H*W, and over the batch for a (1, C) operand:
    dscale = sum dy (xhat gamma + beta), dshift = sum dy, dshift_in = sum dx,
    dy the gradient at the SiLU's input."""
    b, h, w, c = x.shape
    cg = c // groups
    xf = x.float().reshape(b, h * w, c)
    if shift_in is not None:
        xf = xf + _row(shift_in)
    gf = g.float().reshape(b, h * w, c)
    mean_c = mean.repeat_interleave(cg, dim=1)[:, None, :]
    rstd_c = rstd.repeat_interleave(cg, dim=1)[:, None, :]
    xhat = (xf - mean_c) * rstd_c
    wf, bf = _affine(weight, bias, scale, shift)
    y = xhat * wf + bf

    sig = torch.sigmoid(y)
    dy = gf * (sig * (1 + y * (1 - sig)))     # d silu(y)/dy

    dscale = dshift = dshift_in = None
    dz = dy                                    # at the unmodulated affine map's output
    if scale is not None:
        dscale = _sum_rows(dy * (xhat * weight.float() + bias.float()), scale)
        dshift = _sum_rows(dy, shift)
        dz = dy * (1 + _row(scale))
    dweight = (dz * xhat).sum(dim=(0, 1)).to(weight.dtype)
    dbias = dz.sum(dim=(0, 1)).to(bias.dtype)

    dxhat = dy * wf
    # group means of dxhat and dxhat * xhat
    m1 = dxhat.reshape(b, h * w, groups, cg).mean(dim=(1, 3))
    m2 = (dxhat * xhat).reshape(b, h * w, groups, cg).mean(dim=(1, 3))
    m1_c = m1.repeat_interleave(cg, dim=1)[:, None, :]
    m2_c = m2.repeat_interleave(cg, dim=1)[:, None, :]
    dx = rstd_c * (dxhat - m1_c - xhat * m2_c)
    if shift_in is not None:
        dshift_in = _sum_rows(dx, shift_in)
    return dx.reshape(b, h, w, c).to(x.dtype), dweight, dbias, dscale, dshift, dshift_in


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


def _launch(x, weight, bias, groups, eps, scale=None, shift=None, shift_in=None):
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
    mod = 1 if scale is not None else 2 if shift_in is not None else 0
    # each operand's rows are read in place: unit channel stride, batch
    # stride 0 for a (1, C) row that every sample shares
    ms, mt = (None if t is None else t if t.stride(1) == 1 else t.contiguous()
              for t in (scale, shift if shift is not None else shift_in))
    code = _build.lib().probunet_gn_silu_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), b, h * w, c, groups, p.cb, p.n, p.rows, p.chunk_rows, eps,
        int(x.dtype == torch.bfloat16), vec, mod, *(None if t is None else t.data_ptr()
                                                   for t in (ms, mt)),
        *(0 if t is None or t.shape[0] == 1 else t.stride(0) for t in (ms, mt)),
        _build.stream_handle(dev))
    _build.check(code, "gn_silu kernel")
    _build.LAUNCHES["gn_silu", "on_chip" if p.on_chip else "streamed", MODS[mod]] += 1
    return out, mean, rstd


def _forward(x, weight, bias, groups, eps, scale=None, shift=None, shift_in=None):
    if x.device.type == "cpu":
        return _plain_gn_silu(x, weight, bias, groups, eps, scale, shift, shift_in)
    return _launch(x, weight, bias, groups, eps, scale, shift, shift_in)


class _GNSiLU(torch.autograd.Function):
    """K1 forward (saving x, the operands and the statistics), plain backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, scale, shift, shift_in, groups, eps):
        out, mean, rstd = _forward(x, weight, bias, groups, eps, scale, shift, shift_in)
        ctx.save_for_backward(x, weight, bias, scale, shift, shift_in, mean, rstd)
        ctx.groups = groups
        ctx.mark_non_differentiable(mean, rstd)
        return out, mean, rstd

    @staticmethod
    def backward(ctx, g, _gmean, _grstd):
        x, weight, bias, scale, shift, shift_in, mean, rstd = ctx.saved_tensors
        _build.LAUNCHES[("gn_silu_bwd",)] += 1
        return (*_plain_gn_silu_bwd(x, weight, bias, mean, rstd, g, ctx.groups, scale, shift,
                                    shift_in), None, None)


def _operand(t, x, name):
    """A modulation operand as (B, C) or (1, C) fp32 on x's device."""
    b, c = x.shape[0], x.shape[-1]
    if t.ndim != 2 or t.shape[0] not in (1, b) or t.shape[1] != c:
        raise ValueError(f"gn_silu's {name} must be ({b}, {c}) or (1, {c}), "
                         f"got {tuple(t.shape)}")
    if t.device != x.device:
        raise ValueError(f"gn_silu's {name} is on {t.device}, x on {x.device}")
    return t.float()


def gn_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
            eps: float = 1e-5, return_stats: bool = False, *,
            scale: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
            shift_in: Optional[torch.Tensor] = None):
    """GroupNorm + SiLU over NHWC ``x`` (B, H, W, C), fp32 or bf16, C
    divisible by ``groups``; ``weight``/``bias`` are (C,). With ``scale`` and
    ``shift`` (together), ``silu(GN(x) * (1 + scale) + shift)``; with
    ``shift_in``, ``silu(GN(x + shift_in))``; each (B, C) or (1, C), taken in
    fp32. Returns ``out`` in x's dtype, and ``(out, mean, rstd)`` with (B, G)
    fp32 stats when ``return_stats``. Differentiable in x, weight, bias and
    the operands. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if x.ndim != 4 or x.shape[-1] % groups:
        raise ValueError(f"gn_silu needs NHWC input with C divisible by groups, "
                         f"got shape {tuple(x.shape)} and groups={groups}")
    if (scale is None) != (shift is None) or (scale is not None and shift_in is not None):
        raise ValueError("gn_silu takes scale and shift together, or shift_in alone")
    scale, shift, shift_in = (None if t is None else _operand(t, x, name)
                              for t, name in ((scale, "scale"), (shift, "shift"),
                                              (shift_in, "shift_in")))
    if x.device.type == "cuda":
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"gn_silu kernel takes fp32 or bf16, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("gn_silu kernel takes a contiguous NHWC tensor")
    elif x.device.type != "cpu":
        raise RuntimeError(f"gn_silu has no path for device {x.device}")
    args = (x, weight, bias, scale, shift, shift_in)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        res = _GNSiLU.apply(*args, groups, eps)
    else:
        res = _forward(x, weight, bias, groups, eps, scale, shift, shift_in)
    return res if return_stats else res[0]
