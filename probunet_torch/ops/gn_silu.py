"""Fused GroupNorm + SiLU — kernel K1 of the port, and its backward.

``gn_silu`` launches the hand-written CUDA kernel ``csrc/gn_silu.cu`` for a
CUDA tensor and runs :func:`_plain_gn_silu`, the same function in plain
PyTorch, for a CPU tensor. It replaces
``probunet_tpu/ops/pallas_gn.py::_kernel``; the source note in the ``.cu``
file gives its bound and design. When an input requires a gradient it runs
inside an ``autograd.Function`` whose backward is
:func:`_plain_gn_silu_bwd` on every device, as the JAX package's backward
(``pallas_gn.py::_gn_silu_bwd``) is plain XLA and no Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from probunet_torch.ops import _build
from probunet_torch.ops.norm import group_stats

#: stats-pass blocks to aim for per SM, so batch 8 still fills the card
_STATS_BLOCKS_PER_SM = 4


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


def stats_split(batch: int, hw: int, num_sms: int):
    """(S, rows_per_chunk): the H*W rows cut into S chunks so that the
    statistics pass runs about ``_STATS_BLOCKS_PER_SM`` blocks per SM."""
    s = max(1, min(hw, math.ceil(_STATS_BLOCKS_PER_SM * num_sms / batch)))
    rows = math.ceil(hw / s)
    return math.ceil(hw / rows), rows


def _vec_width(x: torch.Tensor, *ptrs) -> int:
    """Elements per 16-byte access, or 1 where C or an address forbids it."""
    vec = 16 // x.element_size()
    if x.shape[-1] % vec or any(p % 16 for p in ptrs):
        return 1
    return vec


@torch.no_grad()
def _launch(x, weight, bias, groups, eps):
    b, h, w, c = x.shape
    dev = x.device
    gamma = weight.to(dev, torch.float32).contiguous()
    beta = bias.to(dev, torch.float32).contiguous()
    out = torch.empty_like(x)
    mean = torch.empty(b, groups, device=dev, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    s, rows = stats_split(b, h * w, torch.cuda.get_device_properties(dev).multi_processor_count)
    partials = torch.empty(b, s, groups, 3, device=dev, dtype=torch.float32)
    vec = _vec_width(x, x.data_ptr(), out.data_ptr())
    lib = _build.lib()
    code = lib.probunet_gn_silu_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), partials.data_ptr(), b, h * w, c, groups, s, rows, eps,
        int(x.dtype == torch.bfloat16), vec, _build.stream_handle(dev))
    _build.check(code, "gn_silu kernel")
    gn_silu.launches += 1
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
gn_silu.bwd_calls = 0  # backward calls (plain PyTorch on every device)
