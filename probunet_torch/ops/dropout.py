"""Dropout's compare, scale and select (``models/layers.py``: ``dropout``,
``token_dropout``, ``drop_path``) in one launch each way.

:func:`apply` takes x and the uniforms u drawn for it and returns
``where(u < keep, x / keep, 0)``. The mode is read from u's shape: u of x's
shape (element mode: one uniform an element) or (B, 1) (row mode: one a
sample, stochastic depth). On the CPU it runs :func:`plain`, that
expression. On the card it runs :class:`_Dropout`, which launches the
hand-written CUDA kernel ``csrc/dropout.cu`` once in the forward and once in
the backward, with results bit-equal to the plain expression's on the card
(the kernel's source note). Element mode saves the mask as one bit an
element, ``ceil(n / 32)`` uint32 words; row mode saves the (B, 1) uniforms.

On the card x has to be fp32 or bf16, contiguous or channels_last, and u
fp32 on x's card; element mode reads u in x's memory order, so a u with
other strides is copied into it first (the spatial path's row slices).
Anything else raises a ``ValueError`` that names each tensor.

Counted in :data:`_build.LAUNCHES`: ``("dropout", "fwd" | "bwd", "element"
| "row")`` a launch, ``("dropout", "u_copy")`` a u made dense in x's order,
``("dropout", "dy_copy")`` a gradient made dense in the saved order. CPU
calls count nothing.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from probunet_torch.ops import _build

#: the kernel's modes (``DropMode`` in the source)
ELEMENT_FWD, ELEMENT_BWD, ROW = 0, 1, 2


def plain(x: torch.Tensor, u: torch.Tensor, keep: float) -> torch.Tensor:
    """``where(u < keep, x / keep, 0)`` in PyTorch ops, u of x's shape or
    (B, 1): the expression the kernel replaces, the CPU's path."""
    if u.shape != x.shape:
        u = u.reshape(x.shape[0], *(1,) * (x.dim() - 1))
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def apply(x: torch.Tensor, u: torch.Tensor, keep: float) -> torch.Tensor:
    """x with each element (u of x's shape) or each sample (u (B, 1)) kept
    where its uniform is below ``keep`` and scaled by 1 / keep, else 0;
    differentiable in x."""
    if not (x.is_cuda or u.is_cuda):
        return plain(x, u, keep)
    return _Dropout.apply(x, u, keep)


def _dense(x: torch.Tensor) -> bool:
    """x contiguous or channels_last: dense, its samples outermost."""
    return x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)


def _same_order(t: torch.Tensor, shape: torch.Size, stride: Tuple[int, ...]) -> bool:
    """t of ``shape`` with ``stride``, those of size-1 dims aside: dense in
    the order of a dense tensor of that shape and those strides."""
    st = t.stride()
    return t.shape == shape and (st == stride or all(
        a == b for s, a, b in zip(shape, st, stride) if s != 1))


def _refuse(x: torch.Tensor, u: torch.Tensor, what: str) -> ValueError:
    found = ", ".join(f"{name} {tuple(t.shape)} {t.dtype} strides {t.stride()} on {t.device}"
                      for name, t in (("x", x), ("u", u)))
    return ValueError(f"dropout kernel takes x fp32 or bf16, contiguous or channels_last, on a "
                      f"card and u fp32 on x's card, of x's shape (element) or (B, 1) (row); "
                      f"{what}: got {found}")


def _operands(x: torch.Tensor, u: torch.Tensor) -> Tuple[int, torch.Tensor]:
    """The mode (ELEMENT_FWD or ROW) and u as the kernel reads it (copied,
    and counted, where element mode's u is not dense in x's order); a
    ValueError names each tensor where the kernel cannot take them."""
    if x.dtype not in (torch.float32, torch.bfloat16) or u.dtype != torch.float32:
        raise _refuse(x, u, "a dtype does not fit")
    if not x.is_cuda or u.device != x.device:
        raise _refuse(x, u, "not both on one card")
    if not _dense(x):
        raise _refuse(x, u, "x is not dense")
    if u.shape == x.shape:
        if not _same_order(u, x.shape, x.stride()):
            u = torch.empty_like(x, dtype=torch.float32).copy_(u)
            _build.LAUNCHES["dropout", "u_copy"] += 1
        return ELEMENT_FWD, u
    if x.dim() >= 1 and u.shape == (x.shape[0], 1):
        if not u.is_contiguous():
            u = u.contiguous()
            _build.LAUNCHES["dropout", "u_copy"] += 1
        return ROW, u
    raise _refuse(x, u, "u's shape is neither x's nor (B, 1)")


@functools.lru_cache(maxsize=None)
def _scalars(keep: float) -> Tuple[float, float]:
    """fp32 keep and fp32 1 / fp32 keep, as the kernel takes them."""
    keep32 = np.float32(keep)
    return float(keep32), float(np.float32(1) / keep32)


def _launch(src: torch.Tensor, u: Optional[torch.Tensor], bits: Optional[torch.Tensor],
            keep: float, mode: int) -> torch.Tensor:
    """One launch over the n elements of ``src`` (x or dy, dense) into a new
    tensor of its strides: ``u`` the uniforms (element forward, row),
    ``bits`` the mask (written in the element forward, read in the
    backward)."""
    out = torch.empty_like(src)
    n = src.numel()
    row = n // src.shape[0] if mode == ROW and src.shape[0] else 1
    ptrs = [src.data_ptr(), out.data_ptr(), None if u is None else u.data_ptr(),
            None if bits is None else bits.data_ptr()]
    vec = all(p % 16 == 0 for p in ptrs[:3 if mode == ELEMENT_FWD else 2])
    code = _build.lib().probunet_dropout(
        *ptrs, n, max(row, 1), *_scalars(keep), int(src.dtype == torch.bfloat16), mode, int(vec),
        _build.stream_handle(src.device))
    _build.check(code, "dropout kernel")
    return out


def _mask_words(n: int, device) -> torch.Tensor:
    """The element mode's saved mask: one bit an element in uint32 words
    (held as int32)."""
    return torch.empty(-(-n // 32), dtype=torch.int32, device=device)


class _Dropout(torch.autograd.Function):
    """The kernel's forward and backward; saves only the mask bits (element
    mode) or the (B, 1) uniforms (row mode)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, u: torch.Tensor, keep: float) -> torch.Tensor:
        mode, u = _operands(x, u)
        if mode == ROW:
            y = _launch(x, u, None, keep, ROW)
            _build.LAUNCHES["dropout", "fwd", "row"] += 1
            ctx.save_for_backward(u)
        else:
            bits = _mask_words(x.numel(), x.device)
            y = _launch(x, u, bits, keep, ELEMENT_FWD)
            _build.LAUNCHES["dropout", "fwd", "element"] += 1
            ctx.save_for_backward(bits)
        ctx.mode, ctx.keep, ctx.shape, ctx.stride = mode, keep, x.shape, x.stride()
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        saved, = ctx.saved_tensors
        if ctx.mode == ROW:
            if not _dense(dy):
                dy = dy.contiguous()
                _build.LAUNCHES["dropout", "dy_copy"] += 1
            dx = _launch(dy, saved, None, ctx.keep, ROW)
            _build.LAUNCHES["dropout", "bwd", "row"] += 1
        else:
            if not _same_order(dy, ctx.shape, ctx.stride):
                dy = torch.empty_strided(ctx.shape, ctx.stride, dtype=dy.dtype,
                                         device=dy.device).copy_(dy)
                _build.LAUNCHES["dropout", "dy_copy"] += 1
            dx = _launch(dy, None, saved, ctx.keep, ELEMENT_BWD)
            _build.LAUNCHES["dropout", "bwd", "element"] += 1
        return dx, None, None
