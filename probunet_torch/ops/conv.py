"""The port's convolutions: strict (fp32) ones partly in 3xTF32 on cuDNN's tensor cores.

Every convolution the model code makes goes through :func:`conv2d`. The
path depends only on the input:

- bf16, and any CPU tensor: ``F.conv2d``, as PyTorch runs it;
- a CUDA tensor in float32 whose gradient is not recorded (the samplers,
  evaluation): the forward in 3xTF32 (:func:`forward_3x`);
- a CUDA tensor in float32 whose gradient is recorded (training): the
  forward and the weight gradient in IEEE fp32, the input gradient in
  3xTF32 (:class:`_StrictConv`).

With TF32 off (``utils/device.py::full_fp32``, which every strict step runs
under), cuDNN has only IEEE fp32 algorithms for an fp32 convolution, and on
the H100 it runs the forward at 128x128 with 128-384 channels as an FFT at
4-5 TFLOP/s. 3xTF32 runs fp32 work on the tensor cores: each operand x is
carried as hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest,
ties away (|lo| <= 2^-11 |x|), and the products hi*hi + lo*hi + hi*lo are
summed in fp32. The TF32 inputs are exact (their low 13 bits are zero), so
the products are exact; the dropped lo*lo and the rounding of lo are each
within 2^-22 of the product. What is not fp32's is the sum: the tensor
cores round their fp32 accumulator toward zero, so a reduction of K terms
into one accumulator comes out shrunk by about 1.6e-9 K of its spread (H100
measurements in PERF.md). Hence:

- each 3xTF32 convolution is two cuDNN calls summed in fp32: hi*hi alone,
  and the two small products in one call over the parts concatenated
  (``[a_lo, a_hi]`` against ``[b_hi, b_lo]``), whose accumulator stays
  ~2^-11 of the output's, so the large product's K terms are the only
  deep reduction (one call over all three parts would put 3K terms into
  an accumulator of the output's size, four times the shrink);
- the weight gradient, a reduction over B*H*W terms, stays IEEE fp32, and
  so does the forward of a training step, whose shrink moves the loss
  (the strict benchmark cell's limits; PERF.md). A training forward of at
  least TRANSPOSED_MIN_BATCH rows, TRANSPOSED_MIN_PIXELS pixels and
  TRANSPOSED_MIN_CHANNELS input channels runs as the transposed convolution
  of the flipped weight (cuDNN's dgrad kernels, IEEE fp32 too), which takes
  1.2-3.2 ms where cuDNN's forward takes its 5-17 ms FFT (b8, 128x128, 96-256
  channels on the H100); at fewer rows, pixels or channels cuDNN's forward
  picks no FFT and is the faster (PERF.md gives the shapes measured);
- the input gradient: the transposed convolutions of dy_hi with w_hi and
  of ``[dy_lo, dy_hi]`` with ``[w_hi; w_lo]`` (stacked along the output
  channels); the bias gradient is ``dy.sum`` in fp32.

The parts are written by ``csrc/tf32_split.cu``, one launch per operand
(hi alone, and the pair concatenated), in the channels_last layout that
cuDNN reads without a copy; a CPU tensor takes :func:`_plain_split`, the
same function in plain PyTorch. The backward's convolutions are
``aten::convolution_backward`` calls. cuDNN's TF32 flag is set for each of
the module's cuDNN calls (:func:`_cudnn`) and restored on every exit: on
for the 3xTF32 ones, off for the IEEE ones whatever the caller set. The
flag is process-wide, and the port runs its convolutions from one thread
at a time (the forward on the caller's, the backward on autograd's while
the caller waits).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from probunet_torch.ops import _build

IntPair = Union[int, Tuple[int, int]]

#: the small products' parts of each operand, by the role the operand plays
#: in its call: lo*hi + hi*lo is [a_lo, a_hi] against [b_hi, b_lo]
X_FWD, W_FWD = ("lo", "hi"), ("hi", "lo")
DY_DGRAD, W_DGRAD = ("lo", "hi"), ("hi", "lo")

#: a training forward at least this large runs as a transposed convolution
TRANSPOSED_MIN_BATCH, TRANSPOSED_MIN_PIXELS, TRANSPOSED_MIN_CHANNELS = 8, 128 * 128, 96


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 in plain PyTorch: x rounded to 10 mantissa bits,
    ties away from zero (half of the dropped 13 bits' range added to the
    magnitude's bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _plain_split(x: torch.Tensor, order: Sequence[str], dim: int):
    """Plain version of the split kernel: (hi, x's parts in ``order`` ("hi"
    or "lo" each) concatenated along ``dim`` (0 or 1)), channels_last."""
    hi = tf32(x)
    parts = {"hi": hi, "lo": tf32(x - hi)}
    out = torch.cat([parts[p] for p in order], dim).contiguous(
        memory_format=torch.channels_last)
    return hi.contiguous(memory_format=torch.channels_last), out


def _launch_split(x: torch.Tensor, order: Sequence[str], dim: int):
    b, c, h, w = x.shape
    n = len(order)
    shape = (n * b, c, h, w) if dim == 0 else (b, n * c, h, w)
    out = torch.empty(shape, device=x.device, dtype=torch.float32,
                      memory_format=torch.channels_last)
    hi = torch.empty_like(x, memory_format=torch.channels_last)
    s0, s1, s2, s3 = x.stride()
    # read as (B, H, W, C): the channels are the unit-stride dim of a
    # channels_last tensor (a dim of size 1 is never stepped along)
    vec = 4 if (c % 4 == 0 and s1 == 1
                and all(st % 4 == 0 or size == 1 for size, st in ((b, s0), (h, s2), (w, s3)))
                and not any(t.data_ptr() % 16 for t in (x, out, hi))) else 1
    lo_mask = sum(1 << i for i, part in enumerate(order) if part == "lo")
    code = _build.lib().probunet_tf32_split(
        x.data_ptr(), hi.data_ptr(), out.data_ptr(), b, h, w, c, s0, s2, s3, s1, n, lo_mask,
        int(dim == 0), vec, _build.stream_handle(x.device))
    _build.check(code, "tf32 split kernel")
    conv2d.calls["split"] += 1
    return hi, out


def split(x: torch.Tensor, order: Sequence[str], dim: int):
    """(hi, parts): the 4-D fp32 tensor ``x``'s hi part, and its tf32 parts
    in ``order`` concatenated along ``dim`` (1: the channels, 0: the batch
    or the output channels), both channels_last, from one read of x. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.dtype != torch.float32 or x.ndim != 4 or dim not in (0, 1):
        raise ValueError(f"split takes a 4-D float32 tensor and dim 0 or 1, got "
                         f"{x.dtype} {tuple(x.shape)} and dim {dim}")
    if x.device.type == "cpu":
        return _plain_split(x, order, dim)
    if x.numel() >= 2 ** 31:
        raise ValueError(f"the split kernel takes fewer than 2^31 elements, got {x.numel()}")
    return _launch_split(x, order, dim)


def _cudnn(tf32_on: bool, fn, *args):
    """``fn(*args)`` with cuDNN's TF32 kernels allowed or not, the flag
    restored on every exit."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32_on
    try:
        return fn(*args)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


_DILATION, _NO_OUTPUT_PADDING = (1, 1), (0, 0)


def _conv(tf32_on, x, w, b, stride, padding):
    return _cudnn(tf32_on, torch.ops.aten.convolution, x, w, b, stride, padding, _DILATION,
                  False, _NO_OUTPUT_PADDING, 1)


def _backward(tf32_on, grad, inp, weight, stride, padding, mask):
    """dgrad (mask (True, False, False)) or wgrad (False, True, False)."""
    out = _cudnn(tf32_on, torch.ops.aten.convolution_backward, grad, inp, weight, None, stride,
                 padding, _DILATION, False, _NO_OUTPUT_PADDING, 1, mask)
    return out[0] if mask[0] else out[1]


def forward_3x(x, w, b, stride, padding) -> torch.Tensor:
    """The forward convolution in 3xTF32: hi*hi (with the bias) and the
    small products over their parts concatenated along the input channels,
    summed in fp32."""
    xh, x2 = split(x, X_FWD, 1)
    wh, w2 = split(w, W_FWD, 1)
    conv2d.calls["tf32x3_fwd"] += 1
    small = _conv(True, x2, w2, None, stride, padding)
    del x2, w2
    return _conv(True, xh, wh, b, stride, padding).add_(small)


def dgrad_3x(dy, x, w, stride, padding) -> torch.Tensor:
    """The input's gradient in 3xTF32: the transposed convolutions of
    dy_hi with w_hi and of the output gradient's parts (concatenated along
    its channels) with the weight's (stacked along the output channels),
    summed in fp32. ``x`` gives the shape."""
    dh, d2 = split(dy, DY_DGRAD, 1)
    wh, w2 = split(w, W_DGRAD, 0)
    conv2d.calls["tf32x3_dgrad"] += 1
    small = _backward(True, d2, x, w2, stride, padding, (True, False, False))
    del d2, w2
    return _backward(True, dh, x, wh, stride, padding, (True, False, False)).add_(small)


def _transposed(x, w, stride) -> bool:
    """Whether a training forward runs as a transposed convolution (stride
    1, a kernel wider than 1, a large batch of large maps with many
    channels)."""
    return (stride == (1, 1) and w.shape[-1] > 1 and x.shape[0] >= TRANSPOSED_MIN_BATCH
            and x.shape[1] >= TRANSPOSED_MIN_CHANNELS
            and x.shape[2] * x.shape[3] >= TRANSPOSED_MIN_PIXELS)


def forward_ieee(x, w, b, stride, padding) -> torch.Tensor:
    """The forward convolution in IEEE fp32: cuDNN's forward, or, where
    :func:`_transposed` says so, the gradient of the input of the
    convolution with the flipped, transposed weight, which is the same
    sum: y[o, p] = sum_{c, k} x[c, p + k - pad] w[o, c, k] is dgrad with
    grad x and weight w'[c, o, k] = w[o, c, K - 1 - k] at padding K - 1 - pad."""
    if not _transposed(x, w, stride):
        conv2d.calls["ieee_fwd"] += 1
        return _conv(False, x, w, b, stride, padding)
    kh, kw = w.shape[-2:]
    out = (x.shape[0], w.shape[0], x.shape[2] + 2 * padding[0] - kh + 1,
           x.shape[3] + 2 * padding[1] - kw + 1)
    like = torch.empty(out, device=x.device, memory_format=torch.channels_last)
    wt = w.transpose(0, 1).flip(2, 3).contiguous(memory_format=torch.channels_last)
    conv2d.calls["ieee_fwd_transposed"] += 1
    y = _backward(False, x, like, wt, (1, 1), (kh - 1 - padding[0], kw - 1 - padding[1]),
                  (True, False, False))
    return y if b is None else y.add_(b[:, None, None])


class _StrictConv(torch.autograd.Function):
    """An fp32 convolution whose gradient is recorded: the forward and the
    weight gradient in IEEE fp32, the input gradient in 3xTF32. Saves x
    and w in fp32, as ``F.conv2d`` does."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding, ctx.has_bias = stride, padding, b is not None
        return forward_ieee(x, w, b, stride, padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        s, p = ctx.stride, ctx.padding
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dgrad_3x(dy, x, w, s, p) if need_x else None
        dw = None
        if need_w:
            conv2d.calls["ieee_wgrad"] += 1
            dw = _backward(False, dy, x, w, s, p, (False, True, False))
        db = dy.sum((0, 2, 3)) if ctx.has_bias and need_b else None
        return dx, dw, db, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           padding: IntPair = 0, stride: IntPair = 1) -> torch.Tensor:
    """``F.conv2d(x, w, b, stride, padding)`` (NCHW ``x``, OIHW ``w``, no
    groups or dilation), differentiable in x, w and b. An fp32 CUDA ``x``
    runs the strict paths of the module docstring; bf16 and CPU tensors
    take ``F.conv2d``."""
    if x.device.type == "cuda" and x.dtype == torch.float32:
        if w.dtype != torch.float32 or (b is not None and b.dtype != torch.float32):
            raise TypeError(f"an fp32 convolution takes an fp32 weight and bias, got {w.dtype}"
                            f" and {None if b is None else b.dtype}")
        stride, padding = _pair(stride), _pair(padding)
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
            return _StrictConv.apply(x, w, b, stride, padding)
        return forward_3x(x, w, b, stride, padding)
    conv2d.calls["plain"] += 1
    return F.conv2d(x, w, b, stride, padding)


#: calls by path: the 3xTF32 forward and input gradient, the IEEE forward
#: (cuDNN's, or as a transposed convolution) and weight gradient,
#: F.conv2d, and split-kernel launches (CPU calls of the plain split do
#: not count)
conv2d.calls = {"tf32x3_fwd": 0, "tf32x3_dgrad": 0, "ieee_fwd": 0, "ieee_fwd_transposed": 0,
                "ieee_wgrad": 0, "plain": 0, "split": 0}
