"""Operations and bytes of one call, counted from the shapes.

The plain reference runs on the ``meta`` device at the cell's shapes, so
the count is the same whatever implements the work. The model's FLOPs are
``torch.utils.flop_counter.FlopCounterMode``'s (convolutions and matrix
products, forward and backward). Each convolution, attention and fused
GroupNorm+SiLU site also gets its own FLOPs and bytes, for the rooflines:

- convolution: direct-convolution FLOPs; bytes of the input, weight and
  output (backward: the output gradient, input and weight read, the input
  and weight gradients written), each once;
- attention, per (B, L, heads, c): forward 4 B h L^2 c FLOPs, q, k, v read
  and o written; backward 8 B h L^2 c (the four products a backward needs
  given the forward's softmax), q, k, v, o, dO read, dq, dk, dv written
  and the fp32 row statistics read;
- GroupNorm+SiLU forward: x read once and the output written once.

Bytes are at the mode's activation size (``itemsize``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.unet import Attention, GroupNormSiLU

aten = torch.ops.aten


def conv_flops(x_shape, w_shape, out_shape) -> float:
    """2 * N * Cout * Ho * Wo * (Cin / groups) * kh * kw."""
    return 2.0 * out_shape[0] * math.prod(out_shape[1:]) * math.prod(w_shape[1:])


class _ConvSites(TorchDispatchMode):
    def __init__(self, itemsize: int):
        super().__init__()
        self.itemsize = itemsize
        self.sites: List[Dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        n = lambda t: t.numel() * self.itemsize  # noqa: E731
        if func is aten.convolution.default:
            x, w = args[0], args[1]
            self.sites.append({"pass": "fwd", "flops": conv_flops(x.shape, w.shape, out.shape),
                               "bytes": n(x) + n(w) + n(out)})
        elif func is aten.convolution_backward.default:
            go, x, w = args[0], args[1], args[2]
            mask = args[-1]
            f = conv_flops(x.shape, w.shape, go.shape)
            written = (n(x) if mask[0] else 0) + (n(w) if mask[1] else 0)
            self.sites.append({"pass": "bwd", "flops": f * (int(mask[0]) + int(mask[1])),
                               "bytes": n(go) + n(x) + n(w) + written})
        return out


def count(model: torch.nn.Module, run: Callable[[], None], itemsize: int,
          backward: bool) -> Dict:
    """Counts of one ``run()`` of the meta ``model`` (which runs the forward
    and, with ``backward``, the backward): {"flops", "conv", "attn", "gn"},
    the last three lists of per-site {"flops", "bytes"}."""
    attn, gn, hooks = [], [], []

    def on_attn(mod, args, out):
        qkv, heads = args
        b, c3, h, w = qkv.shape
        c, L = c3 // 3 // heads, h * w
        elems = b * L * heads * c
        attn.append({"pass": "fwd", "flops": 4.0 * b * heads * L * L * c,
                     "bytes": 4 * elems * itemsize})
        if backward:
            attn.append({"pass": "bwd", "flops": 8.0 * b * heads * L * L * c,
                         "bytes": 8 * elems * itemsize + 4 * b * heads * L})

    def on_gn(mod, args, out):
        gn.append({"pass": "fwd", "flops": 0.0, "bytes": 2 * args[0].numel() * itemsize})

    for m in model.modules():
        if isinstance(m, Attention):
            hooks.append(m.register_forward_hook(on_attn))
        elif isinstance(m, GroupNormSiLU):
            hooks.append(m.register_forward_hook(on_gn))
    convs = _ConvSites(itemsize)
    flop_mode = FlopCounterMode(display=False)
    try:
        with flop_mode, convs:
            run()
    finally:
        for h in hooks:
            h.remove()
    return {"flops": float(flop_mode.get_total_flops()), "conv": convs.sites, "attn": attn,
            "gn": gn}
