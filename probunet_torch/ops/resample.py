"""Spatial resampling on NHWC tensors — ``probunet_tpu/ops/resample.py``.

Bilinear upsampling is two small dense fp32 matmuls (one per spatial axis)
with precomputed half-pixel weights, equal to
``F.interpolate(mode="bilinear", align_corners=False)``. The JAX package runs
them at ``Precision.HIGHEST``; here they run with TF32 off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from probunet_torch.utils.device import full_fp32


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k average pooling over NHWC (or HWC) input."""
    if k == 1:
        return x
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    b, h, w, c = x.shape
    out = x.reshape(b, h // k, k, w // k, k, c).mean(dim=(2, 4))
    return out[0] if squeeze else out


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(n_in: int, scale: int) -> np.ndarray:
    """(n_in*scale, n_in) float32 matrix of torch half-pixel bilinear upsampling."""
    n_out = n_in * scale
    w = np.zeros((n_out, n_in), dtype=np.float32)
    for i in range(n_out):
        src = (i + 0.5) / scale - 0.5
        i0 = int(np.floor(src))
        frac = src - i0
        lo = min(max(i0, 0), n_in - 1)
        hi = min(max(i0 + 1, 0), n_in - 1)
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return w


@functools.lru_cache(maxsize=64)
def _bilinear_tensor(n_in: int, scale: int, device: torch.device,
                     dtype: torch.dtype) -> torch.Tensor:
    """:func:`_bilinear_matrix` on ``device``, copied there once."""
    return torch.from_numpy(_bilinear_matrix(n_in, scale)).to(device, dtype)


def bilinear_upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear x``scale`` upsampling of NHWC (or HWC) input via two matmuls."""
    if scale == 1:
        return x
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    b, h, w, c = x.shape
    wh = _bilinear_tensor(h, scale, x.device, x.dtype)
    ww = _bilinear_tensor(w, scale, x.device, x.dtype)
    # out[b, i, j, c] = sum_{h,w} Wh[i,h] Ww[j,w] x[b,h,w,c]
    with full_fp32():
        out = torch.einsum("ih,bhwc->biwc", wh, x)
        out = torch.einsum("jw,biwc->bijc", ww, out)
    return out[0] if squeeze else out


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling over NHWC (the reference's
    conv_transpose2d with the [1,1] filter scaled by 4)."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)
