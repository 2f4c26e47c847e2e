"""Group normalization (NHWC, fp32 statistics) — ``probunet_tpu/ops/norm.py``.

Statistics are always two-pass fp32, whatever the activation dtype. This is
the plain version: ``norm2`` of every attention block runs it as it is, and
the GroupNorm+SiLU kernel (``ops/gn_silu.py``) is held against
:func:`group_norm_silu`.
"""

from __future__ import annotations

import torch


def num_groups_for(num_channels: int, num_groups: int = 32, min_channels_per_group: int = 4) -> int:
    """Reference group-count rule (networks.py:98)."""
    return min(num_groups, num_channels // min_channels_per_group)


def group_stats(x: torch.Tensor, num_groups: int, eps: float = 1e-5):
    """(B, G) fp32 mean and rstd = 1/sqrt(var + eps) of NHWC ``x``, two-pass."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3))
    var = (xf - mean[:, None, :, None]).square().mean(dim=(1, 3))
    return mean, torch.rsqrt(var + eps)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """NHWC group norm; normalizes each (H, W, C/G) group like torch's NCHW
    group_norm normalizes (C/G, H, W). Returns x's dtype."""
    b, h, w, c = x.shape
    g = num_groups
    xf = x.float().reshape(b, h, w, g, c // g)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xf * weight.float() + bias.float()).to(x.dtype)


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm then SiLU, unfused."""
    y = group_norm(x, weight, bias, num_groups, eps)
    return y * torch.sigmoid(y)
