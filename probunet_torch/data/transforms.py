"""LR/HR pair synthesis and standardization on NHWC tensors —
``probunet_tpu/data/transforms.py``.

    input  = standardized bilinear-upsampled LR          (lrinterp_stand)
    target = standardized residual hr_stand - lrinterp_stand
    hr_pred = lrinterp + invstand(residual_pred)

Four standardization modes, with statistics from the same split's LR data:
none | perpixel | pertimestep | minmax. Torch's conventions are kept:
unbiased std (ddof=1), eps=1e-10 added to std (or to max-min) at use time.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from probunet_torch.ops.resample import avg_pool, bilinear_upsample

EPSILON = 1e-10

Stats = Tuple[torch.Tensor, torch.Tensor]


def compute_lr_stats(hr: torch.Tensor, lowres_scale: int, standardization: str) -> Optional[Stats]:
    """Standardization statistics from the LR (avg-pooled HR) data.

    hr: (T, H, W, C). Returns a pair whose shapes depend on the mode:
      perpixel     -> ((H, W, C) mean, (H, W, C) std), LR stats repeated to HR grid
      pertimestep  -> ((T, 1, 1, C) mean, (T, 1, 1, C) std)
      minmax       -> ((T, 1, 1, C) min, (T, 1, 1, C) max)
      none         -> None
    """
    if standardization == "none":
        return None
    lr = avg_pool(hr, lowres_scale)
    if standardization == "perpixel":
        s = lowres_scale
        mean = lr.mean(dim=0)
        std = lr.std(dim=0, correction=1)
        up = lambda a: a.repeat_interleave(s, dim=0).repeat_interleave(s, dim=1)  # noqa: E731
        return up(mean), up(std)
    if standardization == "pertimestep":
        return (lr.mean(dim=(1, 2), keepdim=True),
                lr.std(dim=(1, 2), correction=1, keepdim=True))
    if standardization == "minmax":
        return lr.amin(dim=(1, 2), keepdim=True), lr.amax(dim=(1, 2), keepdim=True)
    raise ValueError(f"unknown standardization {standardization!r}")


def _scale_of(stats: Stats, standardization: str) -> torch.Tensor:
    """The denominator of the standardization (std+eps or max-min+eps)."""
    if standardization == "minmax":
        return stats[1] - stats[0] + EPSILON
    return stats[1] + EPSILON


def make_pair(hr: torch.Tensor, lowres_scale: int, standardization: str,
              stats: Optional[Stats]) -> Dict[str, torch.Tensor]:
    """One batch of pairs from HR tiles (NHWC). ``stats`` must already be
    sliced per sample for pertimestep/minmax (leading axis B). Returns
    inputs/targets/hr/lr/lrinterp/stand_stats."""
    lr = avg_pool(hr, lowres_scale)
    lrinterp = bilinear_upsample(lr, lowres_scale)
    if standardization == "none":
        inputs, targets = lrinterp, hr - lrinterp
    else:
        scale = _scale_of(stats, standardization)
        inputs = (lrinterp - stats[0]) / scale
        targets = (hr - lrinterp) / scale  # hr_stand - lrinterp_stand, same denominator
    return {"inputs": inputs, "targets": targets, "hr": hr, "lr": lr,
            "lrinterp": lrinterp,
            "stand_stats": None if standardization == "none" else stats}


def invstand_residual(residual: torch.Tensor, standardization: str,
                      stats: Optional[Stats]) -> torch.Tensor:
    """Inverse standardization of a residual."""
    if standardization == "none":
        return residual
    return residual * _scale_of(stats, standardization)


def residual_to_hr(residual: torch.Tensor, lrinterp: torch.Tensor, standardization: str,
                   stats: Optional[Stats]) -> torch.Tensor:
    """Predicted residual -> physical HR field."""
    return lrinterp + invstand_residual(residual, standardization, stats)


def slice_stats(stats: Optional[Stats], standardization: str,
                idx: torch.Tensor) -> Optional[Stats]:
    """Per-sample stats for a batch index vector (no-op for global modes)."""
    if stats is None or standardization == "perpixel":
        return stats
    return stats[0][idx], stats[1][idx]
