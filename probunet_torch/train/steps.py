"""Ensemble sampler — ``make_sample_fn`` of ``probunet_tpu/train/steps.py``.

Per batch: gather the HR tiles from the device-resident dataset tensor,
slice the standardization stats, synthesize the LR input (avg-pool, bilinear
upsample, standardize), draw K prior members with the U-Net features computed
once, and invert the residual to physical HR fields, all on the device.
"""

from __future__ import annotations

from typing import Optional

import torch

from probunet_torch.data import transforms


def make_sample_fn(model, lowres_scale: int, standardization: str, num_samples: int,
                   compute_dtype: torch.dtype = torch.float32):
    """Returns fn(hr_all, stats, idx, generator=None, eps=None) ->
    (hr_preds (B, K, H, W, C) fp32, pair dict). ``eps`` is an optional
    (K, B, latent_dim) tensor of standard normals; else the draws come from
    ``generator``. Runs under ``torch.inference_mode``."""

    @torch.inference_mode()
    def fn(hr_all: torch.Tensor, stats, idx: torch.Tensor,
           generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None):
        hr = hr_all[idx]
        sl = transforms.slice_stats(stats, standardization, idx)
        pair = transforms.make_pair(hr, lowres_scale, standardization, sl)
        x = pair["inputs"].to(compute_dtype)
        preds = model.sample(x, num_samples, generator=generator, eps=eps).float()
        # the stats broadcast over the K axis for the inverse transform
        if sl is not None and standardization != "perpixel":
            sl = (sl[0][:, None], sl[1][:, None])
        hr_preds = transforms.residual_to_hr(preds, pair["lrinterp"][:, None],
                                             standardization, sl)
        return hr_preds, pair

    return fn
