"""The EDM diffusion downscaler (Karras et al. 2022, arXiv:2206.00364) in
plain PyTorch: the preconditioned denoiser and the deterministic Heun
sampler over a Karras schedule.

D(x; sigma) = c_skip x + c_out F(c_in [x, cond]; log(sigma) / 4) with
c_skip = sd^2 / (sigma^2 + sd^2), c_out = sigma sd / sqrt(sigma^2 + sd^2),
c_in = 1 / sqrt(sd^2 + sigma^2); F is the ADM U-Net with its noise
embedding, its output the image channels. The sampler takes S Heun steps
from t_0 = sigma_max down to t_{S-1} = sigma_min and then 0, the last
step Euler: 2 S - 1 denoiser passes. Parameter names are the program's
``state_dict`` keys (the backbone is ``model``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from perfbench.reference.unet import UNet, fp32_math, make_pair


class EDMPrecond(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        nv = len(cfg["variables"])
        self.sigma_data = cfg["sigma_data"]
        self.model = UNet(cfg["resolution"][0], 2 * nv, nv, cfg["model_channels"],
                          cfg["channel_mult"], cfg["num_blocks"], cfg["attn_resolutions"],
                          cfg["dropout"], noise_embedding=True)

    def forward(self, x, sigma, cond):
        """x, cond: (B, H, W, C); sigma: (B,)."""
        sd = self.sigma_data
        s = sigma.reshape(-1, 1, 1, 1)
        c_skip = sd ** 2 / (s ** 2 + sd ** 2)
        c_out = s * sd / torch.sqrt(s ** 2 + sd ** 2)
        c_in = 1 / torch.sqrt(sd ** 2 + s ** 2)
        f = self.model(c_in * torch.cat([x, cond], dim=-1), noise_labels=torch.log(sigma) / 4)
        return c_skip * x + c_out * f


def karras_sigmas(steps: int, sigma_min: float, sigma_max: float, rho: float) -> np.ndarray:
    """t_0 > ... > t_{S-1}, then 0, in float32."""
    i = np.arange(steps, dtype=np.float32)
    a, b = np.float32(sigma_max ** (1 / rho)), np.float32(sigma_min ** (1 / rho))
    t = (a + i / np.float32(steps - 1) * (b - a)) ** rho
    return np.concatenate([t.astype(np.float32), np.zeros(1, np.float32)])


def heun_chain(model: EDMPrecond, cond, noise, steps: int, sigma_min: float, sigma_max: float,
               rho: float, skip_step: Optional[int] = None):
    """Residuals from initial standard normals ``noise`` conditioned on
    ``cond``. ``skip_step`` plants a fault: that step leaves x unchanged."""
    t = [float(v) for v in karras_sigmas(steps, sigma_min, sigma_max, rho)]
    b = cond.shape[0]
    x = noise * t[0]

    def d(xk, sigma):
        return model(xk, torch.full((b,), sigma, device=xk.device), cond)

    for i, (t0, t1) in enumerate(zip(t[:-1], t[1:])):
        if i == skip_step:
            continue
        slope = (x - d(x, t0)) / t0
        x_next = x + (t1 - t0) * slope
        if t1 > 0:
            x_next = x + (t1 - t0) * 0.5 * (slope + (x_next - d(x_next, t1)) / t1)
        x = x_next
    return x


def sample_residuals(model: EDMPrecond, hr_all, stats, idx, noise, cfg: Dict,
                     skip_step: Optional[int] = None) -> Dict:
    """K chains per day of ``idx``, K-major in ``noise`` (K * B, H, W, C):
    the standardized residuals (B, K, H, W, C) and the pair."""
    model.eval()
    with torch.no_grad(), fp32_math():
        pair = make_pair(hr_all[idx], cfg["lowres_scale"], stats)
        x = pair["inputs"]
        b = x.shape[0]
        k = noise.shape[0] // b
        cond = x[None].expand(k, *x.shape).reshape(k * b, *x.shape[1:])
        r = heun_chain(model, cond, noise, cfg["edm_steps"], cfg["sigma_min"], cfg["sigma_max"],
                       cfg["rho"], skip_step)
        return {"residual": r.reshape(k, b, *r.shape[1:]).transpose(0, 1), "pair": pair}
