"""CorrDiff, residual corrective diffusion (Mardani et al. 2023,
arXiv:2309.15214), on two DDPM++ U-Nets (NVIDIA's ``ddpmpp-cwb``).

Two stages per input ``x`` (the standardized LR interpolation on the HR
grid). The regression U-Net gives the mean, ``mu = F_reg([0, x]; 0)``: its
first channels are zeros of the output's shape and its noise label is 0,
as NVIDIA's regression wrapper feeds it. The residual U-Net is the
denoiser of an EDM chain on the residual, preconditioned as NVIDIA's
``EDMPrecondSR``:

    D(r; sigma, x) = c_skip r + c_out F_res([c_in r, x]; ln(sigma) / 4)

with the condition ``x`` concatenated unscaled beside ``c_in r`` (the
port's :class:`~probunet_torch.models.edm.EDMPrecond` scales both) and
``sigma_data`` 0.5. A member is ``mu + r``, in the standardized residual
units of the other downscalers. Both U-Nets run in fp32 whatever
``compute_dtype`` says, as the EDM backbone does. Only sampling is built:
the DDPM++ attention's 256-wide head has no backward kernel (K3 stops at
128 columns).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from probunet_torch.models.unet import UNet
from probunet_torch.utils.device import resolve_device


class CorrDiff(nn.Module):
    """``reg`` and ``res``: DDPM++ U-Nets of ``cond_channels + out_channels``
    input channels and ``out_channels`` outputs, at the same widths.
    ``forward`` is the residual denoiser D(r; sigma, x), the model that
    ``train/steps.py::edm_heun_chain`` runs; :meth:`regression` is the mean."""

    def __init__(self, img_resolution: Tuple[int, int], cond_channels: int, out_channels: int,
                 sigma_data: float = 0.5, model_channels: int = 128,
                 channel_mult: Tuple[int, ...] = (1, 2, 2, 2, 2), num_blocks: int = 4,
                 attn_resolutions: Tuple[int, ...] = (28,), dropout: float = 0.10, *,
                 device=None, generator=None):
        super().__init__()
        self.sigma_data = sigma_data
        self.out_channels = out_channels
        kw = dict(img_resolution=img_resolution, in_channels=cond_channels + out_channels,
                  out_channels=out_channels, model_channels=model_channels,
                  channel_mult=channel_mult, num_blocks=num_blocks,
                  attn_resolutions=attn_resolutions, dropout=dropout, ddpmpp=True,
                  device=resolve_device(device), generator=generator)
        self.reg = UNet(**kw)
        self.res = UNet(**kw)

    def regression(self, x: torch.Tensor) -> torch.Tensor:
        """mu = F_reg([0, x]; c_noise = 0): x (B, H, W, C') NHWC; returns
        (B, H, W, out_channels) fp32."""
        x = x.float()
        zeros = x.new_zeros(*x.shape[:-1], self.out_channels)
        noise = x.new_zeros(x.shape[0])
        return self.reg(torch.cat([zeros, x], dim=-1), noise_labels=noise)

    def forward(self, r: torch.Tensor, sigma, condition_img: torch.Tensor) -> torch.Tensor:
        """D(r; sigma, x): r (B, H, W, C) the noisy residual, sigma (B,) or
        a scalar, the condition (B, H, W, C') concatenated unscaled.
        Returns the fp32 denoised residual (B, H, W, C)."""
        r = r.float()
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=r.device).reshape(-1, 1, 1, 1)
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sigma ** 2 + sd2)
        c_out = sigma * self.sigma_data / torch.sqrt(sigma ** 2 + sd2)
        c_in = 1 / torch.sqrt(sd2 + sigma ** 2)
        c_noise = torch.log(sigma) / 4
        arg = torch.cat([c_in * r, condition_img.float()], dim=-1)
        f_x = self.res(arg, noise_labels=c_noise.flatten())
        return c_skip * r + c_out * f_x
