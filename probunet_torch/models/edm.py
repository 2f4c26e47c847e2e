"""EDM preconditioning wrapper — ``probunet_tpu/models/edm.py`` in PyTorch
(reference networks.py:339-389).

Wraps the ADM :class:`~probunet_torch.models.unet.UNet`, built with its noise
embedding (``use_diffuse=True``), in the EDM c_skip / c_out / c_in / c_noise
scalings (Karras et al.), so the denoiser D(x; sigma) sees the noisy residual
channel-concatenated with the conditioning image. The backbone is
``self.model``, so its parameters read ``model.enc.…`` as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from probunet_torch.models.unet import UNet
from probunet_torch.utils.device import resolve_device


class EDMPrecond(nn.Module):
    """D(x; sigma) = c_skip x + c_out F(c_in [x, cond]; log(sigma) / 4).

    ``in_channels`` counts the backbone's input channels, the noisy image's
    and the condition's together. ``fast_attention`` and ``remat`` go to the
    backbone. The backbone runs in bf16 only with ``use_bf16`` and
    ``force_fp32=False``; otherwise in fp32, whatever dtype ``x`` and the
    condition come in (the scalings are fp32 and promote them)."""

    def __init__(self, img_resolution: Tuple[int, int], in_channels: int, out_channels: int,
                 label_dim: int = 0, use_bf16: bool = False, sigma_data: float = 1.0,
                 model_channels: int = 128, channel_mult: Tuple[int, ...] = (1, 2, 3, 4),
                 num_blocks: int = 2, attn_resolutions: Tuple[int, ...] = (32, 16, 8),
                 dropout: float = 0.10, fast_attention: bool = False, remat: bool = False, *,
                 device=None, generator=None):
        super().__init__()
        self.label_dim = label_dim
        self.use_bf16 = use_bf16
        self.sigma_data = sigma_data
        self.model = UNet(img_resolution, in_channels, out_channels, label_dim=label_dim,
                          model_channels=model_channels, channel_mult=channel_mult,
                          num_blocks=num_blocks, attn_resolutions=attn_resolutions,
                          dropout=dropout, use_diffuse=True, fast_attention=fast_attention,
                          remat=remat, device=resolve_device(device), generator=generator)

    def forward(self, x: torch.Tensor, sigma, condition_img: Optional[torch.Tensor] = None,
                class_labels: Optional[torch.Tensor] = None, force_fp32: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, H, W, C) noisy image, NHWC; sigma: (B,) or a scalar; the
        condition (B, H, W, C') is concatenated on channels. In training
        mode the backbone's dropout draws from ``generator``. Returns the
        fp32 denoised image (B, H, W, C)."""
        in_img = x
        if condition_img is not None:
            dtype = torch.promote_types(x.dtype, condition_img.dtype)
            in_img = torch.cat([x.to(dtype), condition_img.to(dtype)], dim=-1)
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).reshape(-1, 1, 1, 1)
        if self.label_dim:
            class_labels = (torch.zeros(1, self.label_dim, device=x.device)
                            if class_labels is None
                            else class_labels.float().reshape(-1, self.label_dim))
        else:
            class_labels = None
        dtype = torch.bfloat16 if (self.use_bf16 and not force_fp32) else torch.float32

        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sigma ** 2 + sd2)
        c_out = sigma * self.sigma_data / torch.sqrt(sigma ** 2 + sd2)
        c_in = 1 / torch.sqrt(sd2 + sigma ** 2)
        c_noise = torch.log(sigma) / 4

        f_x = self.model((c_in * in_img).to(dtype), noise_labels=c_noise.flatten(),
                         class_labels=class_labels, generator=generator).to(dtype)
        return c_skip * x + c_out * f_x.float()
