"""Probabilistic U-Net — ``probunet_tpu/models/prob_unet.py`` in PyTorch.

U-Net backbone, axis-aligned Gaussian prior and posterior, and the Fcomb
fusion. Public methods take NHWC inputs like the JAX module. ``sample``
computes the U-Net features once and folds the K prior draws into the batch
axis, K-major, so member ``k`` of input ``b`` uses ``eps[k, b]`` on both
sides. ``elbo`` is the training loss (sum-MSE + beta * KL in fp32); dropout
follows the module's ``train()``/``eval()`` mode and draws from an explicit
generator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from probunet_torch.models.layers import TorchConv, nchw, nhwc
from probunet_torch.models.unet import UNet
from probunet_torch.ops.distributions import DiagGaussian, kl_diag_gaussian
from probunet_torch.utils.device import resolve_device


class AxisAlignedConvGaussian(nn.Module):
    """Conv encoder emitting a diagonal Gaussian over the latent space
    (reference prob_unet.py:8-78). ``encoder`` indices 0, 3, 6, 9 are the
    convs, as in the reference ``nn.Sequential``."""

    def __init__(self, input_channels: int, num_filters: Tuple[int, ...], latent_dim: int,
                 posterior: bool = False, *, device=None, generator=None):
        super().__init__()
        f = dict(device=device, generator=generator)
        self.posterior = posterior
        cin = input_channels * (2 if posterior else 1)
        layers = []
        for cout in num_filters:
            layers += [TorchConv(cin, cout, 3, **f), nn.ReLU(), nn.AvgPool2d(2, 2)]
            cin = cout
        self.encoder = nn.Sequential(*layers)
        self.conv_mu = TorchConv(cin, latent_dim, 1, **f)
        self.conv_log_sigma = TorchConv(cin, latent_dim, 1, **f)

    def forward(self, x: torch.Tensor, target: Optional[torch.Tensor] = None) -> DiagGaussian:
        """x, target: NCHW."""
        if self.posterior and target is not None:
            x = torch.cat([x, target], dim=1)
        h = self.encoder(x).mean(dim=(2, 3), keepdim=True)  # global average pool
        mu = self.conv_mu(h)[:, :, 0, 0]
        log_sigma = self.conv_log_sigma(h)[:, :, 0, 0]
        # fp32 distribution parameters for stable KL/sampling under bf16 compute
        return DiagGaussian(mu.float(), log_sigma.float())


class Fcomb(nn.Module):
    """Fuses U-Net features with the latent z via 1x1 convs
    (reference prob_unet.py:80-121); ``layers`` indices 0, 2, 4 are the convs."""

    def __init__(self, unet_output_channels: int, latent_dim: int, num_classes: int, *,
                 device=None, generator=None):
        super().__init__()
        f = dict(device=device, generator=generator)
        c = unet_output_channels
        self.layers = nn.Sequential(TorchConv(c + latent_dim, c, 1, **f), nn.ReLU(),
                                    TorchConv(c, c, 1, **f), nn.ReLU(),
                                    TorchConv(c, num_classes, 1, **f))

    def forward(self, feature_map: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """feature_map: NHWC (N, H, W, C); z: (N, D). Returns NHWC."""
        n, h, w, _ = feature_map.shape
        zmap = z[:, None, None, :].to(feature_map.dtype).expand(n, h, w, z.shape[-1])
        x = torch.cat([feature_map, zmap], dim=-1)
        return nhwc(self.layers(nchw(x)))


class ProbabilisticUNet(nn.Module):
    """U-Net backbone + prior/posterior Gaussians + Fcomb (prob_unet.py:123-234)."""

    def __init__(self, input_channels: int, num_classes: int, latent_dim: int = 6,
                 num_filters: Tuple[int, ...] = (64, 128, 256, 512), beta: float = 1.0,
                 img_resolution: Tuple[int, int] = (64, 64), dropout: float = 0.10,
                 model_channels: int = 128, channel_mult: Tuple[int, ...] = (1, 2, 3, 4),
                 num_blocks: int = 2, attn_resolutions: Tuple[int, ...] = (32, 16, 8),
                 fast_attention: bool = False, remat: bool = False, *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        f = dict(device=device, generator=generator)
        self.num_classes = num_classes
        self.latent_dim = latent_dim
        self.beta = beta  # ELBO KL weight unless a call passes its own
        self.unet = UNet(img_resolution, input_channels, num_filters[0],
                         model_channels=model_channels, channel_mult=channel_mult,
                         num_blocks=num_blocks, attn_resolutions=attn_resolutions,
                         dropout=dropout, fast_attention=fast_attention, remat=remat, **f)
        self.prior = AxisAlignedConvGaussian(input_channels, tuple(num_filters), latent_dim,
                                             posterior=False, **f)
        self.posterior = AxisAlignedConvGaussian(input_channels, tuple(num_filters), latent_dim,
                                                 posterior=True, **f)
        self.fcomb = Fcomb(num_filters[0], latent_dim, num_classes, **f)

    def forward(self, x: torch.Tensor, target: Optional[torch.Tensor] = None,
                training: bool = True, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One draw: posterior z when ``training`` and a target is given,
        prior z otherwise. x, target: NHWC."""
        features = self.unet(x)
        if training and target is not None:
            dist = self.posterior(nchw(x), nchw(target))
        else:
            dist = self.prior(nchw(x))
        return self.fcomb(features, dist.rsample(generator, eps))

    def elbo(self, x: torch.Tensor, target: torch.Tensor, beta=None,
             generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None):
        """ELBO = sum-MSE reconstruction + beta * sum-KL (prob_unet.py:151-173),
        with a reparameterized posterior draw mu + sigma * eps; ``eps`` (B, D)
        or drawn from ``generator``, which also draws the dropout masks in
        training mode. x, target: NHWC. Returns fp32 (total, recon, kl)."""
        return self._elbo(x, target, lambda post: post.rsample(generator, eps), beta, generator)

    def elbo_with_z(self, x: torch.Tensor, target: torch.Tensor, z: torch.Tensor, beta=None):
        """:meth:`elbo` with a supplied posterior draw ``z`` (prob_unet.py:179-191)."""
        return self._elbo(x, target, lambda post: z, beta, None)

    def _elbo(self, x, target, draw, beta, generator):
        features = self.unet(x, generator=generator)
        prior = self.prior(nchw(x))
        posterior = self.posterior(nchw(x), nchw(target))
        out = self.fcomb(features, draw(posterior))
        recon = (out.float() - target.float()).square().sum()
        kl = kl_diag_gaussian(posterior, prior).sum()
        b = self.beta if beta is None else beta
        return recon + b * kl, recon, kl

    def reconstruct(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Deterministic decode with a supplied latent (no sampling)."""
        return self.fcomb(self.unet(x), z)

    def latent_dists(self, x: torch.Tensor, target: Optional[torch.Tensor] = None):
        """(prior, posterior) DiagGaussians; posterior is None without a target."""
        prior = self.prior(nchw(x))
        posterior = self.posterior(nchw(x), nchw(target)) if target is not None else None
        return prior, posterior

    def sample(self, x: torch.Tensor, num_samples: int,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """K prior-draw ensemble: U-Net features computed once, Fcomb over the
        K*B folded batch (K-major). ``eps``: optional (K, B, D) standard
        normals. Returns (B, K, H, W, C)."""
        features = self.unet(x)                                   # (B, H, W, C) NHWC
        zs = self.prior(nchw(x)).sample(num_samples, generator, eps)  # (K, B, D)
        k = num_samples
        b, h, w, c = features.shape
        feats = features[None].expand(k, b, h, w, c).reshape(k * b, h, w, c)
        outs = self.fcomb(feats, zs.reshape(k * b, -1))
        return outs.reshape(k, b, h, w, self.num_classes).transpose(0, 1)
