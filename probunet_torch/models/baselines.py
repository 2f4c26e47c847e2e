"""Downscaling baselines — ``probunet_tpu/models/baselines.py`` in PyTorch.

- :class:`LinearCNN`: two 3x3 convs (reference baseline/models.py:28-62),
  with the reference's time-embedding MLP behind ``use_time_embedding``
  (off by default, as the reference leaves it out of ``forward``).
- :func:`day_of_year_365` and :func:`bcsd`: the Bias-Correction/Spatial-
  Disaggregation climatology scaling, pred = test LR-interp x day-of-year
  HR climatology / day-of-year LR-interp climatology over the train days.
- :class:`ConvVAE`: the conditional conv-VAE (the reference's ``vae``
  choice), with the surface of
  :class:`~probunet_torch.models.prob_unet.ProbabilisticUNet` (``elbo``,
  ``sample``, ``forward``), so the prob-U-Net's train step, eval, sampler
  and serving take it unchanged; a fixed N(0, I) prior.

Public methods take NHWC inputs like the JAX modules; the convolutions run
NCHW in ``channels_last`` memory format.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from probunet_torch.models.layers import Init, Linear, TorchConv, nchw, nhwc
from probunet_torch.models.prob_unet import AxisAlignedConvGaussian, Fcomb
from probunet_torch.ops.distributions import DiagGaussian, kl_diag_gaussian
from probunet_torch.utils.device import full_fp32, resolve_device


class LinearCNN(nn.Module):
    """Two 3x3 convolutions, in_channels -> latent_channels -> in_channels.
    With ``use_time_embedding`` the class labels ((B, ``label_dim``) time
    features) go through three dense layers (128, 512, H*W units; no
    activation between them, as in the JAX module) to one more input
    channel. Its dense weights are drawn N(0, 1/fan_in) with zero biases
    (flax's ``Dense`` init, untruncated)."""

    def __init__(self, resolution: Tuple[int, int] = (64, 64), in_channels: int = 3,
                 ds_factor: int = 4, latent_channels: int = 10,
                 use_time_embedding: bool = False, label_dim: int = 1, *,
                 device=None, generator=None):
        super().__init__()
        f = dict(device=resolve_device(device), generator=generator)
        self.resolution = tuple(resolution)
        self.time_embed = None
        cin = in_channels
        if use_time_embedding:
            h, w = self.resolution
            dense = Init("kaiming_normal", 1.0, 0.0)
            self.time_embed = nn.Sequential(Linear(label_dim, 128, dense, **f),
                                            Linear(128, 512, dense, **f),
                                            Linear(512, h * w, dense, **f))
            cin += 1
        self.first_conv = TorchConv(cin, latent_channels, 3, **f)
        self.second_conv = TorchConv(latent_channels, in_channels, 3, **f)

    def forward(self, x: torch.Tensor, class_labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """NHWC in and out. ``generator`` and ``shard`` are accepted for the
        surface the deterministic step calls; the model draws nothing."""
        if self.time_embed is not None and class_labels is not None:
            t = self.time_embed(class_labels.float()).reshape(x.shape[0], *self.resolution, 1)
            # fp32 t promotes a bf16 x, as jnp.concatenate does
            x = torch.cat([x, t.expand(*x.shape[:3], 1)], dim=-1)
        return nhwc(self.second_conv(self.first_conv(nchw(x))))


def day_of_year_365(timestamps_ns) -> np.ndarray:
    """Day-of-year index in [0, 365) from float-ns timestamps (host-side
    numpy), from the calendar dates: each timestamp's own year start is
    subtracted, which is exact for real Gregorian dates and for the
    noleap->Gregorian mapping ``data.netcdf.decode_time`` makes (``days %
    365`` drifts one day per leap year). Dec 31 of a leap year clips into
    bin 364. Equals ``ClimexDataset.dayofyear``."""
    ts = np.asarray(timestamps_ns, dtype=np.float64)
    dates = ts.astype(np.int64).astype("datetime64[ns]")
    year_start = dates.astype("datetime64[Y]").astype("datetime64[ns]")
    doy = (dates - year_start) / np.timedelta64(1, "D")
    return np.minimum(np.floor(doy), 364.0).astype(np.int32)


def doy_sums(values: torch.Tensor, doy: torch.Tensor) -> torch.Tensor:
    """Per-day-of-year sums of ``values`` (T, ...) over its leading axis:
    (365, ...), fp32. A one-hot (365, T) product under :func:`full_fp32`,
    so the summation order is fixed and two runs give equal bits (a
    scatter-add such as ``index_add_`` uses atomics on CUDA, whose order
    varies from run to run)."""
    onehot = (doy.to(values.device)[None, :]
              == torch.arange(365, device=values.device)[:, None]).to(values.dtype)
    with full_fp32():
        out = onehot @ values.reshape(values.shape[0], -1)
    return out.reshape(365, *values.shape[1:])


def bcsd(train_hr: torch.Tensor, train_lrinterp: torch.Tensor, test_lrinterp: torch.Tensor,
         train_doy: torch.Tensor, test_doy: torch.Tensor, epsilon: float = 1e-9) -> torch.Tensor:
    """Multiplicative day-of-year climatology correction:

        pred(t) = test_lrinterp(t) * clim_HR(doy(t)) / (clim_LRinterp(doy(t)) + eps)

    ``train_hr``, ``train_lrinterp``: (T_train, H, W, C) physical units;
    ``test_lrinterp``: (T_test, H, W, C); the doy vectors are int day-of-year
    indices in [0, 365). Vectorized over the days (:func:`doy_sums`)."""
    num = doy_sums(train_hr, train_doy)
    den = doy_sums(train_lrinterp, train_doy)
    cnt = doy_sums(torch.ones(train_doy.shape[0], dtype=train_hr.dtype, device=train_hr.device),
                   train_doy)
    cnt = torch.clamp(cnt, min=1.0)[:, None, None, None]
    scale = (num / cnt) / (den / cnt + epsilon)
    return test_lrinterp * scale[test_doy.to(scale.device).long()]


class ConvVAE(nn.Module):
    """Conditional conv-VAE downscaler: a posterior
    :class:`AxisAlignedConvGaussian` over (x, target), two 3x3 conv + ReLU
    feature layers on x, and an :class:`Fcomb` decoder of (features, z);
    the prior is a fixed standard normal. ``elbo`` is sum-MSE + beta * KL in
    fp32, ``sample`` folds K prior draws into the batch axis K-major."""

    def __init__(self, input_channels: int, num_classes: int, latent_dim: int = 6,
                 num_filters: Tuple[int, ...] = (32, 64), beta: float = 1.0,
                 decoder_channels: int = 64, *, device=None, generator=None):
        super().__init__()
        f = dict(device=resolve_device(device), generator=generator)
        self.num_classes = num_classes
        self.latent_dim = latent_dim
        self.beta = beta  # ELBO KL weight unless a call passes its own
        self.posterior = AxisAlignedConvGaussian(input_channels, tuple(num_filters), latent_dim,
                                                 posterior=True, **f)
        self.enc0 = TorchConv(input_channels, decoder_channels, 3, **f)
        self.enc1 = TorchConv(decoder_channels, decoder_channels, 3, **f)
        self.fcomb = Fcomb(decoder_channels, latent_dim, num_classes, **f)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC x -> NHWC features."""
        return nhwc(F.relu(self.enc1(F.relu(self.enc0(nchw(x))))))

    def _prior(self, x: torch.Tensor) -> DiagGaussian:
        zero = torch.zeros(x.shape[0], self.latent_dim, device=x.device)
        return DiagGaussian(zero, zero)   # N(0, I)

    def forward(self, x: torch.Tensor, target: Optional[torch.Tensor] = None,
                training: bool = True, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One draw: posterior z when ``training`` and a target is given,
        prior z otherwise. x, target: NHWC."""
        features = self._features(x)
        dist = (self.posterior(nchw(x), nchw(target)) if training and target is not None
                else self._prior(x))
        return self.fcomb(features, dist.rsample(generator, eps))

    def elbo(self, x: torch.Tensor, target: torch.Tensor, beta=None,
             generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None,
             shard: Tuple[int, int] = (0, 1)):
        """sum-MSE + beta * KL(q(z|x, y) || N(0, I)) with the posterior draw
        mu + sigma * eps; ``eps`` (B, D) or drawn from ``generator``. x,
        target: NHWC. Returns fp32 (total, recon, kl). ``shard`` is accepted
        for the surface the train step calls; the model has no dropout."""
        return self._elbo(x, target, lambda post: post.rsample(generator, eps), beta)

    def elbo_with_z(self, x: torch.Tensor, target: torch.Tensor, z: torch.Tensor, beta=None):
        """:meth:`elbo` with a supplied posterior draw ``z`` (B, D)."""
        return self._elbo(x, target, lambda post: z, beta)

    def _elbo(self, x, target, draw, beta):
        features = self._features(x)
        posterior = self.posterior(nchw(x), nchw(target))
        out = self.fcomb(features, draw(posterior))
        recon = (out.float() - target.float()).square().sum()
        kl = kl_diag_gaussian(posterior, self._prior(x)).sum()
        b = self.beta if beta is None else beta
        return recon + b * kl, recon, kl

    def sample(self, x: torch.Tensor, num_samples: int,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """K standard-normal draws (``eps``: optional (K, B, D)), features
        computed once, the decoder over the K*B folded batch (K-major).
        Returns (B, K, H, W, C)."""
        features = self._features(x)
        zs = self._prior(x).sample(num_samples, generator, eps)     # (K, B, D)
        k = num_samples
        b, h, w, c = features.shape
        feats = features[None].expand(k, b, h, w, c).reshape(k * b, h, w, c)
        outs = self.fcomb(feats, zs.reshape(k * b, -1))
        return outs.reshape(k, b, h, w, self.num_classes).transpose(0, 1)
