"""Primitive layers — ``probunet_tpu/models/layers.py`` in PyTorch idiom.

The same math and weight-init distributions as the JAX package, with torch
layouts: conv weights OIHW, linear weights (out, in), parameter names that
match the reference ``state_dict`` keys. Activations are NCHW tensors in
``torch.channels_last`` memory format, so ``x.permute(0, 2, 3, 1)`` is a
contiguous NHWC view for the NHWC ops and kernels. Parameters are fp32 and
cast to the activation dtype on use.

Every layer takes ``device`` and ``generator``: parameters are created on
``device`` and drawn from ``generator`` (on the CPU, so a seed gives the same
weights on every device); on the ``meta`` device nothing is drawn.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from probunet_torch.ops.conv import conv2d
from probunet_torch.ops.gn_silu import gn_silu
from probunet_torch.ops.norm import group_norm, num_groups_for
from probunet_torch.ops.resample import avg_pool, nearest_upsample_2x


class Init(NamedTuple):
    """Weight-init recipe, mirroring reference ``weight_init`` (networks.py:21-26)."""

    mode: str = "kaiming_normal"
    weight: float = 1.0
    bias: float = 0.0


#: reference networks.py:245 — main init for ADM U-Net blocks
ADM_INIT = Init(mode="kaiming_uniform", weight=math.sqrt(1.0 / 3.0), bias=math.sqrt(1.0 / 3.0))
#: reference networks.py:246 — zero-init for conv1 / out_conv / attn proj
ADM_INIT_ZERO = Init(mode="kaiming_uniform", weight=0.0, bias=0.0)


def _uniform(shape, generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator) * 2.0 - 1.0


def weight_init(shape: Sequence[int], mode: str, fan_in: int, fan_out: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Reference networks.py:21-26 init distributions (fp32, on the CPU)."""
    if mode == "xavier_uniform":
        return math.sqrt(6 / (fan_in + fan_out)) * _uniform(shape, generator)
    if mode == "xavier_normal":
        return math.sqrt(2 / (fan_in + fan_out)) * torch.randn(shape, generator=generator)
    if mode == "kaiming_uniform":
        return math.sqrt(3 / fan_in) * _uniform(shape, generator)
    if mode == "kaiming_normal":
        return math.sqrt(1 / fan_in) * torch.randn(shape, generator=generator)
    raise ValueError(f'Invalid init mode "{mode}"')


def torch_default_init(shape: Sequence[int], fan_in: int,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch.nn.Conv2d / Linear default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return _uniform(shape, generator) / math.sqrt(fan_in)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (contiguous for a channels_last tensor)."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last strides for a contiguous NHWC tensor)."""
    return x.permute(0, 3, 1, 2)


class _Layer(nn.Module):
    """Creates parameters on ``device`` and draws them unless it is ``meta``."""

    def _param(self, *shape, device=None) -> nn.Parameter:
        return nn.Parameter(torch.empty(*shape, device=device))

    def _fill(self, device, generator) -> None:
        if torch.device(device if device is not None else "cpu").type != "meta":
            with torch.no_grad():
                self.reset_parameters(generator)

    def reset_parameters(self, generator=None) -> None:  # pragma: no cover
        raise NotImplementedError


def reset_parameters(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Draw every layer's parameters of ``model`` anew from ``generator``,
    in construction order: the weights a fresh model built with the same
    generator gets."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _Layer):
                m.reset_parameters(generator)


class Conv2d(_Layer):
    """Convolution with optional 2x up/downsampling (reference networks.py:49-90).

    ``kernel=0`` means no learned weight: pure resampling (UNetBlock skips
    whose channel counts match but whose resolution changes). With the
    default [1,1] resample filter, upsampling is pixel replication and
    downsampling a 2x2 average, applied before the convolution.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int, up: bool = False,
                 down: bool = False, init: Init = Init(), *, device=None, generator=None):
        super().__init__()
        self.in_channels, self.out_channels, self.kernel = in_channels, out_channels, kernel
        self.up, self.down, self.init = up, down, init
        self.weight = self.bias = None
        if kernel:
            self.weight = self._param(out_channels, in_channels, kernel, kernel, device=device)
            self.bias = self._param(out_channels, device=device)
        self._fill(device, generator)

    def reset_parameters(self, generator=None) -> None:
        k = self.kernel
        fan_in, fan_out = self.in_channels * k * k, self.out_channels * k * k
        if self.weight is not None:
            self.weight.copy_(weight_init(self.weight.shape, self.init.mode, fan_in, fan_out,
                                          generator) * self.init.weight)
            self.bias.copy_(weight_init(self.bias.shape, self.init.mode, fan_in, fan_out,
                                        generator) * self.init.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up:
            x = nchw(nearest_upsample_2x(nhwc(x)))
        if self.down:
            x = nchw(avg_pool(nhwc(x), 2))
        if self.weight is not None:
            x = conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.kernel // 2)
        return x


class TorchConv(_Layer):
    """Stock conv with torch-default init and 'same' padding (the reference
    builds the prior/posterior encoders and Fcomb from plain ``nn.Conv2d``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, *,
                 device=None, generator=None):
        super().__init__()
        self.kernel = kernel
        self.weight = self._param(out_channels, in_channels, kernel, kernel, device=device)
        self.bias = self._param(out_channels, device=device)
        self._fill(device, generator)

    def reset_parameters(self, generator=None) -> None:
        fan_in = self.weight.shape[1] * self.kernel * self.kernel
        self.weight.copy_(torch_default_init(self.weight.shape, fan_in, generator))
        self.bias.copy_(torch_default_init(self.bias.shape, fan_in, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.kernel // 2)


class Linear(_Layer):
    """Fully-connected layer (reference networks.py:31-44), weight (out, in);
    no bias parameter when ``use_bias`` is False."""

    def __init__(self, in_features: int, out_features: int, init: Init = Init(),
                 use_bias: bool = True, *, device=None, generator=None):
        super().__init__()
        self.in_features, self.out_features, self.init = in_features, out_features, init
        self.weight = self._param(out_features, in_features, device=device)
        self.bias = self._param(out_features, device=device) if use_bias else None
        self._fill(device, generator)

    def reset_parameters(self, generator=None) -> None:
        fi, fo = self.in_features, self.out_features
        self.weight.copy_(weight_init(self.weight.shape, self.init.mode, fi, fo, generator)
                          * self.init.weight)
        if self.bias is not None:
            self.bias.copy_(weight_init(self.bias.shape, self.init.mode, fi, fo, generator)
                            * self.init.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class GroupNorm(_Layer):
    """Learned-affine group norm (reference networks.py:95-105), plain PyTorch
    with two-pass fp32 statistics."""

    def __init__(self, num_channels: int, num_groups: int = 32, min_channels_per_group: int = 4,
                 eps: float = 1e-5, *, device=None, generator=None):
        super().__init__()
        self.num_groups = num_groups_for(num_channels, num_groups, min_channels_per_group)
        self.eps = eps
        self.weight = self._param(num_channels, device=device)
        self.bias = self._param(num_channels, device=device)
        self._fill(device, generator)

    def reset_parameters(self, generator=None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nchw(group_norm(nhwc(x), self.weight, self.bias, self.num_groups, self.eps))


class GroupNormSiLU(GroupNorm):
    """GroupNorm immediately followed by SiLU, through kernel K1
    (``ops/gn_silu.py``). Same parameters as :class:`GroupNorm`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gn_silu(nhwc(x).contiguous(), self.weight, self.bias, self.num_groups, self.eps)
        return nchw(y)


class PositionalEmbedding(nn.Module):
    """DDPM++/ADM timestep embedding (reference networks.py:190-203)."""

    def __init__(self, num_channels: int, max_positions: int = 10000, endpoint: bool = False):
        super().__init__()
        self.num_channels, self.max_positions, self.endpoint = num_channels, max_positions, endpoint

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.num_channels // 2
        freqs = torch.arange(half, dtype=torch.float32, device=x.device)
        freqs = freqs / (half - (1 if self.endpoint else 0))
        freqs = (1.0 / self.max_positions) ** freqs
        x = torch.outer(x, freqs.to(x.dtype))
        return torch.cat([torch.cos(x), torch.sin(x)], dim=1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rand_rows(shape: Sequence[int], generator: Optional[torch.Generator], device,
              shard: Tuple[int, int] = (0, 1), rows: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Uniforms of ``shape`` from ``generator``: with ``shard`` = (rank,
    world), rank's rows of the draw for the global batch of ``world *
    shape[0]`` rows, so a data-parallel rank draws what one process draws
    for the whole global batch (as the JAX package draws over the global
    batch whatever the sharding). ``rows`` = (index, count) does the same
    along axis 1, the height of an NHWC draw: a spatial rank's rows of the
    whole tile's draw."""
    rank, world = shard
    index, count = rows
    b, h = shape[0], shape[1]
    full = torch.rand((b * world, h * count, *shape[2:]), generator=generator, device=device)
    return full[rank * b:(rank + 1) * b, index * h:(index + 1) * h]


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None,
            shard: Tuple[int, int] = (0, 1), rows: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """flax ``nn.Dropout`` on an NCHW channels_last tensor: each element is
    kept with probability 1 - rate and then scaled by 1 / (1 - rate), the
    mask drawn from ``generator`` (on x's device; None means torch's global
    generator) as ``shard``'s rows of the global batch's mask and ``rows``'
    H rows of the whole tile's (:func:`rand_rows`). The identity when not
    ``training`` or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    b, c, h, w = x.shape
    # drawn NHWC so the mask, and the result, keep x's channels_last layout
    mask = nchw(rand_rows((b, h, w, c), generator, x.device, shard, rows) < keep)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
