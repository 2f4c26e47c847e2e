"""FourCastNet (Pathak et al. 2022, arXiv:2202.11214; ``networks/afnonet.py``
of NVlabs/FourCastNet, backbone settings ``config/AFNO.yaml``) as a
downscaler of the port: its Adaptive Fourier Neural Operator backbone
(Guibas et al., arXiv:2111.13587) over the standardized LR interpolation on
the HR grid, mapping it to the standardized residual, as ClimaX does here.

For C channels in and out on an (H, W) grid, patch p, tokens on the (h, w) =
(H / p, W / p) grid of width D:

1. Tokenizer: ``Conv2d(C, D, p, stride p)`` with bias (here one product
   over the unfolded patches, the same sum), plus the learned ``pos_embed``
   (1, h w, D), then dropout (``pos_drop``); tokens reshaped (B, h, w, D).
2. ``depth`` double-skip blocks: ``x = filter(LN1 x) + x``, then ``x = x +
   drop_path(drop(fc2(drop(GELU(fc1(LN2 x))))))``; LayerNorm eps 1e-6,
   exact GELU, block i's drop_path rate ``linspace(0, drop_path, depth)[i]``.
3. The filter, ``AFNO2D`` (:class:`AFNO2D`), in fp32 whatever x's dtype,
   at ``AFNO.yaml``'s ``num_blocks`` 8 and ``AFNONet``'s defaults
   ``sparsity_threshold`` 0.01 and ``hard_thresholding_fraction`` 1.
4. The head ``Linear(D, C p^2, bias=False)``, unpatchified ``b h w (p1 p2
   c) -> b (h p1) (w p2) c``. ``forward_features`` applies no final
   LayerNorm: the published ``norm`` is built and never used, so it is left
   out here (a parameter with no gradient would still decay under AdamW).

Random draws, in this order, from the step's dropout generator, each as the
shard's rows of the global batch's draw (``layers.rand_rows``): the
``pos_drop`` mask (B, h w, D); then per block the MLP's hidden mask (B, h,
w, mlp_ratio D), its output mask (B, h, w, D) and its drop_path (B, 1). A
rate of 0 draws nothing (the published rates are 0). Activations are in
x's dtype (the step's compute dtype); parameters are fp32 and cast on use,
except the filter's, which it uses in fp32. Parameter names are
``afnonet.py``'s ``state_dict`` keys less ``norm``; the init is its own:
``pos_embed`` and the Linears normal(0.02) (timm's ``trunc_normal_``, cut at
+-2 absolute), zero Linear biases, LayerNorms 1 and 0, PyTorch's default
``Conv2d`` init for the tokenizer, ``0.02 * randn`` for the filter's
weights and biases.

Spans: ``probunet.tokenize`` (step 1), ``probunet.spectral`` (each block's
filter, 12 a forward at the published depth) and ``probunet.head`` (step
4), inside the step's ``probunet.forward``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from probunet_torch.models.climax import unpatchify
from probunet_torch.models.layers import (
    VIT_INIT,
    LayerNorm,
    Linear,
    Mlp,
    _Layer,
    drop_path,
    token_dropout,
    torch_default_init,
)
from probunet_torch.utils.logging import span

#: LayerNorm eps of every FourCastNet norm (``partial(nn.LayerNorm, eps=1e-6)``)
LN_EPS = 1e-6


#: the filter's block-diagonal blocks (``AFNO.yaml``'s ``num_blocks``)
NUM_BLOCKS = 8
#: softshrink's threshold on the second layer's modes (``sparsity_threshold``)
SPARSITY = 0.01


def kept_columns(h: int, w: int) -> int:
    """The rfft2 columns ``AFNO2D`` transforms on an (h, w) grid: the
    published slice ``[total - kept : total + kept, :kept]`` at
    ``hard_thresholding_fraction`` 1 (``kept = total = h // 2 + 1``) takes
    every row and the first h // 2 + 1 columns of the w // 2 + 1 (46 of 91
    at 90 x 180): the longitudinal wavenumbers from there on are zeroed."""
    return min(w // 2 + 1, h // 2 + 1)


class AFNO2D(_Layer):
    """``AFNO2D(D, NUM_BLOCKS, SPARSITY, 1.0)`` on tokens (B, h, w, D) in any
    dtype, computed in fp32 and returned in x's dtype: ``X = rfft2(x,
    norm="ortho")`` over (h, w), a two-layer block-diagonal complex MLP on
    the kept modes (every row, :func:`kept_columns` columns) with ``w1``,
    ``w2`` (2, nb, D / nb, D / nb) and ``b1``, ``b2`` (2, nb, D / nb) (index
    0 the real part, 1 the imaginary), ReLU between, softshrink of the
    second layer's real and imaginary parts, every other mode 0, then
    ``irfft2(.., s=(h, w), norm="ortho") + x``.

    Each layer of each block is one real product of the (re, im)-interleaved
    mode vector (2 D / nb) with the (2 D / nb)^2 matrix [[w0, w1], [-w1,
    w0]] laid out to match: the sums of the published four einsums, with no
    zero-filled buffers. The products are IEEE fp32 where TF32 is off (the
    training steps' ``full_fp32``), as the published module under AMP."""

    def __init__(self, dim: int, *, device=None, generator=None):
        super().__init__()
        if dim % NUM_BLOCKS:
            raise ValueError(f"AFNO2D needs D a multiple of {NUM_BLOCKS}, got {dim}")
        self.block_size = dim // NUM_BLOCKS
        nb, bs = NUM_BLOCKS, self.block_size
        self.w1 = self._param(2, nb, bs, bs, device=device)
        self.b1 = self._param(2, nb, bs, device=device)
        self.w2 = self._param(2, nb, bs, bs, device=device)
        self.b2 = self._param(2, nb, bs, device=device)
        self._fill(device, generator)

    def reset_parameters(self, generator=None) -> None:
        for p in (self.w1, self.b1, self.w2, self.b2):
            p.copy_(0.02 * torch.randn(p.shape, generator=generator))

    def _matrix(self, w: torch.Tensor) -> torch.Tensor:
        """(nb, 2 bs, 2 bs): row 2 i + a (input i, a = re / im), column 2 o
        + c (output o, c = re / im)."""
        re, im = w[0], w[1]
        m = torch.stack([torch.stack([re, im], -1), torch.stack([-im, re], -1)], 2)
        return m.reshape(NUM_BLOCKS, 2 * self.block_size, 2 * self.block_size)

    def _bias(self, b: torch.Tensor) -> torch.Tensor:
        return torch.stack([b[0], b[1]], -1).reshape(NUM_BLOCKS, 1, 2 * self.block_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("probunet.spectral"):
            b, h, w, d = x.shape
            c1 = kept_columns(h, w)
            spec = torch.fft.rfft2(x.float(), dim=(1, 2), norm="ortho")
            # (nb, modes, 2 bs): each block's (re, im) pairs, one row a kept mode
            t = torch.view_as_real(spec[:, :, :c1]).reshape(-1, NUM_BLOCKS, 2 * self.block_size)
            t = t.transpose(0, 1)
            o = torch.relu(torch.baddbmm(self._bias(self.b1), t, self._matrix(self.w1)))
            o = torch.baddbmm(self._bias(self.b2), o, self._matrix(self.w2))
            o = F.softshrink(o, SPARSITY)
            o = o.transpose(0, 1).reshape(b, h, c1, d, 2)
            # irfft2 zero-fills the columns from c1 up to w // 2 + 1
            y = torch.fft.irfft2(torch.view_as_complex(o), s=(h, w), dim=(1, 2), norm="ortho")
            return y.to(x.dtype) + x


class Block(nn.Module):
    """``afnonet.py``'s ``Block`` with ``double_skip``: the filter's residual,
    then the MLP's, with ``drop`` in the MLP and ``drop_path`` on its branch."""

    def __init__(self, dim: int, mlp_ratio: float, drop: float, drop_path: float, *,
                 device=None, generator=None):
        super().__init__()
        self.drop_path = drop_path
        kw = dict(device=device, generator=generator)
        self.norm1 = LayerNorm(dim, LN_EPS, **kw)
        self.filter = AFNO2D(dim, **kw)
        self.norm2 = LayerNorm(dim, LN_EPS, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, **kw)

    def forward(self, x: torch.Tensor, generator=None, shard=(0, 1)) -> torch.Tensor:
        x = self.filter(self.norm1(x)) + x
        m = self.mlp(self.norm2(x), generator, shard)
        return x + drop_path(m, self.drop_path, self.training, generator, shard)


class _PatchProj(_Layer):
    """``Conv2d(C, D, p, stride p)``'s weight (D, C, p, p) and bias (D), at
    PyTorch's default init: U(-1 / sqrt(C p^2), 1 / sqrt(C p^2)) both."""

    def __init__(self, in_chans: int, embed_dim: int, patch: int, *, device=None,
                 generator=None):
        super().__init__()
        self.weight = self._param(embed_dim, in_chans, patch, patch, device=device)
        self.bias = self._param(embed_dim, device=device)
        self._fill(device, generator)

    def reset_parameters(self, generator=None) -> None:
        fan_in = self.weight[0].numel()
        self.weight.copy_(torch_default_init(self.weight.shape, fan_in, generator))
        self.bias.copy_(torch_default_init(self.bias.shape, fan_in, generator))


class PatchEmbed(nn.Module):
    """``afnonet.py``'s ``PatchEmbed`` (its ``proj``)."""

    def __init__(self, in_chans: int, embed_dim: int, patch: int, *, device=None,
                 generator=None):
        super().__init__()
        self.proj = _PatchProj(in_chans, embed_dim, patch, device=device, generator=generator)


class FourCastNet(_Layer):
    """``AFNONet`` on NHWC fields (B, H, W, C_in) -> (B, H, W, C_out), the
    module docstring's equations. ``img_size`` (H, W) must be multiples of
    ``patch_size``; ``embed_dim`` a multiple of :data:`NUM_BLOCKS`."""

    def __init__(self, img_size: Sequence[int], in_chans: int, out_chans: int,
                 patch_size: int = 8, embed_dim: int = 768, depth: int = 12,
                 mlp_ratio: float = 4.0, drop_rate: float = 0.0, drop_path: float = 0.0, *,
                 device=None, generator=None):
        super().__init__()
        h, w = img_size
        if h % patch_size or w % patch_size or embed_dim % NUM_BLOCKS:
            raise ValueError(f"FourCastNet needs a grid in whole patches and D in whole filter "
                             f"blocks, got {tuple(img_size)}, patch {patch_size}, D {embed_dim}, "
                             f"{NUM_BLOCKS} blocks")
        self.patch_size, self.out_chans = patch_size, out_chans
        self.grid = (h // patch_size, w // patch_size)
        self.embed_dim, self.drop_rate = embed_dim, drop_rate
        # drawn first, as :func:`layers.reset_parameters` redraws (this module first)
        self.pos_embed = self._param(1, self.grid[0] * self.grid[1], embed_dim, device=device)
        self._fill(device, generator)
        kw = dict(device=device, generator=generator)
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size, **kw)
        rates = torch.linspace(0, drop_path, depth, device="cpu").tolist()
        self.blocks = nn.ModuleList(Block(embed_dim, mlp_ratio, drop_rate, r, **kw)
                                    for r in rates)
        self.head = Linear(embed_dim, out_chans * patch_size ** 2, VIT_INIT, use_bias=False, **kw)

    def reset_parameters(self, generator=None) -> None:
        self.pos_embed.copy_(VIT_INIT.weight * torch.randn(self.pos_embed.shape,
                                                           generator=generator))

    def tokenize(self, x: torch.Tensor, generator=None, shard=(0, 1)) -> torch.Tensor:
        """Step 1: NHWC x (B, H, W, C) -> tokens (B, h, w, D) in x's dtype."""
        b, _, _, c = x.shape
        (gh, gw), p, d = self.grid, self.patch_size, self.embed_dim
        patches = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
        patches = patches.reshape(b, gh * gw, c * p * p)                 # (c, p1, p2) a row
        proj = self.patch_embed.proj
        t = F.linear(patches, proj.weight.reshape(d, -1).to(x.dtype), proj.bias.to(x.dtype))
        t = token_dropout(t + self.pos_embed.to(x.dtype), self.drop_rate, self.training,
                          generator, shard)
        return t.view(b, gh, gw, d)

    def forward(self, x: torch.Tensor, class_labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """NHWC x (B, H, W, C_in) -> (B, H, W, C_out) in x's dtype.
        ``class_labels`` (the deterministic steps' time features) are accepted
        and not read; ``generator`` and ``shard`` give the dropout draws
        (module docstring)."""
        del class_labels
        with span("probunet.tokenize"):
            x = self.tokenize(x, generator, shard)
        for blk in self.blocks:
            x = blk(x, generator, shard)
        with span("probunet.head"):
            return unpatchify(self.head(x), self.grid, self.patch_size, self.out_chans)
