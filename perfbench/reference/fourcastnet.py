"""FourCastNet (Pathak et al. 2022, arXiv:2202.11214; ``networks/afnonet.py``
of NVlabs/FourCastNet, ``config/AFNO.yaml``'s backbone) in plain PyTorch, as
a downscaler: the standardized LR interpolation on the HR grid in, the
standardized residual out, an MSE loss, Adam(W). fp32 with TF32 off
(``fp32_math``); every product's operands pass ``Ref.q`` (the controls of
``unet.py``).

Written from the published module, line for line where it computes:
``PatchEmbed``'s ``Conv2d(C, D, p, stride p)``, ``pos_embed``, ``pos_drop``,
the reshape to (B, h, w, D); ``depth`` double-skip ``Block``s (LayerNorm eps
1e-6; ``AFNO2D``: ``x.float()``, ``rfft2(norm="ortho")``, zero-filled
``o1``/``o2`` buffers, the slice ``[total - kept : total + kept, :kept]``
assigned from ``einsum("...bi,bio->...bo")`` products with ReLU, ``stack``,
``softshrink``, ``view_as_complex``, ``irfft2(s=(H, W), norm="ortho")``,
cast back and the input added; the GELU MLP); the head ``Linear(D, C p^2,
bias=False)`` and the rearrange ``b h w (p1 p2 c) -> b (h p1) (w p2) c``
(NHWC here). Parameter names are the program's ``state_dict`` keys.

Departures, each the same numbers as the published module:

- the unused final ``norm`` (built by ``AFNONet``, never applied in
  ``forward_features``) is left out, as in the program;
- the FFTs are not products and do not pass ``Ref.q``;
- dropout and stochastic depth draw uniforms from the generator given, in
  the order the program documents (``probunet_torch/models/fourcastnet.py``):
  ``pos_drop`` (B, L, D); per block the MLP's hidden layer (B, h, w, 4D) and
  output (B, h, w, D), its drop_path (B, 1); a rate of 0 draws nothing (the
  published rates are 0). An element (a sample, for drop_path) is kept
  where its uniform is below 1 - rate and scaled by 1 / (1 - rate).

A step at the benchmark's 720x1440 runs in parts of one row
(``reference/climax.py::train_readings``' ``chunk``): one fp32 sample holds
~12 GB of activations.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.climax import drop_path, dropout
from perfbench.reference.unet import Linear, Ref, _param

LN_EPS = 1e-6


class AFNO2D(Ref):
    """``AFNO2D(hidden_size, num_blocks, sparsity_threshold,
    hard_thresholding_fraction, hidden_size_factor=1)``."""

    def __init__(self, hidden_size: int, num_blocks: int, sparsity_threshold: float,
                 hard_thresholding_fraction: float):
        super().__init__()
        self.hidden_size, self.num_blocks = hidden_size, num_blocks
        self.block_size = hidden_size // num_blocks
        self.sparsity_threshold = sparsity_threshold
        self.hard_thresholding_fraction = hard_thresholding_fraction
        self.w1 = _param(2, num_blocks, self.block_size, self.block_size)
        self.b1 = _param(2, num_blocks, self.block_size)
        self.w2 = _param(2, num_blocks, self.block_size, self.block_size)
        self.b2 = _param(2, num_blocks, self.block_size)

    def _mm(self, x, w):
        return torch.einsum("...bi,bio->...bo", self.q(x), self.q(w))

    def forward(self, x):
        bias = x
        dtype = x.dtype
        x = x.float()
        B, H, W, C = x.shape
        x = torch.fft.rfft2(x, dim=(1, 2), norm="ortho")
        x = x.reshape(B, H, W // 2 + 1, self.num_blocks, self.block_size)
        o1_real = torch.zeros([B, H, W // 2 + 1, self.num_blocks, self.block_size],
                              device=x.device)
        o1_imag = torch.zeros([B, H, W // 2 + 1, self.num_blocks, self.block_size],
                              device=x.device)
        o2_real = torch.zeros(x.shape, device=x.device)
        o2_imag = torch.zeros(x.shape, device=x.device)
        total_modes = H // 2 + 1
        kept_modes = int(total_modes * self.hard_thresholding_fraction)
        rows = slice(total_modes - kept_modes, total_modes + kept_modes)
        cols = slice(None, kept_modes)
        o1_real[:, rows, cols] = F.relu(
            self._mm(x[:, rows, cols].real, self.w1[0])
            - self._mm(x[:, rows, cols].imag, self.w1[1]) + self.b1[0])
        o1_imag[:, rows, cols] = F.relu(
            self._mm(x[:, rows, cols].imag, self.w1[0])
            + self._mm(x[:, rows, cols].real, self.w1[1]) + self.b1[1])
        o2_real[:, rows, cols] = (
            self._mm(o1_real[:, rows, cols], self.w2[0])
            - self._mm(o1_imag[:, rows, cols], self.w2[1]) + self.b2[0])
        o2_imag[:, rows, cols] = (
            self._mm(o1_imag[:, rows, cols], self.w2[0])
            + self._mm(o1_real[:, rows, cols], self.w2[1]) + self.b2[1])
        x = torch.stack([o2_real, o2_imag], dim=-1)
        x = F.softshrink(x, lambd=self.sparsity_threshold)
        x = torch.view_as_complex(x)
        x = x.reshape(B, H, W // 2 + 1, C)
        x = torch.fft.irfft2(x, s=(H, W), dim=(1, 2), norm="ortho")
        x = x.type(dtype)
        return x + bias


class Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(d, hidden)
        self.fc2 = Linear(hidden, d)


class Block(nn.Module):
    def __init__(self, cfg: Dict, path: float):
        super().__init__()
        d = cfg["embed_dim"]
        self.drop, self.path = cfg["dropout"], path
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.filter = AFNO2D(d, cfg["num_blocks"], cfg["sparsity_threshold"],
                             cfg["hard_thresholding_fraction"])
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp = Mlp(d, int(d * cfg["mlp_ratio"]))

    def _drop(self, x, gen, shard):
        return dropout(x, self.drop, gen, shard) if self.training and self.drop else x

    def forward(self, x, gen=None, shard=(0, 1)):
        residual = x
        x = self.norm1(x)
        x = self.filter(x)
        x = x + residual              # double_skip
        residual = x
        x = self.norm2(x)
        x = self._drop(F.gelu(self.mlp.fc1(x)), gen, shard)
        x = self._drop(self.mlp.fc2(x), gen, shard)
        if self.training and self.path:
            x = drop_path(x.flatten(1, 2), self.path, gen, shard).view_as(x)
        return x + residual


class _Proj(Ref):
    """``Conv2d(C, D, p, stride=p)``."""

    def __init__(self, c: int, d: int, p: int):
        super().__init__()
        self.p = p
        self.weight = _param(d, c, p, p)
        self.bias = _param(d)

    def forward(self, x):
        return F.conv2d(self.q(x), self.q(self.weight), self.bias, stride=self.p)


class PatchEmbed(nn.Module):
    def __init__(self, c: int, d: int, p: int):
        super().__init__()
        self.proj = _Proj(c, d, p)

    def forward(self, x):   # (B, C, H, W) -> (B, L, D)
        return self.proj(x).flatten(2).transpose(1, 2)


class FourCastNet(nn.Module):
    """``AFNONet`` with C = ``len(cfg["variables"])`` channels in and out."""

    def __init__(self, cfg: Dict):
        super().__init__()
        h, w = cfg["resolution"]
        d, p, c = cfg["embed_dim"], cfg["patch_size"], len(cfg["variables"])
        self.p, self.c, self.d, self.drop = p, c, d, cfg["dropout"]
        self.h, self.w = h // p, w // p
        self.patch_embed = PatchEmbed(c, d, p)
        self.pos_embed = _param(1, self.h * self.w, d)
        rates = torch.linspace(0, cfg["drop_path"], cfg["depth"], device="cpu").tolist()
        self.blocks = nn.ModuleList(Block(cfg, r) for r in rates)
        self.head = Linear(d, c * p * p, bias=False)

    def forward(self, x_nhwc, gen=None, shard=(0, 1)):
        """(B, H, W, C) -> (B, H, W, C)."""
        b = x_nhwc.shape[0]
        x = self.patch_embed(x_nhwc.permute(0, 3, 1, 2))
        x = x + self.pos_embed
        if self.training and self.drop:
            x = dropout(x, self.drop, gen, shard)
        x = x.reshape(b, self.h, self.w, self.d)
        for blk in self.blocks:
            x = blk(x, gen, shard)
        x = self.head(x)
        p = self.p
        x = x.reshape(b, self.h, self.w, p, p, self.c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, self.h * p, self.w * p, self.c)
