"""CorrDiff (Mardani et al. 2023, arXiv:2309.15214) in plain PyTorch: the
regression and residual DDPM++ U-Nets of NVIDIA's ``ddpmpp-cwb`` (SongUNet
of the EDM code base, positional embedding, standard encoder and decoder,
resampling filter [1, 1]), the ``EDMPrecondSR`` denoiser and the two-stage
sampler.

Written from the published equations with ``reference/unet.py``'s classes,
so that ``counts.py`` finds its convolution, attention and GroupNorm+SiLU
sites as it finds the ADM U-Net's. The DDPM++ block, beside the ADM one:

    h = conv0(silu(GN(x)));  h = silu(GN(h + affine(emb)));  h = conv1(h)
    x = (h + skip(x)) / sqrt(2);  x = (x + proj(attn(GN(x)))) / sqrt(2)

with one attention head of all the block's channels, GroupNorm eps 1e-6,
a 1x1 skip conv on every resampling block, attention in the decoder only on
a level's last block, and the output ``aux_conv(silu(aux_norm(x)))``. The
embedding: sin and cos (that order) of sigma's noise label at frequencies
(1/10000)^(i / (C/2 - 1)), then ``map_layer0``, SiLU, ``map_layer1``, SiLU.

Stages: ``mu = F_reg([0, x]; 0)``; ``D(r; sigma, x) = c_skip r + c_out
F_res([c_in r, x]; ln(sigma) / 4)`` with the condition unscaled; member k
is ``mu + r_k``, ``r_k`` from the Heun chain of ``reference/edm.py``.
Parameter names are the program's ``state_dict`` keys (``reg.…``, ``res.…``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference import unet
from perfbench.reference.edm import heun_chain
from perfbench.reference.unet import Attention, Conv, Linear, fp32_math, make_pair

EPS = 1e-6
SKIP_SCALE = math.sqrt(0.5)


class GroupNorm(unet.GroupNorm):
    """The reference's group norm at eps 1e-6."""

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, eps=EPS)


class GroupNormSiLU(unet.GroupNormSiLU):
    """GroupNorm at eps 1e-6, then SiLU (the program's kernel K1)."""

    def forward(self, x):
        return F.silu(F.group_norm(x, self.groups, self.weight, self.bias, eps=EPS))


class Block(nn.Module):
    """The DDPM++ residual block (see the module's docstring)."""

    def __init__(self, cin: int, cout: int, emb: int, up=False, down=False, attention=False):
        super().__init__()
        self.attention = attention
        self.norm0 = GroupNormSiLU(cin)
        self.conv0 = Conv(cin, cout, 3, up=up, down=down)
        self.affine = Linear(emb, cout)
        self.norm1 = GroupNormSiLU(cout)
        self.conv1 = Conv(cout, cout, 3)
        self.skip = Conv(cin, cout, 1, up=up, down=down) if cout != cin or up or down else None
        if attention:
            self.norm2 = GroupNorm(cout)
            self.qkv = Conv(cout, 3 * cout, 1)
            self.attn = Attention()
            self.proj = Conv(cout, cout, 1)

    def forward(self, x, emb):
        orig = x
        x = self.conv0(self.norm0(x))
        x = self.conv1(self.norm1(x + self.affine(emb)[:, :, None, None]))
        x = (x + (orig if self.skip is None else self.skip(orig))) * SKIP_SCALE
        if self.attention:
            x = (x + self.proj(self.attn(self.qkv(self.norm2(x)), 1))) * SKIP_SCALE
        return x


def songunet_plan(res: int, cin: int, mc: int, mult: Sequence[int], nblocks: int,
                  attn_res: Sequence[int]) -> Tuple[List[tuple], List[tuple], int]:
    """(encoder, decoder, final channels) of SongUNet, entries as
    ``unet.unet_plan``'s: (name, kind, cin, cout, up, down, attention, concat)."""
    enc, cout = [], cin
    for level, m in enumerate(mult):
        r = res >> level
        if level == 0:
            enc.append((f"{r}x{r}_conv", "conv", cout, mc, False, False, False, 0))
            cout = mc
        else:
            enc.append((f"{r}x{r}_down", "block", cout, cout, False, True, False, 0))
        for i in range(nblocks):
            enc.append((f"{r}x{r}_block{i}", "block", cout, mc * m, False, False, r in attn_res, 0))
            cout = mc * m
    skips = [e[3] for e in enc]
    dec = []
    for level, m in reversed(list(enumerate(mult))):
        r = res >> level
        if level == len(mult) - 1:
            dec.append((f"{r}x{r}_in0", "block", cout, cout, False, False, True, 0))
            dec.append((f"{r}x{r}_in1", "block", cout, cout, False, False, False, 0))
        else:
            dec.append((f"{r}x{r}_up", "block", cout, cout, True, False, False, 0))
        for i in range(nblocks + 1):
            skip = skips.pop()
            dec.append((f"{r}x{r}_block{i}", "block", cout + skip, mc * m, False, False,
                        i == nblocks and r in attn_res, skip))
            cout = mc * m
    return enc, dec, cout


def noise_embedding(noise_labels: torch.Tensor, channels: int) -> torch.Tensor:
    half = channels // 2
    freqs = (1.0 / 10000) ** (torch.arange(half, dtype=torch.float32,
                                           device=noise_labels.device) / (half - 1))
    x = torch.outer(noise_labels, freqs)
    return torch.cat([torch.sin(x), torch.cos(x)], dim=1)


class SongUNet(nn.Module):
    """NHWC in and out; ``noise_labels`` (B,)."""

    def __init__(self, res: int, cin: int, cout: int, model_channels: int,
                 channel_mult: Sequence[int], num_blocks: int, attn_resolutions: Sequence[int]):
        super().__init__()
        mc = self.mc = model_channels
        emb = 4 * mc
        self.enc_plan, self.dec_plan, final = songunet_plan(res, cin, mc, channel_mult,
                                                            num_blocks, attn_resolutions)
        self.map_layer0 = Linear(mc, emb)
        self.map_layer1 = Linear(emb, emb)

        def make(e):
            name, kind, ci, co, up, down, attention, _ = e
            return Conv(ci, co, 3) if kind == "conv" else Block(ci, co, emb, up, down, attention)

        self.enc = nn.ModuleDict({e[0]: make(e) for e in self.enc_plan})
        self.dec = nn.ModuleDict({e[0]: make(e) for e in self.dec_plan})
        self.aux = (f"{res}x{res}_aux_norm", f"{res}x{res}_aux_conv")
        self.dec[self.aux[0]] = GroupNormSiLU(final)
        self.dec[self.aux[1]] = Conv(final, cout, 3)

    def forward(self, x_nhwc, noise_labels):
        emb = F.silu(self.map_layer0(noise_embedding(noise_labels, self.mc)))
        emb = F.silu(self.map_layer1(emb))
        x = x_nhwc.permute(0, 3, 1, 2)
        skips = []
        for e in self.enc_plan:
            blk = self.enc[e[0]]
            x = blk(x) if e[1] == "conv" else blk(x, emb)
            skips.append(x)
        for e in self.dec_plan:
            if e[7]:
                x = torch.cat([x, skips.pop()], dim=1)
            x = self.dec[e[0]](x, emb)
        return self.dec[self.aux[1]](self.dec[self.aux[0]](x)).permute(0, 2, 3, 1)


class CorrDiff(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        nv = len(cfg["variables"])
        self.nv, self.sigma_data = nv, cfg["sigma_data"]
        args = (cfg["resolution"][0], 2 * nv, nv, cfg["model_channels"], cfg["channel_mult"],
                cfg["num_blocks"], cfg["attn_resolutions"])
        self.reg = SongUNet(*args)
        self.res = SongUNet(*args)

    def regression(self, x):
        """mu of the conditions x (B, H, W, C)."""
        zeros = torch.zeros(*x.shape[:-1], self.nv, device=x.device)
        return self.reg(torch.cat([zeros, x], dim=-1), torch.zeros(x.shape[0], device=x.device))

    def forward(self, r, sigma, cond):
        """D(r; sigma, cond): r, cond (B, H, W, C); sigma (B,)."""
        sd = self.sigma_data
        s = sigma.reshape(-1, 1, 1, 1)
        c_skip = sd ** 2 / (s ** 2 + sd ** 2)
        c_out = s * sd / torch.sqrt(s ** 2 + sd ** 2)
        c_in = 1 / torch.sqrt(sd ** 2 + s ** 2)
        f = self.res(torch.cat([c_in * r, cond], dim=-1), torch.log(sigma) / 4)
        return c_skip * r + c_out * f


def sample_residuals(model: CorrDiff, hr_all, stats, idx, noise, cfg: Dict,
                     skip_step: Optional[int] = None) -> Dict:
    """K members per day of ``idx``, the chains' noise K-major in ``noise``
    (K * B, H, W, C): the standardized residuals mu + r_k (B, K, H, W, C)
    and the pair."""
    model.eval()
    with torch.no_grad(), fp32_math():
        pair = make_pair(hr_all[idx], cfg["lowres_scale"], stats)
        x = pair["inputs"]
        b = x.shape[0]
        k = noise.shape[0] // b
        mu = model.regression(x)
        cond = x[None].expand(k, *x.shape).reshape(k * b, *x.shape[1:])
        r = heun_chain(model, cond, noise, cfg["edm_steps"], cfg["sigma_min"], cfg["sigma_max"],
                       cfg["rho"], skip_step)
        members = mu[None] + r.reshape(k, b, *r.shape[1:])
        return {"residual": members.transpose(0, 1), "pair": pair}
