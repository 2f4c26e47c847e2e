"""The ADM U-Net of the reference (networks.py of prob-unet-mds) in plain PyTorch.

Written from the published equations, not from the measured program: NCHW
tensors, ``F.conv2d``, ``F.group_norm``, an einsum softmax attention and a
Python plan of the encoder/decoder. Parameter names are those of the
program's ``state_dict``, so the benchmark hands both the same weights.

Numerics: every product runs in fp32 with TF32 off (``fp32_math``). A
module's ``precision`` (see :func:`set_precision`) rounds the operands of
every convolution, linear layer and attention product first, and the
gradients that flow back through them: ``"tf32"`` to TF32's 10-bit
mantissa (what TF32 tensor cores read), ``"fp8"`` to float8 with one scale
per tensor (e4m3 forward, e5m2 backward, as fp8 training runs). These are
the controls that must fail the comparison; ``"fp32"`` is the reference
itself.

Dropout draws uniforms of the NHWC shape of each block's activation from
the generator it is given, block by block in encoder then decoder order,
and keeps an element where its uniform is below 1 - rate. With ``shard``
= (j, n) the batch is part j of n equal parts of a larger batch, and the
draw is part j of the larger batch's.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

PRECISIONS = ("fp32", "tf32", "fp8")
FP8_MAX = 448.0


@contextlib.contextmanager
def fp32_math():
    """IEEE fp32 convolutions and matmuls (TF32 off), restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def round_operand(t: torch.Tensor, precision: str, grad: bool = False) -> torch.Tensor:
    """``t`` (fp32) rounded as a product in ``precision`` reads it (``grad``:
    a gradient operand)."""
    if precision == "tf32":   # round to nearest (ties away) at 10 mantissa bits
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    if precision == "fp8":
        dtype, top = ((torch.float8_e5m2, 57344.0) if grad else (torch.float8_e4m3fn, FP8_MAX))
        scale = top / t.abs().amax().clamp_min(1e-30)
        return (t * scale).to(dtype).float() / scale
    raise ValueError(f"unknown precision {precision!r}")


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, precision):
        ctx.precision = precision
        return round_operand(t, precision)

    @staticmethod
    def backward(ctx, g):
        return round_operand(g, ctx.precision, grad=True), None


class Ref(nn.Module):
    """A module whose products round their operands to ``precision``."""

    precision = "fp32"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.precision == "fp32" else _Round.apply(t, self.precision)


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    for m in model.modules():
        if isinstance(m, Ref):
            m.precision = precision
    return model


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


class Conv(Ref):
    """k x k convolution, 'same' padding; with ``up`` nearest 2x upsampling
    and with ``down`` 2x2 averaging before it; ``kernel=0``: resampling only."""

    def __init__(self, cin: int, cout: int, kernel: int, up: bool = False, down: bool = False):
        super().__init__()
        self.kernel, self.up, self.down = kernel, up, down
        if kernel:
            self.weight = _param(cout, cin, kernel, kernel)
            self.bias = _param(cout)

    def forward(self, x):
        if self.up:
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        if self.down:
            x = F.avg_pool2d(x, 2)
        if self.kernel:
            x = F.conv2d(self.q(x), self.q(self.weight), self.bias, padding=self.kernel // 2)
        return x


class Linear(Ref):
    def __init__(self, fin: int, fout: int, bias: bool = True):
        super().__init__()
        self.weight = _param(fout, fin)
        self.bias = _param(fout) if bias else None

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class GroupNorm(nn.Module):
    """Affine group norm with min(32, C // 4) groups, eps 1e-5."""

    def __init__(self, channels: int):
        super().__init__()
        self.groups = min(32, channels // 4)
        self.weight = _param(channels)
        self.bias = _param(channels)

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, eps=1e-5)


class GroupNormSiLU(GroupNorm):
    """GroupNorm then SiLU (the program fuses them: its kernel K1)."""

    def forward(self, x):
        return F.silu(super().forward(x))


class Attention(Ref):
    """softmax(q k^T / sqrt(c)) v over the HW positions of each head; the
    heads' channels and q/k/v interleave as (head, channel, qkv)."""

    def forward(self, qkv: torch.Tensor, heads: int) -> torch.Tensor:
        b, c3, h, w = qkv.shape
        c = c3 // 3
        q, k, v = qkv.reshape(b * heads, c // heads, 3, h * w).unbind(2)
        s = torch.einsum("ncq,nck->nqk", self.q(q), self.q(k / math.sqrt(c // heads)))
        p = torch.softmax(s, dim=2)
        a = torch.einsum("nqk,nck->ncq", self.q(p), self.q(v))
        return a.reshape(b, c, h, w)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    b, c, h, w = x.shape
    j, n = shard
    u = torch.rand((b * n, h, w, c), generator=generator, device=x.device)
    u = u[j * b:(j + 1) * b].permute(0, 3, 1, 2)
    keep = 1.0 - rate
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Block(nn.Module):
    """Residual block: GN+SiLU, conv (with resampling), the embedding's
    scale and shift after a GN, SiLU, dropout, conv; a skip conv where the
    shape changes; self-attention with C // 64 heads."""

    def __init__(self, cin: int, cout: int, emb: int, up=False, down=False, attention=False,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.heads = cout // 64 if attention else 0
        self.norm0 = GroupNormSiLU(cin)
        self.conv0 = Conv(cin, cout, 3, up=up, down=down)
        self.affine = Linear(emb, 2 * cout)
        self.norm1 = GroupNorm(cout)
        self.conv1 = Conv(cout, cout, 3)
        self.skip = None
        if cout != cin or up or down:
            self.skip = Conv(cin, cout, 1 if cout != cin else 0, up=up, down=down)
        if self.heads:
            self.norm2 = GroupNorm(cout)
            self.qkv = Conv(cout, 3 * cout, 1)
            self.attn = Attention()
            self.proj = Conv(cout, cout, 1)

    def forward(self, x, emb, generator=None, shard=(0, 1)):
        orig = x
        x = self.conv0(self.norm0(x))
        scale, shift = self.affine(emb)[:, :, None, None].chunk(2, dim=1)
        x = F.silu(self.norm1(x) * (scale + 1) + shift)
        if self.training and self.dropout_rate:
            x = dropout(x, self.dropout_rate, generator, shard)
        x = self.conv1(x)
        if self.skip is not None:
            orig = self.skip(orig)
        x = x + orig
        if self.heads:
            x = x + self.proj(self.attn(self.qkv(self.norm2(x)), self.heads))
        return x


def unet_plan(res: int, cin: int, mc: int, mult: Sequence[int], nblocks: int,
              attn_res: Sequence[int]) -> Tuple[List[tuple], List[tuple], int]:
    """(encoder, decoder, final channels): entries (name, kind, cin, cout,
    up, down, attention, concat); the decoder concatenates the last skip
    whenever its input is wider than the running activation."""
    enc, cout = [], cin
    for level, m in enumerate(mult):
        r = res >> level
        if level == 0:
            enc.append((f"{r}x{r}_conv", "conv", cout, mc * m, False, False, False, 0))
            cout = mc * m
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
                        r in attn_res, skip))
            cout = mc * m
    return enc, dec, cout


def positional_embedding(x: torch.Tensor, channels: int) -> torch.Tensor:
    half = channels // 2
    freqs = (1.0 / 10000) ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    x = torch.outer(x, freqs)
    return torch.cat([torch.cos(x), torch.sin(x)], dim=1)


class UNet(nn.Module):
    """NHWC in and out. ``noise_embedding``: the EDM denoiser's sigma
    embedding feeds every block; without it the embedding is silu(0) = 0."""

    def __init__(self, res: int, cin: int, cout: int, model_channels: int,
                 channel_mult: Sequence[int], num_blocks: int, attn_resolutions: Sequence[int],
                 dropout_rate: float, noise_embedding: bool = False):
        super().__init__()
        mc = model_channels
        emb = 4 * mc
        self.mc, self.noise_embedding = mc, noise_embedding
        self.emb_channels = emb
        self.enc_plan, self.dec_plan, final = unet_plan(res, cin, mc, channel_mult, num_blocks,
                                                        attn_resolutions)
        self.map_layer0 = Linear(mc, emb)
        self.map_layer1 = Linear(emb, emb)

        def make(e):
            name, kind, ci, co, up, down, attention, _ = e
            if kind == "conv":
                return Conv(ci, co, 3)
            return Block(ci, co, emb, up, down, attention, dropout_rate)

        self.enc = nn.ModuleDict({e[0]: make(e) for e in self.enc_plan})
        self.dec = nn.ModuleDict({e[0]: make(e) for e in self.dec_plan})
        self.out_norm = GroupNormSiLU(final)
        self.out_conv = Conv(final, cout, 3)

    def embedding(self, x, noise_labels):
        if not self.noise_embedding:
            return torch.zeros(1, self.emb_channels, device=x.device)
        e = F.silu(self.map_layer0(positional_embedding(noise_labels, self.mc)))
        return F.silu(self.map_layer1(e))

    def forward(self, x_nhwc, noise_labels=None, generator=None, shard=(0, 1)):
        emb = self.embedding(x_nhwc, noise_labels)
        x = x_nhwc.permute(0, 3, 1, 2)
        skips = []
        for e in self.enc_plan:
            blk = self.enc[e[0]]
            x = blk(x) if e[1] == "conv" else blk(x, emb, generator, shard)
            skips.append(x)
        for e in self.dec_plan:
            if e[7]:
                x = torch.cat([x, skips.pop()], dim=1)
            x = self.dec[e[0]](x, emb, generator, shard)
        return self.out_conv(self.out_norm(x)).permute(0, 2, 3, 1)


# ---- pair synthesis (LR input and HR residual target) ----------------------------------

EPSILON = 1e-10


def lr_of(hr_nhwc: torch.Tensor, scale: int) -> torch.Tensor:
    """k x k block means of NHWC fields."""
    return F.avg_pool2d(hr_nhwc.permute(0, 3, 1, 2), scale).permute(0, 2, 3, 1)


def perpixel_stats(hr_all: torch.Tensor, scale: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel mean and unbiased std over time of the LR fields, repeated
    to the HR grid: ((H, W, C), (H, W, C))."""
    lr = lr_of(hr_all, scale)
    mean, std = lr.mean(dim=0), lr.std(dim=0, correction=1)
    up = lambda a: a.repeat_interleave(scale, 0).repeat_interleave(scale, 1)  # noqa: E731
    return up(mean), up(std)


def make_pair(hr: torch.Tensor, scale: int, stats) -> dict:
    """Standardized bilinear LR interpolation (input) and standardized
    residual (target) of HR tiles (B, H, W, C)."""
    lr = lr_of(hr, scale).permute(0, 3, 1, 2)
    lrinterp = F.interpolate(lr, scale_factor=scale, mode="bilinear",
                             align_corners=False).permute(0, 2, 3, 1)
    mean, std = stats
    denom = std + EPSILON
    return {"inputs": (lrinterp - mean) / denom, "targets": (hr - lrinterp) / denom,
            "lrinterp": lrinterp, "denom": denom}
