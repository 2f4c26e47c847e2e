"""ADM-style U-Net backbone — ``probunet_tpu/models/unet.py`` in PyTorch.

The encoder/decoder topology, including every skip concat, is the static
:func:`build_unet_plan` of the JAX package (a copy of its pure-Python plan).
Blocks run on NCHW activations in ``channels_last`` memory format; the
public :class:`UNet` takes and returns NHWC like the JAX module. ``norm0``,
``norm1`` (with the embedding's terms) and ``out_norm`` go through kernel K1
(GroupNorm+SiLU), every attention block through kernels K2 and, in the
backward, K3.

The mapping network is ported whole (JAX ``unet.py:239-265``): the noise
embedding ``map_noise`` -> ``map_layer0`` -> SiLU -> ``map_layer1`` with
``use_diffuse`` (the EDM denoiser, ``models/edm.py``), the bias-free
``map_label`` with label dropout when ``label_dim`` > 0, and ``map_augment``.
The embedding is then per sample, (B, 4C). In the downscaling configuration
(``use_diffuse=False, label_dim=0``) it is ``silu(0) = 0``, (1, 4C), and
``map_layer0``/``map_layer1`` exist, unused, so the parameters and their
count match the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from probunet_torch.models.layers import (
    ADM_INIT,
    ADM_INIT_ZERO,
    Conv2d,
    GroupNorm,
    GroupNormSiLU,
    Init,
    Linear,
    PositionalEmbedding,
    dropout,
    nchw,
    nhwc,
    rand_rows,
    silu,
)
from probunet_torch.ops.attention import fused_attention
from probunet_torch.ops.conv import conv2d
from probunet_torch.utils.device import resolve_device

#: an attention block of C channels has C // 64 heads of C // (C // 64)
#: channels each, 64 to 127 (probunet_tpu/models/unet.py:65-70, :234)
CHANNELS_PER_HEAD = 64


class UNetBlock(nn.Module):
    """Residual block with optional resampling and self-attention
    (reference networks.py:132-185), with the JAX block's fields: the ADM
    block by default; the DDPM++ block of NVIDIA's SongUNet (CorrDiff's
    ``ddpmpp-cwb``) with ``num_heads=1, skip_scale=sqrt(1/2), eps=1e-6,
    resample_proj=True, adaptive_scale=False``. ``num_heads`` None gives
    C // 64 heads. ``norm1`` is a :class:`GroupNormSiLU` with the embedding's
    terms in the same kernel K1 launch: with ``adaptive_scale`` the affine
    map gives a (scale, shift) pair per channel, ``silu(GN(x) * (1 + scale) +
    shift)``; without it one shift per channel, added before the norm,
    ``silu(GN(x + shift))``. ``skip_scale`` multiplies the residual sum, and
    again the attention's."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 up: bool = False, down: bool = False, attention: bool = False,
                 fast_attention: bool = False, num_heads: Optional[int] = None,
                 dropout: float = 0.0, skip_scale: float = 1.0, eps: float = 1e-5,
                 resample_proj: bool = False, adaptive_scale: bool = True,
                 init: Init = Init(), init_zero: Init = Init(weight=0.0), *,
                 device=None, generator=None):
        super().__init__()
        f = dict(device=device, generator=generator)
        self.fast_attention = fast_attention
        self.dropout = dropout
        self.skip_scale = skip_scale
        self.adaptive_scale = adaptive_scale
        self.heads = ((num_heads if num_heads is not None else out_channels // CHANNELS_PER_HEAD)
                      if attention else 0)
        self.norm0 = GroupNormSiLU(in_channels, eps=eps, **f)
        self.conv0 = Conv2d(in_channels, out_channels, 3, up=up, down=down, init=init, **f)
        # adaptive scale: the affine map gives a (scale, shift) pair per channel
        self.affine = Linear(emb_channels, out_channels * (2 if adaptive_scale else 1),
                             init=init, **f)
        self.norm1 = GroupNormSiLU(out_channels, eps=eps, **f)
        self.conv1 = Conv2d(out_channels, out_channels, 3, init=init_zero, **f)
        self.skip = None
        if out_channels != in_channels or up or down:
            kernel = 1 if resample_proj or out_channels != in_channels else 0
            self.skip = Conv2d(in_channels, out_channels, kernel, up=up, down=down,
                               init=init, **f)
        if self.heads:
            self.norm2 = GroupNorm(out_channels, eps=eps, **f)
            self.qkv = Conv2d(out_channels, out_channels * 3, 1, init=init, **f)
            self.proj = Conv2d(out_channels, out_channels, 1, init=init_zero, **f)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """``generator`` draws the dropout mask in training mode, as
        ``shard``'s (rank, world) rows of the global batch's mask."""
        orig = x
        x = self.conv0(self.norm0(x))
        params = self.affine(emb).float()  # (B|1, 2C or C), K1's fp32 operands
        if self.adaptive_scale:
            scale, shift = params.chunk(2, dim=1)
            x = self.norm1(x, scale=scale, shift=shift)
        else:
            x = self.norm1(x, shift_in=params)
        x = dropout(x, self.dropout, self.training, generator, shard)
        x = self.conv1(x)
        if self.skip is not None:
            orig = self.skip(orig)
        x = x + orig
        if self.skip_scale != 1:  # the ADM blocks skip the multiply by 1
            x = x * self.skip_scale
        if self.heads:
            x = x + self.attend(x, self.fast_attention)
            if self.skip_scale != 1:
                x = x * self.skip_scale
        return x

    def attend(self, x: torch.Tensor, fast: bool) -> torch.Tensor:
        """The attention layer's residual, ``proj(attention(norm2(x)))``,
        on NCHW channels_last ``x`` through K2 (K3 in the backward); the
        spatial forward runs it on the gathered map with ``fast=False``."""
        b, c, h, w = x.shape
        nh = self.heads
        # The reference's output channels factor as (head, channel, qkv),
        # qkv last ((B*nh, C/nh, 3, HW) reshape, networks.py:180). The conv
        # runs with its weight and bias rows reordered to (qkv, head,
        # channel), the same math, so that q, k and v come out as views with
        # a unit-stride head dim that the attention kernels read in place;
        # the parameters keep the reference's layout.
        y = conv2d(self.norm2(x), _qkv_major(self.qkv.weight, nh, x.dtype),
                   _qkv_major(self.qkv.bias, nh, x.dtype))
        q, k, v = nhwc(y).reshape(b, h * w, 3, nh, c // nh).unbind(2)
        a = fused_attention(q, k, v, fast)
        return self.proj(nchw(a.reshape(b, h, w, c)))


def _qkv_major(p: torch.Tensor, heads: int, dtype: torch.dtype) -> torch.Tensor:
    """The qkv conv's weight or bias in ``dtype`` with its rows from (head,
    channel, qkv) order to (qkv, head, channel) order, in one copy."""
    t = p.reshape(heads, -1, 3, *p.shape[1:]).transpose(0, 2).transpose(1, 2)
    return t.to(dtype, memory_format=torch.contiguous_format).reshape(p.shape)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Static description of one encoder/decoder entry."""

    name: str          # torch-compatible key, e.g. "64x64_block0"
    kind: str          # "conv" | "block"
    in_channels: int
    out_channels: int
    up: bool = False
    down: bool = False
    attention: bool = False
    concat_skip: int = 0  # decoder: channels concatenated from the skip stack before the block


def build_unet_plan(
    img_resolution: Tuple[int, int],
    in_channels: int,
    model_channels: int,
    channel_mult: Sequence[int],
    num_blocks: int,
    attn_resolutions: Sequence[int],
    bottleneck_attention: bool = True,
    ddpmpp: bool = False,
) -> Tuple[List[BlockSpec], List[BlockSpec], int]:
    """The full encoder/decoder topology, replicating the reference
    constructor's channel bookkeeping (networks.py:258-298) including the
    runtime concat rule (networks.py:327-330) resolved statically.

    ``ddpmpp``: the topology of the DDPM++ U-Net (NVIDIA's SongUNet, the
    EDM code base's networks.py): the first conv gives ``model_channels``,
    and a decoder level's blocks attend only on its last block (``idx ==
    num_blocks``), where the ADM U-Net attends on each of them.

    Returns (encoder_specs, decoder_specs, final_channels).
    """
    enc: List[BlockSpec] = []
    cout = in_channels
    for level, mult in enumerate(channel_mult):
        resx = img_resolution[0] >> level
        resy = img_resolution[1] >> level
        if level == 0:
            cin, cout = cout, model_channels * (1 if ddpmpp else mult)
            enc.append(BlockSpec(f"{resx}x{resy}_conv", "conv", cin, cout))
        else:
            enc.append(BlockSpec(f"{resx}x{resy}_down", "block", cout, cout, down=True))
        for idx in range(num_blocks):
            cin, cout = cout, model_channels * mult
            enc.append(BlockSpec(f"{resx}x{resy}_block{idx}", "block", cin, cout,
                                 attention=(resx in attn_resolutions)))
    skips = [s.out_channels for s in enc]

    dec: List[BlockSpec] = []
    for level, mult in reversed(list(enumerate(channel_mult))):
        resx = img_resolution[0] >> level
        resy = img_resolution[1] >> level
        if level == len(channel_mult) - 1:
            dec.append(BlockSpec(f"{resx}x{resy}_in0", "block", cout, cout,
                                 attention=bottleneck_attention))
            dec.append(BlockSpec(f"{resx}x{resy}_in1", "block", cout, cout))
        else:
            dec.append(BlockSpec(f"{resx}x{resy}_up", "block", cout, cout, up=True))
        for idx in range(num_blocks + 1):
            cin = cout + skips.pop()
            cout = model_channels * mult
            attend = resx in attn_resolutions and (idx == num_blocks or not ddpmpp)
            dec.append(BlockSpec(f"{resx}x{resy}_block{idx}", "block", cin, cout,
                                 attention=attend))
    resolved: List[BlockSpec] = []
    cur = enc[-1].out_channels
    for spec in dec:
        concat = spec.in_channels - cur if spec.in_channels != cur else 0
        if concat < 0:
            raise AssertionError("decoder channel bookkeeping mismatch")
        resolved.append(dataclasses.replace(spec, concat_skip=concat))
        cur = spec.out_channels
    return enc, resolved, cout


def gn_silu_sites(enc: List[BlockSpec], dec: List[BlockSpec], final_channels: int,
                  img_resolution: Tuple[int, int]) -> List[Tuple[int, int, int]]:
    """(H, W, C) of every GroupNorm+SiLU (kernel K1) call in one forward of
    the U-Net that ``build_unet_plan`` describes: each block's ``norm0`` at
    its input's resolution (a down block's conv halves it after the norm,
    an up block's doubles it) and ``norm1`` at its output's, then
    ``out_norm`` (the DDPM++ ``aux_norm``)."""
    sites = []
    for spec in enc + dec:
        if spec.kind == "block":
            out = [int(v) for v in spec.name.split("_")[0].split("x")]
            hw = [v * 2 if spec.down else v // 2 if spec.up else v for v in out]
            sites.append((hw[0], hw[1], spec.in_channels))
            sites.append((out[0], out[1], spec.out_channels))
    return sites + [(img_resolution[0], img_resolution[1], final_channels)]


def remat_block(block: UNetBlock, x: torch.Tensor, emb: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """``block(x, emb, generator, shard)`` with its activations dropped after the
    forward and recomputed in the backward (``torch.utils.checkpoint``, the
    counterpart of the JAX package's ``nn.remat(UNetBlock)``).

    ``checkpoint``'s ``preserve_rng_state`` restores only the global RNGs,
    not a ``torch.Generator`` object: a recompute drawing from ``generator``
    would take the masks after the forward's and give silently wrong
    gradients. So the generator's state is snapshotted before the forward,
    and the recompute draws from a copy of that snapshot, which leaves
    ``generator`` where the forward left it."""
    snapshot = generator.get_state() if generator is not None else None
    calls = [0]

    def run(x, emb):
        gen = generator
        if calls[0] and snapshot is not None:  # a recompute: replay the forward's draws
            gen = torch.Generator(generator.device)
            gen.set_state(snapshot)
        calls[0] += 1
        return block(x, emb, gen, shard)

    return torch.utils.checkpoint.checkpoint(run, x, emb, use_reentrant=False)


class UNet(nn.Module):
    """The ADM architecture (reference networks.py:224-333). ``forward``
    takes and returns NHWC. With ``remat``, every :class:`UNetBlock` is
    recomputed in the backward (:func:`remat_block`) whenever grad is
    enabled. ``bottleneck_attention`` gives the bottleneck's first block an
    attention layer whatever ``attn_resolutions`` says (the reference's
    networks.py:284-285); the deterministic baseline turns it off
    (baseline/deterministic_unet.py:283-284).

    ``ddpmpp``: the DDPM++ U-Net instead (NVIDIA's SongUNet with
    ``embedding_type="positional"``, ``channel_mult_noise=1``, standard
    encoder and decoder, resampling filter [1, 1]; CorrDiff's ``ddpmpp-cwb``
    at its widths): its topology (``build_unet_plan(ddpmpp=True)``), its
    block (:class:`UNetBlock`'s DDPM++ fields: one head, ``skip_scale``
    sqrt(1/2), eps 1e-6, a 1x1 skip conv on every resampling block, the
    embedding as a shift), the noise embedding always on
    (``PositionalEmbedding(endpoint=True)`` with its cos and sin halves
    swapped, then ``map_layer0``, SiLU, ``map_layer1``, SiLU), and the
    output ``aux_conv(silu(aux_norm(x)))``, held as the decoder's
    ``<res>x<res>_aux_norm`` and ``_aux_conv`` as SongUNet names them.
    It draws the ADM U-Net's inits: it is only served, from weights loaded
    into it. Labels and augmentation are the ADM U-Net's only."""

    def __init__(self, img_resolution: Tuple[int, int], in_channels: int, out_channels: int,
                 label_dim: int = 0, augment_dim: int = 0, model_channels: int = 128,
                 channel_mult: Tuple[int, ...] = (1, 2, 3, 4), channel_mult_emb: int = 4,
                 num_blocks: int = 2, attn_resolutions: Tuple[int, ...] = (32, 16, 8),
                 dropout: float = 0.10, label_dropout: float = 0.0, use_diffuse: bool = False,
                 bottleneck_attention: bool = True, fast_attention: bool = False,
                 remat: bool = False, ddpmpp: bool = False, *, device=None, generator=None):
        super().__init__()
        if ddpmpp and (label_dim or augment_dim):
            raise ValueError("the DDPM++ U-Net takes no labels or augmentation here")
        device = resolve_device(device)
        f = dict(device=device, generator=generator)
        self.remat = remat
        self.ddpmpp = ddpmpp
        self.label_dropout = label_dropout
        self.emb_channels = emb = model_channels * channel_mult_emb  # networks.py:233
        self.enc_specs, self.dec_specs, final_c = build_unet_plan(
            tuple(img_resolution), in_channels, model_channels, channel_mult, num_blocks,
            attn_resolutions, bottleneck_attention, ddpmpp)
        # the mapping network (networks.py:249-253); map_layer0/1 are
        # constructed unconditionally, as the reference does
        self.map_noise = (PositionalEmbedding(model_channels, endpoint=ddpmpp)
                          if use_diffuse or ddpmpp else None)
        self.map_layer0 = Linear(model_channels, emb, init=ADM_INIT, **f)
        self.map_layer1 = Linear(emb, emb, init=ADM_INIT, **f)
        self.map_label = self.map_augment = None
        if label_dim:
            self.map_label = Linear(label_dim, emb, Init("kaiming_normal", math.sqrt(label_dim)),
                                    use_bias=False, **f)
        if augment_dim:
            self.map_augment = Linear(augment_dim, model_channels, ADM_INIT_ZERO, use_bias=False,
                                      **f)
        block_kw = dict(emb_channels=emb, fast_attention=fast_attention,
                        dropout=dropout, init=ADM_INIT, init_zero=ADM_INIT_ZERO, **f)
        if ddpmpp:   # SongUNet's block_kwargs
            block_kw.update(num_heads=1, skip_scale=math.sqrt(0.5), eps=1e-6, resample_proj=True,
                            adaptive_scale=False)

        def make(spec: BlockSpec) -> nn.Module:
            if spec.kind == "conv":
                return Conv2d(spec.in_channels, spec.out_channels, 3, init=ADM_INIT, **f)
            return UNetBlock(spec.in_channels, spec.out_channels, up=spec.up, down=spec.down,
                             attention=spec.attention, **block_kw)

        self.enc = nn.ModuleDict({s.name: make(s) for s in self.enc_specs})
        self.dec = nn.ModuleDict({s.name: make(s) for s in self.dec_specs})
        if ddpmpp:
            res = f"{img_resolution[0]}x{img_resolution[1]}"
            self.aux_names = (f"{res}_aux_norm", f"{res}_aux_conv")
            self.dec[self.aux_names[0]] = GroupNormSiLU(final_c, eps=1e-6, **f)
            self.dec[self.aux_names[1]] = Conv2d(final_c, out_channels, 3, init=ADM_INIT_ZERO,
                                                 **f)
        else:
            self.out_norm = GroupNormSiLU(final_c, **f)
            self.out_conv = Conv2d(final_c, out_channels, 3, init=ADM_INIT_ZERO, **f)

    def embedding(self, x: torch.Tensor, noise_labels: Optional[torch.Tensor] = None,
                  class_labels: Optional[torch.Tensor] = None,
                  augment_labels: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """The blocks' embedding (JAX ``unet.py:239-265``): (B, 4C), or (1, 4C)
        with neither labels nor noise. In training mode, label dropout keeps
        each sample's labels where ``uniform(B, 1) >= label_dropout``, drawn
        from ``generator`` as ``shard``'s rows of the global batch's draw."""
        emb = torch.zeros(1, self.emb_channels, dtype=x.dtype, device=x.device)
        if self.map_label is not None:
            tmp = class_labels.to(x.dtype)
            if self.training and self.label_dropout:
                keep = rand_rows((x.shape[0], 1), generator, x.device, shard)
                tmp = tmp * (keep >= self.label_dropout).to(tmp.dtype)
            emb = self.map_label(tmp)
        if self.map_noise is not None:
            emb_n = self.map_noise(noise_labels)
            if self.ddpmpp:   # SongUNet swaps the cos and sin halves
                emb_n = emb_n.reshape(emb_n.shape[0], 2, -1).flip(1).reshape(emb_n.shape)
            emb_n = silu(self.map_layer0(emb_n))
            emb = emb + self.map_layer1(emb_n)
        if self.map_augment is not None and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels)
        return silu(emb)

    def forward(self, x: torch.Tensor, noise_labels: Optional[torch.Tensor] = None,
                class_labels: Optional[torch.Tensor] = None,
                augment_labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """NHWC in and out. In training mode the label dropout and then every
        block's dropout mask are drawn from ``generator``, in block order;
        ``shard`` = (rank, world) makes each draw the rank's rows of the
        global batch's (``layers.rand_rows``)."""
        emb = self.embedding(x, noise_labels, class_labels, augment_labels, generator, shard)
        x = nchw(x)  # channels_last strides when x is a contiguous NHWC tensor
        run = remat_block if self.remat and torch.is_grad_enabled() else (
            lambda blk, *args: blk(*args))
        skips = []
        for spec in self.enc_specs:
            blk = self.enc[spec.name]
            x = blk(x) if spec.kind == "conv" else run(blk, x, emb, generator, shard)
            skips.append(x)
        for spec in self.dec_specs:
            if spec.concat_skip:
                x = torch.cat([x, skips.pop()], dim=1)
            x = run(self.dec[spec.name], x, emb, generator, shard)
        if self.ddpmpp:
            norm, conv = (self.dec[name] for name in self.aux_names)
        else:
            norm, conv = self.out_norm, self.out_conv
        return nhwc(conv(norm(x)))
