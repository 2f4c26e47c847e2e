"""ClimaX (Nguyen et al., ICML 2023, arXiv:2301.10343; ``src/climax/arch.py``
of microsoft/ClimaX) as a downscaler of the port: a vision transformer over
the standardized LR interpolation on the HR grid, mapping it to the
standardized residual, as the port's deterministic U-Net does.

For V input variables on an (H, W) grid, patch p, L = (H / p)(W / p)
tokens of width D:

1. Variable tokenization: each variable has its own ``Conv2d(1, D, p,
   stride p)`` with bias (here one batched product over the unfolded
   patches, which is the same sum), then the learned ``var_embed`` (1, V,
   D): tokens (B, V, L, D).
2. Variable aggregation: at each of the B L positions one learned query
   ``var_query`` attends over that position's V tokens,
   ``nn.MultiheadAttention(D, heads)`` (in_proj with bias, out_proj with
   bias, no dropout): (B, L, D). The query's projection is taken once.
3. ``pos_embed`` (1, L, D) and ``lead_time_embed``, a ``Linear(1, D)`` of
   the lead time, which is 0 here (downscaling maps fields at one time),
   are added; then dropout (``pos_drop``).
4. ``depth`` pre-LN timm ``Block``s: ``x + drop_path(drop(proj(attn(LN1
   x))))``, then ``x + drop_path(drop(fc2(drop(GELU(fc1(LN2 x))))))``. The
   qkv Linear has a bias and lays its output out as (3, heads, D / heads);
   attention is ``ops/attention.py::fused_attention`` (K2/K3) on the (B, L,
   heads, D / heads) views of that output, read in place; LayerNorm eps
   1e-5; exact GELU; block i's drop_path rate is ``linspace(0, drop_path,
   depth)[i]``.
5. The final LayerNorm, a head of [Linear(D, D), GELU] x ``decoder_depth``
   and ``Linear(D, V p^2)``, unpatchified to NHWC (B, H, W, V).

Random draws, in this order, from the step's dropout generator, each as
the shard's rows of the global batch's draw (``layers.rand_rows``): the
``pos_drop`` mask (B, L, D); then per block the attention's output mask
(B, L, D), its drop_path (B, 1), the MLP's hidden mask (B, L, mlp_ratio D),
its output mask (B, L, D) and its drop_path (B, 1). A rate of 0 draws
nothing (block 0's drop_path). Activations are in x's dtype (the step's
compute dtype); parameters are fp32 and cast on use. Parameter names are
ClimaX's ``state_dict`` keys; the init is ClimaX's (``initialize_weights``):
sincos ``pos_embed`` and ``var_embed``, a zero ``var_query``, timm's
normal(0.02) Linears and tokenizer weights, PyTorch's default tokenizer
biases, xavier-uniform ``in_proj_weight``.

Spans: ``probunet.tokenize`` (steps 1-3 with their dropout) and
``probunet.head`` (step 5's head and unpatchify), inside the step's
``probunet.forward``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from probunet_torch.models.layers import (
    VIT_INIT,
    LayerNorm,
    Linear,
    Mlp,
    _Layer,
    drop_path,
    token_dropout,
    torch_default_init,
    weight_init,
)
from probunet_torch.ops.attention import fused_attention
from probunet_torch.utils.logging import span


def sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    """(len(pos), dim): sin then cos of pos / 10000^(2i / dim) (MAE's
    ``get_1d_sincos_pos_embed_from_grid``, which ClimaX uses)."""
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(dim: int, h: int, w: int) -> np.ndarray:
    """(h w, dim): MAE's ``get_2d_sincos_pos_embed``, the first half of the
    channels from a token's column, the second from its row."""
    cols, rows = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    return np.concatenate([sincos_1d(dim // 2, cols), sincos_1d(dim // 2, rows)], axis=1)


def unpatchify(t: torch.Tensor, grid: Tuple[int, int], p: int, c: int) -> torch.Tensor:
    """Tokens (B, gh gw, p^2 c) or (B, gh, gw, p^2 c), each laid out (p1, p2,
    c), -> NHWC (B, gh p, gw p, c): ``b h w (p1 p2 c) -> b (h p1) (w p2) c``."""
    gh, gw = grid
    t = t.reshape(t.shape[0], gh, gw, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(t.shape[0], gh * p, gw * p, c)


class _PatchProj(_Layer):
    """A variable's patch embedding, ``Conv2d(1, D, p, stride p)``'s weight
    (D, 1, p, p) and bias (D)."""

    def __init__(self, embed_dim: int, patch: int, *, device=None, generator=None):
        super().__init__()
        self.weight = self._param(embed_dim, 1, patch, patch, device=device)
        self.bias = self._param(embed_dim, device=device)
        self._fill(device, generator)

    def reset_parameters(self, generator=None) -> None:
        self.weight.copy_(weight_init(self.weight.shape, VIT_INIT.mode, 0, 0, generator)
                          * VIT_INIT.weight)
        self.bias.copy_(torch_default_init(self.bias.shape, self.weight[0].numel(), generator))


class PatchEmbed(nn.Module):
    """timm's ``PatchEmbed`` with one input channel (its ``proj``)."""

    def __init__(self, embed_dim: int, patch: int, *, device=None, generator=None):
        super().__init__()
        self.proj = _PatchProj(embed_dim, patch, device=device, generator=generator)


class VariableAggregation(_Layer):
    """``nn.MultiheadAttention(D, heads, batch_first=True)`` with one query
    over few keys: ``in_proj_weight`` (3D, D), ``in_proj_bias`` (3D),
    ``out_proj``. Plain PyTorch: one query against V keys fits no attention
    kernel's tile."""

    def __init__(self, embed_dim: int, heads: int, *, device=None, generator=None):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = self._param(3 * embed_dim, embed_dim, device=device)
        self.in_proj_bias = self._param(3 * embed_dim, device=device)
        self._fill(device, generator)
        self.out_proj = Linear(embed_dim, embed_dim, VIT_INIT, device=device, generator=generator)

    def reset_parameters(self, generator=None) -> None:
        d3, d = self.in_proj_weight.shape
        self.in_proj_weight.copy_(weight_init(self.in_proj_weight.shape, "xavier_uniform", d, d3,
                                              generator))
        self.in_proj_bias.zero_()

    def forward(self, query: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """query (D,), tokens (V, N, D) -> (N, D)."""
        v_, n, d = tokens.shape
        h = self.heads
        w = self.in_proj_weight.to(tokens.dtype)
        b = self.in_proj_bias.to(tokens.dtype)
        q = F.linear(query.to(tokens.dtype), w[:d], b[:d]).reshape(h, d // h)
        k = F.linear(tokens, w[d:2 * d], b[d:2 * d]).view(v_, n, h, d // h)
        v = F.linear(tokens, w[2 * d:], b[2 * d:]).view(v_, n, h, d // h)
        s = torch.einsum("vnhc,hc->vnh", k, q / math.sqrt(d // h))
        p = torch.softmax(s.float(), dim=0).to(tokens.dtype)
        a = (p[..., None] * v).sum(0)
        return self.out_proj(a.reshape(n, d))


class Attention(nn.Module):
    """timm's ``Attention``: qkv Linear (with bias), K2/K3 on its output's
    (B, L, heads, c) views, proj Linear."""

    def __init__(self, dim: int, heads: int, fast: bool, *, device=None, generator=None):
        super().__init__()
        self.heads, self.fast = heads, fast
        self.qkv = Linear(dim, 3 * dim, VIT_INIT, device=device, generator=generator)
        self.proj = Linear(dim, dim, VIT_INIT, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = self.qkv(x).view(b, n, 3, self.heads, d // self.heads).unbind(2)
        return self.proj(fused_attention(q, k, v, self.fast).reshape(b, n, d))


class Block(nn.Module):
    """timm's pre-LN ``Block`` (no layer scale) with ``drop`` on the
    attention's and the MLP's outputs and the MLP's hidden layer, and
    stochastic depth ``drop_path`` on both branches."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, drop: float, drop_path: float,
                 fast: bool, *, device=None, generator=None):
        super().__init__()
        self.drop, self.drop_path = drop, drop_path
        kw = dict(device=device, generator=generator)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn = Attention(dim, heads, fast, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, **kw)

    def forward(self, x: torch.Tensor, generator=None, shard=(0, 1)) -> torch.Tensor:
        t = self.training
        a = token_dropout(self.attn(self.norm1(x)), self.drop, t, generator, shard)
        x = x + drop_path(a, self.drop_path, t, generator, shard)
        m = self.mlp(self.norm2(x), generator, shard)
        return x + drop_path(m, self.drop_path, t, generator, shard)


class ClimaX(_Layer):
    """ClimaX on NHWC fields (B, H, W, V) -> (B, H, W, V), the module
    docstring's equations. ``img_size`` (H, W) must be multiples of
    ``patch_size``; ``embed_dim`` a multiple of ``num_heads``."""

    def __init__(self, img_size: Sequence[int], variables: int, patch_size: int = 4,
                 embed_dim: int = 1024, depth: int = 8, num_heads: int = 16,
                 mlp_ratio: float = 4.0, decoder_depth: int = 2, drop_path: float = 0.1,
                 drop_rate: float = 0.1, fast_attention: bool = False, *, device=None,
                 generator=None):
        super().__init__()
        h, w = img_size
        if h % patch_size or w % patch_size or embed_dim % num_heads:
            raise ValueError(f"ClimaX needs a grid in whole patches and whole heads, got "
                             f"{tuple(img_size)}, patch {patch_size}, D {embed_dim}, "
                             f"{num_heads} heads")
        self.patch_size, self.variables = patch_size, variables
        self.grid = (h // patch_size, w // patch_size)
        self.embed_dim, self.drop_rate = embed_dim, drop_rate
        kw = dict(device=device, generator=generator)
        self.token_embeds = nn.ModuleList(PatchEmbed(embed_dim, patch_size, **kw)
                                          for _ in range(variables))
        self.var_embed = self._param(1, variables, embed_dim, device=device)
        self.var_query = self._param(1, 1, embed_dim, device=device)
        self.var_agg = VariableAggregation(embed_dim, num_heads, **kw)
        self.pos_embed = self._param(1, self.grid[0] * self.grid[1], embed_dim, device=device)
        self.lead_time_embed = Linear(1, embed_dim, VIT_INIT, **kw)
        rates = torch.linspace(0, drop_path, depth, device="cpu").tolist()
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio, drop_rate, r,
                                          fast_attention, **kw) for r in rates)
        self.norm = LayerNorm(embed_dim, **kw)
        head = []
        for _ in range(decoder_depth):
            head += [Linear(embed_dim, embed_dim, VIT_INIT, **kw), nn.GELU()]
        head.append(Linear(embed_dim, variables * patch_size ** 2, VIT_INIT, **kw))
        self.head = nn.Sequential(*head)
        self._fill(device, generator)

    def reset_parameters(self, generator=None) -> None:
        """The embeddings of ClimaX's ``initialize_weights`` (no draws)."""
        d = self.embed_dim
        self.pos_embed.copy_(torch.from_numpy(sincos_2d(d, *self.grid)).float()[None])
        self.var_embed.copy_(torch.from_numpy(
            sincos_1d(d, np.arange(self.variables))).float()[None])
        self.var_query.zero_()

    def tokenize(self, x: torch.Tensor, generator=None, shard=(0, 1)) -> torch.Tensor:
        """Steps 1-3: NHWC x (B, H, W, V) -> tokens (B, L, D) in x's dtype."""
        b, _, _, nv = x.shape
        (gh, gw), p, d = self.grid, self.patch_size, self.embed_dim
        patches = x.reshape(b, gh, p, gw, p, nv).permute(5, 0, 1, 3, 2, 4)
        patches = patches.reshape(nv, b * gh * gw, p * p)
        weight = torch.stack([t.proj.weight.reshape(d, p * p) for t in self.token_embeds])
        bias = torch.stack([t.proj.bias for t in self.token_embeds]) + self.var_embed[0]
        tokens = torch.baddbmm(bias.to(x.dtype)[:, None], patches,
                               weight.to(x.dtype).transpose(1, 2))       # (V, B L, D)
        x = self.var_agg(self.var_query.reshape(d), tokens).view(b, gh * gw, d)
        lead = self.lead_time_embed(x.new_zeros(b, 1))                    # lead time 0
        x = x + self.pos_embed.to(x.dtype) + lead[:, None]
        return token_dropout(x, self.drop_rate, self.training, generator, shard)

    def unpatchify(self, t: torch.Tensor) -> torch.Tensor:
        """(B, L, V p^2) -> NHWC (B, H, W, V), ClimaX's ``unpatchify``."""
        return unpatchify(t, self.grid, self.patch_size, self.variables)

    def forward(self, x: torch.Tensor, class_labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """NHWC x (B, H, W, V) -> (B, H, W, V) in x's dtype. ``class_labels``
        (the deterministic steps' time features) are accepted and not read;
        ``generator`` and ``shard`` give the dropout draws (module docstring)."""
        del class_labels
        with span("probunet.tokenize"):
            x = self.tokenize(x, generator, shard)
        for blk in self.blocks:
            x = blk(x, generator, shard)
        x = self.norm(x)
        with span("probunet.head"):
            return self.unpatchify(self.head(x))
