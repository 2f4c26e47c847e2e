"""ClimaX (Nguyen et al., ICML 2023, arXiv:2301.10343; ``src/climax/arch.py``
of microsoft/ClimaX) in plain PyTorch, as a downscaler: the standardized LR
interpolation on the HR grid in, the standardized residual out, an MSE
loss, AdamW. fp32 with TF32 off (``fp32_math``); every product's operands
pass ``Ref.q`` (the controls of ``unet.py``).

Written from the published equations, not from the measured program. For
V variables on an (H, W) grid, patch p, L = (H / p)(W / p) tokens of width
D: each variable's ``Conv2d(1, D, p, stride p)`` (timm's ``PatchEmbed``)
plus ``var_embed``; ``nn.MultiheadAttention``'s math with the learned
``var_query`` over each position's V tokens; ``pos_embed`` and the lead
time's ``Linear(1, D)``; ``pos_drop``; ``depth`` timm ``Block``s (pre-LN,
qkv with bias laid out (3, heads, c), softmax(q k^T / sqrt(c)) v, proj,
GELU MLP, dropout and stochastic depth, LayerNorm eps 1e-5); the final
LayerNorm, the head of [Linear, GELU] x ``decoder_depth`` and a Linear to
V p^2; unpatchify. Parameter names are the program's ``state_dict`` keys
(ClimaX's).

Departures, each the same numbers as the published module:

- self-attention runs ``unet.Attention`` (the U-Net reference's, whose
  sites ``perfbench/counts.py`` counts) on the qkv output permuted into
  that module's (head, channel, qkv) channel interleave and shaped (B, 3D,
  H / p, W / p): a relabelling of rows;
- the aggregation's query is projected once, not once per position
  (``nn.MultiheadAttention`` repeats ``var_query`` B L times);
- the lead time is 0 (downscaling maps fields at one time), so its
  embedding is the Linear's bias;
- dropout and stochastic depth draw uniforms from the generator given,
  in the order the program documents (``probunet_torch/models/climax.py``):
  ``pos_drop`` (B, L, D); per block the attention's output (B, L, D), its
  drop_path (B, 1), the MLP's hidden layer (B, L, 4D) and output (B, L, D),
  its drop_path (B, 1); a rate of 0 draws nothing. An element (a sample,
  for drop_path) is kept where its uniform is below 1 - rate (timm's
  ``bernoulli_``: the same law) and scaled by 1 / (1 - rate). With
  ``shard`` = (j, n) the batch is part j of n of a larger batch and takes
  part j of each of the larger batch's draws.

A step at the benchmark's b64 runs in parts (``train_readings``' ``chunk``):
plain attention holds (chunk heads, L, L) fp32 scores a layer.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.compare import row_norms
from perfbench.reference.probunet import adamw_
from perfbench.reference.unet import Attention, Linear, Ref, _param, fp32_math, make_pair


def _uniforms(shape, generator, device, shard):
    j, n = shard
    b = shape[0]
    return torch.rand((b * n, *shape[1:]), generator=generator, device=device)[j * b:(j + 1) * b]


def dropout(x, rate: float, generator, shard):
    keep = 1.0 - rate
    u = _uniforms(x.shape, generator, x.device, shard)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x, rate: float, generator, shard):
    keep = 1.0 - rate
    u = _uniforms((x.shape[0], 1), generator, x.device, shard)[:, :, None]
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class _Proj(Ref):
    """``Conv2d(1, D, p, stride=p)``."""

    def __init__(self, d: int, p: int):
        super().__init__()
        self.p = p
        self.weight = _param(d, 1, p, p)
        self.bias = _param(d)

    def forward(self, x):
        return F.conv2d(self.q(x), self.q(self.weight), self.bias, stride=self.p)


class PatchEmbed(nn.Module):
    def __init__(self, d: int, p: int):
        super().__init__()
        self.proj = _Proj(d, p)

    def forward(self, x):   # (B, 1, H, W) -> (B, L, D)
        return self.proj(x).flatten(2).transpose(1, 2)


class VarAgg(Ref):
    """``nn.MultiheadAttention(D, heads, batch_first=True)``, query length 1."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = _param(3 * d, d)
        self.in_proj_bias = _param(3 * d)
        self.out_proj = Linear(d, d)

    def forward(self, query, x):   # query (1, D), x (N, V, D) -> (N, D)
        n, nv, d = x.shape
        h, c = self.heads, d // self.heads
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(self.q(query), self.q(w[:d]), b[:d]).reshape(h, c) / math.sqrt(c)
        k = F.linear(self.q(x), self.q(w[d:2 * d]), b[d:2 * d]).reshape(n, nv, h, c)
        v = F.linear(self.q(x), self.q(w[2 * d:]), b[2 * d:]).reshape(n, nv, h, c)
        p = torch.softmax(torch.einsum("nvhc,hc->nhv", self.q(k), self.q(q)), dim=2)
        return self.out_proj(torch.einsum("nhv,nvhc->nhc", self.q(p), self.q(v)).reshape(n, d))


class SelfAttention(nn.Module):
    def __init__(self, d: int, heads: int, grid):
        super().__init__()
        self.heads, self.grid = heads, grid
        self.qkv = Linear(d, 3 * d)
        self.attn = Attention()
        self.proj = Linear(d, d)

    def forward(self, x):
        b, n, d = x.shape
        h = self.heads
        qkv = self.qkv(x).reshape(b, n, 3, h, d // h).permute(0, 3, 4, 2, 1)   # (head, c, qkv)
        a = self.attn(qkv.reshape(b, 3 * d, *self.grid), h)                    # (B, D, gh, gw)
        return self.proj(a.reshape(b, d, n).transpose(1, 2))


class Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(d, hidden)
        self.fc2 = Linear(hidden, d)


class Block(nn.Module):
    def __init__(self, d: int, heads: int, mlp_ratio: float, grid, drop: float, path: float):
        super().__init__()
        self.drop, self.path = drop, path
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.attn = SelfAttention(d, heads, grid)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = Mlp(d, int(d * mlp_ratio))

    def _drop(self, x, gen, shard):
        return dropout(x, self.drop, gen, shard) if self.training and self.drop else x

    def _path(self, x, gen, shard):
        return drop_path(x, self.path, gen, shard) if self.training and self.path else x

    def forward(self, x, gen=None, shard=(0, 1)):
        x = x + self._path(self._drop(self.attn(self.norm1(x)), gen, shard), gen, shard)
        h = self._drop(F.gelu(self.mlp.fc1(self.norm2(x))), gen, shard)
        return x + self._path(self._drop(self.mlp.fc2(h), gen, shard), gen, shard)


class ClimaX(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        h, w = cfg["resolution"]
        d, p, nv = cfg["embed_dim"], cfg["patch_size"], len(cfg["variables"])
        self.p, self.nv, self.drop = p, nv, cfg["dropout"]
        self.grid = (h // p, w // p)
        self.token_embeds = nn.ModuleList(PatchEmbed(d, p) for _ in range(nv))
        self.var_embed = _param(1, nv, d)
        self.var_query = _param(1, 1, d)
        self.var_agg = VarAgg(d, cfg["num_heads"])
        self.pos_embed = _param(1, self.grid[0] * self.grid[1], d)
        self.lead_time_embed = Linear(1, d)
        rates = torch.linspace(0, cfg["drop_path"], cfg["depth"], device="cpu").tolist()
        self.blocks = nn.ModuleList(Block(d, cfg["num_heads"], cfg["mlp_ratio"], self.grid,
                                          self.drop, r) for r in rates)
        self.norm = nn.LayerNorm(d, eps=1e-5)
        head = []
        for _ in range(cfg["decoder_depth"]):
            head += [Linear(d, d), nn.GELU()]
        self.head = nn.Sequential(*head, Linear(d, nv * p * p))

    def forward(self, x_nhwc, gen=None, shard=(0, 1)):
        """(B, H, W, V) -> (B, H, W, V)."""
        b = x_nhwc.shape[0]
        x = x_nhwc.permute(0, 3, 1, 2)
        tokens = torch.stack([emb(x[:, i:i + 1]) for i, emb in enumerate(self.token_embeds)],
                             dim=1) + self.var_embed[:, :, None]              # (B, V, L, D)
        n = tokens.shape[2]
        agg = self.var_agg(self.var_query[0], tokens.transpose(1, 2).flatten(0, 1))
        lead = self.lead_time_embed(x.new_zeros(b, 1))
        t = agg.reshape(b, n, -1) + self.pos_embed + lead[:, None]
        if self.training and self.drop:
            t = dropout(t, self.drop, gen, shard)
        for blk in self.blocks:
            t = blk(t, gen, shard)
        out = self.head(self.norm(t))                                          # (B, L, V p^2)
        (gh, gw), p = self.grid, self.p
        out = out.reshape(b, gh, gw, p, p, self.nv).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, gh * p, gw * p, self.nv)


def train_readings(model: ClimaX, hr_all, stats, feeds, lr: float, wd: float, scale: int,
                   fault: Optional[str] = None, chunk: Optional[int] = None) -> Dict:
    """Runs the training steps of ``feeds`` (idx, dropout generator) from the
    model's weights: each step's MSE loss (the mean over the batch's
    elements), the norms of the first step's gradient of each leaf and of
    its rows, and the row norms of each leaf's change over all the steps, as
    ``probunet.train_readings`` gives them. ``chunk``: rows a backward, each
    part's loss its share of the batch mean (its squared errors over the
    batch's element count), drawing its part of the batch's dropout draws
    from the generator as it stood at the step's start. ``fault``
    ``"half_batch"``: the loss of the first half of each batch alone."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    state, losses, grad_rows = {}, [], None
    model.train()
    with fp32_math():
        for idx, gen in feeds:
            pair = make_pair(hr_all[idx], scale, stats)
            x, y = pair["inputs"], pair["targets"]
            for p in params:
                p.grad = None
            drawn = gen.get_state() if gen is not None else None
            loss = 0.0
            parts, rows = _parts(len(idx), chunk, fault)
            for sl, shard in parts:
                if drawn is not None:
                    gen.set_state(drawn)
                part = (model(x[sl], gen, shard) - y[sl]).square().sum() / (rows * y[0].numel())
                part.backward()
                loss += part.item()
            losses.append(loss)
            if grad_rows is None:
                grad_rows = {n: row_norms(p.grad if p.grad is not None else torch.zeros_like(p))
                             for n, p in zip(names, params)}
            adamw_(params, state, lr, wd)
    return {"losses": losses, "grad_rows": grad_rows,
            "grad_norms": {n: float(r.norm()) for n, r in grad_rows.items()},
            "change_rows": {n: row_norms(p - s) for n, p, s in zip(names, params, start)}}


def _parts(batch: int, chunk: Optional[int], fault: Optional[str]):
    """([(rows, dropout shard)] of each backward of a step, the rows the
    loss averages over)."""
    if chunk is None or chunk == batch:
        if fault == "half_batch":
            return [(slice(0, batch // 2), (0, 1))], batch // 2
        return [(slice(0, batch), (0, 1))], batch
    n = batch // chunk
    keep = max(1, n // 2) if fault == "half_batch" else n
    return [(slice(j * chunk, (j + 1) * chunk), (j, n)) for j in range(keep)], keep * chunk
