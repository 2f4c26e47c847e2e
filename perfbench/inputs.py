"""Inputs made from the seed: weights, the resident ClimEx-like days, and
the feed of each call. Both the program and the reference get them.

Every draw is on the device, from a ``torch.Generator`` there, in a few
large calls; only the few numbers that shape the synthetic fields come from
NumPy on the host. The same seed gives the same inputs.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``tags``."""
    words = np.random.SeedSequence([int(seed) % 2 ** 64, *tags]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def device_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every tensor ~ N(0, 1) / sqrt(fan_in), fan_in the product of its
    trailing dims (1 for a vector), fp32; one draw for all, cut in the
    order of the names. A zero-initialized conv (ADM's conv1, proj and
    out_conv) would hide most of each block, so none is left at zero."""
    shapes = sorted((name, tuple(shape)) for name, shape in shapes)
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn(total, generator=device_generator(device, subseed(seed, 1)),
                       device=device)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape) / math.sqrt(max(1, math.prod(shape[1:])))
        at += n
    return out


def climex_like(seed: int, days_per_year: int, years: int, res: int, variables,
                device, modes: int = 6) -> torch.Tensor:
    """(T, H, W, C) fp32 daily fields like ClimEx's: per year and variable
    a sum of ``modes`` random low-frequency travelling waves and a seasonal
    cycle; precipitation non-negative in kg m-2 s-1, temperatures in K
    (the arithmetic of the program's synthetic netCDF generator)."""
    rng = np.random.default_rng(subseed(seed, 2))
    lin = torch.linspace(0, 1, res, device=device)
    ys, xs = torch.meshgrid(lin, lin, indexing="ij")
    t = torch.arange(days_per_year, device=device, dtype=torch.float32)
    season = torch.sin(2 * math.pi * t / days_per_year)[:, None, None]
    out = []
    for _ in range(years):
        fields = []
        for var in variables:
            p = torch.as_tensor(rng.uniform(size=(modes, 7)), dtype=torch.float32, device=device)
            fy, fx = 0.5 + 3.5 * p[:, 0], 0.5 + 3.5 * p[:, 1]
            ph = 2 * math.pi * p[:, 2:5]
            speed, amp = 0.02 + 0.18 * p[:, 5], 0.3 + 0.7 * p[:, 6]
            spatial = torch.sin(2 * math.pi * (fy[:, None, None] * ys + fx[:, None, None] * xs)
                                + ph[:, 0, None, None])                      # (M, H, W)
            temporal = amp[:, None] * torch.sin(speed[:, None] * t + ph[:, 1, None])  # (M, T)
            base = torch.einsum("mt,mhw->thw", temporal, spatial)
            if var == "pr":
                fields.append(torch.clamp(base + 0.5 * season, min=0.0) ** 2 * (20.0 / 86400.0))
            elif var == "tasmin":
                fields.append(268.0 + 12.0 * season + 3.0 * base)
            else:
                fields.append(276.0 + 12.0 * season + 3.0 * base)
        out.append(torch.stack(fields, dim=-1))
    return torch.cat(out).contiguous()


def batch_rows(seed: int, days: int, batch: int, calls: int, device) -> torch.Tensor:
    """(calls, batch) day indices: seeded permutations of the days cut into
    batches, a new permutation when one runs out; the rows of a batch differ."""
    rng = np.random.default_rng(subseed(seed, 3))
    per = days // batch
    rows = [rng.permutation(days)[:per * batch].reshape(per, batch)
            for _ in range(-(-calls // per))]
    return torch.as_tensor(np.concatenate(rows)[:calls], device=device)


def call_generator(seed: int, call: int, device) -> torch.Generator:
    """The generator of call ``call``: its latent draws, noise and dropout."""
    return device_generator(device, subseed(seed, 4, call))
