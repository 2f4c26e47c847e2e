"""A torch emulation of the strict (fp32) attention kernels' arithmetic.

K2 and K3 in fp32 (csrc/attention_fwd.cu, csrc/attention_bwd.cu) multiply
in 3xTF32 on tf32 wgmma: each operand x is carried as hi = tf32(x) (cvt.rna:
round to nearest, ties away) and lo = tf32(x - hi), and each k8 step of a
product adds lo*hi, then hi*lo, then hi*hi into fp32 accumulators. K2 runs
the online softmax over K/V tiles of 64 keys (kD = 64) or 32 (kD = 128, head
dims past 64) and adds each tile's P V, taken into a fresh accumulator,
into O by one fp32 FMA; K3 takes D = rowsum(dO o O) in the form of dP,
recomputes P from K2's lse and sums dV, dK and dQ over tiles of 64 rows
(kD = 64) or 32. The products here run over the head dim's c columns, the
k8 steps the kernels take (``head_steps``: 9 at c = 72; their columns past
c are zeros). What this cannot follow is how wgmma sums the eight products
of a step into its accumulator (its own order, truncating), so it gives
the kernels' design, not their bits. It imports no JAX:
test_torch_tf32x3.py holds it against JAX on the CPU, test_torch_cuda.py
against the kernels on the card.
"""

import math

import torch

from probunet_torch.ops import attention as tatt


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, ties away from zero
    (adding half of the dropped 13 bits' range to the magnitude's bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor, acc=None) -> torch.Tensor:
    """acc (+)= a b^T over the last dims, (..., m, k) x (..., n, k), in
    3xTF32 as the kernels run it: per k8 step lo*hi, hi*lo, hi*hi into an
    fp32 accumulator."""
    (ah, al), (bh, bl) = split(a), split(b)
    d = torch.zeros(*a.shape[:-1], b.shape[-2]) if acc is None else acc
    for j in range(0, a.shape[-1], 8):
        s = slice(j, j + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            d = d + x[..., s] @ y[..., s].transpose(-1, -2)
    return d


def fma(a, b, c):
    """fp32 a * b + c with one rounding."""
    return (a.double() * b.double() + c.double()).float()


def tile_rows(c: int) -> int:
    """The fp32 kernels' K/V and streamed tile rows at head dim c."""
    return tatt.fp32_plan(64 if tatt.kernel_width(c) == 64 else 128).fwd_tile


def emulated_fwd(q, k, v):
    """K2 strict on (BH, L, c) fp32: (O, lse)."""
    bn, c = tile_rows(q.shape[-1]), math.log2(math.e) / math.sqrt(q.shape[-1])
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros_like(q)
    for j in range(0, k.shape[1], bn):
        s = mm3(q, k[:, j:j + bn])                                 # S = Q K^T
        m_new = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        l = l * alpha + p.sum(-1)
        m = m_new
        pv = mm3(p, v[:, j:j + bn].transpose(-1, -2))              # this tile's P V, fresh
        o = fma(o, alpha[..., None], pv)
    return o / l[..., None], (m + torch.log2(l)) / math.log2(math.e)


def emulated_bwd(q, k, v, o, lse, do):
    """K3 strict on (BH, L, c) fp32 with K2's O and lse: (dq, dk, dv)."""
    r, scale = tile_rows(q.shape[-1]), 1 / math.sqrt(q.shape[-1])
    c = scale * math.log2(math.e)
    lse2 = lse * math.log2(math.e)
    # (a) D as the diagonal of dO O^T, in the form of dP
    d = torch.diagonal(mm3(do, o), dim1=-2, dim2=-1)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    # (b) dK, dV: per key block, over the q tiles (S^T, dP^T summed as S, dP)
    for i in range(0, q.shape[1], r):
        rows = slice(i, i + r)
        st = mm3(q[:, rows], k).transpose(-1, -2)                  # S^T (keys x queries)
        pt = torch.exp2(st * c - lse2[:, None, rows])
        dpt = mm3(do[:, rows], v).transpose(-1, -2)
        dst = pt * (dpt - d[:, None, rows])
        dv = mm3(pt, do[:, rows].transpose(-1, -2), dv)            # dV += P^T dO
        dk = mm3(dst, q[:, rows].transpose(-1, -2), dk)            # dK += dS^T Q
    # (c) dQ: per query block, over the K/V tiles
    for j in range(0, k.shape[1], r):
        keys = slice(j, j + r)
        p = torch.exp2(mm3(q, k[:, keys]) * c - lse2[..., None])
        ds = p * (mm3(do, v[:, keys]) - d[..., None])
        dq = mm3(ds, k[:, keys].transpose(-1, -2), dq)             # dQ += dS K
    return dq * scale, dk * scale, dv


def _bh(a):   # (B, L, heads, c) -> (B * heads, L, c)
    b, L, h, c = a.shape
    return a.permute(0, 2, 1, 3).reshape(b * h, L, c)
