"""Spatial (height-axis) sharding primitives with halo exchange —
``probunet_tpu/parallel/spatial.py``.

When a tile's activations outgrow one card, its H dimension is sharded over
the ranks of a space group (:class:`~probunet_torch.parallel.mesh.
SpatialMesh`): rank s of sp holds rows ``[s*H/sp, (s+1)*H/sp)`` of every
activation. In the JAX package one process drives every device of the
mesh's "space" axis inside a ``shard_map``; here one process drives one
card, so a device of that axis is a rank and each collective is a
``torch.distributed`` call over the space group.

Activations are NCHW tensors in ``channels_last`` memory format, as
everywhere in the port (H is dim 2). The building blocks:

- :func:`halo_exchange_rows`: a local block padded with its neighbours'
  edge rows, zeros at the global edges (SAME zero padding);
- :func:`psum`: the sum over the space group (GroupNorm statistics, the
  Gaussian nets' global pool);
- :func:`spatial_attention` / :func:`local_rows`: the rows gathered in
  rank order into the full map, and this rank's rows of a full map;
- :func:`spatial_conv3x3`, :func:`spatial_group_norm_silu`,
  :func:`spatial_avg_pool`, :func:`spatial_nearest_up_2x`.

**Gradients.** The training step differentiates through every collective,
so each is a ``torch.autograd.Function``. The convention: each rank
back-propagates its share of the loss (the shares sum to the loss), and
each collective's backward hands every input the sum over the ranks of the
cotangents that reach it: the halo sends the cotangent of received rows
back to their owner, which adds it to its edge rows; ``psum``'s backward is
the sum of the cotangent; the gather's backward is the sum over the ranks
of the full map's cotangent, narrowed to this rank's rows (a reduce-scatter
under NCCL, an all-reduce and a narrow where gloo has none). The parameter
gradients are then summed over the ranks (``DataParallel.allreduce_grads``).
JAX gets the same sum from transposing a ``shard_map`` with replicated
parameters.

**Backends.** Halos move by ``batch_isend_irecv``. Under gloo,
``send``/``recv``/``all_gather`` take CPU tensors only (gloo lists just
``broadcast`` and ``all_reduce`` for CUDA tensors), so those stage through
``mesh.collective_device()``. A collective that fails raises; no rank
carries on alone. Every rank of a space group must issue the same
collectives in the same order, in the forward, in autograd's backward and
in a remat recompute: nothing here branches on the rank but the edge test
of the halo, which only skips the messages an edge rank has no peer for.

Without a process group (:class:`SpatialMesh` of one rank) every collective
is the identity and the halo brings zeros: the unsharded math.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from probunet_torch.models.layers import nchw, nhwc, silu
from probunet_torch.ops.conv import conv2d
from probunet_torch.ops.resample import avg_pool, nearest_upsample_2x
from probunet_torch.parallel.mesh import SpatialMesh, collective_device


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous on the device the backend moves it from."""
    return t.to(collective_device()).contiguous()


def _exchange(mesh: SpatialMesh, to_prev: torch.Tensor, to_next: torch.Tensor):
    """(rows from the previous rank, rows from the next rank) of the space
    group: each rank sends ``to_prev`` to its previous rank and ``to_next``
    to its next one; a rank at a global edge gets zeros on that side."""
    from_prev, from_next = torch.zeros_like(to_next), torch.zeros_like(to_prev)
    s, sp = mesh.space_index, mesh.sp
    if mesh.space_group is None or sp == 1:
        return from_prev, from_next
    ops, recvs = [], []
    for peer, out, send in ((s - 1, from_prev, to_prev), (s + 1, from_next, to_next)):
        if 0 <= peer < sp:
            buf = _staged(out)
            rank = mesh.space_ranks[peer]
            ops += [dist.P2POp(dist.isend, _staged(send), rank, mesh.space_group),
                    dist.P2POp(dist.irecv, buf, rank, mesh.space_group)]
            recvs.append((out, buf))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for out, buf in recvs:
        out.copy_(buf)
    return from_prev, from_next


class _HaloRows(torch.autograd.Function):
    """NHWC (B, H_loc, W, C) -> (B, H_loc + 2 halo, W, C)."""

    @staticmethod
    def forward(ctx, x, mesh, halo):
        ctx.mesh, ctx.halo = mesh, halo
        from_prev, from_next = _exchange(mesh, x[:, :halo], x[:, -halo:])
        return torch.cat([from_prev, x, from_next], dim=1)

    @staticmethod
    def backward(ctx, g):
        h = ctx.halo
        # the cotangent of the rows a neighbour sent goes back to it, and
        # joins the cotangent of its edge rows
        from_prev, from_next = _exchange(ctx.mesh, g[:, :h], g[:, -h:])
        grad = g[:, h:-h].clone()
        grad[:, :h] += from_prev
        grad[:, -h:] += from_next
        return grad, None, None


def halo_exchange_rows(x: torch.Tensor, mesh: SpatialMesh, halo: int = 1) -> torch.Tensor:
    """``x`` (B, C, H_loc, W) padded along H with ``halo`` rows of each
    neighbour: (B, C, H_loc + 2 halo, W). Ranks at the global edges get zero
    rows there, which is SAME zero padding."""
    return nchw(_HaloRows.apply(nhwc(x), mesh, halo))


def _sum(x: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    if mesh.space_group is not None:
        dist.all_reduce(y, group=mesh.space_group)
    return y


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh), None


def psum(x: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """The sum of ``x`` over the space group, on every rank of it; its
    gradient is the sum of the cotangent over the group."""
    return _Psum.apply(x, mesh)


def gather_rows(x: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """The space group's (B, H_loc, ...) blocks joined along dim 1 in rank
    order, (B, sp * H_loc, ...), on every rank; no gradient."""
    if mesh.space_group is None:
        return x
    part = _staged(x)
    parts = [torch.empty_like(part) for _ in range(mesh.sp)]
    dist.all_gather(parts, part, group=mesh.space_group)
    return torch.cat(parts, dim=1).to(x.device)


class _GatherRows(torch.autograd.Function):
    """NHWC (B, H_loc, W, C) -> the full (B, H, W, C) map."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        if mesh.space_group is None:
            return g, None
        h = g.shape[1] // mesh.sp
        if dist.get_backend(mesh.space_group) == "nccl":
            out = torch.empty_like(g[:, :h], memory_format=torch.contiguous_format)
            dist.reduce_scatter(out, [c.contiguous() for c in g.split(h, dim=1)],
                                group=mesh.space_group)
            return out, None
        return _sum(g, mesh).narrow(1, mesh.space_index * h, h), None


def spatial_attention(x: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """All-gather the H-sharded (B, C, H_loc, W) block into the full map,
    the input of a global self-attention (which lives at coarse <=32x32
    resolutions, networks.py:237, where the full map is small); the caller
    takes its rows back with :func:`local_rows`."""
    return nchw(_GatherRows.apply(nhwc(x), mesh))


def local_rows(x_full: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """This rank's H rows of a gathered full (B, C, H, W) tensor."""
    h = x_full.shape[2] // mesh.sp
    return x_full.narrow(2, mesh.space_index * h, h)


def spatial_conv3x3(x: torch.Tensor, w: torch.Tensor, mesh: SpatialMesh, stride: int = 1,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """3x3 SAME convolution (weight OIHW) of an H-sharded block, stride 1 or
    2: the unsharded ``F.conv2d(x, w, bias, stride, padding=1)``'s rows.
    H is padded by the halo, W by zeros; at stride 2 the local height must
    be even so that the output rows stay aligned."""
    if stride not in (1, 2) or (stride == 2 and x.shape[2] % 2):
        raise ValueError(f"stride {stride} on {x.shape[2]} local rows")
    return conv2d(halo_exchange_rows(x, mesh, 1), w, bias, (0, 1), stride)


def spatial_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       num_groups: int, mesh: SpatialMesh, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of an H-sharded (B, C, H_loc, W) block with the statistics
    of the whole tile: fp32 local sums and sums of squares per (batch,
    group), one :func:`psum` of the 2 x B x G values, then the local
    normalization and affine in fp32. Returns x's dtype."""
    b, c, h, w = x.shape
    cg = c // num_groups
    xf = nhwc(x).float().reshape(b, h * w, num_groups, cg)
    sums = psum(torch.stack([xf.sum(dim=(1, 3)), xf.square().sum(dim=(1, 3))]), mesh)
    n = h * w * cg * mesh.sp
    mean = sums[0] / n
    rstd = torch.rsqrt(sums[1] / n - mean * mean + eps)
    y = (xf - mean[:, None, :, None]) * rstd[:, None, :, None]
    y = y.reshape(b, h, w, c) * weight.float() + bias.float()
    return nchw(y.to(x.dtype))


def spatial_group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            num_groups: int, mesh: SpatialMesh, eps: float = 1e-5) -> torch.Tensor:
    """:func:`spatial_group_norm` followed by SiLU (plain PyTorch: kernel K1
    normalizes by local statistics only)."""
    return silu(spatial_group_norm(x, weight, bias, num_groups, mesh, eps))


def spatial_avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k average pooling: local when H_loc % k == 0."""
    if x.shape[2] % k:
        raise ValueError(f"{x.shape[2]} local rows do not pool by {k}")
    return nchw(avg_pool(nhwc(x), k))


def spatial_nearest_up_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling: purely local."""
    return nchw(nearest_upsample_2x(nhwc(x)))
