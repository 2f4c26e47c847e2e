"""Spatially-sharded Probabilistic U-Net forward (H-axis model parallelism) —
``probunet_tpu/parallel/spatial_unet.py``.

Runs the port's own :class:`~probunet_torch.models.prob_unet.
ProbabilisticUNet` modules and parameters with the height dimension sharded
over a space group (:class:`~probunet_torch.parallel.mesh.SpatialMesh`): 3x3
convolutions exchange 1-row halos, GroupNorm statistics are summed over the
group, resampling and 1x1 convolutions are local, and self-attention (at
coarse <=32x32 resolutions) gathers the small map, runs on the whole of it
on every rank and keeps this rank's rows. No parameter is new, so a state
dict (or ``utils.transplant.flax_probunet_to_torch``) feeds the sharded and
the unsharded model alike; the topology is the module's own static plan
(``UNet.enc_specs``/``dec_specs``), built at the GLOBAL resolution.

Supports the downscaling configuration (``use_diffuse=False``,
``label_dim=0``), where the embedding is silu(0) = 0 and each block's
adaptive scale and shift reduce to the affine bias (reference
networks.py:303,319).

- Kernel K1 does not run on this path: its statistics are local, and the
  sharded GroupNorm needs the whole tile's (as the JAX package's ``_gn`` is
  plain XLA with psum'd sums). K2 runs in every attention block on the
  gathered map, and K3 in its backward, always strict (``fast=False``, as
  JAX's ``spatial_unet.py:141`` calls ``fused_attention`` without the flag).
- Dropout draws this rank's H rows (and, in 2d, its data index's batch
  rows) of the mask of the whole global batch (``layers.rand_rows``), so N
  ranks draw what one process draws. The JAX package folds the axis index
  into its dropout key instead (per-shard masks, JAX ``spatial_unet.py:
  86-94``): its bits could not be matched anyway, and the global mask lets
  N ranks be held against one process with dropout on.
- ``remat`` recomputes each block in the backward through the port's
  non-reentrant checkpoint with generator replay (``unet.remat_block``);
  the recompute issues the block's collectives again, in the same order on
  every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from probunet_torch.models.layers import TorchConv, dropout, nchw, nhwc, silu
from probunet_torch.models.prob_unet import AxisAlignedConvGaussian, Fcomb, ProbabilisticUNet
from probunet_torch.models.unet import BlockSpec, UNet, UNetBlock, remat_block
from probunet_torch.ops.conv import conv2d
from probunet_torch.ops.distributions import DiagGaussian, kl_diag_gaussian
from probunet_torch.parallel.mesh import SpatialMesh, is_initialized
from probunet_torch.parallel.spatial import (
    halo_exchange_rows,
    local_rows,
    psum,
    spatial_attention,
    spatial_avg_pool,
    spatial_group_norm,
    spatial_nearest_up_2x,
)


def check_tile(height: int, sp: int, channel_mult, num_filters) -> None:
    """Raise unless a tile of ``height`` rows splits over ``sp`` ranks
    through every 2x pool: the U-Net's ``len(channel_mult) - 1`` and the
    prior and posterior nets' ``len(num_filters)``."""
    for what, pools in (("the U-Net", len(channel_mult) - 1),
                        ("the prior and posterior nets", len(num_filters))):
        if height % (sp * 2 ** pools):
            raise ValueError(f"tile height {height} does not split over {sp} ranks through "
                             f"the {pools} 2x pools of {what}: it must be a multiple of "
                             f"{sp * 2 ** pools}")


def _conv(conv, x: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """A convolution of the model (its weight OIHW, SAME padding): 3x3
    through the halo, 1x1 local."""
    k = conv.weight.shape[-1]
    w, b = conv.weight.to(x.dtype), conv.bias.to(x.dtype)
    if k == 1:
        return conv2d(x, w, b)
    return conv2d(halo_exchange_rows(x, mesh, k // 2), w, b, (0, k // 2))


def _gn(norm, x: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """A GroupNorm module of the model, with the whole tile's statistics."""
    return spatial_group_norm(x, norm.weight, norm.bias, norm.num_groups, mesh, norm.eps)


def _block(blk: UNetBlock, x: torch.Tensor, spec: BlockSpec, mesh: SpatialMesh,
           generator: Optional[torch.Generator], shard: Tuple[int, int]) -> torch.Tensor:
    """``UNetBlock.forward`` on an H-shard (reference networks.py:164-185)
    with the zero-embedding reduction: the affine map of silu(0) is its
    bias."""
    orig = x
    h = silu(_gn(blk.norm0, x, mesh))
    if spec.up:
        h = spatial_nearest_up_2x(h)
    if spec.down:
        h = spatial_avg_pool(h, 2)
    h = _conv(blk.conv0, h, mesh)
    scale, shift = blk.affine.bias.to(h.dtype)[None, :, None, None].chunk(2, dim=1)
    h = silu(_gn(blk.norm1, h, mesh) * (scale + 1) + shift)
    h = dropout(h, blk.dropout, blk.training, generator, shard, (mesh.space_index, mesh.sp))
    h = _conv(blk.conv1, h, mesh)
    if blk.skip is not None:
        orig = blk.skip(orig)   # resampling and a 1x1 convolution: local
    x = h + orig
    if blk.heads:
        x = x + local_rows(blk.attend(spatial_attention(x, mesh), fast=False), mesh)
    return x


def spatial_unet_forward(unet: UNet, x: torch.Tensor, mesh: SpatialMesh,
                         generator: Optional[torch.Generator] = None,
                         shard: Tuple[int, int] = (0, 1), remat: bool = False) -> torch.Tensor:
    """H-sharded ``UNet.forward`` (``use_diffuse=False``, ``label_dim=0``):
    NHWC (B, H_loc, W, C) in and out, this rank's rows. In training mode the
    blocks' dropout masks come from ``generator`` in block order, each as
    ``shard``'s batch rows and this rank's H rows of the global mask; with
    ``remat`` (and grad enabled) every block is recomputed in the
    backward."""
    levels = sum(spec.down for spec in unet.enc_specs)
    if x.shape[1] % 2 ** levels:
        raise ValueError(f"{x.shape[1]} local rows do not pool {levels} times by 2")
    x = nchw(x)
    remat = remat and torch.is_grad_enabled()

    def run(blk, spec, x):
        def fn(x, emb, gen, shard):
            return _block(blk, x, spec, mesh, gen, shard)
        return remat_block(fn, x, None, generator, shard) if remat else fn(x, None, generator,
                                                                             shard)

    skips = []
    for spec in unet.enc_specs:
        blk = unet.enc[spec.name]
        x = _conv(blk, x, mesh) if spec.kind == "conv" else run(blk, spec, x)
        skips.append(x)
    for spec in unet.dec_specs:
        if spec.concat_skip:
            x = torch.cat([x, skips.pop()], dim=1)
        x = run(unet.dec[spec.name], spec, x)
    return nhwc(_conv(unet.out_conv, silu(_gn(unet.out_norm, x, mesh)), mesh))


def spatial_gaussian_forward(net: AxisAlignedConvGaussian, x: torch.Tensor, mesh: SpatialMesh,
                             target: Optional[torch.Tensor] = None) -> DiagGaussian:
    """H-sharded ``AxisAlignedConvGaussian`` (NHWC shards in): halo
    convolutions, local ReLU and pools, and the global average pool as the
    :func:`psum` of the local means over sp; (mu, log_sigma) then come out
    the same on every rank of the space group."""
    pools = len(net.encoder) // 3
    if x.shape[1] % 2 ** pools:
        raise ValueError(f"{x.shape[1]} local rows do not pool {pools} times by 2")
    h = nchw(x if target is None else torch.cat([x, target], dim=-1))
    for layer in net.encoder:   # conv, ReLU, AvgPool2d(2, 2) per level
        h = _conv(layer, h, mesh) if isinstance(layer, TorchConv) else layer(h)
    pooled = psum(h.mean(dim=(2, 3), keepdim=True) / mesh.sp, mesh)
    mu = net.conv_mu(pooled)[:, :, 0, 0]
    log_sigma = net.conv_log_sigma(pooled)[:, :, 0, 0]
    return DiagGaussian(mu.float(), log_sigma.float())


def spatial_fcomb(fcomb: Fcomb, feats: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Fcomb on an H-shard: its 1x1 convolutions are local, so the module
    runs on the shard as it is (prob_unet.py:80-121)."""
    return fcomb(feats, z)


def elbo_share(recon: torch.Tensor, kl: torch.Tensor, beta, mesh: SpatialMesh) -> torch.Tensor:
    """This rank's share of the ELBO: its local sum of squared errors plus
    ``beta * KL / sp``, since every rank of a space group computes the same
    KL of its batch rows. The shares of all ranks sum to the ELBO."""
    return recon + beta * kl / mesh.sp


def _world_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every rank (the identity without a process group)."""
    if is_initialized():
        torch.distributed.all_reduce(t)
    return t


def spatial_probunet_elbo(model: ProbabilisticUNet, x: torch.Tensor, y: torch.Tensor,
                          mesh: SpatialMesh, beta=None, z: Optional[torch.Tensor] = None,
                          eps: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None, remat: bool = False):
    """H-sharded ELBO (prob_unet.py:198-234 math), the training loss body.

    ``x``/``y`` are this rank's NHWC (B_loc, H_loc, W, C) shards; in 2d the
    batch rows are its data index's. The posterior draw is ``z``, or ``mu +
    sigma * eps`` with ``eps`` (B_loc, D) the same on every rank of the
    space group (the posterior itself is, from the psum'd pools), so z is
    the same too. ``generator`` draws the dropout masks in training mode.

    Returns (share, total, recon, kl): ``share`` (:func:`elbo_share`) is
    what this rank back-propagates; total, recon and kl are the global
    batch's ELBO terms, detached, identical on every rank (one all-reduce
    of the local terms over every rank)."""
    shard = (mesh.data_index, mesh.dp)
    feats = spatial_unet_forward(model.unet, x, mesh, generator, shard, remat)
    prior = spatial_gaussian_forward(model.prior, x, mesh)
    posterior = spatial_gaussian_forward(model.posterior, x, mesh, y)
    if z is None:
        z = posterior.rsample(eps=eps)
    out = spatial_fcomb(model.fcomb, feats, z)
    recon = (out.float() - y.float()).square().sum()
    kl = kl_diag_gaussian(posterior, prior).sum()
    b = model.beta if beta is None else beta
    share = elbo_share(recon, kl, b, mesh)
    recon_g, kl_g = _world_sum(torch.stack([recon.detach(), kl.detach() / mesh.sp])).unbind()
    return share, recon_g + b * kl_g, recon_g, kl_g


def spatial_probunet_forward(model: ProbabilisticUNet, x: torch.Tensor, z: torch.Tensor,
                             mesh: SpatialMesh) -> torch.Tensor:
    """H-sharded deterministic decode: U-Net features and Fcomb with a given
    ``z`` (``ProbabilisticUNet.reconstruct``); NHWC shards in and out."""
    return spatial_fcomb(model.fcomb, spatial_unet_forward(model.unet, x, mesh), z)
