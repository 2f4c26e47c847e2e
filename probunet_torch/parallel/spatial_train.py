"""Spatially-sharded training (H-axis model parallelism) —
``probunet_tpu/parallel/spatial_train.py``.

Makes tiles whose activations outgrow one card (BASELINE's multi-variable
256x256 configuration and beyond) trainable across cards: the whole ELBO,
with halo-exchange convolutions, GroupNorm statistics summed over the space
group, gathered coarse attention, posterior sampling, dropout and optional
per-block remat (:mod:`probunet_torch.parallel.spatial_unet`), runs on this
rank's rows, and the update is the unsharded one.

**Gradients.** The JAX package takes ``jax.grad`` outside a ``shard_map``
whose scalar outputs are replicated; the transpose sums the per-device
parameter cotangents. Here each rank back-propagates its share of the ELBO
(``spatial_unet.elbo_share``: its local sum of squared errors plus beta *
KL / sp, as every rank of a space group computes the same KL), the
collectives' backwards carry the cotangents between the ranks
(:mod:`probunet_torch.parallel.spatial`), and one all-reduce (SUM) of the
parameter gradients over every rank (``DataParallel.allreduce_grads``)
gives the gradient of the ELBO.

**Ranks.** In the JAX package one process drives every device of a (data,
space) mesh; here a device of that mesh is a rank
(:class:`~probunet_torch.parallel.mesh.SpatialMesh`). ``--parallel_mode
spatial`` makes every rank one space group; ``--parallel_mode 2d
--mesh_shape dp,-1`` makes ``dp`` space groups of ``world / dp`` ranks,
each holding the batch rows of its data index (the lockstep plan,
``MultihostPlan``, is keyed by the data index and count, so the ranks of one
space group ingest the same years and rows). JAX's refusal of pure spatial
mode over several processes (``spatial_train.py:330-337``) has no
counterpart: it exists because a JAX process owns many devices, and a
process of the port owns one, so several processes ARE the space group.

**Draws.** Every random draw a space group shares comes from one generator
seeded alike on its ranks, as the data index's rows of the global batch's
draw (``SpatialMesh.randn``): posterior and prior eps, the CRPS eps, the
sampler's eps; dropout draws this rank's H and batch rows of the global
mask. So the ranks compute what one process computes.

**Pair synthesis** runs on the full (B, H, W, C) HR tile, then each rank
takes its rows (:func:`put_spatial`): the bilinear x4 upsample reads
neighbouring LR rows, so pairing a rank's rows alone would be wrong at the
seams.

The sample plots are the data-parallel loop's (``train.loop.
_plot_probunet_samples``, drawn by the primary only) over the H-sharded
ensemble, which has ``make_sample_fn``'s surface: JAX's
``_plot_spatial_samples``. ``shard_map_unchecked`` and ``_replicator`` of
the JAX module are JAX mechanics (the replication checker, resharding to a
host-fetchable layout) and have no counterpart: the port runs eagerly, and
a rank gathers the decoded rows it needs.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from probunet_torch.data import transforms
from probunet_torch.parallel.mesh import SpatialMesh
from probunet_torch.parallel.spatial import gather_rows
from probunet_torch.parallel.spatial_unet import (
    check_tile,
    spatial_fcomb,
    spatial_gaussian_forward,
    spatial_probunet_elbo,
    spatial_unet_forward,
)
from probunet_torch.train.state import TrainState, global_norm
from probunet_torch.train.steps import (
    SeedOrGenerator,
    _ensemble_crps_metrics,
    _grad_leaf_norms,
    _step_generators,
)
from probunet_torch.utils.device import full_fp32


def put_spatial(x: torch.Tensor, mesh: SpatialMesh, batch: bool = False) -> torch.Tensor:
    """This rank's H rows of a (B, H, ...) array, contiguous; with ``batch``
    its data index's batch rows too (a global batch in 2d mode)."""
    h = x.shape[1] // mesh.sp
    x = x.narrow(1, mesh.space_index * h, h)
    if batch:
        b = x.shape[0] // mesh.dp
        x = x.narrow(0, mesh.data_index * b, b)
    return x.contiguous()


def make_spatial_probunet_train_step(model, mesh: SpatialMesh,
                                     beta_fn: Optional[Callable[[int], float]] = None,
                                     compute_dtype: torch.dtype = torch.float32,
                                     remat: bool = True, accum: int = 1, watch: bool = False,
                                     dp=None):
    """Returns step(state, x, y, seed_or_generator, z=None) -> metrics, for
    ``state.model is model``: ``x``/``y`` this rank's (B_loc, H_loc, W, C)
    standardized input and target shards (:func:`put_spatial`).

    The counterpart of ``train.steps.make_probunet_train_step`` on a shard:
    the latent and dropout draws derive from (seed, micro-step) as there
    (the posterior eps as the data index's rows of the global draw, unless
    ``z`` is given), the ELBO's share is back-propagated, the gradients
    all-reduced over every rank by ``dp`` (the process group's
    ``DataParallel``; None without one), and the optimizer steps. Metrics
    are the global batch's ``train_loss``, ``recon_loss``, ``kl_div``, and
    ``beta`` and ``grad_norm`` (of the global gradient), plus per-parameter
    gradient norms with ``watch``; tensors stay on the device. ``remat``
    recomputes every U-Net block in the backward."""
    beta_fn = beta_fn or (lambda step: model.beta)
    accum = max(1, int(accum))

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
             seed_or_generator: SeedOrGenerator, z: Optional[torch.Tensor] = None):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        model.train()
        with full_fp32():
            x, y = x.to(compute_dtype), y.to(compute_dtype)
            beta = beta_fn(state.step // accum)
            g_latent, g_dropout = _step_generators(seed_or_generator, state.step, x.device)
            eps = None if z is not None else mesh.randn((x.shape[0], model.latent_dim),
                                                        g_latent, x.device)
            params = state.optimizer.params
            for p in params:
                p.grad = None
            share, total, recon, kl = spatial_probunet_elbo(
                model, x, y, mesh, beta, z=z, eps=eps, generator=g_dropout, remat=remat)
            share.backward()
            for p in params:  # unused parameters (map_layer*, affine weights) still decay
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if dp is not None:
                dp.allreduce_grads(params, mean=False)
            metrics = {"train_loss": total, "recon_loss": recon, "kl_div": kl, "beta": beta,
                       "grad_norm": global_norm(p.grad for p in params)}
            if watch:
                metrics.update(_grad_leaf_norms(model))
            state.optimizer.step()
        state.step += 1
        return metrics

    return step


def make_spatial_eval_elbo(model, mesh: SpatialMesh,
                           compute_dtype: torch.dtype = torch.float32):
    """Returns fn(x, y, seed_or_generator, beta, z=None) -> {val_loss,
    val_recon_loss, val_kl_div}: the sharded ELBO of the global batch with
    dropout off and a seeded posterior draw (the data index's rows of the
    global draw, fp32 as the posterior's parameters), as
    ``train.steps.make_probunet_eval_step`` draws it."""

    @torch.no_grad()
    def fn(x, y, seed_or_generator: SeedOrGenerator, beta, z: Optional[torch.Tensor] = None):
        model.eval()
        with full_fp32():
            x, y = x.to(compute_dtype), y.to(compute_dtype)
            gen = (seed_or_generator if isinstance(seed_or_generator, torch.Generator)
                   else torch.Generator(x.device).manual_seed(int(seed_or_generator)))
            eps = None if z is not None else mesh.randn((x.shape[0], model.latent_dim), gen,
                                                        gen.device, torch.float32)
            _, total, recon, kl = spatial_probunet_elbo(model, x, y, mesh, beta, z=z, eps=eps)
        return {"val_loss": total, "val_recon_loss": recon, "val_kl_div": kl}

    return fn


def make_spatial_sample_fn(model, mesh: SpatialMesh, num_samples: int = 3,
                           compute_dtype: torch.dtype = torch.float32):
    """Returns fn(x, generator=None, eps=None) -> (B, K, H_loc, W, C) fp32
    standardized residual draws of this rank's rows: the U-Net features
    once per input, then K prior draws through Fcomb, K-major in the batch
    (``ProbabilisticUNet.sample``). ``eps`` (K, B, latent_dim): the draws'
    standard normals, the same on every rank of the space group; else drawn
    from ``generator`` for the batch as given."""

    @torch.inference_mode()
    def fn(x: torch.Tensor, generator: Optional[torch.Generator] = None,
           eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        model.eval()
        with full_fp32():
            x = x.to(compute_dtype)
            feats = spatial_unet_forward(model.unet, x, mesh)
            zs = spatial_gaussian_forward(model.prior, x, mesh).sample(num_samples, generator,
                                                                      eps)
            k, (b, h, w, c) = num_samples, feats.shape
            folded = feats[None].expand(k, b, h, w, c).reshape(k * b, h, w, c)
            outs = spatial_fcomb(model.fcomb, folded, zs.reshape(k * b, -1))
        return outs.reshape(k, b, h, w, -1).transpose(0, 1).float()

    return fn


def _spatial_ensemble_physical(cfg, sample_fn, mesh: SpatialMesh):
    """Returns fn(hr_all, stats, idx, generator=None, eps=None) ->
    (hr_preds (B, K, H, W, C) fp32 in physical units, pair dict), the
    surface of ``train.steps.make_sample_fn``: pair synthesis on the full
    tile, this rank's rows decoded by ``sample_fn``, the rows gathered over
    the space group, then residual -> HR on the full tile."""

    @torch.inference_mode()
    def fn(hr_all, stats, idx, generator=None, eps=None):
        hr = hr_all[idx]
        sl = transforms.slice_stats(stats, cfg.standardization, idx)
        pair = transforms.make_pair(hr, cfg.lowres_scale, cfg.standardization, sl)
        local = sample_fn(put_spatial(pair["inputs"], mesh), generator, eps)
        b, k, h, w, c = local.shape
        preds = gather_rows(local.reshape(b * k, h, w, c).contiguous(), mesh)
        preds = preds.reshape(b, k, h * mesh.sp, w, c)
        if sl is not None and cfg.standardization != "perpixel":
            sl = (sl[0][:, None], sl[1][:, None])
        return transforms.residual_to_hr(preds, pair["lrinterp"][:, None],
                                         cfg.standardization, sl), pair

    return fn


def _spatial_crps_metrics(cfg, sample_fn, mesh: SpatialMesh, dp=None):
    """Returns fn(hr_all, stats, idx, generator) -> per-variable mean CRPS
    and ensemble-mean MAE in physical units of a val batch (this data
    index's rows): the metric tail of ``train.steps.make_crps_eval_fn``,
    decoded through the H-sharded ensemble, with the K draws as the data
    index's rows of the global batch's and the metrics averaged over the
    ranks by ``dp``."""
    ensemble = _spatial_ensemble_physical(cfg, sample_fn, mesh)

    def fn(hr_all, stats, idx, generator):
        eps = mesh.randn((cfg.crps_samples, len(idx), cfg.latent_dim), generator,
                         generator.device, torch.float32, axis=1)
        hr_preds, pair = ensemble(hr_all, stats, idx, generator, eps)
        with torch.inference_mode():
            out = _ensemble_crps_metrics(hr_preds, pair["hr"], cfg.variables)
        return out if dp is None else dp.reduce_metrics(out, means=list(out))

    return fn


def _two_d_shape(cfg, world: int) -> tuple:
    """(dp, sp) of ``--parallel_mode 2d``: ``--mesh_shape dp,-1`` (default
    (2, -1)) over ``world`` ranks; JAX's refusal of a device count that
    does not factor (``spatial_train.py:345-353``)."""
    shape = tuple(cfg.mesh_shape) if len(cfg.mesh_shape) == 2 else (2, -1)
    fixed = [s for s in shape if s != -1]
    if world < 2 or (fixed and world % int(np.prod(fixed))) or (
            len(fixed) == 2 and world != int(np.prod(fixed))):
        raise ValueError(f"parallel_mode=2d needs a 2D-factorable device count; have {world} "
                         f"devices for mesh_shape {shape} — pass --mesh_shape dp,-1 with dp "
                         "dividing the device count")
    dp = shape[0] if shape[0] != -1 else world // shape[1]
    return dp, world // dp


def train_probunet_spatial(cfg, datasets=None, make_plots: bool = True, device=None):
    """``--parallel_mode spatial`` and ``2d``: the prob-U-Net trainer of
    ``train.loop.train_probunet`` with the height axis sharded over the
    ranks (see the module docstring), on the shared engine
    (:mod:`probunet_torch.train.engine`: ingest, exact resume,
    ``--checkpoint_every``/``--max_steps``/``--watch_every``, scheduled-beta
    eval, CRPS, plots, rank-0 writes); this trainer contributes the sharded
    steps, the 2d plan (``EngineSpec.build_plan``) and the H-sharded
    ensemble tails. Ingest: ``resident_data`` "auto" streams (the
    tiles-beyond-one-card mode this trainer exists for). Returns {state,
    tr_losses, val_losses, samples_per_sec}."""
    from probunet_torch.parallel.mesh import resolve_device
    from probunet_torch.parallel.multihost import make_plan, process_info
    from probunet_torch.train.engine import EngineFns, EngineSpec, load_datasets, run_training
    from probunet_torch.train.loop import (
        _dtype,
        _plot_probunet_samples,
        build_probunet,
        init_probunet_state,
    )
    from probunet_torch.train.steps import beta_schedule

    two_d = cfg.parallel_mode == "2d"
    world = process_info()[1]
    if not two_d and int(cfg.data_shards) > 1:
        raise ValueError("--data_shards applies to the multi-host batch plan, which pure "
                         "spatial mode has none of — use --parallel_mode 2d --mesh_shape "
                         "<shards>,-1")
    dp, sp = _two_d_shape(cfg, world) if two_d else (1, world)
    if two_d and cfg.batch_size % dp:
        raise ValueError(f"batch_size {cfg.batch_size} must divide the data mesh axis ({dp}) "
                         "in 2d mode")
    check_tile(cfg.resolution[0], sp, cfg.channel_mult, cfg.num_filters)
    device = resolve_device(device)
    mesh = SpatialMesh(dp)
    datasets = datasets or load_datasets(cfg, device, shard=(mesh.data_index, dp))
    model = build_probunet(cfg, device="meta")
    beta_fn = beta_schedule(cfg.beta_schedule, cfg.beta, cfg.beta_warmup_steps)
    accum = max(1, int(cfg.accum))

    def build_plan(cfg, ds_train, device):
        # 2d: batch rows shard over the data index (each data index is one
        # shard of the plan), H over the space group
        if not two_d:
            return None
        plan = make_plan(cfg, ds_train, device, shard=(mesh.data_index, dp),
                         group=mesh.data_group)
        if plan is not None and plan.pc > 1 and dp % plan.pc:
            raise ValueError(f"2d multi-process needs the data axis ({dp}) to be a multiple of "
                             f"process_count ({plan.pc}) so each process owns contiguous "
                             "batch shards")
        return plan

    def make_fns(ctx):
        dtype = _dtype(cfg)
        step = make_spatial_probunet_train_step(model, mesh, beta_fn, dtype, remat=cfg.remat,
                                                accum=cfg.accum, watch=cfg.watch_every > 0,
                                                dp=ctx.dp)
        eval_fn = make_spatial_eval_elbo(model, mesh, dtype)
        ensemble = _spatial_ensemble_physical(
            cfg, make_spatial_sample_fn(model, mesh, cfg.num_samples, dtype), mesh)
        crps_fn = None
        if cfg.eval_crps:
            crps_fn = _spatial_crps_metrics(
                cfg, make_spatial_sample_fn(model, mesh, cfg.crps_samples, dtype), mesh, ctx.dp)

        def pair(item):
            idx = item["idx"]
            sl = transforms.slice_stats(item["stats"], cfg.standardization, idx)
            p = transforms.make_pair(item["hr"][idx], cfg.lowres_scale, cfg.standardization, sl)
            return put_spatial(p["inputs"], mesh), put_spatial(p["targets"], mesh)

        def train_call(state, item, seed):
            return step(state, *pair(item), seed)

        def eval_call(state, item, generator, beta):
            return eval_fn(*pair(item), generator, beta)

        def crps_call(state, item, generator):
            return crps_fn(item["hr"], item["stats"], item["idx"], generator)

        def plot_fn(state, epoch):
            # every rank decodes its rows (the sampler holds collectives);
            # the primary draws
            _plot_probunet_samples(cfg, ctx.datasets["test"], ensemble, epoch, device,
                                   ctx.primary)

        return EngineFns(
            train_call=train_call, eval_call=eval_call,
            eval_beta_fn=lambda gs: beta_fn(gs // accum),
            crps_call=crps_call if crps_fn is not None else None, plot_fn=plot_fn)

    spec = EngineSpec(
        name="probunet", metrics_filename="metrics.jsonl",
        init_state=lambda tx: init_probunet_state(cfg, model, tx, device),
        make_fns=make_fns, desc="Train(spatial)", rng_offset=1, build_plan=build_plan,
        wandb_config=True, loss_curve="loss.png")
    return run_training(cfg, spec, datasets, make_plots, device)
