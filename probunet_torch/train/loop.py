"""Experiments (reference main.py) as thin configurations of the shared
training engine — ``probunet_tpu/train/loop.py``.

``train_probunet``: datasets -> ProbabilisticUNet -> epoch loop of training
steps -> seeded stochastic eval (and ensemble CRPS) -> ensemble sampling
plots every 2 epochs -> loss curves + checkpoints (reference
main.py:101-145). ``train_edm`` (``ds_model="edm"``, through
``train_baseline``): the EDM diffusion downscaler on the same engine, with
denoising-score-matching steps, a seeded DSM eval and Heun-sampled
ensembles for CRPS and plots. The epoch loop itself — ingest modes, logging,
watch and checkpoint cadences, max_steps, exact resume, eval/CRPS/plot
scheduling — lives once in :mod:`probunet_torch.train.engine`. The
deterministic baselines and ``run_bcsd`` are not ported yet; they plug into
the same engine.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from probunet_torch.config import Config
from probunet_torch.models.edm import EDMPrecond
from probunet_torch.models.layers import reset_parameters
from probunet_torch.models.prob_unet import ProbabilisticUNet
from probunet_torch.train.engine import (
    EngineFns,
    EngineSpec,
    load_datasets,  # noqa: F401  (public API, as in the JAX package's loop)
    run_training,
)
from probunet_torch.train.state import TrainState, create_train_state
from probunet_torch.train.steps import (
    beta_schedule,
    make_crps_eval_fn,
    make_edm_crps_eval_fn,
    make_edm_eval_step,
    make_edm_sample_fn,
    make_edm_train_step,
    make_probunet_eval_step,
    make_probunet_train_step,
    make_sample_fn,
)
from probunet_torch.utils.device import resolve_device


def build_probunet(cfg: Config, device=None,
                   generator: Optional[torch.Generator] = None) -> ProbabilisticUNet:
    """The Probabilistic U-Net for ``cfg`` on ``device`` (default the CUDA
    card), in ``channels_last`` memory format. Its weights are drawn from
    ``generator``; on the ``meta`` device nothing is allocated."""
    if cfg.ds_model != "probabilistic_unet":
        raise NotImplementedError(f"build_probunet builds the Probabilistic U-Net, not "
                                  f"ds_model={cfg.ds_model!r}: build_edm_model builds EDM; "
                                  "the baselines are not ported yet (ROADMAP Queue 1 item 5)")
    device = resolve_device(device)
    model = ProbabilisticUNet(
        input_channels=cfg.nvars,
        num_classes=cfg.nvars,
        latent_dim=cfg.latent_dim,
        num_filters=tuple(cfg.num_filters),
        beta=cfg.beta,
        img_resolution=tuple(cfg.resolution),
        model_channels=cfg.model_channels,
        channel_mult=tuple(cfg.channel_mult),
        num_blocks=cfg.num_blocks,
        attn_resolutions=tuple(cfg.attn_resolutions),
        dropout=cfg.dropout,
        fast_attention=cfg.fast_attention,
        remat=cfg.remat,
        device=device,
        generator=generator,
    )
    return model.to(memory_format=torch.channels_last)


def init_probunet_state(cfg: Config, model: ProbabilisticUNet, tx, device=None) -> TrainState:
    """A fresh :class:`TrainState` for ``model``: its parameters moved to
    ``device`` (default the CUDA card; a ``meta`` model is materialized
    there) and drawn anew from ``cfg.seed`` by the layers' own init, in
    construction order, so the weights equal those of ``build_probunet(cfg,
    device, torch.Generator().manual_seed(cfg.seed))``; then the optimizer
    ``tx`` on them. With ``cfg.remat`` the model (built by
    :func:`build_probunet`) recomputes its U-Net blocks in the backward."""
    model.to_empty(device=resolve_device(device))
    reset_parameters(model, torch.Generator().manual_seed(cfg.seed))
    return create_train_state(model, tx)


def build_edm_model(cfg: Config, device=None,
                    generator: Optional[torch.Generator] = None) -> EDMPrecond:
    """The EDM-preconditioned diffusion downscaler for ``cfg`` on ``device``
    (default the CUDA card), in ``channels_last`` memory format: the
    denoiser U-Net sees the noisy residual concatenated with the LR-interp
    condition (2 x nvars channels); ``fast_attention`` and ``remat`` go to
    the backbone. Its weights are drawn from ``generator``; on the ``meta``
    device nothing is allocated. As in the JAX package, the backbone runs in
    fp32 in both numerics modes."""
    model = EDMPrecond(
        img_resolution=tuple(cfg.resolution),
        in_channels=2 * cfg.nvars,
        out_channels=cfg.nvars,
        model_channels=cfg.model_channels,
        channel_mult=tuple(cfg.channel_mult),
        num_blocks=cfg.num_blocks,
        attn_resolutions=tuple(cfg.attn_resolutions),
        dropout=cfg.dropout,
        fast_attention=cfg.fast_attention,
        remat=cfg.remat,
        device=resolve_device(device),
        generator=generator,
    )
    return model.to(memory_format=torch.channels_last)


def init_edm_state(cfg: Config, model: EDMPrecond, tx, device=None) -> TrainState:
    """:func:`init_probunet_state` for an EDM model from :func:`build_edm_model`."""
    return init_probunet_state(cfg, model, tx, device)


def train_probunet(cfg: Config, datasets=None, make_plots: bool = True, device=None) -> Dict:
    """The reference ``main.py`` pipeline on ``device`` (default the CUDA
    card; raises without one unless ``device="cpu"``). Returns {state,
    tr_losses, val_losses, samples_per_sec}."""
    if cfg.parallel_mode in ("spatial", "2d"):
        raise NotImplementedError(f"parallel_mode={cfg.parallel_mode!r} (spatial sharding) is "
                                  "not ported yet: ROADMAP Queue 1 item 8")
    device = resolve_device(device)
    model = build_probunet(cfg, device="meta")
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    beta_fn = beta_schedule(cfg.beta_schedule, cfg.beta, cfg.beta_warmup_steps)
    accum = max(1, int(cfg.accum))

    def make_fns(ctx):
        train_step = make_probunet_train_step(model, cfg.lowres_scale, cfg.standardization,
                                              beta_fn, dtype, accum=cfg.accum,
                                              watch=cfg.watch_every > 0)
        eval_step = make_probunet_eval_step(model, cfg.lowres_scale, cfg.standardization, dtype)
        sample_fn = make_sample_fn(model, cfg.lowres_scale, cfg.standardization,
                                   cfg.num_samples, dtype)
        crps_fn = None
        if cfg.eval_crps:
            crps_fn = make_crps_eval_fn(model, cfg.lowres_scale, cfg.standardization,
                                        cfg.variables, cfg.crps_samples, dtype)

        def train_call(state, item, seed):
            return train_step(state, item["hr"], item["stats"], item["idx"], seed)

        def eval_call(state, item, generator, beta):
            return eval_step(item["hr"], item["stats"], item["idx"], generator, beta)

        def crps_call(state, item, generator):
            return crps_fn(item["hr"], item["stats"], item["idx"], generator)

        def plot_fn(state, epoch):
            _plot_probunet_samples(cfg, ctx.datasets["test"], sample_fn, epoch, device)

        return EngineFns(
            train_call=train_call,
            eval_call=eval_call,
            # eval at the SCHEDULED β so annealed runs (--beta_schedule
            # linear/cyclic) log train/val ELBOs computed at the same KL weight
            eval_beta_fn=lambda gs: beta_fn(gs // accum),
            crps_call=crps_call if crps_fn is not None else None,
            plot_fn=plot_fn,
        )

    spec = EngineSpec(
        name="probunet", metrics_filename="metrics.jsonl",
        init_state=lambda tx: init_probunet_state(cfg, model, tx, device),
        make_fns=make_fns, desc="Train", rng_offset=1,
        wandb_config=True, loss_curve="loss.png")
    return run_training(cfg, spec, datasets, make_plots, device)


def train_edm(cfg: Config, datasets=None, make_plots: bool = True, device=None) -> Dict:
    """The diffusion downscaler (``ds_model="edm"``) on ``device`` (default
    the CUDA card): denoising-score-matching training steps, a seeded DSM
    eval, Heun-sampled ensembles for CRPS and the every-2-epochs plots, loss
    curve and checkpoints under ``<checkpoints_dir>/edm``. Returns {state,
    tr_losses, val_losses, samples_per_sec}."""
    device = resolve_device(device)
    model = build_edm_model(cfg, device="meta")
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    def make_fns(ctx):
        train_step = make_edm_train_step(model, cfg.lowres_scale, cfg.standardization,
                                         compute_dtype=dtype, watch=cfg.watch_every > 0)
        eval_step = make_edm_eval_step(model, cfg.lowres_scale, cfg.standardization,
                                       compute_dtype=dtype)
        sample_fn = make_edm_sample_fn(model, cfg.lowres_scale, cfg.standardization,
                                       cfg.num_samples, cfg.edm_steps, compute_dtype=dtype)
        crps_fn = None
        if cfg.eval_crps:
            crps_fn = make_edm_crps_eval_fn(model, cfg.lowres_scale, cfg.standardization,
                                            cfg.variables, cfg.crps_samples, cfg.edm_steps,
                                            compute_dtype=dtype)

        def train_call(state, item, seed):
            return train_step(state, item["hr"], item["stats"], item["idx"], seed)

        def eval_call(state, item, generator, beta):   # DSM has no beta
            return eval_step(item["hr"], item["stats"], item["idx"], generator)

        def crps_call(state, item, generator):
            return crps_fn(item["hr"], item["stats"], item["idx"], generator)

        def plot_fn(state, epoch):
            # the EDM sampler has make_sample_fn's surface
            _plot_probunet_samples(cfg, ctx.datasets["test"], sample_fn, epoch, device)

        return EngineFns(train_call=train_call, eval_call=eval_call,
                         crps_call=crps_call if crps_fn is not None else None,
                         plot_fn=plot_fn)

    spec = EngineSpec(
        name="edm", metrics_filename="metrics_edm.jsonl",
        init_state=lambda tx: init_edm_state(cfg, model, tx, device),
        make_fns=make_fns, desc="Train(edm)", rng_offset=3, loss_curve="loss_edm.png")
    return run_training(cfg, spec, datasets, make_plots, device)


def train_baseline(cfg: Config, datasets=None, make_plots: bool = True, device=None) -> Dict:
    """The reference ``baseline/main.py`` pipeline: ``ds_model="edm"`` trains
    the diffusion downscaler (:func:`train_edm`); the deterministic
    baselines, the conv-VAE and BCSD are not ported yet."""
    if cfg.ds_model == "edm":
        return train_edm(cfg, datasets, make_plots, device)
    raise NotImplementedError(f"ds_model={cfg.ds_model!r} is not ported yet: ROADMAP Queue 1 "
                              "item 5 (baselines)")


def _plot_probunet_samples(cfg: Config, ds_test, sample_fn, epoch: int, device) -> None:
    """``cfg.num_samples`` ensemble members of two random test days, drawn
    with a generator seeded by ``epoch``, as ``<plotdir>/epoch<epoch>.png``."""
    import matplotlib.pyplot as plt

    from probunet_torch.viz.plots import plot_sample_batch

    n = min(2, len(ds_test))
    idx = np.random.default_rng(epoch).integers(0, len(ds_test), size=n)
    hr_preds, pair = sample_fn(ds_test.hr_device(), ds_test.stats,
                               torch.from_numpy(idx).to(ds_test.device),
                               generator=torch.Generator(device).manual_seed(epoch))
    fig, _ = plot_sample_batch(pair["lrinterp"].cpu().numpy(), hr_preds.cpu().numpy(),
                               pair["hr"].cpu().numpy(), ds_test.timestamps_np[idx], epoch,
                               cfg.variables, lat=ds_test.lat, lon=ds_test.lon, N=n,
                               num_samples=cfg.num_samples)
    fig.savefig(os.path.join(cfg.plotdir, f"epoch{epoch}.png"), dpi=150)
    plt.close(fig)


def moving_average(x, w: int):
    """Smoothing for loss-curve plots (reference baseline/main.py:12-13).
    Empty in -> empty out (a --max_steps stop can end a run before any eval
    batch, leaving a loss series empty)."""
    x = np.asarray(x)
    if x.size == 0:
        return x
    w = max(1, min(w, len(x)))
    return np.convolve(x, np.ones(w), "valid") / w
