"""Experiments (reference main.py) as thin configurations of the shared
training engine — ``probunet_tpu/train/loop.py``.

``train_probunet``: datasets -> ProbabilisticUNet (or, for
``ds_model="vae"``, the conv-VAE, which has its ELBO surface) -> epoch loop
of training steps -> seeded stochastic eval (and ensemble CRPS) -> ensemble
sampling plots every 2 epochs -> loss curves + checkpoints (reference
main.py:101-145). ``train_baseline`` (reference baseline/main.py) dispatches
``edm`` to ``train_edm`` (the EDM diffusion downscaler: denoising-score-
matching steps, a seeded DSM eval, Heun-sampled ensembles for CRPS and
plots), ``vae`` to ``train_probunet``, ``bcsd`` to ``run_bcsd`` (chunked
day-of-year climatologies), and trains the deterministic U-Net and the
LinearCNN with per-variable losses and a final physical-unit MAE. The epoch
loop itself — ingest modes, logging, watch and checkpoint cadences,
max_steps, exact resume, eval/CRPS/plot scheduling — lives once in
:mod:`probunet_torch.train.engine`. Under a process group each experiment
runs data parallel: the engine's plan feeds each rank its rows of every
global batch, the steps take the engine's ``dp``, and only rank 0 draws the
plots.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from probunet_torch.config import Config
from probunet_torch.models.baselines import ConvVAE, LinearCNN
from probunet_torch.models.edm import EDMPrecond
from probunet_torch.models.layers import reset_parameters
from probunet_torch.models.prob_unet import ProbabilisticUNet
from probunet_torch.models.unet import UNet
from probunet_torch.parallel.mesh import resolve_device
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
    make_deterministic_eval_step,
    make_deterministic_train_step,
    make_edm_crps_eval_fn,
    make_edm_eval_step,
    make_edm_sample_fn,
    make_edm_train_step,
    make_probunet_eval_step,
    make_probunet_train_step,
    make_sample_fn,
)


def _dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def build_probunet(cfg: Config, device=None, generator: Optional[torch.Generator] = None):
    """The probabilistic model for ``cfg`` on ``device`` (default the CUDA
    card), in ``channels_last`` memory format: the Probabilistic U-Net, or,
    for ``ds_model="vae"``, the conditional conv-VAE (the same elbo/sample
    surface, so every consumer is shared). Its weights are drawn from
    ``generator``; on the ``meta`` device nothing is allocated."""
    if cfg.ds_model not in ("probabilistic_unet", "vae"):
        raise ValueError(f"build_probunet builds the Probabilistic U-Net or the conv-VAE, not "
                         f"ds_model={cfg.ds_model!r}")
    device = resolve_device(device)
    if cfg.ds_model == "vae":
        model = ConvVAE(input_channels=cfg.nvars, num_classes=cfg.nvars,
                        latent_dim=cfg.latent_dim, num_filters=tuple(cfg.num_filters),
                        beta=cfg.beta, decoder_channels=cfg.baseline_channels,
                        device=device, generator=generator)
        return model.to(memory_format=torch.channels_last)
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


def init_probunet_state(cfg: Config, model: torch.nn.Module, tx, device=None) -> TrainState:
    """A fresh :class:`TrainState` for ``model``: its parameters moved to
    ``device`` (default the CUDA card; a ``meta`` model is materialized
    there) and drawn anew from ``cfg.seed`` by the layers' own init, in
    construction order, so the weights equal those of ``build_probunet(cfg,
    device, torch.Generator().manual_seed(cfg.seed))``; then the optimizer
    ``tx`` on them. With ``cfg.remat`` the model (built by
    :func:`build_probunet`) recomputes its U-Net blocks in the backward.
    Every model of the port is initialized so."""
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
    card; raises without one unless ``device="cpu"``), for the Probabilistic
    U-Net or (``ds_model="vae"``) the conv-VAE, checkpointed under
    ``<checkpoints_dir>/probunet`` or ``/vae``. Returns {state, tr_losses,
    val_losses, samples_per_sec}."""
    if cfg.parallel_mode in ("spatial", "2d"):
        raise NotImplementedError(f"parallel_mode={cfg.parallel_mode!r} (spatial sharding) is "
                                  "not ported yet: ROADMAP Queue 1 item 8")
    device = resolve_device(device)
    model = build_probunet(cfg, device="meta")
    dtype = _dtype(cfg)
    beta_fn = beta_schedule(cfg.beta_schedule, cfg.beta, cfg.beta_warmup_steps)
    accum = max(1, int(cfg.accum))

    def make_fns(ctx):
        train_step = make_probunet_train_step(model, cfg.lowres_scale, cfg.standardization,
                                              beta_fn, dtype, accum=cfg.accum,
                                              watch=cfg.watch_every > 0, dp=ctx.dp)
        eval_step = make_probunet_eval_step(model, cfg.lowres_scale, cfg.standardization, dtype,
                                            dp=ctx.dp)
        sample_fn = make_sample_fn(model, cfg.lowres_scale, cfg.standardization,
                                   cfg.num_samples, dtype)
        crps_fn = None
        if cfg.eval_crps:
            crps_fn = make_crps_eval_fn(model, cfg.lowres_scale, cfg.standardization,
                                        cfg.variables, cfg.crps_samples, dtype, dp=ctx.dp)

        def train_call(state, item, seed):
            return train_step(state, item["hr"], item["stats"], item["idx"], seed)

        def eval_call(state, item, generator, beta):
            return eval_step(item["hr"], item["stats"], item["idx"], generator, beta)

        def crps_call(state, item, generator):
            return crps_fn(item["hr"], item["stats"], item["idx"], generator)

        def plot_fn(state, epoch):
            _plot_probunet_samples(cfg, ctx.datasets["test"], sample_fn, epoch, device,
                                   ctx.primary)

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
        name="probunet" if cfg.ds_model == "probabilistic_unet" else cfg.ds_model,
        metrics_filename="metrics.jsonl",
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
    dtype = _dtype(cfg)

    def make_fns(ctx):
        train_step = make_edm_train_step(model, cfg.lowres_scale, cfg.standardization,
                                         compute_dtype=dtype, watch=cfg.watch_every > 0,
                                         dp=ctx.dp)
        eval_step = make_edm_eval_step(model, cfg.lowres_scale, cfg.standardization,
                                       compute_dtype=dtype, dp=ctx.dp)
        sample_fn = make_edm_sample_fn(model, cfg.lowres_scale, cfg.standardization,
                                       cfg.num_samples, cfg.edm_steps, compute_dtype=dtype)
        crps_fn = None
        if cfg.eval_crps:
            crps_fn = make_edm_crps_eval_fn(model, cfg.lowres_scale, cfg.standardization,
                                            cfg.variables, cfg.crps_samples, cfg.edm_steps,
                                            compute_dtype=dtype, dp=ctx.dp)

        def train_call(state, item, seed):
            return train_step(state, item["hr"], item["stats"], item["idx"], seed)

        def eval_call(state, item, generator, beta):   # DSM has no beta
            return eval_step(item["hr"], item["stats"], item["idx"], generator)

        def crps_call(state, item, generator):
            return crps_fn(item["hr"], item["stats"], item["idx"], generator)

        def plot_fn(state, epoch):
            # the EDM sampler has make_sample_fn's surface
            _plot_probunet_samples(cfg, ctx.datasets["test"], sample_fn, epoch, device,
                                   ctx.primary)

        return EngineFns(train_call=train_call, eval_call=eval_call,
                         crps_call=crps_call if crps_fn is not None else None,
                         plot_fn=plot_fn)

    spec = EngineSpec(
        name="edm", metrics_filename="metrics_edm.jsonl",
        init_state=lambda tx: init_edm_state(cfg, model, tx, device),
        make_fns=make_fns, desc="Train(edm)", rng_offset=3, loss_curve="loss_edm.png")
    return run_training(cfg, spec, datasets, make_plots, device)


def _label_dim(cfg: Config) -> int:
    """Width of the baseline U-Net's class labels: 'id' keeps the
    reference's label_dim=0 (the raw-timestamp labels are ignored,
    trainmodel.py:157); 'cyclic' feeds the (sin, cos) annual phase to
    ``map_label``."""
    return 2 if cfg.timetransform == "cyclic" else 0


def build_baseline_model(cfg: Config, device=None, generator: Optional[torch.Generator] = None):
    """The deterministic baseline for ``cfg`` on ``device`` (default the
    CUDA card), in ``channels_last`` memory format: the U-Net of the
    reference's baseline (width ``baseline_channels``, no attention, not
    even at the bottleneck; baseline/deterministic_unet.py:232,274,283) or
    the LinearCNN. Its weights are drawn from ``generator``; on the
    ``meta`` device nothing is allocated."""
    device = resolve_device(device)
    if cfg.ds_model == "deterministic_unet":
        model = UNet(tuple(cfg.resolution), cfg.nvars, cfg.nvars, label_dim=_label_dim(cfg),
                     use_diffuse=False, model_channels=cfg.baseline_channels,
                     channel_mult=tuple(cfg.channel_mult), num_blocks=cfg.num_blocks,
                     attn_resolutions=(), bottleneck_attention=False, dropout=cfg.dropout,
                     remat=cfg.remat, device=device, generator=generator)
    elif cfg.ds_model == "linearcnn":
        model = LinearCNN(resolution=tuple(cfg.resolution), in_channels=cfg.nvars,
                          ds_factor=cfg.lowres_scale, device=device, generator=generator)
    else:
        raise ValueError(f"unknown deterministic ds_model {cfg.ds_model!r}")
    return model.to(memory_format=torch.channels_last)


def train_baseline(cfg: Config, datasets=None, make_plots: bool = True, device=None) -> Dict:
    """The reference ``baseline/main.py`` pipeline on ``device`` (default
    the CUDA card): ``bcsd`` -> :func:`run_bcsd`, ``edm`` ->
    :func:`train_edm`, ``vae`` -> :func:`train_probunet`; the deterministic
    U-Net and the LinearCNN train with per-variable MSE, log
    ``metrics_baseline.jsonl``, checkpoint under ``<checkpoints_dir>/<ds_model>``
    and end with the validation MAE in physical units (mm/day, deg C).
    Those return {state, tr_losses, val_losses, mae, samples_per_sec}, the
    losses and the MAE per variable."""
    if cfg.ds_model == "bcsd":
        return run_bcsd(cfg, datasets or load_datasets(cfg, resolve_device(device)),
                        device=device)
    if cfg.ds_model == "edm":
        return train_edm(cfg, datasets, make_plots, device)
    if cfg.ds_model == "vae":
        # the conv-VAE has the ELBO surface, so it trains through the
        # prob-U-Net loop
        return train_probunet(cfg, datasets, make_plots, device)
    device = resolve_device(device)
    model = build_baseline_model(cfg, device="meta")
    tr_losses = {v: [] for v in cfg.variables}
    val_losses = {v: [] for v in cfg.variables}

    def make_fns(ctx):
        train_step = make_deterministic_train_step(model, cfg.lowres_scale, cfg.standardization,
                                                   _dtype(cfg), timetransform=cfg.timetransform,
                                                   watch=cfg.watch_every > 0, dp=ctx.dp)
        eval_step = make_deterministic_eval_step(model, cfg.lowres_scale, cfg.standardization,
                                                 cfg.variables, timetransform=cfg.timetransform,
                                                 dp=ctx.dp)
        mae_step = make_deterministic_eval_step(model, cfg.lowres_scale, cfg.standardization,
                                                cfg.variables, reconstruct=True, loss="mae",
                                                timetransform=cfg.timetransform, dp=ctx.dp)

        def train_call(state, item, seed):
            return train_step(state, item["hr"], item["stats"], item["idx"],
                              item["timestamps"], seed)

        def eval_call(state, item, generator, beta):
            return eval_step(item["hr"], item["stats"], item["idx"], item["timestamps"])

        def on_train_metrics(metrics):
            for i, v in enumerate(cfg.variables):
                tr_losses[v].append(float(metrics[f"train_loss_var{i}"]))

        def on_val_metrics(mf):
            for v in cfg.variables:
                val_losses[v].append(mf[f"eval_{v}"])

        def final_fn(state, logger, global_step):
            # sample + plot_batch (baseline/main.py:88-90, trainmodel.py:204-233)
            if make_plots and ctx.primary:
                _plot_baseline_samples(cfg, model, ctx.ds_val)
                _plot_baseline_losses(cfg, tr_losses, val_losses)
            # final physical-unit MAE (reference baseline/main.py:112-115)
            mae = {v: [] for v in cfg.variables}
            for gids in ctx.val_batches():
                item = ctx.val_item(gids)
                m = mae_step(item["hr"], item["stats"], item["idx"], item["timestamps"])
                for v in cfg.variables:
                    mae[v].append(float(m[f"eval_{v}"]))
            mae = {v: float(np.mean(x)) for v, x in mae.items()}
            if ctx.primary:
                for v in cfg.variables:
                    print(f"MAE for {v} on validation data: ", mae[v])
            logger.log({f"mae_{v}": mae[v] for v in cfg.variables}, step=global_step)
            return {"tr_losses": tr_losses, "val_losses": val_losses, "mae": mae}

        return EngineFns(train_call=train_call, eval_call=eval_call,
                         on_train_metrics=on_train_metrics, on_val_metrics=on_val_metrics,
                         final_fn=final_fn)

    spec = EngineSpec(
        name=cfg.ds_model, metrics_filename="metrics_baseline.jsonl",
        init_state=lambda tx: init_probunet_state(cfg, model, tx, device),
        make_fns=make_fns, desc="Train", rng_offset=2, needs_timestamps=True)
    return run_training(cfg, spec, datasets, make_plots, device)


def run_bcsd(cfg: Config, datasets, chunk: int = 1024, device=None) -> Dict:
    """BCSD on the validation and test splits, chunked, on ``device``
    (default the CUDA card). Returns {split: {"preds": (T, H, W, C) numpy,
    "mae": {var: mean absolute error}}} for "val" and "test".

    The day-of-year climatologies are accumulated over time chunks of the
    train split (:func:`~probunet_torch.models.baselines.doy_sums` into
    fixed (365, H, W, C) buffers) and the predictions stream chunk by
    chunk, so device memory is O(chunk + 365 tiles), never the full split.
    The tail chunk is padded with zero days in bin 364 so every chunk has
    one shape, and bin 364's count is corrected after. With several
    processes (each holding its shard of the train years) the accumulators
    are partial sums: they are summed across the processes
    (:func:`~probunet_torch.parallel.multihost.allreduce_sum`, float64), so
    every process applies the GLOBAL train climatology."""
    from probunet_torch.data import transforms
    from probunet_torch.models.baselines import doy_sums
    from probunet_torch.parallel.multihost import allreduce_sum, process_info

    dev = resolve_device(device)
    ds_train = datasets["train"]
    t_all, h, w, c = ds_train.hr_np.shape
    chunk = min(chunk, t_all)

    def lrinterp(hr):
        return transforms.make_pair(hr, cfg.lowres_scale, "none", None)["lrinterp"]

    num = torch.zeros(365, h, w, c, device=dev)
    den = torch.zeros(365, h, w, c, device=dev)
    cnt = torch.zeros(365, device=dev)
    doy_train = ds_train.dayofyear
    for lo in range(0, t_all, chunk):
        hr_c, doy_c = ds_train.hr_np[lo:lo + chunk], doy_train[lo:lo + chunk]
        pad = chunk - hr_c.shape[0]
        if pad:
            hr_c = np.concatenate([hr_c, np.zeros((pad, h, w, c), hr_c.dtype)])
            doy_c = np.concatenate([doy_c, np.full((pad,), 364, doy_c.dtype)])
        hr_d = torch.from_numpy(hr_c).to(dev)
        doy_d = torch.from_numpy(doy_c).to(dev)
        num += doy_sums(hr_d, doy_d)
        den += doy_sums(lrinterp(hr_d), doy_d)
        cnt += doy_sums(torch.ones(chunk, device=dev), doy_d)
        if pad:
            cnt[364] -= pad   # the padded rows were zero fields; fix the count
    if process_info()[1] > 1:
        num, den, cnt = (torch.from_numpy(a).to(dev, torch.float32) for a in allreduce_sum(
            *(t.cpu().double().numpy() for t in (num, den, cnt))))
    cnt_c = torch.clamp(cnt, min=1.0)[:, None, None, None]
    scale = (num / cnt_c) / (den / cnt_c + 1e-9)

    out = {}
    for split in ("val", "test"):
        ds = datasets[split]
        doy = torch.from_numpy(ds.dayofyear.astype(np.int64)).to(dev)
        pred_chunks, err_sum = [], 0.0
        for lo in range(0, len(ds), chunk):
            hr_c = torch.from_numpy(ds.hr_np[lo:lo + chunk]).to(dev)
            preds = lrinterp(hr_c) * scale[doy[lo:lo + chunk]]
            abs_err = (preds - hr_c).abs().mean(dim=(0, 1, 2))   # per variable
            pred_chunks.append(preds.cpu().numpy())
            err_sum = err_sum + abs_err.cpu().double().numpy() * hr_c.shape[0]
        mae = {v: float(err_sum[i] / len(ds)) for i, v in enumerate(cfg.variables)}
        out[split] = {"preds": np.concatenate(pred_chunks, axis=0), "mae": mae}
        print(f"BCSD {split} MAE:", mae)
    return out


def _plot_probunet_samples(cfg: Config, ds_test, sample_fn, epoch: int, device,
                           primary: bool = True) -> None:
    """``cfg.num_samples`` ensemble members of two random test days, drawn
    with a generator seeded by ``epoch``, as ``<plotdir>/epoch<epoch>.png``.
    Every process samples (as the JAX loop runs its sampler on all
    processes); only the ``primary`` draws the figure."""
    import matplotlib.pyplot as plt

    from probunet_torch.viz.plots import plot_sample_batch

    n = min(2, len(ds_test))
    idx = np.random.default_rng(epoch).integers(0, len(ds_test), size=n)
    hr_preds, pair = sample_fn(ds_test.hr_device(), ds_test.stats,
                               torch.from_numpy(idx).to(ds_test.device),
                               generator=torch.Generator(device).manual_seed(epoch))
    if not primary:
        return
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


def _plot_baseline_samples(cfg: Config, model, ds_val) -> None:
    """One batch of two random validation days forward -> residual_to_hr ->
    ``plot_batch`` (trainmodel.py:204-233), saved as
    ``<plotdir>/epoch<num_epochs>_samples_from_<ds_model>.png``."""
    from probunet_torch.data import transforms
    from probunet_torch.viz.plots import _plt, plot_batch

    n = min(2, len(ds_val))
    idx_np = np.random.default_rng(0).integers(0, len(ds_val), size=max(n, 2))
    idx = torch.from_numpy(idx_np).to(ds_val.device)
    hr = ds_val.hr_device()[idx]
    sl = transforms.slice_stats(ds_val.stats, cfg.standardization, idx)
    pair = transforms.make_pair(hr, cfg.lowres_scale, cfg.standardization, sl)
    model.eval()
    with torch.inference_mode():
        preds = model(pair["inputs"], class_labels=transforms.time_features(
            ds_val.timestamps_device()[idx], cfg.timetransform))
        hr_pred = transforms.residual_to_hr(preds.float(), pair["lrinterp"],
                                            cfg.standardization, sl)
    fig, _ = plot_batch(pair["lrinterp"].cpu().numpy(), hr_pred.cpu().numpy(),
                        pair["hr"].cpu().numpy(), ds_val.timestamps_np[idx_np], cfg.num_epochs,
                        cfg.variables, lat=ds_val.lat, lon=ds_val.lon, N=n)
    fig.savefig(os.path.join(cfg.plotdir,
                             f"epoch{cfg.num_epochs}_samples_from_{cfg.ds_model}.png"), dpi=150)
    _plt().close(fig)


def _plot_baseline_losses(cfg: Config, tr_losses, val_losses) -> None:
    """Per-variable smoothed train/val loss curves (baseline/main.py:93-106)
    as ``<plotdir>/loss_<var>.png``."""
    from probunet_torch.viz.plots import _plt

    plt = _plt()

    for var in cfg.variables:
        tr = moving_average(tr_losses[var], w=24)
        vl = moving_average(val_losses[var], w=48)
        if len(tr) == 0 or len(vl) == 0:
            continue
        tr_x = np.arange(1, len(tr) + 1)
        val_x = np.linspace(1, len(tr) + 1, len(vl))
        fig = plt.figure(figsize=(15, 10))
        plt.plot(tr_x, tr, lw=2, label="training loss")
        plt.plot(val_x, vl, lw=2, linestyle="dashed", label="validation loss")
        plt.xlabel("Steps")
        plt.ylabel("Loss")
        plt.title(f"Loss for {var}")
        plt.legend()
        fig.savefig(os.path.join(cfg.plotdir, f"loss_{var}.png"), dpi=150)
        plt.close(fig)
