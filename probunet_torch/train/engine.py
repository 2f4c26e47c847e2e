"""One training engine for every experiment —
``probunet_tpu/train/engine.py``.

The experiments in :mod:`probunet_torch.train.loop` are thin configurations
of this loop; every lifecycle feature lives here once:

- the multi-process plan (:class:`~probunet_torch.parallel.multihost.
  MultihostPlan`), optimizer and state construction on the device,
  checkpoint restore, and the check that every rank holds the same
  parameters;
- **ingest-mode selection**: lockstep plan batches (this process's rows of
  each global batch, assembled ahead on a background thread) under a plan;
  else the default device-resident dataset tensor with a per-step index
  gather (each epoch's batch indices go to the device in one copy), or
  double-buffered host->device streaming (``--device_resident_data
  false``, :mod:`probunet_torch.data.pipeline`);
- the epoch loop: per-step bookkeeping (``--log_every`` cadence,
  ``--watch_every`` wandb.watch parity, ``--checkpoint_every`` step-granular
  checkpoints, ``--max_steps`` stop), seeded stochastic eval at the
  **scheduled** β, full-split ensemble CRPS with the evaluated-batch count
  always logged, the sample-plot cadence (every 2 epochs), epoch-end
  checkpoints, and EXACT mid-epoch resume: steps per epoch are constant
  (remainders dropped), so the restored step counter alone gives (epoch,
  intra-epoch offset), and the continuation replays the batch and noise
  sequence an uninterrupted run takes.

The loss of each step stays on the device; the host fetches metrics only at
the ``--log_every`` cadence and stacks the epoch's losses at its end, so the
host enqueues step after step without waiting for the card.

Per-step seeds: training draws from ``cfg.seed + spec.rng_offset`` folded
with the micro-step (``steps._step_generators``); eval batch ``bi`` from
(``cfg.eval_seed``, bi), CRPS batch ``bi`` from (``cfg.eval_seed``, 10_000 +
bi), as the JAX engine folds them into its keys.

Experiment-specific pieces plug in through :class:`EngineSpec` /
:class:`EngineFns`. Items flowing through the loop are dicts with keys
``hr`` (the batch or the full dataset tensor), ``stats`` (standardization
statistics or None), ``idx`` (batch gather indices) and, for an experiment
that asks for them, ``timestamps`` (the batch's float32 ns).

Several processes (one per card, ``torch.distributed``): each reads its
shard of the train years, the plan keeps them in lockstep on global batches
with GLOBAL statistics, the steps all-reduce gradients and metrics
(``EngineCtx.dp``), every rank runs every step, eval and collective, and
only rank 0 writes metrics, plots and checkpoints. The spatial modes are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from probunet_torch.config import Config
from probunet_torch.parallel.mesh import data_parallel, resolve_device
from probunet_torch.parallel.multihost import make_plan, process_info, shard_years
from probunet_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from probunet_torch.train.state import TrainState, make_optimizer
from probunet_torch.utils.logging import MetricLogger, StepTimer, progress


@dataclasses.dataclass
class EngineFns:
    """An experiment's plug-ins, built once per run by ``EngineSpec.make_fns(ctx)``.

    ``train_call(state, item, seed) -> metrics`` is required: it updates
    ``state`` in place, and its metrics contain ``train_loss`` as a device
    scalar. Everything else is optional."""

    train_call: Callable[[TrainState, Dict, int], Dict[str, Any]]
    # (state, item, generator, beta) -> metrics; beta is None unless
    # eval_beta_fn is set
    eval_call: Optional[Callable] = None
    # global_step -> scheduled β passed to eval_call (keeps annealed train/val
    # ELBOs comparable; logged as val_beta)
    eval_beta_fn: Optional[Callable] = None
    crps_call: Optional[Callable] = None       # (state, item, generator) -> metrics
    plot_fn: Optional[Callable] = None         # (state, epoch) -> None
    # (state, logger, global_step) -> dict merged into the result (runs before
    # logger.close; e.g. the baseline's final physical-unit MAE)
    final_fn: Optional[Callable] = None
    on_train_metrics: Optional[Callable] = None  # per-step hook (device metrics)
    on_val_metrics: Optional[Callable] = None    # per-val-batch hook (floats)


@dataclasses.dataclass
class EngineSpec:
    """Static experiment description: names, RNG stream, and the factories."""

    name: str                    # checkpoint subdirectory
    metrics_filename: str        # default metrics JSONL name under plotdir
    init_state: Callable         # (tx) -> TrainState on the run's device
    make_fns: Callable           # (EngineCtx) -> EngineFns
    desc: str = "Train"          # progress-bar prefix
    rng_offset: int = 1          # train noise stream seed = cfg.seed + rng_offset
    needs_timestamps: bool = False  # items carry float32 ``timestamps`` (B,)
    build_plan: Optional[Callable] = None   # (cfg, ds_train, device) -> plan | None
    wandb_config: bool = False   # pass vars(cfg) as the wandb run config
    loss_curve: Optional[str] = None  # filename for the train/val loss plot


def load_datasets(cfg: Config, device=None) -> Dict[str, Any]:
    """The three split datasets, their device tensors on ``device``
    (default the CUDA card). With several processes each reads only its
    contiguous shard of the TRAIN years (:func:`shard_years`); val and test
    stay whole on every process, so every process evaluates the same data."""
    from probunet_torch.data.dataset import ClimexDataset

    pi, pc = process_info()
    out = {}
    for split in ("train", "val", "test"):
        years = cfg.years(split)
        if split == "train" and pc > 1:
            years = shard_years(years, pi, pc)
        out[split] = ClimexDataset(
            cfg.datadir, years=years, variables=cfg.variables, coords=cfg.coords,
            lowres_scale=cfg.lowres_scale, time_transform=cfg.timetransform,
            standardization=cfg.standardization, device=device)
    return out


def _crps_batches(cfg: Config, n_val_batches: int) -> int:
    """How many val batches the per-epoch CRPS eval covers: the FULL split by
    default; ``--crps_eval_batches N`` bounds the cost for huge splits. The
    count is always logged (crps_batches_evaluated) so a truncated metric can
    never masquerade as the split metric."""
    if cfg.crps_eval_batches:
        return min(n_val_batches, int(cfg.crps_eval_batches))
    return n_val_batches


def _seeded_generator(seed: int, index: int, device) -> torch.Generator:
    """A generator on ``device`` for draw ``index`` of the stream ``seed``:
    the pair goes through numpy's SeedSequence, as the train step derives
    its (seed, micro-step) streams."""
    s = int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1)[0])
    return torch.Generator(device).manual_seed(s)


def _require_data_parallel(cfg: Config) -> None:
    if cfg.parallel_mode != "data":
        raise NotImplementedError(f"parallel_mode={cfg.parallel_mode!r} (spatial sharding) is "
                                  "not ported yet: ROADMAP Queue 1 item 8")


class EngineCtx:
    """Per-run ingest state shared between the engine loop and the
    experiment's ``make_fns``: the device, the multi-process ``plan`` (or
    None) and ``dp`` (the process group's
    :class:`~probunet_torch.parallel.mesh.DataParallel`, which the steps
    take, or None), whether this process is the ``primary`` (rank 0), the
    device-resident tensors or the host-side statistics, and the item
    builders for train/val batches."""

    def __init__(self, cfg: Config, datasets, device, needs_timestamps: bool = False,
                 plan=None):
        self.cfg = cfg
        self.datasets = datasets
        self.device = device
        self.needs_timestamps = needs_timestamps
        self.plan = plan
        self.dp = data_parallel()
        self.primary = process_info()[0] == 0
        self.ds_train, self.ds_val = datasets["train"], datasets["val"]
        self.streaming = not cfg.resident_data and plan is None

        self.hr_train = self.stats_train = None
        self.hr_val = self.stats_val = None
        self.ts_train = self.ts_val = None
        self.stats_train_np = self.stats_val_np = None
        self._stats_val_global = None
        if plan is not None:
            # lockstep global batches from this process's rows; val stays whole
            self.stats_val_np = plan.split_stats(self.ds_val)
        elif self.streaming:
            # host-resident dataset; batches stream to the card double-buffered
            from probunet_torch.data.pipeline import compute_lr_stats_streaming
            self.stats_train_np = compute_lr_stats_streaming(
                self.ds_train.hr_np, cfg.lowres_scale, cfg.standardization, device=device)
            self.stats_val_np = compute_lr_stats_streaming(
                self.ds_val.hr_np, cfg.lowres_scale, cfg.standardization, device=device)
            self._arange = torch.arange(cfg.batch_size, device=device)
        else:
            self.hr_train, self.stats_train = self.ds_train.hr_device(), self.ds_train.stats
            self.hr_val, self.stats_val = self.ds_val.hr_device(), self.ds_val.stats
            if needs_timestamps:
                self.ts_train = self.ds_train.timestamps_device()
                self.ts_val = self.ds_val.timestamps_device()

    # ---- epoch geometry ----
    @property
    def steps_per_epoch(self) -> int:
        if self.plan is not None:
            return self.plan.steps_per_epoch
        return len(self.ds_train) // self.cfg.batch_size

    # ---- train ingest ----
    def train_items(self, epoch: int, offset: int):
        """(generator of item dicts, total) for one epoch, starting at
        ``offset`` (mid-epoch resume). Close the generator to stop its
        ingest early."""
        cfg = self.cfg
        ts_np = self.ds_train.timestamps_np if self.needs_timestamps else None
        if self.plan is not None:
            batches = self.plan.epoch_batches(cfg.seed + epoch)[offset:]
            return (self.plan.batch_iter(self.ds_train.hr_np, batches, self.plan.stats_np,
                                         timestamps_np=ts_np), batches.shape[0])
        if self.streaming:
            from probunet_torch.data.pipeline import stream_batches
            it = stream_batches(self.ds_train.hr_np, cfg.batch_size, cfg.seed + epoch,
                                self.stats_train_np, cfg.standardization, device=self.device,
                                start_batch=offset, timestamps_np=ts_np)

            def gen():
                try:
                    for item in it:
                        item["idx"] = self._arange
                        yield item
                finally:
                    it.close()

            return gen(), self.steps_per_epoch - offset
        batches = self.ds_train.epoch_indices(cfg.seed + epoch, cfg.batch_size)
        # the epoch's indices in one copy; each step takes a view of a row
        batches_dev = torch.from_numpy(batches[offset:]).to(self.device)

        def gen():
            for idx in batches_dev:
                item = {"hr": self.hr_train, "stats": self.stats_train, "idx": idx}
                if self.ts_train is not None:
                    item["timestamps"] = self.ts_train[idx]
                yield item

        return gen(), batches.shape[0] - offset

    # ---- val ingest ----
    def val_batches(self) -> np.ndarray:
        if self.plan is not None:
            return self.plan.replicated_batches(len(self.ds_val))
        return self.ds_val.epoch_indices(0, self.cfg.batch_size, shuffle=False)

    def val_item(self, gids: np.ndarray) -> Dict:
        if self.plan is not None:
            ts_np = self.ds_val.timestamps_np if self.needs_timestamps else None
            return self.plan.device_batch(self.ds_val.hr_np, gids, self.stats_val_np,
                                          timestamps_np=ts_np, replicated_source=True)
        idx = np.asarray(gids)
        if not self.streaming:
            item = {"hr": self.hr_val, "stats": self.stats_val,
                    "idx": torch.from_numpy(idx).to(self.device)}
            if self.ts_val is not None:
                item["timestamps"] = self.ts_val[item["idx"]]
            return item
        item = {"hr": torch.from_numpy(self.ds_val.hr_np[idx]).to(self.device),
                "idx": torch.arange(len(idx), device=self.device)}
        if self.needs_timestamps:
            item["timestamps"] = torch.from_numpy(
                self.ds_val.timestamps_np[idx].astype(np.float32)).to(self.device)
        stats = self.stats_val_np
        if stats is None:
            item["stats"] = None
        elif self.cfg.standardization in ("pertimestep", "minmax"):
            item["stats"] = tuple(torch.from_numpy(s[idx]).to(self.device) for s in stats)
        else:
            if self._stats_val_global is None:
                self._stats_val_global = tuple(
                    torch.from_numpy(np.asarray(s, np.float32)).to(self.device) for s in stats)
            item["stats"] = self._stats_val_global
        return item


def run_training(cfg: Config, spec: EngineSpec, datasets=None, make_plots: bool = True,
                 device=None) -> Dict:
    """The shared epoch loop on ``device`` (default the CUDA card, under a
    process group this rank's). Returns {state, tr_losses, val_losses,
    samples_per_sec} plus whatever the experiment's ``final_fn`` adds."""
    _require_data_parallel(cfg)
    device = resolve_device(device)
    datasets = datasets or load_datasets(cfg, device)
    plan = (spec.build_plan(cfg, datasets["train"], device) if spec.build_plan
            else make_plan(cfg, datasets["train"], device))

    tx = make_optimizer(cfg.lr, cfg.weight_decay, cfg.accum, cfg.optimizer,
                        state_dtype=cfg.opt_state_dtype)
    state = spec.init_state(tx)
    resume_step = 0
    if cfg.resume:
        state = restore_checkpoint(cfg.resume, state)
        resume_step = int(state.step)
        print(f"resumed from {cfg.resume} at step {resume_step}")
    dp = data_parallel()
    if dp is not None:
        dp.check_same_params(state.model)
    if cfg.max_steps and resume_step >= cfg.max_steps:
        # finished step-bounded run: resuming must be a pure no-op (no extra
        # step, no new checkpoint) — same semantics as the epoch-bounded case
        print(f"max_steps={cfg.max_steps} already reached at resume "
              f"(step {resume_step}); nothing to do")
        return {"state": state, "tr_losses": [], "val_losses": [], "samples_per_sec": 0.0}

    ctx = EngineCtx(cfg, datasets, device, spec.needs_timestamps, plan)
    fns = spec.make_fns(ctx)

    primary = ctx.primary
    os.makedirs(cfg.plotdir, exist_ok=True)
    metrics_path = cfg.metrics_path or os.path.join(cfg.plotdir, spec.metrics_filename)
    logger = MetricLogger(metrics_path if primary else None, use_wandb=cfg.wandb and primary,
                          wandb_config=vars(cfg) if spec.wandb_config else None)
    timer = StepTimer(cfg.profile_dir if primary else "", device)
    train_seed = cfg.seed + spec.rng_offset

    nb_epoch = ctx.steps_per_epoch
    ckpt_dir = os.path.join(cfg.checkpoints_dir, spec.name)
    tr_losses, val_losses = [], []
    global_step = resume_step
    stopped = False
    timer.start_trace()
    for epoch in range(1, cfg.num_epochs + 1):
        if global_step >= epoch * nb_epoch:
            continue  # epoch fully covered by the resumed checkpoint
        offset = global_step - (epoch - 1) * nb_epoch
        desc = f"{spec.desc} :: Epoch: {epoch}/{cfg.num_epochs}"
        running = []
        timer.reset()

        def after_step(metrics):
            """Shared per-step bookkeeping: logging, watch cadence, periodic
            checkpoints, max_steps stop. Returns True when the run must stop."""
            nonlocal global_step
            global_step += 1
            timer.tick(cfg.batch_size)
            running.append(metrics["train_loss"])
            if fns.on_train_metrics is not None:
                fns.on_train_metrics(metrics)
            if global_step % cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items() if not k.startswith("gradnorm/")}
                m["samples_per_sec"] = timer.rate()
                logger.log(m, step=global_step)
            if cfg.watch_every and global_step % cfg.watch_every == 0:
                # wandb.watch parity: per-layer grad norms + param histograms
                logger.log({k: float(v) for k, v in metrics.items()
                            if k.startswith("gradnorm/")}, step=global_step)
                logger.log_param_histograms(state.model, step=global_step)
            if cfg.checkpoint_every and global_step % cfg.checkpoint_every == 0:
                save_checkpoint(ckpt_dir, state)
            return bool(cfg.max_steps) and global_step >= cfg.max_steps

        items, total = ctx.train_items(epoch, offset)
        for item in progress(items, desc=desc, total=total):
            metrics = fns.train_call(state, item, train_seed)
            if after_step(metrics):
                stopped = True
                break
        items.close()
        epoch_tr = float(torch.stack(running).mean()) if running else float("nan")
        tr_losses.append(epoch_tr)
        if stopped:
            # max_steps interrupt: checkpoint the exact position and leave;
            # the next --resume run continues with the identical sequence
            save_checkpoint(ckpt_dir, state)
            break

        # ---- eval (stochastic, seeded; scheduled β when the experiment has one
        # so annealed runs log comparable train/val losses) ----
        vbatches = ctx.val_batches()
        beta = None
        vmean: Dict[str, float] = {}
        if fns.eval_call is not None:
            if fns.eval_beta_fn is not None:
                beta = fns.eval_beta_fn(global_step)
            vacc: Dict[str, list] = {}
            for bi in range(vbatches.shape[0]):
                m = fns.eval_call(state, ctx.val_item(vbatches[bi]),
                                  _seeded_generator(cfg.eval_seed, bi, device), beta)
                mf = {k: float(v) for k, v in m.items()}
                if fns.on_val_metrics is not None:
                    fns.on_val_metrics(mf)
                for k, v in mf.items():
                    vacc.setdefault(k, []).append(v)
            vmean = {k: float(np.mean(v)) for k, v in vacc.items()}
        if "val_loss" in vmean:
            val_losses.append(vmean["val_loss"])
        rec = {"epoch": epoch, "epoch_train_loss": epoch_tr, **vmean}
        if beta is not None:
            rec["val_beta"] = float(beta)
        logger.log(rec, step=global_step)

        # ---- optional ensemble CRPS in physical units ----
        if fns.crps_call is not None:
            acc: Dict[str, list] = {}
            nb_crps = _crps_batches(cfg, vbatches.shape[0])
            for bi in range(nb_crps):
                m = fns.crps_call(state, ctx.val_item(vbatches[bi]),
                                  _seeded_generator(cfg.eval_seed, 10_000 + bi, device))
                for k, v in m.items():
                    acc.setdefault(k, []).append(float(v))
            crps_metrics = {k: float(np.mean(v)) for k, v in acc.items()}
            crps_metrics["crps_batches_evaluated"] = nb_crps
            logger.log(crps_metrics, step=global_step)

        # ---- sample + plot every 2 epochs (reference main.py:125-134); the
        # sampler runs on every process, the primary draws ----
        if make_plots and fns.plot_fn is not None and epoch % 2 == 0:
            fns.plot_fn(state, epoch)

        save_checkpoint(ckpt_dir, state)   # rank 0 writes, every rank waits for it
    timer.stop_trace()

    result = {"state": state, "tr_losses": tr_losses, "val_losses": val_losses,
              "samples_per_sec": timer.rate()}
    if fns.final_fn is not None:
        result.update(fns.final_fn(state, logger, global_step) or {})
    if make_plots and primary and spec.loss_curve and tr_losses:
        from probunet_torch.viz.plots import plot_loss_curves
        plot_loss_curves(tr_losses, val_losses, os.path.join(cfg.plotdir, spec.loss_curve))
    logger.close()
    return result
