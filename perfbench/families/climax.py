"""The ClimaX family: ``train``, the fast deterministic training step of
probunet_torch (``train/steps.py::make_deterministic_train_step``) on
ClimaX (``models/climax.py``), with AdamW.

Call ``i`` takes batch ``i`` of the seeded day order and a generator
seeded from (seed, i), which the step's dropout and stochastic depth draw
from (in the order ``models/climax.py`` documents); the class labels the
step computes from timestamps are not read by ClimaX (all zeros here).

The days are ``inputs.climex_like`` fields at W x W cut to their first H
rows, (T, H, W, C): the shared feed makes square days only.

As in the Probabilistic U-Net family, set-up runs the first
``checked_steps`` calls and reads each step's loss, each leaf's first
gradient (from the optimizer's second moment) and each leaf's change after
the last; the reference (``perfbench/reference/climax.py``) repeats those
steps after the window in parts of ``reference_rows`` rows (8 at b64:
plain fp32 attention holds 8 x 16 x 2048^2 fp32 scores, 2.1 GB, a layer),
each part's loss its share of the batch mean.
"""

from __future__ import annotations

import torch

from perfbench import counts, inputs
from perfbench.families.probunet import Train as ProbUNetTrain
from perfbench.job import FEED_ROWS
from perfbench.reference import climax as ref
from perfbench.reference.unet import perpixel_stats


def program_config(cfg: dict, program: dict):
    from probunet_torch.config import Config

    keys = ("variables", "resolution", "lowres_scale", "standardization", "embed_dim", "depth",
            "num_heads", "patch_size", "decoder_depth", "mlp_ratio", "drop_path", "dropout",
            "lr", "weight_decay")
    kw = {k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k] for k in keys}
    return Config(ds_model="climax", **kw, **program)


class Train(ProbUNetTrain):
    def make_inputs(self) -> None:
        c, wl = self.cfg, self.wl
        h, w = c["resolution"]
        days = inputs.climex_like(self.seed, wl["days_per_year"], wl["years"], w, c["variables"],
                                  self.device)
        self.hr_all = days[:, :h].contiguous()
        del days
        self.stats = perpixel_stats(self.hr_all, c["lowres_scale"])
        self.rows = inputs.batch_rows(self.seed, self.hr_all.shape[0], wl["batch"], FEED_ROWS,
                                      self.device)
        self.timestamps = torch.zeros(wl["batch"], device=self.device)
        self.mark("inputs (and the CUDA context)")

    def build_program(self):
        from probunet_torch.train.loop import build_climax_model

        self.make_inputs()
        self.pcfg = program_config(self.cfg, self.wl["program"])
        model = build_climax_model(self.pcfg, device="meta").to_empty(device=self.device)
        model.load_state_dict(self.weights(model))
        self.dtype = getattr(torch, self.pcfg.compute_dtype)
        self.mark("program and weights")
        return model

    def reference(self) -> ref.ClimaX:
        with torch.device("meta"):
            model = ref.ClimaX(self.cfg)
        model = model.to_empty(device=self.device)
        model.load_state_dict(self.weights(model))
        return model

    def make_step(self, dp=None) -> None:
        from probunet_torch.train.state import create_train_state, make_optimizer
        from probunet_torch.train.steps import make_deterministic_train_step

        p = self.pcfg
        self.state = create_train_state(self.model, make_optimizer(
            p.lr, p.weight_decay, 1, "adamw", None, p.opt_state_dtype))
        self.step = make_deterministic_train_step(self.model, p.lowres_scale, p.standardization,
                                                  compute_dtype=self.dtype)
        self.losses = []

    def draws(self, i):
        """Call ``i``'s days and the generator its dropout draws from."""
        return self.feed(i)

    def call(self) -> None:
        i = self.k
        self.k += 1
        idx, gen = self.draws(i)
        m = self.step(self.state, self.hr_all, self.stats, idx, self.timestamps, gen)
        if i < self.wl["checked_steps"]:
            self.losses.append(m["train_loss"])

    def reference_readings(self, model, fault=None):
        feeds = [self.draws(i) for i in range(self.wl["checked_steps"])]
        return ref.train_readings(model, self.hr_all, self.stats, feeds, self.cfg["lr"],
                                  self.cfg["weight_decay"], self.cfg["lowres_scale"], fault,
                                  chunk=self.wl.get("reference_rows"))

    def counts(self):
        b = self.wl["batch"]
        (h, w), c = self.cfg["resolution"], len(self.cfg["variables"])
        with torch.device("meta"):
            model = ref.ClimaX(self.cfg)
            x, y = torch.empty(b, h, w, c), torch.empty(b, h, w, c)
        model.train()

        def run():
            (model(x) - y).square().mean().backward()

        return counts.count(model, run, self.itemsize(), backward=True)


def make_job(cell, seed, device):
    # a program without ClimaX fails here, before the kernel library is built
    from probunet_torch.train.loop import build_climax_model  # noqa: F401

    return {"train": Train}[cell.workload["job"]](cell, seed, device)
