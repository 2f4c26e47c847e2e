"""The EDM family: ``sample``, K Heun chains per input folded K-major into
one batch (``train/steps.py::make_edm_sample_fn``) of probunet_torch.

Call ``i`` takes batch ``i`` of the seeded day order and draws the chains'
initial standard normals (K * B, H, W, C) from a generator seeded from
(seed, i). The answers of ``check_calls`` calls drawn from the seed are
kept and the reference recomputes them after the window.
"""

from __future__ import annotations

import torch

from perfbench import counts
from perfbench.families.probunet import program_config
from perfbench.job import SampleJob
from perfbench.reference import edm as ref


class Sample(SampleJob):
    def setup(self) -> None:
        from probunet_torch.train.loop import build_edm_model
        from probunet_torch.train.steps import make_edm_sample_fn

        self.make_inputs()
        p = program_config(self.cfg, self.wl["program"])
        self.model = build_edm_model(p, device="meta").to_empty(device=self.device)
        if self.model.sigma_data != self.cfg["sigma_data"]:
            raise ValueError(f"the program's sigma_data is {self.model.sigma_data}, the "
                             f"configuration's {self.cfg['sigma_data']}")
        self.model.load_state_dict(self.weights(self.model))
        self.mark("program and weights")
        c = self.cfg
        self.fn = make_edm_sample_fn(self.model, p.lowres_scale, p.standardization,
                                     self.wl["members"], c["edm_steps"], c["sigma_min"],
                                     c["sigma_max"], c["rho"], getattr(torch, p.compute_dtype))
        for _ in range(self.wl["warmup_calls"]):
            self.call()
        self.mark("warm-up")

    def draws(self, i):
        idx, gen = self.feed(i)
        r, c = self.cfg["resolution"][0], len(self.cfg["variables"])
        noise = torch.randn((self.wl["members"] * len(idx), r, r, c), generator=gen,
                            device=self.device)
        return idx, noise

    def run_program(self, idx, noise):
        return self.fn(self.hr_all, self.stats, idx, noise=noise)[0]

    def reference(self):
        with torch.device("meta"):
            model = ref.EDMPrecond(self.cfg)
        model = model.to_empty(device=self.device)
        model.load_state_dict(self.weights(model))
        return model

    def reference_sample(self, model, idx, noise):
        return ref.sample_residuals(model, self.hr_all, self.stats, idx, noise, self.cfg)

    def counts(self):
        """One batch: 2 S - 1 denoiser passes over K * B rows."""
        rows = self.wl["batch"] * self.wl["members"]
        r, c = self.cfg["resolution"][0], len(self.cfg["variables"])
        with torch.device("meta"):
            model = ref.EDMPrecond(self.cfg)
            x, cond = torch.empty(rows, r, r, c), torch.empty(rows, r, r, c)
            sigma = torch.ones(rows)
        model.eval()

        def run():
            with torch.no_grad():
                model(x, sigma, cond)

        one = counts.count(model, run, self.itemsize(), backward=False)
        passes = 2 * self.cfg["edm_steps"] - 1
        return {"flops": one["flops"] * passes,
                **{k: one[k] * passes for k in ("conv", "attn", "gn")}}


def make_job(cell, seed, device):
    return {"sample": Sample}[cell.workload["job"]](cell, seed, device)
