"""The CorrDiff family: ``sample``, the two-stage sampler of probunet_torch
(``train/steps.py::make_corrdiff_sample_fn``): the regression U-Net's mean
once per input, then K residual Heun chains folded K-major into one batch.

Call ``i`` takes batch ``i`` of the seeded day order and draws the chains'
initial standard normals (K * B, H, W, C) from a generator seeded from
(seed, i), as the EDM family does. The answers of ``check_calls`` calls
drawn from the seed are kept and the reference recomputes them after the
window.
"""

from __future__ import annotations

import torch

from perfbench import counts
from perfbench.families.edm import Sample as EDMSample
from perfbench.reference import corrdiff as ref


def program_config(cfg: dict, program: dict):
    from probunet_torch.config import Config

    keys = ("variables", "model_channels", "channel_mult", "num_blocks", "attn_resolutions",
            "dropout", "lowres_scale", "standardization", "resolution", "edm_steps")
    kw = {k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k] for k in keys}
    return Config(ds_model="corrdiff", **kw, **program)


class Sample(EDMSample):
    def setup(self) -> None:
        from probunet_torch.train.loop import build_corrdiff_model
        from probunet_torch.train.steps import make_corrdiff_sample_fn

        self.make_inputs()
        p = program_config(self.cfg, self.wl["program"])
        self.model = build_corrdiff_model(p, device="meta").to_empty(device=self.device)
        if self.model.sigma_data != self.cfg["sigma_data"]:
            raise ValueError(f"the program's sigma_data is {self.model.sigma_data}, the "
                             f"configuration's {self.cfg['sigma_data']}")
        self.model.load_state_dict(self.weights(self.model))
        self.mark("program and weights")
        c = self.cfg
        self.fn = make_corrdiff_sample_fn(self.model, p.lowres_scale, p.standardization,
                                          self.wl["members"], c["edm_steps"], c["sigma_min"],
                                          c["sigma_max"], c["rho"], getattr(torch, p.compute_dtype))
        for _ in range(self.wl["warmup_calls"]):
            self.call()
        self.mark("warm-up")

    def reference(self):
        with torch.device("meta"):
            model = ref.CorrDiff(self.cfg)
        model = model.to_empty(device=self.device)
        model.load_state_dict(self.weights(model))
        return model

    def reference_sample(self, model, idx, noise):
        return ref.sample_residuals(model, self.hr_all, self.stats, idx, noise, self.cfg)

    def counts(self):
        """One call: a regression pass over B rows, then 2 S - 1 residual
        denoiser passes over K * B rows."""
        b = self.wl["batch"]
        rows = b * self.wl["members"]
        r, c = self.cfg["resolution"][0], len(self.cfg["variables"])
        with torch.device("meta"):
            model = ref.CorrDiff(self.cfg)
            x = torch.empty(b, r, r, c)
            noisy, cond = torch.empty(rows, r, r, c), torch.empty(rows, r, r, c)
            sigma = torch.ones(rows)
        model.eval()

        def count(fn):
            def run():
                with torch.no_grad():
                    fn()

            return counts.count(model, run, self.itemsize(), backward=False)

        reg = count(lambda: model.regression(x))
        one = count(lambda: model(noisy, sigma, cond))
        passes = 2 * self.cfg["edm_steps"] - 1
        return {"flops": reg["flops"] + one["flops"] * passes,
                **{k: reg[k] + one[k] * passes for k in ("conv", "attn", "gn")}}


def make_job(cell, seed, device):
    # a program without CorrDiff fails here, before the kernel library is built
    from probunet_torch.train.loop import build_corrdiff_model  # noqa: F401

    return {"sample": Sample}[cell.workload["job"]](cell, seed, device)
