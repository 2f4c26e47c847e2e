"""What every family's job shares: the inputs made from the seed, the
kernel library's load, the choice of the answers to check, and the counts.

A job drives the program under test one call at a time (``call``), and
afterwards (``check``) runs the plain reference on the same inputs and
returns the numbers compared, each with its limit from the cell's file.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import compare, inputs
from perfbench.reference.unet import perpixel_stats, set_precision


#: batches of day indices drawn ahead (a call past them takes them again, in order)
FEED_ROWS = 4096


class Job:
    #: work done by one call (samples or members), set by each job
    units_per_call = 1
    #: peak device bytes of the other ranks of a cell on several cards, known after ``free``
    rank_peaks: Tuple[int, ...] = ()

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg, self.wl = cell.config, cell.workload
        self.k = 0            # calls made so far
        self.kept: Dict[int, torch.Tensor] = {}
        self.chosen: set = set()
        self.marks: List[Tuple[str, float]] = []   # set-up's stages, for the log

    def mark(self, stage: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.marks.append((stage, time.perf_counter()))

    # ---- inputs ------------------------------------------------------------------------
    def make_inputs(self) -> None:
        c, wl = self.cfg, self.wl
        self.hr_all = inputs.climex_like(self.seed, wl["days_per_year"], wl["years"],
                                         c["resolution"][0], c["variables"], self.device)
        self.stats = perpixel_stats(self.hr_all, c["lowres_scale"])
        self.rows = inputs.batch_rows(self.seed, self.hr_all.shape[0], wl["batch"],
                                      FEED_ROWS, self.device)
        self.mark("inputs (and the CUDA context)")

    def weights(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """The seed's weights for ``model``'s ``state_dict`` names and shapes."""
        shapes = [(n, tuple(p.shape)) for n, p in model.state_dict().items()]
        return inputs.make_weights(shapes, self.seed, self.device)

    def feed(self, i: int) -> Tuple[torch.Tensor, torch.Generator]:
        """Call ``i``'s day indices and generator."""
        return self.rows[i % len(self.rows)], inputs.call_generator(self.seed, i, self.device)

    # ---- the program ---------------------------------------------------------------------
    def build_kernels(self) -> None:
        """Loads the program's kernel library (built on first use)."""
        if self.device.type == "cuda":
            from probunet_torch.ops import _build

            _build.lib()

    def plan_checks(self, n: int) -> None:
        """Chooses from the seed which of the next ``n`` calls' answers are
        kept for the check (``check_calls`` of them)."""
        rng = np.random.default_rng(inputs.subseed(self.seed, 5))
        m = min(self.wl.get("check_calls", 0), n)
        self.chosen = {self.k + int(j) for j in rng.choice(n, size=m, replace=False)}

    def limits(self, values: Dict[str, float]) -> List[Tuple[str, float, float]]:
        lim = self.wl["limits"]
        return [(k, float(values[k]), float(lim[k])) for k in lim]

    def itemsize(self) -> int:
        return 2 if self.wl.get("program", {}).get("compute_dtype") == "bfloat16" else 4

    def free(self) -> None:
        """Drops the program's state before the reference runs."""
        for name in ("state", "model", "fn", "step"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


class SampleJob(Job):
    """A sampler: ``units_per_call`` members per call; the answers of the
    chosen calls are kept and recomputed by the reference. A subclass gives
    ``draws(i)`` (the day indices and the call's random draws),
    ``run_program(idx, draws)`` (the answer, (B, K, H, W, C) physical
    fields), ``reference()`` and ``reference_sample(model, idx, draws)``."""

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.units_per_call = self.wl["batch"] * self.wl["members"]
        self._ref = None

    def call(self) -> None:
        i = self.k
        self.k += 1
        hr_preds = self.run_program(*self.draws(i))
        if i in self.chosen:
            self.kept[i] = hr_preds

    def reference_residual(self, i: int, precision: str = "fp32") -> dict:
        """The reference's {"residual", "pair"} for call ``i``'s inputs."""
        if self._ref is None:
            self._ref = self.reference()
        return self.reference_sample(set_precision(self._ref, precision), *self.draws(i))

    def check(self):
        gap = math.inf if not self.kept else 0.0
        for i, got in sorted(self.kept.items()):
            want = self.reference_residual(i)
            pair = want["pair"]
            residual = (got - pair["lrinterp"][:, None]) / pair["denom"]
            gap = max(gap, compare.residual_gap(residual, want["residual"]))
        return self.limits({"residual_gap": gap})
