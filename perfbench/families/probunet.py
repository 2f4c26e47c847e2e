"""The Probabilistic U-Net family: ``train`` (the ELBO training step with
AdamW, ``train/steps.py::make_probunet_train_step``), ``train_dp`` (the same
step on one rank per card, through the program's data-parallel path) and
``sample`` (the K-member prior sampler, ``make_sample_fn``) of
probunet_torch.

Call ``i`` takes batch ``i`` of the seeded day order and a generator
seeded from (seed, i): the benchmark draws the posterior noise (training,
(B, D)) or the prior draws (sampling, (K, B, D)) from it, and training's
dropout masks are drawn from it by the step itself.

Training: set-up runs the first ``checked_steps`` calls as the window
runs them, on the same object, and reads each step's loss, the first
gradient of each leaf from the optimizer's second moment after one step
(v = (1 - beta2) g^2) and each leaf's parameter change after the last;
the reference repeats those steps after the window. Data-parallel
training (``train_dp``, ``perfbench/ranks.py``): each of the cell's
``chips`` ranks takes its ``batch`` rows of each global batch of
``batch * chips``, its rows of the global posterior noise (``dp.randn``) and
of the dropout masks (``shard=(rank, world)``); the gradients are summed
over the ranks, so rank 0's readings are of the global step, and the
reference repeats it at the global batch, ``batch`` rows at a time (the
ELBO sums over the batch: the parts' gradients add). Sampling: the
answers of ``check_calls`` calls drawn from the seed are kept and the
reference recomputes them after the window.
"""

from __future__ import annotations

import math

import torch

from perfbench import compare, counts, inputs, ranks
from perfbench.job import FEED_ROWS, Job, SampleJob
from perfbench.reference import probunet as ref


def program_config(cfg: dict, program: dict):
    from probunet_torch.config import Config

    keys = ("variables", "latent_dim", "num_filters", "model_channels", "channel_mult",
            "num_blocks", "attn_resolutions", "dropout", "lowres_scale", "standardization",
            "lr", "weight_decay", "beta", "resolution")
    kw = {k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k] for k in keys}
    return Config(**kw, **program)


class _ProbUNetJob(Job):
    def build_program(self):
        from probunet_torch.train.loop import build_probunet

        self.make_inputs()
        self.pcfg = program_config(self.cfg, self.wl["program"])
        model = build_probunet(self.pcfg, device="meta").to_empty(device=self.device)
        model.load_state_dict(self.weights(model))
        self.dtype = getattr(torch, self.pcfg.compute_dtype)
        self.mark("program and weights")
        return model

    def reference(self) -> ref.ProbUNet:
        with torch.device("meta"):
            model = ref.ProbUNet(self.cfg)
        model = model.to_empty(device=self.device)
        model.load_state_dict(self.weights(model))
        return model


class Train(_ProbUNetJob):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.units_per_call = self.wl["batch"]

    def setup(self) -> None:
        self.model = self.build_program()
        self.make_step()
        self.run_checked_steps()

    def make_step(self, dp=None) -> None:
        """The training state and step (``dp``: the program's ``DataParallel``)."""
        from probunet_torch.train.state import create_train_state, make_optimizer
        from probunet_torch.train.steps import make_probunet_train_step

        p = self.pcfg
        self.state = create_train_state(self.model, make_optimizer(
            p.lr, p.weight_decay, 1, "adamw", None, p.opt_state_dtype))
        self.step = make_probunet_train_step(self.model, p.lowres_scale, p.standardization,
                                             compute_dtype=self.dtype, dp=dp)
        self.losses = []

    def run_checked_steps(self) -> None:
        """The first ``checked_steps`` calls, read for the check, then the warm-up."""
        n = self.wl["checked_steps"]
        for i in range(n):
            self.call()
            if i == 0:
                self.grad_norms = self.first_gradient_norms()
        self.got = {"losses": [float(x) for x in self.losses], "grad_norms": self.grad_norms,
                    "change_rows": self.change_since_start()}
        self.mark("checked steps")
        for _ in range(self.wl["warmup_calls"]):
            self.call()
        self.mark("warm-up")

    def draws(self, i):
        """Call ``i``'s days, posterior noise and the generator its dropout draws from."""
        idx, gen = self.feed(i)
        eps = torch.randn((len(idx), self.cfg["latent_dim"]), generator=gen, device=self.device)
        return idx, eps, gen

    def call(self) -> None:
        i = self.k
        self.k += 1
        idx, eps, gen = self.draws(i)
        m = self.step(self.state, self.hr_all, self.stats, idx, gen, eps=eps)
        if i < self.wl["checked_steps"]:
            self.losses.append(m["train_loss"])

    def first_gradient_norms(self):
        """Each leaf's gradient norm as the optimizer got it, from its second
        moment after one step: ||g|| = sqrt(sum(v) / (1 - beta2))."""
        inner = self.state.optimizer.inner
        b2 = inner.param_groups[0]["betas"][1]
        out = {}
        for name, p in self.model.named_parameters():
            st = inner.state.get(p, {})
            v = st.get("exp_avg_sq", st.get("nu"))   # none: the optimizer got no gradient
            out[name] = 0.0 if v is None else math.sqrt(float(v.double().sum()) / (1 - b2))
        return out

    def change_since_start(self):
        """Row norms of each leaf's change since the weights the run began with."""
        start = self.weights(self.model)
        return {n: compare.row_norms(p.detach() - start[n])
                for n, p in self.model.named_parameters()}

    def reference_readings(self, model, fault=None):
        """The reference's readings of the checked steps, on their draws made afresh."""
        feeds = [self.draws(i) for i in range(self.wl["checked_steps"])]
        return ref.train_readings(model, self.hr_all, self.stats, feeds,
                                  self.cfg["lr"], self.cfg["weight_decay"],
                                  self.cfg["lowres_scale"], fault)

    def check(self):
        self.readings = compare.training_gaps(self.got, self.reference_readings(self.reference()))
        return self.limits(self.readings)

    def counts(self):
        b, r, c = self.wl["batch"], self.cfg["resolution"][0], len(self.cfg["variables"])
        with torch.device("meta"):
            model = ref.ProbUNet(self.cfg)
            x, y = torch.empty(b, r, r, c), torch.empty(b, r, r, c)
            eps = torch.empty(b, self.cfg["latent_dim"])
        model.train()

        def run():
            model.elbo(x, y, eps)[0].backward()

        return counts.count(model, run, self.itemsize(), backward=True)


class Sample(SampleJob, _ProbUNetJob):
    def setup(self) -> None:
        from probunet_torch.train.steps import make_sample_fn

        self.model = self.build_program()
        p = self.pcfg
        self.fn = make_sample_fn(self.model, p.lowres_scale, p.standardization,
                                 self.wl["members"], self.dtype)
        for _ in range(self.wl["warmup_calls"]):
            self.call()
        self.mark("warm-up")

    def draws(self, i):
        idx, gen = self.feed(i)
        eps = torch.randn((self.wl["members"], len(idx), self.cfg["latent_dim"]),
                          generator=gen, device=self.device)
        return idx, eps

    def run_program(self, idx, eps):
        return self.fn(self.hr_all, self.stats, idx, eps=eps)[0]

    def reference_sample(self, model, idx, eps):
        return ref.sample_residuals(model, self.hr_all, self.stats, idx, eps,
                                    self.cfg["lowres_scale"])

    def counts(self):
        b, r, c = self.wl["batch"], self.cfg["resolution"][0], len(self.cfg["variables"])
        with torch.device("meta"):
            model = ref.ProbUNet(self.cfg)
            x = torch.empty(b, r, r, c)
            eps = torch.empty(self.wl["members"], b, self.cfg["latent_dim"])
        model.eval()

        def run():
            with torch.no_grad():
                model.sample(x, eps)

        return counts.count(model, run, self.itemsize(), backward=False)


class TrainDP(Train):
    """``Train`` on ``cell.chips`` ranks, this one ``rank``; rank 0 starts
    and drives the others (``perfbench/ranks.py``)."""

    def __init__(self, cell, seed, device, rank=0):
        super().__init__(cell, seed, device)
        self.rank, self.world = rank, cell.chips
        self.global_batch = self.wl["batch"] * self.world
        self.units_per_call = self.global_batch
        self.ranks = None

    def make_inputs(self) -> None:
        super().make_inputs()
        self.rows = inputs.batch_rows(self.seed, self.hr_all.shape[0], self.global_batch,
                                      FEED_ROWS, self.device)

    def setup(self) -> None:
        env = None
        if self.rank == 0:
            self.ranks = ranks.Ranks(self.cell, self.seed, self.device)
            env = self.ranks.env(0)
            self.mark("ranks started")
        self.model = self.build_program()
        if self.ranks:
            self.ranks.beat()
        self.dp = ranks.join_group(self.device, env)
        self.dp.check_same_params(self.model)
        self.mark("process group")
        self.make_step(self.dp)
        if self.rank == 0:   # the other ranks make the calls rank 0 tells them
            self.run_checked_steps()

    def draws(self, i):
        """Call ``i``: this rank's days, its rows of the global posterior
        noise, and the generator its rows of the dropout masks come from."""
        rows, gen = self.feed(i)
        b = self.wl["batch"]
        eps = self.dp.randn((b, self.cfg["latent_dim"]), gen, self.device)
        return rows[self.rank * b:(self.rank + 1) * b], eps, gen

    def global_draws(self, i):
        """Call ``i``'s global batch: days, posterior noise and generator."""
        rows, gen = self.feed(i)
        eps = torch.randn((len(rows), self.cfg["latent_dim"]), generator=gen, device=self.device)
        return rows, eps, gen

    def call(self) -> None:
        if self.ranks:
            self.ranks.tell()
        super().call()

    def free(self) -> None:
        """Stops the other ranks (their peaks kept), leaves the group and
        waits for the other ranks to end."""
        if self.ranks:
            self.rank_peaks = [a["peak_bytes"] for a in self.ranks.stop()]
        ranks.leave_group()
        if self.ranks:
            self.ranks.join()
            self.ranks = None
        self.__dict__.pop("dp", None)
        super().free()

    def reference_readings(self, model, fault=None):
        feeds = [self.global_draws(i) for i in range(self.wl["checked_steps"])]
        return ref.train_readings(model, self.hr_all, self.stats, feeds,
                                  self.cfg["lr"], self.cfg["weight_decay"],
                                  self.cfg["lowres_scale"], fault, chunk=self.wl["batch"])


def make_job(cell, seed, device, rank=0):
    """The cell's job; ``rank``: which rank of a ``train_dp`` cell this process is."""
    if cell.workload["job"] == "train_dp":
        return TrainDP(cell, seed, device, rank)
    return {"train": Train, "sample": Sample}[cell.workload["job"]](cell, seed, device)
