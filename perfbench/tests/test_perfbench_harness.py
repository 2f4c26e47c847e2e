"""The harness end to end on the CPU at a tiny size, past its look for a
card: sound runs come out correct, and a run with the timed path broken
underneath comes out not correct, once for each fault the cell can have:

- a step that returns its state unchanged (training: the optimizer does
  not update; EDM: each Heun step leaves x as it was);
- half of the batch left out (training: the loss of the first half,
  doubled; sampling: the first half's answers given for the whole batch);
- an answer altered where it is produced (one member of one input).

The control (the reference computed one precision below the cell's, in
the program's place) fails a number of each cell too.
"""

import math
import time

import pytest
import torch

from perfbench import control, harness

TINY = {"config": {"resolution": [16, 16], "model_channels": 32, "channel_mult": [1, 2],
                   "attn_resolutions": [8], "num_blocks": 1, "num_filters": [8, 16],
                   "latent_dim": 4, "edm_steps": 4},
        "workload": {"days_per_year": 20, "years": 2, "check_range": 3}}
TRAIN = ["probunet_mc128.train_strict_b8", "probunet_mc128.train_fast_b8"]
SAMPLE = ["probunet_mc128.serve_fast_k16"]
EDM = ["edm_mc128.serve_b2_k4"]
SEED = 2 ** 31 + 11


def run(name, seed=SEED):
    torch.manual_seed(0)
    cell = harness.Cell(name, overrides=TINY)
    return harness.run(cell, seed, 0.3, False, "cpu", time.perf_counter(), log=lambda m: None)


@pytest.mark.parametrize("name", TRAIN + SAMPLE + EDM)
def test_a_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    for m in out["metrics"].values():
        assert math.isfinite(m["value"])


def _elbo_half(monkeypatch):
    from probunet_torch.models.prob_unet import ProbabilisticUNet

    orig = ProbabilisticUNet.elbo

    def elbo(self, x, target, beta=None, generator=None, eps=None, shard=(0, 1)):
        h = x.shape[0] // 2
        t, r, k = orig(self, x[:h], target[:h], beta, generator,
                       None if eps is None else eps[:h], shard)
        return 2 * t, 2 * r, 2 * k

    monkeypatch.setattr(ProbabilisticUNet, "elbo", elbo)


def _sample_half(monkeypatch):
    from probunet_torch.models.prob_unet import ProbabilisticUNet

    orig = ProbabilisticUNet.sample

    def sample(self, x, num_samples, generator=None, eps=None):
        h = x.shape[0] // 2
        out = orig(self, x[:h], num_samples, generator, None if eps is None else eps[:, :h])
        return torch.cat([out, out])[:x.shape[0]]

    monkeypatch.setattr(ProbabilisticUNet, "sample", sample)


def _sample_altered(monkeypatch):
    from probunet_torch.models.prob_unet import ProbabilisticUNet

    orig = ProbabilisticUNet.sample

    def sample(self, *args, **kw):
        out = orig(self, *args, **kw).clone()
        out[0, 0] += 1.0
        return out

    monkeypatch.setattr(ProbabilisticUNet, "sample", sample)


def _state_unchanged(monkeypatch):
    from probunet_torch.train.state import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self: False)


def _edm_unchanged(monkeypatch):
    from probunet_torch.models.edm import EDMPrecond

    monkeypatch.setattr(EDMPrecond, "forward", lambda self, x, *a, **kw: x.float())


def _edm_half(monkeypatch):
    from probunet_torch.models.edm import EDMPrecond

    orig = EDMPrecond.forward

    def forward(self, x, sigma, condition_img=None, *a, **kw):
        h = x.shape[0] // 2
        out = orig(self, x[:h], sigma[:h], condition_img[:h], *a, **kw)
        return torch.cat([out, out])[:x.shape[0]]

    monkeypatch.setattr(EDMPrecond, "forward", forward)


def _edm_altered(monkeypatch):
    from probunet_torch.train import steps

    orig = steps.edm_heun_chain

    def chain(*args, **kw):
        out = orig(*args, **kw).clone()
        out[0] += 1.0
        return out

    monkeypatch.setattr(steps, "edm_heun_chain", chain)


FAULTS = ([(n, f) for n in TRAIN for f in (_state_unchanged, _elbo_half)]
          + [(n, f) for n in SAMPLE for f in (_sample_half, _sample_altered)]
          + [(n, f) for n in EDM for f in (_edm_unchanged, _edm_half, _edm_altered)])


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    out = run(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", TRAIN + SAMPLE + EDM)
def test_the_control_fails(name):
    cell = harness.Cell(name, overrides=TINY)
    limits = cell.workload["limits"]
    readings = control.control_readings(cell, SEED, torch.device("cpu"))
    for variant in readings:   # the control, and in training the half-batch fault
        assert any(v > limits[k] for k, v in readings[variant].items() if k in limits), readings


@pytest.mark.parametrize("name", [TRAIN[1], EDM[0]])
def test_the_traced_path_runs_on_the_cpu(monkeypatch, name):
    """A ``--trace 1`` run on the CPU (no kernels: the device readers find
    nothing; the wall-clock ones and the breakdown still read)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    cell = harness.Cell(name, overrides=TINY)
    out = harness.run(cell, SEED, 0.3, True, "cpu", time.perf_counter(), log=lambda m: None)
    plan = cell.workload["trace"]
    assert out["correct"] and out["attempted"] == plan["traces"] * plan["calls"]
    kind = name.split(".")[1].split("_")[0]
    assert 0 < out["metrics"][f"mfu.{'train' if kind == 'train' else 'serve'}"]["value"] < 100
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
