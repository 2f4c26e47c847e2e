"""The CorrDiff cell end to end on the CPU at a tiny size, past the
harness's look for a card: a sound run comes out correct, and a run with
the timed path broken underneath comes out not correct, once for each fault
it can have:

- each Heun step leaves the residual as it was (the denoiser returns its
  input);
- the regression's mean left out (mu = 0);
- half of the members left out (the first half's chains given for all);
- an answer altered where it is produced (one member).

The control (the reference in TF32, in the program's place) fails too; the
traced path runs; one call's counts hold the regression and the chain.
"""

import math
import time

import pytest
import torch

from perfbench import control, harness

NAME = "corrdiff_cwb448.serve_b1_k2"
TINY = {"config": {"resolution": [32, 32], "model_channels": 32, "channel_mult": [1, 2, 2],
                   "attn_resolutions": [8], "num_blocks": 1, "edm_steps": 3},
        # the checked call is the window's first, so a loaded CPU's short window has it
        "workload": {"days_per_year": 20, "years": 2, "check_range": 1}}
SEED = 2 ** 31 + 11


def run(seconds=0.3):
    torch.manual_seed(0)
    cell = harness.Cell(NAME, overrides=TINY)
    return harness.run(cell, SEED, seconds, False, "cpu", time.perf_counter(),
                       log=lambda m: None)


def test_a_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "serve_members_per_s", "peak_mem_gib"}
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())


def _chain_unchanged(monkeypatch):
    from probunet_torch.models.corrdiff import CorrDiff

    monkeypatch.setattr(CorrDiff, "forward", lambda self, r, *a, **kw: r.float())


def _no_regression(monkeypatch):
    from probunet_torch.models.corrdiff import CorrDiff

    monkeypatch.setattr(CorrDiff, "regression",
                        lambda self, x: torch.zeros_like(x[..., :self.out_channels]).float())


def _half_members(monkeypatch):
    from probunet_torch.models.corrdiff import CorrDiff

    orig = CorrDiff.forward

    def forward(self, r, sigma, condition_img):
        h = r.shape[0] // 2
        out = orig(self, r[:h], sigma[:h], condition_img[:h])
        return torch.cat([out, out])[:r.shape[0]]

    monkeypatch.setattr(CorrDiff, "forward", forward)


def _altered(monkeypatch):
    from probunet_torch.train import steps

    orig = steps.edm_heun_chain

    def chain(*args, **kw):
        out = orig(*args, **kw).clone()
        out[0] += 1.0
        return out

    monkeypatch.setattr(steps, "edm_heun_chain", chain)


FAULTS = [_chain_unchanged, _no_regression, _half_members, _altered]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run()
    assert not out["correct"], out["checks"]


def test_the_control_fails():
    cell = harness.Cell(NAME, overrides=TINY)
    limit = cell.workload["limits"]["residual_gap"]
    readings = control.control_readings(cell, SEED, torch.device("cpu"))
    assert readings["control"]["residual_gap"] > limit, readings


def test_the_traced_path_runs_on_the_cpu(monkeypatch):
    """A ``--trace 1`` run on the CPU (no kernels: the device readers find
    nothing; the wall-clock ones and the breakdown still read)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    cell = harness.Cell(NAME, overrides=TINY)
    out = harness.run(cell, SEED, 0.3, True, "cpu", time.perf_counter(), log=lambda m: None)
    plan = cell.workload["trace"]
    assert out["correct"] and out["attempted"] == plan["traces"] * plan["calls"]
    assert 0 < out["metrics"]["mfu.serve"]["value"] < 100
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_counts_hold_the_regression_and_the_chain():
    """One call's counts: the regression pass over B rows, then 2 S - 1
    residual passes over K B rows; six attention sites a pass at 448x448
    (one of 256 channels each), here three (the 8x8 level's encoder block,
    in0 and the level's last decoder block, one head of 64 each)."""
    cell = harness.Cell(NAME, overrides=TINY)
    job = cell.family().make_job(cell, SEED, torch.device("cpu"))
    c = job.counts()
    passes = 2 * TINY["config"]["edm_steps"] - 1
    assert len(c["attn"]) == 3 * (1 + passes)
    rows = [s["flops"] / (4.0 * 64 * 64 * 64) for s in c["attn"]]
    assert rows == [1.0] * 3 + [2.0] * (3 * passes)
    assert c["flops"] > 0 and len(c["gn"]) % (1 + passes) == 0
