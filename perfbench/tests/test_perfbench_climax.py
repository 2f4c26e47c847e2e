"""The ClimaX cell end to end on the CPU at a tiny size, past the harness's
look for a card: a sound run comes out correct, and a run with the timed
path broken underneath comes out not correct, once for each fault it can
have:

- a step that returns its state unchanged (the optimizer does not update);
- half of the batch left out (the first half's predictions given for all);
- the dropout and stochastic depth left out (the model run in eval mode);
- the variable aggregation's softmax left out (the V tokens averaged).

The control (the reference with fp8 products) and the half-batch fault of
the reference fail too; the traced path runs; one call's counts hold the
blocks' attention sites, forward and backward.
"""

import math
import time

import pytest
import torch

from perfbench import control, harness

NAME = "climax_128x256.train_fast_b64"
TINY = {"config": {"resolution": [16, 32], "embed_dim": 64, "depth": 2, "num_heads": 4},
        "workload": {"days_per_year": 20, "years": 2, "batch": 4, "reference_rows": 2}}
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
    assert set(out["metrics"]) == {"setup_s", "train_samples_per_s", "step_ms_p90",
                                   "peak_mem_gib"}
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())


def _state_unchanged(monkeypatch):
    from probunet_torch.train.state import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self: False)


def _half_batch(monkeypatch):
    from probunet_torch.models.climax import ClimaX

    orig = ClimaX.forward

    def forward(self, x, class_labels=None, generator=None, shard=(0, 1)):
        h = x.shape[0] // 2
        out = orig(self, x[:h], class_labels, generator, shard)
        return torch.cat([out, out])[:x.shape[0]]

    monkeypatch.setattr(ClimaX, "forward", forward)


def _no_dropout(monkeypatch):
    from probunet_torch.models import climax

    monkeypatch.setattr(climax, "token_dropout", lambda x, *a, **kw: x)
    monkeypatch.setattr(climax, "drop_path", lambda x, *a, **kw: x)
    monkeypatch.setattr(climax.Mlp, "forward",
                        lambda self, x, *a: self.fc2(torch.nn.functional.gelu(self.fc1(x))))


def _mean_over_variables(monkeypatch):
    from probunet_torch.models.climax import VariableAggregation

    def forward(self, query, tokens):
        d = tokens.shape[-1]
        w, b = self.in_proj_weight.to(tokens.dtype), self.in_proj_bias.to(tokens.dtype)
        v = torch.nn.functional.linear(tokens, w[2 * d:], b[2 * d:])
        return self.out_proj(v.mean(0))

    monkeypatch.setattr(VariableAggregation, "forward", forward)


FAULTS = [_state_unchanged, _half_batch, _no_dropout, _mean_over_variables]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run()
    assert not out["correct"], out["checks"]


def test_the_control_fails():
    cell = harness.Cell(NAME, overrides=TINY)
    limits = cell.workload["limits"]
    readings = control.control_readings(cell, SEED, torch.device("cpu"))
    assert set(readings) == {"control", "half_batch"}
    for variant in readings:
        assert any(v > limits[k] for k, v in readings[variant].items() if k in limits), readings


def test_the_traced_path_runs_on_the_cpu(monkeypatch):
    """A ``--trace 1`` run on the CPU (no kernels: the device readers find
    nothing; the wall-clock ones, the spans and the breakdown still read)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    cell = harness.Cell(NAME, overrides=TINY)
    out = harness.run(cell, SEED, 0.3, True, "cpu", time.perf_counter(), log=lambda m: None)
    plan = cell.workload["trace"]
    assert out["correct"] and out["attempted"] == plan["traces"] * plan["calls"]
    assert 0 < out["metrics"]["mfu.train"]["value"] < 100
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_counts_hold_the_blocks_attention():
    """One call's counts: each block's self-attention site forward and
    backward at (B, L, heads, c) = (4, 32, 4, 16) here, (64, 2048, 16, 64)
    in the cell; no convolution-sized GroupNorm site."""
    cell = harness.Cell(NAME, overrides=TINY)
    job = cell.family().make_job(cell, SEED, torch.device("cpu"))
    c = job.counts()
    assert [s["pass"] for s in c["attn"]] == ["fwd", "bwd"] * 2
    assert [s["flops"] for s in c["attn"]] == [4.0 * 4 * 4 * 32 ** 2 * 16,
                                               8.0 * 4 * 4 * 32 ** 2 * 16] * 2
    assert c["gn"] == [] and c["flops"] > 0
