"""The FourCastNet cell end to end on the CPU at a tiny size, past the
harness's look for a card: a sound run comes out correct, and a run with the
timed path broken underneath comes out not correct, once for each fault it
can have:

- a step that returns its state unchanged (the optimizer does not update);
- half of the batch left out (the first half's predictions given for all);
- the filter skipped (each block's filter returns its input);
- softshrink dropped (the second layer's modes passed whole);
- all the columns kept (every one of the w // 2 + 1 rfft2 columns
  transformed, not the published first h // 2 + 1).

The control (the reference with fp8 products) and the half-batch fault of
the reference fail too; the traced path runs; one call's counts hold the
filters' sites; the reference and the family load neither JAX nor, for the
reference, the program.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import control, harness

NAME = "fourcastnet_720x1440.train_fast_b4"
TINY = {"config": {"resolution": [32, 64], "patch_size": 4, "embed_dim": 64, "depth": 2},
        "workload": {"days_per_year": 20, "years": 2, "batch": 2, "reference_rows": 1}}
SEED = 2 ** 31 + 11
ROOT = Path(__file__).resolve().parents[2]


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
    from probunet_torch.models.fourcastnet import FourCastNet

    orig = FourCastNet.forward

    def forward(self, x, class_labels=None, generator=None, shard=(0, 1)):
        h = x.shape[0] // 2
        out = orig(self, x[:h], class_labels, generator, shard)
        return torch.cat([out, out])[:x.shape[0]]

    monkeypatch.setattr(FourCastNet, "forward", forward)


def _filter_skipped(monkeypatch):
    from probunet_torch.models.fourcastnet import AFNO2D

    monkeypatch.setattr(AFNO2D, "forward", lambda self, x: x)


class _NoShrink:
    """torch.nn.functional with softshrink the identity."""

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    @staticmethod
    def softshrink(x, lambd=0.5):
        return x


def _softshrink_dropped(monkeypatch):
    from probunet_torch.models import fourcastnet

    monkeypatch.setattr(fourcastnet, "F", _NoShrink())


def _all_columns_kept(monkeypatch):
    from probunet_torch.models import fourcastnet

    monkeypatch.setattr(fourcastnet, "kept_columns", lambda h, w: w // 2 + 1)


FAULTS = [_state_unchanged, _half_batch, _filter_skipped, _softshrink_dropped, _all_columns_kept]


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
    assert "spectral_roofline_pct.train" not in out["metrics"]   # no device time to divide
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_counts_hold_the_filters():
    """One call's counts: a forward site a block, its FLOPs the kept modes'
    block products (b2 x 8 rows x 5 of 9 columns of modes, 8 blocks of 8
    here), its bytes x and y at bf16 and the fp32 weights; no attention or
    GroupNorm site."""
    cell = harness.Cell(NAME, overrides=TINY)
    job = cell.family().make_job(cell, SEED, torch.device("cpu"))
    c = job.counts()
    modes = 2 * 8 * 5
    weights = 4 * (2 * 2 * 8 * 8 * 8 + 2 * 2 * 64)
    assert c["spectral"] == [{"pass": "fwd", "flops": 16.0 * modes * 64 * 8,
                              "bytes": float(2 * 2 * 8 * 16 * 64 * 2 + weights)}] * 2
    assert c["attn"] == [] and c["gn"] == [] and c["flops"] > 0


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_cell_loads_no_jax_and_the_reference_no_program():
    forbidden = set(harness.FORBIDDEN)
    run_mods = _top_level_after("from perfbench.families import fourcastnet\n"
                                "fourcastnet.make_job.__call__\n"
                                "from probunet_torch.train.loop import build_fourcastnet_model")
    assert "probunet_torch" in run_mods and not run_mods & forbidden
    ref_mods = _top_level_after("import perfbench.reference.fourcastnet")
    assert not ref_mods & (forbidden | {"probunet_torch"})
