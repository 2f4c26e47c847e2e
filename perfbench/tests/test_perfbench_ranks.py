"""A cell on several cards, rehearsed on the CPU: two gloo ranks of the
``train_dp`` job (``perfbench/ranks.py``), rank 0 in the test's process or
in a process of its own where a fault ends it (CPU only).

- Two ranks give the one-process step of the global batch: step 1's loss
  and each leaf's first gradient within the 1e-5 of
  ``tests/test_torch_multihost_e2e.py`` (only the summation order across
  the two backwards differs).
- A sound run is correct; a run with the timed path broken underneath, in
  every rank, is not: a state left unchanged, half of the batch left out,
  the exchange between ranks left out. The control fails a number too.
- A rank that dies or hangs, or a rank 0 that dies, ends the run within
  its bound, leaving no process behind; a one-card cell starts no process.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import _faults
from perfbench import control, harness, ranks
from perfbench.families import probunet

ROOT = Path(__file__).resolve().parents[2]
DP = "probunet_mc128.train_dp4_strict"
STRICT = "probunet_mc128.train_strict_b8"
TINY = {"config": {"resolution": [16, 16], "model_channels": 32, "channel_mult": [1, 2],
                   "attn_resolutions": [8], "num_blocks": 1, "num_filters": [8, 16],
                   "latent_dim": 4},
        "workload": {"days_per_year": 20, "years": 2}, "chips": 2}
SEED = 2 ** 31 + 11
STEP1_RTOL = 1e-5
CPU = torch.device("cpu")


def run(name=DP, overrides=TINY, seconds=0.3):
    torch.manual_seed(0)
    cell = harness.Cell(name, overrides=overrides)
    out = harness.run(cell, SEED, seconds, False, "cpu", time.perf_counter(), log=lambda m: None)
    assert not dist.is_initialized()
    return out


def test_two_ranks_give_the_one_process_step():
    job = probunet.make_job(harness.Cell(DP, overrides=TINY), SEED, CPU)
    job.setup()
    got = job.got
    job.free()
    one = {**TINY, "workload": {**TINY["workload"], "batch": 16}}
    single = probunet.make_job(harness.Cell(STRICT, overrides=one), SEED, CPU)
    single.setup()
    want = single.got
    assert abs(got["losses"][0] - want["losses"][0]) <= STEP1_RTOL * abs(want["losses"][0])
    med = sorted(want["grad_norms"].values())[len(want["grad_norms"]) // 2]
    for leaf, norm in want["grad_norms"].items():
        assert abs(got["grad_norms"][leaf] - norm) <= STEP1_RTOL * max(norm, med), leaf


def test_a_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and list(out)[-1] == "checks"
    # 16 global samples a call: the rate counts every rank's rows
    assert out["metrics"]["train_samples_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(_faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _faults.FAULTS[fault](monkeypatch.setattr)
    monkeypatch.setattr(ranks, "COMMAND", _faults.rank_command(fault))
    out = run()
    assert not out["correct"], out["checks"]


def test_the_control_fails():
    cell = harness.Cell(DP, overrides=TINY)
    limits = cell.workload["limits"]
    readings = control.control_readings(cell, SEED, CPU)
    assert set(readings) == {"control", "half_batch", "no_exchange"}
    for variant in readings:
        assert any(v > limits[k] for k, v in readings[variant].items() if k in limits), readings


RANK0 = """
import json, os, signal, sys, time
sys.path.insert(0, os.getcwd())
from perfbench import harness, ranks
cell = harness.Cell(sys.argv[1], overrides=json.loads(sys.argv[2]))
fault = sys.argv[3]
tell = ranks.Ranks.tell

def tell_then_fault(self):
    tell(self)
    if self.told == 4:   # set-up's calls made: the window's first
        print("RANK1", self.procs[0].pid, file=sys.stderr, flush=True)
        if fault == "rank_hangs":
            self.stall_s = 3
            os.kill(self.procs[0].pid, signal.SIGSTOP)
        elif fault == "rank_dies":
            os.kill(self.procs[0].pid, signal.SIGKILL)
        else:
            os.kill(os.getpid(), signal.SIGKILL)

ranks.Ranks.tell = tell_then_fault
out = harness.run(cell, int(sys.argv[4]), 60.0, False, "cpu", time.perf_counter(), log=print)
print(json.dumps(out))
"""


def _gone(pid: int, within: float) -> bool:
    end = time.monotonic() + within
    while time.monotonic() < end:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().split(")")[-1].split()[0] == "Z":
                    return True   # ended, not yet reaped by its new parent
        except FileNotFoundError:
            return True
        time.sleep(0.1)
    return False


@pytest.mark.parametrize("fault", ["rank_dies", "rank_hangs", "rank0_dies"])
def test_a_fault_ends_the_run(fault):
    """A 60 s window: a run that is not ended by the fault takes longer
    than the bound asserted."""
    t = time.monotonic()
    out = subprocess.run([sys.executable, "-c", RANK0, DP, json.dumps(TINY), fault, str(SEED)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    wall = time.monotonic() - t
    assert out.returncode != 0 and "correct" not in out.stdout, out.stderr[-3000:]
    assert wall < 45, (wall, out.stderr[-3000:])
    if fault == "rank_hangs":   # gloo would wait for its timeout: the watchdog ends it
        assert out.returncode == ranks.FAILED and "no progress" in out.stderr
    pid = int(out.stderr.split("RANK1 ")[1].split()[0])
    assert _gone(pid, within=5 * ranks.POLL_S + 5), f"rank 1 ({pid}) outlived the run"


def test_a_one_card_cell_starts_no_process(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a one-card cell started a process")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(ranks.Ranks, "__init__", refuse)
    launch = {k: os.environ.get(k) for k in ranks.LAUNCH_VARS}
    out = run(STRICT, overrides={k: v for k, v in TINY.items() if k != "chips"})
    assert out["correct"], out["checks"]
    assert {k: os.environ.get(k) for k in ranks.LAUNCH_VARS} == launch
