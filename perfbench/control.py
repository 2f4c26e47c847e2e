"""The readings that a cell's limits are set from (never run by the
benchmark's own runs):

    python3 perfbench/control.py --workload <name> --seeds 12 --control-seeds 3

For each program seed: the set-up and calls that a run checks (training:
the first steps; sampling: ``check_calls`` calls), then the check, as a
run makes it. For each control seed: the reference computed in the
precision below the cell's (``control`` in the cell's file: ``tf32`` for
fp32, ``fp8`` for bf16) put in the program's place, against the fp32
reference; for training also the reference with half of each batch left
out (the loss of the rest, doubled). A step that returns its state
unchanged reads 1 on ``change_gap`` by that number's definition.
Prints one JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import compare, harness  # noqa: E402
from perfbench.reference.unet import set_precision  # noqa: E402


def program_reading(cell, seed: int, device) -> dict:
    job = cell.family().make_job(cell, seed, device)
    job.build_kernels()
    job.setup()
    n = job.wl.get("check_calls", 0)
    job.plan_checks(n)
    for _ in range(n):
        job.call()
    job.free()
    checked = {name: v for name, v, _ in job.check()}
    return {**getattr(job, "readings", {}), **checked}


def control_readings(cell, seed: int, device) -> dict:
    """{variant: {number: value}} of the control and, for training, the
    half-batch fault, each against the fp32 reference."""
    job = cell.family().make_job(cell, seed, device)
    job.make_inputs()
    out = {}
    if job.wl["job"] in ("train", "train_dp"):
        def readings(precision, fault=None):
            return job.reference_readings(set_precision(job.reference(), precision), fault)

        ref = readings("fp32")
        out["control"] = compare.training_gaps(readings(job.wl["control"]), ref)
        out["half_batch"] = compare.training_gaps(readings("fp32", "half_batch"), ref)
        if job.wl["job"] == "train_dp":
            out["no_exchange"] = compare.training_gaps(readings("fp32", "no_exchange"), ref)
        return out
    job.plan_checks(job.wl["check_calls"])
    gap = 0.0
    for i in sorted(job.chosen):
        want = job.reference_residual(i, "fp32")
        low = job.reference_residual(i, job.wl["control"])
        gap = max(gap, compare.residual_gap(low["residual"], want["residual"]))
    out["control"] = {"residual_gap": gap}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)
    device = torch.device("cuda:0")
    for s in range(args.seeds):
        seed = args.first_seed + s
        t = time.perf_counter()
        r = program_reading(cell, seed, device)
        print(json.dumps({"cell": cell.name, "kind": "program", "seed": seed, **r,
                          "s": round(time.perf_counter() - t, 1)}), flush=True)
    for s in range(args.control_seeds):
        seed = args.first_seed + 1000 + s
        t = time.perf_counter()
        for variant, r in control_readings(cell, seed, device).items():
            print(json.dumps({"cell": cell.name, "kind": variant, "seed": seed, **r,
                              "s": round(time.perf_counter() - t, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
