"""The benchmark's run: set-up, the measured window or the traced
segments, the correctness check and the result line.

Everything that belongs to one cell is found by name: the cell's file
``workloads/<name>.json`` names its configuration ``configs/<config>.json``,
whose ``family`` names the module ``families/<family>.py`` that builds the
job (the program under test, its feed and its check). Each per-layer
metric ``<base>[.<variant>]`` is read by ``metrics/<base>.py``; each
``kernels/<layer>.json`` tells a layer's kernels apart. Which metrics a
cell reports is ``BENCHMARK.json``'s.

The window is a closed loop: call ``i + 1`` is issued as soon as the host
returns from call ``i``, and a CUDA event is recorded after each call, with
no synchronise. The window closes at the first completion at or after
``seconds``; its rates divide the work completed by that time.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import torch

from perfbench import trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "probunet_tpu")
GIB = 2 ** 30


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads``: its files and its metrics."""

    def __init__(self, name: str, overrides: Optional[dict] = None):
        self.name = name
        self.overrides = overrides
        self.workload = load_json(HERE / "workloads" / f"{name}.json")
        self.config = load_json(HERE / "configs" / f"{self.workload['config']}.json")
        if overrides:
            self.config = {**self.config, **overrides.get("config", {})}
            self.workload = {**self.workload, **overrides.get("workload", {})}
        self.peaks = load_json(HERE / "peaks.json")
        self.bench = load_json(ROOT / "BENCHMARK.json")
        self.chips = next((w["chips"] for w in self.bench["workloads"] if w["name"] == name), 1)
        if overrides and "chips" in overrides:
            self.chips = overrides["chips"]

    def metrics(self, kind: str) -> List[dict]:
        return [m for m in self.bench[kind]
                if name_in(self.name, m.get("workloads"), self.bench, kind, m)]

    def family(self):
        return importlib.import_module(f"perfbench.families.{self.config['family']}")


def name_in(cell: str, listed, bench: dict, kind: str, metric: dict) -> bool:
    """Whether ``cell`` reports ``metric``: listed under its ``workloads``,
    or, without that key, every cell that reports the end-to-end metric it
    moves (per-layer) or every cell (end-to-end)."""
    if listed is not None:
        return cell in listed
    if kind == "per_layer":
        moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
        return name_in(cell, moved.get("workloads"), bench, "end_to_end", moved)
    return True


def reader(metric: str):
    """``metrics/<base>.py`` for a metric named ``<base>`` or ``<base>.<variant>``."""
    base = metric.split(".")[0]
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{base}",
                                                  HERE / "metrics" / f"{base}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class TraceContext:
    """What a per-layer reader reads."""

    def __init__(self, segments, counts: dict, peak_flops: float, hbm: float):
        self.segments, self.counts = segments, counts
        self.peak_flops, self.hbm = peak_flops, hbm
        self.kernels = {p.stem: load_json(p) for p in sorted((HERE / "kernels").glob("*.json"))}


def p90(values: List[float]) -> float:
    return statistics.quantiles(values, n=10)[8] if len(values) > 1 else values[0]


def measure(job, seconds: float) -> dict:
    """The closed-loop window: rates and the p90 of the time between
    consecutive completions, from CUDA events after each call."""
    cuda = job.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0, marks, i = time.perf_counter(), [], 0
    while True:
        job.call()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
        done = [start.elapsed_time(e) / 1e3 for e in marks]
        peak = torch.cuda.max_memory_allocated()
    else:
        done, peak = [m - t0 for m in marks], 0
    end = next((j for j, t in enumerate(done) if t >= seconds), len(done) - 1)
    n, length = end + 1, done[end]
    gaps = [done[0]] + [done[j] - done[j - 1] for j in range(1, n)]
    return {"calls": n, "issued": i, "window_s": length, "step_ms_p90": 1e3 * p90(gaps),
            "units_per_s": n * job.units_per_call / length, "peak_bytes": peak}


def traced(job, plan: dict, workdir: str) -> list:
    """``plan["traces"]`` profiled segments of ``plan["calls"]`` calls each."""
    from torch.profiler import ProfilerActivity, profile, record_function

    segments = []
    for r in range(plan["traces"]):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(trace.WINDOW):
                for _ in range(plan["calls"]):
                    job.call()
                torch.cuda.synchronize()
        path = os.path.join(workdir, f"segment{r}.json")
        prof.export_chrome_trace(path)
        segments.append(trace.load_segment(path, plan["calls"]))
        os.unlink(path)
    return segments


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _per_layer(cell: Cell, job, log) -> dict:
    """The traced segments and what the readers take from them."""
    plan = cell.workload["trace"]
    job.plan_checks(plan["traces"] * plan["calls"])
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        segments = traced(job, plan, tmp)
    log(f"traced {sum(s.calls for s in segments)} calls in {len(segments)} segments, exported "
        f"and read in {time.perf_counter() - t:.1f} s")
    ctx = TraceContext(segments, job.counts(), cell.peaks["flops_per_s"][cell.workload["peak"]],
                       cell.peaks["hbm_bytes_per_s"])
    values = {m["name"]: reader(m["name"])(ctx) for m in cell.metrics("per_layer")}
    split = {k: trace.pooled_ms(segments, trace.kernel_filter(v)) for k, v in ctx.kernels.items()}
    log(f"device ms per call: all kernels {trace.pooled_ms(segments):.3f}, "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return {"values": values, "attempted": sum(s.calls for s in segments),
            "peak": torch.cuda.max_memory_allocated(),
            "device": {"busy_s": sum(s.busy_s() for s in segments),
                       "window_s": sum(s.window_s for s in segments)},
            "breakdown": {"device_ops": trace.top_device_ops(segments),
                          "idle_gaps": trace.top_idle_gaps(segments)}}


def _end_to_end(cell: Cell, job, seconds: float, setup_s: float, log) -> dict:
    """The measured window's metrics."""
    job.plan_checks(cell.workload["check_range"])
    w = measure(job, seconds)
    log(f"window {w['window_s']:.4f} s, {w['calls']} calls counted of {w['issued']} issued")
    values = {"setup_s": setup_s, "step_ms_p90": w["step_ms_p90"],
              "peak_mem_gib": w["peak_bytes"] / GIB,
              cell.workload["rate_metric"]: w["units_per_s"]}
    return {"values": values, "attempted": w["calls"], "peak": w["peak_bytes"], "device": {}}


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, device, t_start: float,
        log=print) -> dict:
    """One run of ``cell``; returns the result object (before printing)."""
    device = torch.device(device)
    job = cell.family().make_job(cell, seed, device)
    job.mark("imports")
    job.build_kernels()
    job.mark("kernel library")
    job.setup()
    setup_s = time.perf_counter() - t_start
    stages, last = [], t_start
    for stage, t in job.marks:
        stages.append(f"{stage} {t - last:.3f}")
        last = t
    log(f"set-up {setup_s:.3f} s: " + ", ".join(stages))
    r = _per_layer(cell, job, log) if trace_on else _end_to_end(cell, job, seconds, setup_s, log)
    kind = "per_layer" if trace_on else "end_to_end"
    out = {"correct": False, "attempted": r["attempted"], "failed": 0,
           "metrics": {m["name"]: {"value": r["values"][m["name"]], "unit": m["unit"]}
                       for m in cell.metrics(kind) if r["values"].get(m["name"]) is not None},
           "device": {}}
    if device.type == "cuda":
        out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                         "count": cell.chips, "memory_peak_bytes": r["peak"],
                         "card_and_power_limit": power_limit(), **r["device"]}
    if "breakdown" in r:
        out["breakdown"] = r["breakdown"]
    job.free()
    if job.rank_peaks and out["device"]:   # the peak on the fullest card
        out["device"]["memory_peak_bytes"] = max(r["peak"], *job.rank_peaks)
    t = time.perf_counter()
    checks = job.check()
    log(f"check {time.perf_counter() - t:.1f} s")
    out["correct"] = bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return out
