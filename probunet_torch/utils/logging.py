"""Observability: scalar metric logging, progress and step timing —
``probunet_tpu/utils/logging.py``.

A :class:`MetricLogger` fans out to a JSONL file (always: the run's
machine-readable record), to wandb when the package is importable and asked
for, and the loop shows a tqdm bar when tqdm is importable. Scalar names
match the reference's (train_loss/recon_loss/kl_div, val_*), and ``val_loss``
is also logged as ``val-loss``, the name the reference's sweeps.yaml
minimizes. :class:`StepTimer` reads the host clock after a
``torch.cuda.synchronize`` when the run is on the card, so its rate counts
finished work, not enqueued work, and owns the run's profiler trace.
:func:`span` marks a phase of a step on the profiler's timeline.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

try:
    import wandb as _wandb
except ImportError:  # pragma: no cover
    _wandb = None

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = None


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None, use_wandb: bool = False,
                 wandb_project: str = "prob-unet-mds-tpu", wandb_config: Optional[dict] = None):
        self.jsonl_path = jsonl_path
        self._fh = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
            self._fh = open(jsonl_path, "a")
        self.wandb_run = None
        if use_wandb:
            if _wandb is None:
                print("[probunet_torch] wandb requested but not installed; logging to JSONL only")
            else:
                self.wandb_run = _wandb.init(project=wandb_project, config=wandb_config or {})

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        rec = {k: float(v) for k, v in metrics.items()}
        if "val_loss" in rec:
            rec["val-loss"] = rec["val_loss"]  # reference sweeps.yaml metric alias
        if step is not None:
            rec["step"] = int(step)
        rec["time"] = time.time()
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.wandb_run is not None:
            self.wandb_run.log(rec, step=step)

    def log_param_histograms(self, model: torch.nn.Module, step: Optional[int] = None) -> None:
        """Parameter-distribution logging — the parameter half of the
        reference's ``wandb.watch(model)`` (baseline/main.py:57-58), under
        the port's (the reference's torch) parameter names. The JSONL record
        gets per-parameter L2 norms, computed on the device in float64 and
        fetched in one copy; a wandb run also gets full histograms."""
        named = [(name, p.detach()) for name, p in model.named_parameters()]
        norms = torch.stack([torch.linalg.vector_norm(p, dtype=torch.float64)
                             for _, p in named]).tolist()
        self.log({f"paramnorm/{name}": n for (name, _), n in zip(named, norms)}, step=step)
        if self.wandb_run is not None:
            self.wandb_run.log({f"params/{name}": _wandb.Histogram(p.float().cpu().numpy())
                                for name, p in named}, step=step)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
        if self.wandb_run is not None:
            self.wandb_run.finish()


def progress(iterable, desc: str = "", total: Optional[int] = None):
    if tqdm is None:
        return iterable
    return tqdm(iterable, desc=desc, total=total, dynamic_ncols=True)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks one phase of a call (``probunet.<phase>``) as a
    ``torch.profiler.record_function`` range, on the same timeline as the
    launches and kernels it encloses. With no profiler recording it is a
    shared no-op context: one flag read, no range, no allocation, no sync.
    It changes no dtype, stream or order of any operation."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


#: the steps a training trace records: the first step (kernel builds,
#: algorithm searches, allocator growth) is skipped, the next ones recorded
TRACE_WARMUP_STEPS = 1
TRACE_ACTIVE_STEPS = 8


class StepTimer:
    """Samples/s since the last :meth:`reset`, by the host clock read after
    the device has finished (``torch.cuda.synchronize`` on a CUDA
    ``device``). With ``profile_dir``, :meth:`start_trace` starts a
    ``torch.profiler`` trace (host and, on the card, device activity) of a
    bounded window of steps, advanced by :meth:`tick`: one step skipped,
    then :data:`TRACE_ACTIVE_STEPS` recorded. It is written there as
    ``trace.json`` (a Chrome trace) when the window closes, or at
    :meth:`stop_trace` if that comes first."""

    def __init__(self, profile_dir: str = "", device=None):
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.profile_dir = profile_dir
        self._prof = None
        self.reset()

    def start_trace(self):
        if self.profile_dir and self._prof is None:
            from torch.profiler import ProfilerActivity, profile, schedule

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._exported = False
            self._prof = profile(activities=activities, on_trace_ready=self._export,
                                 schedule=schedule(wait=0, warmup=TRACE_WARMUP_STEPS,
                                                   active=TRACE_ACTIVE_STEPS, repeat=1))
            self._prof.__enter__()

    def _export(self, prof) -> None:
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.profile_dir, "trace.json"))
        self._exported = True

    def stop_trace(self):
        """Closes the trace; writes it unless its window already has."""
        if self._prof is not None:
            self._sync()
            self._prof.__exit__(None, None, None)
            if not self._exported:   # closed before the first recorded step
                self._export(self._prof)
            self._prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self, n: int = 1):
        """Counts ``n`` samples of one finished step; advances the trace."""
        self.count += n
        if self._prof is not None:
            from torch.profiler import ProfilerAction

            if self._prof.current_action == ProfilerAction.RECORD_AND_SAVE:
                self._sync()   # the window's last step: its kernels belong in the trace
            self._prof.step()
            if self._exported:
                self._prof.__exit__(None, None, None)
                self._prof = None

    def rate(self) -> float:
        self._sync()
        dt = time.perf_counter() - self.t0
        return self.count / dt if dt > 0 else 0.0

    def reset(self):
        self._sync()
        self.t0 = time.perf_counter()
        self.count = 0
