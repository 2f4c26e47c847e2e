"""Hyperparameter sweeps — ``probunet_tpu/train/sweep.py`` (reference
sweeps.yaml + wandb agent).

Reads a wandb-style sweep YAML (``method: grid``, ``parameters: {name:
{values: [...]}}``, ``metric: {name, goal}``), runs the training pipeline
for every grid point in turn on one card, records the optimization metric of
each run and returns the best configuration. The reference's sweep minimizes
``val-loss`` (sweeps.yaml:5-7), a key its training loop never logs (it logs
``val_loss``); both spellings are accepted. ``yaml`` and ``wandb`` are
imported where they are needed.

    python -m probunet_torch.train.sweep --sweep sweeps.yaml [--device cpu] [config flags...]

With wandb importable and ``--agent`` left on, the command registers the
sweep and runs a real ``wandb.agent``; otherwise it runs the local grid.
Under a multi-process launch (``torchrun``, as for ``python -m
probunet_torch.train``) every process runs every grid point data parallel
and rank 0 writes the results.
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
from typing import Dict, List, Optional, Sequence

from probunet_torch.config import Config, get_config
from probunet_torch.parallel.multihost import maybe_initialize_distributed, process_info


def load_sweep(path: str) -> Dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def grid_points(sweep: Dict) -> List[Dict]:
    """Every combination of the sweep's parameter values, in YAML order."""
    params = sweep.get("parameters", {})
    names, valuess = [], []
    for name, spec in params.items():
        names.append(name)
        valuess.append(spec["values"] if isinstance(spec, dict) else list(spec))
    return [dict(zip(names, combo)) for combo in itertools.product(*valuess)]


def _metric_name(sweep: Dict) -> str:
    name = (sweep.get("metric") or {}).get("name", "val_loss")
    return "val_loss" if name == "val-loss" else name


def _resolve_metric(result: Dict, metric: str, cfg: Config) -> float:
    """Value of the optimization metric for one finished run.

    ``val_loss`` comes from the train result; any other name (``crps_pr``,
    ``ensmean_mae_tasmax``, ``mae_pr``, ...) from the result dict or else
    the run's metrics JSONL, where the last record holding the key wins, so
    a per-epoch metric resolves to its final-epoch value."""
    if metric == "val_loss":
        vl = result.get("val_losses")
        # the baselines' val_losses is a per-variable dict: fall through
        if isinstance(vl, (list, tuple)) and vl \
                and not isinstance(vl[-1], (dict, list, tuple)):
            return float(vl[-1])
    if metric in result and not isinstance(result[metric], (dict, list, tuple)):
        return float(result[metric])
    if isinstance(result.get("mae"), dict) and metric.startswith("mae_"):
        var = metric[len("mae_"):]
        if var in result["mae"]:
            return float(result["mae"][var])
    paths = ([cfg.metrics_path] if cfg.metrics_path else
             sorted(glob.glob(os.path.join(cfg.plotdir, "metrics*.jsonl"))))
    for path in paths:
        if not os.path.exists(path):
            continue
        value = None
        with open(path) as fh:
            for line in fh:
                rec = json.loads(line)
                if metric in rec:
                    value = rec[metric]
        if value is not None:
            return float(value)
    raise KeyError(
        f"sweep metric {metric!r} not found in the run result or in the "
        f"run's metrics files ({paths}); check the sweep YAML's metric.name "
        "against the keys the training loop logs")


def _default_train(device):
    """The trainer of each run's ``ds_model``, as ``python -m
    probunet_torch.train`` picks it, without plots."""
    from probunet_torch.train.loop import train_baseline, train_probunet

    def train(cfg):
        fn = train_probunet if cfg.ds_model == "probabilistic_unet" else train_baseline
        return fn(cfg, make_plots=False, device=device)

    return train


def run_sweep(sweep_path: str, base_cfg: Config, out_path: Optional[str] = None,
              train_fn=None, device=None) -> Dict:
    """Run the grid; returns {"runs": [...], "best": {...}, "metric",
    "goal"}. Each run trains with ``train_fn(cfg)`` (default the trainer of
    its ``ds_model`` on ``device``, default the CUDA card) under its own
    ``sweep_<i>`` plot and checkpoint directories."""
    sweep = load_sweep(sweep_path)
    train_fn = train_fn or _default_train(device)
    metric = _metric_name(sweep)
    goal = (sweep.get("metric") or {}).get("goal", "minimize")
    sign = 1.0 if goal == "minimize" else -1.0

    runs = []
    for i, point in enumerate(grid_points(sweep)):
        overrides = {k: v for k, v in point.items() if hasattr(base_cfg, k)}
        cfg = base_cfg.replace(**overrides)
        cfg = cfg.replace(plotdir=os.path.join(base_cfg.plotdir, f"sweep_{i}"),
                          checkpoints_dir=os.path.join(base_cfg.checkpoints_dir, f"sweep_{i}"))
        result = train_fn(cfg)
        value = _resolve_metric(result, metric, cfg)
        runs.append({"point": point, "metric": metric, "value": float(value)})
        print(f"[sweep {i}] {point} -> {metric}={value:.4f}")

    best = min(runs, key=lambda r: sign * r["value"])
    out = {"runs": runs, "best": best, "metric": metric, "goal": goal}
    if out_path and process_info()[0] == 0:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def run_wandb_agent(sweep_path: str, base_cfg: Config, train_fn=None,
                    count: Optional[int] = None, project: Optional[str] = None,
                    device=None) -> str:
    """Drive the sweep through a real wandb agent, the reference's workflow
    (``wandb sweep sweeps.yaml && wandb agent <id>``). Needs wandb; the
    metric is reported under the sweep's own declared name, so the
    reference YAML's ``val-loss`` spelling optimizes ``val_loss``."""
    import wandb

    sweep = load_sweep(sweep_path)
    raw_metric = (sweep.get("metric") or {}).get("name", "val_loss")
    metric = _metric_name(sweep)
    train_fn = train_fn or _default_train(device)
    sweep_id = wandb.sweep(sweep, project=project or sweep.get("project", "probunet_tpu"))

    def _run():
        with wandb.init() as run:
            overrides = {k: v for k, v in dict(run.config).items() if hasattr(base_cfg, k)}
            overrides["wandb"] = False  # the agent owns the run; avoid nesting
            cfg = base_cfg.replace(**overrides)
            result = train_fn(cfg)
            run.log({raw_metric: _resolve_metric(result, metric, cfg)})

    wandb.agent(sweep_id, function=_run, count=count)
    return sweep_id


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sweep", type=str, default="sweeps.yaml")
    p.add_argument("--out", type=str, default="./results/sweep_results.json")
    p.add_argument("--agent", type=lambda s: s.lower() in ("1", "true", "yes"), default=True,
                   help="use a wandb agent when wandb is importable")
    p.add_argument("--count", type=int, default=None, help="max runs for the wandb agent")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (under a process group cuda:<LOCAL_RANK>)")
    args, rest = p.parse_known_args(argv)
    cfg = get_config(rest)
    maybe_initialize_distributed(args.device)
    if args.agent:
        try:
            import wandb  # noqa: F401
        except ImportError:
            pass
        else:
            sweep_id = run_wandb_agent(args.sweep, cfg, count=args.count, device=args.device)
            print("wandb sweep:", sweep_id)
            return {"sweep_id": sweep_id}
    result = run_sweep(args.sweep, cfg, out_path=args.out, device=args.device)
    print("best:", result["best"])
    return result


if __name__ == "__main__":
    main()
