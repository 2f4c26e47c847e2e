"""End-to-end training (reference main.py) — the port's
``scripts/train_probunet.py`` and, with any other ``--ds_model``, its
``scripts/train_baseline.py``: ``edm`` (the diffusion downscaler), ``vae``
(the conv-VAE), ``deterministic_unet``, ``linearcnn`` and ``bcsd``.

    python -m probunet_torch.train --datadir /path/to/climex [config flags...]
    python -m probunet_torch.train --synthetic [config flags...]   # generated data
    python -m probunet_torch.train --device cpu ...                # default: the card
    python -m probunet_torch.train --ds_model deterministic_unet [config flags...]

All Config fields are flags (see probunet_torch/config.py). ``--synthetic``
writes ClimEx-like files for every year of the three splits into
``--datadir`` (default ./data/synthetic_climex) when they are missing:
netCDF-4 where h5py is installed, else netCDF classic.

Several processes, one per card, train data parallel when the environment
describes the launch (``probunet_torch.parallel.mesh.launch_env``), e.g.

    torchrun --nproc_per_node 2 -m probunet_torch.train [config flags...]
    torchrun --nproc_per_node 2 -m probunet_torch.train --device cpu [config flags...]

or with the JAX package's names (``COORDINATOR_ADDRESS=host:port``,
``PROBUNET_NUM_PROCESSES``, ``PROBUNET_PROCESS_ID``). The process group comes
up before any device work: NCCL on the cards, gloo on the CPU.
``--data_shards N`` on one process computes what N processes compute.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from probunet_torch.config import Config, get_config


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (under a process group cuda:<LOCAL_RANK>)")
    args, rest = p.parse_known_args(argv)
    cfg = get_config(rest)
    from probunet_torch.parallel import mesh
    from probunet_torch.parallel.multihost import maybe_initialize_distributed, process_info

    maybe_initialize_distributed(args.device)
    if args.synthetic:
        from probunet_torch.data.netcdf import discover_files
        from probunet_torch.data.synthetic import generate_climex_like

        datadir = cfg.datadir if cfg.datadir != Config().datadir else "./data/synthetic_climex"
        years = range(cfg.years_train[0], cfg.years_test[1])
        if process_info()[0] == 0:   # one writer; the other ranks wait for the files
            try:
                discover_files(datadir, years, cfg.variables)
            except (FileNotFoundError, OSError):
                print(f"Generating synthetic ClimEx-like data in {datadir}")
                generate_climex_like(datadir, years=years,
                                     grid=max(cfg.coords[1], cfg.coords[3]))
        if mesh.is_initialized():
            mesh.barrier()
        cfg = cfg.replace(datadir=datadir)

    from probunet_torch.train.loop import train_baseline, train_probunet

    train = train_probunet if cfg.ds_model == "probabilistic_unet" else train_baseline
    results = train(cfg, device=args.device)
    if cfg.ds_model == "bcsd":
        print("  ".join(f"{split} MAE: {_fmt(r['mae'])}" for split, r in results.items()))
    elif "mae" in results:   # the deterministic baselines: per-variable losses
        last = {v: losses[-1] if losses else float("nan")
                for v, losses in results["tr_losses"].items()}
        print(f"final train loss: {_fmt(last)}  val MAE: {_fmt(results['mae'])}  "
              f"throughput: {results['samples_per_sec']:.1f} samples/s")
    else:
        val = results["val_losses"][-1] if results["val_losses"] else float("nan")
        print(f"final train loss: {results['tr_losses'][-1]:.4f}  val loss: {val:.4f}  "
              f"throughput: {results['samples_per_sec']:.1f} samples/s")
    return results


def _fmt(per_var: dict) -> str:
    return ", ".join(f"{v} {x:.4g}" for v, x in per_var.items())


if __name__ == "__main__":
    main()
