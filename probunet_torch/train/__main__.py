"""End-to-end training (reference main.py) — the port's
``scripts/train_probunet.py`` and, with ``--ds_model edm``, its
``scripts/train_baseline.py --ds_model edm`` (the EDM diffusion downscaler).

    python -m probunet_torch.train --datadir /path/to/climex [config flags...]
    python -m probunet_torch.train --synthetic [config flags...]   # generated data
    python -m probunet_torch.train --device cpu ...                # default: the card
    python -m probunet_torch.train --ds_model edm [config flags...]

All Config fields are flags (see probunet_torch/config.py). ``--synthetic``
writes ClimEx-like files for every year of the three splits into
``--datadir`` (default ./data/synthetic_climex) when they are missing:
netCDF-4 where h5py is installed, else netCDF classic.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from probunet_torch.config import Config, get_config


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args, rest = p.parse_known_args(argv)
    cfg = get_config(rest)
    if args.synthetic:
        from probunet_torch.data.netcdf import discover_files
        from probunet_torch.data.synthetic import generate_climex_like

        datadir = cfg.datadir if cfg.datadir != Config().datadir else "./data/synthetic_climex"
        years = range(cfg.years_train[0], cfg.years_test[1])
        try:
            discover_files(datadir, years, cfg.variables)
        except (FileNotFoundError, OSError):
            print(f"Generating synthetic ClimEx-like data in {datadir}")
            generate_climex_like(datadir, years=years, grid=max(cfg.coords[1], cfg.coords[3]))
        cfg = cfg.replace(datadir=datadir)

    from probunet_torch.train.loop import train_baseline, train_probunet

    train = train_probunet if cfg.ds_model == "probabilistic_unet" else train_baseline
    results = train(cfg, device=args.device)
    val = results["val_losses"][-1] if results["val_losses"] else float("nan")
    print(f"final train loss: {results['tr_losses'][-1]:.4f}  val loss: {val:.4f}  "
          f"throughput: {results['samples_per_sec']:.1f} samples/s")
    return results


if __name__ == "__main__":
    main()
