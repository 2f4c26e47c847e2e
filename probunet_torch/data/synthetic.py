"""Synthetic ClimEx-like netCDF generator (test fixture + demo data) — a
copy of ``probunet_tpu/data/synthetic.py``: the same files from the same
seed, as netCDF-4 or, where h5py is missing, as netCDF classic.

Writes files with the same structure the ingest path expects: per-year
per-variable files named ``climex_{var}_kdj_{year}_synth.nc`` holding a
(time, rlat, rlon) field, CF time with the 365-day calendar, and 2D lat/lon.
Fields are smooth spatio-temporal random processes with a seasonal cycle so
standardization and downscaling are non-trivial; precipitation is kept
non-negative in kg/m^2/s scale, temperatures in Kelvin.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from probunet_torch.data import netcdf
from probunet_torch.data.netcdf_classic import ClassicWriter

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


def _smooth_field(rng: np.random.Generator, t: int, h: int, w: int, n_modes: int = 6) -> np.ndarray:
    """Sum of random low-frequency Fourier modes -> (t, h, w) smooth noise."""
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    out = np.zeros((t, h, w), dtype=np.float32)
    tt = np.arange(t)[:, None, None]
    for _ in range(n_modes):
        fy, fx = rng.uniform(0.5, 4, size=2)
        ph = rng.uniform(0, 2 * np.pi, size=3)
        speed = rng.uniform(0.02, 0.2)
        amp = rng.uniform(0.3, 1.0)
        spatial = np.sin(2 * np.pi * (fy * ys + fx * xs) + ph[0])
        out += (amp * spatial[None] * np.sin(speed * tt + ph[1])).astype(np.float32)
    return out


def generate_climex_like(
    datadir: str,
    years: Sequence[int] = (2000, 2001),
    variables: Sequence[str] = ("pr", "tasmin", "tasmax"),
    grid: int = 32,
    days_per_year: int = 365,
    seed: int = 0,
) -> Dict[str, str]:
    """Write synthetic files; returns {f"{year}_{var}": path}. netCDF-4 (the
    JAX package's files) where h5py is installed, else netCDF classic."""
    file_format = netcdf.default_format()
    os.makedirs(datadir, exist_ok=True)
    rng = np.random.default_rng(seed)
    h = w = grid
    ys, xs = np.meshgrid(np.linspace(44, 52, h), np.linspace(-79, -57, w), indexing="ij")
    paths = {}
    for year in years:
        t0 = (year - 1950) * days_per_year
        doy = np.arange(days_per_year)
        season = np.sin(2 * np.pi * doy / days_per_year)[:, None, None].astype(np.float32)
        for var in variables:
            base = _smooth_field(rng, days_per_year, h, w)
            if var == "pr":
                # kg/m^2/s, non-negative, skewed like precip (~0-50 mm/day)
                data = np.maximum(base + 0.5 * season, 0.0) ** 2 * (20.0 / 86400.0)
            elif var == "tasmin":
                data = 268.0 + 12.0 * season + 3.0 * base
            else:  # tasmax
                data = 276.0 + 12.0 * season + 3.0 * base
            path = os.path.join(datadir, f"climex_{var}_kdj_{year}_synth.nc")
            paths[f"{year}_{var}"] = path
            if file_format == "classic":
                _write_classic(path, var, t0 + doy, h, w, ys, xs, data)
                continue
            with h5py.File(path, "w") as f:
                tds = f.create_dataset("time", data=(t0 + doy).astype(np.float64))
                tds.attrs["units"] = np.bytes_("days since 1950-01-01")
                tds.attrs["calendar"] = np.bytes_("noleap")
                f.create_dataset("rlat", data=np.linspace(-5, 5, h))
                f.create_dataset("rlon", data=np.linspace(-8, 8, w))
                f.create_dataset("lat", data=ys.astype(np.float32))
                f.create_dataset("lon", data=xs.astype(np.float32))
                vds = f.create_dataset(var, data=data.astype(np.float32))
                vds.attrs["units"] = np.bytes_(
                    "kg m-2 s-1" if var == "pr" else "K")
    return paths


def _write_classic(path, var, days, h, w, ys, xs, data) -> None:
    """The same file's contents as netCDF classic."""
    time_attrs = {"units": "days since 1950-01-01", "calendar": "noleap"}
    cw = ClassicWriter(path, {"time": len(days), "rlat": h, "rlon": w}, {
        "time": (("time",), np.float64, time_attrs),
        "rlat": (("rlat",), np.float64, {}),
        "rlon": (("rlon",), np.float64, {}),
        "lat": (("rlat", "rlon"), np.float32, {}),
        "lon": (("rlat", "rlon"), np.float32, {}),
        var: (("time", "rlat", "rlon"), np.float32,
              {"units": "kg m-2 s-1" if var == "pr" else "K"}),
    })
    try:
        for name, arr in (("time", days.astype(np.float64)), ("rlat", np.linspace(-5, 5, h)),
                          ("rlon", np.linspace(-8, 8, w)), ("lat", ys), ("lon", xs),
                          (var, data)):
            cw.write(name, 0, arr)
    finally:
        cw.close()
