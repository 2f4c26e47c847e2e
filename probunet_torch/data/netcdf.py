"""Minimal netCDF ingest and output — a copy of ``probunet_tpu/data/netcdf.py``
(numpy and h5py only), so the two packages read and write the same files.
Where h5py is not installed, output (and the synthetic inputs) are written
as netCDF classic instead (:mod:`probunet_torch.data.netcdf_classic`), and
either format is read.

File discovery by the reference's glob pattern, windowed reads of the
rotated-pole grid, and a thread pool for the per-file reads (h5py releases
the GIL during HDF5 I/O). The result is the in-RAM HR tensor, shaped
(T, H, W, C) channels-last. Like the JAX package, ``read_var`` applies
scale_factor/add_offset but not ``_FillValue``.

ClimEx files are netCDF-4, i.e. HDF5 with dimension-scale conventions, so h5py
reads them directly; this module also understands the 365-day ("noleap")
calendar the ensemble uses.
"""

from __future__ import annotations

import concurrent.futures as cf
import glob
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from probunet_torch.data import netcdf_classic

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


def discover_files(datadir: str, years: Sequence[int], variables: Sequence[str]) -> List[Tuple[int, str, str]]:
    """Glob per (year, var) exactly like reference climex_utils.py:79-81."""
    out = []
    for year in years:
        for var in variables:
            pattern = f"{datadir}/*_{var}_*_{year}_*"
            matches = glob.glob(pattern)
            if not matches:
                raise FileNotFoundError(f"no file matching {pattern}")
            out.append((year, var, matches[0]))
    return out


def decode_time(values: np.ndarray, units: str, calendar: str = "standard") -> np.ndarray:
    """CF time values -> datetime64[ns]. Supports 'days since ...' with the
    standard and 365-day (noleap) calendars."""
    m = re.match(r"(\w+)\s+since\s+([0-9-]+)", units)
    if not m:
        raise ValueError(f"unsupported time units: {units!r}")
    unit, origin = m.group(1), m.group(2)
    scale = {"days": 86400.0, "hours": 3600.0, "seconds": 1.0}[unit]
    days = np.asarray(values, dtype=np.float64) * scale / 86400.0
    base = np.datetime64(origin, "D")
    if calendar.lower() in ("noleap", "365_day"):
        # Map virtual noleap days onto real dates: every 365 days is one year
        # starting at the same month/day as the origin.
        year0 = int(str(base)[:4])
        rest = base - np.datetime64(f"{year0:04d}-01-01", "D")
        years = (days // 365).astype(np.int64)
        doy = days - years * 365
        dates = np.array([np.datetime64(f"{year0 + y:04d}-01-01", "D") + rest for y in years])
        return (dates.astype("datetime64[ns]")
                + (doy * 86400e9).astype("timedelta64[ns]"))
    return (base.astype("datetime64[ns]") + (days * 86400e9).astype("timedelta64[ns]"))


def default_format() -> str:
    """'netcdf4' (HDF5, through h5py) where h5py is installed, else 'classic'."""
    return "netcdf4" if h5py is not None else "classic"


class NetCDFFile:
    """One netCDF file: netCDF-4 opened via h5py, or classic (CDF-1/2) read
    by :mod:`netcdf_classic`, told apart by the file's signature."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            magic = fh.read(4)
        if magic in (netcdf_classic.MAGIC_CDF1, netcdf_classic.MAGIC_CDF2):
            self._f = netcdf_classic.ClassicFile(path)
            return
        if h5py is None:
            raise ImportError(f"h5py is required to read netCDF-4 (HDF5) file {path}")
        self._f = h5py.File(path, "r")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _attr(self, ds, name, default=""):
        v = ds.attrs.get(name, default)
        return v.decode() if isinstance(v, bytes) else str(v)

    def read_var(self, name: str, window: Optional[Tuple[slice, slice]] = None) -> np.ndarray:
        """Read variable (time, rlat, rlon) with an optional (rlat, rlon) window.
        Applies CF scale_factor/add_offset/_FillValue if present."""
        ds = self._f[name]
        if window is not None and ds.ndim == 3:
            data = ds[:, window[0], window[1]]
        elif window is not None and ds.ndim == 2:
            data = ds[window[0], window[1]]
        else:
            data = ds[...]
        data = np.asarray(data, dtype=np.float32)
        if "scale_factor" in ds.attrs or "add_offset" in ds.attrs:
            data = data * np.float32(ds.attrs.get("scale_factor", 1.0)) + np.float32(
                ds.attrs.get("add_offset", 0.0))
        return data

    def read_time(self) -> np.ndarray:
        t = self._f["time"]
        units = self._attr(t, "units", "days since 1950-01-01")
        calendar = self._attr(t, "calendar", "standard")
        return decode_time(t[...], units, calendar)


def load_window(
    datadir: str,
    years: Sequence[int],
    variables: Sequence[str],
    coords: Sequence[int] = (120, 184, 120, 184),
    max_workers: int = 8,
) -> Dict[str, np.ndarray]:
    """Parallel windowed load of a ClimEx-style dataset.

    coords = (rlon0, rlon1, rlat0, rlat1) exactly like reference
    climex_utils.py:74-75: variables are indexed [time, rlat, rlon], so the
    window is [:, rlat0:rlat1, rlon0:rlon1].

    Returns {"hr": (T, H, W, C) float32, "timestamps": (T,) float ns,
             "lat": (H, W), "lon": (H, W)}.
    """
    rlon = slice(coords[0], coords[1])
    rlat = slice(coords[2], coords[3])
    files = discover_files(datadir, years, variables)
    var_index = {v: i for i, v in enumerate(variables)}

    def read_one(entry):
        year, var, path = entry
        with NetCDFFile(path) as f:
            data = f.read_var(var, (rlat, rlon))
            times = f.read_time() if var == variables[0] else None
            latlon = None
            if year == years[0] and var == variables[0]:
                lat = f.read_var("lat", (rlat, rlon))
                lon = f.read_var("lon", (rlat, rlon))
                # some ClimEx files carry (time, rlat, rlon) lat/lon; take t=0
                if lat.ndim == 3:
                    lat, lon = lat[0], lon[0]
                latlon = (lat, lon)
        return year, var, data, times, latlon

    with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
        results = list(pool.map(read_one, files))

    per_year: Dict[int, dict] = {}
    lat = lon = None
    for year, var, data, times, latlon in results:
        d = per_year.setdefault(year, {"times": None, "vars": {}})
        d["vars"][var] = data
        if times is not None:
            d["times"] = times
        if latlon is not None:
            lat, lon = latlon

    hr_chunks, ts_chunks = [], []
    for year in sorted(per_year):
        d = per_year[year]
        stacked = np.stack([d["vars"][v] for v in variables], axis=-1)  # (T, H, W, C)
        hr_chunks.append(stacked)
        ts_chunks.append(d["times"].astype("datetime64[ns]").astype(float))
    return {
        "hr": np.concatenate(hr_chunks, axis=0),
        "timestamps": np.concatenate(ts_chunks, axis=0),
        "lat": lat,
        "lon": lon,
    }


def pack_params(lo: float, hi: float):
    """CF short-packing parameters for the value range [lo, hi]:
    scale_factor/add_offset such that the range maps onto int16
    [-32767, 32767] (−32768 reserved as a fill value by convention).
    Quantization step = (hi-lo)/65534 — e.g. ~0.002 K over a 150 K
    temperature range, far finer than bfloat16."""
    lo, hi = float(lo), float(hi)
    if not hi > lo:
        raise ValueError(f"packing range must have hi > lo, got [{lo}, {hi}]")
    scale = (hi - lo) / 65534.0
    offset = (hi + lo) / 2.0
    return scale, offset


def pack_int16(arr: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Pack a float array into CF int16 (values outside [lo, hi] clip)."""
    scale, offset = pack_params(lo, hi)
    q = np.rint((np.asarray(arr, np.float64) - offset) / scale)
    return np.clip(q, -32767, 32767).astype(np.int16)


class StreamingFieldWriter:
    """Incremental netCDF writer for serving: variables are created at full
    (T[, K], H, W) size up front and filled chunk-by-chunk with
    :meth:`append`, so century-scale ensembles never materialize in host RAM.
    The file layout is the JAX package's: CF time, 2D lat/lon, per-variable
    datasets.

    The file is netCDF-4 (HDF5 through h5py, the JAX package's files) where
    h5py is installed, else classic (CDF-2, :mod:`netcdf_classic`, numpy
    only): :func:`default_format`.

    Usage::

        with StreamingFieldWriter(path, shapes={"pr": (T, K, H, W)}, ...) as w:
            for t0, chunk in ...:
                w.append({"pr": chunk}, t0)
    """

    def __init__(self, path: str, shapes: Dict[str, tuple],
                 timestamps_ns: np.ndarray,
                 lat: Optional[np.ndarray] = None,
                 lon: Optional[np.ndarray] = None,
                 attrs: Optional[Dict[str, str]] = None,
                 time_chunk: int = 64,
                 compression: Optional[str] = None,
                 packing: Optional[Dict[str, tuple]] = None):
        """``compression``: 'gzip' (netCDF-standard deflate, max interop,
        but slow on one host core), 'lzf' (h5py-only filter, much faster,
        needs the lzf filter on the reader side), or 'none'; both filters
        need netCDF-4. Default: 'gzip' for netCDF-4, 'none' for classic.

        ``packing``: optional {var: (lo, hi)} — store those variables as
        CF-standard int16 with ``scale_factor``/``add_offset`` attributes
        (the packing convention climate archives themselves use; values
        outside [lo, hi] clip). Halves bytes vs float32 at quantization step
        (hi-lo)/65534, and lets the serving path transfer int16 off the
        device. ``NetCDFFile.read_var``
        (and any netCDF reader) un-packs transparently. :meth:`append`
        accepts either raw int16 (already packed, e.g. on-device) or float
        arrays (packed here on host) for a packed variable."""
        self.file_format = default_format()
        if compression is None:
            compression = "gzip" if self.file_format == "netcdf4" else "none"
        if compression not in ("gzip", "lzf", "none"):
            raise ValueError(f"unknown compression {compression!r}")
        if self.file_format == "classic" and compression != "none":
            raise ValueError(f"compression {compression!r} needs netCDF-4 (h5py); "
                             "classic netCDF is uncompressed")
        self._packing = dict(packing or {})
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        days = np.asarray(timestamps_ns, dtype=np.float64) / 86400e9
        base = (np.datetime64("1950-01-01", "D").astype("datetime64[ns]")
                .astype(float) / 86400e9)
        time_attrs = {"units": np.bytes_("days since 1950-01-01"),
                      "calendar": np.bytes_("standard")}
        var_attrs = {}
        for name in shapes:
            a = {}
            if name in self._packing:
                scale, offset = pack_params(*self._packing[name])
                a["scale_factor"] = np.float64(scale)
                a["add_offset"] = np.float64(offset)
            a.update({k: np.bytes_(v) for k, v in (attrs or {}).items()})
            var_attrs[name] = a
        dtype_of = {n: np.int16 if n in self._packing else np.float32 for n in shapes}
        if self.file_format == "classic":
            self._open_classic(path, shapes, days - base, lat, lon, time_attrs,
                               var_attrs, dtype_of)
            return
        self._f = h5py.File(path, "w")
        tds = self._f.create_dataset("time", data=days - base)
        tds.attrs.update(time_attrs)
        if lat is not None:
            self._f.create_dataset("lat", data=np.asarray(lat, np.float32))
        if lon is not None:
            self._f.create_dataset("lon", data=np.asarray(lon, np.float32))
        comp = {}
        if compression == "gzip":
            comp = {"compression": "gzip", "compression_opts": 1}
        elif compression == "lzf":
            comp = {"compression": "lzf"}
        self._ds = {}
        for name, shape in shapes.items():
            if shape[0] == 0:
                # empty time range (e.g. an idle process's part file in a
                # many-process serve): chunks must be positive, so create
                # the zero-length dataset contiguous/uncompressed
                ds = self._f.create_dataset(name, shape=shape, dtype=dtype_of[name])
            else:
                chunk = (min(time_chunk, shape[0]),) + tuple(shape[1:])
                ds = self._f.create_dataset(name, shape=shape, dtype=dtype_of[name],
                                            chunks=chunk, **comp)
            ds.attrs.update(var_attrs[name])
            self._ds[name] = ds

    def _open_classic(self, path, shapes, days, lat, lon, time_attrs, var_attrs, dtype_of):
        dims = {"time": len(days)}
        names = {4: ("time", "member", "rlat", "rlon"), 3: ("time", "rlat", "rlon")}
        for shape in shapes.values():
            for d, n in zip(names[len(shape)], shape):
                if dims.setdefault(d, n) != n:
                    raise ValueError(f"variables disagree on the length of {d!r}: {shapes}")
        grid = [np.asarray(a, np.float32) for a in (lat, lon) if a is not None]
        if grid:
            dims.setdefault("rlat", grid[0].shape[0])
            dims.setdefault("rlon", grid[0].shape[1])
        variables = {"time": (("time",), np.float64, time_attrs)}
        for key, a in (("lat", lat), ("lon", lon)):
            if a is not None:
                variables[key] = (("rlat", "rlon"), np.float32, {})
        for name, shape in shapes.items():
            variables[name] = (names[len(shape)], dtype_of[name], var_attrs[name])
        self._f = netcdf_classic.ClassicWriter(path, dims, variables)
        self._f.write("time", 0, days)
        for key, a in (("lat", lat), ("lon", lon)):
            if a is not None:
                self._f.write(key, 0, np.asarray(a, np.float32))
        self._ds = None

    def append(self, fields: Dict[str, np.ndarray], t0: int) -> None:
        """Write each variable's chunk at time offset ``t0``."""
        for name, arr in fields.items():
            arr = np.asarray(arr)
            if name in self._packing:
                if arr.dtype != np.int16:  # host-side pack of float input
                    lo, hi = self._packing[name]
                    arr = pack_int16(arr, lo, hi)
            else:
                arr = arr.astype(np.float32, copy=False)
            if self._ds is None:
                self._f.write(name, t0, arr)
            else:
                self._ds[name][t0:t0 + arr.shape[0]] = arr

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
