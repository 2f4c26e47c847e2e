"""Exploratory data analysis over the ClimEx domain —
``probunet_tpu/eda/climex_eda.py`` (reference ``climexEDA``,
climex_utils.py:517-846).

- seasonal per-pixel interannual statistics (mean/median/quartiles/min/max)
- day-of-year annual-cycle profiles along rlat or rlon
- Spearman correlation of every pixel against a reference pixel, by season
- lagged (1-30 day) Spearman autocorrelation of a pixel, by season
- seasonal grid plots with the reference's colormaps

Offline analysis on the host in numpy, with no device work: it streams
over the per-year files through :class:`~probunet_torch.data.netcdf.NetCDFFile`,
so the full domain over all years never has to fit in memory at once. Rank
transforms use scipy where it is installed, else a numpy fallback.
Matplotlib is imported when a figure is drawn.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from probunet_torch.data.netcdf import NetCDFFile, discover_files
from probunet_torch.data.units import k_to_c, kgm2s_to_mmday

try:
    from scipy.stats import rankdata as _rankdata

    def rankdata(x, axis=-1):
        return _rankdata(x, axis=axis)
except ImportError:  # pragma: no cover
    def rankdata(x, axis=-1):
        """Ordinal ranks 1..n along ``axis`` (ties not averaged)."""
        order = np.argsort(x, axis=axis)
        ranks = np.empty_like(order, dtype=np.float64)
        np.put_along_axis(ranks, order,
                          np.broadcast_to(np.arange(1, x.shape[axis] + 1, dtype=np.float64),
                                          x.shape), axis=axis)
        return ranks


SEASONS = ("DJF", "MAM", "JJA", "SON")
# month of each day in a 365-day (noleap) year
_MONTH_LEN = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
_DOY_MONTH = np.repeat(np.arange(1, 13), _MONTH_LEN)
_SEASON_OF_MONTH = {12: "DJF", 1: "DJF", 2: "DJF", 3: "MAM", 4: "MAM", 5: "MAM",
                    6: "JJA", 7: "JJA", 8: "JJA", 9: "SON", 10: "SON", 11: "SON"}


def season_of_doy(doy: np.ndarray) -> np.ndarray:
    """Season label per day-of-year index (0-based, noleap)."""
    months = _DOY_MONTH[np.asarray(doy) % 365]
    return np.array([_SEASON_OF_MONTH[m] for m in months])


def spearman_corr(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Spearman correlation along the last axis, with broadcasting
    (reference spearman_gufunc, climex_utils.py:679-690)."""
    xr_ = rankdata(x, axis=-1)
    yr_ = rankdata(y, axis=-1)
    xm = xr_ - xr_.mean(axis=-1, keepdims=True)
    ym = yr_ - yr_.mean(axis=-1, keepdims=True)
    cov = (xm * ym).mean(axis=-1)
    return cov / (xr_.std(axis=-1) * yr_.std(axis=-1))


def _physical(field, var: str) -> np.ndarray:
    field = np.asarray(field)
    return kgm2s_to_mmday(field) if var == "pr" else k_to_c(field)


class ClimexEDA:
    def __init__(self, datadir: str, years: Sequence[int] = range(1960, 2099),
                 variables: Sequence[str] = ("pr", "tasmin", "tasmax"),
                 coords: Sequence[int] = (0, 280, 0, 280)):
        self.datadir = datadir
        self.years = list(years)
        self.variables = tuple(variables)
        self.nvars = len(self.variables)
        self.coords = tuple(coords)
        self._rlon = slice(coords[0], coords[1])
        self._rlat = slice(coords[2], coords[3])
        self.files = discover_files(datadir, self.years, self.variables)
        with NetCDFFile(self.files[0][2]) as f:
            lat = f.read_var("lat", (self._rlat, self._rlon))
            lon = f.read_var("lon", (self._rlat, self._rlon))
        self.lat = lat[0] if lat.ndim == 3 else lat
        self.lon = lon[0] if lon.ndim == 3 else lon

    # ---- streaming iteration ----
    def _iter_year(self, var: str):
        """Yield (year, (T, H, W) array, doy (T,)) one file at a time."""
        for year, v, path in self.files:
            if v != var:
                continue
            with NetCDFFile(path) as f:
                data = f.read_var(var, (self._rlat, self._rlon))
            yield year, data, np.arange(data.shape[0]) % 365

    # ---- seasonal per-pixel interannual statistics ----
    def interannual_stat_ppp_seasonal(self, stat: str = "mean", plot: bool = False):
        """Per-pixel seasonal statistic over all years (reference
        climex_utils.py:586-614). Returns {var: {season: (H, W)}};
        mean/min/max stream in O(1) memory, median/quartiles gather the
        season's values."""
        out: Dict[str, Dict[str, np.ndarray]] = {}
        exact = stat in ("median", "1st-quartile", "3rd-quartile")
        q = {"median": 0.5, "1st-quartile": 0.25, "3rd-quartile": 0.75}.get(stat)
        for var in self.variables:
            acc: Dict[str, List] = {s: [] for s in SEASONS}
            cnt: Dict[str, int] = {s: 0 for s in SEASONS}
            run: Dict[str, np.ndarray] = {}
            for _, data, doy in self._iter_year(var):
                seasons = season_of_doy(doy)
                for s in SEASONS:
                    sel = data[seasons == s]
                    if sel.size == 0:
                        continue
                    if exact:
                        acc[s].append(sel)
                    elif stat == "mean":
                        run[s] = run.get(s, 0) + sel.sum(axis=0)
                        cnt[s] += sel.shape[0]
                    elif stat == "min":
                        m = sel.min(axis=0)
                        run[s] = m if s not in run else np.minimum(run[s], m)
                    elif stat == "max":
                        m = sel.max(axis=0)
                        run[s] = m if s not in run else np.maximum(run[s], m)
                    else:
                        raise ValueError("Received unknown statistics")
            if exact:
                out[var] = {s: np.quantile(np.concatenate(acc[s], axis=0), q, axis=0)
                            for s in SEASONS}
            elif stat == "mean":
                out[var] = {s: run[s] / cnt[s] for s in SEASONS}
            else:
                out[var] = {s: run[s] for s in SEASONS}
        if plot:
            return out, self.plot_grids_seasonal(out, f"Interannual seasonal {stat}")
        return out

    # ---- annual cycle profiles ----
    def annual_cycle_along_dim(self, dim: str = "rlat", plot: bool = False):
        """Day-of-year profile along one spatial dim, averaged over the other
        dim and all years (reference climex_utils.py:617-676). Returns
        {var: (365, len(dim))}."""
        if dim == "rlat":
            avg_axis = 2  # average over rlon -> profile over rlat
        elif dim == "rlon":
            avg_axis = 1
        else:
            raise ValueError("unrecognized dimension")
        out = {}
        for var in self.variables:
            total = None
            count = np.zeros(365)
            for _, data, doy in self._iter_year(var):
                prof = data.mean(axis=avg_axis)  # (T, len(dim))
                if total is None:
                    total = np.zeros((365, prof.shape[1]))
                np.add.at(total, doy, prof)
                np.add.at(count, doy, 1)
            out[var] = total / np.maximum(count, 1)[:, None]
        if plot:
            return out, self._plot_annual_cycle(out, dim)
        return out

    # ---- Spearman correlation against a reference pixel ----
    def spearmancorr_seasonal_fop(self, pxl_coords: Sequence[int] = (32, 32),
                                  plot: bool = False):
        """Seasonal Spearman correlation map of every pixel against one pixel
        (reference climex_utils.py:693-732). Returns {var: {season: (H, W)}}."""
        py, px = self._check_pixel(pxl_coords)
        out = {}
        for var in self.variables:
            chunks: Dict[str, List[np.ndarray]] = {s: [] for s in SEASONS}
            for _, data, doy in self._iter_year(var):
                seasons = season_of_doy(doy)
                for s in SEASONS:
                    sel = data[seasons == s]
                    if sel.size:
                        chunks[s].append(sel)
            out[var] = {}
            for s in SEASONS:
                series = np.concatenate(chunks[s], axis=0)       # (Ts, H, W)
                ref = series[:, py, px]
                field = np.moveaxis(series, 0, -1)               # (H, W, Ts)
                out[var][s] = spearman_corr(field, ref[None, None, :]).astype(np.float32)
        if plot:
            title = (f"Spearman correlation for latitude = {self.lat[py, px]}° "
                     f"and longitude = {self.lon[py, px]}°")
            return out, self.plot_grids_seasonal(out, title, correlation=True)
        return out

    # ---- lagged Spearman autocorrelation of a pixel ----
    def autocorr_spearman_lag_ppp(self, pxl_coords: Sequence[int] = (140, 140),
                                  max_lag: int = 30, plot: bool = False):
        """Seasonal Spearman autocorrelation at lags 1..max_lag days of one
        pixel (reference climex_utils.py:735-794). Returns
        {var: {season: (max_lag,)}}."""
        py, px = self._check_pixel(pxl_coords)
        out = {}
        for var in self.variables:
            series, doys = [], []
            for _, data, doy in self._iter_year(var):
                series.append(data[:, py, px])
                doys.append(doy)
            x = np.concatenate(series)
            seasons = season_of_doy(np.concatenate(doys))
            out[var] = {}
            for s in SEASONS:
                mask = seasons == s
                vals = np.empty(max_lag, np.float32)
                for lag in range(1, max_lag + 1):
                    # pair x[t] (in season) with x[t - lag], the reference's
                    # shift-then-correlate semantics
                    m = mask.copy()
                    m[:lag] = False
                    vals[lag - 1] = spearman_corr(x[m], x[np.flatnonzero(m) - lag])
                out[var][s] = vals
        if plot:
            return out, self._plot_autocorr(out, max_lag, (py, px))
        return out

    def _check_pixel(self, pxl_coords):
        c = self.coords
        if (pxl_coords[0] < c[0] or pxl_coords[0] > c[1]
                or pxl_coords[1] < c[2] or pxl_coords[1] > c[3]):
            raise ValueError("Rotated coordinates incorrect")
        return pxl_coords[0] - c[0], pxl_coords[1] - c[2]

    # ---- plotting ----
    def plot_grids_seasonal(self, dataset, title: str, correlation: bool = False):
        """One row of seasonal maps per variable (physical units, or the
        correlation), a colorbar per row. Returns (fig, axes)."""
        from probunet_torch.viz.plots import _cmaps, _make_axes, _panel, _plt

        plt = _plt()
        cmaps = _cmaps()
        fig = plt.figure(figsize=(15, 10), constrained_layout=True)
        axs = _make_axes(fig, self.nvars, len(SEASONS))
        for i, var in enumerate(self.variables):
            fields = dataset[var]
            if correlation:
                cmap, unit = plt.get_cmap("gist_rainbow"), ""
                vmin = min(np.nanmin(fields[s]) for s in SEASONS)
                vmax = 1.0
            elif var == "pr":
                cmap, unit = cmaps["pr"], " (mm/day)"
                fields = {s: _physical(fields[s], var) for s in SEASONS}
                vmin, vmax = 0, max(np.nanmax(fields[s]) for s in SEASONS)
            else:
                cmap, unit = cmaps["temp"], " (°C)"
                fields = {s: _physical(fields[s], var) for s in SEASONS}
                m = max(max(abs(np.nanmin(fields[s])), abs(np.nanmax(fields[s])))
                        for s in SEASONS)
                vmin, vmax = -m, m
            for j, s in enumerate(SEASONS):
                if i == 0:
                    axs[i, j].set_title(s, fontsize=14)
                im = _panel(axs[i, j], self.lon, self.lat, fields[s], cmap, vmin, vmax)
            cbar = plt.colorbar(im, ax=list(axs[i, :]), shrink=0.8)
            cbar.set_label(var + unit, fontsize=14)
        fig.suptitle(title, fontsize=18)
        return fig, axs

    def _plot_annual_cycle(self, out, dim):
        import matplotlib as mpl

        from probunet_torch.viz.plots import _plt

        plt = _plt()
        fig, axs = plt.subplots(1, self.nvars, figsize=(15, 5), constrained_layout=True)
        axs = np.atleast_1d(axs)
        cmap = plt.get_cmap("viridis")
        for v, var in enumerate(self.variables):
            data = _physical(out[var], var)
            n = data.shape[1]
            norm = mpl.colors.Normalize(vmin=0, vmax=n - 1)
            for k in range(n):
                axs[v].plot(data[:, k], color=cmap(norm(k)), lw=1)
            axs[v].set_ylabel(var + (" (mm/day)" if var == "pr" else " (°C)"))
            axs[v].set_xlabel("day of year")
        cbar = plt.colorbar(mpl.cm.ScalarMappable(norm=norm, cmap=cmap), ax=axs[-1])
        cbar.set_label(dim)
        fig.suptitle(f"Annual cycle over {dim}", fontsize=18)
        return fig, axs

    def _plot_autocorr(self, out, max_lag, pixel):
        from probunet_torch.viz.plots import _plt

        plt = _plt()
        fig, axs = plt.subplots(self.nvars, len(SEASONS), figsize=(15, 10),
                                constrained_layout=True)
        axs = np.atleast_2d(axs)
        for i, var in enumerate(self.variables):
            for j, s in enumerate(SEASONS):
                axs[i, j].bar(x=range(1, max_lag + 1), height=out[var][s], width=0.1,
                              color="black")
                axs[i, j].set_ylim(-0.2, 1.0)
                axs[i, j].axhline(y=0.05, color="blue", linestyle="--", lw=1)
                axs[i, j].axhline(color="black", lw=1)
                axs[i, j].axhline(y=-0.05, color="blue", linestyle="--", lw=1)
                axs[i, j].set_xlabel("Lags in days")
                if i == 0:
                    axs[i, j].set_title(s)
            axs[i, 0].set_ylabel(f"Spearman autocorrelation for {var}")
        fig.suptitle(f"Spearman autocorrelation with lags at pixel {pixel}", fontsize=18)
        return fig, axs
