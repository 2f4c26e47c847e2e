"""Map plotting (reference climex_utils.py:214-512) — a copy of
``probunet_tpu/viz/plots.py`` on numpy arrays.

Same figure semantics as the reference — per-variable colormaps (custom
6-color precipitation map, RdBu_r temperatures, gist_heat_r errors), physical
units (mm/day, deg C), shared symmetric color limits across tasmin/tasmax, the
LR | prediction(s) | HR | abs-error column layout, and per-date suptitles.

matplotlib is imported when a figure is drawn, not with this module: the
port runs without it until a plot is asked for. Cartopy is optional: when
available, panels are drawn on the ClimEx RotatedPole(pole_longitude=83.0,
pole_latitude=42.5) projection with coastlines/gridlines exactly like the
reference; otherwise plain axes with lat/lon pcolormesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from probunet_torch.data.units import float_to_date, k_to_c, kgm2s_to_mmday


def _plt():
    """matplotlib's pyplot on the Agg backend (no display needed)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _ccrs():
    """cartopy's crs module, or None where cartopy is missing."""
    try:
        from cartopy import crs
    except ImportError:
        return None
    return crs


# reference climex_utils.py:225-233
_PREP_COLORS = [
    (1.0, 1.0, 1.0),
    (0.5, 0.88, 1.0),
    (0.1, 0.15, 0.8),
    (0.39, 0.09, 0.66),
    (0.85, 0.36, 0.14),
    (0.99, 0.91, 0.3),
]


def _cmaps():
    import matplotlib as mpl

    plt = _plt()
    prep = mpl.colors.LinearSegmentedColormap.from_list("prep", _PREP_COLORS)
    return {"pr": prep, "temp": plt.get_cmap("RdBu_r"), "error": plt.get_cmap("gist_heat_r")}


def _make_axes(subfig, nrows, ncols):
    ccrs = _ccrs()
    if ccrs is not None:
        proj = ccrs.RotatedPole(pole_longitude=83.0, pole_latitude=42.5)
        axs = subfig.subplots(nrows, ncols, subplot_kw={"projection": proj},
                              gridspec_kw={"wspace": 0.01, "hspace": 0.005})
    else:
        axs = subfig.subplots(nrows, ncols, gridspec_kw={"wspace": 0.01, "hspace": 0.005})
    return np.atleast_2d(axs)


def _panel(ax, lon, lat, field, cmap, vmin, vmax):
    ccrs = _ccrs()
    if ccrs is not None:
        transform = ccrs.PlateCarree()
        im = ax.pcolormesh(lon, lat, field, cmap=cmap, vmin=vmin, vmax=vmax,
                           transform=transform)
        ax.coastlines()
        # labeled gridlines, top/right hidden (climex_utils.py:271-273)
        gl = ax.gridlines(crs=transform, draw_labels=True, x_inline=False,
                          y_inline=False, linestyle="--")
        gl.top_labels = False
        gl.right_labels = False
    else:
        im = ax.pcolormesh(lon, lat, field, cmap=cmap, vmin=vmin, vmax=vmax)
        ax.set_xticks([])
        ax.set_yticks([])
    return im


def _to_physical(field, var):
    field = np.asarray(field)
    return kgm2s_to_mmday(field) if var == "pr" else np.asarray(k_to_c(field))


def _date_str(ts) -> str:
    try:
        return str(float_to_date(float(ts)))[:10]
    except Exception:
        return str(ts)


def plot_batch(lrinterp, hr_pred, hr, timestamps, epoch, variables: Sequence[str],
               lat=None, lon=None, N: int = 2):
    """LR | prediction | HR | abs-error grid per variable per date
    (reference climex_utils.py:214-361). Arrays are NHWC."""
    plt = _plt()
    lrinterp, hr_pred, hr = (np.asarray(a) for a in (lrinterp, hr_pred, hr))
    nvars = len(variables)
    N = min(N, lrinterp.shape[0])
    if lat is None or lon is None:
        h, w = lrinterp.shape[1:3]
        lat, lon = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cmaps = _cmaps()

    fig = plt.figure(figsize=(N * 18, 12), constrained_layout=True)
    subfigs = np.atleast_1d(fig.subfigures(1, N, wspace=0.05))
    all_axs = []
    for j in range(N):
        axs = _make_axes(subfigs[j], nvars, 4)
        all_axs.append(axs)
        temp_ims, temp_max_abs = [], []
        for i, var in enumerate(variables):
            lr_s = _to_physical(lrinterp[j, ..., i], var)
            pred_s = _to_physical(hr_pred[j, ..., i], var)
            hr_s = _to_physical(hr[j, ..., i], var)
            err = np.abs(hr_s - pred_s)
            if var == "pr":
                cmap, unit = cmaps["pr"], " (mm/day)"
                vmin, vmax = 0.0, max(lr_s.max(), pred_s.max(), hr_s.max())
            else:
                cmap, unit = cmaps["temp"], " (°C)"
                max_abs = max(np.abs(lr_s).max(), np.abs(pred_s).max(), np.abs(hr_s).max())
                vmin, vmax = -max_abs, max_abs
                temp_max_abs.append(max_abs)
            ims = [
                _panel(axs[i, 0], lon, lat, lr_s, cmap, vmin, vmax),
                _panel(axs[i, 1], lon, lat, pred_s, cmap, vmin, vmax),
                _panel(axs[i, 2], lon, lat, hr_s, cmap, vmin, vmax),
            ]
            cbar = plt.colorbar(ims[2], ax=list(axs[i, :3]), shrink=0.8,
                                extend="max" if var == "pr" else "both")
            cbar.set_label(var + unit, fontsize=14)
            im_err = _panel(axs[i, 3], lon, lat, err, cmaps["error"], 0, err.max())
            cbar_e = plt.colorbar(im_err, ax=axs[i, 3], shrink=0.8, extend="max")
            cbar_e.set_label(var + unit, fontsize=14)
            if var != "pr":
                temp_ims.append(ims)
        if temp_max_abs:
            shared = float(np.max(temp_max_abs))  # shared clim across tasmin/tasmax
            for ims in temp_ims:
                for im in ims:
                    im.set_clim(vmin=-shared, vmax=shared)
        subfigs[j].suptitle(_date_str(timestamps[j]), fontsize=16)
        axs[0, 0].set_title("Low-resolution", fontsize=14)
        axs[0, 1].set_title("Prediction", fontsize=14)
        axs[0, 2].set_title("High-resolution", fontsize=14)
        axs[0, 3].set_title("Absolute error", fontsize=14)
    fig.suptitle(f"Predictions after the {epoch}th epoch for {N} random test dates",
                 fontsize=18, fontweight="bold")
    return fig, all_axs


def plot_sample_batch(lrinterp, hr_preds, hr, timestamps, epoch, variables: Sequence[str],
                      lat=None, lon=None, N: int = 2, num_samples: int = 3):
    """LR | K predictions | HR per variable (reference climex_utils.py:364-512).
    hr_preds: (B, K, H, W, C)."""
    plt = _plt()
    lrinterp, hr_preds, hr = (np.asarray(a) for a in (lrinterp, hr_preds, hr))
    nvars = len(variables)
    N = min(N, lrinterp.shape[0])
    num_samples = min(num_samples, hr_preds.shape[1])
    total_cols = num_samples + 2
    if lat is None or lon is None:
        h, w = lrinterp.shape[1:3]
        lat, lon = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cmaps = _cmaps()

    fig = plt.figure(figsize=(total_cols * 6, N * nvars * 4), constrained_layout=True)
    subfigs = np.atleast_1d(fig.subfigures(N, 1, hspace=0.1))
    last_axs = None
    for j in range(N):
        axs = _make_axes(subfigs[j], nvars, total_cols)
        last_axs = axs
        temp_ims, temp_max_abs = [], []
        for i, var in enumerate(variables):
            lr_s = _to_physical(lrinterp[j, ..., i], var)
            hr_s = _to_physical(hr[j, ..., i], var)
            preds = [_to_physical(hr_preds[j, s, ..., i], var) for s in range(num_samples)]
            if var == "pr":
                cmap, unit, extend = cmaps["pr"], " (mm/day)", "max"
                vmin = 0.0
                vmax = max(lr_s.max(), hr_s.max(), max(p.max() for p in preds))
            else:
                cmap, unit, extend = cmaps["temp"], " (°C)", "both"
                max_abs = max(np.abs(lr_s).max(), np.abs(hr_s).max(),
                              max(np.abs(p).max() for p in preds))
                vmin, vmax = -max_abs, max_abs
                temp_max_abs.append(max_abs)
            _panel(axs[i, 0], lon, lat, lr_s, cmap, vmin, vmax)
            axs[i, 0].set_title("Low-resolution", fontsize=14)
            for s in range(num_samples):
                im = _panel(axs[i, s + 1], lon, lat, preds[s], cmap, vmin, vmax)
                axs[i, s + 1].set_title(f"Prediction {s + 1}", fontsize=14)
                if var != "pr":
                    temp_ims.append(im)
            im = _panel(axs[i, -1], lon, lat, hr_s, cmap, vmin, vmax)
            axs[i, -1].set_title("High-resolution", fontsize=14)
            if var != "pr":
                temp_ims.append(im)
            cbar = plt.colorbar(im, ax=list(axs[i, :]), orientation="vertical",
                                shrink=0.8, extend=extend)
            cbar.set_label(var + unit, fontsize=14)
        if temp_max_abs:
            shared = float(np.max(temp_max_abs))
            for im in temp_ims:
                im.set_clim(vmin=-shared, vmax=shared)
        subfigs[j].suptitle(f"Sample {j + 1}: {_date_str(timestamps[j])}", fontsize=16)
    fig.suptitle(f"Predictions after the {epoch}th epoch", fontsize=18, fontweight="bold")
    return fig, last_axs


def plot_loss_curves(tr_losses, val_losses, path: Optional[str] = None,
                     ylabel: str = "Loss", title: str = "Training and Validation Loss"):
    """Loss-curve PNG (reference main.py:137-145)."""
    plt = _plt()
    fig = plt.figure(figsize=(15, 10))
    plt.plot(tr_losses, lw=2, label="Training Loss")
    plt.plot(val_losses, lw=2, linestyle="dashed", label="Validation Loss")
    plt.xlabel("Epochs")
    plt.ylabel(ylabel)
    plt.title(title)
    plt.legend()
    if path:
        fig.savefig(path, dpi=150)
        plt.close(fig)
    return fig
