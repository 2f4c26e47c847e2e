"""The port's host tools on the CPU against the JAX package's: the sweep
runner (``train/sweep.py``: grid expansion, the metric lookup in results and
metrics files, a stubbed grid, a real micro-sweep through the port's
trainer and its command line) and the EDA (``eda/climex_eda.py``: seasonal
statistics, annual cycles, Spearman maps and lagged autocorrelations, on
the same netCDF files, and its plots). Both packages' tools are numpy on the
host, so their results are compared for equality."""

import json
import os

import numpy as np
import pytest
import torch
from scipy import stats as sps

from probunet_torch.config import Config as TConfig
from probunet_torch.eda import ClimexEDA as TEDA
from probunet_torch.eda import spearman_corr as t_spearman
from probunet_torch.eda.climex_eda import SEASONS
from probunet_torch.eda.climex_eda import season_of_doy as t_season
from probunet_torch.train import sweep as tsweep
from probunet_tpu.config import Config as JConfig
from probunet_tpu.eda import ClimexEDA as JEDA
from probunet_tpu.eda.climex_eda import season_of_doy as j_season
from probunet_tpu.train import sweep as jsweep


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write(tmp_path, text, name="sweep.yaml"):
    p = os.path.join(str(tmp_path), name)
    with open(p, "w") as f:
        f.write(text)
    return p


GRID = """
method: grid
metric: {name: val-loss, goal: minimize}
parameters:
  batch_size: {values: [4, 8]}
  beta: {values: [0.1, 1.0]}
  latent_dim: {values: [2, 4, 6]}
"""


# ---- sweeps ------------------------------------------------------------------------

def test_grid_points_and_metric_name_match_jax(tmp_path):
    p = _write(tmp_path, GRID)
    sweep = tsweep.load_sweep(p)
    assert sweep == jsweep.load_sweep(p)
    pts = tsweep.grid_points(sweep)
    assert pts == jsweep.grid_points(sweep) and len(pts) == 12
    assert {"batch_size": 8, "beta": 0.1, "latent_dim": 4} in pts
    assert tsweep._metric_name(sweep) == jsweep._metric_name(sweep) == "val_loss"
    assert tsweep._metric_name({}) == "val_loss"


@pytest.mark.parametrize("goal", ["minimize", "maximize"])
def test_run_sweep_with_a_stub_matches_jax(tmp_path, goal):
    p = _write(tmp_path, GRID.replace("minimize", goal))
    out = {}
    for name, mod, cfg_cls in (("port", tsweep, TConfig), ("jax", jsweep, JConfig)):
        base = cfg_cls(plotdir=os.path.join(str(tmp_path), name),
                       checkpoints_dir=os.path.join(str(tmp_path), name + "_ckpt"))
        seen = []

        def fake_train(cfg, seen=seen):
            seen.append((cfg.batch_size, cfg.beta, cfg.latent_dim, os.path.basename(cfg.plotdir)))
            return {"val_losses": [cfg.batch_size * cfg.beta + 0.01 * cfg.latent_dim]}

        path = os.path.join(str(tmp_path), f"{name}.json")
        out[name] = (mod.run_sweep(p, base, out_path=path, train_fn=fake_train), seen)
        with open(path) as f:
            assert json.load(f) == out[name][0]
    assert out["port"] == out["jax"]
    want = {"batch_size": 8, "beta": 1.0, "latent_dim": 6} if goal == "maximize" else \
        {"batch_size": 4, "beta": 0.1, "latent_dim": 2}
    assert out["port"][0]["best"]["point"] == want
    assert out["port"][1][3][3] == "sweep_3"


def test_resolve_metric_matches_jax(tmp_path):
    """Results and metrics files: val_loss from a list, mae_<var> from the
    baselines' per-variable dict (whose val_losses dict falls through to the
    files), any key from the last JSONL record holding it, a clear error
    when it is nowhere."""
    plotdir = os.path.join(str(tmp_path), "run")
    os.makedirs(plotdir)
    with open(os.path.join(plotdir, "metrics_baseline.jsonl"), "w") as f:
        for rec in ({"train_loss": 1.0, "step": 1}, {"crps_pr": 10.0, "step": 2},
                    {"crps_pr": 2.5, "eval_pr": 0.3, "step": 4}):
            f.write(json.dumps(rec) + "\n")
    baseline = {"val_losses": {"pr": [1.0]}, "tr_losses": {"pr": [0.5]},
                "mae": {"pr": 3.0, "tasmin": 1.5}, "samples_per_sec": 12.0}
    cases = [({"val_losses": [0.9, 0.4]}, "val_loss"), (baseline, "mae_tasmin"),
             (baseline, "samples_per_sec"), (baseline, "crps_pr"), (baseline, "eval_pr")]
    for result, metric in cases:
        t = tsweep._resolve_metric(result, metric, TConfig(plotdir=plotdir))
        assert t == jsweep._resolve_metric(result, metric, JConfig(plotdir=plotdir)), metric
    assert tsweep._resolve_metric(baseline, "crps_pr", TConfig(plotdir=plotdir)) == 2.5
    for mod, cfg in ((tsweep, TConfig), (jsweep, JConfig)):
        with pytest.raises(KeyError, match="not found"):
            mod._resolve_metric(baseline, "val_loss", cfg(plotdir=os.path.join(plotdir, "x")))


def test_micro_sweep_through_the_port_trainer(tmp_path, datadir_small):
    """A real grid over the LinearCNN baseline through
    ``python -m probunet_torch.train.sweep`` (its ``main``, in this process,
    ``--device cpu``, no wandb agent), minimizing the final ``mae_pr``; then
    one run of the prob-U-Net default through ``run_sweep``, minimizing
    ``val_loss``."""
    p = _write(tmp_path, """
method: grid
metric: {name: mae_pr, goal: minimize}
parameters:
  lr: {values: [0.001, 0.01]}
""")
    flags = ["--datadir", datadir_small, "--years_train", "2000,2001", "--years_val", "2001,2002",
             "--years_test", "2002,2003", "--coords", "0,16,0,16", "--resolution", "16,16",
             "--batch_size", "4", "--num_epochs", "1", "--plotdir",
             os.path.join(str(tmp_path), "plots"), "--checkpoints_dir",
             os.path.join(str(tmp_path), "ckpt")]
    out = os.path.join(str(tmp_path), "res.json")
    res = tsweep.main(["--sweep", p, "--out", out, "--agent", "false", "--device", "cpu",
                       "--ds_model", "linearcnn"] + flags)
    assert [r["point"] for r in res["runs"]] == [{"lr": 0.001}, {"lr": 0.01}]
    assert all(np.isfinite(r["value"]) and r["value"] > 0 for r in res["runs"])
    assert res["best"]["value"] == min(r["value"] for r in res["runs"])
    assert os.path.exists(os.path.join(str(tmp_path), "ckpt", "sweep_1", "linearcnn", "state",
                                       "state.pt"))
    with open(out) as f:
        assert json.load(f)["metric"] == "mae_pr"
    one = _write(tmp_path, "parameters:\n  latent_dim: {values: [2]}\n", "one.yaml")
    cfg = TConfig(datadir=datadir_small, years_train=(2000, 2001), years_val=(2001, 2002),
                  years_test=(2002, 2003), coords=(0, 16, 0, 16), resolution=(16, 16),
                  batch_size=4, num_epochs=1, num_filters=(8,), model_channels=8,
                  channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,),
                  plotdir=os.path.join(str(tmp_path), "p2"),
                  checkpoints_dir=os.path.join(str(tmp_path), "c2"))
    res = tsweep.run_sweep(one, cfg, device="cpu")
    assert res["metric"] == "val_loss" and np.isfinite(res["best"]["value"])


# ---- EDA ---------------------------------------------------------------------------

def test_spearman_and_seasons():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(200)
    y = 0.5 * x + rng.standard_normal(200)
    np.testing.assert_allclose(t_spearman(x, y), sps.spearmanr(x, y).statistic, rtol=1e-6)
    field = rng.standard_normal((4, 5, 100))
    out = t_spearman(field, y[None, None, :100])
    assert out.shape == (4, 5)
    np.testing.assert_allclose(out[2, 3], sps.spearmanr(field[2, 3], y[:100]).statistic,
                               rtol=1e-6)
    doy = np.arange(800)
    np.testing.assert_array_equal(t_season(doy), j_season(doy))
    assert [t_season(np.array([d]))[0] for d in (0, 59, 180, 364)] == ["DJF", "MAM", "JJA", "DJF"]


@pytest.fixture(scope="module")
def eda(tmp_path_factory):
    from probunet_tpu.data.synthetic import generate_climex_like

    d = str(tmp_path_factory.mktemp("climex_eda"))
    generate_climex_like(d, years=(2000, 2001), grid=16, days_per_year=365)
    kw = dict(years=[2000, 2001], coords=(0, 16, 0, 16))
    return TEDA(d, **kw), JEDA(d, **kw)


def _equal(a, b):
    """Nested dicts of arrays, equal bit for bit (the same numpy code on the
    same file contents)."""
    assert type(a) is type(b) or isinstance(a, np.ndarray)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stat", ["mean", "median", "1st-quartile", "3rd-quartile", "min", "max"])
def test_seasonal_statistics_match_jax(eda, stat):
    t, j = eda
    out = t.interannual_stat_ppp_seasonal(stat)
    _equal(out, j.interannual_stat_ppp_seasonal(stat))
    assert out["pr"]["JJA"].shape == (16, 16)
    with pytest.raises(ValueError):
        t.interannual_stat_ppp_seasonal("mode")


def test_cycles_correlations_and_plots_match_jax(eda):
    t, j = eda
    for dim in ("rlat", "rlon"):
        out = t.annual_cycle_along_dim(dim)
        _equal(out, j.annual_cycle_along_dim(dim))
        assert out["tasmin"].shape == (365, 16)
    with pytest.raises(ValueError):
        t.annual_cycle_along_dim("bogus")
    corr = t.spearmancorr_seasonal_fop(pxl_coords=(8, 8))
    _equal(corr, j.spearmancorr_seasonal_fop(pxl_coords=(8, 8)))
    for s in SEASONS:
        np.testing.assert_allclose(corr["tasmin"][s][8, 8], 1.0, atol=1e-5)
    auto = t.autocorr_spearman_lag_ppp(pxl_coords=(8, 8), max_lag=5)
    _equal(auto, j.autocorr_spearman_lag_ppp(pxl_coords=(8, 8), max_lag=5))
    with pytest.raises(ValueError):
        t.spearmancorr_seasonal_fop(pxl_coords=(100, 8))
    np.testing.assert_array_equal(t.lat, j.lat)

    from probunet_torch.viz.plots import _plt
    _, (fig, axs) = t.interannual_stat_ppp_seasonal("mean", plot=True)
    assert axs.shape == (3, 4)
    _, (fig, _) = t.spearmancorr_seasonal_fop(pxl_coords=(8, 8), plot=True)
    _, (fig, _) = t.autocorr_spearman_lag_ppp(pxl_coords=(8, 8), max_lag=3, plot=True)
    _, (fig, _) = t.annual_cycle_along_dim("rlon", plot=True)
    fig.savefig(os.path.join(os.path.dirname(t.datadir), "cycle.png"))
    _plt().close("all")
