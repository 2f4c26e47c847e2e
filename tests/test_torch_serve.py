"""The port's serving slice end to end on the CPU: the same synthetic netCDF
and the same weights through the JAX ``serve.downscale`` and the port's
``downscale(device="cpu")``, compared file against file."""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probunet_torch import serve as tserve
from probunet_torch.config import Config as TConfig
from probunet_torch.data import netcdf as tnc
from probunet_torch.data import synthetic as tsyn
from probunet_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from probunet_torch.train.loop import build_probunet as t_build
from probunet_torch.train.state import TrainState
from probunet_torch.utils.device import resolve_device
from probunet_torch.utils.transplant import flax_probunet_to_torch
from probunet_tpu.config import Config
from probunet_tpu.data import netcdf as jnc
from probunet_tpu.data.synthetic import generate_climex_like
from probunet_tpu.serve import downscale as jax_downscale
from probunet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from probunet_tpu.train.loop import build_probunet as jax_build
from probunet_tpu.train.state import create_train_state, make_optimizer

VARS = ("pr", "tasmin", "tasmax")
PACK = {"pr": (0.0, 2e-3), "tasmin": (200.0, 330.0), "tasmax": (200.0, 330.0)}
FLAGS = dict(years_test=(2000, 2001), coords=(0, 16, 0, 16), resolution=(16, 16),
             lowres_scale=4, standardization="pertimestep", latent_dim=4,
             num_filters=(8, 16), model_channels=64, channel_mult=(1, 2), num_blocks=1,
             attn_resolutions=(8,), batch_size=5, num_samples=3, dropout=0.0)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Synthetic data (16x16 grid, 16 days: batches of 5 leave a ragged
    tail), random weights saved as a JAX orbax checkpoint and as a port
    checkpoint. The prior's log-sigma bias is -30, so every member equals the
    prior mean and the two sides' different random draws do not matter."""
    d = str(tmp_path_factory.mktemp("torch_serve"))
    datadir = os.path.join(d, "data")
    generate_climex_like(datadir, years=(2000,), grid=16, days_per_year=16)
    cfg = Config(datadir=datadir, **FLAGS)
    model = jax_build(cfg)
    x0 = jnp.zeros((1, 16, 16, 3))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "latent": jax.random.key(1),
         "dropout": jax.random.key(2)}, x0, x0, method=model.elbo))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) / np.sqrt(
        max(1, int(np.prod(s.shape[:-1]))))).astype(np.float32), shapes)
    params["prior"]["conv_log_sigma"]["bias"] = np.full((4,), -30.0, np.float32)
    tx = make_optimizer(cfg.lr, cfg.weight_decay, cfg.accum, cfg.optimizer,
                        state_dtype=cfg.opt_state_dtype)
    jax_ckpt = os.path.join(d, "jax_ckpt")
    jax_save_checkpoint(jax_ckpt, create_train_state(params, tx))
    tm = t_build(TConfig(datadir=datadir, **FLAGS), device="cpu")
    tm.load_state_dict(flax_probunet_to_torch(params))
    port_ckpt = os.path.join(d, "port_ckpt")
    save_checkpoint(port_ckpt, TrainState(tm, None, 7))  # parameters only
    return d, cfg, jax_ckpt, port_ckpt


def _read(path):
    with h5py.File(path, "r") as f:
        raw = {k: f[k][...] for k in ("time", "lat", "lon") + VARS}
    with tnc.NetCDFFile(path) as f:
        phys = {v: f.read_var(v) for v in VARS}
    return raw, phys


def _compare(jax_path, port_path, atol_of):
    (rj, pj), (rt, pt) = _read(jax_path), _read(port_path)
    for k in ("time", "lat", "lon"):
        np.testing.assert_array_equal(rt[k], rj[k])
    for v in VARS:
        assert pt[v].shape == pj[v].shape == (16, 3, 16, 16)
        assert np.isfinite(pt[v]).all()
        np.testing.assert_allclose(pt[v], pj[v], rtol=1e-4, atol=atol_of(v, pj[v]))


def test_downscale_file_matches_jax(setup):
    d, cfg, jax_ckpt, port_ckpt = setup
    out_j = jax_downscale(cfg, jax_ckpt, os.path.join(d, "jax.nc"), num_samples=3)
    out_t = tserve.downscale(TConfig(**vars(cfg)), port_ckpt, os.path.join(d, "port.nc"),
                             num_samples=3, device="cpu")
    # fp32 on both sides through the ~20 layers of the model and the
    # residual -> HR inverse: 1e-4 relative, with an absolute floor of 1e-4
    # of each field's largest value (precip is O(1e-4) kg m-2 s-1)
    _compare(out_j, out_t, lambda v, ref: 1e-4 * float(np.abs(ref).max()))


def test_downscale_packed_cli_matches_jax(setup):
    """The CLI with --pack: int16 packed on the device; equal to the JAX
    package's packed file within one quantization step."""
    d, cfg, jax_ckpt, port_ckpt = setup
    out_j = jax_downscale(cfg, jax_ckpt, os.path.join(d, "jax_packed.nc"),
                          num_samples=3, pack_ranges=PACK)
    out_t = os.path.join(d, "port_packed.nc")
    argv = ["--checkpoint", port_ckpt, "--out", out_t, "--device", "cpu",
            "--nc_compression", "lzf", "--datadir", cfg.datadir]
    argv += [f"--pack={v}={lo}:{hi}" for v, (lo, hi) in PACK.items()]
    for k, val in FLAGS.items():
        argv += [f"--{k}", ",".join(map(str, val)) if isinstance(val, tuple) else str(val)]
    tserve.main(argv)
    with h5py.File(out_t, "r") as f:
        assert f["pr"].dtype == np.int16
    step = {v: tnc.pack_params(*PACK[v])[0] for v in VARS}
    _compare(out_j, out_t, lambda v, ref: 1.01 * step[v])


def test_checkpoint_roundtrip_and_guards(setup):
    d, cfg, _, port_ckpt = setup
    tcfg = TConfig(**vars(cfg))
    m = t_build(tcfg, device="meta").to_empty(device="cpu")
    assert restore_checkpoint(port_ckpt, TrainState(m, None)).step == 7
    assert m.prior.conv_log_sigma.bias.detach()[0].item() == -30.0
    with pytest.raises(NotImplementedError):
        tserve.downscale(tcfg.replace(ds_model="deterministic_unet"), port_ckpt,
                         os.path.join(d, "x.nc"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)


def test_classic_format_where_h5py_is_missing(setup, monkeypatch):
    """Without h5py the port writes netCDF classic: the synthetic inputs and
    the served file, here forced by the format default. The served values
    equal the JAX package's netCDF-4 file, and the output opens in scipy's
    independent classic-format reader."""
    from scipy.io import netcdf_file

    from probunet_torch.data import netcdf as tnetcdf

    d, cfg, jax_ckpt, port_ckpt = setup
    monkeypatch.setattr(tnetcdf, "default_format", lambda: "classic")
    datadir = os.path.join(d, "data_classic")
    tsyn.generate_climex_like(datadir, years=(2000,), grid=16, days_per_year=16)
    with open(os.path.join(datadir, "climex_pr_kdj_2000_synth.nc"), "rb") as f:
        assert f.read(4) == b"CDF\x02"
    tcfg = TConfig(**vars(cfg)).replace(datadir=datadir)
    out_t = tserve.downscale(tcfg, port_ckpt, os.path.join(d, "port_classic.nc"),
                             num_samples=3, device="cpu")
    out_j = os.path.join(d, "jax.nc")
    if not os.path.exists(out_j):
        out_j = jax_downscale(cfg, jax_ckpt, out_j, num_samples=3)
    _, pj = _read(out_j)
    with tnc.NetCDFFile(out_t) as f:
        for v in VARS:
            np.testing.assert_allclose(f.read_var(v), pj[v], rtol=1e-4,
                                       atol=1e-4 * float(np.abs(pj[v]).max()))
        times = f.read_time()
    with tnc.NetCDFFile(out_j) as f:
        np.testing.assert_array_equal(times, f.read_time())
    with netcdf_file(out_t, "r", mmap=False) as f:
        assert f.variables["pr"].shape == (16, 3, 16, 16)
        assert f.variables["time"].units == b"days since 1950-01-01"
        with tnc.NetCDFFile(out_t) as g:
            np.testing.assert_array_equal(f.variables["tasmax"][:], g.read_var("tasmax"))
    with pytest.raises(ValueError):
        tnc.StreamingFieldWriter(os.path.join(d, "bad.nc"), {"pr": (2, 2, 2)},
                                 np.zeros(2), compression="gzip")


def test_classic_reader_reads_scipy_files(tmp_path):
    """Classic files written by scipy (CDF-1 and CDF-2), packed int16 and
    windowed reads included."""
    from scipy.io import netcdf_file

    rng = np.random.default_rng(0)
    data = rng.integers(-30000, 30000, size=(5, 6, 7)).astype(np.int16)
    for version in (1, 2):
        path = str(tmp_path / f"v{version}.nc")
        with netcdf_file(path, "w", version=version) as f:
            for dname, n in (("time", 5), ("rlat", 6), ("rlon", 7)):
                f.createDimension(dname, n)
            t = f.createVariable("time", "d", ("time",))
            t[:] = np.arange(5) + 10.0
            t.units = b"days since 1950-01-01"
            t.calendar = b"noleap"
            v = f.createVariable("tas", "h", ("time", "rlat", "rlon"))
            v[:] = data
            v.scale_factor = 0.01
            v.add_offset = 270.0
        with tnc.NetCDFFile(path) as f:
            np.testing.assert_allclose(f.read_var("tas", (slice(1, 4), slice(2, 7))),
                                       data[:, 1:4, 2:7] * np.float32(0.01) + np.float32(270.0),
                                       rtol=1e-6)
            assert f.read_time()[0] == np.datetime64("1950-01-11")


def test_synthetic_and_ingest_match_jax(tmp_path):
    """The port's copies of the numpy-only modules write and read the same
    files as the JAX package's."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    generate_climex_like(a, years=(2000, 2001), grid=8, days_per_year=4, seed=3)
    tsyn.generate_climex_like(b, years=(2000, 2001), grid=8, days_per_year=4, seed=3)
    lj = jnc.load_window(a, [2000, 2001], VARS, (0, 8, 0, 8))
    lt = tnc.load_window(b, [2000, 2001], VARS, (0, 8, 0, 8))
    for k in ("hr", "timestamps", "lat", "lon"):
        np.testing.assert_array_equal(lt[k], lj[k])
    np.testing.assert_array_equal(tnc.pack_int16(lt["hr"], 260.0, 280.0),
                                  jnc.pack_int16(lj["hr"], 260.0, 280.0))
