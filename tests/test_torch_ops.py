"""Port ops (probunet_torch, on the CPU) against the JAX package on the same
numpy inputs: group norm, resampling, distributions, transforms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probunet_torch.data import transforms as tt
from probunet_torch.ops import distributions as td
from probunet_torch.ops import norm as tn
from probunet_torch.ops import resample as tr
from probunet_tpu.data import transforms as jt
from probunet_tpu.ops import distributions as jd
from probunet_tpu.ops import norm as jn
from probunet_tpu.ops import resample as jr

# fp32 on both sides; sums run in another order, so 1e-5 relative (about
# 100 fp32 ulps) is the tolerance unless a test says otherwise
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rand(*shape, seed=0, loc=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) + loc).astype(np.float32)


@pytest.mark.parametrize("c", [64, 256])
def test_group_norm_and_silu(c):
    x = _rand(2, 8, 8, c, seed=1, loc=0.5)
    w = 1 + 0.1 * _rand(c, seed=2)
    b = 0.1 * _rand(c, seed=3)
    g = tn.num_groups_for(c)
    assert g == jn.num_groups_for(c)
    args_t = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), g)
    args_j = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), g)
    np.testing.assert_allclose(_np(tn.group_norm(*args_t)), _np(jn.group_norm(*args_j)), **TOL)
    np.testing.assert_allclose(_np(tn.group_norm_silu(*args_t)),
                               _np(jn.group_norm_silu(*args_j)), **TOL)


def test_avg_pool_and_nearest():
    x = _rand(2, 16, 8, 3, seed=4)
    for k in (1, 2, 4):
        np.testing.assert_allclose(_np(tr.avg_pool(torch.from_numpy(x), k)),
                                   _np(jr.avg_pool(jnp.asarray(x), k)), **TOL)
    # HWC input squeezes like the JAX function
    np.testing.assert_allclose(_np(tr.avg_pool(torch.from_numpy(x[0]), 2)),
                               _np(jr.avg_pool(jnp.asarray(x[0]), 2)), **TOL)
    # replication is exact
    np.testing.assert_array_equal(_np(tr.nearest_upsample_2x(torch.from_numpy(x))),
                                  _np(jr.nearest_upsample_2x(jnp.asarray(x))))


@pytest.mark.parametrize("scale", [2, 4])
def test_bilinear_upsample(scale):
    x = _rand(2, 8, 6, 3, seed=5)
    out = tr.bilinear_upsample(torch.from_numpy(x), scale)
    np.testing.assert_allclose(_np(out), _np(jr.bilinear_upsample(jnp.asarray(x), scale)), **TOL)
    # and the library's own bilinear interpolation agrees with the matmul form
    ref = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                                          scale_factor=scale, mode="bilinear",
                                          align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_diag_gaussian_and_kl():
    mu, ls = _rand(3, 6, seed=6), 0.3 * _rand(3, 6, seed=7)
    mu2, ls2 = _rand(3, 6, seed=8), 0.3 * _rand(3, 6, seed=9)
    eps = _rand(5, 3, 6, seed=10)
    pt = td.DiagGaussian(torch.from_numpy(mu), torch.from_numpy(ls))
    qt = td.DiagGaussian(torch.from_numpy(mu2), torch.from_numpy(ls2))
    pj = jd.DiagGaussian(jnp.asarray(mu), jnp.asarray(ls))
    qj = jd.DiagGaussian(jnp.asarray(mu2), jnp.asarray(ls2))
    # the JAX draw is mu + exp(log_sigma) * eps; feed the port the same eps
    want = np.asarray(pj.mu)[None] + np.exp(np.asarray(pj.log_sigma))[None] * eps
    np.testing.assert_allclose(_np(pt.sample(5, eps=torch.from_numpy(eps))), want, **TOL)
    np.testing.assert_allclose(_np(pt.rsample(eps=torch.from_numpy(eps[0]))), want[0], **TOL)
    np.testing.assert_allclose(_np(td.kl_diag_gaussian(qt, pt)),
                               _np(jd.kl_diag_gaussian(qj, pj)), **TOL)
    with pytest.raises(ValueError):
        pt.sample(4, eps=torch.from_numpy(eps))
    g = torch.Generator().manual_seed(0)
    assert pt.sample(7, generator=g).shape == (7, 3, 6)


def test_units():
    from probunet_torch.data import units as tu
    from probunet_tpu.data import units as ju

    x = _rand(4, 5, seed=12)
    for name in ("kgm2s_to_mmday", "k_to_c", "log_inv"):
        np.testing.assert_allclose(_np(getattr(tu, name)(torch.from_numpy(x))),
                                   _np(getattr(ju, name)(jnp.asarray(x))), **TOL)
    dates = np.array(["2000-01-01", "2080-06-30T12:00"], dtype="datetime64[ns]")
    np.testing.assert_array_equal(tu.date_to_float(dates), ju.date_to_float(dates))
    np.testing.assert_array_equal(tu.float_to_date(tu.date_to_float(dates)), dates)


def _hr(t=6, h=16, w=16, seed=11):
    # temperature-like fields in Kelvin plus a non-negative precip-like one
    x = _rand(t, h, w, 3, seed=seed)
    x[..., 1:] = 270.0 + 5.0 * x[..., 1:]
    x[..., 0] = np.maximum(x[..., 0], 0.0) * 1e-4
    return x


@pytest.mark.parametrize("mode", ["none", "perpixel", "pertimestep", "minmax"])
def test_transforms_match_jax(mode):
    hr = _hr()
    st = tt.compute_lr_stats(torch.from_numpy(hr), 4, mode)
    sj = jt.compute_lr_stats(jnp.asarray(hr), 4, mode)
    # The temperature fields sit at ~270 K with a spread of ~5 K: one fp32 ulp
    # of the data (3e-5) is ~1e-5 of the spread, and means and stds summed in
    # another order carry a few of those ulps into everything standardized.
    # Hence 1e-4 relative, with an absolute floor of 1e-4 of each field's
    # largest value (the precip field is O(1e-4)).
    def close(a, b):
        b = _np(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-4 * float(np.abs(b).max()))

    if mode == "none":
        assert st is None and sj is None
    else:
        for a, b in zip(st, sj):
            close(a, b)
    idx = np.array([4, 1, 3])
    slt = tt.slice_stats(st, mode, torch.from_numpy(idx))
    slj = jt.slice_stats(sj, mode, jnp.asarray(idx))
    pt = tt.make_pair(torch.from_numpy(hr[idx]), 4, mode, slt)
    pj = jt.make_pair(jnp.asarray(hr[idx]), 4, mode, slj)
    for key in ("inputs", "targets", "lr", "lrinterp"):
        close(pt[key], pj[key])
    # residual -> HR inverts the targets back onto the HR tiles, with the
    # stats broadcast over a K axis as the sampler does
    res = np.stack([_np(pt["targets"])] * 2, axis=1)         # (B, K, H, W, C)
    if slt is not None and mode != "perpixel":
        slt_k = (slt[0][:, None], slt[1][:, None])
        slj_k = (slj[0][:, None], slj[1][:, None])
    else:
        slt_k, slj_k = slt, slj
    ht = tt.residual_to_hr(torch.from_numpy(res), pt["lrinterp"][:, None], mode, slt_k)
    hj = jt.residual_to_hr(jnp.asarray(res), pj["lrinterp"][:, None], mode, slj_k)
    close(ht, hj)
    close(_np(ht)[:, 1], hr[idx])


def test_dataset_batches_match_jax():
    from probunet_torch.data.dataset import ClimexDataset as TDS
    from probunet_tpu.data.dataset import ClimexDataset as JDS

    hr = _hr(t=10, seed=13)
    ts = np.arange(10) * 86400e9
    td = TDS(hr=hr, timestamps=ts, standardization="minmax", device="cpu")
    jd = JDS(hr=hr, timestamps=ts, standardization="minmax")
    np.testing.assert_array_equal(td.epoch_indices(3, 4, drop_remainder=False),
                                  jd.epoch_indices(3, 4, drop_remainder=False))
    idx = td.epoch_indices(1, 4)[0]
    bt, bj = td.batch(idx), jd.batch(idx)
    for key in ("inputs", "targets", "hr", "lrinterp", "timestamps"):
        ref = _np(bj[key])
        # fp32 data at ~270 K: see test_transforms_match_jax
        np.testing.assert_allclose(_np(bt[key]), ref, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref).max()))
