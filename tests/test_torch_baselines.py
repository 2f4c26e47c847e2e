"""The port's baselines on the CPU against the JAX package: the time
features and day-of-year bins, the float32 timestamps of a batch, the
LinearCNN (time embedding off and on), BCSD and its chunked run, the
conv-VAE's ELBO and ensemble with JAX's draws, the deterministic U-Net's
training and eval steps (3-step AdamW traces, id and cyclic labels, fp32 and
bf16, and a step after a transplanted JAX state), its full-width parameter
count, then ``train_baseline`` end to end for every baseline, exact resume,
streaming against resident ingest, the command line, and serving the
conv-VAE from a JAX checkpoint carried across. The same weights (carried
across by ``utils/transplant.py``) and the same numpy inputs on both sides;
where the JAX side draws (the VAE's latents), its draws are recomputed and
handed to the port; dropout is off where the two sides are compared."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import _assert_close, _params
from test_torch_train import _data, _rel_err

from probunet_torch import serve as tserve
from probunet_torch.config import Config as TConfig
from probunet_torch.data import transforms as tt
from probunet_torch.data.dataset import ClimexDataset as TDataset
from probunet_torch.data.netcdf import NetCDFFile
from probunet_torch.models import ConvVAE as TConvVAE
from probunet_torch.models import LinearCNN as TLinearCNN
from probunet_torch.models import UNet as TUNet
from probunet_torch.models import bcsd as t_bcsd
from probunet_torch.models import day_of_year_365 as t_doy
from probunet_torch.models.baselines import doy_sums
from probunet_torch.models.layers import GroupNormSiLU
from probunet_torch.train import steps as tsteps
from probunet_torch.train.__main__ import main as t_train_main
from probunet_torch.train.checkpoint import load_payload, save_checkpoint
from probunet_torch.train.loop import build_baseline_model as t_build_baseline
from probunet_torch.train.loop import build_probunet as t_build
from probunet_torch.train.loop import run_bcsd as t_run_bcsd
from probunet_torch.train.loop import train_baseline as t_train_baseline
from probunet_torch.train.state import TrainState as TTrainState
from probunet_torch.train.state import create_train_state as t_create
from probunet_torch.train.state import make_optimizer as t_make_optimizer
from probunet_torch.utils.transplant import (
    flax_convvae_to_torch,
    flax_linearcnn_to_torch,
    flax_train_state_to_torch,
    flax_unet_to_torch,
)
from probunet_tpu.config import Config as JConfig
from probunet_tpu.data import transforms as jt
from probunet_tpu.data.dataset import ClimexDataset as JDataset
from probunet_tpu.models import UNet as JUNet
from probunet_tpu.models.baselines import ConvVAE as JConvVAE
from probunet_tpu.models.baselines import LinearCNN as JLinearCNN
from probunet_tpu.models.baselines import bcsd as j_bcsd
from probunet_tpu.models.baselines import day_of_year_365 as j_doy
from probunet_tpu.serve import downscale as jax_downscale
from probunet_tpu.train import steps as jsteps
from probunet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from probunet_tpu.train.loop import build_baseline_model as j_build_baseline
from probunet_tpu.train.loop import run_bcsd as j_run_bcsd
from probunet_tpu.train.loop import train_baseline as j_train_baseline
from probunet_tpu.train.state import create_train_state as j_create
from probunet_tpu.train.state import make_optimizer as j_make_optimizer

VARS = ("pr", "tasmin", "tasmax")
LR = 1e-3
DAY_NS = 86400e9


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tiny models, which many threads only slow down when several test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ns(dates):
    """ISO dates -> float64 ns since the epoch, as the datasets hold them."""
    return np.array(dates, "datetime64[ns]").astype(np.int64).astype(np.float64)


def _days(start, n, every=1):
    """``n`` timestamps ``every`` days apart from ``start``, float64 ns."""
    return _ns([start])[0] + np.arange(n) * every * DAY_NS


# ---- time features, day-of-year bins, float32 timestamps ---------------------------

@pytest.mark.parametrize("transform", ["id", "cyclic"])
def test_time_features_match_jax(transform):
    ts = np.concatenate([_days("1960-01-01", 9, 1000), _days("2000-12-25", 9)]).astype(np.float32)
    ref = np.asarray(jt.time_features(jnp.asarray(ts), transform))
    out = tt.time_features(torch.from_numpy(ts), transform)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    # float32 on both sides; sin/cos of the same float32 phase from two
    # math libraries, which may differ in the last bit
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-7, atol=2e-7)
    with pytest.raises(ValueError):
        tt.time_features(torch.from_numpy(ts), "bogus")


def test_day_of_year_matches_jax_with_leap_dec31():
    """Exact: calendar dates, not days % 365; Dec 31 of a leap year clips
    into bin 364, as Dec 30 of that year lands there too."""
    ts = _ns(["2000-01-01", "2000-02-29", "2000-03-01", "2000-12-30", "2000-12-31",
              "2001-12-31", "2096-12-31T18:00", "1961-07-04T12:00"])
    out = t_doy(ts)
    np.testing.assert_array_equal(out, j_doy(ts))
    assert out.dtype == np.int32
    assert out.tolist() == [0, 59, 60, 364, 364, 364, 364, 184]
    hr = np.zeros((len(ts), 4, 4, 3), np.float32)
    np.testing.assert_array_equal(TDataset(hr=hr, timestamps=ts, device="cpu").dayofyear,
                                  JDataset(hr=hr, timestamps=ts).dayofyear)


def test_batch_timestamps_are_the_jax_float32_values():
    """``batch()`` carries the timestamps as float32, the values JAX (no
    64-bit floats) holds; float64 ~1e18 ns would differ from them by up to
    one float32 rounding (2^36 ns, about 69 s)."""
    ts = _days("2003-05-17T06:00", 6, 3) + 123456789.0
    hr = np.random.default_rng(0).gamma(2.0, 1.0, (6, 8, 8, 3)).astype(np.float32)
    idx = np.array([4, 0, 5])
    t = TDataset(hr=hr, timestamps=ts, standardization="pertimestep", device="cpu").batch(idx)
    j = JDataset(hr=hr, timestamps=ts, standardization="pertimestep").batch(idx)
    assert t["timestamps"].dtype == torch.float32
    np.testing.assert_array_equal(t["timestamps"].numpy(), np.asarray(j["timestamps"]))
    assert (t["timestamps"].numpy().astype(np.float64) != ts[idx]).any()


# ---- LinearCNN ----------------------------------------------------------------------

@pytest.mark.parametrize("time_embedding", [False, True], ids=["plain", "time_embedding"])
def test_linearcnn_matches_jax(time_embedding):
    jm = JLinearCNN(resolution=(16, 16), in_channels=3, use_time_embedding=time_embedding)
    x, labels = _x((2, 16, 16, 3), 1), _x((2, 2), 2)
    params = _params(jm, jnp.asarray(x), jnp.asarray(labels), seed=3)
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(labels))
    tm = TLinearCNN((16, 16), 3, use_time_embedding=time_embedding, label_dim=2, device="cpu")
    tm.load_state_dict(flax_linearcnn_to_torch(params))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), class_labels=torch.from_numpy(labels))
    # fp32 convolutions and dense layers summed in another order
    _assert_close(out.numpy(), ref, 1e-5)
    # a JAX TrainState of it carries across: parameters and Adam moments
    tx = j_make_optimizer(lr=LR)
    names = [n for n, _ in tm.named_parameters()]
    state = t_create(tm, t_make_optimizer(lr=LR))
    load_payload(state, flax_train_state_to_torch(jax.device_get(j_create(params, tx)), names))
    assert state.step == 0
    for name, p in tm.named_parameters():
        assert torch.equal(p, flax_linearcnn_to_torch(params)[name]), name


# ---- BCSD ---------------------------------------------------------------------------

def test_bcsd_matches_jax():
    rng = np.random.default_rng(4)
    train_hr = rng.gamma(2.0, 1.0, (40, 8, 8, 3)).astype(np.float32) + 1.0
    train_lri = (train_hr * rng.uniform(0.8, 1.2, train_hr.shape)).astype(np.float32)
    test_lri = rng.gamma(2.0, 1.0, (9, 8, 8, 3)).astype(np.float32)
    train_doy = rng.integers(0, 12, 40).astype(np.int32)   # several days per bin
    test_doy = rng.integers(0, 14, 9).astype(np.int32)     # and bins without train days
    ref = j_bcsd(*(jnp.asarray(a) for a in (train_hr, train_lri, test_lri, train_doy, test_doy)))
    out = t_bcsd(*(torch.from_numpy(a) for a in (train_hr, train_lri, test_lri, train_doy,
                                                 test_doy)))
    # fp32 sums of up to ~7 terms in another order (tests/test_loop.py's tolerance)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    # the one-hot product: the same bits on every call
    a, b = (doy_sums(torch.from_numpy(train_hr), torch.from_numpy(train_doy)) for _ in range(2))
    assert torch.equal(a, b)


def _bcsd_datasets(cls, **kw):
    """Two train years of 15 days from Jan 1 (30 days: chunks of 7 leave a
    tail of 2), and val/test days in the same bins, every train bin among
    the val days (so a train day left out of the sums shows)."""
    rng = np.random.default_rng(6)

    def hr(t):
        return (rng.gamma(2.0, 1.0, (t, 16, 16, 3)) + 250.0).astype(np.float32)

    ts = {"train": np.concatenate([_days("2000-01-01", 15), _days("2001-01-01", 15)]),
          "val": _days("2002-01-01", 15), "test": _days("2003-01-03", 5)}
    return {k: cls(hr=hr(len(v)), timestamps=v, **kw) for k, v in ts.items()}


def test_run_bcsd_chunked_matches_unchunked_and_jax():
    cfg = TConfig(ds_model="bcsd", resolution=(16, 16), lowres_scale=4)
    datasets = _bcsd_datasets(TDataset, device="cpu")
    chunked = t_run_bcsd(cfg, datasets, chunk=7, device="cpu")
    whole = t_run_bcsd(cfg, datasets, device="cpu")
    ref = j_run_bcsd(JConfig(**vars(cfg)), _bcsd_datasets(JDataset), chunk=7)
    for split in ("val", "test"):
        assert chunked[split]["preds"].shape == (len(datasets[split]), 16, 16, 3)
        assert np.isfinite(chunked[split]["preds"]).all()
        # fp32 sums in another order (tests/test_loop.py's tolerance)
        for other in (whole, ref):
            np.testing.assert_allclose(chunked[split]["preds"], np.asarray(other[split]["preds"]),
                                       rtol=1e-4, atol=1e-5)
            for v in VARS:
                assert chunked[split]["mae"][v] == pytest.approx(other[split]["mae"][v],
                                                                 rel=1e-4, abs=1e-5)


# ---- the conv-VAE ----------------------------------------------------------------------

def _latent_key(jm, params, key):
    """The key the JAX module's first ``make_rng("latent")`` returns under
    ``rngs={"latent": key}``: its elbo and sample each draw once, at the
    top scope."""
    return jm.apply({"params": params}, rngs={"latent": key},
                    method=lambda m: m.make_rng("latent"))


VAE_KW = dict(input_channels=3, num_classes=3, latent_dim=4, num_filters=(8, 16),
              decoder_channels=16)


def test_convvae_elbo_and_sample_match_jax():
    jm = JConvVAE(**VAE_KW)
    x0 = jnp.zeros((1, 16, 16, 3))
    params = _params(jm, x0, x0, seed=8, method=jm.elbo)
    x, y = _x((2, 16, 16, 3), 1), _x((2, 16, 16, 3), 2)
    key = jax.random.key(9)

    def loss(p):
        total, recon, kl = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(y), 0.7,
                                    rngs={"latent": key}, method=jm.elbo)
        return total, (recon, kl)

    (total, (recon, kl)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    eps = np.asarray(jax.random.normal(_latent_key(jm, params, key), (2, 4)))
    tm = TConvVAE(**VAE_KW, device="cpu")
    tm.load_state_dict(flax_convvae_to_torch(params))
    out = tm.elbo(torch.from_numpy(x), torch.from_numpy(y), 0.7, eps=torch.from_numpy(eps))
    out[0].backward()
    # fp32 through the encoder, the posterior and Fcomb on both sides
    for a, b in zip(out, (total, recon, kl)):
        assert a.item() == pytest.approx(float(b), rel=1e-5)
    ref = {k: v.numpy() for k, v in flax_convvae_to_torch(grads).items()}
    for name, p in tm.named_parameters():
        assert _rel_err(p.grad.numpy(), ref[name]) <= 1e-4, name
    with torch.no_grad():   # the posterior draw z = mu + sigma * eps, given
        post = tm.posterior(torch.from_numpy(x).permute(0, 3, 1, 2),
                            torch.from_numpy(y).permute(0, 3, 1, 2))
        z = post.mu + post.sigma * torch.from_numpy(eps)
        assert tm.elbo_with_z(torch.from_numpy(x), torch.from_numpy(y), z, 0.7)[0].item() == \
            pytest.approx(out[0].item(), rel=1e-6)

    js = jm.apply({"params": params}, jnp.asarray(x), 3, rngs={"latent": key}, method=jm.sample)
    zs = np.asarray(jax.random.normal(_latent_key(jm, params, key), (3, 2, 4)))
    with torch.no_grad():
        ts = tm.sample(torch.from_numpy(x), 3, eps=torch.from_numpy(zs))
    assert ts.shape == (2, 3, 16, 16, 3)
    _assert_close(ts.numpy(), js, 1e-5)
    assert float(np.abs(np.asarray(js)[:, 0] - np.asarray(js)[:, 1]).max()) > 0


# ---- the deterministic U-Net: steps ---------------------------------------------------------

NET = dict(model_channels=16, channel_mult=(1, 2), num_blocks=1)


def _unet_kw(label_dim):
    return dict(img_resolution=(16, 16), in_channels=3, out_channels=3, label_dim=label_dim,
                use_diffuse=False, attn_resolutions=(), bottleneck_attention=False,
                dropout=0.0, **NET)


@pytest.fixture(scope="module", params=["id", "cyclic"])
def det(request):
    """(timetransform, JAX U-Net, filled params, port U-Net factory) of the
    deterministic baseline: label_dim 0 for 'id', 2 (map_label) for
    'cyclic'."""
    transform = request.param
    label_dim = 2 if transform == "cyclic" else 0
    jm = JUNet(**_unet_kw(label_dim))
    params = _params(jm, jnp.zeros((1, 16, 16, 3)), None, jnp.zeros((1, max(label_dim, 1))),
                     seed=31)

    def port():
        tm = TUNet(**_unet_kw(label_dim), device="cpu")
        tm.load_state_dict(flax_unet_to_torch(params))
        return tm

    return transform, jm, params, port


def _flat(tree):
    return {k: v.numpy() for k, v in flax_unet_to_torch(tree).items()}


# six days a fortnight apart from late December: the cyclic phase wraps
TS = _days("2000-12-20", 6, 14).astype(np.float32)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_deterministic_train_steps_match_jax(det, compute_dtype):
    """Three AdamW steps of JAX's ``make_deterministic_train_step`` and the
    port's, from the same weights, on the same batches and timestamps."""
    transform, jm, params, port = det
    t_hr, t_stats, j_hr, j_stats = _data()
    jdt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(3)
    idxs = [rng.choice(6, 2, replace=False) for _ in range(3)]
    tx = j_make_optimizer(lr=LR)
    jstep = jsteps.make_deterministic_train_step(jm, tx, 4, "pertimestep", jdt, donate=False,
                                                 timetransform=transform)
    jstate, j_trace, states, clear, sign = j_create(params, tx), [], [], {}, {}
    for idx in idxs:
        states.append(jax.device_get(jstate))
        jstate, m = jstep(jstate, j_hr, j_stats, jnp.asarray(idx), jnp.asarray(TS[idx]),
                          jax.random.key(0))
        j_trace.append([float(m["train_loss"])] + [float(m[f"train_loss_var{i}"])
                                                    for i in range(3)])
        for name, g in _flat(jax.device_get(jstate.opt_state[0].mu)).items():
            sign.setdefault(name, np.sign(g))   # clear of zero, one sign at every step
            ok = (np.abs(g) > 1e-3 * np.abs(g).max()) & (np.sign(g) == sign[name])
            clear[name] = clear.get(name, True) & ok

    tm = port()
    state = t_create(tm, t_make_optimizer(lr=LR))
    step = tsteps.make_deterministic_train_step(tm, 4, "pertimestep", tdt,
                                                timetransform=transform)
    t_trace = []
    for idx in idxs:
        m = step(state, t_hr, t_stats, torch.from_numpy(idx), torch.from_numpy(TS[idx]), 0)
        t_trace.append([m["train_loss"].item()] + [m[f"train_loss_var{i}"].item()
                                                   for i in range(3)])
    assert state.step == 3
    ref = _flat(jax.device_get(jstate.params))
    if compute_dtype == "float32":
        # fp32 on both sides; Adam moves each weight by ~lr whatever its
        # gradient, so the first step's small gradient differences reach
        # the later losses: 1e-4 relative (the prob-U-Net trace's limit)
        np.testing.assert_allclose(np.array(t_trace), np.array(j_trace), rtol=1e-4, atol=1e-6)
        for name, w in tm.named_parameters():
            d = np.abs(w.detach().numpy() - ref[name])
            assert d.max() <= 2 * LR * 3 + 1e-6, name
            assert d[clear[name]].max(initial=0.0) <= 1e-5, name
        # a JAX TrainState after two steps (parameters and Adam moments)
        # carried across: the port's third step is JAX's third step
        tm2 = port()
        state2 = t_create(tm2, t_make_optimizer(lr=LR))
        load_payload(state2, flax_train_state_to_torch(
            states[2], [n for n, _ in tm2.named_parameters()]))
        assert state2.step == 2
        step2 = tsteps.make_deterministic_train_step(tm2, 4, "pertimestep",
                                                     timetransform=transform)
        m = step2(state2, t_hr, t_stats, torch.from_numpy(idxs[2]),
                  torch.from_numpy(TS[idxs[2]]), 0)
        assert m["train_loss"].item() == pytest.approx(j_trace[2][0], rel=1e-5)
    else:
        # x and y rounded to bf16 alike, then bf16 convolutions and K1 whose
        # outputs round to bf16 at other points; the mean over the batch
        # averages those roundings, so each loss stays within one bf16 ulp
        # (2^-8) of JAX's. Every weight within Adam's 2 lr per step.
        np.testing.assert_allclose(np.array(t_trace), np.array(j_trace), rtol=2 ** -8)
        for name, w in tm.named_parameters():
            assert np.abs(w.detach().numpy() - ref[name]).max() <= 2 * LR * 3 + 1e-6, name


@pytest.mark.parametrize("reconstruct", [False, True], ids=["residual_mse", "physical_mae"])
def test_deterministic_eval_step_matches_jax(det, reconstruct):
    transform, jm, params, port = det
    t_hr, t_stats, j_hr, j_stats = _data()
    loss = "mae" if reconstruct else "mse"
    idx = np.array([5, 1, 2])
    ref = jsteps.make_deterministic_eval_step(jm, 4, "pertimestep", VARS, reconstruct, loss,
                                              timetransform=transform)(
        params, j_hr, j_stats, jnp.asarray(idx), jnp.asarray(TS[idx]))
    out = tsteps.make_deterministic_eval_step(port(), 4, "pertimestep", VARS, reconstruct, loss,
                                              timetransform=transform)(
        t_hr, t_stats, torch.from_numpy(idx), torch.from_numpy(TS[idx]))
    assert sorted(out) == sorted(ref) == [f"eval_{v}" for v in sorted(VARS)]
    for k in ref:   # fp32 through the network (and the residual -> HR inverse)
        assert out[k].item() == pytest.approx(float(ref[k]), rel=1e-5), k


def test_full_width_parameter_count_and_k1_sites():
    """The reference's baseline at 128x128 (width 64, no attention, not at
    the bottleneck either): the JAX count from ``jax.eval_shape``; 29
    GroupNorm+SiLU (K1) modules and no attention block."""
    jcfg = JConfig(ds_model="deterministic_unet", resolution=(128, 128))
    jm = j_build_baseline(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, 128, 128, 3)), class_labels=jnp.zeros((1, 1)), train=False))["params"]
    j_count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    tm = t_build_baseline(TConfig(**vars(jcfg)), device="meta")
    assert sum(p.numel() for p in tm.parameters()) == j_count == 22_792_579
    assert sum(isinstance(m, GroupNormSiLU) for m in tm.modules()) == 29
    assert not any(getattr(m, "heads", 0) for m in tm.modules())
    cyc = t_build_baseline(TConfig(**vars(jcfg)).replace(timetransform="cyclic"), device="meta")
    assert sum(p.numel() for p in cyc.parameters()) == 22_793_091   # + map_label 2 x 256
    # the prob-U-Net's backbone keeps its bottleneck attention block
    assert TUNet((16, 16), 3, 8, attn_resolutions=(), device="meta").dec_specs[0].attention


# ---- train_baseline end to end --------------------------------------------------------------

# 12 train days at batch 4: 3 steps per epoch; 8 val days: 2 eval batches
TINY = dict(resolution=(16, 16), lowres_scale=4, batch_size=4, num_epochs=2, log_every=1,
            baseline_channels=8, channel_mult=(1, 2), num_blocks=1, latent_dim=4,
            num_filters=(8, 16), standardization="pertimestep", num_samples=2)
SPLITS = {"train": (12, 1, "2000-01-05"), "val": (8, 2, "2001-03-01"),
          "test": (4, 3, "2002-06-01")}


def _datasets(cls, **kw):
    """Days 23 apart, so the cyclic phase takes many values."""
    def hr(t, seed):
        return (np.random.default_rng(seed).gamma(2.0, 1.0, (t, 16, 16, 3))
                + 270.0).astype(np.float32)

    return {k: cls(hr=hr(t, s), timestamps=_days(d, t, 23), standardization="pertimestep",
                   lowres_scale=4, **kw) for k, (t, s, d) in SPLITS.items()}


def _dirs(tmp, tag):
    return dict(plotdir=os.path.join(str(tmp), f"plots_{tag}"),
                checkpoints_dir=os.path.join(str(tmp), f"ckpt_{tag}"))


def _records(plotdir, name):
    with open(os.path.join(plotdir, name)) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_linearcnn(tmp_path_factory):
    """The JAX ``train_baseline`` once (LinearCNN, 2 epochs of 3 steps)."""
    tmp = tmp_path_factory.mktemp("jax_baseline")
    cfg = JConfig(ds_model="linearcnn", **TINY, **_dirs(tmp, "jax"))
    res = j_train_baseline(cfg, datasets=_datasets(JDataset), make_plots=False)
    assert int(res["state"].step) == 6
    return _records(cfg.plotdir, "metrics_baseline.jsonl")


@pytest.mark.parametrize("ds_model", ["deterministic_unet", "linearcnn"])
def test_train_baseline_writes_the_jax_records(jax_linearcnn, ds_model, tmp_path):
    """Per-variable losses, the JAX loop's records (keys and order: one per
    step, one per epoch, the final MAE), the finite physical MAE, the plots
    (U-Net) and the checkpoint under ``<ds_model>/``."""
    cfg = TConfig(ds_model=ds_model, timetransform="cyclic", **TINY, **_dirs(tmp_path, "p"))
    plots = ds_model == "deterministic_unet"
    res = t_train_baseline(cfg, datasets=_datasets(TDataset, device="cpu"), make_plots=plots,
                           device="cpu")
    assert res["state"].step == 6
    for v in VARS:
        assert len(res["tr_losses"][v]) == 6 and len(res["val_losses"][v]) == 4
        assert np.isfinite(res["mae"][v]) and res["mae"][v] > 0
    recs = _records(cfg.plotdir, "metrics_baseline.jsonl")
    assert [sorted(r) for r in recs] == [sorted(r) for r in jax_linearcnn]
    assert recs[-1]["mae_pr"] == res["mae"]["pr"]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    assert os.path.isfile(os.path.join(cfg.checkpoints_dir, ds_model, "state", "state.pt"))
    if plots:
        for name in ("epoch2_samples_from_deterministic_unet.png", "loss_pr.png"):
            assert os.path.getsize(os.path.join(cfg.plotdir, name)) > 0


def test_train_baseline_bcsd_and_vae(tmp_path):
    """``bcsd`` runs ``run_bcsd``; ``vae`` trains the conv-VAE through the
    prob-U-Net loop: its records, its checkpoint under ``vae/``."""
    cfg = TConfig(**TINY, **_dirs(tmp_path, "b"))
    datasets = _datasets(TDataset, device="cpu")
    out = t_train_baseline(cfg.replace(ds_model="bcsd"), datasets=datasets, device="cpu")
    assert set(out) == {"val", "test"}
    assert out["val"]["preds"].shape == (8, 16, 16, 3)
    assert all(np.isfinite(m) for split in out.values() for m in split["mae"].values())
    res = t_train_baseline(cfg.replace(ds_model="vae"), datasets=datasets, make_plots=True,
                           device="cpu")
    assert res["state"].step == 6 and isinstance(res["state"].model, TConvVAE)
    assert np.isfinite(res["tr_losses"]).all() and len(res["val_losses"]) == 2
    recs = _records(cfg.plotdir, "metrics.jsonl")
    assert {"train_loss", "recon_loss", "kl_div", "beta", "grad_norm"} <= set(recs[0])
    assert os.path.isfile(os.path.join(cfg.checkpoints_dir, "vae", "state", "state.pt"))
    assert os.path.getsize(os.path.join(cfg.plotdir, "epoch2.png")) > 0


def test_train_baseline_exact_resume(tmp_path):
    """Bit-equal on the CPU (cyclic labels, dropout 0.1 from the per-step
    streams): 2 steps, a checkpoint, resumed to the end, against the
    uninterrupted run; resuming the finished run is a no-op."""
    kw = dict(TINY, ds_model="deterministic_unet", timetransform="cyclic", dropout=0.1)
    datasets = _datasets(TDataset, device="cpu")
    a = t_train_baseline(TConfig(**kw, max_steps=2, **_dirs(tmp_path, "a")), datasets, False, "cpu")
    assert a["state"].step == 2
    resume = os.path.join(str(tmp_path), "ckpt_a", "deterministic_unet")
    b = t_train_baseline(TConfig(**kw, resume=resume, **_dirs(tmp_path, "b")), datasets, False,
                         "cpu")
    c = t_train_baseline(TConfig(**kw, **_dirs(tmp_path, "c")), datasets, False, "cpu")
    assert b["state"].step == c["state"].step == 6
    for x, y in zip(b["state"].model.state_dict().values(), c["state"].model.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert b["mae"] == c["mae"]
    done = os.path.join(str(tmp_path), "ckpt_c", "deterministic_unet")
    d = t_train_baseline(TConfig(**kw, resume=done, **_dirs(tmp_path, "d")), datasets, False,
                         "cpu")
    assert d["state"].step == 6


def test_streaming_equals_resident_with_cyclic_labels(tmp_path):
    """Host-resident streaming ingest feeds the same batches, statistics and
    timestamps (the cyclic labels drive map_label) as the resident tensors:
    the same losses and MAE."""
    kw = dict(TINY, ds_model="deterministic_unet", timetransform="cyclic")
    res = {}
    for tag, resident in (("stream", False), ("resident", True)):
        cfg = TConfig(**kw, device_resident_data=resident, **_dirs(tmp_path, tag))
        res[tag] = (t_train_baseline(cfg, _datasets(TDataset, device="cpu"), False, "cpu"),
                    _records(cfg.plotdir, "metrics_baseline.jsonl"))
    (s, s_recs), (r, r_recs) = res["stream"], res["resident"]
    losses = [(a["train_loss"], b["train_loss"]) for a, b in zip(s_recs, r_recs)
              if "train_loss" in a]
    assert len(losses) == 6
    # the same fp32 math on the same values; the per-sample statistics are
    # computed chunk-wise there and on the whole split here
    for a, b in losses:
        assert a == pytest.approx(b, rel=1e-6)
    for v in VARS:
        assert s["mae"][v] == pytest.approx(r["mae"][v], rel=1e-6)


def test_cli_trains_linearcnn(tmp_path):
    """``python -m probunet_torch.train --ds_model linearcnn --device cpu
    --synthetic`` (run in this process): one epoch, the per-variable print,
    the baseline metrics and checkpoint."""
    from probunet_torch.data.synthetic import generate_climex_like

    out = str(tmp_path)
    generate_climex_like(os.path.join(out, "data"), years=(2000, 2001, 2002), grid=16,
                         days_per_year=8)
    argv = ["--synthetic", "--device", "cpu", "--ds_model", "linearcnn", "--datadir",
            os.path.join(out, "data"), "--years_train", "2000,2001", "--years_val", "2001,2002",
            "--years_test", "2002,2003", "--coords", "0,16,0,16", "--resolution", "16,16",
            "--batch_size", "4", "--num_epochs", "1", "--plotdir", os.path.join(out, "plots"),
            "--checkpoints_dir", os.path.join(out, "ckpt")]
    res = t_train_main(argv)
    assert res["state"].step == 2 and all(np.isfinite(res["mae"][v]) for v in VARS)
    assert os.path.getsize(os.path.join(out, "plots", "metrics_baseline.jsonl")) > 0
    assert os.path.exists(os.path.join(out, "ckpt", "linearcnn", "state", "state.pt"))
    bcsd = t_train_main(argv[:4] + ["bcsd"] + argv[5:])
    assert set(bcsd) == {"val", "test"}


# ---- serving the conv-VAE ------------------------------------------------------------------

def test_downscale_vae_from_a_jax_checkpoint(tmp_path, monkeypatch):
    """A JAX conv-VAE TrainState (params and AdamW state) carried across by
    ``flax_train_state_to_torch`` into a port checkpoint, served by the
    port's ``downscale(ds_model="vae")`` and by the JAX package's on the
    same netCDF days: (T, K, H, W) per variable, members that differ, and
    the port's members equal JAX's where each batch's prior draws are the
    ones JAX draws (handed to the port's draw for that batch)."""
    from probunet_tpu.data.synthetic import generate_climex_like

    datadir = os.path.join(str(tmp_path), "data")
    generate_climex_like(datadir, years=(2002,), grid=16, days_per_year=6, seed=5)
    jcfg = JConfig(**TINY, ds_model="vae", datadir=datadir,
                   years_test=(2002, 2003), coords=(0, 16, 0, 16))
    jm = JConvVAE(input_channels=3, num_classes=3, latent_dim=4, num_filters=(8, 16),
                  decoder_channels=8)
    x0 = jnp.zeros((1, 16, 16, 3))
    params = _params(jm, x0, x0, seed=12, method=jm.elbo)
    tx = j_make_optimizer(jcfg.lr, jcfg.weight_decay)
    jstate = j_create(params, tx)
    jax_ckpt = os.path.join(str(tmp_path), "jax_ckpt")
    jax_save_checkpoint(jax_ckpt, jstate)
    out_j = jax_downscale(jcfg, jax_ckpt, os.path.join(str(tmp_path), "jax.nc"), num_samples=2,
                          seed=0)

    tcfg = TConfig(**vars(jcfg))
    tm = t_build(tcfg, device="cpu")
    state = t_create(tm, t_make_optimizer(tcfg.lr, tcfg.weight_decay))
    load_payload(state, flax_train_state_to_torch(jax.device_get(jstate),
                                                  [n for n, _ in tm.named_parameters()]))
    port_ckpt = os.path.join(str(tmp_path), "port_ckpt")
    save_checkpoint(port_ckpt, TTrainState(tm, None, state.step))

    randn, drawn = torch.randn, []

    def jax_eps(*shape, generator=None, **kw):   # (K, B, D) per batch: JAX's
        if generator is None or shape != ((2, 4, 4),):
            return randn(*shape, generator=generator, **kw)
        key = _latent_key(jm, params, jax.random.fold_in(jax.random.key(0), len(drawn)))
        drawn.append(shape)
        return torch.from_numpy(np.asarray(jax.random.normal(key, (2, 4, 4))))

    monkeypatch.setattr(torch, "randn", jax_eps)
    out_t = tserve.downscale(tcfg, port_ckpt, os.path.join(str(tmp_path), "port.nc"),
                             num_samples=2, seed=0, device="cpu")
    monkeypatch.undo()
    assert len(drawn) == 2   # 6 days in batches of 4
    with NetCDFFile(out_j) as f, NetCDFFile(out_t) as g:
        for v in VARS:
            a, b = f.read_var(v), g.read_var(v)
            assert b.shape == a.shape == (6, 2, 16, 16)
            assert np.isfinite(b).all() and b.std(axis=1).mean() > 0
            # fp32 through the decoder and the residual -> HR inverse
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4 * float(np.abs(a).max()))
    with pytest.raises(NotImplementedError, match="not served"):
        tserve.downscale(tcfg.replace(ds_model="linearcnn"), port_ckpt, "x.nc", device="cpu")
