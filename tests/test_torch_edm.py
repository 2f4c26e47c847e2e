"""The port's EDM diffusion downscaler on the CPU against the JAX package:
the U-Net's mapping network, ``EDMPrecond`` (strict and fast attention on
fp32 operands), one denoising-score-matching training step (loss, every
gradient, parameters after AdamW), the Heun chain, the ensemble sample,
eval and CRPS functions, the parameter count at full width, ``train_edm``
against the JAX loop, exact resume, and EDM serving from a JAX checkpoint
carried across. The same weights (carried across by ``flax_edm_to_torch``)
and the same numpy inputs on both sides; jax.random and torch never agree
bit for bit, so the sigmas and the noise JAX draws are handed to the port,
and dropout is off where the two sides are compared."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import _params
from test_torch_train import _data, _rel_err

from probunet_torch import serve as tserve
from probunet_torch.config import Config as TConfig
from probunet_torch.data.dataset import ClimexDataset as TDataset
from probunet_torch.data.netcdf import NetCDFFile
from probunet_torch.models import EDMPrecond as TEDM
from probunet_torch.models import UNet as TUNet
from probunet_torch.train import steps as tsteps
from probunet_torch.train.__main__ import main as t_train_main
from probunet_torch.train.checkpoint import save_checkpoint
from probunet_torch.train.loop import build_edm_model as t_build_edm
from probunet_torch.train.loop import train_baseline as t_train_baseline
from probunet_torch.train.loop import train_edm as t_train_edm
from probunet_torch.train.state import TrainState as TTrainState
from probunet_torch.train.state import create_train_state as t_create
from probunet_torch.train.state import make_optimizer as t_make_optimizer
from probunet_tpu.config import Config as JConfig
from probunet_tpu.data.dataset import ClimexDataset as JDataset
from probunet_tpu.models import EDMPrecond as JEDM
from probunet_tpu.models import UNet as JUNet
from probunet_tpu.serve import downscale as jax_downscale
from probunet_tpu.train import steps as jsteps
from probunet_tpu.train.checkpoint import restore_checkpoint as j_restore
from probunet_tpu.train.loop import abstract_edm_state
from probunet_tpu.train.loop import build_edm_model as j_build_edm
from probunet_tpu.train.loop import train_edm as j_train_edm
from probunet_tpu.train.state import create_train_state as j_create
from probunet_tpu.train.state import make_optimizer as j_make_optimizer
from probunet_tpu.utils.transplant import _nest, _unet_flat
from probunet_torch.utils.transplant import flax_edm_to_torch, flax_unet_to_torch

VARS = ("pr", "tasmin", "tasmax")
LR = 1e-3
# 16x16 with model_channels 32: 64 channels at 8x8, so the 8x8 blocks and
# the bottleneck run attention (one head of 64)
NET = dict(model_channels=32, channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,))
EDM_KW = dict(img_resolution=(16, 16), in_channels=6, out_channels=3, dropout=0.0, **NET)
SIGMA = np.array([0.3, 5.0], np.float32)


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


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _heads(model):
    return [m.heads for m in model.modules() if getattr(m, "heads", 0)]


def _fill(model, seed):
    """Every parameter ~ 0.1 N(0, 1): the zero-init convs would hide most of
    each block, and the output."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)


# ---- the mapping network -------------------------------------------------------------

@pytest.mark.parametrize("label_dim", [0, 2], ids=["noise", "noise_and_labels"])
def test_mapping_network_matches_jax(label_dim):
    """The embedding (map_noise -> map_layer0 -> SiLU -> map_layer1, plus
    map_label) and the U-Net output with per-sample noise labels, against
    the JAX U-Net; its embedding taken from flax's captured intermediates."""
    kw = dict(img_resolution=(16, 16), in_channels=6, out_channels=3, dropout=0.0, **NET)
    jm = JUNet(label_dim=label_dim, use_diffuse=True, **kw)
    x, noise = _x((2, 16, 16, 6), 1), np.array([-1.3, 0.8], np.float32)
    labels = _x((2, label_dim), 2) if label_dim else None
    params = _params(jm, x, noise, labels, seed=3)
    ref, inter = jax.jit(lambda p: jm.apply({"params": p}, x, noise, labels,
                                            capture_intermediates=True,
                                            mutable=["intermediates"]))(params)
    inter = inter["intermediates"]
    emb_ref = inter["map_layer1"]["__call__"][0]
    if label_dim:
        emb_ref = emb_ref + inter["map_label"]["__call__"][0]
    emb_ref = jax.nn.silu(emb_ref)

    tm = TUNet(label_dim=label_dim, use_diffuse=True, device="cpu", **kw).eval()
    tm.load_state_dict(flax_unet_to_torch(params))
    assert ("map_label.weight" in tm.state_dict()) == bool(label_dim)
    assert not any(k.startswith("map_noise") or k.endswith("map_label.bias")
                   for k in tm.state_dict())
    lab = None if labels is None else _t(labels)
    with torch.no_grad():
        emb = tm.embedding(_t(x), _t(noise), lab)
        out = tm(_t(x), _t(noise), lab)
    assert emb.shape == (2, 4 * NET["model_channels"])
    # fp32 on both sides, sums in other orders
    assert _rel_err(emb.numpy(), emb_ref) <= 1e-5
    assert _rel_err(out.numpy(), ref) <= 1e-5


def test_label_dropout_at_rate_one_zeroes_the_labels():
    """Label dropout at rate 1.0 in training mode equals zero labels; the
    keep draw comes from the step's generator."""
    kw = dict(img_resolution=(16, 16), in_channels=3, out_channels=3, dropout=0.0,
              use_diffuse=True, **NET)
    g = torch.Generator().manual_seed(0)
    dropped = TUNet(label_dim=2, label_dropout=1.0, device="cpu", generator=g, **kw)
    _fill(dropped, 1)
    plain = TUNet(label_dim=2, device="cpu", **kw).eval()
    plain.load_state_dict(dropped.state_dict())
    x, noise, labels = _t(_x((2, 16, 16, 3), 4)), _t([0.1, -0.5]), _t(_x((2, 2), 5))
    with torch.no_grad():
        out = dropped.train()(x, noise, labels, generator=torch.Generator().manual_seed(1))
        ref = plain(x, noise, torch.zeros(2, 2))
        kept = dropped.eval()(x, noise, labels)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (kept - ref).abs().max() > 0


def test_downscaling_unet_keeps_silu_zero_embedding():
    """``use_diffuse=False, label_dim=0``: the embedding is silu(0), one row
    broadcast over the batch, no noise, label or augment map exists, and
    noise labels passed in change nothing."""
    kw = dict(img_resolution=(16, 16), in_channels=3, out_channels=3, dropout=0.0, **NET)
    tm = TUNet(device="cpu", generator=torch.Generator().manual_seed(2), **kw).eval()
    _fill(tm, 2)
    x = _t(_x((2, 16, 16, 3), 6))
    emb = tm.embedding(x)
    torch.testing.assert_close(emb, torch.zeros(1, 4 * NET["model_channels"]), rtol=0, atol=0)
    assert tm.map_noise is None and tm.map_label is None and tm.map_augment is None
    with torch.no_grad():
        torch.testing.assert_close(tm(x, _t([3.0, 4.0])), tm(x), rtol=0, atol=0)


# ---- EDMPrecond ----------------------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True], ids=["strict", "fast_attention"])
def test_edm_precond_matches_jax(fast):
    """Per-sample sigma, the condition concatenated on channels; with
    ``fast_attention`` the backbone still runs fp32 operands (as the EDM
    path does in fast mode), whose attention math is the strict one."""
    jm = JEDM(fast_attention=fast, **EDM_KW)
    x, cond = _x((2, 16, 16, 3), 7), _x((2, 16, 16, 3), 8)
    params = _params(jm, x, SIGMA, cond, seed=9)
    ref = jax.jit(lambda p: jm.apply({"params": p}, x, SIGMA, condition_img=cond))(params)
    tm = TEDM(fast_attention=fast, device="cpu", **EDM_KW).eval()
    tm.load_state_dict(flax_edm_to_torch(params))
    assert _heads(tm) == [1, 1, 1, 1] and all(k.startswith("model.") for k in tm.state_dict())
    with torch.no_grad():
        out = tm(_t(x), _t(SIGMA), condition_img=_t(cond))
    assert out.dtype == torch.float32
    assert _rel_err(out.numpy(), ref) <= 1e-5


def test_port_state_dict_carries_into_jax():
    """The other direction: a port EDM state_dict, with ``map_label``,
    through the JAX package's ``_unet_flat(prefix="model.")``: the JAX
    model on those weights gives the port's output (a scalar sigma, class
    labels given)."""
    kw = dict(EDM_KW, label_dim=2)
    tm = TEDM(device="cpu", generator=torch.Generator().manual_seed(3), **kw).eval()
    _fill(tm, 4)
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = {"model": _nest(_unet_flat(state, prefix="model."))}
    x, cond, labels = _x((2, 16, 16, 3), 10), _x((2, 16, 16, 3), 11), _x((2, 2), 12)
    jm = JEDM(**kw)
    ref = jax.jit(lambda p: jm.apply({"params": p}, x, 0.7, condition_img=cond,
                                     class_labels=labels))(params)
    with torch.no_grad():
        out = tm(_t(x), 0.7, condition_img=_t(cond), class_labels=_t(labels))
    assert _rel_err(out.numpy(), ref) <= 1e-5


# ---- the DSM training step -----------------------------------------------------------

def _edm_cfg(**kw):
    return JConfig(ds_model="edm", resolution=(16, 16), coords=(0, 16, 0, 16), lowres_scale=4,
                   standardization="pertimestep", dropout=0.0, **NET, **kw)


@pytest.fixture(scope="module")
def edm():
    """The JAX EDM model of ``build_edm_model`` with filled weights, and the
    port's model with the same weights, data on both sides."""
    cfg = _edm_cfg()
    jm = j_build_edm(cfg)
    x0 = np.zeros((1, 16, 16, 3), np.float32)
    params = _params(jm, x0, np.ones((1,), np.float32), x0, seed=13)
    return cfg, jm, params, _data()


def _port_model(cfg, params):
    tm = t_build_edm(TConfig(**vars(cfg)), device="cpu")
    tm.load_state_dict(flax_edm_to_torch(params))
    return tm


def _flat(tree):
    return {k: v.numpy() for k, v in flax_edm_to_torch(tree).items()}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_dsm_train_step_matches_jax(edm, compute_dtype):
    """One step of the JAX ``make_edm_train_step`` from a fresh AdamW state;
    its sigma and noise come from its own split of ``fold_in(rng, step)``,
    recomputed here and handed to the port's step; its gradients are read
    back from Adam's first moment, mu = (1 - b1) g after one step.
    bfloat16: the noisy input and the condition are rounded to bf16 on both
    sides, the denoiser runs fp32."""
    cfg, jm, params, (t_hr, t_stats, j_hr, j_stats) = edm
    jdt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    idx, rng = np.array([1, 4]), jax.random.key(7)
    tx = j_make_optimizer(lr=LR)
    jstep = jsteps.make_edm_train_step(jm, tx, 4, "pertimestep", compute_dtype=jdt, donate=False)
    new_state, j_metrics = jax.device_get(jstep(j_create(params, tx), j_hr, j_stats,
                                                jnp.asarray(idx), rng))
    r_sigma, r_noise, _ = jax.random.split(jax.random.fold_in(rng, 0), 3)
    sigma = jnp.exp(-1.2 + 1.2 * jax.random.normal(r_sigma, (2,)))
    noise = jax.random.normal(r_noise, (2, 16, 16, 3))

    tm = _port_model(cfg, params)
    state = t_create(tm, t_make_optimizer(lr=LR))
    step = tsteps.make_edm_train_step(tm, 4, "pertimestep", compute_dtype=tdt)
    m = step(state, t_hr, t_stats, torch.from_numpy(idx), 0, sigma=_t(sigma), noise=_t(noise))
    assert state.step == 1
    # fp32 through the network and back on both sides
    assert m["train_loss"].item() == pytest.approx(float(j_metrics["train_loss"]), rel=1e-4)
    assert m["grad_norm"].item() == pytest.approx(float(j_metrics["grad_norm"]), rel=1e-4)
    ref_g = {k: v / 0.1 for k, v in _flat(new_state.opt_state[0].mu).items()}
    ref_p = _flat(new_state.params)
    for name, p in tm.named_parameters():
        g = ref_g[name]
        scale = np.abs(g).max()
        # each gradient against its tensor's largest entry
        assert np.abs(p.grad.numpy() - g).max() <= 1e-3 * scale, name
        # Adam's first step moves each weight by ~lr sign(g): compared where
        # the gradient is clear of the gradient error
        clear = np.abs(g) > 1e-3 * scale
        d = np.abs(p.detach().numpy() - ref_p[name])
        assert d[clear].max(initial=0.0) <= 1e-6, name
        assert d.max() <= 2 * LR + 1e-6, name


def test_dsm_draws_follow_seed_and_step(edm):
    """Sigma, noise and dropout derive from (seed, micro-step): the same
    seed and step give the same loss, another seed another; remat replays
    the dropout masks (loss and gradients bit-equal at dropout 0.1)."""
    cfg, _, params, (t_hr, t_stats, _, _) = edm
    idx = torch.tensor([0, 3])

    def run(seed, remat=False):
        tm = t_build_edm(TConfig(**vars(cfg)).replace(dropout=0.1, remat=remat), device="cpu")
        tm.load_state_dict(flax_edm_to_torch(params))
        state = t_create(tm, t_make_optimizer(optimizer="sgd", lr=0.0))
        m = tsteps.make_edm_train_step(tm, 4, "pertimestep")(state, t_hr, t_stats, idx, seed)
        return m["train_loss"].item(), [p.grad.clone() for p in tm.parameters()]

    (a, ga), (b, _), (c, _) = run(7), run(7), run(8)
    assert a == b and a != c
    r, gr = run(7, remat=True)
    assert r == a
    for g1, g2 in zip(ga, gr):
        torch.testing.assert_close(g2, g1, rtol=0, atol=0)


# ---- the Heun chain and the ensemble functions -----------------------------------------

def test_heun_chain_matches_jax(edm):
    """JAX's ``edm_sample`` (3 steps: 5 denoiser passes) against the port's
    chain from the same initial noise; the schedule is the JAX chain's."""
    cfg, jm, params, _ = edm
    rng = jax.random.key(3)
    x_cond = _x((2, 16, 16, 3), 14)
    ref = jsteps.edm_sample(jm, params, jnp.asarray(x_cond), rng, num_steps=3)
    noise = np.asarray(jax.random.normal(rng, x_cond.shape))
    tm = _port_model(cfg, params).train()   # edm_sample sets eval mode itself
    calls = []
    tm.register_forward_hook(lambda *a: calls.append(1))
    out = tsteps.edm_sample(tm, _t(x_cond), num_steps=3, noise=_t(noise))
    assert len(calls) == 5 and not tm.training
    assert _rel_err(out.numpy(), ref) <= 1e-4
    s = jnp.arange(18, dtype=jnp.float32)
    t = (80.0 ** (1 / 7) + s / 17 * (0.002 ** (1 / 7) - 80.0 ** (1 / 7))) ** 7.0
    np.testing.assert_allclose(tsteps.karras_schedule(18)[:-1], np.asarray(t), rtol=1e-6)
    assert tsteps.karras_schedule(18)[-1] == 0.0


def test_sample_eval_and_crps_match_jax(edm):
    """``make_edm_sample_fn`` (K=2 chains folded K-major, HR output (B, K,
    H, W, C)), the eval step and the CRPS function against JAX's, with the
    noise and sigmas JAX draws from the same key."""
    cfg, jm, params, (t_hr, t_stats, j_hr, j_stats) = edm
    idx, rng = np.array([2, 5]), jax.random.key(11)
    j_sample = jsteps.make_edm_sample_fn(jm, 4, "pertimestep", 2, 3)
    ref, _ = j_sample(params, j_hr, j_stats, jnp.asarray(idx), rng)
    noise = _t(jax.random.normal(rng, (4, 16, 16, 3)))
    tm = _port_model(cfg, params)
    out, pair = tsteps.make_edm_sample_fn(tm, 4, "pertimestep", 2, 3)(
        t_hr, t_stats, torch.from_numpy(idx), noise=noise)
    assert out.shape == (2, 2, 16, 16, 3) and pair["hr"].shape == (2, 16, 16, 3)
    assert _rel_err(out.numpy(), ref) <= 1e-4
    assert (out[:, 0] - out[:, 1]).abs().max() > 0

    j_eval = jsteps.make_edm_eval_step(jm, 4, "pertimestep")(params, j_hr, j_stats,
                                                               jnp.asarray(idx), rng)
    r_sigma, r_noise = jax.random.split(rng)
    sigma = _t(jnp.exp(-1.2 + 1.2 * jax.random.normal(r_sigma, (2,))))
    ev = tsteps.make_edm_eval_step(tm, 4, "pertimestep")(
        t_hr, t_stats, torch.from_numpy(idx), 0, sigma=sigma,
        noise=_t(jax.random.normal(r_noise, (2, 16, 16, 3))))
    assert ev["val_loss"].item() == pytest.approx(float(j_eval["val_loss"]), rel=1e-4)

    j_crps = jsteps.make_edm_crps_eval_fn(jm, 4, "pertimestep", VARS, 2, 3)(
        params, j_hr, j_stats, jnp.asarray(idx), rng)
    crps = tsteps.make_edm_crps_eval_fn(tm, 4, "pertimestep", VARS, 2, 3)(
        t_hr, t_stats, torch.from_numpy(idx), noise=noise)
    assert sorted(crps) == sorted(j_crps)
    for k, v in crps.items():
        assert v.item() == pytest.approx(float(j_crps[k]), rel=1e-4), k


def test_parameter_count_at_full_width():
    """The default configuration (model_channels 128, channel_mult 1,2,3,4,
    2 blocks, attention at 32/16/8) at 128x128 with 3 variables: the port
    built on ``meta`` against ``jax.eval_shape`` of the JAX model."""
    cfg = JConfig(ds_model="edm", resolution=(128, 128))
    jm = j_build_edm(cfg)
    x = jnp.zeros((1, 128, 128, 3))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0),
                                             "dropout": jax.random.key(1)},
                                            x, jnp.ones((1,)), condition_img=x))["params"]
    j_count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    tm = t_build_edm(TConfig(ds_model="edm", resolution=(128, 128)), device="meta")
    t_count = sum(p.numel() for p in tm.parameters())
    assert t_count == j_count == 100_349_315


# ---- the trainer and serving -----------------------------------------------------------

# 24 train days at batch 4: 6 steps per epoch; 8 val days: 2 eval batches
TRAIN = dict(resolution=(16, 16), lowres_scale=4, batch_size=4, num_epochs=2,
             model_channels=8, channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,),
             standardization="pertimestep", ds_model="edm", log_every=1, num_samples=2,
             edm_steps=4, eval_crps=True, crps_samples=2)
SPLITS = {"train": (24, 1), "val": (8, 2), "test": (4, 3)}


def _hr(t, seed):
    return np.random.default_rng(seed).gamma(2.0, 1.0, (t, 16, 16, 3)).astype(np.float32)


def _dirs(tmp, tag):
    return dict(plotdir=os.path.join(str(tmp), f"plots_{tag}"),
                checkpoints_dir=os.path.join(str(tmp), f"ckpt_{tag}"))


def _records(cfg):
    with open(os.path.join(cfg.plotdir, "metrics_edm.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX ``train_edm`` once: 2 epochs of 6 steps, eval and CRPS."""
    tmp = tmp_path_factory.mktemp("jax_edm")
    cfg = JConfig(**TRAIN, **_dirs(tmp, "jax"))
    datasets = {k: JDataset(hr=_hr(t, s), standardization="pertimestep", lowres_scale=4)
                for k, (t, s) in SPLITS.items()}
    res = j_train_edm(cfg, datasets=datasets, make_plots=False)
    assert int(res["state"].step) == 12
    return {"cfg": cfg, "records": _records(cfg),
            "ckpt": os.path.join(cfg.checkpoints_dir, "edm")}


def _t_datasets(train_days=24):
    sizes = dict(SPLITS, train=(train_days, 1))
    return {k: TDataset(hr=_hr(t, s), standardization="pertimestep", lowres_scale=4,
                        device="cpu") for k, (t, s) in sizes.items()}


def test_train_edm_writes_the_jax_records(jax_run, tmp_path):
    """The port's ``train_baseline`` dispatches ``ds_model="edm"`` to
    ``train_edm``: the records of the JAX loop (keys, order, one CRPS record
    per epoch), finite, a falling DSM loss, the checkpoint under ``edm/``."""
    cfg = TConfig(**{**vars(jax_run["cfg"]), **_dirs(tmp_path, "port")})
    res = t_train_baseline(cfg, datasets=_t_datasets(), make_plots=False, device="cpu")
    assert res["state"].step == 12 and len(res["tr_losses"]) == 2
    recs = _records(cfg)
    assert [sorted(r) for r in recs] == [sorted(r) for r in jax_run["records"]]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    assert len([r for r in recs if "crps_pr" in r]) == 2
    # the seeded eval draws the same sigmas and noise every epoch, so its
    # loss shows the fit; an epoch's 6 training steps each draw new sigmas,
    # which move the lambda(sigma)-weighted train loss more than 2 epochs' fit
    assert res["val_losses"][-1] < res["val_losses"][0], res["val_losses"]
    assert os.path.isfile(os.path.join(cfg.checkpoints_dir, "edm", "state", "state.pt"))
    with pytest.raises(NotImplementedError, match="item 5"):
        t_train_baseline(cfg.replace(ds_model="linearcnn"), device="cpu")


def test_train_edm_exact_resume(tmp_path):
    """Bit-equal on the CPU: 2 steps, a checkpoint, resumed to the end of
    the epoch, against the uninterrupted run (dropout 0.1 drawn from the
    per-step streams)."""
    kw = dict(TRAIN, num_epochs=1, eval_crps=False, dropout=0.1)
    datasets = _t_datasets(train_days=16)
    a = t_train_edm(TConfig(**kw, max_steps=2, **_dirs(tmp_path, "a")), datasets, False, "cpu")
    assert a["state"].step == 2
    resume = os.path.join(str(tmp_path), "ckpt_a", "edm")
    b = t_train_edm(TConfig(**kw, resume=resume, **_dirs(tmp_path, "b")), datasets, False, "cpu")
    c = t_train_edm(TConfig(**kw, **_dirs(tmp_path, "c")), datasets, False, "cpu")
    assert b["state"].step == c["state"].step == 4
    for x, y in zip(b["state"].model.state_dict().values(), c["state"].model.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert b["val_losses"] == c["val_losses"]


def test_cli_trains_edm(tmp_path):
    """``python -m probunet_torch.train --ds_model edm --synthetic`` (run
    in this process): one epoch, the EDM metrics and checkpoint."""
    from probunet_torch.data.synthetic import generate_climex_like

    out = str(tmp_path)
    generate_climex_like(os.path.join(out, "data"), years=(2000, 2001, 2002), grid=16,
                         days_per_year=8)
    argv = ["--synthetic", "--device", "cpu", "--ds_model", "edm", "--datadir",
            os.path.join(out, "data"), "--years_train", "2000,2001", "--years_val", "2001,2002",
            "--years_test", "2002,2003", "--coords", "0,16,0,16", "--resolution", "16,16",
            "--batch_size", "4", "--num_epochs", "1", "--model_channels", "8",
            "--channel_mult", "1,2", "--num_blocks", "1", "--attn_resolutions", "8",
            "--edm_steps", "2", "--plotdir", os.path.join(out, "plots"),
            "--checkpoints_dir", os.path.join(out, "ckpt")]
    res = t_train_main(argv)
    assert res["state"].step == 2 and np.isfinite(res["tr_losses"]).all()
    assert os.path.getsize(os.path.join(out, "plots", "metrics_edm.jsonl")) > 0
    assert os.path.exists(os.path.join(out, "ckpt", "edm", "state", "state.pt"))


def test_downscale_edm_from_a_jax_checkpoint(jax_run, tmp_path, monkeypatch):
    """The JAX run's trained EDM checkpoint, carried across by
    ``flax_edm_to_torch``, served by the port's ``downscale`` (its command
    line, ``--ds_model edm``) and by the JAX package's, on the same netCDF
    days: (T, K, H, W) per variable, members that differ, and the port's
    members equal JAX's where each chain starts from the noise JAX draws
    for it (handed to the port's draw for each batch)."""
    from probunet_tpu.data.synthetic import generate_climex_like

    jcfg = jax_run["cfg"]
    tx = j_make_optimizer(jcfg.lr, jcfg.weight_decay)
    jstate = j_restore(jax_run["ckpt"], abstract_edm_state(jcfg, j_build_edm(jcfg), tx))
    tm = t_build_edm(TConfig(**vars(jcfg)), device="cpu")
    tm.load_state_dict(flax_edm_to_torch(jax.device_get(jstate.params)))
    port_ckpt = os.path.join(str(tmp_path), "port_ckpt")
    save_checkpoint(port_ckpt, TTrainState(tm, None, int(jstate.step)))

    datadir = os.path.join(str(tmp_path), "data")
    generate_climex_like(datadir, years=(2002,), grid=16, days_per_year=6, seed=5)
    cfg = jcfg.replace(datadir=datadir, years_test=(2002, 2003), coords=(0, 16, 0, 16),
                       batch_size=4)
    out_j = jax_downscale(cfg, jax_run["ckpt"], os.path.join(str(tmp_path), "jax.nc"),
                          num_samples=2, seed=0)

    # the port's per-batch draw of the chains' initial noise takes JAX's for
    # that batch: normal(fold_in(key(seed), bi), (K*B, H, W, C))
    randn, drawn = torch.randn, []

    def jax_noise(*shape, generator=None, **kw):
        if generator is None or shape != ((8, 16, 16, 3),):
            return randn(*shape, generator=generator, **kw)
        key = jax.random.fold_in(jax.random.key(0), len(drawn))
        drawn.append(shape[0])
        return _t(jax.random.normal(key, (8, 16, 16, 3)))

    monkeypatch.setattr(torch, "randn", jax_noise)
    out_t = os.path.join(str(tmp_path), "port.nc")
    argv = ["--ds_model", "edm", "--checkpoint", port_ckpt, "--out", out_t, "--device", "cpu",
            "--datadir", datadir, "--years_test", "2002,2003", "--num_samples", "2"]
    for k in ("resolution", "coords", "lowres_scale", "batch_size", "model_channels",
              "channel_mult", "num_blocks", "attn_resolutions", "standardization",
              "edm_steps"):
        val = getattr(cfg, k)
        argv += [f"--{k}", ",".join(map(str, val)) if isinstance(val, tuple) else str(val)]
    tserve.main(argv)
    monkeypatch.undo()
    assert len(drawn) == 2   # 6 days in batches of 4

    with NetCDFFile(out_j) as f, NetCDFFile(out_t) as g:
        for v in VARS:
            a, b = f.read_var(v), g.read_var(v)
            assert b.shape == a.shape == (6, 2, 16, 16)
            assert np.isfinite(b).all() and b.std(axis=1).mean() > 0
            # fp32 through 7 denoiser passes and the residual -> HR inverse
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4 * float(np.abs(a).max()))
