"""CorrDiff on the port (on the CPU): the DDPM++ U-Net block against the
JAX block with the same fields set and the same weights; CorrDiff's
regression pass, residual denoiser and a 3-step two-stage sample against
the benchmark's plain reference (``perfbench/reference/corrdiff.py``) on
seeded weights; the 448x448 network on ``meta`` against the reference's;
the ADM U-Net left as it was; ``serve.downscale --ds_model corrdiff``; and
training refused.

Small size: 32x32, model_channels 32, channel_mult 1,2,2, one block a
level, attention at 8x8, where one head takes all 64 channels.
"""

import math
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perfbench import inputs as pinputs
from perfbench.reference import corrdiff as rcd
from perfbench.reference import unet as runet
from probunet_torch import serve as tserve
from probunet_torch.config import Config
from probunet_torch.models import layers as tl
from probunet_torch.models import unet as tunet
from probunet_torch.models.corrdiff import CorrDiff
from probunet_torch.ops.gn_silu import plan as gn_plan
from probunet_torch.ops.norm import num_groups_for
from probunet_torch.train import steps as tsteps
from probunet_torch.train.checkpoint import save_checkpoint
from probunet_torch.train.loop import (
    build_corrdiff_model,
    build_edm_model,
    train_baseline,
)
from probunet_torch.train.state import TrainState
from probunet_torch.utils.transplant import flax_unet_to_torch
from probunet_tpu.models.unet import UNetBlock as JUNetBlock

SMALL = dict(resolution=(32, 32), model_channels=32, channel_mult=(1, 2, 2), num_blocks=1,
             attn_resolutions=(8,), dropout=0.0)
REF_CFG = {"variables": ["pr", "tasmin", "tasmax"], "resolution": [32, 32], "lowres_scale": 4,
           "model_channels": 32, "channel_mult": [1, 2, 2], "num_blocks": 1,
           "attn_resolutions": [8], "sigma_data": 0.5, "sigma_min": 0.002, "sigma_max": 80.0,
           "rho": 7.0, "edm_steps": 3}
DDPM_BLOCK = dict(num_heads=1, skip_scale=math.sqrt(0.5), eps=1e-6, resample_proj=True,
                  adaptive_scale=False)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _params(module, *args, seed):
    """Random JAX params from the abstract init, each leaf standard normal /
    sqrt(fan_in) (conv1 and proj are not left at zero, which would hide
    most of the block)."""
    shapes = jax.eval_shape(lambda: flax.linen.Module.init(
        module, {"params": jax.random.key(0)}, *args))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) / np.sqrt(
        max(1, int(np.prod(s.shape[:-1]))))).astype(np.float32), shapes)


def _assert_close(out, ref, rel):
    """Max abs difference within ``rel`` of the reference's largest value."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


# (in, out, up, down, attention) at 8x8: the attention block (one head of
# 64), a down and an up block (1x1 skip convs with resample_proj), a block
# that widens (1x1 skip)
BLOCKS = [(64, 64, False, False, True), (32, 32, False, True, False),
          (32, 32, True, False, False), (32, 64, False, False, False)]


@pytest.mark.parametrize("cin,cout,up,down,attention", BLOCKS)
def test_ddpmpp_block_matches_jax(cin, cout, up, down, attention):
    """The port's UNetBlock with the DDPM++ fields (one head, skip_scale
    sqrt(1/2), eps 1e-6, resample_proj, the embedding as a shift through
    K1) against the JAX UNetBlock with the same four fields and eps set,
    the same weights carried across by flax_unet_to_torch."""
    emb = 32
    jm = JUNetBlock(cin, cout, emb, up=up, down=down, attention=attention, **DDPM_BLOCK)
    x, e = _x((2, 8, 8, cin), 1), _x((2, emb), 2)
    params = _params(jm, jnp.asarray(x), jnp.asarray(e), seed=3)
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(e))
    tm = tunet.UNetBlock(cin, cout, emb, up=up, down=down, attention=attention, device="cpu",
                         **DDPM_BLOCK).eval()
    assert isinstance(tm.norm1, tl.GroupNormSiLU) and tm.affine.out_features == cout
    assert tm.heads == (1 if attention else 0)
    assert (tm.skip is not None and tm.skip.kernel) == (up or down or cin != cout)
    prefix = "enc.8x8_block0."
    tm.load_state_dict({k[len(prefix):]: v for k, v in
                        flax_unet_to_torch({"enc_8x8_block0": params}).items()})
    with torch.no_grad():
        out = tl.nhwc(tm(tl.nchw(torch.from_numpy(x)), torch.from_numpy(e)))
    # fp32 through two convs, two norms (and the attention): the ADM
    # block's limit, 1e-4 of the output's scale
    _assert_close(out.numpy(), ref, 1e-4)


def _pair():
    """The port's small CorrDiff and the reference, on the benchmark's seeded
    weights, and a condition."""
    model = build_corrdiff_model(Config(ds_model="corrdiff", **SMALL), device="cpu").eval()
    shapes = [(n, tuple(p.shape)) for n, p in model.state_dict().items()]
    weights = pinputs.make_weights(shapes, 5, torch.device("cpu"))
    model.load_state_dict(weights)
    ref = rcd.CorrDiff(REF_CFG).eval()
    ref.load_state_dict(weights)
    return model, ref


def test_corrdiff_regression_and_denoiser_match_the_reference():
    """mu = F_reg([0, x]; 0) and D(r; sigma, x) at three noise levels
    against the plain reference: the same parameter names and shapes, the
    same answers to fp32 rounding in another order (1e-5 of each answer's
    scale: ~60 layers of fp32 sums, one attention site a U-Net)."""
    model, ref = _pair()
    assert {n: p.shape for n, p in model.state_dict().items()} == \
        {n: p.shape for n, p in ref.state_dict().items()}
    x = torch.from_numpy(_x((2, 32, 32, 3), 7))
    r = torch.from_numpy(_x((2, 32, 32, 3), 8))
    with torch.no_grad():
        _assert_close(model.regression(x), ref.regression(x), 1e-5)
        for sigma in (0.002, 1.0, 80.0):
            s = torch.full((2,), sigma)
            _assert_close(model(r * sigma, s, condition_img=x), ref(r * sigma, s, x), 1e-5)


def test_corrdiff_two_stage_sample_matches_the_reference():
    """``make_corrdiff_sample_fn`` (K = 2 members of 2 days, 3 Heun steps:
    5 residual passes after the regression) against the reference's
    ``sample_residuals`` on the same days and noise: the standardized
    members mu + r_k within the benchmark's residual_gap measure, 2e-5
    (fp32 on both sides; the CPU reads 2-5e-6 here)."""
    model, ref = _pair()
    hr = pinputs.climex_like(11, 8, 1, 32, REF_CFG["variables"], torch.device("cpu"))
    stats = runet.perpixel_stats(hr, 4)
    idx = torch.tensor([3, 5])
    noise = torch.from_numpy(_x((4, 32, 32, 3), 12))
    fn = tsteps.make_corrdiff_sample_fn(model, 4, "perpixel", 2, 3)
    hr_preds, pair = fn(hr, stats, idx, noise=noise)
    assert hr_preds.shape == (2, 2, 32, 32, 3)
    want = rcd.sample_residuals(ref, hr, stats, idx, noise, REF_CFG)
    got = (hr_preds - want["pair"]["lrinterp"][:, None]) / want["pair"]["denom"]
    from perfbench.compare import residual_gap

    assert residual_gap(got, want["residual"]) <= 2e-5
    # the members differ, and each is mu plus its own chain
    assert (got[:, 0] - got[:, 1]).abs().mean() > 1e-3


def test_corrdiff_sample_spans_in_order(monkeypatch):
    """The sampler's phases: pair, regression, forward (the chains), output."""
    model, _ = _pair()
    seen = []
    real = tsteps.span

    def spy(name):
        seen.append(name)
        return real(name)

    monkeypatch.setattr(tsteps, "span", spy)
    hr = pinputs.climex_like(11, 8, 1, 32, REF_CFG["variables"], torch.device("cpu"))
    fn = tsteps.make_corrdiff_sample_fn(model, 4, "perpixel", 2, 2)
    fn(hr, runet.perpixel_stats(hr, 4), torch.tensor([0]), noise=torch.zeros(2, 32, 32, 3))
    assert seen == ["probunet.sample", "probunet.pair", "probunet.regression",
                    "probunet.forward", "probunet.output"]


def test_corrdiff_at_448_on_meta_matches_the_reference():
    """ddpmpp-cwb at 448x448 on ``meta``: the plan's blocks (five levels,
    four blocks each, the bottleneck's two), the six attention sites (four
    encoder blocks, the bottleneck's in0 and the 28x28 level's last decoder
    block, one head of 256 each), the K1 sites and which of them stream, and
    79,985,411 parameters a U-Net, the reference's names and shapes."""
    cfg = Config(ds_model="corrdiff", resolution=(448, 448), model_channels=128,
                 channel_mult=(1, 2, 2, 2, 2), num_blocks=4, attn_resolutions=(28,))
    model = build_corrdiff_model(cfg, device="meta")
    enc, dec, final = tunet.build_unet_plan((448, 448), 6, 128, (1, 2, 2, 2, 2), 4, (28,),
                                            ddpmpp=True)
    renc, rdec, rfinal = rcd.songunet_plan(448, 6, 128, (1, 2, 2, 2, 2), 4, (28,))
    assert [(s.name, s.kind, s.in_channels, s.out_channels, s.up, s.down, s.attention,
             s.concat_skip) for s in enc + dec] == renc + rdec
    assert final == rfinal == 128 and len(enc) == 25 and len(dec) == 31
    attn = [(n, b.heads, b.qkv.weight.shape[1]) for n, b in model.reg.named_modules()
            if getattr(b, "heads", 0)]
    assert attn == [(f"enc.28x28_block{i}", 1, 256) for i in range(4)] + \
        [("dec.28x28_in0", 1, 256), ("dec.28x28_block4", 1, 256)]
    sites = tunet.gn_silu_sites(enc, dec, final, (448, 448))
    assert len(sites) == 2 * (24 + 31) + 1 and sites[-1] == (448, 448, 128)
    # K1 streams the slices too large for a cluster: 26 of a pass's 111 at
    # one row (the regression) and at two (the chains), as counted on the card
    for rows in (1, 2):
        plans = [gn_plan(rows, h, w, c, num_groups_for(c), 4, 132) for h, w, c in sites]
        assert sum(not p.on_chip for p in plans) == 26
    for unet in (model.reg, model.res):
        assert sum(p.numel() for p in unet.parameters()) == 79_985_411
    with torch.device("meta"):
        ref = rcd.CorrDiff({**REF_CFG, "resolution": [448, 448], "model_channels": 128,
                            "channel_mult": [1, 2, 2, 2, 2], "num_blocks": 4,
                            "attn_resolutions": [28]})
    assert {n: p.shape for n, p in model.state_dict().items()} == \
        {n: p.shape for n, p in ref.state_dict().items()}


def test_adm_unet_keeps_its_parameters_and_names():
    """The ADM U-Net with the new fields at their defaults: the EDM
    configuration's 100,349,315 parameters under the benchmark reference's
    names and shapes, its blocks' ADM settings, no aux layers, no scaling."""
    model = build_edm_model(Config(ds_model="edm", resolution=(128, 128)), device="meta")
    assert sum(p.numel() for p in model.parameters()) == 100_349_315
    with torch.device("meta"):
        ref = runet.UNet(128, 6, 3, 128, (1, 2, 3, 4), 2, (32, 16, 8), 0.1,
                         noise_embedding=True)
    assert {f"model.{n}": p.shape for n, p in ref.state_dict().items()} == \
        {n: p.shape for n, p in model.state_dict().items()}
    blocks = [m for m in model.modules() if isinstance(m, tunet.UNetBlock)]
    # norm1 runs through K1 with the (scale, shift) pair in the same launch
    assert blocks and all(b.adaptive_scale and b.skip_scale == 1 and
                          isinstance(b.norm1, tl.GroupNormSiLU) and b.norm1.eps == 1e-5
                          for b in blocks)
    assert [b.heads for b in blocks if b.heads] == [6, 6, 8, 8, 8, 8, 8, 8, 6, 6, 6]


def test_serve_downscales_with_corrdiff(tmp_path):
    """``python -m probunet_torch.serve --ds_model corrdiff`` on the CPU:
    a saved CorrDiff checkpoint served over a year of synthetic days, K = 2
    members a day from the two-stage sampler, (T, K, H, W) per variable,
    finite, the members apart."""
    from probunet_torch.data.netcdf import NetCDFFile
    from probunet_torch.data.synthetic import generate_climex_like

    datadir = os.path.join(str(tmp_path), "data")
    generate_climex_like(datadir, years=(2002,), grid=32, days_per_year=5, seed=3)
    cfg = Config(ds_model="corrdiff", datadir=datadir, coords=(0, 32, 0, 32), **SMALL)
    model = build_corrdiff_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    shapes = [(n, tuple(p.shape)) for n, p in model.state_dict().items()]
    model.load_state_dict(pinputs.make_weights(shapes, 9, torch.device("cpu")))
    ckpt = os.path.join(str(tmp_path), "ckpt")
    save_checkpoint(ckpt, TrainState(model, None, 0))
    out = os.path.join(str(tmp_path), "corrdiff.nc")
    argv = ["--ds_model", "corrdiff", "--checkpoint", ckpt, "--out", out, "--device", "cpu",
            "--datadir", datadir, "--years_test", "2002,2003", "--num_samples", "2",
            "--batch_size", "4", "--coords", "0,32,0,32", "--resolution", "32,32",
            "--model_channels", "32", "--channel_mult", "1,2,2", "--num_blocks", "1",
            "--attn_resolutions", "8", "--edm_steps", "2"]
    tserve.main(argv)
    with NetCDFFile(out) as f:
        for v in ("pr", "tasmin", "tasmax"):
            a = f.read_var(v)
            assert a.shape == (5, 2, 32, 32)
            assert np.isfinite(a).all() and np.abs(a[:, 0] - a[:, 1]).mean() > 0


def test_training_corrdiff_is_refused():
    """Training entry points refuse corrdiff, naming the missing K3 build."""
    with pytest.raises(NotImplementedError, match="K3"):
        train_baseline(Config(ds_model="corrdiff", **SMALL), device="cpu")


def test_corrdiff_holds_two_ddpmpp_unets():
    model = CorrDiff((32, 32), 3, 3, model_channels=32, channel_mult=(1, 2, 2), num_blocks=1,
                     attn_resolutions=(8,), device="meta")
    assert model.sigma_data == 0.5
    assert model.reg.ddpmpp and model.res.ddpmpp
    assert set(n.split(".")[0] for n in model.state_dict()) == {"reg", "res"}
    assert "reg.dec.32x32_aux_conv.weight" in model.state_dict()
    assert not any(n.startswith(("reg.out_", "res.out_")) for n in model.state_dict())
