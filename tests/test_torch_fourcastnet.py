"""FourCastNet on the port (``probunet_torch/models/fourcastnet.py``,
``ds_model=fourcastnet``) against the plain reference
``perfbench/reference/fourcastnet.py`` on the CPU, at a tiny size: D 64,
depth 2, 8 filter blocks of 8, patch 4, a 32x64 grid (8x16 tokens: 8 rows
and the first 5 of 9 rfft2 columns kept), C = 3, b2. Seeded weights at
``AFNONet``'s own init (the benchmark's draw), the same dropout draws: the
forward, the MSE loss, every parameter's gradient and one AdamW step, in
strict (fp32) and fast (bf16 stream, fp32 filter) mode. Also the published
slice of modes, the published widths on ``meta`` (73,019,136 parameters),
the init, the filter's span and count, the draws' shards, and two training
steps through ``python -m probunet_torch.train --ds_model fourcastnet``.
"""

import os
import statistics

import numpy as np
import pytest
import torch

from perfbench import inputs
from perfbench.families.fourcastnet import published_weights
from perfbench.reference import fourcastnet as ref
from perfbench.reference.probunet import adamw_
from perfbench.reference.unet import fp32_math, make_pair, perpixel_stats, set_precision
from probunet_torch.config import Config, get_config
from probunet_torch.models.fourcastnet import AFNO2D, FourCastNet, kept_columns
from probunet_torch.models.layers import LayerNorm, reset_parameters
from probunet_torch.train.__main__ import main as t_train_main
from probunet_torch.train.loop import build_fourcastnet_model
from probunet_torch.train.state import create_train_state, make_optimizer
from probunet_torch.train.steps import make_deterministic_train_step

VARS = ("pr", "tasmin", "tasmax")
TINY = dict(resolution=(32, 64), embed_dim=64, depth=2, patch_size=4, mlp_ratio=4.0)
PUBLISHED = 73_019_136

# fp32: both sides sum in fp32 in other orders (the port's patch product
# and interleaved (re, im) block products with fused biases, the
# reference's conv and its four einsums a layer), ~1e-7 a rounding over
# some tens of roundings on the longest path; the FFTs are the same
# library's on both sides. Readings over seeds 5-8: 2.2e-7 to 3.2e-7
# (output), 4.3e-7 to 6.1e-7 (gradients), 0 to 2.1e-7 (loss). 1e-5 leaves
# over ten times that, and fails products rounded
# to TF32 (1e-4 and more here) or a bf16 stream.
FP32_TOL = 1e-5
# bf16 stream (the filter inside is fp32): 8 significant bits (u = 2^-9 =
# 1.95e-3), every activation outside the filters rounded again after each
# of the ~14 operations on the forward's longest path; the error grows at
# most linearly: 14 u = 2.7e-2 for the output. The loss averages 12,288
# squared errors whose roundings partly cancel: 2 u = 4e-3. Gradients by
# the benchmark's rule (``perfbench/compare.py``: a leaf's norm gap over
# its reference norm or the median leaf's, whichever is larger): 0.06. The
# filters' leaves alone, each against its own norm: their gradients are
# sums over the kept modes whose terms largely cancel (norms ~1e-3, a
# hundredth of a Linear's), so the stream's roundings show amplified:
# 0.15. Readings over seeds 5-8: output 5.4e-3 to 7.5e-3, loss under
# 7.1e-5, leaves 0.011 to 0.034, filters 0.047 to 0.075; the reference's
# own products in fp8 read 0.043 to 0.061, 0.090 to 0.120 and 0.195 to
# 0.229.
BF16_TOL = {"output": 2.7e-2, "loss": 4e-3, "leaf": 0.06, "filter": 0.15}
# One AdamW step from the same weights: the first update is lr g / (|g| +
# eps) plus the decay, about lr in size per element whatever g's size, so
# it is compared where the reference gradient is clear of the gradient's
# own error (above GRAD_FLOOR of the leaf's largest): there the two updates
# part by lr eps / |g|, the bf16 first moment's rounding (2^-9 lr) and the
# parameters' fp32 rounding (an ulp of a LayerNorm weight at 1 is 2.4e-4
# lr). Readings: fp32 2.4e-4 lr (that ulp), bf16 3.1e-3 lr; the limits
# leave four and thirteen times.
STEP_TOL = {"float32": 1e-3, "bfloat16": 4e-2}
GRAD_FLOOR = {"float32": 1e-4, "bfloat16": 0.3}


def ref_cfg(dropout=0.0, drop_path=0.0):
    c = TINY
    return {"resolution": list(c["resolution"]), "embed_dim": c["embed_dim"],
            "patch_size": c["patch_size"], "variables": list(VARS), "depth": c["depth"],
            "mlp_ratio": c["mlp_ratio"], "num_blocks": 8, "sparsity_threshold": 0.01,
            "hard_thresholding_fraction": 1.0, "drop_path": drop_path, "dropout": dropout}


def pair(dropout=0.0, drop_path=0.0, seed=5):
    """The port's model and the reference on the same seeded weights."""
    cfg = Config(ds_model="fourcastnet", dropout=dropout, drop_path=drop_path, **TINY)
    model = build_fourcastnet_model(cfg, device="meta").to_empty(device="cpu")
    rcfg = ref_cfg(dropout, drop_path)
    weights = published_weights(model, rcfg, seed, "cpu")
    model.load_state_dict(weights)
    with torch.device("meta"):
        r = ref.FourCastNet(rcfg)
    r = r.to_empty(device="cpu")
    r.load_state_dict(weights)
    return model, r


def readings(model, r, dtype, precision="fp32", b=2):
    """{output, loss, grad, leaf, filter}: the port's gaps to the reference
    in training mode on one batch, each draw from a generator seeded alike.
    output: the largest difference over the reference's largest element;
    grad: over the leaves, the same of each leaf's gradient; leaf: over the
    leaves, the norm of the gradient's difference over the larger of the
    leaf's and the median leaf's norm; filter: over the filters' leaves,
    that over the leaf's own norm."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(b, 32, 64, 3, generator=g)
    y = torch.randn(b, 32, 64, 3, generator=g)
    set_precision(r, precision)
    model.train()
    r.train()
    out = model(x.to(dtype), generator=torch.Generator().manual_seed(3))
    loss = (out.float() - y).square().mean()
    loss.backward()
    with fp32_math():
        want = r(x, torch.Generator().manual_seed(3))
        want_loss = (want - y).square().mean()
        want_loss.backward()
    got_p, want_p = dict(model.named_parameters()), dict(r.named_parameters())
    assert set(got_p) == set(want_p)
    grad = max(float((got_p[n].grad - p.grad).abs().max() / p.grad.abs().max())
               for n, p in want_p.items())
    norms = {n: float(p.grad.norm()) for n, p in want_p.items()}
    med = statistics.median(norms.values())
    gaps = {n: float((got_p[n].grad - p.grad).norm()) for n, p in want_p.items()}
    out, want = out.detach().float(), want.detach()
    return {"output": float((out - want).abs().max() / want.abs().max()),
            "loss": abs(loss.item() - want_loss.item()) / want_loss.item(), "grad": grad,
            "leaf": max(gaps[n] / max(norms[n], med) for n in norms),
            "filter": max(gaps[n] / norms[n] for n in norms if ".filter." in n)}


def test_published_widths_on_meta():
    """73,019,136 parameters at AFNO.yaml's backbone on the 720x1440 grid,
    C = 3: the port's and the reference's, by the same names and shapes;
    no final ``norm``."""
    cfg = Config(ds_model="fourcastnet", resolution=(720, 1440), patch_size=8, embed_dim=768,
                 depth=12)
    model = build_fourcastnet_model(cfg, device="meta")
    with torch.device("meta"):
        r = ref.FourCastNet({"resolution": [720, 1440], "embed_dim": 768, "patch_size": 8,
                             "variables": list(VARS), "depth": 12, "mlp_ratio": 4.0,
                             "num_blocks": 8, "sparsity_threshold": 0.01,
                             "hard_thresholding_fraction": 1.0, "drop_path": 0.0,
                             "dropout": 0.0})
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {n: tuple(p.shape) for n, p in r.named_parameters()}
    assert sum(p.numel() for p in model.parameters()) == PUBLISHED
    assert shapes["pos_embed"] == (1, 16200, 768)
    assert shapes["blocks.11.filter.w1"] == (2, 8, 96, 96)
    assert shapes["blocks.0.filter.b2"] == (2, 8, 96)
    assert shapes["head.weight"] == (192, 768) and "head.bias" not in shapes
    assert not any(n.startswith("norm.") for n in shapes)
    assert kept_columns(90, 180) == 46
    assert all(isinstance(m, LayerNorm) and m.eps == 1e-6
               for b in model.blocks for m in (b.norm1, b.norm2))


@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.3, 0.5)], ids=["published", "dropout"])
def test_fp32_matches_the_reference(rates):
    """Strict mode: output, loss and every gradient within FP32_TOL, at the
    published rates 0 and with dropout and drop_path on (the same draws);
    the same model run in bf16 reads past it."""
    got = readings(*pair(*rates), torch.float32)
    assert max(got.values()) <= FP32_TOL, got
    low = readings(*pair(*rates), torch.bfloat16)
    assert min(low["output"], low["grad"]) > FP32_TOL, low


def test_tf32_products_fail_the_fp32_tolerance():
    """The reference's own products rounded to TF32 against its fp32 self
    (the control one precision below strict mode's)."""
    _, r = pair()
    with torch.device("meta"):
        r32 = ref.FourCastNet(ref_cfg())
    r32 = r32.to_empty(device="cpu")
    r32.load_state_dict(r.state_dict())
    x = torch.randn(2, 32, 64, 3, generator=torch.Generator().manual_seed(1))
    r.eval()
    r32.eval()
    with torch.no_grad(), fp32_math():
        want = r32(x)
        low = set_precision(r, "tf32")(x)
    assert float((low - want).abs().max() / want.abs().max()) > FP32_TOL


def test_bf16_within_fast_limits():
    """Fast mode: the bf16 stream with the filter in fp32."""
    got = readings(*pair(), torch.bfloat16)
    assert all(got[k] <= BF16_TOL[k] for k in BF16_TOL), got


def test_filter_keeps_the_published_slice():
    """rfft2 of the filter's output minus its input is 0 (to fp32 rounding
    of the largest mode) in every column from h // 2 + 1 on, and not in the
    kept ones; a bf16 input gives a bf16 output."""
    f = AFNO2D(64, generator=torch.Generator().manual_seed(2))
    x = torch.randn(2, 8, 16, 64, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        y = f(x)
        assert f(x.bfloat16()).dtype == torch.bfloat16
    spec = torch.fft.rfft2(y - x, dim=(1, 2), norm="ortho")
    c1 = kept_columns(8, 16)
    assert (c1, spec.shape[2]) == (5, 9)
    top = float(spec.abs().max())
    assert float(spec[:, :, c1:].abs().max()) <= 1e-5 * top
    assert float(spec[:, :, :c1].abs().amax(dim=(0, 1, 3)).min()) > 1e-2 * top


def test_filters_count_and_span_once_a_block():
    """Two blocks: two ``probunet.spectral`` ranges a forward, beside one
    ``probunet.tokenize`` and one ``probunet.head`` (the spans are recorded
    under a profiler only)."""
    model, _ = pair()
    x = torch.randn(2, 32, 64, 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(x)
    names = [e.name for e in prof.events()]
    assert names.count("probunet.spectral") == 2
    assert names.count("probunet.tokenize") == 1 and names.count("probunet.head") == 1


def _one_step(dtype: str):
    """One training step of the port's deterministic step and of the
    reference (pair synthesis, MSE, backward, AdamW) from the same weights
    on the same days: ({leaf: port's change}, {leaf: reference's change},
    {leaf: reference gradient})."""
    days = inputs.climex_like(9, 6, 1, 64, VARS, "cpu")[:, :32].contiguous()
    stats = perpixel_stats(days, 4)
    idx = torch.tensor([1, 4])
    cfg = Config(ds_model="fourcastnet", dropout=0.0, drop_path=0.0, lr=5e-4,
                 weight_decay=1e-5, compute_dtype=dtype, opt_state_dtype=dtype, **TINY)
    model, r = pair()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, make_optimizer(cfg.lr, cfg.weight_decay, 1, "adamw", None,
                                                     cfg.opt_state_dtype))
    step = make_deterministic_train_step(model, 4, "perpixel", getattr(torch, dtype))
    m = step(state, days, stats, idx, torch.zeros(2), torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["train_loss"]))
    named = dict(r.named_parameters())
    with fp32_math():
        p = make_pair(days[idx], 4, stats)
        (r(p["inputs"]) - p["targets"]).square().mean().backward()
        grads = {n: q.grad.clone() for n, q in named.items()}
        adamw_(list(named.values()), {}, cfg.lr, cfg.weight_decay)
    got = {n: (q - start[n]).detach() for n, q in model.named_parameters()}
    return got, {n: (q - start[n]).detach() for n, q in named.items()}, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["strict", "fast"])
def test_one_adamw_step_matches_the_reference(dtype):
    """Per leaf, where the reference gradient is above GRAD_FLOOR of the
    leaf's largest, the two changes part by at most STEP_TOL lr; in strict
    mode that holds at least half of every leaf's elements."""
    lr = 5e-4
    got, want, grads = _one_step(dtype)
    worst = 0.0
    for n, w in want.items():
        clear = grads[n].abs() > GRAD_FLOOR[dtype] * grads[n].abs().max()
        assert float(clear.float().mean()) >= (0.5 if dtype == "float32" else 0.0), n
        worst = max(worst, float((got[n] - w)[clear].abs().max()) / lr)
    assert worst <= STEP_TOL[dtype]


def test_init_is_afnonets_and_replays_from_the_generator():
    """The port's own init: pos_embed and the Linears normal(0.02), the
    filters 0.02 randn, zero MLP biases, LayerNorms 1 and 0, the tokenizer
    U(+-1/sqrt(48)); drawing anew from a generator seeded alike gives the
    weights a fresh build got."""
    cfg = Config(ds_model="fourcastnet", **TINY)
    model = build_fourcastnet_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    assert 0.015 < float(model.pos_embed.detach().std()) < 0.025
    assert 0.015 < float(model.blocks[0].filter.w1.detach().std()) < 0.025
    assert torch.equal(model.blocks[1].norm2.weight, torch.ones(64))
    assert torch.equal(model.blocks[0].mlp.fc1.bias, torch.zeros(256))
    assert float(model.patch_embed.proj.weight.detach().abs().max()) <= 48 ** -0.5
    state = {k: v.clone() for k, v in model.state_dict().items()}
    reset_parameters(model, torch.Generator().manual_seed(4))
    assert all(torch.equal(v, state[k]) for k, v in model.state_dict().items())
    assert isinstance(model, FourCastNet)


def test_draws_are_the_shards_rows_of_the_global_batch():
    """A rank's rows with shard (j, 2) give the rows of the whole batch's
    result, dropout and drop_path alike (rates high enough to drop)."""
    model, _ = pair(0.3, 0.5)
    model.train()
    x = torch.randn(4, 32, 64, 3, generator=torch.Generator().manual_seed(2))
    whole = model(x, generator=torch.Generator().manual_seed(9))
    for j in range(2):
        part = model(x[2 * j:2 * j + 2], generator=torch.Generator().manual_seed(9),
                     shard=(j, 2))
        torch.testing.assert_close(part, whole[2 * j:2 * j + 2], rtol=1e-6, atol=1e-6)


def test_config_flags():
    """ClimaX's flags size FourCastNet; the filter keeps its published 8
    blocks whatever the width (here blocks of 8), and a width in no whole
    blocks is refused."""
    cfg = get_config(["--ds_model", "fourcastnet", "--embed_dim", "64", "--depth", "2",
                      "--patch_size", "4", "--resolution", "32,64"])
    model = build_fourcastnet_model(cfg, device="meta")
    assert len(model.blocks) == 2 and model.grid == (8, 16)
    assert tuple(model.blocks[1].filter.w2.shape) == (2, 8, 8, 8)
    with pytest.raises(ValueError):
        build_fourcastnet_model(Config(ds_model="fourcastnet", embed_dim=60), device="meta")


def test_cli_trains_fourcastnet(tmp_path):
    """``python -m probunet_torch.train --ds_model fourcastnet --device cpu
    --synthetic`` (run in this process) on a 16x32 grid: two steps through
    ``train_baseline`` and the deterministic step with the bf16 AdamW
    state, the per-variable losses, the validation MAE, the baseline
    metrics and checkpoint."""
    from probunet_torch.data.synthetic import generate_climex_like

    out = str(tmp_path)
    generate_climex_like(os.path.join(out, "data"), years=(2000, 2001, 2002), grid=32,
                         days_per_year=8)
    argv = ["--synthetic", "--device", "cpu", "--ds_model", "fourcastnet", "--datadir",
            os.path.join(out, "data"), "--years_train", "2000,2001", "--years_val", "2001,2002",
            "--years_test", "2002,2003", "--coords", "0,32,0,16", "--resolution", "16,32",
            "--batch_size", "4", "--num_epochs", "1", "--embed_dim", "64", "--depth", "2",
            "--dropout", "0", "--drop_path", "0",
            "--compute_dtype", "bfloat16", "--opt_state_dtype", "bfloat16",
            "--plotdir", os.path.join(out, "plots"),
            "--checkpoints_dir", os.path.join(out, "ckpt")]
    res = t_train_main(argv)
    assert res["state"].step == 2 and isinstance(res["state"].model, FourCastNet)
    assert all(len(res["tr_losses"][v]) >= 1 for v in VARS)
    assert all(np.isfinite(res["mae"][v]) for v in VARS)
    assert os.path.getsize(os.path.join(out, "plots", "metrics_baseline.jsonl")) > 0
    assert os.path.exists(os.path.join(out, "ckpt", "fourcastnet", "state", "state.pt"))
