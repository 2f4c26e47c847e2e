"""ClimaX on the port (``probunet_torch/models/climax.py``, ``ds_model=climax``)
against the plain reference ``perfbench/reference/climax.py`` on the CPU, at
a tiny size: D 64, depth 2, 4 heads of 16, patch 4, a 16x32 grid (L = 32),
V = 3. Seeded weights (the benchmark's N(0, 1) / sqrt(fan_in)), dropout and
stochastic depth on, the same draws: the forward, the MSE loss and every
parameter's gradient in fp32, and the bf16 path within fast-mode limits.
Also the published widths on ``meta`` (109,274,160 parameters), the init,
the draws' shards, the attention operands read in place, and two training
steps through ``python -m probunet_torch.train --ds_model climax``.
"""

import os

import numpy as np
import pytest
import torch

from perfbench import inputs
from perfbench.reference import climax as ref
from perfbench.reference.unet import fp32_math, set_precision
from probunet_torch.config import Config, get_config
from probunet_torch.models.climax import ClimaX
from probunet_torch.models.layers import reset_parameters
from probunet_torch.ops import attention as K2
from probunet_torch.train.__main__ import main as t_train_main
from probunet_torch.train.loop import build_climax_model

VARS = ("pr", "tasmin", "tasmax")
TINY = dict(resolution=(16, 32), embed_dim=64, depth=2, num_heads=4, patch_size=4,
            decoder_depth=2, mlp_ratio=4.0)
PUBLISHED = 109_274_160

# fp32: both sides sum in fp32 in other orders (the port's batched patch
# product and fused bias, its aggregation's einsum, the reference's conv
# and unet.Attention's einsums), ~1e-7 a rounding over some tens of
# roundings on the longest path: readings 4e-7 (output) and 8e-7
# (gradients). 1e-5 leaves ten times that, and fails products rounded to
# TF32 (5e-4 to 2e-3 here) or bf16 (7e-3 and more).
FP32_TOL = 1e-5
# bf16 keeps 8 significant bits (unit roundoff u = 2^-9 = 1.95e-3), and
# every activation is rounded again after each of the ~20 operations on
# the forward's longest path; the error grows at most linearly in them: 20
# u = 4e-2 for the output. A gradient's path runs back through all of them
# again: 40 u = 8e-2. The loss is a mean of 1,536 squared errors whose
# roundings partly cancel: 2 u = 4e-3. Readings 7e-3 to 8e-3 (output),
# 1.4e-2 to 2.1e-2 (gradients) and 3e-4 to 6e-4 (loss).
BF16_TOL = {"output": 4e-2, "grad": 8e-2, "loss": 4e-3}


def ref_cfg(dropout=0.1, drop_path=0.1, **kw):
    c = {**TINY, **kw}
    return {"resolution": list(c["resolution"]), "embed_dim": c["embed_dim"],
            "patch_size": c["patch_size"], "variables": list(VARS), "num_heads": c["num_heads"],
            "depth": c["depth"], "mlp_ratio": c["mlp_ratio"], "decoder_depth": c["decoder_depth"],
            "drop_path": drop_path, "dropout": dropout}


def pair(dropout=0.1, drop_path=0.1, fast=False, seed=5):
    """The port's model and the reference on the same seeded weights."""
    cfg = Config(ds_model="climax", dropout=dropout, drop_path=drop_path, fast_attention=fast,
                 **TINY)
    model = build_climax_model(cfg, device="meta").to_empty(device="cpu")
    weights = inputs.make_weights([(n, tuple(p.shape)) for n, p in model.state_dict().items()],
                                  seed, "cpu")
    model.load_state_dict(weights)
    with torch.device("meta"):
        r = ref.ClimaX(ref_cfg(dropout, drop_path))
    r = r.to_empty(device="cpu")
    r.load_state_dict(weights)
    return model, r


def readings(model, r, dtype, precision="fp32", b=4):
    """{output, loss, grad}: the port's gaps to the reference in training
    mode on one batch, each draw from a generator seeded alike. output:
    the largest difference over the reference's largest element; grad:
    over the leaves, the same of each leaf's gradient."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(b, 16, 32, 3, generator=g)
    y = torch.randn(b, 16, 32, 3, generator=g)
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
    grad = 0.0
    for n, p in want_p.items():
        top = p.grad.abs().max()
        if top > 0:
            grad = max(grad, float((got_p[n].grad - p.grad).abs().max() / top))
        else:   # the lead time's weight: its input is 0
            assert float(got_p[n].grad.abs().max()) == 0.0, n
    out, want = out.detach().float(), want.detach()
    return {"output": float((out - want).abs().max() / want.abs().max()),
            "loss": abs(loss.item() - want_loss.item()) / want_loss.item(), "grad": grad}


def test_published_widths_on_meta():
    """109,274,160 parameters at the 1.40625 deg model's widths, V = 3: the
    port's and the reference's, by the same names and shapes."""
    cfg = Config(ds_model="climax", resolution=(128, 256))
    model = build_climax_model(cfg, device="meta")
    with torch.device("meta"):
        r = ref.ClimaX({"resolution": [128, 256], "embed_dim": 1024, "patch_size": 4,
                        "variables": list(VARS), "num_heads": 16, "depth": 8, "mlp_ratio": 4.0,
                        "decoder_depth": 2, "drop_path": 0.1, "dropout": 0.1})
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {n: tuple(p.shape) for n, p in r.named_parameters()}
    assert sum(p.numel() for p in model.parameters()) == PUBLISHED
    assert shapes["pos_embed"] == (1, 2048, 1024)
    assert shapes["blocks.7.mlp.fc1.weight"] == (4096, 1024)
    assert shapes["head.4.weight"] == (48, 1024)
    assert [b.drop_path for b in model.blocks] == torch.linspace(0, 0.1, 8).tolist()


@pytest.mark.parametrize("rates", [(0.1, 0.1), (0.3, 0.5)], ids=["published", "heavy"])
def test_fp32_matches_the_reference(rates):
    """Output, loss and every gradient within FP32_TOL, with dropout and
    drop_path at the published rates and at heavier ones (more dropped
    samples); the same model run in bf16 reads past it."""
    got = readings(*pair(*rates), torch.float32)
    assert max(got.values()) <= FP32_TOL, got
    low = readings(*pair(*rates), torch.bfloat16)
    assert min(low["output"], low["grad"]) > FP32_TOL, low


def test_tf32_products_fail_the_fp32_tolerance():
    """The reference's own products rounded to TF32 against its fp32 self
    (the control one precision below the configuration's)."""
    model, r = pair()
    with torch.device("meta"):
        r32 = ref.ClimaX(ref_cfg())
    r32 = r32.to_empty(device="cpu")
    r32.load_state_dict(r.state_dict())
    x = torch.randn(2, 16, 32, 3, generator=torch.Generator().manual_seed(1))
    r.eval()
    r32.eval()
    with torch.no_grad(), fp32_math():
        want = r32(x)
        low = set_precision(r, "tf32")(x)
    assert float((low - want).abs().max() / want.abs().max()) > FP32_TOL


@pytest.mark.parametrize("fast", [False, True], ids=["strict_attention", "fast_attention"])
def test_bf16_within_fast_limits(fast):
    got = readings(*pair(fast=fast), torch.bfloat16)
    assert all(got[k] <= BF16_TOL[k] for k in BF16_TOL), got


def test_draws_are_the_shards_rows_of_the_global_batch():
    """A rank's rows with shard (j, 2) give the rows of the whole batch's
    result, dropout and drop_path alike (rates high enough to drop)."""
    model, _ = pair(0.3, 0.5)
    model.train()
    x = torch.randn(4, 16, 32, 3, generator=torch.Generator().manual_seed(2))
    whole = model(x, generator=torch.Generator().manual_seed(9))
    for j in range(2):
        part = model(x[2 * j:2 * j + 2], generator=torch.Generator().manual_seed(9),
                     shard=(j, 2))
        torch.testing.assert_close(part, whole[2 * j:2 * j + 2], rtol=1e-6, atol=1e-6)
    model.eval()
    torch.testing.assert_close(model(x), model(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_operands_are_read_in_place(dtype):
    """The q/k/v views of the qkv Linear's (B, L, 3 D) output, laid out (3,
    heads, 64), are what the kernels read where they lie: a unit-stride
    head dim and 16-byte rows, so ``kernel_layout`` copies none of them."""
    lin = torch.nn.Linear(1024, 3 * 1024).to(dtype)
    qkv = lin(torch.randn(2, 40, 1024, dtype=dtype)).view(2, 40, 3, 16, 64)
    for t in qkv.unbind(2):
        assert K2._in_place(t) and K2.kernel_layout(t) is t


def test_init_is_climax_and_replays_from_the_generator():
    """The port's own init: sincos pos_embed and var_embed, a zero
    var_query, LayerNorms at 1 and 0, zero Linear biases; drawing anew from
    a generator seeded alike gives the weights a fresh build got."""
    cfg = Config(ds_model="climax", **TINY)
    model = build_climax_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    pe = model.pos_embed[0]
    assert torch.equal(pe[0, :16], torch.zeros(16)) and torch.equal(pe[0, 16:32], torch.ones(16))
    assert torch.equal(model.var_query, torch.zeros(1, 1, 64))
    assert torch.equal(model.blocks[1].norm2.weight, torch.ones(64))
    assert torch.equal(model.blocks[0].attn.qkv.bias, torch.zeros(192))
    assert 0.015 < float(model.blocks[0].mlp.fc1.weight.detach().std()) < 0.025
    state = {k: v.clone() for k, v in model.state_dict().items()}
    reset_parameters(model, torch.Generator().manual_seed(4))
    assert all(torch.equal(v, state[k]) for k, v in model.state_dict().items())
    assert isinstance(model, ClimaX)


def test_config_flags():
    cfg = get_config(["--ds_model", "climax", "--embed_dim", "64", "--depth", "2",
                      "--num_heads", "4", "--patch_size", "2", "--decoder_depth", "1",
                      "--mlp_ratio", "2.5", "--drop_path", "0.2"])
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.patch_size, cfg.decoder_depth,
            cfg.mlp_ratio, cfg.drop_path) == (64, 2, 4, 2, 1, 2.5, 0.2)
    assert Config().embed_dim == 1024 and Config().depth == 8 and Config().num_heads == 16


def test_cli_trains_climax(tmp_path):
    """``python -m probunet_torch.train --ds_model climax --device cpu
    --synthetic`` (run in this process) on a 16x32 grid: two steps through
    ``train_baseline`` and the deterministic step, the per-variable losses,
    the validation MAE, the baseline metrics and checkpoint."""
    from probunet_torch.data.synthetic import generate_climex_like

    out = str(tmp_path)
    generate_climex_like(os.path.join(out, "data"), years=(2000, 2001, 2002), grid=32,
                         days_per_year=8)
    argv = ["--synthetic", "--device", "cpu", "--ds_model", "climax", "--datadir",
            os.path.join(out, "data"), "--years_train", "2000,2001", "--years_val", "2001,2002",
            "--years_test", "2002,2003", "--coords", "0,32,0,16", "--resolution", "16,32",
            "--batch_size", "4", "--num_epochs", "1", "--embed_dim", "64", "--depth", "2",
            "--num_heads", "4", "--compute_dtype", "bfloat16", "--fast_attention", "true",
            "--opt_state_dtype", "bfloat16", "--plotdir", os.path.join(out, "plots"),
            "--checkpoints_dir", os.path.join(out, "ckpt")]
    res = t_train_main(argv)
    assert res["state"].step == 2 and isinstance(res["state"].model, ClimaX)
    assert all(len(res["tr_losses"][v]) >= 1 for v in VARS)
    assert all(np.isfinite(res["mae"][v]) for v in VARS)
    assert os.path.getsize(os.path.join(out, "plots", "metrics_baseline.jsonl")) > 0
    assert os.path.exists(os.path.join(out, "ckpt", "climax", "state", "state.pt"))
