"""The plain reference against the program's plain CPU path at a small size,
and the counts at the cells' shapes (CPU only)."""

import math

import pytest
import torch

from perfbench import counts, harness, inputs
from perfbench.reference import edm as ref_edm
from perfbench.reference import probunet as ref_pu
from perfbench.reference.unet import make_pair, perpixel_stats, round_operand

SMALL = {"resolution": [16, 16], "model_channels": 32, "channel_mult": [1, 2],
         "attn_resolutions": [8], "num_blocks": 1, "num_filters": [8, 16], "latent_dim": 4,
         "edm_steps": 4}
FULL = harness.load_json(harness.HERE / "configs" / "probunet_mc128.json")
FULL_EDM = harness.load_json(harness.HERE / "configs" / "edm_mc128.json")


def _cfg(base, **kw):
    return {**base, **SMALL, **kw}


def _both(cfg, program, reference):
    """The program model on the CPU and the reference, with the same weights."""
    ref = reference(cfg)
    shapes = [(n, tuple(p.shape)) for n, p in ref.state_dict().items()]
    w = inputs.make_weights(shapes, 7, "cpu")
    ref.load_state_dict(w)
    program.load_state_dict(w)
    return program, ref


def _data(cfg, days=24):
    hr = inputs.climex_like(5, days // 2, 2, cfg["resolution"][0], cfg["variables"], "cpu")
    return hr, perpixel_stats(hr, cfg["lowres_scale"])


def test_the_pair_matches_the_program():
    from probunet_torch.data import transforms

    cfg = _cfg(FULL)
    hr, stats = _data(cfg)
    got = transforms.make_pair(hr[:4], 4, "perpixel",
                               transforms.compute_lr_stats(hr, 4, "perpixel"))
    want = make_pair(hr[:4], 4, stats)
    for k in ("inputs", "targets", "lrinterp"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-4)


def test_the_elbo_and_its_gradients_match_the_program():
    from probunet_torch.config import Config
    from probunet_torch.train.loop import build_probunet

    cfg = _cfg(FULL)
    pc = Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()
                   if k in ("variables", "latent_dim", "num_filters", "model_channels",
                            "channel_mult", "num_blocks", "attn_resolutions", "dropout",
                            "resolution")})
    prog, ref = _both(cfg, build_probunet(pc, device="cpu"), ref_pu.ProbUNet)
    hr, stats = _data(cfg)
    pair = make_pair(hr[:4], 4, stats)
    x, y = pair["inputs"], pair["targets"]
    eps = torch.randn(4, cfg["latent_dim"], generator=torch.Generator().manual_seed(1))
    prog.train()
    ref.train()
    got = prog.elbo(x, y, 1.0, generator=torch.Generator().manual_seed(2), eps=eps)
    want = ref.elbo(x, y, eps, torch.Generator().manual_seed(2))
    for g, w in zip(got, want):
        assert g.item() == pytest.approx(w.item(), rel=1e-5)
    got[0].backward()
    want[0].backward()
    grads = dict(ref.named_parameters())

    def grad(p):
        return p.grad if p.grad is not None else torch.zeros_like(p)

    for name, p in prog.named_parameters():
        w = grad(grads[name])
        torch.testing.assert_close(grad(p), w, rtol=1e-4, atol=1e-4 * float(w.abs().max()) + 1e-12)


def test_the_sampler_matches_the_program():
    from probunet_torch.config import Config
    from probunet_torch.train.loop import build_probunet
    from probunet_torch.train.steps import make_sample_fn

    cfg = _cfg(FULL)
    pc = Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()
                   if k in ("variables", "latent_dim", "num_filters", "model_channels",
                            "channel_mult", "num_blocks", "attn_resolutions", "resolution")})
    prog, ref = _both(cfg, build_probunet(pc, device="cpu"), ref_pu.ProbUNet)
    hr, stats = _data(cfg)
    idx = torch.tensor([3, 1, 7])
    eps = torch.randn(5, 3, cfg["latent_dim"], generator=torch.Generator().manual_seed(3))
    got, _ = make_sample_fn(prog, 4, "perpixel", 5)(hr, stats, idx, eps=eps)
    want = ref_pu.sample_residuals(ref, hr, stats, idx, eps, 4)
    pair = want["pair"]
    torch.testing.assert_close((got - pair["lrinterp"][:, None]) / pair["denom"],
                               want["residual"], rtol=1e-4, atol=1e-4)


def test_the_heun_chain_matches_the_program():
    from probunet_torch.config import Config
    from probunet_torch.train.loop import build_edm_model
    from probunet_torch.train.steps import make_edm_sample_fn

    cfg = _cfg(FULL_EDM)
    pc = Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()
                   if k in ("variables", "model_channels", "channel_mult", "num_blocks",
                            "attn_resolutions", "resolution")})
    prog, ref = _both(cfg, build_edm_model(pc, device="cpu"), ref_edm.EDMPrecond)
    hr, stats = _data(cfg)
    idx = torch.tensor([2, 5])
    noise = torch.randn(6, 16, 16, 3, generator=torch.Generator().manual_seed(4))
    got, _ = make_edm_sample_fn(prog, 4, "perpixel", 3, cfg["edm_steps"])(hr, stats, idx,
                                                                         noise=noise)
    want = ref_edm.sample_residuals(ref, hr, stats, idx, noise, cfg)
    pair = want["pair"]
    residual = (got - pair["lrinterp"][:, None]) / pair["denom"]
    assert float((residual - want["residual"]).abs().max()) < 1e-3 * float(
        want["residual"].abs().max())


def test_parameter_counts_are_the_published_ones():
    with torch.device("meta"):
        assert sum(p.numel() for p in ref_pu.ProbUNet(FULL).parameters()) == FULL["parameters"]
        assert sum(p.numel() for p in ref_edm.EDMPrecond(FULL_EDM).parameters()) == \
            FULL_EDM["parameters"]


def test_flops_at_128x128():
    """Per sample: 293.5 GFLOP forward and 586.8 backward. The port's plain
    attention backward also recomputes Q K^T (2 B h L^2 c a site, 4.43 GFLOP
    a sample; 591.2 with it); the work a backward needs leaves it out."""
    with torch.device("meta"):
        model = ref_pu.ProbUNet(FULL)
        x, y, eps = torch.empty(1, 128, 128, 3), torch.empty(1, 128, 128, 3), torch.empty(1, 6)
    model.train()
    fwd = counts.count(model, lambda: model.elbo(x, y, eps), 4, backward=False)
    both = counts.count(model, lambda: model.elbo(x, y, eps)[0].backward(), 4, backward=True)
    assert fwd["flops"] / 1e9 == pytest.approx(293.5, abs=0.05)
    assert (both["flops"] - fwd["flops"]) / 1e9 == pytest.approx(586.8, abs=0.05)
    recompute = sum(2 * s["flops"] / 4 for s in fwd["attn"])
    assert (both["flops"] - fwd["flops"] + recompute) / 1e9 == pytest.approx(591.2, abs=0.05)
    assert len(fwd["gn"]) == 29 and len(fwd["attn"]) == 11


def test_sampler_and_denoiser_flops_at_128x128():
    with torch.device("meta"):
        model = ref_pu.ProbUNet(FULL)
        edm = ref_edm.EDMPrecond(FULL_EDM)
        x, eps = torch.empty(1, 128, 128, 3), torch.empty(16, 1, 6)
        sigma = torch.ones(1)
    with torch.no_grad():
        sample = counts.count(model, lambda: model.sample(x, eps), 2, backward=False)
        one = counts.count(edm, lambda: edm(x, sigma, x), 4, backward=False)
    assert sample["flops"] / 1e9 == pytest.approx(295.9, abs=0.05)
    assert one["flops"] / 1e9 == pytest.approx(287.3, abs=0.05)


def test_the_controls_round_as_stated():
    t = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -9, -3.0 - 2 ** -12])
    assert round_operand(t, "tf32").tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -9, -3.0]
    x = torch.linspace(-3, 3, 1001)
    err = (round_operand(x, "fp8") - x).abs().max()
    assert 0 < float(err) <= 3 / 448 * 16 and math.isfinite(float(err))
