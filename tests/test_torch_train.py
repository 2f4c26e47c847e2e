"""The port's training path on the CPU against the JAX package: the attention
and GroupNorm+SiLU backwards, the ELBO and its gradients, and three-step
training traces, at small width (``PROB_KW``: 16x16, model_channels 64,
attention on) with the same weights, carried across by
``flax_probunet_to_torch``, and the same numpy inputs and noise."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import PROB_KW, _params

from probunet_torch.data import transforms as tt
from probunet_torch.models import ProbabilisticUNet as TProbUNet
from probunet_torch.models.layers import dropout
from probunet_torch.ops import _build
from probunet_torch.ops import attention as tatt
from probunet_torch.ops import crps as tcrps
from probunet_torch.ops import gn_silu as tgn
from probunet_torch.ops.norm import num_groups_for
from probunet_torch.train import steps as tsteps
from probunet_torch.train.state import create_train_state as t_create
from probunet_torch.train.state import make_optimizer as t_make_optimizer
from probunet_torch.utils.transplant import flax_probunet_to_torch
from probunet_tpu.data import transforms as jt
from probunet_tpu.models import ProbabilisticUNet as JProbUNet
from probunet_tpu.ops import crps as jcrps
from probunet_tpu.ops.pallas_attn import fused_attention as jax_fused_attention
from probunet_tpu.ops.pallas_gn import gn_silu as jax_gn_silu
from probunet_tpu.train.state import make_optimizer as j_make_optimizer
from probunet_tpu.train.steps import beta_schedule as j_beta_schedule

LATENT = 4
LR = 1e-3


def _rel_err(out, ref):
    """max |out - ref| / max |ref|, both as fp32 numpy."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _np(t):
    return t.detach().float().numpy()


# ---- attention backward ------------------------------------------------------

# (q/k/v dtype, fast): strict fp32, fast bf16, and strict with bf16 activations
ATTN_MODES = {"strict": (torch.float32, False), "fast": (torch.bfloat16, True),
              "strict_bf16": (torch.bfloat16, False)}


@pytest.mark.parametrize("mode", list(ATTN_MODES))
@pytest.mark.parametrize("L", [64, 512])  # 512: more than one 256-row chunk of _bwd_kernel
def test_attention_bwd_matches_jax(mode, L):
    dtype, fast = ATTN_MODES[mode]
    rng = np.random.default_rng(L + len(mode))
    y = torch.from_numpy(rng.standard_normal((2, L, 2, 64, 3)).astype(np.float32)).to(dtype)
    do = torch.from_numpy(rng.standard_normal((2, L, 2, 64)).astype(np.float32)).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(_np(y[..., i])).astype(jdt) for i in range(3))
    _, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(a, b, c, fast, "interpret"), jq, jk, jv)
    ref = vjp(jnp.asarray(_np(do)).astype(jdt))

    plain = tatt._plain_attention_bwd(y[..., 0], y[..., 1], y[..., 2], do, fast)
    # autograd through the stride-3 views the U-Net block hands over
    yg = y.clone().requires_grad_()
    tatt.fused_attention(yg[..., 0], yg[..., 1], yg[..., 2], fast).backward(do)
    auto = [yg.grad[..., i] for i in range(3)]
    # the tolerances of test_pallas_attn.py's gradient test, relative to the
    # largest reference gradient: fp32 sums in another order (strict); bf16
    # results, weights and (fast) dS rounded to bf16 at other points (bf16)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for a, b, r in zip(plain, auto, ref):
        assert a.dtype == b.dtype == dtype
        assert _rel_err(_np(a), r) <= tol
        assert _rel_err(_np(b), r) <= tol


# ---- GroupNorm + SiLU backward -------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_silu_bwd_matches_jax(dtype):
    rng = np.random.default_rng(11)
    c = 128
    g = num_groups_for(c)
    x = torch.from_numpy((rng.standard_normal((2, 8, 8, c)) + 0.3).astype(np.float32)).to(dtype)
    gamma = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    gout = torch.from_numpy(rng.standard_normal((2, 8, 8, c)).astype(np.float32)).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, vjp = jax.vjp(lambda a, w, b: jax_gn_silu(a, w, b, g, 1e-5, "interpret"),
                     jnp.asarray(_np(x)).astype(jdt), jnp.asarray(gamma.numpy()),
                     jnp.asarray(beta.numpy()))
    ref = vjp(jnp.asarray(_np(gout)).astype(jdt))
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, gamma, beta))
    calls = _build.launches("gn_silu_bwd")
    tgn.gn_silu(xs, ws, bs, g).backward(gout)
    assert _build.launches("gn_silu_bwd") == calls + 1
    assert xs.grad.dtype == dtype and ws.grad.dtype == bs.grad.dtype == torch.float32
    # the same fp32 math line for line, fp32 sums in another order; a bf16
    # dx is rounded once on each side, which may land one bf16 ulp apart
    for a, r in zip((xs.grad, ws.grad, bs.grad), ref):
        assert _rel_err(_np(a), r) <= (2 ** -8 if a.dtype == torch.bfloat16 else 1e-5)


# ---- ELBO and training steps -----------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The JAX model with filled weights (no zero-init conv hides a block),
    the port's model with the same weights, and one jitted JAX
    value-and-grad of the ELBO with the posterior draw mu + sigma * eps,
    shared by every test here (one compile)."""
    jm = JProbUNet(input_channels=3, num_classes=3, latent_dim=LATENT, **PROB_KW)
    x0 = jnp.zeros((1, 16, 16, 3))
    params = _params(jm, x0, x0, seed=21, method=jm.elbo)

    def elbo_eps(m, x, y, eps, beta):
        _, post = m.latent_dists(x, y)
        return m.elbo_with_z(x, y, post.mu + jnp.exp(post.log_sigma) * eps, beta)

    def loss(p, x, y, eps, beta):
        total, recon, kl = jm.apply({"params": p}, x, y, eps, beta, method=elbo_eps)
        return total, (recon, kl)

    return jm, params, jax.jit(jax.value_and_grad(loss, has_aux=True))


def _torch_model(params):
    tm = TProbUNet(3, 3, latent_dim=LATENT, device="cpu", **PROB_KW)
    tm.load_state_dict(flax_probunet_to_torch(params))
    return tm


def _flat(tree):
    """JAX params/grads -> {torch key: OIHW/(out, in) numpy array}."""
    return {k: v.numpy() for k, v in flax_probunet_to_torch(tree).items()}


def test_elbo_with_z_value_and_grads_match_jax(models):
    jm, params, _ = models
    rng = np.random.default_rng(5)
    x, y = (rng.standard_normal((2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    z = rng.standard_normal((2, LATENT)).astype(np.float32)

    def loss(p):
        total, recon, kl = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(z), 0.7, method=jm.elbo_with_z)
        return total, (recon, kl)

    (total, (recon, kl)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tm = _torch_model(params).eval()
    out = tm.elbo_with_z(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z), 0.7)
    out[0].backward()
    # fp32 through ~20 layers on both sides, sums in other orders
    for a, b in zip(out, (total, recon, kl)):
        assert abs(a.item() - float(b)) <= 1e-5 * abs(float(b))
    ref = _flat(grads)
    for name, p in tm.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        # each gradient relative to that tensor's largest entry: fp32 through
        # the network and back, the same tolerance as the forward parity
        assert _rel_err(_np(g), ref[name]) <= 1e-4 or np.abs(ref[name]).max() < 1e-30, name


def _data(seed=9):
    """(hr_all, stats) on both sides: 6 synthetic days, pertimestep stats."""
    hr = np.random.default_rng(seed).gamma(2.0, 1.0, (6, 16, 16, 3)).astype(np.float32)
    t_hr = torch.from_numpy(hr)
    j_hr = jnp.asarray(hr)
    return (t_hr, tt.compute_lr_stats(t_hr, 4, "pertimestep"),
            j_hr, jt.compute_lr_stats(j_hr, 4, "pertimestep"))


# (optimizer kwargs, accum, beta schedule): torch-parity AdamW, the bf16-mu
# variant, and a two-micro-step window with clipping and a beta warm-up
TRACES = {
    "adamw": (dict(), 1, ("const", 1.0, 0)),
    "adamw_bf16": (dict(state_dtype="bfloat16"), 1, ("const", 1.0, 0)),
    "accum2_clip": (dict(accum=2, grad_clip=50.0), 2, ("linear", 1.0, 2)),
}


@pytest.mark.parametrize("variant", list(TRACES))
def test_train_steps_match_jax(models, variant):
    jm, params, grad_fn = models
    opt_kw, accum, sched = TRACES[variant]
    t_hr, t_stats, j_hr, j_stats = _data()
    steps = 3
    rng = np.random.default_rng(len(variant))
    idxs = [rng.choice(6, 2, replace=False) for _ in range(steps)]
    epss = [rng.standard_normal((2, LATENT)).astype(np.float32) for _ in range(steps)]

    # JAX: a step built from the public pieces
    tx = j_make_optimizer(lr=LR, **opt_kw)
    update = jax.jit(tx.update)
    j_beta = j_beta_schedule(*sched)
    p, opt_state, j_trace, clear, sign = params, tx.init(params), [], {}, {}
    for s in range(steps):
        idx = jnp.asarray(idxs[s])
        pair = jt.make_pair(j_hr[idx], 4, "pertimestep", jt.slice_stats(j_stats, "pertimestep", idx))
        (total, (recon, kl)), grads = grad_fn(p, pair["inputs"], pair["targets"],
                                              jnp.asarray(epss[s]), j_beta(jnp.asarray(s // accum)))
        upd, opt_state = update(grads, opt_state, p)
        p = optax.apply_updates(p, upd)
        j_trace.append((float(total), float(recon), float(kl)))
        for name, g in _flat(grads).items():  # clear of zero, one sign at every step
            sign.setdefault(name, np.sign(g))
            ok = (np.abs(g) > 1e-3 * np.abs(g).max()) & (np.sign(g) == sign[name])
            clear[name] = clear.get(name, True) & ok

    # the port's step, dropout off (PROB_KW), the same eps
    tm = _torch_model(params)
    state = t_create(tm, t_make_optimizer(lr=LR, **opt_kw))
    step = tsteps.make_probunet_train_step(tm, 4, "pertimestep",
                                           tsteps.beta_schedule(*sched), accum=accum)
    t_trace = []
    for s in range(steps):
        m = step(state, t_hr, t_stats, torch.from_numpy(idxs[s]), 0, eps=torch.from_numpy(epss[s]))
        assert m["beta"] == pytest.approx(float(j_beta(jnp.asarray(s // accum))), rel=1e-6)
        t_trace.append((m["train_loss"].item(), m["recon_loss"].item(), m["kl_div"].item()))
    assert state.step == steps

    # fp32 on both sides; Adam's steps move each weight by ~lr whatever the
    # size of its gradient, so the small gradient differences of the first
    # step reach the later losses: 1e-4 relative
    np.testing.assert_allclose(np.array(t_trace), np.array(j_trace), rtol=1e-4, atol=1e-6)
    # Parameters: Adam moves each element by about lr * sign(g), so where a
    # gradient lies within rounding of zero (the key part of each qkv bias,
    # which the softmax ignores, is zero up to rounding) the two sides can
    # part by 2 lr per step, and where the gradient changes sign the
    # cancelling first moment magnifies small differences. Every element
    # agrees to 2 lr per step. Elements whose gradient kept one sign clear
    # of zero (> 1e-3 of its tensor's largest) agree to 1e-5, a hundredth
    # of one step's move; with the bf16 first moment, to a few bf16 ulps of
    # the update per step (a rounding of mu may flip between the sides).
    tol = steps * LR * 2 ** -6 if opt_kw.get("state_dtype") == "bfloat16" else 1e-5
    ref = _flat(p)
    for name, w in tm.named_parameters():
        d = np.abs(_np(w) - ref[name])
        assert d.max() <= 2 * LR * steps + 1e-6, name
        assert d[clear[name]].max(initial=0.0) <= tol, name


def test_train_step_draws_follow_seed_and_step(models):
    """Latent and dropout draws derive from (seed, micro-step): the same
    seed and step give the same loss, another seed another one; dropout is
    drawn (rate 0.1) and is off in eval mode."""
    _, params, _ = models
    t_hr, t_stats, _, _ = _data()
    idx = torch.tensor([0, 3])
    kw = dict(PROB_KW, dropout=0.1)

    def loss_at(seed):
        tm = TProbUNet(3, 3, latent_dim=LATENT, device="cpu", **kw)
        tm.load_state_dict(flax_probunet_to_torch(params))
        state = t_create(tm, t_make_optimizer(optimizer="sgd", lr=0.0))
        step = tsteps.make_probunet_train_step(tm, 4, "pertimestep")
        return step(state, t_hr, t_stats, idx, seed)["train_loss"].item()

    assert loss_at(7) == loss_at(7)
    assert loss_at(7) != loss_at(8)
    x = torch.randn(2, 8, 4, 4).to(memory_format=torch.channels_last)
    out = dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    kept = out != 0
    assert 0.6 < kept.float().mean() < 0.9
    torch.testing.assert_close(out[kept], x[kept] / 0.75)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert dropout(x, 0.25, False) is x


def test_multistep_and_watch(models):
    """The multistep loop stacks one row of metrics per step; ``watch`` adds
    one gradient norm per parameter, under the port's parameter names."""
    _, params, _ = models
    t_hr, t_stats, _, _ = _data()
    tm = _torch_model(params)
    state = t_create(tm, t_make_optimizer())
    out = tsteps.make_probunet_train_multistep(tm, 4, "pertimestep")(
        state, t_hr, t_stats, torch.tensor([[0, 1], [2, 3]]), 5)
    assert state.step == 2 and out["train_loss"].shape == out["beta"].shape == (2,)
    m = tsteps.make_probunet_train_step(tm, 4, "pertimestep", watch=True)(
        state, t_hr, t_stats, torch.tensor([4, 5]), 5)
    names = {k.split("/", 1)[1] for k in m if k.startswith("gradnorm/")}
    assert names == {name for name, _ in tm.named_parameters()}
    total = torch.sqrt(sum(m[f"gradnorm/{n}"] ** 2 for n in names))
    assert total.item() == pytest.approx(m["grad_norm"].item(), rel=1e-5)


def test_sample_fn_runs_without_dropout(models):
    """A model left in training mode by the train step samples as in eval
    mode: the JAX sampler runs the U-Net with train=False."""
    _, params, _ = models
    t_hr, t_stats, _, _ = _data()
    tm = TProbUNet(3, 3, latent_dim=LATENT, device="cpu", **dict(PROB_KW, dropout=0.5))
    tm.load_state_dict(flax_probunet_to_torch(params))
    fn = tsteps.make_sample_fn(tm, 4, "pertimestep", 2)
    eps = torch.randn(2, 2, LATENT, generator=torch.Generator().manual_seed(0))
    idx = torch.tensor([1, 2])
    ref = fn(t_hr, t_stats, idx, eps=eps)[0]
    tm.train()
    torch.testing.assert_close(fn(t_hr, t_stats, idx, eps=eps)[0], ref, rtol=0, atol=0)


def test_eval_and_crps_steps(models):
    _, params, _ = models
    t_hr, t_stats, _, _ = _data()
    tm = _torch_model(params)
    idx = torch.tensor([0, 5])
    ev = tsteps.make_probunet_eval_step(tm, 4, "pertimestep")(t_hr, t_stats, idx, 3, 1.0)
    again = tsteps.make_probunet_eval_step(tm, 4, "pertimestep")(t_hr, t_stats, idx, 3, 1.0)
    assert ev["val_loss"].item() == again["val_loss"].item()
    assert ev["val_loss"].item() == pytest.approx(
        ev["val_recon_loss"].item() + ev["val_kl_div"].item(), rel=1e-6)
    crps = tsteps.make_crps_eval_fn(tm, 4, "pertimestep", ("pr", "tasmin", "tasmax"), 4)(
        t_hr, t_stats, idx, torch.Generator().manual_seed(1))
    assert sorted(crps) == sorted(f"{k}_{v}" for k in ("crps", "ensmean_mae")
                                  for v in ("pr", "tasmin", "tasmax"))
    assert all(np.isfinite(v.item()) and v.item() >= 0 for v in crps.values())


# ---- small pieces --------------------------------------------------------------------

@pytest.mark.parametrize("sched", [("const", 0.5, 0), ("linear", 2.0, 5), ("cyclic", 1.0, 4)])
def test_beta_schedule_matches_jax(sched):
    t, j = tsteps.beta_schedule(*sched), j_beta_schedule(*sched)
    for s in range(12):
        # JAX computes the schedule in fp32, the port in Python floats
        assert t(s) == pytest.approx(float(j(jnp.asarray(s))), rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("n", [1, 2, 7])
def test_crps_matches_jax(n):
    rng = np.random.default_rng(n)
    pred = rng.standard_normal((n, 3, 5)).astype(np.float32)
    truth = rng.standard_normal((3, 5)).astype(np.float32)
    out = tcrps.crps_empirical(torch.from_numpy(pred), torch.from_numpy(truth))
    np.testing.assert_allclose(out.numpy(), np.asarray(jcrps.crps_empirical(
        jnp.asarray(pred), jnp.asarray(truth))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), tcrps.crps_naive(
        torch.from_numpy(pred), torch.from_numpy(truth)).numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        tcrps.crps_empirical(torch.from_numpy(pred), torch.from_numpy(truth[:2]))


def test_init_probunet_state_draws_from_seed():
    from probunet_torch.config import Config
    from probunet_torch.train.loop import build_probunet, init_probunet_state

    cfg = Config(latent_dim=LATENT, resolution=(16, 16), seed=4,
                 **{k: v for k, v in PROB_KW.items() if k != "img_resolution"})
    ref = build_probunet(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    state = init_probunet_state(cfg, build_probunet(cfg, device="meta"), t_make_optimizer(),
                                device="cpu")
    assert state.step == 0 and state.model.beta == cfg.beta
    for a, b in zip(state.model.state_dict().values(), ref.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # remat: the same weights, every U-Net block recomputed in the backward
    remat = init_probunet_state(cfg.replace(remat=True),
                                build_probunet(cfg.replace(remat=True), device="meta"),
                                t_make_optimizer(), device="cpu")
    assert remat.model.unet.remat and not state.model.unet.remat
    for a, b in zip(remat.model.state_dict().values(), ref.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        t_make_optimizer(optimizer="lion")

