"""Port models (on the CPU) against the JAX models with the same weights,
carried across by flax_unet_to_torch / flax_probunet_to_torch."""

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probunet_torch.models import ProbabilisticUNet as TProbUNet
from probunet_torch.models import UNet as TUNet
from probunet_torch.models import layers as tl
from probunet_torch.models import unet as tunet
from probunet_torch.ops.attention import kernel_layout
from probunet_torch.utils.transplant import flax_probunet_to_torch, flax_unet_to_torch
from probunet_tpu.models import ProbabilisticUNet as JProbUNet
from probunet_tpu.models import UNet as JUNet
from probunet_tpu.models import layers as jl
from probunet_tpu.models.unet import UNetBlock as JUNetBlock
from probunet_tpu.utils.transplant import assert_tree_shapes_match, torch_probunet_to_flax

# Small widths: model_channels 64 gives attention 1-2 heads of 64.
UNET_KW = dict(model_channels=64, channel_mult=(1, 2), num_blocks=1, attn_resolutions=(16,))
PROB_KW = dict(num_filters=(16, 32), img_resolution=(16, 16), dropout=0.0, **UNET_KW)


def _params(module, *args, seed, method=None):
    """Random JAX params for ``module`` from its abstract init (a real flax
    init runs op by op and takes tens of seconds here), every leaf filled
    as bench.py fills them: standard normal / sqrt(fan_in). At init conv1,
    proj and out_conv are zero, which would hide the attention and most of
    each block. (A flax Conv2d's ``init`` field, its Init recipe, shadows
    Module.init, hence the explicit call.)"""
    rngs = {"params": jax.random.key(0), "latent": jax.random.key(1),
            "dropout": jax.random.key(2)}
    shapes = jax.eval_shape(lambda: flax.linen.Module.init(
        module, rngs, *args, method=method))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) / np.sqrt(
        max(1, int(np.prod(s.shape[:-1]))))).astype(np.float32), shapes)


def _apply(jm, params, *args, method=None):
    """Jitted JAX apply: one compile costs less here than eager op-by-op."""
    return jax.jit(functools.partial(jm.apply, method=method))({"params": params}, *args)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_close(out, ref, rel):
    """Max abs difference within ``rel`` of the reference's largest value."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("kernel,up,down", [(3, False, False), (3, True, False),
                                            (3, False, True), (1, False, True),
                                            (0, True, False), (0, False, True)])
def test_conv2d_resample(kernel, up, down):
    jm = jl.Conv2d(8, 8 if kernel == 0 else 16, kernel, up=up, down=down)
    x = _x((2, 8, 8, 8), 0)
    params = _params(jm, jnp.asarray(x), seed=1) if kernel else {}
    ref = jm.apply({"params": params}, jnp.asarray(x))
    tm = tl.Conv2d(8, 8 if kernel == 0 else 16, kernel, up=up, down=down, device="cpu")
    tm.load_state_dict({k.split(".", 1)[1]: v
                        for k, v in flax_unet_to_torch({"out_conv": params}).items()})
    with torch.no_grad():
        out = tl.nhwc(tm(tl.nchw(torch.from_numpy(x))))
    # fp32 convolutions of 72 terms in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_positional_embedding():
    x = np.linspace(0.0, 3.0, 5).astype(np.float32)
    ref = jl.PositionalEmbedding(16).apply({}, jnp.asarray(x))
    out = tl.PositionalEmbedding(16)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_unet_forward_parity_with_attention():
    kw = dict(img_resolution=(16, 16), in_channels=3, out_channels=3, dropout=0.0, **UNET_KW)
    jm = JUNet(label_dim=0, use_diffuse=False, **kw)
    x = _x((2, 16, 16, 3), 2)
    params = _params(jm, jnp.asarray(x), seed=3)
    ref = _apply(jm, params, jnp.asarray(x))
    tm = TUNet(device="cpu", **kw).eval()
    # attention at 16x16 (one head of 64) in enc block0 and dec block0/1, and
    # in the bottleneck in0 (two heads)
    assert [b.heads for b in tm.modules() if getattr(b, "heads", 0)] == [1, 2, 1, 1]
    tm.load_state_dict(flax_unet_to_torch(params))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    # fp32 through ~20 conv/norm layers: 1e-4 of the output's scale
    _assert_close(out.numpy(), ref, 1e-4)


def _block_pair(c=128, emb=32, seed=11):
    """A JAX attention UNetBlock (c channels, c/64 heads) and the port's,
    with the same filled weights carried across by flax_unet_to_torch."""
    jm = JUNetBlock(c, c, emb, attention=True)
    x, e = _x((2, 8, 8, c), seed), _x((2, emb), seed + 1)
    params = _params(jm, jnp.asarray(x), jnp.asarray(e), seed=seed + 2)
    tm = tunet.UNetBlock(c, c, emb, attention=True, device="cpu").eval()
    prefix = "enc.8x8_block0."
    tm.load_state_dict({k[len(prefix):]: v for k, v in
                        flax_unet_to_torch({"enc_8x8_block0": params}).items()})
    return jm, params, tm, x, e


def test_unet_block_qkv_reorder_matches_jax():
    """The block runs its qkv conv with the output rows reordered to (qkv,
    head, channel) so that q/k/v are unit-stride views; with the
    reference's parameters and state_dict layout, forward and gradients
    (input and every parameter) match the JAX block."""
    jm, params, tm, x, e = _block_pair()
    g = _x((2, 8, 8, 128), 14)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, jnp.asarray(e)) * jnp.asarray(g))

    ref = _apply(jm, params, jnp.asarray(x), jnp.asarray(e))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = tl.nchw(torch.from_numpy(x)).requires_grad_()
    out = tm(xt, torch.from_numpy(e))
    out.backward(tl.nchw(torch.from_numpy(g)))
    # fp32 through two convs, two norms and the attention: the forward
    # parity's 1e-4 of the output's scale, and of each gradient's
    _assert_close(tl.nhwc(out).detach().numpy(), ref, 1e-4)
    _assert_close(tl.nhwc(xt.grad).numpy(), gx, 1e-4)
    ref_g = {k[len("enc.8x8_block0."):]: v.numpy()
             for k, v in flax_unet_to_torch({"enc_8x8_block0": gp}).items()}
    assert set(ref_g) == {k for k, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        _assert_close(p.grad.numpy(), ref_g[name], 1e-4)


@pytest.mark.parametrize("emb_rows", [2, 1], ids=["per_sample", "shared"])
@pytest.mark.parametrize("adaptive_scale", [True, False], ids=["adm", "ddpmpp"])
def test_unet_block_norm1_forward_and_backward_match_jax(adaptive_scale, emb_rows):
    """norm1 with the embedding's terms in the one GroupNorm+SiLU call: the
    ADM block's (scale, shift) and the DDPM++ block's shift added before
    the norm (its skip_scale, eps and 1x1 skip with it), per sample (B, E)
    and one (1, E) row for the batch, as the downscaling U-Net's silu(0)
    embedding is. Forward and the gradients of x, the embedding and every
    parameter against the JAX block with the same weights."""
    cin, cout, emb = 32, 64, 16
    fields = {} if adaptive_scale else dict(num_heads=1, skip_scale=np.sqrt(0.5), eps=1e-6,
                                            resample_proj=True, adaptive_scale=False)
    jm = JUNetBlock(cin, cout, emb, **fields)
    x, e, g = _x((2, 8, 8, cin), 31), _x((emb_rows, emb), 32), _x((2, 8, 8, cout), 33)
    params = _params(jm, jnp.asarray(x), jnp.asarray(e), seed=34)
    tm = tunet.UNetBlock(cin, cout, emb, device="cpu", **fields).eval()
    assert isinstance(tm.norm1, tl.GroupNormSiLU)
    prefix = "enc.8x8_block0."
    tm.load_state_dict({k[len(prefix):]: v for k, v in
                        flax_unet_to_torch({"enc_8x8_block0": params}).items()})

    def loss(p, xx, ee):
        return jnp.sum(jm.apply({"params": p}, xx, ee) * jnp.asarray(g))

    ref = _apply(jm, params, jnp.asarray(x), jnp.asarray(e))
    gp, gx, ge = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(params, jnp.asarray(x),
                                                             jnp.asarray(e))
    xt = tl.nchw(torch.from_numpy(x)).requires_grad_()
    et = torch.from_numpy(e).requires_grad_()
    out = tm(xt, et)
    out.backward(tl.nchw(torch.from_numpy(g)))
    # fp32 through two convs and two norms: 1e-4 of each result's scale
    _assert_close(tl.nhwc(out).detach().numpy(), ref, 1e-4)
    _assert_close(tl.nhwc(xt.grad).numpy(), gx, 1e-4)
    _assert_close(et.grad.numpy(), ge, 1e-4)
    ref_g = {k[len(prefix):]: v.numpy()
             for k, v in flax_unet_to_torch({"enc_8x8_block0": gp}).items()}
    assert set(ref_g) == {k for k, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        _assert_close(p.grad.numpy(), ref_g[name], 1e-4)


def test_unet_block_hands_unit_stride_qkv_views(monkeypatch):
    """q, k and v reach fused_attention as views of the qkv conv output with
    a unit-stride head dim (row stride 3C, head stride 64), which the
    kernels read in place: no copy on the path."""
    _, _, tm, x, e = _block_pair(c=128)
    real, seen = tunet.fused_attention, []

    def spy(q, k, v, fast=False):
        seen.append((q, k, v))
        return real(q, k, v, fast)

    monkeypatch.setattr(tunet, "fused_attention", spy)
    with torch.no_grad():
        tm(tl.nchw(torch.from_numpy(x)), torch.from_numpy(e))
    (q, k, v), = seen
    c, hw = 128, 64
    for i, a in enumerate((q, k, v)):
        assert a.shape == (2, hw, 2, 64)
        assert a.stride() == (hw * 3 * c, 3 * c, 64, 1)
        assert a.data_ptr() == q.data_ptr() + i * c * a.element_size()
        assert kernel_layout(a) is a


@pytest.fixture(scope="module")
def probunet_pair():
    jm = JProbUNet(input_channels=3, num_classes=3, latent_dim=4, **PROB_KW)
    x0 = jnp.zeros((1, 16, 16, 3))
    params = _params(jm, x0, x0, seed=4, method=jm.elbo)
    tm = TProbUNet(3, 3, latent_dim=4, device="cpu", **PROB_KW).eval()
    tm.load_state_dict(flax_probunet_to_torch(params))
    return jm, params, tm


def test_state_dict_keys_follow_reference_scheme(probunet_pair):
    """The port's state_dict parses with the JAX package's torch->flax
    transplant (the reference key scheme) into the JAX tree, shapes and all,
    and the round trip is exact."""
    jm, params, tm = probunet_pair
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = torch_probunet_to_flax(sd)
    assert_tree_shapes_match(back, jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_latent_dists_and_reconstruct(probunet_pair):
    jm, params, tm = probunet_pair
    x, y = _x((2, 16, 16, 3), 5), _x((2, 16, 16, 3), 6)
    pj, qj = _apply(jm, params, jnp.asarray(x), jnp.asarray(y), method=jm.latent_dists)
    with torch.no_grad():
        pt, qt = tm.latent_dists(torch.from_numpy(x), torch.from_numpy(y))
    for a, b in [(pt.mu, pj.mu), (pt.log_sigma, pj.log_sigma),
                 (qt.mu, qj.mu), (qt.log_sigma, qj.log_sigma)]:
        _assert_close(a.numpy(), b, 1e-5)
    z = _x((2, 4), 7)
    ref = _apply(jm, params, jnp.asarray(x), jnp.asarray(z), method=jm.reconstruct)
    with torch.no_grad():
        out = tm.reconstruct(torch.from_numpy(x), torch.from_numpy(z))
    _assert_close(out.numpy(), ref, 1e-4)


def test_sample_with_explicit_eps(probunet_pair):
    """Member k of input b is prior.mu + sigma * eps[k, b] through Fcomb, in
    the JAX package's K-major order."""
    jm, params, tm = probunet_pair
    k = 3
    x, eps = _x((2, 16, 16, 3), 8), _x((k, 2, 4), 9)
    with torch.no_grad():
        out = tm.sample(torch.from_numpy(x), k, eps=torch.from_numpy(eps))
    assert out.shape == (2, k, 16, 16, 3)
    prior, _ = _apply(jm, params, jnp.asarray(x), method=jm.latent_dists)
    for m in range(k):
        z = prior.mu + jnp.exp(prior.log_sigma) * eps[m]
        ref = _apply(jm, params, jnp.asarray(x), z, method=jm.reconstruct)
        _assert_close(out[:, m].numpy(), ref, 1e-4)


@pytest.mark.parametrize("res,count", [(128, 103_541_083), (64, 104_859_483)])
def test_full_width_parameter_count(res, count):
    tm = TProbUNet(3, 3, img_resolution=(res, res), device="meta")
    assert sum(p.numel() for p in tm.parameters()) == count
    jm = JProbUNet(input_channels=3, num_classes=3, img_resolution=(res, res))
    x0 = jnp.zeros((1, res, res, 3))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "latent": jax.random.key(1),
         "dropout": jax.random.key(2)}, x0, x0, method=jm.elbo))["params"]
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == count
