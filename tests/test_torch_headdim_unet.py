"""The port's U-Net and prob-U-Net at ``model_channels=96`` on the CPU
against the JAX package: attention heads of 72 (a 288-wide level) and 96
(ROADMAP's reproducer ``UNet((16, 16), 3, 2, model_channels=96,
attn_resolutions=(16,), label_dim=0, use_diffuse=False)``), forward and
every gradient, and the prob-U-Net's ELBO with z and its gradients. The
same filled weights on both sides (``flax_unet_to_torch``,
``flax_probunet_to_torch``), inputs made with numpy. The attention at these
head dims alone: tests/test_torch_headdim.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_headdim import REPRO, WIDE, _head_dims, _x
from test_torch_models import _apply, _params
from test_torch_train import _np, _rel_err

from probunet_torch.models import ProbabilisticUNet as TProbUNet
from probunet_torch.models import UNet as TUNet
from probunet_torch.utils.transplant import flax_probunet_to_torch, flax_unet_to_torch
from probunet_tpu.models import ProbabilisticUNet as JProbUNet
from probunet_tpu.models import UNet as JUNet


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- the U-Net -------------------------------------------------------------------------------

def _unet_grads_match(jm, params, tm, x):
    """Forward and the gradients of sum(out * g) with respect to the input
    and every parameter, port against JAX; fp32 through the network and back
    on both sides: the forward parity's 1e-4 of each tensor's largest entry
    (tests/test_torch_models.py)."""
    g = _x((x.shape[0], *x.shape[1:3], jm.out_channels), 99)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * jnp.asarray(g))

    ref = _apply(jm, params, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    out.backward(torch.from_numpy(g))
    assert _rel_err(_np(out), ref) <= 1e-4
    assert _rel_err(_np(xt.grad), gx) <= 1e-4
    ref_g = {k: v.numpy() for k, v in flax_unet_to_torch(gp).items()}
    assert set(ref_g) == {k for k, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        r = ref_g[name]
        g = p.grad if p.grad is not None else torch.zeros_like(p)   # unused: no labels
        assert _rel_err(_np(g), r) <= 1e-4 or np.abs(r).max() < 1e-30, name


@pytest.mark.parametrize("config", ["wide288", "reproducer"])
def test_unet_mc96_matches_jax(config):
    """The port's U-Net at model_channels 96, forward and per-tensor
    gradients against JAX's with the same filled weights: the 288-wide
    level's 4 heads of 72, and the reproducer's heads of 96 (and of 64 in
    its bottleneck)."""
    if config == "wide288":
        kw = dict(img_resolution=(16, 16), in_channels=3, out_channels=3, label_dim=0,
                  use_diffuse=False, dropout=0.0, **WIDE)
        dims = [72]
    else:
        kw, dims = REPRO, [64, 96]
    jm = JUNet(**kw)
    x = _x((2, 16, 16, 3), 2)
    params = _params(jm, jnp.asarray(x), seed=3)
    tm = TUNet(device="cpu", **kw).eval()
    assert _head_dims(tm) == dims
    tm.load_state_dict(flax_unet_to_torch(params))
    _unet_grads_match(jm, params, tm, x)


def test_probunet_mc96_elbo_with_z_matches_jax():
    """The prob-U-Net at model_channels 96 (4 heads of 72 at 8x8): the ELBO
    with an explicit z, its reconstruction and KL terms and every
    gradient, against JAX (the tolerances of test_torch_train.py's ELBO
    test: values 1e-5 relative, gradients 1e-4 of each tensor's largest
    entry)."""
    kw = dict(num_filters=(16, 32), img_resolution=(16, 16), dropout=0.0, **WIDE)
    jm = JProbUNet(input_channels=3, num_classes=3, latent_dim=4, **kw)
    x0 = jnp.zeros((1, 16, 16, 3))
    params = _params(jm, x0, x0, seed=31, method=jm.elbo)
    rng = np.random.default_rng(6)
    x, y = (rng.standard_normal((2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    z = rng.standard_normal((2, 4)).astype(np.float32)

    def loss(p):
        total, recon, kl = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(z), 0.7, method=jm.elbo_with_z)
        return total, (recon, kl)

    (total, (recon, kl)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tm = TProbUNet(3, 3, latent_dim=4, device="cpu", **kw).eval()
    assert _head_dims(tm) == [72]
    tm.load_state_dict(flax_probunet_to_torch(params))
    out = tm.elbo_with_z(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z), 0.7)
    out[0].backward()
    for a, b in zip(out, (total, recon, kl)):
        assert abs(a.item() - float(b)) <= 1e-5 * abs(float(b))
    ref = {k: v.numpy() for k, v in flax_probunet_to_torch(grads).items()}
    for name, p in tm.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert _rel_err(_np(g), ref[name]) <= 1e-4 or np.abs(ref[name]).max() < 1e-30, name


def test_mc96_full_width_parameter_count():
    """The 128x128 prob-U-Net at model_channels 96 (chip_smoke.py phase
    16's model, MC96_PARAMS there): the port's count equals JAX's."""
    cfg = dict(img_resolution=(128, 128), model_channels=96)
    tm = TProbUNet(3, 3, device="meta", **cfg)
    assert sum(p.numel() for p in tm.parameters()) == 59_645_627
    assert _head_dims(tm) == [64, 72]
    jm = JProbUNet(input_channels=3, num_classes=3, **cfg)
    x0 = jnp.zeros((1, 128, 128, 3))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "latent": jax.random.key(1),
         "dropout": jax.random.key(2)}, x0, x0, method=jm.elbo))["params"]
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == 59_645_627
