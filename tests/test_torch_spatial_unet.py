"""The port's spatially-sharded U-Net and prob-U-Net forwards
(``probunet_torch/parallel/spatial_unet.py``) against the JAX package's
unsharded modules, one case per test of tests/test_spatial_unet.py at its
sizes (32x32, width 32, attention at 16x16), with the H axis sharded over
sp = 2 and 4 gloo ranks (``tests/_torch_spatial_child.py``), the same
weights through the transplant and JAX's tolerances (forward and decode
rtol 5e-4 atol 5e-5, the prior 1e-4 / 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_spatial_child import ARCH, join_rows, run_ranks
from test_torch_models import _apply, _params

from probunet_torch.models.unet import UNet as TUNet
from probunet_torch.utils.transplant import flax_probunet_to_torch, flax_unet_to_torch
from probunet_tpu.models import ProbabilisticUNet, UNet

UNET_KW = dict(img_resolution=(32, 32), in_channels=3, out_channels=16, label_dim=0,
               use_diffuse=False, model_channels=32, channel_mult=(1, 2), num_blocks=1,
               attn_resolutions=(16,), dropout=0.0)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """The JAX U-Net and prob-U-Net with filled weights (no zero-init conv
    hides a block) and the port's state dicts of the same weights."""
    um = UNet(**UNET_KW)
    u_params = _params(um, jnp.zeros((1, 32, 32, 3)), seed=0)
    pm = ProbabilisticUNet(input_channels=3, num_classes=3, latent_dim=4,
                           img_resolution=(32, 32), dropout=0.0, **ARCH)
    x0 = jnp.zeros((1, 32, 32, 3))
    p_params = _params(pm, x0, x0, seed=1, method=pm.elbo)
    sd = {"unet": {k: v.numpy() for k, v in flax_unet_to_torch(u_params).items()},
          "probunet": {k: v.numpy() for k, v in flax_probunet_to_torch(p_params).items()}}
    return um, u_params, pm, p_params, sd


@pytest.fixture(scope="module")
def spec(models):
    return {**models[4], "x_unet": _x((2, 32, 32, 3), 0), "x_prior": _x((2, 32, 32, 3), 1),
            "x_decode": _x((2, 32, 32, 3), 2), "z_decode": _x((2, 4), 3),
            "cases": ["forwards"]}


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def ranks(request, spec, tmp_path_factory):
    sp = request.param
    return sp, run_ranks(tmp_path_factory.mktemp(f"spatial_unet_sp{sp}"), sp, spec)


class TestSpatialUNet:
    def test_matches_unsharded(self, ranks, models, spec):
        um, u_params = models[:2]
        _, res = ranks
        ref = _apply(um, u_params, jnp.asarray(spec["x_unet"]))
        np.testing.assert_allclose(join_rows(res, "unet"), np.asarray(ref), rtol=5e-4,
                                   atol=5e-5)

    def test_attention_heads_active(self):
        """The config exercises the attention path (C=64 at 16x16: one
        head), so the gathered attention and its K2 site run."""
        unet = TUNet((32, 32), 3, 16, model_channels=32, channel_mult=(1, 2), num_blocks=1,
                     attn_resolutions=(16,), device="meta")
        heads = [b.heads for b in list(unet.enc.values()) + list(unet.dec.values())
                 if hasattr(b, "heads")]
        assert any(heads) and not all(heads)


class TestSpatialProbUNet:
    def test_prior_matches(self, ranks, models, spec):
        pm, p_params = models[2:4]
        _, res = ranks
        prior, _ = _apply(pm, p_params, jnp.asarray(spec["x_prior"]), method=pm.latent_dists)
        for r in res:   # the psum'd pool gives every rank the same distribution
            np.testing.assert_array_equal(r["prior_mu"], res[0]["prior_mu"])
            np.testing.assert_allclose(r["prior_mu"], np.asarray(prior.mu), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(r["prior_ls"], np.asarray(prior.log_sigma), rtol=1e-4,
                                       atol=1e-5)

    def test_decode_matches(self, ranks, models, spec):
        pm, p_params = models[2:4]
        _, res = ranks
        ref = _apply(pm, p_params, jnp.asarray(spec["x_decode"]), jnp.asarray(spec["z_decode"]),
                     method=pm.reconstruct)
        np.testing.assert_allclose(join_rows(res, "decode"), np.asarray(ref), rtol=5e-4,
                                   atol=5e-5)
