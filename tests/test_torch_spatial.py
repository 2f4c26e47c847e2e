"""The port's spatial-sharding primitives (``probunet_torch/parallel/spatial.py``)
against the JAX package's, one case per test of tests/test_spatial.py at its
sizes, with the H axis sharded over sp = 2 and 4 gloo ranks (child
processes, ``tests/_torch_spatial_child.py``) and JAX's tolerances: 1e-5,
1e-4 for the GroupNorm, 1e-6 for the resampling, exact for the halo rows
and the gather. The JAX side runs here on the conftest's CPU devices: the
unsharded op, and JAX's own halo exchange over sp devices. Also the
gradient of every collective (the training step differentiates through
them): the halo (through the convolutions), the psum (through the
GroupNorm) and the gather, against ``jax.vjp`` of the unsharded op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_spatial_child import join_rows, run_ranks
from jax.sharding import Mesh, PartitionSpec as P

from probunet_tpu.models.layers import conv2d_nhwc
from probunet_tpu.ops.norm import group_norm
from probunet_tpu.ops.resample import avg_pool, nearest_upsample_2x
from probunet_tpu.parallel.spatial import halo_exchange_rows

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map


def _x(b=2, h=32, w=16, c=8, seed=0):
    return np.random.default_rng(seed).standard_normal((b, h, w, c)).astype(np.float32)


def _w(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


def _spec():
    """tests/test_spatial.py's inputs, plus the cotangents of the gradient
    checks."""
    rng = np.random.default_rng(20)
    return {
        "x_halo": _x(h=16),
        "x_conv": _x(h=32, seed=1),
        "w_conv": _w((3, 3, 8, 12), 2), "b_conv": _w((12,), 3),
        "cot_conv1": _x(h=32, c=12, seed=21), "cot_conv2": _x(h=16, w=8, c=12, seed=22),
        "x_stack": _x(h=32, seed=4),
        "w1": _w((3, 3, 8, 8), 5), "w2": _w((3, 3, 8, 8), 6),
        "x_gn": _x(h=32, c=16, seed=7),
        "w_gn": (1 + 0.1 * np.random.default_rng(8).standard_normal(16)).astype(np.float32),
        "b_gn": (0.1 * np.random.default_rng(9).standard_normal(16)).astype(np.float32),
        "cot_gn": _x(h=32, c=16, seed=23),
        "x_pool": _x(h=32, seed=10), "x_up": _x(h=16, seed=11),
        "x_gather": _x(h=32, seed=12), "cot_gather": rng.standard_normal((2, 32, 16, 8)).astype(
            np.float32),
        "cases": ["primitives"],
    }


@pytest.fixture(scope="module")
def spec():
    return _spec()


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def ranks(request, spec, tmp_path_factory):
    sp = request.param
    return sp, run_ranks(tmp_path_factory.mktemp(f"spatial_sp{sp}"), sp, spec)


def _vjp(fn, cot, *args):
    out, pull = jax.vjp(fn, *map(jnp.asarray, args))
    return np.asarray(out), [np.asarray(g) for g in pull(jnp.asarray(cot))]


class TestHalo:
    def test_halo_rows(self, ranks, spec):
        """Each rank's block with a neighbour row on each side (zeros at the
        global edges): the JAX package's ppermute halo over sp devices,
        value for value."""
        sp, res = ranks
        got = join_rows(res, "halo")
        assert got.shape == (2, 16 + 2 * sp, 16, 8)
        mesh = Mesh(np.array(jax.devices()[:sp]), ("h",))
        want = shard_map(lambda xl: halo_exchange_rows(xl, "h", 1), mesh=mesh,
                         in_specs=(P(None, "h"),), out_specs=P(None, "h"))(spec["x_halo"])
        np.testing.assert_array_equal(got, np.asarray(want))


class TestSpatialConv:
    @pytest.mark.parametrize("stride", [1, 2])
    def test_matches_global_conv(self, ranks, spec, stride):
        _, res = ranks
        ref = conv2d_nhwc(jnp.asarray(spec["x_conv"]), jnp.asarray(spec["w_conv"]),
                          stride=stride, padding=1) + spec["b_conv"].reshape(1, 1, 1, -1)
        np.testing.assert_allclose(join_rows(res, f"conv{stride}"), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("stride", [1, 2])
    def test_gradients_match_global_conv(self, ranks, spec, stride):
        """d/dx (through the halo's backward, which returns the cotangent of
        the rows a neighbour sent), d/dw and d/db summed over the ranks.
        d/dw and d/db each sum 2 x 32 x 16 / stride**2 products of unit-scale
        values, in another order on each side: fp32 rounding of those sums
        reaches ~3e-5 absolute whatever the result's size, hence atol 1e-4
        there; d/dx sums 108 products and keeps 1e-5."""
        _, res = ranks

        def fn(x, w, b):
            return conv2d_nhwc(x, w, stride=stride, padding=1) + b.reshape(1, 1, 1, -1)

        _, (dx, dw, db) = _vjp(fn, spec[f"cot_conv{stride}"], spec["x_conv"], spec["w_conv"],
                               spec["b_conv"])
        np.testing.assert_allclose(join_rows(res, f"conv{stride}_dx"), dx, rtol=1e-5, atol=1e-5)
        for r in res:
            np.testing.assert_allclose(r[f"conv{stride}_dw"], dw, rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(r[f"conv{stride}_db"], db, rtol=1e-5, atol=1e-4)

    def test_two_layer_stack(self, ranks, spec):
        """Composition: conv -> conv with halos each time == global."""
        _, res = ranks
        x, w1, w2 = (jnp.asarray(spec[k]) for k in ("x_stack", "w1", "w2"))
        ref = conv2d_nhwc(jax.nn.relu(conv2d_nhwc(x, w1, padding=1)), w2, padding=1)
        np.testing.assert_allclose(join_rows(res, "stack"), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def _gn_silu(x, w, b):
    y = group_norm(x, w, b, 4)
    return y * jax.nn.sigmoid(y)


class TestSpatialNorm:
    def test_group_norm_silu_global_stats(self, ranks, spec):
        _, res = ranks
        ref = _gn_silu(*(jnp.asarray(spec[k]) for k in ("x_gn", "w_gn", "b_gn")))
        np.testing.assert_allclose(join_rows(res, "gn"), np.asarray(ref), rtol=1e-4, atol=1e-5)

    def test_group_norm_gradients(self, ranks, spec):
        """Through the psum of the statistics (whose backward sums the
        cotangent over the ranks); the affine's gradients summed."""
        _, res = ranks
        _, (dx, dw, db) = _vjp(_gn_silu, spec["cot_gn"], spec["x_gn"], spec["w_gn"],
                               spec["b_gn"])
        np.testing.assert_allclose(join_rows(res, "gn_dx"), dx, rtol=1e-4, atol=1e-5)
        for r in res:
            np.testing.assert_allclose(r["gn_dw"], dw, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(r["gn_db"], db, rtol=1e-4, atol=1e-5)


class TestSpatialResample:
    def test_avg_pool_local(self, ranks, spec):
        _, res = ranks
        np.testing.assert_allclose(join_rows(res, "pool"),
                                   np.asarray(avg_pool(jnp.asarray(spec["x_pool"]), 2)), rtol=1e-6)

    def test_nearest_up_local(self, ranks, spec):
        _, res = ranks
        np.testing.assert_allclose(join_rows(res, "up"),
                                   np.asarray(nearest_upsample_2x(jnp.asarray(spec["x_up"]))),
                                   rtol=1e-6)


class TestSpatialAttention:
    def test_gather_and_slice_roundtrip(self, ranks, spec):
        _, res = ranks
        np.testing.assert_array_equal(join_rows(res, "roundtrip"), spec["x_gather"])

    def test_gather_gradient(self, ranks, spec):
        """Rows mixed over the gathered map, this rank's kept: d/dx is the
        sum over the ranks of the full map's cotangent, this rank's rows."""
        _, res = ranks
        _, (dx,) = _vjp(lambda x: x * x.mean(axis=1, keepdims=True), spec["cot_gather"],
                        spec["x_gather"])
        np.testing.assert_allclose(join_rows(res, "gather_dx"), dx, rtol=1e-5, atol=1e-5)
