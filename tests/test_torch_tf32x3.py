"""The strict (fp32) attention kernels' numerics, emulated in torch on the
CPU (tests/_tf32x3.py: the 3xTF32 split, the kernels' order of terms, their
tiles, a fresh P V accumulator per K/V tile joined to O by an FMA) and held
against JAX's strict attention: ``_xla_attention`` and the Pallas
``_bwd_kernel`` in interpret mode, at head dims 64 and 72 (the
model_channels 96 path) and L = 256 and 1024, within the strict limits
chip_smoke.py holds the kernels to: ATTN_TOL["strict"] = 2e-5 for O,
ATTN_BWD_TOL["float32"] = 1e-4 of the largest gradient for dq, dk, dv.

This validates the design, not the kernels' bits: wgmma sums each k8 step
in an order the hardware sets. The kernels themselves are held against
the emulation and against their plain versions on the card
(test_torch_cuda.py, chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _tf32x3 import _bh, emulated_bwd, emulated_fwd, split, tf32

from chip_smoke import ATTN_BWD_TOL, ATTN_TOL
from probunet_tpu.ops.pallas_attn import _bwd_pallas, _xla_attention


def _blhc(a, b, h):
    return a.reshape(b, h, *a.shape[1:]).permute(0, 2, 1, 3)


def test_split_rounds_to_nearest_ties_away():
    """tf32(x): 10 mantissa bits, round to nearest with ties away from zero
    (cvt.rna), and hi + lo carries x to ~2^-22 relative."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -20, 1 + 1.5 * ulp,
                      3.0, 0.0])
    assert tf32(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(y)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - y).abs() <= 2.0 ** -21 * y.abs()).all()
    assert ((y - hi).abs() <= 2.0 ** -11 * y.abs()).all()


@pytest.mark.parametrize("c", [64, 72])
@pytest.mark.parametrize("L", [256, 1024])
def test_tf32x3_attention_matches_jax_strict(c, L):
    """The emulated strict K2 and K3 (the split, the kernels' order of
    terms, their tiles, a fresh accumulator per K/V tile joined to O by an
    FMA) against JAX's strict attention: O against ``_xla_attention``
    (fp32 at HIGHEST) within ATTN_TOL["strict"], the row lse against
    logsumexp, and dq, dk, dv against the Pallas ``_bwd_kernel`` in
    interpret mode within ATTN_BWD_TOL["float32"] of the largest entry."""
    b, h = (2, 2) if L == 256 else (1, 2)
    rng = np.random.default_rng(L + c)
    q, k, v, do = (rng.standard_normal((b, L, h, c)).astype(np.float32) for _ in range(4))
    tq, tk, tv, tdo = (_bh(torch.from_numpy(a)) for a in (q, k, v, do))
    o, lse = emulated_fwd(tq, tk, tv)
    ref = np.asarray(_xla_attention(*(jnp.asarray(a) for a in (q, k, v)), False))
    np.testing.assert_allclose(_blhc(o, b, h).numpy(), ref, atol=ATTN_TOL["strict"],
                               rtol=ATTN_TOL["strict"])
    ref_lse = torch.logsumexp(tq.double() @ tk.double().transpose(-1, -2) / math.sqrt(c), -1)
    assert (lse.double() - ref_lse).abs().max().item() <= 1e-5

    grads = emulated_bwd(tq, tk, tv, o, lse, tdo)
    ref_g = jax.jit(_bwd_pallas, static_argnums=(4, 5))(
        *(jnp.asarray(a) for a in (q, k, v, do)), False, True)
    for g, r in zip(grads, ref_g):
        r = np.asarray(r)
        err = np.abs(_blhc(g, b, h).numpy() - r).max() / max(1e-3, np.abs(r).max())
        assert err <= ATTN_BWD_TOL["float32"], err


def test_tf32x3_one_hot_rows_give_zero_ds():
    """At L = 1 every softmax row is one-hot: O is V's row as P V rounds it
    (P = 1 exactly), whose split is V's own, so D taken in the form of dP
    equals dP bit for bit and dS = 0, as in the plain version (dq = dk = 0
    exactly)."""
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((3, 1, 72)).astype(np.float32))
                   for _ in range(4))
    o, lse = emulated_fwd(q, k, v)
    dq, dk, dv = emulated_bwd(q, k, v, o, lse, do)
    assert not dq.any() and not dk.any()
    torch.testing.assert_close(dv, do, atol=1e-6, rtol=1e-6)
