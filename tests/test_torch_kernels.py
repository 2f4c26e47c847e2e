"""The port's kernel modules on the CPU: the plain versions that CPU tensors
take are held against the JAX Pallas kernels run in interpret mode (and the
XLA paths), launch counters stay at 0 off the card, and importing the kernel
modules needs neither nvcc nor triton. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py."""

import importlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probunet_torch.ops import attention as tatt
from probunet_torch.ops import gn_silu as tgn
from probunet_torch.ops.norm import num_groups_for
from probunet_tpu.ops.pallas_attn import fused_attention as jax_fused_attention
from probunet_tpu.ops.pallas_gn import gn_silu as jax_gn_silu


def _gn_data(b=2, h=8, w=8, c=64, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, c)) + 0.3).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("force", ["interpret", "xla"])
@pytest.mark.parametrize("c", [64, 256])
def test_gn_silu_plain_matches_jax(c, force):
    x, gamma, beta = _gn_data(c=c, seed=c)
    g = num_groups_for(c)
    out, mean, rstd = tgn.gn_silu(torch.from_numpy(x), torch.from_numpy(gamma),
                                  torch.from_numpy(beta), g, 1e-5, return_stats=True)
    ref = jax_gn_silu(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), g, 1e-5, force)
    # fp32 both sides; the JAX kernel's E[x^2]-mean^2 against the port's
    # two-pass variance differ by a few ulps: the 1e-5 of test_pallas_gn.py
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert mean.shape == rstd.shape == (2, g)
    xg = x.reshape(2, -1, g, c // g)
    np.testing.assert_allclose(mean.numpy(), xg.mean(axis=(1, 3)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(xg.var(axis=(1, 3)) + 1e-5),
                               rtol=1e-5)


def test_gn_silu_plain_bf16():
    x, gamma, beta = _gn_data(c=128, seed=7)
    g = num_groups_for(128)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = tgn.gn_silu(xb, torch.from_numpy(gamma), torch.from_numpy(beta), g)
    assert out.dtype == torch.bfloat16
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    ref = jax_gn_silu(xj, jnp.asarray(gamma), jnp.asarray(beta), g, 1e-5, "interpret")
    # same bf16 input, fp32 math, one rounding to bf16 at the end on both
    # sides: at most one bf16 ulp (2^-8 relative) apart
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2 ** -8, atol=1e-2)


def _qkv(L, nh=2, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, L, nh, 64)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("L", [64, 512])
def test_attention_plain_matches_jax_interpret(fast, L):
    q, k, v = _qkv(L, seed=L + fast)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if fast else (torch.float32, jnp.float32)
    qt, kt, vt = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    out = tatt.fused_attention(qt, kt, vt, fast)
    assert out.shape == qt.shape and out.dtype == tdt
    ref = jax_fused_attention(*(jnp.asarray(a.float().numpy()).astype(jdt)
                                for a in (qt, kt, vt)), fast, "interpret")
    # the tolerances of test_pallas_attn.py: strict is fp32 at HIGHEST on
    # both sides; fast rounds the weights (and, unfused, the logits) to bf16
    tol = 2e-2 if fast else 2e-5
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def test_attention_takes_strided_qkv_views():
    """The U-Net block hands over stride-3 views of the interleaved qkv conv
    output; the result equals that of contiguous copies."""
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal((2, 64, 2, 64, 3)).astype(np.float32))
    q, k, v = y[..., 0], y[..., 1], y[..., 2]
    assert q.stride()[-1] == 3
    out = tatt.fused_attention(q, k, v)
    ref = tatt.fused_attention(q.contiguous(), k.contiguous(), v.contiguous())
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    with pytest.raises(ValueError):
        tatt.fused_attention(q[..., :32], k[..., :32], v[..., :32])


def test_cpu_tensors_leave_launch_counters_at_zero():
    tgn.gn_silu.launches = 0
    tatt.fused_attention.launches = 0
    x, gamma, beta = _gn_data()
    tgn.gn_silu(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta), 16)
    q, k, v = (torch.from_numpy(a) for a in _qkv(64))
    tatt.fused_attention(q, k, v)
    assert tgn.gn_silu.launches == 0 and tatt.fused_attention.launches == 0


def test_cpu_autograd_leaves_launch_counters_at_zero():
    """Gradients flow through both wrappers on the CPU, through the stride-3
    q/k/v views of the block's interleaved qkv tensor, by the plain versions:
    no kernel counter moves, and the views' gradients are those of
    contiguous copies."""
    tgn.gn_silu.launches = tatt.fused_attention.launches = tatt.attention_bwd.launches = 0
    x, gamma, beta = _gn_data()
    xt = torch.from_numpy(x).requires_grad_()
    tgn.gn_silu(xt, torch.from_numpy(gamma), torch.from_numpy(beta), 16).square().sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()
    rng = np.random.default_rng(4)
    y = torch.from_numpy(rng.standard_normal((2, 64, 2, 64, 3)).astype(np.float32))
    yg = y.clone().requires_grad_()
    tatt.fused_attention(yg[..., 0], yg[..., 1], yg[..., 2]).square().sum().backward()
    parts = [y[..., i].contiguous().requires_grad_() for i in range(3)]
    tatt.fused_attention(*parts).square().sum().backward()
    for i in range(3):
        torch.testing.assert_close(yg.grad[..., i], parts[i].grad, rtol=0, atol=0)
    assert (tgn.gn_silu.launches, tatt.fused_attention.launches,
            tatt.attention_bwd.launches) == (0, 0, 0)


def test_stats_split_covers_rows():
    for batch, hw, sms in [(8, 128 * 128, 132), (8, 16 * 16, 132), (1, 4, 132), (64, 1024, 132)]:
        s, rows = tgn.stats_split(batch, hw, sms)
        assert 1 <= s <= hw and (s - 1) * rows < hw <= s * rows


def test_kernel_modules_import_without_nvcc_or_triton():
    """Importing the kernel modules builds nothing and imports no triton: a
    fresh interpreter with nvcc and triton made unfindable still imports
    them, and no kernel library gets loaded."""
    code = (
        "import sys, os\n"
        "sys.modules['triton'] = None\n"
        "os.environ['PATH'] = ''\n"
        "os.environ['CUDA_HOME'] = '/nonexistent'\n"
        "import probunet_torch.ops.gn_silu, probunet_torch.ops.attention, probunet_torch.ops.crps\n"
        "import probunet_torch.models, probunet_torch.serve, probunet_torch.train\n"
        "from probunet_torch.ops import _build\n"
        "assert _build._lib is None\n"
        "assert 'triton' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=importlib.import_module("probunet_torch").__path__[0] + "/..")
    assert res.returncode == 0, res.stderr
