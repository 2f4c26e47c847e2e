"""Attention head dims other than 64 in the port, on the CPU, against the
JAX package. JAX's ``UNetBlock`` takes width // 64 heads of width // heads
channels (``channels_per_head=64``), so a level whose width is no multiple
of 64 runs heads of 65-127 channels: ``model_channels=96`` gives 4 heads of
72 at its 288-wide level. Held here: the plain attention (forward and
backward) at such head dims against JAX's Pallas kernels in interpret mode,
the spatially sharded U-Net forward and the EDM denoiser at head dim 72,
and the block's q/k/v views at head dim 72; the U-Net and prob-U-Net at
``model_channels=96``: tests/test_torch_headdim_unet.py. Weights carried
across by ``flax_unet_to_torch`` / ``flax_edm_to_torch``, inputs made with
numpy. The CUDA kernels at these head dims are held
against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_spatial_child import join_rows, run_ranks
from test_torch_models import _apply, _params
from test_torch_train import _np, _rel_err

from probunet_torch.models import EDMPrecond as TEDM
from probunet_torch.models import UNet as TUNet
from probunet_torch.ops import attention as tatt
from probunet_torch.utils.transplant import flax_edm_to_torch, flax_unet_to_torch
from probunet_tpu.models import EDMPrecond as JEDM
from probunet_tpu.models import UNet as JUNet
from probunet_tpu.ops.pallas_attn import fused_attention as jax_fused_attention

# 16x16, model_channels 96: the 8x8 level is 288 wide, 4 heads of 72 (its
# encoder and decoder blocks and the bottleneck); the 16x16 level (96) has
# no attention
WIDE = dict(model_channels=96, channel_mult=(1, 3), num_blocks=1, attn_resolutions=(8,))
# ROADMAP's reproducer: the default channel_mult (1, 2, 3, 4) and two blocks
# a level, attention at 16x16 (one head of 96) and in the bottleneck at 2x2
# (384 wide: 6 heads of 64)
REPRO = dict(img_resolution=(16, 16), in_channels=3, out_channels=2, model_channels=96,
             attn_resolutions=(16,), label_dim=0, use_diffuse=False)
# (q/k/v dtype, fast), as tests/test_torch_train.py
ATTN_MODES = {"strict": (torch.float32, False), "fast": (torch.bfloat16, True)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _head_dims(model):
    return sorted({m.qkv.weight.shape[0] // 3 // m.heads for m in model.modules()
                   if getattr(m, "heads", 0)})


# ---- the attention itself --------------------------------------------------------------

@pytest.mark.parametrize("mode", list(ATTN_MODES))
@pytest.mark.parametrize("c", [65, 72, 88, 96, 100, 127])
def test_plain_attention_matches_jax_interpret(c, mode):
    """Forward and backward at head dim c (on the card 65 and 72 run the
    bf16 kernels' kD = 80, 88 and 96 kD = 96, 100 and 127 kD = 128): the
    plain versions and autograd through the block's (qkv, head, channel)
    views, against JAX's Pallas kernels in interpret mode, with the head
    dim 64 tolerances of
    test_torch_kernels.py (forward: strict 2e-5, fast 2e-2) and
    test_torch_train.py (gradients relative to the largest reference
    entry: 1e-4 and 5e-2)."""
    dtype, fast = ATTN_MODES[mode]
    jdt = jnp.bfloat16 if fast else jnp.float32
    rng = np.random.default_rng(c + fast)
    y = torch.from_numpy(rng.standard_normal((2, 64, 3, 2, c)).astype(np.float32)).to(dtype)
    do = torch.from_numpy(rng.standard_normal((2, 64, 2, c)).astype(np.float32)).to(dtype)
    jq, jk, jv = (jnp.asarray(_np(y[:, :, i])).astype(jdt) for i in range(3))
    ref, vjp = jax.vjp(lambda a, b, d: jax_fused_attention(a, b, d, fast, "interpret"),
                       jq, jk, jv)
    ref_g = vjp(jnp.asarray(_np(do)).astype(jdt))

    yg = y.clone().requires_grad_()
    out = tatt.fused_attention(*yg.unbind(2), fast)
    out.backward(do)
    assert out.shape == (2, 64, 2, c) and out.dtype == dtype
    tol = 2e-2 if fast else 2e-5
    np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32), atol=tol, rtol=tol)
    plain = tatt._plain_attention_bwd(*y.unbind(2), do, fast)
    tol = 5e-2 if fast else 1e-4
    for i, r in enumerate(ref_g):
        assert _rel_err(_np(yg.grad[:, :, i]), r) <= tol
        assert _rel_err(_np(plain[i]), r) <= tol


# ---- the spatial path and EDM at head dim 72 ------------------------------------------------

def test_spatial_unet_head_dim_72_matches_jax(tmp_path):
    """The spatially sharded U-Net forward (two gloo ranks, each with 16 of
    the 32 rows; the gathered 16x16 map's attention at 4 heads of 72 runs
    the port's own block) against JAX's unsharded forward, with the
    tolerances of tests/test_torch_spatial_unet.py."""
    kw = dict(img_resolution=(32, 32), in_channels=3, out_channels=4, label_dim=0,
              use_diffuse=False, model_channels=96, channel_mult=(1, 3), num_blocks=1,
              attn_resolutions=(16,), dropout=0.0)
    jm = JUNet(**kw)
    params = _params(jm, jnp.zeros((1, 32, 32, 3)), seed=5)
    assert _head_dims(TUNet(device="meta", **kw)) == [72]
    x = _x((2, 32, 32, 3), 4)
    spec = {"unet": {k: v.numpy() for k, v in flax_unet_to_torch(params).items()},
            "unet_kw": kw, "x_unet": x, "cases": ["unet_forward"]}
    res = run_ranks(tmp_path, 2, spec)
    ref = _apply(jm, params, jnp.asarray(x))
    np.testing.assert_allclose(join_rows(res, "unet"), np.asarray(ref), rtol=5e-4, atol=5e-5)


def test_edm_precond_head_dim_72_matches_jax():
    """The EDM denoiser with a 288-wide 8x8 level (4 heads of 72), fast
    attention on fp32 operands as the EDM path runs it, per-sample sigma
    and the condition on channels, against JAX (test_torch_edm.py's
    EDMPrecond tolerance: 1e-5 of the largest output)."""
    kw = dict(img_resolution=(16, 16), in_channels=6, out_channels=3, dropout=0.0, **WIDE)
    jm = JEDM(fast_attention=True, **kw)
    x, cond = _x((2, 16, 16, 3), 7), _x((2, 16, 16, 3), 8)
    sigma = np.array([0.3, 5.0], np.float32)
    params = _params(jm, x, sigma, cond, seed=9)
    ref = jax.jit(lambda p: jm.apply({"params": p}, x, sigma, condition_img=cond))(params)
    tm = TEDM(fast_attention=True, device="cpu", **kw).eval()
    assert _head_dims(tm) == [72]
    tm.load_state_dict(flax_edm_to_torch(params))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(sigma),
                 condition_img=torch.from_numpy(cond))
    assert _rel_err(out.numpy(), ref) <= 1e-5


def test_unet_block_views_at_head_dim_72_are_read_in_place(monkeypatch):
    """At the 288-wide level the block hands fused_attention q/k/v views of
    its qkv conv output with 72-column heads (row stride 3 x 288, head
    stride 72, unit-stride head dim): whole 16-byte bf16 chunks, which the
    kernels read where they lie, in fp32 and in bf16."""
    tm = TUNet(device="cpu", img_resolution=(16, 16), in_channels=3, out_channels=3,
               dropout=0.0, **WIDE).eval()
    real, seen = tatt.fused_attention, []

    def spy(q, k, v, fast=False):
        seen.append((q, k, v))
        return real(q, k, v, fast)

    from probunet_torch.models import unet as tunet
    monkeypatch.setattr(tunet, "fused_attention", spy)
    with torch.no_grad():
        tm(torch.from_numpy(_x((2, 16, 16, 3), 1)))
    assert len(seen) == 4   # the encoder's block at 8x8, the bottleneck's first, two decoder blocks
    for q, k, v in seen:
        for i, a in enumerate((q, k, v)):
            assert a.shape == (2, 64, 4, 72)
            assert a.stride() == (64 * 3 * 288, 3 * 288, 72, 1)
            assert a.data_ptr() == q.data_ptr() + i * 288 * a.element_size()
            assert tatt.kernel_layout(a) is a
    # in bf16 the same strides: heads of 144 bytes, rows of 1728 bytes
    assert all(n * 2 % 16 == 0 for n in (72, 288, 3 * 288))
