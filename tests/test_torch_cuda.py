"""The port's CUDA kernels against their plain versions on the card, at the
edge shapes chip_smoke.py does not reach: scalar (unvectorized) paths,
unaligned views, single rows, ragged attention lengths, and the wrappers'
refusals. Marked ``cuda``: they skip without a card. On the card, without
JAX (this file imports none):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from probunet_torch.ops import attention as K2
from probunet_torch.ops import gn_silu as K1
from probunet_torch.ops.norm import group_stats, num_groups_for

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c", [(2, 8, 8, 64), (1, 1, 1, 128), (3, 5, 7, 6),
                                     (2, 4, 4, 12), (1, 9, 3, 1024), (2, 3, 3, 2048)])
def test_gn_silu_kernel_matches_plain(dev, dtype, b, h, w, c):
    g = max(1, num_groups_for(c))
    gen = torch.Generator(device=dev).manual_seed(c)
    x = (torch.randn(b, h, w, c, device=dev, generator=gen) * 2 + 1).to(dtype)
    gamma = torch.randn(c, device=dev, generator=gen)
    beta = torch.randn(c, device=dev, generator=gen)
    before = K1.gn_silu.launches
    with torch.no_grad():
        out, mean, rstd = K1.gn_silu(x, gamma, beta, g, return_stats=True)
        ref = K1._plain_gn_silu(x, gamma, beta, g)[0]
        rmean, rrstd = group_stats(x, g)
    assert K1.gn_silu.launches == before + 1
    # fp32: summation order only; bf16: one rounding of an fp32 result apart
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 2 ** -8)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=1e-5, rtol=1e-5)


def test_gn_silu_kernel_unaligned_view(dev):
    """A view that starts 4 bytes into its storage takes the scalar path."""
    base = torch.randn(2 * 4 * 4 * 64 + 1, device=dev)
    x = base[1:].view(2, 4, 4, 64)
    assert x.data_ptr() % 16
    gamma, beta = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with torch.no_grad():
        out = K1.gn_silu(x, gamma, beta, 16)
    torch.testing.assert_close(out, K1._plain_gn_silu(x, gamma, beta, 16)[0],
                               atol=1e-5, rtol=1e-5)


def test_gn_silu_kernel_refusals(dev):
    x = torch.randn(1, 2, 2, 8, device=dev)
    w = torch.ones(8, device=dev)
    with pytest.raises(TypeError):
        K1.gn_silu(x.half(), w, w, 2)
    with pytest.raises(ValueError):
        K1.gn_silu(x.permute(0, 2, 1, 3), w, w, 2)
    with pytest.raises(RuntimeError):
        K1.gn_silu(x.requires_grad_(), w, w, 2)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("b,L,nh", [(1, 1, 1), (2, 65, 3), (1, 127, 2), (2, 64, 1), (1, 300, 4)])
def test_attention_kernel_matches_plain(dev, fast, b, L, nh):
    dtype = torch.bfloat16 if fast else torch.float32
    gen = torch.Generator(device=dev).manual_seed(L)
    y = torch.randn(b, L, nh, 64, 3, device=dev, generator=gen).to(dtype)
    q, k, v = y[..., 0], y[..., 1], y[..., 2]
    before = K2.fused_attention.launches
    with torch.no_grad():
        out = K2.fused_attention(q, k, v, fast)
        ref = K2._plain_attention(q, k, v, fast)
    assert K2.fused_attention.launches == before + 1
    assert out.shape == (b, L, nh, 64) and out.dtype == dtype and out.is_contiguous()
    tol = 2e-2 if fast else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_attention_kernel_refusals(dev):
    q = torch.randn(1, 8, 2, 64, device=dev)
    with pytest.raises(TypeError):
        K2.fused_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        K2.fused_attention(q[..., :32], q[..., :32], q[..., :32])
    with pytest.raises(RuntimeError):
        K2.fused_attention(q.requires_grad_(), q, q)


def test_unet_on_card_matches_cpu(dev):
    """A small U-Net with attention: the card's kernels and cuDNN against the
    CPU's plain versions, same weights, strict fp32."""
    from probunet_torch.models import UNet
    from probunet_torch.utils.device import full_fp32

    kw = dict(img_resolution=(16, 16), in_channels=3, out_channels=3, model_channels=64,
              channel_mult=(1, 2), num_blocks=1, attn_resolutions=(16,), dropout=0.0)
    cpu = UNet(device="cpu", generator=torch.Generator().manual_seed(0), **kw).eval()
    with torch.no_grad():
        for p in cpu.parameters():  # zero-init convs would hide most of each block
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    gpu = UNet(device="meta", **kw).to_empty(device=dev).eval()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), full_fp32():
        ref = cpu(x)
        out = gpu(x.to(dev)).cpu()
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
