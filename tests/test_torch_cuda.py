"""The port's CUDA kernels against their plain versions on the card, at the
edge shapes chip_smoke.py does not reach: scalar (unvectorized) paths,
unaligned views, single rows, ragged attention lengths, the attention
backward (K3) at one row, one head and strided inputs, and the wrappers'
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
    """Refused dtype and layout; a gradient is no refusal: the forward
    launches K1 and the backward runs the plain version."""
    x = torch.randn(1, 2, 2, 8, device=dev)
    w = torch.ones(8, device=dev)
    with pytest.raises(TypeError):
        K1.gn_silu(x.half(), w, w, 2)
    with pytest.raises(ValueError):
        K1.gn_silu(x.permute(0, 2, 1, 3), w, w, 2)
    before, calls = K1.gn_silu.launches, K1.gn_silu.bwd_calls
    xg = x.clone().requires_grad_()
    K1.gn_silu(xg, w, w, 2).sum().backward()
    assert (K1.gn_silu.launches, K1.gn_silu.bwd_calls) == (before + 1, calls + 1)
    xc = x.cpu().requires_grad_()
    K1.gn_silu(xc, w.cpu(), w.cpu(), 2).sum().backward()
    torch.testing.assert_close(xg.grad.cpu(), xc.grad, atol=1e-5, rtol=1e-5)


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
    with pytest.raises(TypeError):
        K2.fused_attention(q.half().requires_grad_(), q.half(), q.half())
    with pytest.raises(TypeError):
        K2.attention_bwd(q.half(), q.half(), q.half(), q.half(), None, q.half())
    with pytest.raises(ValueError):  # K3 needs the forward kernel's lse
        K2.attention_bwd(q, q, q, q, None, q)


# (q/k/v dtype, fast): strict fp32, fast bf16, strict with bf16 activations
ATTN_BWD_MODES = {"strict": (torch.float32, False), "fast": (torch.bfloat16, True),
                  "strict_bf16": (torch.bfloat16, False)}


@pytest.mark.parametrize("mode", list(ATTN_BWD_MODES))
@pytest.mark.parametrize("b,L,nh", [(1, 1, 1), (2, 64, 1), (2, 65, 3), (1, 127, 2), (1, 300, 4)])
def test_attention_bwd_kernel_matches_plain(dev, mode, b, L, nh):
    """K2 with its lse and K3 through autograd on stride-3 views, against
    the plain backward on the same inputs."""
    dtype, fast = ATTN_BWD_MODES[mode]
    gen = torch.Generator(device=dev).manual_seed(L * nh)
    y = torch.randn(b, L, nh, 64, 3, device=dev, generator=gen).to(dtype)
    do = torch.randn(b, L, nh, 64, device=dev, generator=gen).to(dtype)
    yg = y.clone().requires_grad_()
    launches = (K2.fused_attention.launches, K2.attention_bwd.launches)
    K2.fused_attention(yg[..., 0], yg[..., 1], yg[..., 2], fast).backward(do)
    assert (K2.fused_attention.launches, K2.attention_bwd.launches) == \
        (launches[0] + 1, launches[1] + 1)
    ref = K2._plain_attention_bwd(y[..., 0], y[..., 1], y[..., 2], do, fast)
    # the tolerances of test_pallas_attn.py's gradient test, relative to the
    # largest reference gradient but no less than 1e-3 (at L=1 dq and dk are
    # zero: the softmax over one key is constant)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for i, r in enumerate(ref):
        got = yg.grad[..., i]
        assert got.dtype == dtype
        scale = max(1e-3, r.float().abs().max().item())
        assert (got.float() - r.float()).abs().max().item() <= tol * scale


def test_attention_lse_matches_logsumexp(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(2, 100, 3, 64, device=dev, generator=gen) for _ in range(3))
    out, lse = K2._launch(q, k, v, with_lse=True)
    ref = torch.logsumexp(torch.einsum("bqhc,bkhc->bhqk", q, k / 8), dim=-1).reshape(6, 100)
    torch.testing.assert_close(lse, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out, K2._launch(q, k, v, with_lse=False)[0], atol=0, rtol=0)


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
