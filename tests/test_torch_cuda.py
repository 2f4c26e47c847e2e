"""The port's CUDA kernels against their plain versions on the card, at the
edge shapes chip_smoke.py does not reach: scalar (unvectorized) paths,
unaligned views, single rows, a GroupNorm+SiLU slice streamed through
shared memory, bit-equal reruns (K1, and K2/K3 in bf16 and fp32), the fp32
kernels at every head width and length with dS = 0 on one-hot rows, ragged attention
lengths and L = 4096, the attention forward (K2) and backward (K3) in
every mode on the U-Net block's row-strided views, stride-3 views and
contiguous tensors (and on fp32 operands with fast=True, as the EDM path
runs them), the baselines' paths
(K1 at the deterministic U-Net's 10 and 14 channels per group, the
deterministic step's launches, BCSD's day-of-year sums bit-equal), the
convolutions' paths (the split kernel bit-equal to tests/_tf32x3.py, the
3xTF32 and IEEE paths at the U-Net's level-0 and level-3 shapes against
float64 beside plain TF32, the paths taken and cuDNN's TF32 flag
restored), and the wrappers' and kernels' refusals. Marked ``cuda``: they skip without a
card. On the card, without JAX (this file imports none):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import math

import numpy as np
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
                                     (2, 4, 4, 12), (1, 9, 3, 1024), (2, 3, 3, 2048),
                                     (1, 256, 256, 64), (8, 128, 128, 384), (2, 8, 8, 320),
                                     (2, 8, 8, 448)])
def test_gn_silu_kernel_matches_plain(dev, dtype, b, h, w, c):
    """Against the plain version, output and (B, G) statistics; two calls
    give equal bits (no atomics). (1, 256, 256, 64) is streamed through
    shared memory (its plan is not on chip); (8, 128, 128, 384) is the
    path's largest site, clusters of 16 blocks; C = 320 and 448 (10 and 14
    channels per group, vectors across group edges) are the deterministic
    U-Net's."""
    g = max(1, num_groups_for(c))
    assert K1.plan(b, h, w, c, g, dtype.itemsize, 132).on_chip == ((h, w) != (256, 256))
    gen = torch.Generator(device=dev).manual_seed(c)
    x = (torch.randn(b, h, w, c, device=dev, generator=gen) * 2 + 1).to(dtype)
    gamma = torch.randn(c, device=dev, generator=gen)
    beta = torch.randn(c, device=dev, generator=gen)
    before = K1.gn_silu.launches
    with torch.no_grad():
        out, mean, rstd = K1.gn_silu(x, gamma, beta, g, return_stats=True)
        again = K1.gn_silu(x, gamma, beta, g, return_stats=True)
        ref = K1._plain_gn_silu(x, gamma, beta, g)[0]
        rmean, rrstd = group_stats(x, g)
    assert K1.gn_silu.launches == before + 2
    # fp32: summation order only; bf16: one rounding of an fp32 result apart
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 2 ** -8)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=1e-5, rtol=1e-5)
    for got, first in zip(again, (out, mean, rstd)):
        assert torch.equal(got, first)


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


# ---- the convolutions (ops/conv.py): 3xTF32 and IEEE fp32 on cuDNN -----------------------

SPLIT_CASES = [((8, 128, 128, 128), "channels_last"), ((8, 512, 16, 16), "channels_last"),
               ((2, 6, 33, 17), "channels_last"), ((3, 8, 5, 7), "contiguous"),
               ((2, 16, 8, 8), "unaligned"), ((256, 128, 3, 3), "weight"),
               ((768, 256, 1, 1), "weight")]


@pytest.mark.parametrize("shape,layout", SPLIT_CASES)
@pytest.mark.parametrize("role", ["x_fwd", "w_fwd", "dy_dgrad", "w_dgrad"])
def test_tf32_split_kernel_matches_tf32x3_split(dev, shape, layout, role):
    """The split kernel against tests/_tf32x3.py's split, bit for bit: hi
    alone and the pair in each order and place the convolutions use (along
    the channels or stacked along dim 0), on channels_last and contiguous
    activations, an unaligned view (scalar path), C = 6 (no vectors) and
    OIHW weights; values at the rounding's edges included; one launch a
    call."""
    from _tf32x3 import split as split_ref

    from probunet_torch.ops import conv as C

    order, dim = {"x_fwd": (C.X_FWD, 1), "w_fwd": (C.W_FWD, 1), "dy_dgrad": (C.DY_DGRAD, 1),
                  "w_dgrad": (C.W_DGRAD, 0)}[role]
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn(shape, device=dev, generator=gen) * 3
    x.view(-1)[:4] = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 2 - 2.0 ** -23, 0.0])
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "unaligned":
        x = torch.cat([torch.zeros(1, device=dev), x.flatten()])[1:].view(shape)
        assert x.data_ptr() % 16
    before = C.conv2d.calls["split"]
    hi_got, got = C.split(x, order, dim)
    torch.cuda.synchronize()
    assert C.conv2d.calls["split"] == before + 1
    hi, lo = split_ref(x.cpu().contiguous())
    want = torch.cat([{"hi": hi, "lo": lo}[p] for p in order], dim)
    for a, b in ((got, want), (hi_got, hi)):
        assert a.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


def _conv_errors(dev, b, cin, cout, hw, k):
    """max |err| / max |ref| against float64 on the card of one
    convolution's forward, input gradient, weight gradient and bias
    gradient by each path: ``3xtf32`` (a sampler's forward, a training
    step's input gradient), ``strict`` (the training Function: IEEE
    forward and weight gradient), ``ieee`` and ``tf32`` (F.conv2d and its
    autograd with TF32 off and on)."""
    import torch.nn.functional as F

    from probunet_torch.ops import conv as C
    from probunet_torch.utils.device import full_fp32

    gen = torch.Generator(device=dev).manual_seed(cin + hw)
    x = torch.randn(b, cin, hw, hw, device=dev, generator=gen).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(cout, cin, k, k, device=dev, generator=gen) / (cin * k * k) ** 0.5
    bias = torch.randn(cout, device=dev, generator=gen)
    dy = torch.randn(b, cout, hw, hw, device=dev, generator=gen).contiguous(
        memory_format=torch.channels_last)
    refs = [t.double().requires_grad_() for t in (x, w, bias)]
    ref = F.conv2d(*refs, padding=k // 2)
    ref.backward(dy.double())
    want = [ref.detach()] + [t.grad for t in refs]

    def errs(got):
        return [((g.double() - r).abs().max() / r.abs().max()).item() for g, r in zip(got, want)]

    out = {}
    with full_fp32():
        s, p = (1, 1), (k // 2, k // 2)
        out["3xtf32"] = errs([C.forward_3x(x, w, bias, s, p), C.dgrad_3x(dy, x, w, s, p)])
        for path in ("strict", "ieee", "tf32"):
            leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
            if path == "strict":
                y = C.conv2d(*leaves, k // 2)
            else:
                torch.backends.cudnn.allow_tf32 = path == "tf32"
                y = F.conv2d(*leaves, padding=k // 2)
            y.backward(dy)
            out[path] = errs([y] + [t.grad for t in leaves])
    return out


@pytest.mark.parametrize("b,cin,cout,hw,k", [(8, 128, 128, 128, 3), (8, 384, 128, 128, 3),
                                             (8, 512, 512, 16, 3), (8, 512, 512, 16, 1)])
def test_conv_paths_at_unet_shapes_against_float64(dev, b, cin, cout, hw, k):
    """At the U-Net's level-0 (b8, 128 and 384 -> 128 channels, 128x128;
    the first takes the transposed route) and level-3 (512 channels,
    16x16) shapes, against float64: the training Function's forward and
    weight and bias gradients within twice IEEE fp32's own cuDNN error
    (they are IEEE fp32); the 3xTF32 forward and input gradient within
    6e-9 K of the largest value (K the reduction depth: the tensor cores'
    accumulator rounds toward zero, ~3e-9 K measured on the H100) or four
    times IEEE fp32's error, and a plain TF32 forward at least ten times
    further off than the 3xTF32 one."""
    e = _conv_errors(dev, b, cin, cout, hw, k)
    msg = f"(y, dx, dw, db) {e}"
    limit = 2 ** -20
    for got, ieee in zip(e["strict"][:1] + e["strict"][2:], e["ieee"][:1] + e["ieee"][2:]):
        assert got <= max(2 * ieee, limit), msg
    for got, ieee, depth in zip(e["3xtf32"], e["ieee"], (cin * k * k, cout * k * k)):
        assert got <= max(6e-9 * depth, 4 * ieee), msg
    assert e["tf32"][0] >= 10 * e["3xtf32"][0], msg


def test_conv2d_paths_and_the_cudnn_flag_on_card(dev):
    """An fp32 CUDA conv whose gradient is recorded runs the IEEE forward,
    the 3xTF32 input gradient (two split launches) and the IEEE weight
    gradient; without a gradient the 3xTF32 forward (two split launches);
    bf16 takes F.conv2d; cudnn.allow_tf32 reads as before after a call,
    and after a call that raised."""
    from probunet_torch.ops import conv as C
    from probunet_torch.utils.device import full_fp32

    def delta(before):
        return {k: v - before[k] for k, v in C.conv2d.calls.items() if v != before[k]}

    x = torch.randn(2, 8, 16, 16, device=dev).contiguous(memory_format=torch.channels_last)
    w = torch.randn(4, 8, 3, 3, device=dev)
    b = torch.randn(4, device=dev)
    saved = torch.backends.cudnn.allow_tf32
    try:
        with full_fp32():
            c0 = dict(C.conv2d.calls)
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            C.conv2d(xg, wg, b, 1).square().sum().backward()
            assert torch.backends.cudnn.allow_tf32 is False
            assert delta(c0) == {"ieee_fwd": 1, "tf32x3_dgrad": 1, "ieee_wgrad": 1, "split": 2}
            c1 = dict(C.conv2d.calls)
            with torch.no_grad():
                C.conv2d(x, w, b, 1)
            assert delta(c1) == {"tf32x3_fwd": 1, "split": 2}
            c2 = dict(C.conv2d.calls)
            C.conv2d(x.bfloat16(), w.bfloat16(), b.bfloat16(), 1)
            assert delta(c2) == {"plain": 1}
            with pytest.raises(RuntimeError):
                C.conv2d(x, torch.randn(4, 6, 3, 3, device=dev), b, 1)   # 8 != 6 channels
            assert torch.backends.cudnn.allow_tf32 is False
            with pytest.raises(TypeError):
                C.conv2d(x, w.double(), b, 1)
        torch.backends.cudnn.allow_tf32 = True
        C.conv2d(x, w, b, 1)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# (q/k/v dtype, fast): strict fp32, fast bf16, strict with bf16 activations
ATTN_MODES = {"strict": (torch.float32, False), "fast": (torch.bfloat16, True),
              "strict_bf16": (torch.bfloat16, False)}
# the U-Net block's views of its (qkv, head, channel)-ordered conv output
# (row-strided, unit head-dim stride: read in place), stride-3 views of an
# interleaved qkv tensor (copied by the wrapper), separate contiguous tensors
LAYOUTS = ("block", "stride3", "contiguous")


def _qkv(layout, b, L, nh, dtype, dev, gen, grad=False, c=64):
    """((q, k, v), grad): q/k/v of head dim ``c`` in ``layout``, views of
    one leaf tensor (or three leaves), and a function giving the gradient of
    the i-th."""
    if layout == "block":
        leaf = torch.randn(b, L, 3, nh, c, device=dev, generator=gen).to(dtype)
        leaf.requires_grad_(grad)
        return leaf.unbind(2), lambda i: leaf.grad[:, :, i]
    if layout == "stride3":
        leaf = torch.randn(b, L, nh, c, 3, device=dev, generator=gen).to(dtype)
        leaf.requires_grad_(grad)
        return tuple(leaf[..., i] for i in range(3)), lambda i: leaf.grad[..., i]
    leaves = [torch.randn(b, L, nh, c, device=dev, generator=gen).to(dtype).requires_grad_(grad)
              for _ in range(3)]
    return tuple(leaves), lambda i: leaves[i].grad


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", list(ATTN_MODES))
@pytest.mark.parametrize("b,L,nh", [(1, 1, 1), (2, 65, 3), (1, 127, 2), (2, 64, 1), (1, 300, 4),
                                    (1, 4096, 2)])
def test_attention_kernel_matches_plain(dev, mode, layout, b, L, nh):
    dtype, fast = ATTN_MODES[mode]
    gen = torch.Generator(device=dev).manual_seed(L)
    (q, k, v), _ = _qkv(layout, b, L, nh, dtype, dev, gen)
    assert (q.stride(-1) == 1) == (layout != "stride3")
    before = K2.fused_attention.launches
    with torch.no_grad():
        out = K2.fused_attention(q, k, v, fast)
        ref = K2._plain_attention(q, k, v, fast)
    assert K2.fused_attention.launches == before + 1
    assert out.shape == (b, L, nh, 64) and out.dtype == dtype and out.is_contiguous()
    # fp32: 3xTF32 against fp32 einsums; bf16: the plain version rounds the
    # logits to bf16, the kernel keeps them fp32
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_attention_kernel_refusals(dev):
    q = torch.randn(1, 8, 2, 64, device=dev)
    with pytest.raises(TypeError):
        K2.fused_attention(q.half(), q.half(), q.half())
    wide = torch.randn(1, 8, 2, 136, device=dev)  # past the widest head the kernels hold
    with pytest.raises(ValueError, match=r"\(1, 8, 2, 136\)"):
        K2.fused_attention(wide, wide, wide)
    with pytest.raises(TypeError):
        K2.fused_attention(q.half().requires_grad_(), q.half(), q.half())
    with pytest.raises(TypeError):
        K2.attention_bwd(q.half(), q.half(), q.half(), q.half(), None, q.half())
    with pytest.raises(ValueError):  # K3 needs the forward kernel's lse
        K2.attention_bwd(q, q, q, q, None, q)


def test_attention_kernels_refuse_strided_head_dim(dev):
    """Handed straight to the kernels, a head dim that is not unit-stride (or
    rows that are not 16-byte aligned) is refused before any launch; the
    public wrappers copy such views first (kernel_layout)."""
    y = torch.randn(2, 16, 2, 64, 3, device=dev)
    q, k, v = y[..., 0], y[..., 1], y[..., 2]
    flat = torch.randn(2 * 16 * 2 * 64 + 1, device=dev)
    odd = flat[1:].view(2, 16, 2, 64)  # unit stride, 4 bytes off alignment
    c = q.contiguous()
    before = (K2.fused_attention.launches, K2.attention_bwd.launches)
    for bad in ((q, c, c), (c, k, c), (c, c, v), (odd, c, c)):
        with pytest.raises(ValueError, match="unit-stride"):
            K2._launch(*bad, with_lse=True)
    out, lse = K2._launch(c, c, c, with_lse=True)
    for bad in ((q, c, c, out, c), (c, c, c, out, v), (c, c, c, out, odd)):
        with pytest.raises(ValueError, match="unit-stride"):
            K2._launch_bwd(*bad[:4], lse, bad[4], False)
    assert (K2.fused_attention.launches, K2.attention_bwd.launches) == (before[0] + 1, before[1])
    assert K2.kernel_layout(q).is_contiguous() and K2.kernel_layout(c) is c


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", list(ATTN_MODES))
@pytest.mark.parametrize("b,L,nh", [(1, 1, 1), (2, 64, 1), (2, 65, 3), (1, 127, 2), (1, 300, 4),
                                    (1, 4096, 2)])
def test_attention_bwd_kernel_matches_plain(dev, mode, layout, b, L, nh):
    """K2 with its lse and K3 through autograd, against the plain backward
    on the same inputs."""
    dtype, fast = ATTN_MODES[mode]
    gen = torch.Generator(device=dev).manual_seed(L * nh)
    (q, k, v), grad = _qkv(layout, b, L, nh, dtype, dev, gen, grad=True)
    do = torch.randn(b, L, nh, 64, device=dev, generator=gen).to(dtype)
    launches = (K2.fused_attention.launches, K2.attention_bwd.launches)
    K2.fused_attention(q, k, v, fast).backward(do)
    assert (K2.fused_attention.launches, K2.attention_bwd.launches) == \
        (launches[0] + 1, launches[1] + 1)
    ref = K2._plain_attention_bwd(q.detach(), k.detach(), v.detach(), do, fast)
    # the tolerances of test_pallas_attn.py's gradient test, relative to the
    # largest reference gradient but no less than 1e-3 (at L=1 dq and dk are
    # zero: the softmax over one key is constant)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for i, r in enumerate(ref):
        got = grad(i)
        assert got.dtype == dtype
        scale = max(1e-3, r.float().abs().max().item())
        assert (got.float() - r.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "strict_bf16"])
@pytest.mark.parametrize("b,L,nh", [(8, 1024, 6), (8, 256, 8), (2, 65, 3), (1, 4096, 2)])
def test_attention_bf16_kernels_rerun_bit_equal(dev, fast, b, L, nh):
    """K2 (output and lse) and K3 (dq, dk, dv) on bf16 give the same bits
    on a second call: every sum runs in a fixed order, no atomics. The
    shapes take both block sizes of the plan (128 rows at the U-Net's
    L=1024 sites, 64 at its L=256 sites and below)."""
    gen = torch.Generator(device=dev).manual_seed(L + nh)
    (q, k, v), _ = _qkv("block", b, L, nh, torch.bfloat16, dev, gen)
    do = torch.randn(b, L, nh, 64, device=dev, generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        first = K2._launch(q, k, v, with_lse=True)
        second = K2._launch(q, k, v, with_lse=True)
        grads = [K2.attention_bwd(q, k, v, first[0], first[1], do, fast) for _ in range(2)]
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))
    assert all(torch.equal(a, b_) for a, b_ in zip(*grads))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("b,L,nh", [(1, 1, 1), (2, 65, 3), (1, 300, 4)])
def test_attention_fp32_with_fast_runs_the_strict_kernels(dev, layout, b, L, nh):
    """The EDM U-Net runs fp32 activations with fast attention: K2 and K3
    on fp32 operands with fast=True give the strict kernels' results bit
    for bit, within the strict tolerances of the plain fast versions."""
    gen = torch.Generator(device=dev).manual_seed(L + 7 * nh)
    (q, k, v), grad = _qkv(layout, b, L, nh, torch.float32, dev, gen, grad=True)
    do = torch.randn(b, L, nh, 64, device=dev, generator=gen)
    out = K2.fused_attention(q, k, v, True)
    out.backward(do)
    got = [grad(i).clone() for i in range(3)]
    for i in range(3):
        grad(i).zero_()
    strict = K2.fused_attention(q, k, v, False)
    strict.backward(do)
    assert torch.equal(out, strict)
    assert all(torch.equal(got[i], grad(i)) for i in range(3))
    with torch.no_grad():
        ref = K2._plain_attention(q, k, v, True)
        ref_b = K2._plain_attention_bwd(q.detach(), k.detach(), v.detach(), do, True)
    torch.testing.assert_close(out.detach(), ref, atol=2e-5, rtol=2e-5)
    for g, r in zip(got, ref_b):
        assert (g - r).abs().max().item() <= 1e-4 * max(1e-3, r.abs().max().item())


# head dims past 64: 65 (copied zero-padded to 72 columns) and 72 (the
# 288-wide level of model_channels 96: 4 heads) run the bf16 kernels' kD =
# 80, 80 too; 88 and 96 (one head of a 96-wide level) kD = 96; 100 (bf16
# rows of 200 bytes, not whole 16-byte chunks: copied zero-padded to 104
# columns first) kD = 128; the fp32 kernels run kD = 128 at all of them; 32
# runs kD = 64 on a zero-padded copy
HEAD_DIMS = (32, 65, 72, 80, 88, 96, 100)


def _head_dim_copies(layout, c):
    """kernel_layout's copies in one forward and backward at head dim c: the
    block's views and contiguous tensors of whole 16-byte bf16 chunks are
    read in place; otherwise q, k and v are copied once (the backward reuses
    the forward's), and dO too where its rows must be padded."""
    if c == K2.kernel_width(c):
        return 0 if layout != "stride3" else 3
    return 4


@pytest.mark.parametrize("c", HEAD_DIMS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", list(ATTN_MODES))
@pytest.mark.parametrize("b,L,nh", [(1, 1, 1), (2, 65, 3), (1, 300, 4), (2, 1024, 1)])
def test_attention_head_dims_match_plain(dev, mode, layout, b, L, nh, c):
    """K2 and K3 at head dims other than 64, through autograd, against the
    plain versions on the same inputs, with the tolerances of the head dim
    64 tests; one launch of each, the copies kernel_layout must make and no
    other, results of c columns."""
    dtype, fast = ATTN_MODES[mode]
    gen = torch.Generator(device=dev).manual_seed(L * nh + c)
    (q, k, v), grad = _qkv(layout, b, L, nh, dtype, dev, gen, grad=True, c=c)
    do = torch.randn(b, L, nh, c, device=dev, generator=gen).to(dtype)
    counts = (K2.fused_attention.launches, K2.attention_bwd.launches)
    K2.kernel_layout.copies = 0
    out = K2.fused_attention(q, k, v, fast)
    out.backward(do)
    assert (K2.fused_attention.launches - counts[0], K2.attention_bwd.launches - counts[1]) == \
        (1, 1)
    assert K2.kernel_layout.copies == _head_dim_copies(layout, c)
    assert out.shape == (b, L, nh, c) and out.dtype == dtype and out.is_contiguous()
    with torch.no_grad():
        ref = K2._plain_attention(q, k, v, fast)
        ref_b = K2._plain_attention_bwd(q.detach(), k.detach(), v.detach(), do, fast)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.detach().float(), ref.float(), atol=tol, rtol=tol)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for i, r in enumerate(ref_b):
        got = grad(i)
        assert got.shape == r.shape and got.dtype == dtype
        assert (got.float() - r.float()).abs().max().item() <= \
            tol * max(1e-3, r.float().abs().max().item())


@pytest.mark.parametrize("c", HEAD_DIMS)
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "strict_bf16"])
@pytest.mark.parametrize("b,L,nh", [(8, 1024, 4), (2, 65, 3)])
def test_attention_head_dims_rerun_bit_equal(dev, fast, b, L, nh, c):
    """K2 (output and lse) and K3 on bf16 at head dims past 64 give the
    same bits on a second call; (8, 1024, 4) at c = 72 is the
    model_channels 96 path's 32x32 site."""
    gen = torch.Generator(device=dev).manual_seed(L + nh + c)
    (q, k, v), _ = _qkv("block", b, L, nh, torch.bfloat16, dev, gen, c=c)
    do = torch.randn(b, L, nh, c, device=dev, generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        q, k, v = map(K2.kernel_layout, (q, k, v))
        first = K2._launch(q, k, v, with_lse=True, c=c)
        second = K2._launch(q, k, v, with_lse=True, c=c)
        grads = [K2.attention_bwd(q, k, v, first[0], first[1], do, fast, c) for _ in range(2)]
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))
    assert all(torch.equal(a, b_) for a, b_ in zip(*grads))
    assert all(g.shape == (b, L, nh, c) for g in grads[0])


def _same_plan_as_kd128(monkeypatch, kd):
    """Runs the exact-width kernels (kd) at kD = 128's block shape: 64-row
    blocks and K/V tiles, so that K2's online softmax meets the same tiles
    in the same order."""
    real = K2.plan

    def plan(b, heads, L, num_sms, kd_=64):
        p = real(b, heads, L, num_sms, kd_)
        return p._replace(fwd_rows=64, fwd_tile=64) if kd_ == kd else p

    monkeypatch.setattr(K2, "plan", plan)


@pytest.mark.parametrize("c", [72, 88])
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "strict_bf16"])
@pytest.mark.parametrize("b,L,nh", [(8, 1024, 4), (2, 65, 3), (1, 300, 2), (1, 1, 1)])
def test_attention_exact_width_matches_kd128(dev, monkeypatch, fast, b, L, nh, c):
    """The exact-width bf16 kernels (kD = 80 at c = 72, 96 at 88) against
    the kD = 128 ones on the same inputs: K3 on the same forward output and
    lse gives the same bits (the columns past c and the k steps past the
    tail add exact zeros), and so does K2 at kD = 128's block shape; at its
    own plan (128-row K/V tiles at kD = 80 where they fill the card) K2's
    online softmax rescales at other tile bounds, within the fast tolerance.
    (8, 1024, 4) at c = 72 is the model_channels 96 path's 32x32 site."""
    kd = 80 if c <= 80 else 96
    gen = torch.Generator(device=dev).manual_seed(L + nh + c)
    (q, k, v), _ = _qkv("block", b, L, nh, torch.bfloat16, dev, gen, c=c)
    do = torch.randn(b, L, nh, c, device=dev, generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        before = dict(K2.fused_attention.launches_by_kd)
        own = K2._launch(q, k, v, with_lse=True)
        assert K2.fused_attention.launches_by_kd.get(f"bf16_kd{kd}", 0) == \
            before.get(f"bf16_kd{kd}", 0) + 1
        wide = K2._launch(q, k, v, with_lse=True, kd=128)
        grads = K2._launch_bwd(q, k, v, wide[0], wide[1], do, fast)
        grads_wide = K2._launch_bwd(q, k, v, wide[0], wide[1], do, fast, kd=128)
        _same_plan_as_kd128(monkeypatch, kd)
        same_shape = K2._launch(q, k, v, with_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(grads, grads_wide))
    assert torch.equal(same_shape[0], wide[0]) and torch.equal(same_shape[1], wide[1])
    torch.testing.assert_close(own[0].float(), wide[0].float(), atol=2e-2, rtol=2e-2)
    assert (own[1] - wide[1]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("c", [72, 88])
def test_attention_exact_width_tail_atom(dev, c):
    """One site (b1, L = 64: one block, one K/V tile) whose q, k, v and dO
    are nonzero only in the tail atom's columns 64 .. c - 1: S = Q K^T and
    dP = dO V^T come from the tail's K-major k16 steps alone, and O, dV, dK
    and dQ from its MN-major m64nTk16 products alone (32-byte swizzle at
    kD = 80, 64-byte at 96). Against the plain versions; columns 0 .. 63
    of every result exactly 0. A kd narrower than the row is refused by
    the entry point, one not built by the plan."""
    gen = torch.Generator(device=dev).manual_seed(c)
    (q, k, v), _ = _qkv("block", 1, 64, 2, torch.bfloat16, dev, gen, c=c)
    do = torch.randn(1, 64, 2, c, device=dev, generator=gen).to(torch.bfloat16)
    for a in (q, k, v, do):
        a[..., :64] = 0
    with torch.no_grad():
        out, lse = K2._launch(q, k, v, with_lse=True)
        grads = K2._launch_bwd(q, k, v, out, lse, do, True)
        ref = K2._plain_attention(q, k, v, True)
        ref_b = K2._plain_attention_bwd(q, k, v, do, True)
    assert not out[..., :64].any() and all(not g[..., :64].any() for g in grads)
    assert out[..., 64:].abs().max().item() > 0.1
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    for g, r in zip(grads, ref_b):
        assert (g.float() - r.float()).abs().max().item() <= \
            5e-2 * max(1e-3, r.float().abs().max().item())
    with pytest.raises(RuntimeError, match="attention kernel"):
        K2._launch(q, k, v, with_lse=False, kd=64)
    with pytest.raises(ValueError, match="kd"):
        K2._launch(q, k, v, with_lse=False, kd=112)


# ---- the fp32 (strict, 3xTF32 on tf32 wgmma) kernels -------------------------------------

# every head width the kernels hold: 64 (kD = 64), 72 (the model_channels 96
# path), 80, 96 (read in place), 100 and 127 (copied zero-padded to 104 and
# 128), at lengths that take one row, a ragged tile of each tile size (32
# and 64 rows), the path's lengths and beyond
FP32_HEAD_DIMS = (64, 72, 80, 96, 100, 127)
FP32_LENGTHS = (1, 65, 100, 256, 1024, 2048)


@pytest.mark.parametrize("c", FP32_HEAD_DIMS)
@pytest.mark.parametrize("L", FP32_LENGTHS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_attention_fp32_kernels_match_plain(dev, layout, L, c):
    """K2 and K3 on fp32 through autograd against the plain versions on
    the same inputs: O within 2e-5 (ATTN_TOL strict), dq, dk, dv within
    1e-4 of the largest reference entry; one launch of each, only the
    copies kernel_layout must make (none on the block's views and
    contiguous tensors of whole 16-byte chunks), results of c columns."""
    b, nh = (2, 3) if L <= 256 else (1, 2)
    gen = torch.Generator(device=dev).manual_seed(L + c)
    (q, k, v), grad = _qkv(layout, b, L, nh, torch.float32, dev, gen, grad=True, c=c)
    do = torch.randn(b, L, nh, c, device=dev, generator=gen)
    counts = (K2.fused_attention.launches, K2.attention_bwd.launches)
    K2.kernel_layout.copies = 0
    out = K2.fused_attention(q, k, v)
    out.backward(do)
    assert (K2.fused_attention.launches - counts[0], K2.attention_bwd.launches - counts[1]) == \
        (1, 1)
    assert K2.kernel_layout.copies == _head_dim_copies(layout, c)
    assert out.shape == (b, L, nh, c) and out.dtype == torch.float32 and out.is_contiguous()
    with torch.no_grad():
        ref = K2._plain_attention(q, k, v, False)
        ref_b = K2._plain_attention_bwd(q.detach(), k.detach(), v.detach(), do, False)
    torch.testing.assert_close(out.detach(), ref, atol=2e-5, rtol=2e-5)
    for i, r in enumerate(ref_b):
        got = grad(i)
        assert got.shape == r.shape and got.dtype == torch.float32
        assert (got - r).abs().max().item() <= 1e-4 * max(1e-3, r.abs().max().item())


@pytest.mark.parametrize("c", [64, 72, 100])
@pytest.mark.parametrize("b,L,nh", [(8, 1024, 6), (8, 256, 8), (2, 65, 3), (1, 2048, 2)])
def test_attention_fp32_kernels_rerun_bit_equal(dev, b, L, nh, c):
    """K2 (output and lse) and K3 on fp32 give the same bits on a second
    call: every sum runs in a fixed order, no atomics."""
    gen = torch.Generator(device=dev).manual_seed(L + nh + c)
    (q, k, v), _ = _qkv("block", b, L, nh, torch.float32, dev, gen, c=c)
    do = torch.randn(b, L, nh, c, device=dev, generator=gen)
    with torch.no_grad():
        q, k, v = map(K2.kernel_layout, (q, k, v))
        first = K2._launch(q, k, v, with_lse=True, c=c)
        second = K2._launch(q, k, v, with_lse=True, c=c)
        grads = [K2.attention_bwd(q, k, v, first[0], first[1], do, False, c) for _ in range(2)]
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))
    assert all(torch.equal(a, b_) for a, b_ in zip(*grads))


@pytest.mark.parametrize("c", FP32_HEAD_DIMS)
def test_attention_fp32_one_hot_rows_give_zero_ds(dev, c):
    """At L = 1 every softmax row is one-hot, so dS = P o (dP - D) is 0 and
    with it dq and dk, exactly, as in the plain version: the row pass takes
    D on the tensor cores in the form of dP, from O, whose split is V's."""
    gen = torch.Generator(device=dev).manual_seed(c)
    (q, k, v), _ = _qkv("block", 4, 1, 3, torch.float32, dev, gen, c=c)
    do = torch.randn(4, 1, 3, c, device=dev, generator=gen)
    with torch.no_grad():
        q, k, v = map(K2.kernel_layout, (q, k, v))
        out, lse = K2._launch(q, k, v, with_lse=True, c=c)
        dq, dk, dv = K2.attention_bwd(q, k, v, out, lse, do, False, c)
    assert not dq.any() and not dk.any()
    torch.testing.assert_close(dv, do, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("c", [64, 72])
@pytest.mark.parametrize("L", [256, 1024])
def test_attention_fp32_kernels_match_the_tf32x3_emulation(dev, L, c):
    """K2 and K3 on fp32 against tests/_tf32x3.py, the emulation of their
    arithmetic that test_torch_tf32x3.py holds against JAX, on the same
    inputs (K3 on both sides from K2's O and lse): O and lse within 5e-6,
    dq, dk, dv within 2.5e-5 of the largest entry, a quarter of the strict
    limits. They agree to these limits, not bit for bit: wgmma sums each k8
    step of a product in its own order."""
    from _tf32x3 import _bh, emulated_bwd, emulated_fwd

    b, nh = (2, 2) if L == 256 else (1, 2)
    rng = np.random.default_rng(L + c)
    host = [torch.from_numpy(rng.standard_normal((b, L, nh, c)).astype(np.float32))
            for _ in range(4)]
    q, k, v, do = (a.to(dev) for a in host)
    with torch.no_grad():
        out, lse = K2._launch(q, k, v, with_lse=True, c=c)
        grads = K2.attention_bwd(q, k, v, out, lse, do, False, c)
    out, lse = _bh(out.cpu()), lse.cpu()
    emu_o, emu_lse = emulated_fwd(*map(_bh, host[:3]))
    assert (out - emu_o).abs().max().item() <= 5e-6
    assert (lse - emu_lse).abs().max().item() <= 5e-6
    emu = emulated_bwd(*map(_bh, host[:3]), out, lse, _bh(host[3]))
    for got, ref in zip(grads, emu):
        got = _bh(got.cpu())
        assert (got - ref).abs().max().item() <= 2.5e-5 * ref.abs().max().item()


def _rms_rel(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


# strict mode with bf16 activations against rounded dS: chip_smoke.py's
# DS_SPLIT_TOL, ||err||_2 / ||ref||_2 of dq and dk
DS_SPLIT_TOL = 6e-4


def _plain_dq_dk(q, k, v, out, do, fast):
    """chip_smoke.py's plain_dq_dk: dq, dk with fp32 dS (rounded to bf16
    when ``fast``) and D = rowsum(dO o O) from K2's output, as K3 takes it."""
    qf, kf, vf, dof = (a.float() for a in (q, k, v, do))
    r = math.sqrt(q.shape[-1])
    p = torch.softmax(torch.einsum("bqhc,bkhc->bhqk", qf, kf / r), dim=-1)
    dp = torch.einsum("bqhc,bkhc->bhqk", dof, vf)
    ds = p * (dp - (dof * out.float()[..., :q.shape[-1]]).sum(-1).transpose(1, 2)[..., None])
    if fast:
        ds = ds.to(q.dtype).float()
    return (torch.einsum("bhqk,bkhc->bqhc", ds, kf).div(r).to(q.dtype),
            torch.einsum("bhqk,bqhc->bkhc", ds, qf).div(r).to(q.dtype))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("b,L,nh", [(2, 65, 3), (1, 300, 4), (2, 256, 8)])
def test_attention_bwd_strict_bf16_keeps_ds_unrounded(dev, layout, b, L, nh):
    """K3 in strict mode with bf16 activations carries dS as two bf16
    terms: its dq and dk lie within DS_SPLIT_TOL of the plain strict
    backward with K3's D, while the same kernel in fast mode (dS rounded to
    bf16) and the same plain backward with dS rounded land beyond it."""
    gen = torch.Generator(device=dev).manual_seed(L + nh)
    (q, k, v), _ = _qkv(layout, b, L, nh, torch.bfloat16, dev, gen)
    do = torch.randn(b, L, nh, 64, device=dev, generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        out, lse = K2._launch(*map(K2.kernel_layout, (q, k, v)), with_lse=True)
        split = K2.attention_bwd(q, k, v, out, lse, do, False)
        rounded = K2.attention_bwd(q, k, v, out, lse, do, True)
        exact = _plain_dq_dk(q, k, v, out, do, False)
        plain_rounded = _plain_dq_dk(q, k, v, out, do, True)
    for i in range(2):
        assert _rms_rel(split[i], exact[i]) <= DS_SPLIT_TOL
        assert _rms_rel(rounded[i], exact[i]) > DS_SPLIT_TOL
        assert _rms_rel(plain_rounded[i], exact[i]) > DS_SPLIT_TOL


@pytest.mark.parametrize("mc", [64, 96])
@pytest.mark.parametrize("fast", [False, True])
def test_unet_block_copies_nothing_before_attention(dev, fast, mc):
    """Forward and backward of a small U-Net with attention on the card:
    the block's q/k/v, K2's output and the incoming dO reach the kernels
    without a copy (kernel_layout counts none), at head dim 64 and, with
    model_channels 96, at the 288-wide level's 4 heads of 72."""
    from probunet_torch.models import UNet

    kw = dict(img_resolution=(16, 16), in_channels=3, out_channels=3, model_channels=mc,
              channel_mult=(1, 2) if mc == 64 else (1, 3), num_blocks=1,
              attn_resolutions=(16,) if mc == 64 else (8,), dropout=0.0, fast_attention=fast)
    net = UNet(device="cpu", generator=torch.Generator().manual_seed(0), **kw).to(dev)
    assert {b.qkv.weight.shape[0] // 3 // b.heads for b in net.modules()
            if getattr(b, "heads", 0)} == ({64} if mc == 64 else {72})
    x = torch.randn(2, 16, 16, 3, device=dev).to(torch.bfloat16 if fast else torch.float32)
    K2.kernel_layout.copies = 0
    launches = (K2.fused_attention.launches, K2.attention_bwd.launches)
    net(x).float().square().sum().backward()
    assert K2.fused_attention.launches > launches[0] and K2.attention_bwd.launches > launches[1]
    assert K2.kernel_layout.copies == 0


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", list(ATTN_MODES))
def test_attention_lse_matches_logsumexp(dev, mode, layout):
    dtype, _ = ATTN_MODES[mode]
    gen = torch.Generator(device=dev).manual_seed(0)
    (q, k, v), _ = _qkv(layout, 2, 100, 3, dtype, dev, gen)
    q, k, v = map(K2.kernel_layout, (q, k, v))
    out, lse = K2._launch(q, k, v, with_lse=True)
    ref = torch.logsumexp(torch.einsum("bqhc,bkhc->bhqk", q.float(), k.float() / 8),
                          dim=-1).reshape(6, 100)
    torch.testing.assert_close(lse, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out, K2._launch(q, k, v, with_lse=False)[0], atol=0, rtol=0)


@pytest.mark.parametrize("mc", [64, 96])
def test_unet_on_card_matches_cpu(dev, mc):
    """A small U-Net with attention: the card's kernels and cuDNN against the
    CPU's plain versions, same weights, strict fp32; at model_channels 96
    the 288-wide level runs 4 heads of 72."""
    from probunet_torch.models import UNet
    from probunet_torch.utils.device import full_fp32

    kw = dict(img_resolution=(16, 16), in_channels=3, out_channels=3, model_channels=mc,
              channel_mult=(1, 2) if mc == 64 else (1, 3), num_blocks=1,
              attn_resolutions=(16,) if mc == 64 else (8,), dropout=0.0)
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


# ---- the trainer's pieces on the card -------------------------------------------------

def _tiny_train_state(dev, remat=False, **opt_kw):
    """A small Probabilistic U-Net with attention at 8x8 (one head), dropout
    0.1, filled weights, its AdamW state, a train step and 6 days of data,
    all on the card."""
    from probunet_torch.models import ProbabilisticUNet
    from probunet_torch.train.state import create_train_state, make_optimizer
    from probunet_torch.train.steps import make_probunet_train_step

    model = ProbabilisticUNet(3, 3, latent_dim=4, num_filters=(16, 32), img_resolution=(16, 16),
                              model_channels=64, channel_mult=(1, 2), num_blocks=1,
                              attn_resolutions=(8,), dropout=0.1, remat=remat, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    model = model.to(dev, memory_format=torch.channels_last)
    state = create_train_state(model, make_optimizer(**opt_kw))
    step = make_probunet_train_step(model, 4, "perpixel")
    hr = torch.rand(6, 16, 16, 3, generator=torch.Generator().manual_seed(2)).to(dev) + 1
    stats = (hr.mean(0), hr.std(0))
    return state, step, hr, stats


def test_device_prefetcher_busy_consumer_gets_equal_batches(dev):
    """Batches copied on the side stream while the consumer's stream is
    busy, each handed over (wait on its copy, record_stream) and dropped
    once a kernel on the consumer's stream has read it: every read equals
    its host batch, bit for bit."""
    from probunet_torch.data.pipeline import DevicePrefetcher

    rng = np.random.default_rng(0)
    host = [{"hr": rng.standard_normal((8, 128, 128, 3)).astype(np.float32),
             "stats": (rng.standard_normal((8, 1, 1, 3)).astype(np.float32),)}
            for _ in range(12)]
    a = torch.randn(2048, 2048, device=dev)
    reads = []
    for item in DevicePrefetcher(iter(host), buffer_size=2, device=dev):
        for _ in range(4):   # keep the consumer's stream busy behind the copies
            a = torch.tanh(a @ a)
        reads.append((item["hr"] * 1.0, item["stats"][0] + 0.0))
        del item
    torch.cuda.synchronize()
    assert len(reads) == len(host)
    for (hr, st), ref in zip(reads, host):
        assert torch.equal(hr.cpu(), torch.from_numpy(ref["hr"]))
        assert torch.equal(st.cpu(), torch.from_numpy(ref["stats"][0]))


def test_remat_launch_counts_and_gradients(dev):
    """One training step with every U-Net block recomputed: K1 at every
    block's norm0 twice (+ out_norm once), K2 twice per attention block, K3
    once; no tensor copied before an attention launch; loss and gradients
    those of the step without remat (deterministic cuDNN)."""
    from probunet_torch.models.unet import UNetBlock

    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for remat in (False, True):
            state, step, hr, stats = _tiny_train_state(dev, remat=remat)
            blocks = [m for m in state.model.unet.modules() if isinstance(m, UNetBlock)]
            attn = sum(1 for m in blocks if m.heads)
            counts = (K1.gn_silu.launches, K2.fused_attention.launches,
                      K2.attention_bwd.launches, K2.kernel_layout.copies)
            m = step(state, hr, stats, torch.tensor([0, 3], device=dev), 5)
            torch.cuda.synchronize()
            n = tuple(after - before for after, before in zip(
                (K1.gn_silu.launches, K2.fused_attention.launches, K2.attention_bwd.launches,
                 K2.kernel_layout.copies), counts))
            k = 2 if remat else 1
            assert n == (k * len(blocks) + 1, k * attn, attn, 0), (remat, n)
            out[remat] = (m["train_loss"].item(),
                          {name: p.grad.clone() for name, p in state.model.named_parameters()})
        assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
        for name, g in out[False][1].items():
            torch.testing.assert_close(out[True][1][name], g, rtol=1e-5, atol=1e-6, msg=name)
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.parametrize("opt_kw", [dict(), dict(state_dtype="bfloat16"), dict(accum=2)],
                         ids=["adamw", "adamw_bf16", "accum2"])
def test_checkpoint_roundtrip_of_optimizer_state_on_card(dev, tmp_path, opt_kw):
    """Saved after 3 steps, restored into a fresh state on the card: every
    moment, count and accumulation buffer lands on the card with its dtype
    and bits, and one more step on each state gives equal parameters."""
    from probunet_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    torch.backends.cudnn.deterministic = True
    try:
        state, step, hr, stats = _tiny_train_state(dev, **opt_kw)
        for i in range(3):
            step(state, hr, stats, torch.tensor([i, i + 3], device=dev), 7)
        save_checkpoint(str(tmp_path), state)
        fresh, fresh_step, _, _ = _tiny_train_state(dev, **opt_kw)
        restore_checkpoint(str(tmp_path), fresh)
        assert fresh.step == 3 and fresh.optimizer.mini_step == state.optimizer.mini_step
        for p, q in zip(state.model.parameters(), fresh.model.parameters()):
            assert torch.equal(p, q)
            for key, val in state.optimizer.inner.state[p].items():
                got = fresh.optimizer.inner.state[q][key]
                assert got.device == val.device and got.dtype == val.dtype, key
                assert torch.equal(got, val), key
        assert [g.get("count") for g in fresh.optimizer.inner.param_groups] == \
            [g.get("count") for g in state.optimizer.inner.param_groups]
        for a, b in zip(state.optimizer.acc or [], fresh.optimizer.acc or []):
            assert b.is_cuda and torch.equal(a, b)
        idx = torch.tensor([1, 2], device=dev)
        step(state, hr, stats, idx, 7)
        fresh_step(fresh, hr, stats, idx, 7)
        for p, q in zip(state.model.parameters(), fresh.model.parameters()):
            assert torch.equal(p, q)
    finally:
        torch.backends.cudnn.deterministic = False


def test_deterministic_step_launches_k1_only(dev):
    """One step of the deterministic baseline U-Net (no attention, cyclic
    labels through map_label) on the card: one K1 launch per GroupNorm+SiLU
    module, no K2 or K3; loss and gradients those of the CPU step."""
    from probunet_torch.models import UNet
    from probunet_torch.models.layers import GroupNormSiLU
    from probunet_torch.train.state import create_train_state, make_optimizer
    from probunet_torch.train.steps import make_deterministic_train_step

    model = UNet((16, 16), 3, 3, label_dim=2, model_channels=32, channel_mult=(1, 2, 3),
                 num_blocks=1, attn_resolutions=(), bottleneck_attention=False, dropout=0.0,
                 device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    hr = torch.rand(6, 16, 16, 3, generator=torch.Generator().manual_seed(2)) + 1
    ts = (torch.arange(6) * 40 * 86400e9 + 9.5e17).float()
    out = {}
    for where in ("cpu", dev):
        m = UNet((16, 16), 3, 3, label_dim=2, model_channels=32, channel_mult=(1, 2, 3),
                 num_blocks=1, attn_resolutions=(), bottleneck_attention=False, dropout=0.0,
                 device="meta").to_empty(device=where).to(memory_format=torch.channels_last)
        m.load_state_dict(model.state_dict())
        state = create_train_state(m, make_optimizer())
        step = make_deterministic_train_step(m, 4, "perpixel", timetransform="cyclic")
        h = hr.to(where)
        counts = (K1.gn_silu.launches, K2.fused_attention.launches, K2.attention_bwd.launches)
        metrics = step(state, h, (h.mean(0), h.std(0)), torch.tensor([0, 4], device=where),
                       ts[[0, 4]].to(where), 3)
        n = tuple(a - b for a, b in zip(
            (K1.gn_silu.launches, K2.fused_attention.launches, K2.attention_bwd.launches), counts))
        out[str(where)] = (metrics["train_loss"].item(), n,
                           {k: p.grad.cpu() for k, p in m.named_parameters()})
    sites = sum(isinstance(mod, GroupNormSiLU) for mod in model.modules())
    (loss_c, n_c, g_c), (loss_d, n_d, g_d) = out["cpu"], out[str(dev)]
    assert n_c == (0, 0, 0) and n_d == (sites, 0, 0)
    assert loss_d == pytest.approx(loss_c, rel=1e-5)
    for k, ref in g_c.items():   # each gradient relative to its largest entry
        assert (g_d[k] - ref).abs().max() <= 1e-3 * max(ref.abs().max(), 1e-12), k


def test_bcsd_day_of_year_sums_bit_equal_on_card(dev):
    """BCSD's day-of-year sums (a one-hot product, no atomics): two calls on
    the card give equal bits, and agree with the CPU's fp32 sums."""
    from probunet_torch.models.baselines import doy_sums

    gen = torch.Generator().manual_seed(4)
    vals = torch.rand(300, 32, 32, 3, generator=gen) * 300
    doy = torch.randint(0, 365, (300,), generator=gen)
    a = doy_sums(vals.to(dev), doy.to(dev))
    b = doy_sums(vals.to(dev), doy.to(dev))
    assert torch.equal(a, b)
    torch.testing.assert_close(a.cpu(), doy_sums(vals, doy), rtol=1e-6, atol=1e-4)


# ---- data parallel on the card ------------------------------------------------------------------

def test_global_draws_are_rows_of_the_global_draw_on_card(dev):
    """A data-parallel rank's dropout mask, label-dropout draw and posterior
    eps are its rows of the draw one process makes for the global batch
    (CUDA Philox, the same generator seed): rank 1 of 2 holds rows 4-7 of
    the 8-row draw, and at world size 1 the draw is the plain one."""
    import types

    from probunet_torch.models.layers import dropout, rand_rows
    from probunet_torch.parallel.mesh import DataParallel

    def gen():
        return torch.Generator(dev).manual_seed(9)

    full = torch.rand(8, 16, 16, 32, generator=gen(), device=dev)
    assert torch.equal(rand_rows((4, 16, 16, 32), gen(), dev, (1, 2)), full[4:])
    assert torch.equal(rand_rows((8, 16, 16, 32), gen(), dev), full)
    x = torch.ones(4, 32, 16, 16, device=dev).to(memory_format=torch.channels_last)
    kept = dropout(x, 0.1, True, gen(), (1, 2)) != 0
    assert torch.equal(kept, (full[4:] < 0.9).permute(0, 3, 1, 2))
    rank1 = types.SimpleNamespace(rank=1, world=2)
    eps = DataParallel.randn(rank1, (4, 6), gen(), dev)
    assert torch.equal(eps, torch.randn(8, 6, generator=gen(), device=dev)[4:])
    crps = DataParallel.randn(rank1, (3, 4, 6), gen(), dev, axis=1)
    assert torch.equal(crps, torch.randn(3, 8, 6, generator=gen(), device=dev)[:, 4:])


def test_flat_gradient_allreduce_on_one_nccl_rank(dev):
    """One NCCL rank in this process: the flat all-reduce (one buffer per
    dtype, channels_last gradients included) and the metric reduction
    return their inputs bit for bit at world size 1; the ordered float64
    all-gather keeps values float32 would round; every rank (the one) holds
    the same parameters."""
    import socket

    import torch.distributed as dist

    from probunet_torch.parallel import mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mesh.init_process_group({"init_method": f"tcp://localhost:{port}", "world_size": 1,
                             "rank": 0}, dev)
    try:
        assert dist.get_backend() == "nccl"
        dp = mesh.DataParallel()
        model = torch.nn.Sequential(torch.nn.Conv2d(8, 16, 3), torch.nn.Linear(5, 7)).to(dev)
        model[0].to(memory_format=torch.channels_last)
        params = list(model.parameters())
        gen = torch.Generator(dev).manual_seed(1)
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, device=dev)
        model[0].weight.grad = model[0].weight.grad.to(memory_format=torch.channels_last)
        extra = torch.nn.Parameter(torch.ones(3, device=dev, dtype=torch.bfloat16))
        extra.grad = torch.randn(3, generator=gen, device=dev).to(torch.bfloat16)
        before = [p.grad.clone() for p in params + [extra]]
        dp.allreduce_grads(params + [extra], mean=True)
        for b, p in zip(before, params + [extra]):
            assert torch.equal(p.grad, b)
        metrics = {"train_loss": torch.tensor(3.5, device=dev), "beta": 1.0,
                   "kl": torch.tensor(0.25, device=dev)}
        out = dp.reduce_metrics(metrics, sums=["kl"], means=["train_loss"])
        assert out["train_loss"].item() == 3.5 and out["kl"].item() == 0.25 and out["beta"] == 1.0
        x = 273.0 + 1e-9 * np.arange(64.0)
        assert np.array_equal(mesh.allgather_f64_rows(x)[0], x)
        dp.check_same_params(model)
    finally:
        dist.destroy_process_group()
