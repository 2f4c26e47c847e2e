"""The port's CUDA kernels against their plain versions on the card, at the
edge shapes chip_smoke.py does not reach: scalar (unvectorized) paths,
unaligned views, single rows, a GroupNorm+SiLU slice streamed through
shared memory, bit-equal reruns (K1, and K2/K3 in bf16 and fp32), the fp32
kernels at every head width and length with dS = 0 on one-hot rows, ragged attention
lengths and L = 4096, the attention forward (K2) and backward (K3) in
every mode on the U-Net block's row-strided views, stride-3 views and
contiguous tensors (and on fp32 operands with fast=True, as the EDM path
runs them), K1 with the residual blocks' embedding terms in its launch (forward,
gradients, launches by modulation over an EDM and a CorrDiff pass), the
baselines' paths
(K1 at the deterministic U-Net's 10 and 14 channels per group, the
deterministic step's launches, BCSD's day-of-year sums bit-equal), the
convolutions' paths (the split kernel bit-equal to tests/_tf32x3.py, the
3xTF32 and IEEE paths at the U-Net's level-0 and level-3 shapes against
float64 beside plain TF32, the paths taken and cuDNN's TF32 flag
restored), ClimaX's attention sites on a Linear's qkv views and its fast step with
the fused AdamW over its whole parameter group, FourCastNet's fast step at its
published widths against the plain reference (its filter counted once a
block), dropout's select in one
launch each way (bit-equal to the plain chain in every layout it meets, the
mask saved as bits, the ClimaX and U-Net steps' launches), and the
wrappers' and kernels' refusals. Marked ``cuda``: they skip without a card. On the card, without JAX (this file imports none):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from probunet_torch.ops import _build
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
    _build.reset_launches()
    with torch.no_grad():
        out, mean, rstd = K1.gn_silu(x, gamma, beta, g, return_stats=True)
        again = K1.gn_silu(x, gamma, beta, g, return_stats=True)
        ref = K1._plain_gn_silu(x, gamma, beta, g)[0]
        rmean, rrstd = group_stats(x, g)
    assert _build.launches("gn_silu") == 2
    # fp32: summation order only; bf16: one rounding of an fp32 result apart
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 2 ** -8)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=1e-5, rtol=1e-5)
    for got, first in zip(again, (out, mean, rstd)):
        assert torch.equal(got, first)


MOD_SHAPES = [(8, 128, 128, 128), (8, 64, 64, 256), (8, 32, 32, 384), (8, 16, 16, 512),
              (2, 448, 448, 128)]


@pytest.mark.parametrize("rows", ["per_sample", "shared"])
@pytest.mark.parametrize("mod", ["scale_shift", "shift_in"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c", MOD_SHAPES)
def test_gn_silu_kernel_modulated_matches_plain(dev, dtype, mod, rows, b, h, w, c):
    """K1 with the residual block's embedding terms in its launch against
    the plain version: (scale, shift) as an ADM block's norm1 takes them
    and shift_in as a DDPM++ block's, per sample (B, C) or one row for all
    (1, C, read with batch stride 0), at EDM's norm1 shapes (b8, 128-512
    channels) and CorrDiff's streamed one (b2, 448x448x128); output and
    statistics (of x + shift_in), two calls bit-equal, each launch counted
    under its modulation."""
    g = num_groups_for(c)
    assert K1.plan(b, h, w, c, g, dtype.itemsize, 132).on_chip == (h != 448)
    gen = torch.Generator(device=dev).manual_seed(c + h)
    x = (torch.randn(b, h, w, c, device=dev, generator=gen) * 2 + 1).to(dtype)
    gamma = torch.randn(c, device=dev, generator=gen)
    beta = torch.randn(c, device=dev, generator=gen)
    n = b if rows == "per_sample" else 1
    s, t = (0.5 * torch.randn(n, c, device=dev, generator=gen) for _ in range(2))
    kw = {"scale": s, "shift": t} if mod == "scale_shift" else {"shift_in": t}
    _build.reset_launches()
    with torch.no_grad():
        out, mean, rstd = K1.gn_silu(x, gamma, beta, g, 1e-5, True, **kw)
        again = K1.gn_silu(x, gamma, beta, g, 1e-5, True, **kw)
        ref, rmean, rrstd = K1._plain_gn_silu(x, gamma, beta, g, 1e-5, **kw)
    assert _build.launches("gn_silu") == _build.launches("gn_silu", mod) == 2
    # fp32: the constants folded in another order; bf16: the same fp32
    # results rounded once each, so at most one bf16 ulp apart (2^-7 of the
    # value: the modulated outputs reach past 4, where 2^-8 is under an ulp)
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 2 ** -7)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=1e-5, rtol=1e-5)
    for got, first in zip(again, (out, mean, rstd)):
        assert torch.equal(got, first)


@pytest.mark.parametrize("mod", ["scale_shift", "shift_in"])
def test_gn_silu_modulated_gradients_on_card(dev, mod):
    """The modulated forward launches K1 once and its plain backward gives
    the gradients of x, the affine parameters and each operand that the
    CPU gives, per sample and shared rows."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 8, 64, generator=gen) + 0.5
    gamma, beta = 1 + 0.1 * torch.randn(64, generator=gen), 0.1 * torch.randn(64, generator=gen)
    for n in (2, 1):
        ops = [0.5 * torch.randn(n, 64, generator=gen) for _ in range(2 if mod == "scale_shift"
                                                                         else 1)]
        grads = {}
        for where in ("cpu", dev):
            leaves = [t.detach().to(where).requires_grad_() for t in (x, gamma, beta, *ops)]
            kw = (dict(zip(("scale", "shift"), leaves[3:])) if mod == "scale_shift"
                  else {"shift_in": leaves[3]})
            _build.reset_launches()
            out = K1.gn_silu(*leaves[:3], 16, **kw)
            (out * torch.linspace(-1, 1, out.numel(), device=where).view(out.shape)).sum() \
                .backward()
            assert _build.launches("gn_silu") == (where != "cpu")
            grads[str(where)] = [t.grad.cpu() for t in leaves]
        for got, want in zip(grads[str(dev)], grads["cpu"]):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_k1_launches_by_mod_over_an_edm_and_a_corrdiff_pass(dev):
    """One EDM denoiser pass at the cell's widths (128x128, 8 rows): 28 K1
    launches with per-sample (scale, shift), the blocks' norm1, and 29
    unmodulated (norm0, out_norm); one CorrDiff residual denoiser pass
    (448x448, 2 rows): 55 with the shift added before the norm and 56
    unmodulated."""
    from probunet_torch.config import Config
    from probunet_torch.train.loop import build_corrdiff_model, build_edm_model

    cases = [
        (build_edm_model(Config(ds_model="edm", resolution=(128, 128)), device="meta"),
         (8, 128, 128, 3), {"none": 29, "scale_shift": 28}),
        (build_corrdiff_model(Config(ds_model="corrdiff", resolution=(448, 448),
                                     model_channels=128, channel_mult=(1, 2, 2, 2, 2),
                                     num_blocks=4, attn_resolutions=(28,)), device="meta"),
         (2, 448, 448, 3), {"none": 56, "shift_in": 55}),
    ]
    for model, shape, want in cases:
        model = model.to_empty(device=dev).eval()
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(max(1, p[0].numel())))
        x, cond = (torch.randn(shape, device=dev) for _ in range(2))
        sigma = torch.full((shape[0],), 1.3, device=dev)
        _build.reset_launches()
        with torch.inference_mode():
            out = model(x, sigma, condition_img=cond)
        torch.cuda.synchronize()
        assert {m: _build.launches("gn_silu", m) for m in K1.MODS} == {
            m: want.get(m, 0) for m in K1.MODS}
        assert torch.isfinite(out).all()
        del model, out


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
    _build.reset_launches()
    xg = x.clone().requires_grad_()
    K1.gn_silu(xg, w, w, 2).sum().backward()
    assert (_build.launches("gn_silu"), _build.launches("gn_silu_bwd")) == (1, 1)
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
    _build.reset_launches()
    hi_got, got = C.split(x, order, dim)
    torch.cuda.synchronize()
    assert _build.launches("conv2d", "split") == 1
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

    def delta():
        """The conv2d paths counted since the last call, then reset."""
        out = {k: _build.launches("conv2d", k) for k in C.PATHS if _build.launches("conv2d", k)}
        _build.reset_launches()
        return out

    x = torch.randn(2, 8, 16, 16, device=dev).contiguous(memory_format=torch.channels_last)
    w = torch.randn(4, 8, 3, 3, device=dev)
    b = torch.randn(4, device=dev)
    saved = torch.backends.cudnn.allow_tf32
    try:
        with full_fp32():
            _build.reset_launches()
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            C.conv2d(xg, wg, b, 1).square().sum().backward()
            assert torch.backends.cudnn.allow_tf32 is False
            assert delta() == {"ieee_fwd": 1, "tf32x3_dgrad": 1, "ieee_wgrad": 1, "split": 2}
            with torch.no_grad():
                C.conv2d(x, w, b, 1)
            assert delta() == {"tf32x3_fwd": 1, "split": 2}
            C.conv2d(x.bfloat16(), w.bfloat16(), b.bfloat16(), 1)
            assert delta() == {"plain": 1}
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
    _build.reset_launches()
    with torch.no_grad():
        out = K2.fused_attention(q, k, v, fast)
        ref = K2._plain_attention(q, k, v, fast)
    assert _build.launches("attention_fwd") == 1
    assert out.shape == (b, L, nh, 64) and out.dtype == dtype and out.is_contiguous()
    # fp32: 3xTF32 against fp32 einsums; bf16: the plain version rounds the
    # logits to bf16, the kernel keeps them fp32
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_attention_kernel_refusals(dev):
    q = torch.randn(1, 8, 2, 64, device=dev)
    with pytest.raises(TypeError):
        K2.fused_attention(q.half(), q.half(), q.half())
    wide = torch.randn(1, 8, 2, 264, device=dev)  # past the widest head the kernels hold
    with pytest.raises(ValueError, match=r"\(1, 8, 2, 264\)"):
        K2.fused_attention(wide, wide, wide)
    wide = wide[..., :136].to(torch.bfloat16)  # past the bf16 kernels' widest
    with pytest.raises(ValueError, match=r"\(1, 8, 2, 136\)"):
        K2.fused_attention(wide, wide, wide, True)
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
    _build.reset_launches()
    for bad in ((q, c, c), (c, k, c), (c, c, v), (odd, c, c)):
        with pytest.raises(ValueError, match="unit-stride"):
            K2._launch(*bad, with_lse=True)
    out, lse = K2._launch(c, c, c, with_lse=True)
    for bad in ((q, c, c, out, c), (c, c, c, out, v), (c, c, c, out, odd)):
        with pytest.raises(ValueError, match="unit-stride"):
            K2._launch_bwd(*bad[:4], lse, bad[4], False)
    assert (_build.launches("attention_fwd"), _build.launches("attention_bwd")) == (1, 0)
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
    _build.reset_launches()
    K2.fused_attention(q, k, v, fast).backward(do)
    assert (_build.launches("attention_fwd"), _build.launches("attention_bwd")) == (1, 1)
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
    _build.reset_launches()
    out = K2.fused_attention(q, k, v, fast)
    out.backward(do)
    assert (_build.launches("attention_fwd"), _build.launches("attention_bwd")) == (1, 1)
    assert _build.launches("kernel_layout") == _head_dim_copies(layout, c)
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


@pytest.mark.parametrize("mode", list(ATTN_MODES))
def test_attention_on_climax_linear_qkv_views(dev, mode):
    """K2 and K3 at ClimaX's sites, (B, 2048, 16, 64), on the q/k/v views of
    a Linear's (B, L, 3 D) output laid out (3, heads, 64), through autograd,
    against the plain versions at the tolerances of
    test_attention_head_dims_match_plain: one launch of each and no
    ``kernel_layout`` copy (the views are read in place). B = 2 keeps the
    plain versions' (B heads, L, L) fp32 weights small."""
    dtype, fast = ATTN_MODES[mode]
    b, L, nh, c = 2, 2048, 16, 64
    gen = torch.Generator(device=dev).manual_seed(2048)
    x = torch.randn(b, L, nh * c, device=dev, generator=gen).to(dtype)
    w = (torch.randn(3 * nh * c, nh * c, device=dev, generator=gen) / 32).to(dtype)
    bias = (0.1 * torch.randn(3 * nh * c, device=dev, generator=gen)).to(dtype)
    qkv = torch.nn.functional.linear(x, w, bias).requires_grad_()
    q, k, v = qkv.view(b, L, 3, nh, c).unbind(2)
    do = torch.randn(b, L, nh, c, device=dev, generator=gen).to(dtype)
    _build.reset_launches()
    out = K2.fused_attention(q, k, v, fast)
    out.backward(do)
    assert (_build.launches("attention_fwd"), _build.launches("attention_bwd")) == (1, 1)
    assert _build.launches("kernel_layout") == 0
    with torch.no_grad():
        ref = K2._plain_attention(q, k, v, fast)
        ref_b = K2._plain_attention_bwd(q.detach(), k.detach(), v.detach(), do, fast)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.detach().float(), ref.float(), atol=tol, rtol=tol)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    grads = qkv.grad.view(b, L, 3, nh, c).unbind(2)
    for got, r in zip(grads, ref_b):
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
        _build.reset_launches()
        own = K2._launch(q, k, v, with_lse=True)
        assert _build.launches("attention_fwd") == _build.launches("attention_fwd", "bf16", kd) == 1
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
    _build.reset_launches()
    out = K2.fused_attention(q, k, v)
    out.backward(do)
    assert (_build.launches("attention_fwd"), _build.launches("attention_bwd")) == (1, 1)
    assert _build.launches("kernel_layout") == _head_dim_copies(layout, c)
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


# ---- the fp32 forward at kD = 256 (CorrDiff's one 256-wide head) --------------------------

# CorrDiff's site (B = 2, one head, L = 784 at 28x28, c = 256), then one row,
# a ragged 32-row tile, two heads, a narrower head zero-padded to kD = 256
# and L = 2048
KD256_CASES = [(2, 784, 1, 256), (1, 1, 1, 256), (1, 65, 2, 256), (2, 100, 1, 200),
               (1, 2048, 1, 256)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("b,L,nh,c", KD256_CASES)
def test_attention_fp32_kd256_matches_plain(dev, layout, b, L, nh, c):
    """K2 in fp32 at kD = 256 (K and V streamed 64 head columns at a time,
    128 output columns a block) against the plain fp32 version: O within
    2e-5 and the row lse within 2e-5, the strict limit at kD = 64 and 128;
    one launch, counted under ``fp32_kd256``; results of c columns."""
    gen = torch.Generator(device=dev).manual_seed(L + c)
    (q, k, v), _ = _qkv(layout, b, L, nh, torch.float32, dev, gen, c=c)
    _build.reset_launches()
    with torch.no_grad():
        out = K2.fused_attention(q, k, v)
        ref = K2._plain_attention(q, k, v, False)
        _, lse = K2._launch(*map(K2.kernel_layout, (q, k, v)), with_lse=True, c=c)
        logits = torch.einsum("bqhc,bkhc->bhqk", q, k) / math.sqrt(c)
    assert _build.launches("attention_fwd") == _build.launches("attention_fwd", "fp32", 256) == 2
    assert out.shape == (b, L, nh, c) and out.dtype == torch.float32 and out.is_contiguous()
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1).reshape(b * nh, L),
                               atol=2e-5, rtol=2e-5)


def test_attention_fp32_kd256_reruns_bit_equal(dev):
    """A second call at CorrDiff's site gives the same bits (no atomics;
    the two column halves' blocks compute S alike)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    (q, k, v), _ = _qkv("block", 2, 784, 1, torch.float32, dev, gen, c=256)
    with torch.no_grad():
        first, second = (K2._launch(q, k, v, with_lse=True) for _ in range(2))
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


def test_attention_kd256_backward_raises(dev):
    """The forward runs at c = 256 under autograd; its backward raises,
    naming the missing K3 build, before any launch, and so does a direct
    call of attention_bwd: there is no kD = 256 backward and no fallback."""
    gen = torch.Generator(device=dev).manual_seed(3)
    (q, k, v), _ = _qkv("contiguous", 2, 64, 1, torch.float32, dev, gen, grad=True, c=256)
    out = K2.fused_attention(q, k, v)
    _build.reset_launches()
    with pytest.raises(NotImplementedError, match="up to 128"):
        out.backward(torch.ones_like(out))
    with torch.no_grad():
        o, lse = K2._launch(q.detach(), k.detach(), v.detach(), with_lse=True)
        with pytest.raises(NotImplementedError, match="kD = 256"):
            K2.attention_bwd(q.detach(), k.detach(), v.detach(), o, lse, torch.ones_like(o))
    assert _build.launches("attention_bwd") == 0


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
    _build.reset_launches()
    net(x).float().square().sum().backward()
    assert _build.launches("attention_fwd") > 0 and _build.launches("attention_bwd") > 0
    assert _build.launches("kernel_layout") == 0


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
    block's norm0 and norm1 twice (+ out_norm once), K2 twice per attention
    block, K3 once; no tensor copied before an attention launch; loss and
    gradients those of the step without remat (deterministic cuDNN)."""
    from probunet_torch.models.unet import UNetBlock

    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for remat in (False, True):
            state, step, hr, stats = _tiny_train_state(dev, remat=remat)
            blocks = [m for m in state.model.unet.modules() if isinstance(m, UNetBlock)]
            attn = sum(1 for m in blocks if m.heads)
            _build.reset_launches()
            m = step(state, hr, stats, torch.tensor([0, 3], device=dev), 5)
            torch.cuda.synchronize()
            n = tuple(_build.launches(k) for k in ("gn_silu", "attention_fwd", "attention_bwd",
                                                   "kernel_layout"))
            k = 2 if remat else 1
            assert n == (2 * k * len(blocks) + 1, k * attn, attn, 0), (remat, n)
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
    and bits, and one more step on each state gives equal parameters. The
    bf16 state's five updates are each one fused launch, the restored
    state's too."""
    from probunet_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    torch.backends.cudnn.deterministic = True
    _build.reset_launches()
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
        fused = 5 if opt_kw.get("state_dtype") == "bfloat16" else 0
        assert _build.launches("adamw_bf16", "fused") == fused
        assert _build.launches("adamw_bf16", "foreach") == 0
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
        _build.reset_launches()
        metrics = step(state, h, (h.mean(0), h.std(0)), torch.tensor([0, 4], device=where),
                       ts[[0, 4]].to(where), 3)
        n = tuple(_build.launches(k) for k in ("gn_silu", "attention_fwd", "attention_bwd"))
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


# the last two channels_last, as the models' convolution weights (not
# default-contiguous at 3x3)
ADAMW_SHAPES = [(1,), (3,), (4097,), (2 ** 22 + 3,), (), (6, 5, 3, 3), (7, 9, 1, 1)]


@pytest.mark.parametrize("case", ["ragged", "new_grad", "unaligned", "strided_grad"])
def test_adamw_bf16_fused_update_bit_equal_to_foreach(dev, case):
    """AdamWBf16State on the card against the plain multi-tensor update
    (``adamw_bf16._plain_update``, the foreach ops on the card) on the same
    gradients, 5 steps (the bias corrections at count 1-5), tensors of
    ragged lengths (1, 3, 4k + 1, past 2^22, 0-dim) and two channels_last
    convolution weights: p, mu and nu bit-equal after every step, one
    fused launch a step.
    new_grad: one gradient becomes a new tensor before step 3, and the bits
    stay equal. unaligned: parameters and gradients are views 4 bytes past
    16-byte alignment (the kernel's one-element path). strided_grad: one
    gradient is a transposed view, which the kernel does not take: the step
    raises a ValueError that names that parameter, and updates nothing."""
    from probunet_torch.ops import adamw_bf16 as A
    from probunet_torch.train.state import AdamWBf16State

    shapes = ADAMW_SHAPES + ([(6, 7)] if case == "strided_grad" else [])
    gen = torch.Generator(device=dev).manual_seed(11)

    def make(shape):
        n = math.prod(shape)
        if case == "unaligned":
            flat = torch.randn(n + 1, device=dev, generator=gen)
            return flat[1:].view(shape)   # one fp32 past the allocation's alignment
        x = torch.randn(shape, device=dev, generator=gen)
        return x.contiguous(memory_format=torch.channels_last) if x.dim() == 4 else x

    params = [torch.nn.Parameter(make(s)) for s in shapes]
    grads = [make(s) for s in shapes]
    if case == "strided_grad":
        grads[-1] = torch.randn(7, 6, device=dev, generator=gen).t()
    ref = [p.detach().clone() for p in params]
    start = [p.detach().clone() for p in params]
    ref_states = [{"mu": torch.zeros_like(p, dtype=torch.bfloat16),
                   "nu": torch.zeros_like(p, dtype=torch.float32)} for p in ref]
    opt = AdamWBf16State(params, lr=1e-2, weight_decay=0.05)
    _build.reset_launches()
    if case == "strided_grad":
        for p, g in zip(params, grads):
            p.grad = g
        with pytest.raises(ValueError, match=f"parameter {len(shapes) - 1} of the group has p "
                                             f"\\(6, 7\\).* grad \\(6, 7\\) .* strides \\(1, 6\\)"):
            opt.step()
        assert all(torch.equal(p.detach(), p0) for p, p0 in zip(params, start))
        assert opt.param_groups[0]["count"] == 0
        assert _build.launches("adamw_bf16") == 0
        return
    for step in range(1, 6):
        for g in grads:
            g.copy_(torch.randn(g.shape, device=dev, generator=gen) * 10 ** (step - 3))
        if case == "new_grad" and step == 3:
            grads[2] = grads[2].clone()   # made while the old one lives: another address
        for p, r, g in zip(params, ref, grads):
            p.grad = g
            r.grad = g
        opt.step()
        b1, b2 = 0.9, 0.999
        A._plain_update(ref, ref_states, b1, b2, 1 - b1 ** step, 1 - b2 ** step, 1e-8, 0.05, 1e-2)
        torch.cuda.synchronize()
        for p, r, st, rst in zip(params, ref, [opt.state[p] for p in params], ref_states):
            assert torch.equal(p.detach(), r), (case, step, p.shape)
            assert torch.equal(st["mu"], rst["mu"]) and torch.equal(st["nu"], rst["nu"])
            assert st["mu"].dtype == torch.bfloat16 and st["nu"].dtype == torch.float32
        assert _build.launches("adamw_bf16", "fused") == step
        assert _build.launches("adamw_bf16", "foreach") == 0
    assert opt.param_groups[0]["count"] == 5
    assert not any(torch.equal(p.detach(), p0) for p, p0 in zip(params, start))


def test_climax_fast_step_and_fused_adamw_on_card(dev):
    """ClimaX at its published widths (128x256, D 1,024, depth 8, 16 heads;
    109,274,160 parameters) through the fast deterministic step at b2: 8 K2
    and 8 K3 launches, no ``kernel_layout`` copy, one fused AdamW launch for
    the whole group (2-D Linear weights, (1, L, D) embeddings, 1-D
    LayerNorm vectors, (D, 1, 4, 4) tokenizer weights: no ValueError). Then
    one more update on the step's own gradients, bit-equal to the foreach
    path (``adamw_bf16._plain_update``) on copies of the parameters and
    moments, as test_adamw_bf16_fused_update_bit_equal_to_foreach checks for
    the U-Net's."""
    from perfbench.reference.unet import perpixel_stats
    from probunet_torch.config import Config
    from probunet_torch.ops import adamw_bf16 as A
    from probunet_torch.train.loop import build_climax_model
    from probunet_torch.train.state import create_train_state, make_optimizer
    from probunet_torch.train.steps import make_deterministic_train_step

    cfg = Config(ds_model="climax", resolution=(128, 256), compute_dtype="bfloat16",
                 fast_attention=True, opt_state_dtype="bfloat16", lr=5e-4, weight_decay=1e-5)
    model = build_climax_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == 109_274_160
    state = create_train_state(model, make_optimizer(cfg.lr, cfg.weight_decay, 1, "adamw", None,
                                                     cfg.opt_state_dtype))
    step = make_deterministic_train_step(model, 4, "perpixel", torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(5)
    hr = 270.0 + 5.0 * torch.randn(6, 128, 256, 3, device=dev, generator=gen)
    stats = perpixel_stats(hr, 4)
    idx = torch.tensor([0, 3], device=dev)
    _build.reset_launches()
    m = step(state, hr, stats, idx, torch.zeros(2, device=dev), gen)
    assert math.isfinite(float(m["train_loss"]))
    assert _build.launches("attention_fwd", "bf16", 64) == 8
    assert _build.launches("attention_bwd", "bf16", 64) == 8
    assert _build.launches("kernel_layout") == 0
    assert _build.launches("adamw_bf16", "fused") == 1
    assert _build.launches("adamw_bf16", "foreach") == 0
    opt = state.optimizer.inner
    params = [p for p in model.parameters()]
    assert all(p.grad is not None for p in params)
    ref = [p.detach().clone() for p in params]
    ref_states = [{"mu": opt.state[p]["mu"].clone(), "nu": opt.state[p]["nu"].clone()}
                  for p in params]
    for p, r in zip(params, ref):
        r.grad = p.grad
    opt.step()
    b1, b2 = opt.param_groups[0]["betas"]
    A._plain_update(ref, ref_states, b1, b2, 1 - b1 ** 2, 1 - b2 ** 2, 1e-8, 1e-5, 5e-4)
    torch.cuda.synchronize()
    for p, r, rst in zip(params, ref, ref_states):
        assert torch.equal(p.detach(), r), p.shape
        assert torch.equal(opt.state[p]["mu"], rst["mu"])
        assert torch.equal(opt.state[p]["nu"], rst["nu"])
    assert _build.launches("adamw_bf16", "fused") == 2


def test_fourcastnet_fast_step_against_the_reference_on_card(dev):
    """FourCastNet at its published widths (720x1440, patch 8, D 768, depth
    12, 8 filter blocks of 96; 73,019,136 parameters) through the fast
    deterministic step at b1: the filter's ``probunet.spectral`` span once
    a block (12 a forward), one fused AdamW launch for the whole group (the filters' 4-D
    and 3-D fp32 leaves among them); the first loss and every leaf's
    gradient against the fp32 reference on the same weights (AFNONet's
    init) and day, within tests/test_torch_fourcastnet.py's bf16 limits:
    loss 4e-3, leaves 0.06 by the benchmark's rule, the filters' leaves
    0.15 each against its own norm."""
    import statistics

    from perfbench.families.fourcastnet import published_weights
    from perfbench.reference import fourcastnet as ref
    from perfbench.reference.unet import fp32_math, make_pair, perpixel_stats
    from probunet_torch.config import Config
    from probunet_torch.train.loop import build_fourcastnet_model
    from probunet_torch.train.state import create_train_state, make_optimizer
    from probunet_torch.train.steps import make_deterministic_train_step

    cfg = Config(ds_model="fourcastnet", resolution=(720, 1440), patch_size=8, embed_dim=768,
                 depth=12, dropout=0.0, drop_path=0.0, compute_dtype="bfloat16",
                 opt_state_dtype="bfloat16", lr=5e-4, weight_decay=0.0)
    rcfg = {"resolution": [720, 1440], "embed_dim": 768, "patch_size": 8,
            "variables": ["pr", "tasmin", "tasmax"], "depth": 12, "mlp_ratio": 4.0,
            "num_blocks": 8, "sparsity_threshold": 0.01, "hard_thresholding_fraction": 1.0,
            "drop_path": 0.0, "dropout": 0.0}
    model = build_fourcastnet_model(cfg, device="meta").to_empty(device=dev)
    weights = published_weights(model, rcfg, 11, dev)
    model.load_state_dict(weights)
    assert sum(p.numel() for p in model.parameters()) == 73_019_136
    state = create_train_state(model, make_optimizer(cfg.lr, cfg.weight_decay, 1, "adamw", None,
                                                     cfg.opt_state_dtype))
    step = make_deterministic_train_step(model, 4, "perpixel", torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(5)
    hr = 270.0 + 5.0 * torch.randn(3, 720, 1440, 3, device=dev, generator=gen)
    stats = perpixel_stats(hr, 4)
    idx = torch.tensor([1], device=dev)
    _build.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m = step(state, hr, stats, idx, torch.zeros(1, device=dev), gen)
    assert [e.name for e in prof.events()].count("probunet.spectral") == 12
    assert _build.launches("adamw_bf16", "fused") == 1
    assert _build.launches("adamw_bf16", "foreach") == 0
    got = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    loss = float(m["train_loss"])
    del state, step, model
    torch.cuda.empty_cache()
    with torch.device("meta"):
        r = ref.FourCastNet(rcfg)
    r = r.to_empty(device=dev)
    r.load_state_dict(weights)
    r.train()
    with fp32_math():
        pair = make_pair(hr[idx], 4, stats)
        want = (r(pair["inputs"]) - pair["targets"]).square().mean()
        want.backward()
    assert abs(loss - want.item()) / want.item() <= 4e-3
    norms = {n: float(p.grad.norm()) for n, p in r.named_parameters()}
    med = statistics.median(norms.values())
    gaps = {n: float((got[n] - p.grad).norm()) for n, p in r.named_parameters()}
    assert max(gaps[n] / max(norms[n], med) for n in norms) <= 0.06, gaps
    assert max(gaps[n] / norms[n] for n in norms if ".filter." in n) <= 0.15, gaps


# ---- dropout's compare, scale and select (csrc/dropout.cu) --------------------------------


def _same_bits(a, b):
    """Equal shapes and equal bits, +0 against -0 and NaN payloads included."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def _dropout_case(case, dtype, dev, gen):
    """(x, u, dy) of a case: x and dy in x's layout, u as the layers draw it."""
    from probunet_torch.models.layers import nchw, rand_rows

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    cl = torch.channels_last
    if case == "ragged":           # 1,443 elements: neither a multiple of 8 nor of 32
        x = randn(3, 37, 13)
        return x, torch.rand(x.shape, device=dev, generator=gen), randn(3, 37, 13)
    if case == "tokens":
        x = randn(2, 256, 1024)
        return x, rand_rows(x.shape, gen, dev), randn(2, 256, 1024)
    if case in ("channels_last", "rank_slice", "spatial_rows"):
        x = randn(2, 24, 9, 11).contiguous(memory_format=cl)
        shard, rows = {"channels_last": ((0, 1), (0, 1)), "rank_slice": ((1, 2), (0, 1)),
                       "spatial_rows": ((0, 1), (1, 3))}[case]
        u = nchw(rand_rows((2, 9, 11, 24), gen, dev, shard, rows))
        return x, u, randn(2, 24, 9, 11).contiguous(memory_format=cl)
    if case == "unaligned":        # x, u and dy one element past 16-byte alignment
        x = randn(2 * 9 * 61 + 1)[1:].view(2, 9, 61)
        u = torch.rand(2 * 9 * 61 + 1, device=dev, generator=gen)[1:].view(2, 9, 61)
        return x, u, randn(2 * 9 * 61 + 1)[1:].view(2, 9, 61)
    if case == "row_ragged":       # 481 elements a row
        return randn(4, 37, 13), rand_rows((4, 1), gen, dev), randn(4, 37, 13)
    if case == "row_tokens":
        return randn(8, 64, 128), rand_rows((8, 1), gen, dev, (1, 2)), randn(8, 64, 128)
    if case == "row_unaligned":
        x = randn(4 * 40 + 1)[1:].view(4, 40)
        return x, rand_rows((4, 1), gen, dev), randn(4 * 40 + 1)[1:].view(4, 40)
    raise ValueError(case)


DROPOUT_CASES = ["ragged", "tokens", "channels_last", "rank_slice", "spatial_rows", "unaligned",
                 "row_ragged", "row_tokens", "row_unaligned"]


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("case", DROPOUT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_bit_equal_to_the_plain_chain(dev, dtype, case, rate):
    """The kernel's output and input gradient against the plain chain
    ``where(u < keep, x / keep, 0)`` and its autograd backward on the card,
    bit for bit: element mode (u of x's shape) at 1,443 elements, on
    (B, L, D) tokens, on an NCHW channels_last map against the NCHW view of
    its NHWC draw, against a rank's rows of the global draw, past 16-byte
    alignment (the one-element path), and against a spatial rank's H rows
    (not dense: copied once, counted); row mode (u (B, 1)) at 481 elements
    a row, on tokens with a rank's rows, unaligned. One launch each way, y
    and dx in x's layout, no gradient copied."""
    from probunet_torch.ops import dropout as D

    gen = torch.Generator(device=dev).manual_seed(DROPOUT_CASES.index(case))
    x0, u, dy = _dropout_case(case, dtype, dev, gen)
    keep = 1.0 - rate
    if case.startswith("row"):   # a sample dropped and one kept, whatever the draw
        u[0], u[-1] = 0.995, 0.005
    ref_x = x0.clone().requires_grad_()
    ref = D.plain(ref_x, u, keep)
    ref.backward(dy)
    x = x0.detach().clone().requires_grad_()
    _build.reset_launches()
    y = D.apply(x, u, keep)
    y.backward(dy)
    torch.cuda.synchronize()
    mode = "row" if case.startswith("row") else "element"
    assert _build.launches("dropout", "fwd", mode) == _build.launches("dropout", "bwd", mode) == 1
    assert _build.launches("dropout", "u_copy") == (case == "spatial_rows")
    assert _build.launches("dropout", "dy_copy") == 0
    assert _build.launches("dropout") == 2 + (case == "spatial_rows")
    assert _same_bits(y.detach(), ref.detach()) and y.stride() == x.stride()
    assert _same_bits(x.grad, ref_x.grad)
    assert (y == 0).any() and (y != 0).any()


def test_dropout_kernel_nan_inf_reruns_and_saved_bits(dev):
    """NaN and inf at dropped elements give +0 forward and backward; kept
    ones scale as the plain chain does; two calls are bit-equal; the saved
    mask is ceil(n / 32) int32 words, bit i of the little-endian words the
    element i of x's memory order kept, the bits past n zero; a gradient in
    another layout is copied once (counted) and still bit-equal; row mode
    saves the (B, 1) uniforms alone."""
    from probunet_torch.ops import dropout as D

    gen = torch.Generator(device=dev).manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        n = 8 * 1000 + 5
        x = torch.randn(n, device=dev, generator=gen).to(dtype)
        u = torch.rand(n, device=dev, generator=gen)
        special = torch.tensor([float("nan"), float("inf"), -float("inf")], device=dev)
        x[:3000] = special.repeat(1000).to(dtype)
        dy = torch.randn(n, device=dev, generator=gen).to(dtype)
        dy[:3000] = special.repeat(1000).to(dtype)
        outs = []
        for _ in range(2):
            xi = x.clone().requires_grad_()
            y = D.apply(xi, u, 0.9)
            (bits,) = y.grad_fn.saved_tensors
            y.backward(dy)
            outs.append((y.detach(), xi.grad, bits))
        (y, g, bits), (y2, g2, bits2) = outs
        assert _same_bits(y, y2) and _same_bits(g, g2) and torch.equal(bits, bits2)
        ref_x = x.clone().requires_grad_()
        ref = D.plain(ref_x, u, 0.9)
        ref.backward(dy)
        assert _same_bits(y, ref.detach()) and _same_bits(g, ref_x.grad)
        dropped = u >= np.float32(0.9)
        assert dropped[:3000].any()
        for t in (y, g):
            assert (t[dropped].view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
                    == 0).all()
        assert bits.dtype == torch.int32 and bits.numel() * 4 == -(-n // 32) * 4
        flags = np.unpackbits(bits.cpu().numpy().view(np.uint8), bitorder="little")
        assert np.array_equal(flags[:n], (~dropped).cpu().numpy()) and not flags[n:].any()
    # a gradient of another layout than x's
    x = torch.randn(2, 16, 5, 7, device=dev).contiguous(memory_format=torch.channels_last)
    u = torch.rand(2, 5, 7, 16, device=dev).permute(0, 3, 1, 2)
    dy = torch.randn(2, 16, 5, 7, device=dev)
    xi, ref_x = x.clone().requires_grad_(), x.clone().requires_grad_()
    _build.reset_launches()
    D.apply(xi, u, 0.9).backward(dy)
    D.plain(ref_x, u, 0.9).backward(dy)
    assert _build.launches("dropout", "dy_copy") == 1 and _same_bits(xi.grad, ref_x.grad)
    assert xi.grad.stride() == x.stride()
    # row mode keeps the uniforms alone
    x = torch.randn(4, 64, 32, device=dev).requires_grad_()
    u = torch.rand(4, 1, device=dev)
    y = D.apply(x, u, 0.9)
    (saved,) = y.grad_fn.saved_tensors
    assert saved.shape == (4, 1) and saved.dtype == torch.float32


def test_dropout_kernel_refusals(dev):
    """On the card the kernel or a ValueError that names each tensor's shape,
    dtype, strides and device: x in fp16, u in bf16, u on the CPU, u of
    another shape, x neither contiguous nor channels_last (strided, or its
    samples not outermost in row mode).
    Nothing launched."""
    from probunet_torch.ops import dropout as D

    _build.reset_launches()
    x = torch.randn(4, 6, 8, device=dev)
    u = torch.rand(4, 6, 8, device=dev)
    cases = [(x.half(), u, "a dtype"), (x, u.bfloat16(), "a dtype"), (x, u.cpu(), "one card"),
             (x, u[:, :3], "neither x's nor"), (x[:, ::2], u[:, ::2], "not dense"),
             (x.transpose(0, 1).contiguous().transpose(0, 1), u[:, :1, 0], "not dense")]
    for xi, ui, what in cases:
        with pytest.raises(ValueError, match=rf"{what}.*x \({xi.shape[0]}, .*\) torch\.\w+ "
                                             rf"strides .* on cuda:\d, u .* strides .* on "):
            D.apply(xi, ui, 0.9)
    assert _build.launches("dropout") == 0


def test_climax_step_dropout_in_kernel_launches_bit_equal_to_the_plain_chain(dev, monkeypatch):
    """ClimaX at its published widths through the fast deterministic step
    at b2 (as test_climax_fast_step_and_fused_adamw_on_card): 25 element
    launches (pos_drop; each block's attention output, MLP hidden and MLP
    output) and 14 row launches (blocks 1-7, two drop_path each) in each
    direction, no uniform or gradient copied; the loss, every gradient and
    every updated parameter bit-equal to the same step with the plain chain
    (``ops/dropout.plain``) on the same seed."""
    from perfbench.reference.unet import perpixel_stats
    from probunet_torch.config import Config
    from probunet_torch.ops import dropout as D
    from probunet_torch.train.loop import build_climax_model
    from probunet_torch.train.state import create_train_state, make_optimizer
    from probunet_torch.train.steps import make_deterministic_train_step

    cfg = Config(ds_model="climax", resolution=(128, 256), compute_dtype="bfloat16",
                 fast_attention=True, opt_state_dtype="bfloat16", lr=5e-4, weight_decay=1e-5)

    def run():
        model = build_climax_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, make_optimizer(cfg.lr, cfg.weight_decay, 1, "adamw",
                                                         None, cfg.opt_state_dtype))
        step = make_deterministic_train_step(model, 4, "perpixel", torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(5)
        hr = 270.0 + 5.0 * torch.randn(6, 128, 256, 3, device=dev, generator=gen)
        _build.reset_launches()
        m = step(state, hr, perpixel_stats(hr, 4), torch.tensor([0, 3], device=dev),
                 torch.zeros(2, device=dev), gen)
        torch.cuda.synchronize()
        counts = {key: _build.launches("dropout", *key) for key in
                  [("fwd", "element"), ("bwd", "element"), ("fwd", "row"), ("bwd", "row"),
                   ("u_copy",), ("dy_copy",)]}
        return (m["train_loss"].float().cpu(),
                [(p.detach().clone(), p.grad.clone()) for p in model.parameters()], counts)

    loss, params, counts = run()
    assert counts == {("fwd", "element"): 25, ("bwd", "element"): 25, ("fwd", "row"): 14,
                      ("bwd", "row"): 14, ("u_copy",): 0, ("dy_copy",): 0}
    monkeypatch.setattr(D, "apply", D.plain)
    loss0, params0, counts0 = run()
    assert all(n == 0 for n in counts0.values())
    assert torch.equal(loss, loss0)
    for (p, g), (p0, g0) in zip(params, params0):
        assert _same_bits(g, g0) and _same_bits(p, p0), p.shape


def test_unet_step_one_dropout_launch_each_way_a_residual_block(dev):
    """One prob-U-Net training step at the mc128 widths (b2, 128x128, dropout
    0.1): one element launch each way per residual block (its dropout after
    norm1), no row launch, no uniform or gradient copied."""
    from probunet_torch.config import Config
    from probunet_torch.models.unet import UNetBlock
    from probunet_torch.train.loop import build_probunet
    from probunet_torch.train.state import create_train_state, make_optimizer
    from probunet_torch.train.steps import make_probunet_train_step

    cfg = Config(coords=(0, 128, 0, 128), resolution=(128, 128))
    model = build_probunet(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    blocks = sum(isinstance(m, UNetBlock) for m in model.modules())
    assert blocks == 28
    state = create_train_state(model, make_optimizer())
    step = make_probunet_train_step(model, 4, "perpixel")
    hr = torch.rand(4, 128, 128, 3, device=dev) + 1
    _build.reset_launches()
    m = step(state, hr, (hr.mean(0), hr.std(0)), torch.tensor([0, 3], device=dev), 5)
    torch.cuda.synchronize()
    assert math.isfinite(float(m["train_loss"]))
    assert _build.launches("dropout", "fwd", "element") == blocks
    assert _build.launches("dropout", "bwd", "element") == blocks
    assert _build.launches("dropout", "row") == 0
    assert _build.launches("dropout", "u_copy") == _build.launches("dropout", "dy_copy") == 0
