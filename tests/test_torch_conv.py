"""The port's convolutions (probunet_torch/ops/conv.py) on the CPU: the
3xTF32 compositions that strict (fp32) convolutions run on the card (a
sampler's forward, a training step's input gradient) and the IEEE routes
of a training step's forward (cuDNN's forward, or the transposed
convolution of the flipped weight) and weight gradient, held against
``F.conv2d`` and its autograd gradients in float64; the split's plain
version against tests/_tf32x3.py bit for bit; the split kernel's
indexing, emulated, and the arguments its wrapper passes; the dispatch
(CPU tensors and bf16 take ``F.conv2d``) and its count of each path.

On the CPU the TF32 parts' products are exact in fp32 (11 significant bits
each) and the sums round to nearest, so the compositions here are the
card's arithmetic without the tensor cores' truncating accumulation, which
only the card shows (tests/test_torch_cuda.py).
"""

import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _tf32x3 import split as split_ref
from _tf32x3 import tf32 as tf32_ref

from probunet_torch.ops import _build
from probunet_torch.ops import conv as C

#: 3xTF32 against float64, max |err| / max |ref|: a few fp32 roundings of
#: sums of up to 9 * 128 * 3 terms (measured up to 1.7e-6 at C = 128; fp32
#: itself up to 1e-6); one TF32 product is ~2^-12 off (2e-4 measured)
TOL_3X = 2 ** -18
TF32_AT_LEAST = 5e-5
ZERO_CALLS = dict.fromkeys(C.PATHS, 0)


def _err(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.fixture
def calls():
    """The launch counter zeroed, and a reader of conv2d's counts by path."""
    _build.reset_launches()
    return lambda: {path: _build.launches("conv2d", path) for path in ZERO_CALLS}


CASES = [(3, 7, 1, 0, 1), (5, 7, 3, 1, 1), (7, 5, 3, 0, 1), (9, 6, 3, (0, 1), 1),
         (6, 9, 3, (0, 1), 2), (64, 64, 3, 1, 1), (128, 96, 3, 1, 2), (33, 17, 1, 0, 1)]


def _conv_case(cin, cout, k, padding, stride, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, cin, 10, 12, generator=g).contiguous(memory_format=torch.channels_last)
    w = torch.randn(cout, cin, k, k, generator=g) / (cin * k * k) ** 0.5
    b = torch.randn(cout, generator=g)
    s, p = C._pair(stride), C._pair(padding)
    xr, wr, br = (t.double().requires_grad_() for t in (x, w, b))
    ref = F.conv2d(xr, wr, br, s, p)
    dy = torch.randn(ref.shape, generator=g).contiguous(memory_format=torch.channels_last)
    ref.backward(dy.double())
    return x, w, b, s, p, dy, ref.detach(), xr.grad, wr.grad, br.grad


@pytest.mark.parametrize("cin,cout,k,padding,stride", CASES)
def test_3xtf32_compositions_match_float64(calls, cin, cout, k, padding, stride):
    """The 3xTF32 forward (a sampler's) and input gradient (a training
    step's) on CPU tensors against ``F.conv2d`` and its autograd in
    float64, at kernel 1 and 3, padding 0, 1 and the spatial path's (0,
    1), stride 1 and 2 (the spatial path's strided conv), odd channel
    counts; the sums of the three products of the parts taken exactly
    (float64) agree too, so the parts pair hi*hi, lo*hi and hi*lo in each
    call; a plain TF32 product (x and w rounded once, as tests/_tf32x3.py
    rounds) is far off at the same shapes, so the limit tells them apart."""
    x, w, b, s, p, dy, ref, dx_ref, _, _ = _conv_case(cin, cout, k, padding, stride,
                                                     cin * 100 + cout)
    y = C.forward_3x(x, w, b, s, p)
    dx = C.dgrad_3x(dy, x, w, s, p)
    for got, want in ((y, ref), (dx, dx_ref)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _err(got, want) <= TOL_3X
    assert calls() == {**ZERO_CALLS, "tf32x3_fwd": 1, "tf32x3_dgrad": 1}

    (xh, xl), (wh, wl), (dh, dl) = (split_ref(t.contiguous()) for t in (x, w, dy))

    def conv64(a, c):
        return F.conv2d(a.double(), c.double(), None, s, p)

    def dgrad64(d, c):
        return torch.nn.grad.conv2d_input(x.shape, c.double(), d.double(), s, p)

    three_fwd = conv64(xh, wh) + conv64(xl, wh) + conv64(xh, wl) + b.double()[:, None, None]
    three_dgrad = dgrad64(dh, wh) + dgrad64(dl, wh) + dgrad64(dh, wl)
    assert _err(y, three_fwd) <= TOL_3X and _err(dx, three_dgrad) <= TOL_3X
    once = F.conv2d(tf32_ref(x.contiguous()).double(), tf32_ref(w).double(), b.double(), s, p)
    assert _err(once, ref) >= TF32_AT_LEAST


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("cin,cout,k,padding,stride", CASES)
def test_strict_training_conv_matches_float64(monkeypatch, calls, cin, cout, k, padding,
                                              stride, transposed):
    """A training step's convolution (the autograd Function) on CPU
    tensors: the IEEE forward, by cuDNN's forward or (where the rule
    allows: stride 1, a kernel wider than 1) by the transposed convolution
    of the flipped weight, the 3xTF32 input gradient, the IEEE weight
    gradient and the bias gradient against ``F.conv2d`` and its autograd
    in float64, at fp32's own level (the transposed route sums the same
    terms in another order); the counts by path."""
    floor = 1 if transposed else 10 ** 9
    monkeypatch.setattr(C, "TRANSPOSED_MIN_BATCH", floor)
    monkeypatch.setattr(C, "TRANSPOSED_MIN_PIXELS", floor)
    monkeypatch.setattr(C, "TRANSPOSED_MIN_CHANNELS", floor)
    x, w, b, s, p, dy, ref, dx_ref, dw_ref, db_ref = _conv_case(cin, cout, k, padding, stride,
                                                               cin * 7 + cout)
    xa, wa, ba = (t.clone().requires_grad_() for t in (x, w, b))
    y = C._StrictConv.apply(xa, wa, ba, s, p)
    y.backward(dy)
    for got, want in ((y, ref), (xa.grad, dx_ref), (wa.grad, dw_ref), (ba.grad, db_ref)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _err(got, want) <= TOL_3X
    routed = transposed and stride == 1 and k > 1
    assert calls() == {**ZERO_CALLS, "ieee_fwd": int(not routed),
                     "ieee_fwd_transposed": int(routed), "tf32x3_dgrad": 1, "ieee_wgrad": 1}


def test_transposed_rule():
    """A training forward runs as a transposed convolution at stride 1, a
    kernel wider than 1, at least TRANSPOSED_MIN_BATCH rows,
    TRANSPOSED_MIN_CHANNELS input channels and TRANSPOSED_MIN_PIXELS pixels
    (the U-Net's level 0 at b8, 128x128, from 96 channels up), else by
    cuDNN's forward."""
    def rule(c, h, w, k=3, stride=(1, 1), b=8):
        return C._transposed(torch.empty(b, c, h, w, device="meta"),
                             torch.empty(16, c, k, k, device="meta"), stride)

    assert rule(128, 128, 128) and rule(384, 128, 128) and rule(128, 256, 64)
    assert rule(96, 128, 128) and rule(128, 128, 128, b=16)
    assert not rule(64, 128, 128) and not rule(256, 64, 64) and not rule(512, 16, 16)
    assert not rule(128, 128, 128, k=1) and not rule(128, 128, 128, stride=(2, 2))
    assert not rule(128, 256, 256, b=4) and not rule(256, 128, 128, b=4)


@pytest.mark.parametrize("order", [C.X_FWD, C.W_FWD, ("lo",), ("hi", "lo", "hi")])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous", "weight_3x3", "weight_1x1"])
def test_plain_split_matches_tf32x3_split(order, dim, layout):
    """The split's plain version is tests/_tf32x3.py's split bit for bit,
    its parts concatenated in ``order`` along ``dim``, and hi alone, in the
    channels_last layout, whatever the input's layout; values at the
    rounding's edges (ties, carries into the exponent) included."""
    g = torch.Generator().manual_seed(7)
    shape = {"weight_3x3": (6, 5, 3, 3), "weight_1x1": (6, 8, 1, 1)}.get(layout, (2, 8, 5, 3))
    x = torch.randn(shape, generator=g) * 3
    flat = x.view(-1)
    flat[:4] = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 2 - 2.0 ** -23, 0.0])
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    hi_got, got = C._plain_split(x, order, dim)
    hi, lo = split_ref(x.contiguous())
    want = torch.cat([{"hi": hi, "lo": lo}[p] for p in order], dim)
    for a, b in ((got, want), (hi_got, hi)):
        assert a.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(C.tf32(x).view(torch.int32), tf32_ref(x.contiguous()).view(torch.int32))


def _emulate_kernel(x: torch.Tensor, order, dim, vec):
    """tf32_split_kernel's index arithmetic in numpy, over the wrapper's
    arguments: thread i takes VEC elements along d3 of the (B, H, W, C)
    view at the strides given, writes hi at row * d3 + c and each slot at
    base + s * step. Returns (hi, the concatenated parts)."""
    b, c, h, w = x.shape
    d0, d1, d2, d3 = b, h, w, c
    s0, s1, s2, s3 = x.stride(0), x.stride(2), x.stride(3), x.stride(1)
    storage = torch.as_strided(x, (x.untyped_storage().nbytes() // 4,), (1,),
                               0).numpy()
    n = len(order)
    lo_mask = sum(1 << i for i, part in enumerate(order) if part == "lo")
    elems = d0 * d1 * d2 * d3
    out = np.full(n * elems, np.nan, np.float32)
    hi_out = np.full(elems, np.nan, np.float32)
    i = np.arange(elems // vec)
    d3v = d3 // vec
    cc = (i % d3v) * vec
    row = i // d3v
    i2, i1, i0 = row % d2, (row // d2) % d1, row // d2 // d1
    base = row * d3 + cc if dim == 0 else row * n * d3 + cc
    step = elems if dim == 0 else d3
    for e in range(vec):
        v = torch.from_numpy(storage[i0 * s0 + i1 * s1 + i2 * s2 + (cc + e) * s3].copy())
        hi, lo = split_ref(v)
        hi_out[row * d3 + cc + e] = hi.numpy()
        for s in range(n):
            out[base + s * step + e] = (lo if (lo_mask >> s) & 1 else hi).numpy()

    def as_channels_last(flat, shape):
        strides = torch.empty(shape).contiguous(memory_format=torch.channels_last).stride()
        return torch.as_strided(torch.from_numpy(flat), shape, strides)

    shape = (n * b, c, h, w) if dim == 0 else (b, n * c, h, w)
    return as_channels_last(hi_out, tuple(x.shape)), as_channels_last(out, shape)


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("layout,vec", [("channels_last", 4), ("contiguous", 1),
                                        ("odd_channels", 1), ("weight_3x3", 1),
                                        ("weight_1x1", 4)])
def test_split_kernel_arguments_and_indexing(monkeypatch, calls, dim, layout, vec):
    """What the wrapper hands the kernel's C entry point (a recorder here,
    CPU tensors standing in): the declared arity and types, hi's and the
    parts' buffers, x read as (B, H, W, C) at its own strides (an NCHW
    activation or gradient, an OIHW weight), the parts' mask and place,
    16-byte vectors only where the channels are unit-stride and a multiple
    of 4; one launch counted. The kernel's index arithmetic, emulated on
    those arguments, writes exactly the plain version's buffers."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: ctypes.c_void_p(0))
    shape = {"weight_3x3": (6, 8, 3, 3), "weight_1x1": (6, 8, 1, 1),
             "odd_channels": (2, 5, 4, 3)}.get(layout, (2, 8, 4, 3))
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    order = C.W_DGRAD if dim == 0 else C.X_FWD
    hi, out = C._launch_split(x, order, dim)
    (name, args), = lib.calls
    assert name == "probunet_tf32_split"
    argtypes = _build._SIGNATURES[name]
    assert len(args) == len(argtypes)
    for a, t in zip(args, argtypes):
        t.from_param(a)
    b, c, h, w = x.shape
    assert args[:3] == (x.data_ptr(), hi.data_ptr(), out.data_ptr())
    assert args[3:11] == (b, h, w, c, x.stride(0), x.stride(2), x.stride(3), x.stride(1))
    lo_mask = sum(1 << i for i, part in enumerate(order) if part == "lo")
    assert args[11:15] == (2, lo_mask, int(dim == 0), vec)
    assert out.shape == ((2 * b, c, h, w) if dim == 0 else (b, 2 * c, h, w))
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert hi.shape == x.shape and hi.is_contiguous(memory_format=torch.channels_last)
    assert calls()["split"] == 1
    for got, want in zip(_emulate_kernel(x, order, dim, vec),
                         C._plain_split(x, order, dim)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_and_bf16_take_f_conv2d(calls, dtype):
    """CPU tensors, fp32 and bf16, take ``F.conv2d`` as it is, bits and
    gradients alike; only ``plain`` counts."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 6, 8, 8, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)
    w, b = torch.randn(5, 6, 3, 3, generator=g).to(dtype), torch.randn(5, generator=g).to(dtype)
    xa, wa, ba = (t.clone().requires_grad_() for t in (x, w, b))
    y = C.conv2d(xa, wa, ba, 1)
    y.square().sum().backward()
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    ref = F.conv2d(xr, wr, br, 1, 1)
    ref.square().sum().backward()
    assert torch.equal(y, ref)
    for got, want in ((xa, xr), (wa, wr), (ba, br)):
        assert torch.equal(got.grad, want.grad)
    assert calls() == {**ZERO_CALLS, "plain": 1}


def test_calls_count_only_the_gradients_asked_for(calls):
    """An input that needs no gradient (a model's first conv) skips the
    input gradient; no bias skips the bias gradient; the forward counts
    once a call."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 4, 6, 6, generator=g)
    w = torch.randn(3, 4, 3, 3, generator=g).requires_grad_()
    y = C._StrictConv.apply(x, w, None, (1, 1), (1, 1))
    y.sum().backward()
    assert w.grad is not None and w.grad.shape == w.shape
    assert calls() == {**ZERO_CALLS, "ieee_fwd": 1, "ieee_wgrad": 1}


def test_cudnn_calls_set_and_restore_the_tf32_flag():
    """cudnn.allow_tf32 reads as asked inside a call of the module, and
    as before after it, also after the call raised."""
    saved = torch.backends.cudnn.allow_tf32
    try:
        for before in (False, True):
            for inside in (False, True):
                torch.backends.cudnn.allow_tf32 = before
                assert C._cudnn(inside, lambda: torch.backends.cudnn.allow_tf32) is inside
                assert torch.backends.cudnn.allow_tf32 is before

                def boom():
                    raise RuntimeError("planted")

                with pytest.raises(RuntimeError, match="planted"):
                    C._cudnn(inside, boom)
                assert torch.backends.cudnn.allow_tf32 is before
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_every_model_convolution_goes_through_conv2d(monkeypatch, calls):
    """A small Probabilistic U-Net's ELBO and its backward: each
    ``F.conv2d`` the port makes comes from ``conv2d`` (counted ``plain`` on
    the CPU)."""
    from probunet_torch.models import ProbabilisticUNet

    made = []
    orig = F.conv2d

    def counting(*args, **kwargs):
        made.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", counting)
    model = ProbabilisticUNet(3, 3, latent_dim=4, num_filters=(8, 16), img_resolution=(16, 16),
                              model_channels=16, channel_mult=(1, 2), num_blocks=1,
                              attn_resolutions=(8,), dropout=0.0, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    loss = model.elbo(x, x, eps=torch.zeros(2, 4))[0]
    loss.backward()
    assert calls()["plain"] == len(made) > 10
    assert calls() == {**ZERO_CALLS, "plain": len(made)}


def test_split_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        C.split(torch.zeros(2, 3, 4, 4, dtype=torch.float64), C.X_FWD, 1)
    with pytest.raises(ValueError):
        C.split(torch.zeros(2, 3, 4), C.X_FWD, 1)
    with pytest.raises(ValueError):
        C.split(torch.zeros(2, 3, 4, 4), C.X_FWD, 2)
