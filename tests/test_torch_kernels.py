"""The port's kernel modules on the CPU: the plain versions that CPU tensors
take are held against the JAX Pallas kernels run in interpret mode (and the
XLA paths), launch counters stay at 0 off the card, and importing the kernel
modules needs neither nvcc nor triton. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py."""

import ctypes
import importlib
import math
import re
import subprocess
import sys
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probunet_torch.config import Config
from probunet_torch.models import unet as tunet
from probunet_torch.models.unet import build_unet_plan, gn_silu_sites
from probunet_torch.ops import _build
from probunet_torch.ops import attention as tatt
from probunet_torch.ops import gn_silu as tgn
from probunet_torch.ops.norm import group_norm, num_groups_for
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


def _unfused_chain(x, gamma, beta, g, eps, scale=None, shift=None, shift_in=None):
    """The residual block's norm1 as separate fp32 operations: the shift
    added before the norm, or the norm's output times (1 + scale) plus
    shift, then SiLU."""
    xf = x.float()
    if shift_in is not None:
        xf = xf + shift_in[:, None, None, :]
    y = group_norm(xf, gamma, beta, g, eps)
    if scale is not None:
        y = y * (1 + scale[:, None, None, :]) + shift[:, None, None, :]
    return y * torch.sigmoid(y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows", ["per_sample", "shared"])
@pytest.mark.parametrize("mod", ["scale_shift", "shift_in"])
def test_gn_silu_modulated_plain_matches_the_unfused_chain(mod, rows, dtype):
    """The plain version with the embedding's terms folded into the affine
    map (scale, shift) or added before the norm (shift_in), (B, C) or one
    (1, C) row for every sample, against the chain of separate fp32
    operations it replaces: the output, and the gradients of x, gamma,
    beta and each operand through the autograd Function (its backward sums
    each operand's gradient over H*W, and over the batch for a shared
    row)."""
    rng = np.random.default_rng(5)
    b, c, g = 3, 64, 16
    x = torch.from_numpy((rng.standard_normal((b, 6, 5, c)) + 0.3).astype(np.float32)).to(dtype)
    gamma, beta = (torch.from_numpy(a) for a in _gn_data(c=c, seed=6)[1:])
    n = b if rows == "per_sample" else 1
    ops = [torch.from_numpy((0.5 * rng.standard_normal((n, c))).astype(np.float32))
           for _ in range(2 if mod == "scale_shift" else 1)]
    names = ("scale", "shift") if mod == "scale_shift" else ("shift_in",)
    gout = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(dtype)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (x, gamma, beta, *ops)]
        out = fn(*leaves[:3], g, 1e-5, **dict(zip(names, leaves[3:])))
        out.backward(gout.to(out.dtype))
        return out, [t.grad for t in leaves]

    calls = _build.launches("gn_silu_bwd")
    out, grads = run(tgn.gn_silu)
    assert _build.launches("gn_silu_bwd") == calls + 1
    ref, ref_grads = run(_unfused_chain)
    assert out.dtype == dtype and grads[0].dtype == dtype
    assert [t.shape for t in grads[3:]] == [(n, c)] * len(ops)
    # fp32: other rounding orders; bf16: the output and dx rounded once to
    # bf16 at the end, the parameters' and operands' gradients fp32 sums
    tol = 2 ** -8 if dtype == torch.bfloat16 else 1e-5
    assert _rel_err(out.float().detach(), ref.detach()) <= tol
    assert _rel_err(grads[0].float(), ref_grads[0].float()) <= tol
    for got, want in zip(grads[1:], ref_grads[1:]):
        assert got.dtype == torch.float32
        assert _rel_err(got, want) <= (1e-4 if dtype == torch.bfloat16 else 1e-5)


def test_gn_silu_refuses_mismatched_operands():
    """scale without shift, shift_in beside scale, and operands of the
    wrong shape are refused before anything runs."""
    x, gamma, beta = (torch.from_numpy(a) for a in _gn_data(b=2, c=64))
    row = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="together"):
        tgn.gn_silu(x, gamma, beta, 16, scale=row)
    with pytest.raises(ValueError, match="together"):
        tgn.gn_silu(x, gamma, beta, 16, scale=row, shift=row, shift_in=row)
    for bad in (torch.zeros(3, 64), torch.zeros(2, 32), torch.zeros(64)):
        with pytest.raises(ValueError, match="shift_in"):
            tgn.gn_silu(x, gamma, beta, 16, shift_in=bad)


def _rel_err(a, b):
    """Largest absolute difference over the reference's largest value."""
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


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


def _qkv_leaf(layout, L=64, nh=2, b=2, seed=3):
    """One leaf tensor and its q/k/v views: the U-Net block's (qkv, head,
    channel) layout (row stride 3C, unit head-dim stride) or the stride-3
    views of an interleaved qkv tensor."""
    rng = np.random.default_rng(seed)
    if layout == "block":
        y = torch.from_numpy(rng.standard_normal((b, L, 3, nh, 64)).astype(np.float32))
        return y, lambda t: t.unbind(2)
    y = torch.from_numpy(rng.standard_normal((b, L, nh, 64, 3)).astype(np.float32))
    return y, lambda t: (t[..., 0], t[..., 1], t[..., 2])


@pytest.mark.parametrize("layout", ["block", "stride3"])
def test_attention_takes_strided_qkv_views(layout):
    """The result on the block's row-strided views and on stride-3 views
    equals that of contiguous copies, bit for bit, in the forward and in the
    gradients."""
    y, views = _qkv_leaf(layout)
    q, k, v = views(y)
    assert (q.stride()[-1] == 1) == (layout == "block")
    out = tatt.fused_attention(q, k, v)
    ref = tatt.fused_attention(q.contiguous(), k.contiguous(), v.contiguous())
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(out.shape).astype(np.float32))
    yg = y.clone().requires_grad_()
    tatt.fused_attention(*views(yg)).backward(g)
    parts = [a.contiguous().requires_grad_() for a in (q, k, v)]
    tatt.fused_attention(*parts).backward(g)
    for got, part in zip(views(yg.grad), parts):
        np.testing.assert_array_equal(got.numpy(), part.grad.numpy())
    with pytest.raises(ValueError, match="same shape"):
        tatt.fused_attention(q, k[..., :32], v)
    with pytest.raises(ValueError, match=r"\(B, L, heads, c\)"):
        tatt.fused_attention(q[0], k[0], v[0])


def test_kernel_layout_reads_block_views_in_place():
    """kernel_layout passes the block's views through and copies only a view
    whose head dim is not unit-stride or whose rows are not 16-byte
    aligned."""
    y, views = _qkv_leaf("block")
    for a in views(y):
        assert tatt.kernel_layout(a) is a
    y3, views3 = _qkv_leaf("stride3")
    for a in views3(y3):
        c = tatt.kernel_layout(a)
        assert c.is_contiguous() and torch.equal(c, a)
    flat = torch.zeros(2 * 8 * 2 * 64 + 1)
    odd = flat[1:].view(2, 8, 2, 64)  # unit stride, 4 bytes off a 16-byte boundary
    assert odd.data_ptr() % 16 and tatt.kernel_layout(odd) is not odd


def test_kernel_layout_counts_its_copies():
    """The count of kernel_layout's copies moves by one for each tensor
    copied and not at all for the block's views, which chip_smoke.py relies
    on to show that the main paths copy nothing before the attention
    kernels."""
    _build.reset_launches()
    y, views = _qkv_leaf("block")
    for a in views(y):
        tatt.kernel_layout(a)
    assert _build.launches("kernel_layout") == 0
    y3, views3 = _qkv_leaf("stride3")
    for a in views3(y3):
        tatt.kernel_layout(a)
    assert _build.launches("kernel_layout") == 3


# ---- the C entry points against the wrappers -------------------------------------

_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


def _c_declarations():
    """{name: [ctypes type per parameter]} of every ``extern "C"`` function
    in csrc/*.cu, parsed from the sources."""
    decls = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        src = re.sub(r"//[^\n]*", "", path.read_text())
        for m in re.finditer(r'extern "C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)', src):
            types = []
            for param in (p.strip() for p in m.group(2).split(",") if p.strip()):
                decl = re.sub(r"\bconst\b", "", param)
                base = "void*" if "*" in decl else " ".join(decl.split()[:-1])
                types.append(_C_TYPES[base])
            decls[m.group(1)] = types
    return decls


def test_kernel_signatures_match_c_declarations():
    """Every kernel entry point in _build._SIGNATURES has the arity and the
    parameter types of its extern "C" declaration in csrc/*.cu (ctypes
    passes what argtypes says, so a stride argument added on one side only
    would shift every argument after it)."""
    decls = _c_declarations()
    assert set(_build._SIGNATURES) == set(decls) - {"probunet_error_string"}
    for name, argtypes in _build._SIGNATURES.items():
        assert argtypes == decls[name], name
    # the attention entry points take the head dim after (B, H, L) and the
    # head width kd after the plan's rows, last before the stream; the bf16
    # queries kd after the block sizes, the fp32 queries kd before the tile
    # rows
    i = ctypes.c_int
    assert decls["probunet_attention_fwd"][5:10] == [i, i, i, i, ctypes.c_longlong]
    assert decls["probunet_attention_bwd"][10:15] == [i, i, i, i, ctypes.c_longlong]
    assert decls["probunet_attention_fwd"][-6:] == [ctypes.c_float, i, i, i, i, ctypes.c_void_p]
    assert decls["probunet_attention_bwd"][-6:] == [ctypes.c_float, i, i, i, i, ctypes.c_void_p]
    assert decls["probunet_attention_fwd_query"] == [i, i, i, ctypes.c_void_p]
    assert decls["probunet_attention_bwd_query"] == [i, i, i, i, ctypes.c_void_p]
    assert decls["probunet_attention_fwd_f32_query"] == [i, i, ctypes.c_void_p]
    assert decls["probunet_attention_bwd_f32_query"] == [i, i, i, ctypes.c_void_p]


class _FakeLib:
    """Records the arguments of each entry-point call; every call succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "num_sms", lambda index: 132)
    _build.reset_launches()
    return lib


def test_attention_wrappers_pass_the_declared_arguments(fake_lib, monkeypatch):
    """What _launch and _launch_bwd hand the C entry points (here a recorder,
    with CPU tensors standing in), fp32 and bf16: the declared arity and
    types; the stride arguments are the tensors' own (b, l, h) strides (the
    block's views go in place); then the scale, the dtype flag and the
    plan's sizes and head width (bf16: plan's block and tile rows, kd 64;
    fp32: 64-row blocks and fp32_plan's tile rows, kd 64); K3's scratch is
    an fp32 tensor of bwd_scratch_shape (lse and D per 64-row tile, both
    dtypes)."""
    made = []
    empty = torch.empty

    def recording_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    for dtype in (torch.float32, torch.bfloat16):
        fake_lib.calls.clear()
        y, views = _qkv_leaf("block")
        y = y.to(dtype)
        q, k, v = views(y)
        b, L, h, _ = q.shape
        out, lse = tatt._launch(q, k, v, with_lse=True)
        do = torch.zeros_like(out)
        tatt._launch_bwd(q, k, v, out, lse, do, fast=True)
        tatt._launch_bwd(q, k, v, out, lse, do, fast=False)
        (fwd, fargs), (bwd, bargs), (_, strict_args) = fake_lib.calls
        assert (fwd, bwd) == ("probunet_attention_fwd", "probunet_attention_bwd")
        assert fargs[5:9] == bargs[10:14] == (b, h, L, 64)  # B, H, L, the head dim
        for args, tensors, first in ((fargs, (q, k, v), 9), (bargs, (q, k, v, out, do), 14)):
            name = fwd if args is fargs else bwd
            argtypes = _build._SIGNATURES[name]
            assert len(args) == len(argtypes), name
            for a, t in zip(args, argtypes):
                t.from_param(a)  # raises on an argument ctypes would not pass as declared
            strides = [s for a in tensors for s in a.stride()[:3]]
            assert list(args[first:first + len(strides)]) == strides
            assert args[first + len(strides)] == 1 / 8  # the scale follows the strides
        assert fargs[0] == q.data_ptr() and fargs[1] == k.data_ptr() and fargs[2] == v.data_ptr()
        bf16 = int(dtype == torch.bfloat16)
        if bf16:
            p = tatt.plan(b, h, L, 132)
            assert fargs[-5:-1] == (bf16, p.fwd_rows, p.fwd_tile, 64)
            assert bargs[-5:-1] == (bf16, 1, p.bwd_rows, 64)
            assert strict_args[-5:-1] == (bf16, 0, p.bwd_split_rows, 64)
        else:
            p = tatt.fp32_plan(64)
            assert fargs[-5:-1] == (0, 64, p.fwd_tile, 64) == (0, 64, 64, 64)
            assert bargs[-5:-1] == (0, 1, p.bwd_tile, 64) and strict_args[-5:-1] == (0, 0, 64, 64)
        dt = "bf16" if bf16 else "fp32"
        assert _build.launches("attention_fwd") == _build.launches("attention_fwd", dt, 64) == 1
        assert _build.launches("attention_bwd") == _build.launches("attention_bwd", dt, 64) == 2
        _build.reset_launches()
        scratch = next(t for t in made if t.data_ptr() == bargs[6])
        assert scratch.dtype == torch.float32
        assert tuple(scratch.shape) == tatt.bwd_scratch_shape(b, h, L) == (b * h, -(-L // 64), 2, 64)


@pytest.mark.parametrize("c,width", [(72, 72), (96, 96), (100, 104), (127, 128), (32, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_wrappers_at_other_head_dims(fake_lib, monkeypatch, dtype, c, width):
    """At head dim c the entry points get rows of kernel_width(c) columns:
    the block's views of whole 16-byte bf16 chunks go in place (c = 72, 96:
    no copy), any other width is copied zero-padded to that width (each
    copy counted; the backward reuses the forward's copies of q/k/v and
    pads dO), the scale is 1/sqrt(c) of the real c, the head width is the
    narrowest built that holds the row (bf16: kD = 80 at 72, 96 at 96, 128
    at 104 and 128; fp32: 128 past 64) with its plan's rows, and the
    results are the first c columns. (fake_lib: the outputs' bits are
    whatever torch.empty left.)"""
    assert tatt.kernel_width(c) == width
    rng = np.random.default_rng(c)
    y = torch.from_numpy(rng.standard_normal((2, 64, 3, 2, c)).astype(np.float32)).to(dtype)
    q, k, v = y.unbind(2)
    in_place = width == c
    kq, kk, kv = map(tatt.kernel_layout, (q, k, v))
    assert _build.launches("kernel_layout") == (0 if in_place else 3)
    assert (kq is q) == in_place and kq.shape == (2, 64, 2, width)
    if not in_place:  # zero-padded copies: the first c columns, then zeros
        assert torch.equal(kq[..., :c], q) and not kq[..., c:].any() and kq.is_contiguous()
    out, lse = tatt._launch(kq, kk, kv, with_lse=True, c=c)
    assert out.shape == (2, 64, 2, width)
    do = torch.zeros(2, 64, 2, c, dtype=dtype)
    grads = tatt._kernel_bwd(kq, kk, kv, out, lse, do, True, c)  # attention_bwd's CUDA path
    assert _build.launches("kernel_layout") == (0 if in_place else 4)   # + dO padded
    assert [g.shape for g in grads] == [(2, 64, 2, c)] * 3
    assert all(g.is_contiguous() for g in grads)
    (fwd, fargs), (bwd, bargs) = fake_lib.calls
    assert fargs[5:9] == bargs[10:14] == (2, 2, 64, width)
    assert fargs[18] == bargs[29] == pytest.approx(1 / math.sqrt(c), rel=1e-7)
    assert fargs[0] == kq.data_ptr() and bargs[0] == kq.data_ptr()
    if dtype == torch.bfloat16:
        kd = {64: 64, 72: 80, 96: 96, 104: 128, 128: 128}[width]
        p = tatt.plan(2, 2, 64, 132, kd)
        assert p.kd == kd and fargs[-4:-1] == (p.fwd_rows, p.fwd_tile, kd)
        assert bargs[-3:-1] == (p.bwd_rows, kd)
        if kd != 64:
            assert (p.fwd_rows, p.fwd_tile, p.bwd_rows, p.bwd_split_rows) == (64, 64, 64, 64)
    else:  # fp32: 64-row blocks, the fp32 plan's tiles (32 rows at kD = 128)
        kd = 128 if c > 64 else 64
        p = tatt.fp32_plan(kd)
        assert fargs[-4:-1] == (64, p.fwd_tile, kd) and bargs[-3:-1] == (p.bwd_tile, kd)
        assert (p.fwd_tile, p.bwd_tile) == ((32, 32) if kd == 128 else (64, 64))


@pytest.mark.parametrize("c,width,kd", [(65, 72, 80), (72, 72, 80), (88, 88, 96), (96, 96, 96),
                                        (100, 104, 128)])
def test_attention_wrappers_pass_the_exact_head_width(fake_lib, monkeypatch, c, width, kd):
    """bf16 at head dims past 64: the entry points get kd 80, 80, 96, 96 and
    128 at c = 65, 72, 88, 96 and 100, the narrowest width built that holds
    the row, with that width's plan rows (here 128-row blocks and tiles at
    kd 80, where 8 blocks fill the 8 SMs the recorder's card reports: 64 at
    kd 96 and 128); the block's views of whole bf16 chunks (72, 88, 96) go
    in place; kd = 128 stays callable at every such c, with its own plan;
    the counts by head width see each launch; a kd not built is refused
    before any call."""
    monkeypatch.setattr(_build, "num_sms", lambda index: 8)
    rng = np.random.default_rng(c)
    y = torch.from_numpy(rng.standard_normal((2, 256, 3, 2, c)).astype(np.float32)).to(
        torch.bfloat16)
    q, k, v = map(tatt.kernel_layout, y.unbind(2))
    assert _build.launches("kernel_layout") == (0 if width == c else 3)
    assert (q.data_ptr() == y.data_ptr()) == (width == c)
    do = torch.zeros(2, 256, 2, width, dtype=torch.bfloat16)
    for want in (kd, 128):
        fake_lib.calls.clear()
        out, lse = tatt._launch(q, k, v, with_lse=True, c=c, kd=None if want == kd else 128)
        tatt._launch_bwd(q, k, v, out, lse, do, True, c, kd=None if want == kd else 128)
        tatt._launch_bwd(q, k, v, out, lse, do, False, c, kd=None if want == kd else 128)
        (_, fargs), (_, bargs), (_, sargs) = fake_lib.calls
        p = tatt.plan(2, 2, 256, 8, want)
        assert fargs[8] == bargs[13] == width
        assert fargs[-4:-1] == (p.fwd_rows, p.fwd_tile, want)
        assert bargs[-4:-1] == (1, p.bwd_rows, want) and sargs[-4:-1] == (0, p.bwd_split_rows, want)
        rows = {80: (128, 128, 64, 64), 96: (64, 64, 64, 64), 128: (64, 64, 64, 64)}[want]
        assert p[:4] == rows
    for kernel, per_run in (("attention_fwd", 1), ("attention_bwd", 2)):
        assert _build.launches(kernel) == 2 * per_run
        assert _build.launches(kernel, "bf16", kd) == (2 if kd == 128 else 1) * per_run
        assert _build.launches(kernel, "bf16", 128) == (2 if kd == 128 else 1) * per_run
    fake_lib.calls.clear()
    for bad in (72, 112):
        with pytest.raises(ValueError, match="kd"):
            tatt._launch(q, k, v, with_lse=False, c=c, kd=bad)
    assert fake_lib.calls == []


def _with_plan_cases(path):
    """The (kd, rows, ...) -> Op<...> lines of the bf16 with_plan in a
    source: K2's (kd, block rows, tile rows, NWG, BN, KD), K3's (kd, block
    rows, split, NWG, SPLIT, KD)."""
    src = re.sub(r"//[^\n]*", "", path.read_text())
    body = src[src.index("namespace sm90"):src.index("namespace f32")]
    body = body[body.index("cudaError_t with_plan("):]
    fwd = [tuple(map(int, m)) for m in re.findall(
        r"kd == (\d+) && block_rows == (\d+) && tile_rows == (\d+)\) return f\(Op<(\d+), (\d+), "
        r"(\d+)>", body)]
    bwd = []
    for m in re.finditer(r"kd == (\d+) && block_rows == (\d+)( && split)?\)\s*return ([^;]+);",
                         body):
        kd, rows, only_split, ret = int(m.group(1)), int(m.group(2)), m.group(3), m.group(4)
        for nwg, split, k in re.findall(r"Op<(\d+), (true|false), (\d+)>", ret):
            bwd.append((kd, rows, split == "true", int(nwg), split == "true", int(k)))
        assert not only_split or "false" not in ret
    return fwd, bwd


def test_with_plan_builds_every_shape_the_plan_gives():
    """A census of the sources against ops/attention.py::plan: every (kd,
    block rows, tile rows) K2 plan and every (kd, block rows, split) K3
    plan at each built kd, over the U-Net's sites and edge shapes, has its
    case in with_plan (attention_fwd.cu, attention_bwd.cu), each case's
    instantiation matches it (rows = 64 NWG, tile = BN, KD = kd), no case
    is at a kd outside BF16_KDS, and no case is one the plan never gives
    (a shape built for nothing)."""
    fwd, _ = _with_plan_cases(_build.CSRC / "attention_fwd.cu")
    _, bwd = _with_plan_cases(_build.CSRC / "attention_bwd.cu")
    assert fwd and bwd
    for kd, rows, tile, nwg, bn, k in fwd:
        assert kd == k and rows == 64 * nwg and tile == bn and kd in tatt.BF16_KDS
    for kd, rows, split, nwg, _, k in bwd:
        assert kd == k and rows == 64 * nwg and kd in tatt.BF16_KDS
    built_fwd = {c[:3] for c in fwd}
    built_bwd = {c[:3] for c in bwd}
    assert len(built_fwd) == len(fwd) and len(built_bwd) == len(bwd)
    given_fwd, given_bwd = set(), set()
    for kd in tatt.BF16_KDS:
        for b in (1, 2, 4, 8, 64):
            for heads in (1, 2, 4, 6, 8):
                for L in (1, 64, 65, 100, 128, 256, 1024, 4096):
                    for sms in (16, 132):
                        p = tatt.plan(b, heads, L, sms, kd)
                        given_fwd.add((kd, p.fwd_rows, p.fwd_tile))
                        given_bwd.add((kd, p.bwd_rows, False))
                        given_bwd.add((kd, p.bwd_split_rows, True))
    assert given_fwd == built_fwd
    assert given_bwd <= built_bwd
    # the split-dS 64-row shapes are built for fast mode's 64-row plan too
    assert built_bwd - given_bwd <= {(kd, 64, True) for kd in tatt.BF16_KDS}


def test_attention_refuses_heads_past_128():
    """The bf16 kernels and the backward hold at most 128 columns a head,
    the fp32 forward 256: a wider head is refused before any launch, naming
    its shape (the ADM U-Net builds at most 127, the DDPM++ U-Net 256), and
    a backward past 128 raises, naming the missing K3 build."""
    q = torch.zeros(1, 8, 2, 136)
    tatt._check_cuda(q, q, q)   # fp32: the kD = 256 forward
    with pytest.raises(ValueError, match=r"\(1, 8, 2, 136\)"):
        tatt._check_cuda(*(q.to(torch.bfloat16),) * 3)
    wide = torch.zeros(1, 8, 2, 264)
    with pytest.raises(ValueError, match=r"\(1, 8, 2, 264\)"):
        tatt._check_cuda(wide, wide, wide)
    tatt._check_cuda(*(q[..., :128].to(torch.bfloat16),) * 3)
    tatt._check_bwd_width(128)
    with pytest.raises(NotImplementedError, match="K3"):
        tatt._check_bwd_width(136)
    assert tatt.kernel_width(128) == tatt.MAX_BWD_HEAD_DIM == 128
    assert tatt.kernel_width(256) == tatt.MAX_HEAD_DIM == 256


def test_gn_silu_counts_launches_by_mod(fake_lib, monkeypatch):
    """K1's launches counted by modulation: unmodulated, with per-sample
    (scale, shift) views of one (B, 2C) affine output (in place: batch
    stride 2C), and with a shared (1, C) shift added before the norm (batch
    stride 0); the entry point gets mod, the operands and their strides."""
    monkeypatch.setattr(tgn, "_num_sms", lambda index: 132)
    x, gamma, beta = (torch.from_numpy(a) for a in _gn_data(b=2, c=64))
    params = torch.randn(2, 128)
    scale, shift = params.chunk(2, dim=1)
    row = torch.randn(1, 64)
    tgn._launch(x, gamma, beta, 16, 1e-5)
    tgn._launch(x, gamma, beta, 16, 1e-5, scale=scale, shift=shift)
    tgn._launch(x, gamma, beta, 16, 1e-5, shift_in=row)
    tail = [args[17:22] for _, args in fake_lib.calls]
    assert tail == [(0, None, None, 0, 0),
                    (1, scale.data_ptr(), shift.data_ptr(), 128, 128),
                    (2, None, row.data_ptr(), 0, 0)]
    assert [_build.launches("gn_silu", m) for m in tgn.MODS] == [1, 1, 1]


def test_gn_silu_counts_launches_by_plan(fake_lib, monkeypatch):
    """K1's launches counted by plan beside the total: a slice that fits a
    cluster (b2, 8x8x64) under on_chip, CorrDiff's 448x448 level of 128
    channels (a 3.2 MB group slice in fp32) under streamed."""
    monkeypatch.setattr(tgn, "_num_sms", lambda index: 132)
    for shape in ((2, 8, 8, 64), (1, 448, 448, 128), (2, 8, 8, 64)):
        x = torch.empty(shape)
        tgn._launch(x, torch.ones(shape[-1]), torch.zeros(shape[-1]), 32, 1e-6)
    assert not tgn.plan(1, 448, 448, 128, 32, 4, 132).on_chip
    assert _build.launches("gn_silu") == 3
    assert _build.launches("gn_silu", "on_chip") == 2
    assert _build.launches("gn_silu", "streamed") == 1


@pytest.mark.parametrize("c", [256, 200, 136])
def test_attention_wrappers_at_kd256(fake_lib, c):
    """fp32 at head dims 129-256 (CorrDiff's 256): the block's views go in
    place, the entry point gets kd 256, 64-row blocks, the plan's 32-row
    tiles and 1/sqrt(c), the launch counts under fp32_kd256, and the result
    is c columns wide."""
    rng = np.random.default_rng(c)
    y = torch.from_numpy(rng.standard_normal((2, 64, 3, 1, c)).astype(np.float32))
    q, k, v = y.unbind(2)
    kq, kk, kv = map(tatt.kernel_layout, (q, k, v))
    assert kq is q
    out, lse = tatt._launch(kq, kk, kv, with_lse=True, c=c)
    (fwd, fargs), = fake_lib.calls
    assert fwd == "probunet_attention_fwd" and fargs[5:9] == (2, 1, 64, c)
    assert fargs[18] == pytest.approx(1 / math.sqrt(c), rel=1e-7)
    assert fargs[-5:-1] == (0, 64, 32, 256)
    assert _build.launches("attention_fwd") == _build.launches("attention_fwd", "fp32", 256) == 1
    assert out.shape == (2, 64, 1, c) and lse.shape == (2, 64)


def test_attention_launch_refuses_strided_head_dim(fake_lib):
    """Handed straight to a launch, a view whose head dim is not unit-stride
    is refused before the entry point is called; fused_attention normalises
    it first (kernel_layout)."""
    y, views = _qkv_leaf("stride3")
    q, k, v = views(y)
    c = q.contiguous()
    with pytest.raises(ValueError, match="unit-stride"):
        tatt._launch(q, c, c, with_lse=False)
    lse = torch.zeros(c.shape[0] * c.shape[2], c.shape[1])
    with pytest.raises(ValueError, match="unit-stride"):
        tatt._launch_bwd(c, c, c, c, lse, v, fast=True)
    assert fake_lib.calls == []


def test_cpu_tensors_leave_launch_counters_at_zero():
    _build.reset_launches()
    x, gamma, beta = _gn_data()
    tgn.gn_silu(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta), 16)
    q, k, v = (torch.from_numpy(a) for a in _qkv(64))
    tatt.fused_attention(q, k, v)
    assert _build.launches("gn_silu") == 0 and _build.launches("attention_fwd") == 0


def test_cpu_autograd_leaves_launch_counters_at_zero():
    """Gradients flow through both wrappers on the CPU, through the stride-3
    q/k/v views of the block's interleaved qkv tensor, by the plain versions:
    no kernel counter moves, and the views' gradients are those of
    contiguous copies."""
    _build.reset_launches()
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
    assert [_build.launches(k) for k in ("gn_silu", "attention_fwd", "attention_bwd")] == [0] * 3


def test_one_reset_clears_every_launch_count(fake_lib, monkeypatch):
    """One reset_launches zeroes every kernel's total and each split the
    counter keeps: K1 by plan and by modulation, K2 and K3 by dtype and
    head width, the copies before an attention launch, conv2d's paths and
    the split kernel (launched here through the recorder, CPU tensors
    standing in). After it a CPU call of the plain K1, K2 and K3 counts
    nothing, a plain convolution counts under "plain" and a copy of a
    stride-3 view counts under "kernel_layout"."""
    from probunet_torch.ops import conv as C

    monkeypatch.setattr(tgn, "_num_sms", lambda index: 132)
    x, gamma, beta = (torch.from_numpy(a) for a in _gn_data(b=2, c=64))
    tgn._launch(x, gamma, beta, 16, 1e-5, shift_in=torch.randn(1, 64))
    y3, views3 = _qkv_leaf("stride3")
    q, k, v = map(tatt.kernel_layout, views3(y3))
    out, lse = tatt._launch(q, k, v, with_lse=True)
    tatt._launch_bwd(q, k, v, out, lse, torch.zeros_like(out), fast=False)
    C._launch_split(torch.zeros(2, 4, 3, 3), C.X_FWD, 1)
    C.conv2d(torch.zeros(1, 4, 3, 3), torch.zeros(2, 4, 1, 1))
    keys = [("gn_silu",), ("gn_silu", "on_chip"), ("gn_silu", "shift_in"), ("attention_fwd",),
            ("attention_fwd", "fp32", 64), ("attention_bwd",), ("attention_bwd", "fp32", 64),
            ("kernel_layout",), ("conv2d",), ("conv2d", "split"), ("conv2d", "plain")]
    assert [_build.launches(*key) for key in keys] == [1, 1, 1, 1, 1, 1, 1, 3, 2, 1, 1]
    _build.reset_launches()
    assert [_build.launches(*key) for key in keys] == [0] * len(keys)
    tgn.gn_silu(x, gamma, beta, 16)
    cq, ck, cv = views3(y3)
    tatt.fused_attention(cq, ck, cv)
    tatt.attention_bwd(cq, ck, cv, None, None, torch.zeros_like(cq))
    C.conv2d(torch.zeros(1, 4, 3, 3), torch.zeros(2, 4, 1, 1))
    tatt.kernel_layout(cq)
    assert fake_lib.calls[-1][0] == "probunet_tf32_split" and len(fake_lib.calls) == 4
    assert [_build.launches(*key) for key in keys] == [0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1]


def _k1_sites(res=128):
    cfg = Config()
    return gn_silu_sites(*build_unet_plan((res, res), 4, cfg.model_channels, cfg.channel_mult,
                                          cfg.num_blocks, cfg.attn_resolutions), (res, res))


@pytest.mark.parametrize("ddpmpp", [False, True], ids=["adm", "ddpmpp"])
def test_gn_silu_sites_are_the_k1_calls(monkeypatch, ddpmpp):
    """gn_silu_sites against the GroupNorm+SiLU calls of one forward of an
    ADM and a DDPM++ U-Net on the CPU, recorded in call order by a wrapper
    of the layers' gn_silu: each block's norm0, then its norm1 with the
    embedding's terms ((scale, shift) per sample in the ADM block, the
    shift added before the norm in the DDPM++ block), then out_norm."""
    from probunet_torch.models import layers as tl

    calls = []
    plain = tl.gn_silu

    def record(x, *args, **kw):
        mod = ("scale_shift" if kw.get("scale") is not None
               else "shift_in" if kw.get("shift_in") is not None else "none")
        operand = kw.get("shift") if mod == "scale_shift" else kw.get("shift_in")
        calls.append((tuple(x.shape[1:]), mod, None if operand is None else operand.shape[0]))
        return plain(x, *args, **kw)

    monkeypatch.setattr(tl, "gn_silu", record)
    kw = dict(model_channels=16, channel_mult=(1, 2), num_blocks=1, attn_resolutions=(),
              dropout=0.0, device="cpu")
    net = (tunet.UNet((16, 16), 4, 3, ddpmpp=True, **kw) if ddpmpp
           else tunet.UNet((16, 16), 4, 3, use_diffuse=True, **kw)).eval()
    with torch.no_grad():
        net(torch.randn(2, 16, 16, 4), torch.tensor([0.3, 1.2]))
    enc, dec = net.enc_specs, net.dec_specs
    sites = gn_silu_sites(enc, dec, dec[-1].out_channels, (16, 16))
    blocks = sum(s.kind == "block" for s in enc + dec)
    assert [site for site, _, _ in calls] == sites and len(sites) == 2 * blocks + 1
    mod = "shift_in" if ddpmpp else "scale_shift"
    assert [m for _, m, _ in calls] == ["none", mod] * blocks + ["none"]
    assert all(rows == 2 for _, m, rows in calls if m != "none")   # per sample


def test_k1_sites_of_the_default_unet():
    """The 57 sites per forward that chip_smoke.py counts on the card by
    hooks: norm0 of the 28 blocks (7 at each of 128, 64 and 32, 8 at 16),
    their norm1 at their outputs' resolution (a down block's is half its
    norm0's, an up block's twice) and out_norm."""
    sites = _k1_sites()
    assert len(sites) == 57
    assert sorted(Counter(h for h, _, _ in sites).items()) == [(16, 16), (32, 14), (64, 14),
                                                               (128, 13)]


def _check_plan(b, h, w, c, groups, itemsize, num_sms=132):
    """K1's plan for a shape, checked against what the kernel assumes."""
    p = tgn.plan(b, h, w, c, groups, itemsize, num_sms)
    hw, cg, vec = h * w, c // groups, 16 // itemsize
    assert p.cb % cg == 0 and c % p.cb == 0          # whole groups, equal channel blocks
    if c % vec == 0:
        assert p.cb % vec == 0                        # whole 16-byte vectors
    assert 1 <= p.n <= tgn.MAX_CLUSTER
    # block k takes rows [k rows, (k + 1) rows), chunk_rows at a time: every
    # row exactly once, in order, and no block without rows
    covered = [r for k in range(p.n)
               for c0 in range(k * p.rows, min(hw, (k + 1) * p.rows), p.chunk_rows)
               for r in range(c0, min(c0 + p.chunk_rows, (k + 1) * p.rows, hw))]
    assert covered == list(range(hw))
    assert (p.n - 1) * p.rows < hw
    assert p.chunk_rows * p.cb * itemsize <= tgn.SLICE_BYTES
    assert (p.chunk_rows == p.rows) == p.on_chip      # on chip: the block's rows stay resident
    return p


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("site", sorted(set(_k1_sites())), ids=lambda s: "x".join(map(str, s)))
def test_plan_keeps_every_path_site_on_chip(site, itemsize):
    """At batch 8 every site of the path is held in its clusters' shared
    memory (x read from HBM once), with row segments of at least 32 bytes."""
    h, w, c = site
    p = _check_plan(8, h, w, c, num_groups_for(c), itemsize)
    assert p.on_chip and p.cb * itemsize >= 32


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,on_chip", [
    ((1, 256, 256, 64, 16), False),   # 4 MB per unit of 8 or more channels: streamed
    ((1, 1, 1, 128, 32), True),       # H*W = 1
    ((3, 5, 7, 6, 1), True),          # C = 6: no 16-byte vectors
    ((2, 4, 4, 12, 3), True),
    ((1, 9, 3, 1024, 32), True),
], ids=["streamed", "hw1", "c6", "c12", "b1"])
def test_plan_edge_shapes(shape, on_chip, itemsize):
    p = _check_plan(*shape, itemsize)
    assert p.on_chip == on_chip
    if not on_chip:
        assert p.cb * itemsize >= 32 and p.rows > p.chunk_rows


@pytest.mark.parametrize("dtype,aligned,vec", [(torch.float32, True, 4),
                                               (torch.bfloat16, True, 8),
                                               (torch.float32, False, 1)])
def test_gn_silu_wrapper_passes_the_declared_arguments(fake_lib, monkeypatch, dtype, aligned,
                                                       vec):
    """What _launch hands the C entry point (a recorder here, CPU tensors
    standing in) matches the declared arity and types: x, gamma, beta and
    the three outputs (no partials buffer), then the shape and the plan; one
    launch counted. A view off a 16-byte boundary goes scalar (vec 1)."""
    monkeypatch.setattr(tgn, "_num_sms", lambda index: 132)
    x, gamma, beta = (torch.from_numpy(a) for a in _gn_data(b=2, h=8, w=8, c=64))
    if not aligned:
        x = torch.cat([torch.zeros(1), x.flatten()])[1:].view(x.shape)
        assert x.data_ptr() % 16
    x = x.to(dtype)
    out, mean, rstd = tgn._launch(x, gamma, beta, 16, 1e-5)
    (name, args), = fake_lib.calls
    assert name == "probunet_gn_silu_fwd"
    argtypes = _build._SIGNATURES[name]
    assert len(args) == len(argtypes)
    for a, t in zip(args, argtypes):
        t.from_param(a)  # raises on an argument ctypes would not pass as declared
    assert args[:6] == (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                        mean.data_ptr(), rstd.data_ptr())
    p = tgn.plan(2, 8, 8, 64, 16, x.element_size(), 132)
    assert args[6:14] == (2, 64, 64, 16, p.cb, p.n, p.rows, p.chunk_rows)
    assert args[14:17] == (1e-5, int(dtype == torch.bfloat16), vec)
    assert args[17:22] == (0, None, None, 0, 0)       # unmodulated: no operands
    assert (out.shape, out.dtype, mean.shape, rstd.shape) == (x.shape, dtype, (2, 16), (2, 16))
    assert _build.launches("gn_silu") == _build.launches("gn_silu", "on_chip", "none") == 1


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


# ---- the bf16 AdamW update (ops/adamw_bf16.py) ---------------------------------------------


def test_adamw_bf16_takes_the_foreach_path_on_the_cpu():
    """AdamWBf16State on CPU tensors runs the plain multi-tensor update:
    one ("adamw_bf16", "foreach") count a step and no launch;
    mu stays bf16 and nu fp32, and the parameters move."""
    from probunet_torch.train.state import AdamWBf16State

    gen = torch.Generator().manual_seed(5)
    params = [torch.nn.Parameter(torch.randn(shape, generator=gen))
              for shape in [(), (3,), (4, 5), (4097,)]]
    start = [p.detach().clone() for p in params]
    opt = AdamWBf16State(params, lr=1e-2)
    _build.reset_launches()
    for step in range(1, 4):
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
        assert _build.launches("adamw_bf16", "foreach") == step
    assert _build.launches("adamw_bf16", "fused") == 0
    assert opt.param_groups[0]["count"] == 3
    for p, p0 in zip(params, start):
        st = opt.state[p]
        assert st["mu"].dtype == torch.bfloat16 and st["nu"].dtype == torch.float32
        assert not torch.equal(p.detach(), p0)


@pytest.mark.parametrize("numels", [[1, 3, 4097, 2 ** 22 + 3, 1], [0, 65536, 65537, 5]],
                         ids=["ragged", "edges"])
def test_adamw_bf16_table_covers_every_element_once(numels):
    """The table starts with the rows (p, grad, mu, nu, length), and its
    chunks walk each tensor from element 0 in CHUNK steps, tensor after
    tensor: every element in exactly one chunk (none for an empty tensor)."""
    from probunet_torch.ops import adamw_bf16 as A

    rows = [x for i, n in enumerate(numels) for x in (16 * i, 32 * i, 48 * i, 64 * i, n)]
    words, ntensors, nchunks = A.table_words(rows)
    assert ntensors == len(numels) and len(words) == 5 * ntensors + nchunks
    assert words[:5 * ntensors].tolist() == rows
    chunks = words[5 * ntensors:]
    tensor, chunk = (chunks & 0xFFFFFFFF).tolist(), (chunks >> 32).tolist()
    want = [(i, c) for i, n in enumerate(numels) for c in range(-(-n // A.CHUNK))]
    assert list(zip(tensor, chunk)) == want
    covered = Counter()
    for i, c in want:
        covered[i] += min(A.CHUNK, numels[i] - c * A.CHUNK)
    assert [covered[i] for i in range(len(numels))] == numels


def test_adamw_bf16_launch_writes_the_table_each_call(fake_lib):
    """The launch passes the table, its counts and the hyperparameters (1 -
    b1, 1 - b2, the bias corrections' reciprocals and -lr, as the foreach
    ops take them); the table is written every call, into the same buffer
    while its length and card hold, into a new one when they change."""
    from probunet_torch.ops import adamw_bf16 as A

    table, writes = A.Table(), []

    def write(words, card):   # the device copy, in host memory
        writes.append(card)
        if table.words is None or len(table.words) != len(words):
            table.words = torch.empty(len(words), dtype=torch.int64)
        table.words.copy_(torch.from_numpy(words))

    table._write = write
    hyper = dict(b1=0.9, b2=0.999, bc1=1 - 0.9 ** 2, bc2=1 - 0.999 ** 2, eps=1e-8,
                 weight_decay=0.01, lr=3e-3)
    rows = [[64, 128, 192, 256, 70000], [64, 512, 192, 256, 70000],
            [64, 512, 192, 256, 70000, 8, 16, 24, 32, 3]]
    buffers = []
    for r in (rows[0], rows[0], rows[1], rows[2]):
        table.launch(r, 0, **hyper)
        buffers.append(table.words.data_ptr())
        assert table.words.tolist() == A.table_words(r)[0].tolist()
    assert _build.launches("adamw_bf16", "fused") == len(writes) == 4
    assert _build.launches("adamw_bf16", "foreach") == 0
    assert buffers[0] == buffers[1] == buffers[2] != buffers[3]   # a longer table, a new buffer
    name, args = fake_lib.calls[0]
    assert name == "probunet_adamw_bf16" and args[1:3] == (1, 2)
    assert args[3:12] == (0.9, 1 - 0.9, 0.999, 1 - 0.999, 1 / hyper["bc1"], 1 / hyper["bc2"],
                          1e-8, 0.01, -3e-3)
    assert fake_lib.calls[-1][1][1:3] == (2, 3)


# ---- dropout's compare, scale and select (ops/dropout.py) ----------------------------------


def _former_select(fn, x, rate, gen, shard):
    """The three functions' select as written before ops/dropout.py:
    compare, divide and a where over a 0-dim zero, the mask from the same
    draw."""
    from probunet_torch.models.layers import nchw, rand_rows

    keep = 1.0 - rate
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if fn == "dropout":
        b, c, h, w = x.shape
        mask = nchw(rand_rows((b, h, w, c), gen, x.device, shard) < keep)
    elif fn == "token_dropout":
        mask = rand_rows(x.shape, gen, x.device, shard) < keep
    else:
        mask = rand_rows((x.shape[0], 1), gen, x.device, shard) < keep
        mask = mask.reshape(x.shape[0], *(1,) * (x.ndim - 1))
    return torch.where(mask, x / keep, zero)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("fn", ["dropout", "token_dropout", "drop_path"])
def test_dropout_helper_reproduces_the_former_selects(fn, rate):
    """dropout (an NCHW channels_last map), token_dropout and drop_path
    (tokens (B, L, D)) through the one helper give the former expressions'
    output and input gradient bit for bit on the CPU, in fp32 and bf16, as
    one process and as rank 1 of 2; at rate 0 the identity with no draw;
    nothing counted."""
    from probunet_torch.models import layers

    _build.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        for shard in ((0, 1), (1, 2)):
            x0 = torch.randn(4, 6, 5, 7, generator=torch.Generator().manual_seed(3))
            if fn == "dropout":
                x0 = x0.contiguous(memory_format=torch.channels_last)
            x0 = x0.to(dtype)
            dy = torch.randn(x0.shape, generator=torch.Generator().manual_seed(4)).to(dtype)
            outs = []
            for new in (True, False):
                x = x0.clone().requires_grad_()
                gen = torch.Generator().manual_seed(11)
                if new:
                    y = getattr(layers, fn)(x, rate, True, gen, shard)
                elif rate == 0.0:
                    y = x
                else:
                    y = _former_select(fn, x, rate, gen, shard)
                y.backward(dy)
                outs.append((y.detach(), x.grad, gen.get_state()))
            (y, g, state), (y0, g0, state0) = outs
            bits = torch.int32 if dtype == torch.float32 else torch.int16
            assert torch.equal(y.view(bits), y0.view(bits)), (dtype, shard)
            assert torch.equal(g.view(bits), g0.view(bits)), (dtype, shard)
            assert torch.equal(state, state0)
            if rate == 0.0:
                assert torch.equal(state, torch.Generator().manual_seed(11).get_state())
            else:
                assert not torch.equal(y, x0)
    assert _build.launches("dropout") == 0


def test_dropout_layouts_the_kernel_reads_in_place():
    """The kernel's order checks, on the CPU: the U-Net's channels_last map
    and the NCHW view of its NHWC draw (whole, a rank's rows of the global
    draw, a view past 16-byte alignment) have one order; a spatial rank's H
    rows of the tile's draw do not (copied on the card), nor does a dense
    draw in NCHW order; x is taken contiguous or channels_last, with size-1
    dims' strides ignored."""
    from probunet_torch.models.layers import nchw, rand_rows
    from probunet_torch.ops import dropout as D

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 24, 9, 11).contiguous(memory_format=torch.channels_last)
    whole = nchw(rand_rows((2, 9, 11, 24), gen, "cpu"))
    rank = nchw(rand_rows((2, 9, 11, 24), gen, "cpu", (1, 2)))
    rows = nchw(rand_rows((2, 9, 11, 24), gen, "cpu", (0, 1), (1, 3)))
    flat = torch.rand(2 * 24 * 9 * 11 + 1, generator=gen)
    off = nchw(flat[1:].view(2, 9, 11, 24))
    assert D._dense(x) and D._dense(off)
    for u in (whole, rank, off):
        assert D._same_order(u, x.shape, x.stride())
    assert not D._same_order(rows, x.shape, x.stride())
    assert not D._same_order(torch.rand(x.shape), x.shape, x.stride())   # dense, NCHW order
    assert not D._dense(torch.rand(4, 6)[:, ::2])
    tokens = torch.rand(4, 8, 16)
    assert D._dense(tokens) and D._dense(tokens[1:3])
    assert not D._dense(tokens.transpose(0, 1).contiguous().transpose(0, 1))
    one = torch.rand(3, 1, 5)
    assert D._dense(one.transpose(0, 1))
    assert D._same_order(torch.rand(1, 3, 5).transpose(0, 1), one.shape, one.stride())


def test_dropout_launch_passes_the_declared_arguments(fake_lib):
    """What one launch hands the C entry point (here a recorder, CPU tensors
    standing in): the declared arity, n, the row length, keep and 1 / keep
    as fp32, the dtype, the mode, and the vector flag from the pointers'
    alignment; the mask takes ceil(n / 32) words."""
    from probunet_torch.ops import dropout as D

    x = torch.zeros(3, 5, 7, dtype=torch.bfloat16)
    u = torch.zeros(3, 5, 7)
    bits = D._mask_words(x.numel(), x.device)
    assert bits.dtype == torch.int32 and bits.numel() == -(-105 // 32)
    D._launch(x, u, bits, 0.9, D.ELEMENT_FWD)
    D._launch(x, u[:, :1, :1].reshape(3, 1), None, 0.9, D.ROW)
    flat = torch.zeros(106)
    D._launch(flat[1:].view(3, 5, 7), u, bits, 0.5, D.ELEMENT_FWD)
    for name, args in fake_lib.calls:
        assert name == "probunet_dropout"
        assert len(args) == len(_build._SIGNATURES[name])
    (_, a), (_, r), (_, f) = fake_lib.calls
    keep = np.float32(0.9)
    assert a[4:10] == (105, 1, float(keep), float(np.float32(1) / keep), 1, D.ELEMENT_FWD)
    assert a[10] == int(x.data_ptr() % 16 == 0 and u.data_ptr() % 16 == 0)
    assert r[4:10] == (105, 35, float(keep), float(np.float32(1) / keep), 1, D.ROW)
    assert f[4:11] == (105, 1, 0.5, 2.0, 0, D.ELEMENT_FWD, 0)   # 4 bytes past alignment
    assert _build.launches("dropout") == 0   # counted by the autograd Function, per direction


def test_dropout_refuses_what_the_kernel_cannot_take():
    """A CPU x with uniforms on another device, and the dtypes and shapes
    the kernel does not take, raise a ValueError naming each tensor's shape,
    dtype, strides and device; nothing is launched or counted."""
    from probunet_torch.ops import dropout as D

    _build.reset_launches()
    x = torch.zeros(4, 6)
    cases = [(x.half(), torch.zeros(4, 6), "a dtype"), (x, torch.zeros(4, 6).double(), "a dtype"),
             (x, torch.zeros(4, 6), "one card")]
    for xi, ui, what in cases:
        with pytest.raises(ValueError, match=rf"{what}.*x \(4, 6\) torch\.\w+ strides \(6, 1\) "
                                             rf"on cpu, u \(4, 6\) torch\.\w+ strides"):
            D._operands(xi, ui)
    assert _build.launches("dropout") == 0
