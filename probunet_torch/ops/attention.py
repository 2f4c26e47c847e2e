"""Fused self-attention — kernels K2 (forward) and K3 (backward) of the port.

``fused_attention`` launches the hand-written CUDA kernel
``csrc/attention_fwd.cu`` for CUDA tensors and runs :func:`_plain_attention`,
the math of ``probunet_tpu/ops/pallas_attn.py::_xla_attention``, for CPU
tensors. When an input requires a gradient it goes through an
``autograd.Function`` whose backward is :func:`attention_bwd`: the CUDA
kernel ``csrc/attention_bwd.cu`` for CUDA tensors, :func:`_plain_attention_bwd`
(the unchunked math of ``pallas_attn.py::_bwd_kernel``) for CPU tensors. K2
replaces ``pallas_attn.py::_fwd_kernel``, K3 ``pallas_attn.py::_bwd_kernel``;
the source note in each ``.cu`` file gives its bound and design. Both run
on Hopper's TMA and wgmma, warp-specialised: bf16 operands directly, fp32
operands in 3xTF32 (each split once per block into tf32 hi and lo, and
transposed where a product contracts over a tile's rows, by a producer
warpgroup). The bf16 kernels take their block sizes from :func:`plan`, the
fp32 kernels from :func:`fp32_plan`.

Head dims: the kernels hold a head in shared memory ``kD`` columns wide,
so they take any head dim c up to 128, every one the ADM U-Net builds (a
width C gives C // 64 heads of C // (C // 64) channels, 64..127), and the
fp32 forward up to 256 (the DDPM++ U-Net's one head of 256 channels at
CorrDiff's 28x28 level, :data:`MAX_HEAD_DIM`); the backward kernels stop
at 128 (:data:`MAX_BWD_HEAD_DIM`) and raise past it. The bf16
kernels are built at kD = 64, 80, 96 and 128 and take the narrowest that
holds the row (:func:`_kd`): c = 64 runs kD = 64; 64 < c <= 96 (72 at
``--model_channels 96``) the exact-width kD = 80 / 96, a 64-column atom
and a 16- or 32-column one; 96 < c <= 128 kD = 128. The fp32 kernels are
built at kD = 64 and 128 (:func:`_fp32_kd`), and the fp32 forward at kD =
256, which streams K and V through shared memory 64 head columns at a time
(csrc/attention_fwd.cu, ``attention_fwd_f32_wide``). Columns from c to kD - 1 are
zeros in shared memory, which leave QK^T unchanged and give zero columns
in O, dQ, dK and dV that are never stored. The kernels read rows of whole
16-byte bf16 chunks (:func:`kernel_width`): a view of another width is
copied, zero-padded, first (:func:`kernel_layout`), and the results are
its first c columns. The CPU's plain versions take any c.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from probunet_torch.ops import _build

#: the widest head dim the kernels take: the fp32 forward's kD = 256
#: instantiation; bf16 operands and the backward stop at MAX_BWD_HEAD_DIM
MAX_HEAD_DIM = 256
#: the widest head dim of the bf16 kernels and of the backward (kD = 128)
MAX_BWD_HEAD_DIM = 128
#: the head widths kD the bf16 kernels are built for
BF16_KDS = (64, 80, 96, 128)
#: shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232_448
_FWD_STAGES = _BWD_STAGES = 3


def kernel_width(c: int) -> int:
    """The columns per row that the kernels read for head dim ``c``: 64 up
    to 64 (the kD = 64 kernels, narrower heads zero-padded to 64), else
    ``c`` rounded up to whole 16-byte bf16 chunks, 8 columns."""
    return 64 if c <= 64 else -(-c // 8) * 8


def _kd(width: int) -> int:
    """The bf16 kernels' shared-memory head width for rows of ``width``
    columns: the narrowest of :data:`BF16_KDS` that holds them."""
    return next((kd for kd in BF16_KDS if width <= kd), MAX_BWD_HEAD_DIM)


def _fp32_kd(width: int) -> int:
    """The fp32 kernels' head width for rows of ``width`` columns (64, 128,
    256)."""
    return 64 if width <= 64 else 128 if width <= 128 else 256


def _tile_bytes(kd: int, rows: int = 64, itemsize: int = 2) -> int:
    """A tile of ``rows`` rows at head width kd in shared memory: bf16, kd / 64
    atoms of rows x 128 bytes; fp32 (itemsize 4), kd / 32 atoms."""
    return rows * kd * itemsize


class Plan(NamedTuple):
    """How a bf16 call is cut. K2: blocks of ``fwd_rows`` query rows (64
    per consumer warpgroup) against K/V tiles of ``fwd_tile`` rows. K3: the
    dK/dV kernel's blocks of key rows and the dQ kernel's of query rows,
    against streamed 64-row tiles: ``bwd_rows`` in fast mode,
    ``bwd_split_rows`` in strict mode (dS carried as two bf16 terms). The
    ``*_smem`` fields are each kernel's dynamic shared bytes at those block
    sizes, as csrc/attention_fwd.cu (FwdSmem) and csrc/attention_bwd.cu
    (BwdSmem) lay them out; ``kd`` is the head width the kernels are
    instantiated for (:data:`BF16_KDS`), which the C entry points take."""

    fwd_rows: int
    fwd_tile: int
    bwd_rows: int
    bwd_split_rows: int
    fwd_smem: int
    dkdv_smem: int
    dq_smem: int
    kd: int = 64


def _bwd_smem(rows: int, stats: bool, kd: int = 64) -> int:
    tile = _tile_bytes(kd)
    return (2 * rows // 64 * tile + _BWD_STAGES * (2 * tile + (512 if stats else 0))
            + 8 * (1 + 2 * _BWD_STAGES) + 1024)


def _fwd_smem(rows: int, tile_rows: int, kd: int = 64) -> int:
    return (rows // 64 * _tile_bytes(kd) + 2 * _FWD_STAGES * tile_rows * kd * 2
            + 8 * (1 + 3 * _FWD_STAGES) + 1024)


@functools.lru_cache(maxsize=None)
def plan(b: int, heads: int, L: int, num_sms: int, kd: int = 64) -> Plan:
    """The bf16 kernels' block sizes for one shape; pure and cached.

    Measured on the H100 (scripts/torch_attn_timing.py --plans): K2 takes
    128-row blocks (two consumer warpgroups) where they give every SM a
    block, else 64-row blocks (one consumer), which double the blocks (at
    b8, L=256, 8 heads, 128 rows give 128 blocks for 132 SMs); it streams
    128-row K/V tiles unless L fits one 64-row tile, and then takes 64-row
    blocks (a second consumer would have no rows). K3 in fast mode takes
    64-row blocks, two of which share an SM; with dS split, whose consumers
    hold more registers and fit one block per SM either way, the rule of
    K2's blocks. These are the shapes the kernels are built for.

    kd = 80 and 96 (the exact widths of 64 < c <= 96): at kd = 80 K2 takes
    128-row blocks and tiles where they fill the card (two consumers: 167
    registers, no spill; 32.2 us against 44.3 for 64-row blocks and tiles
    at the model_channels 96 site, b8, L=1024, 4 heads of 72, measured the
    same way), else 64-row blocks and tiles (126 registers). At kd = 96 two
    consumers spill, and K2 takes 64-row blocks and tiles (137 registers,
    two blocks an SM; 128-row tiles would hold 185 and leave one block an
    SM by shared memory). K3 takes 64-row blocks in both modes: its
    one-pass dK/dV consumer holds dK and dV of 64 x kd fp32 (40 / 48
    registers a thread each) beside S^T, dP^T and their A operands, 188 /
    204 registers, past the 168 that ptxas leaves each thread of a
    two-consumer block.

    At kd = 128 every kernel takes 64-row blocks (one consumer warpgroup)
    and 64-row tiles, the one shape built: a consumer's fp32 accumulators
    of 64 x 128 are 64 registers a thread each (K2's O; dK and dV in K3,
    which runs them in two passes), and K2's consumer holds 155 registers
    (chip_smoke.py phase 16); 128-row tiles would add 32 for S, past the
    168 that ptxas leaves each thread of a two-consumer block."""
    if kd not in BF16_KDS:
        raise ValueError(f"the bf16 attention kernels are built for kd {BF16_KDS}, not {kd}")
    if kd == 128:
        return Plan(64, 64, 64, 64, fwd_smem=_fwd_smem(64, 64, kd),
                    dkdv_smem=_bwd_smem(64, True, kd), dq_smem=_bwd_smem(64, False, kd), kd=kd)
    fill = L > 64 and b * heads * math.ceil(L / 128) >= num_sms  # 128-row blocks fill the card
    if kd == 64:
        tile = 128 if L > 64 else 64
        rows = 128 if fill else 64
    else:  # kd 80: two consumers where they fill the card; kd 96: one
        rows = tile = 128 if fill and kd == 80 else 64
    split_rows = rows if kd == 64 else 64
    return Plan(rows, tile, 64, split_rows, fwd_smem=_fwd_smem(rows, tile, kd),
                dkdv_smem=max(_bwd_smem(64, True, kd), _bwd_smem(split_rows, True, kd)),
                dq_smem=max(_bwd_smem(64, False, kd), _bwd_smem(split_rows, False, kd)), kd=kd)


class Fp32Plan(NamedTuple):
    """How an fp32 call is cut, at head width ``kd``: K2 streams K/V tiles of
    ``fwd_tile`` rows, K3's dK/dV and dQ kernels tiles of ``bwd_tile`` rows
    (q tiles, K/V tiles). Every block holds 64 rows of its own and runs one
    consumer and one producer warpgroup. The ``*_smem`` fields are each
    kernel's dynamic shared bytes, as csrc/attention_fwd.cu (FwdSmem32) and
    csrc/attention_bwd.cu (PrepSmem32, DkdvSmem32, DqSmem32) lay them out
    (chip_smoke.py phase 1 holds them against the built kernels); ``dk_smem``
    is 0 where there is no dK pass, and the backward's fields are 0 at kd =
    256, where only the forward is built. The tile rows go to the C entry
    points, which refuse any but the ones built."""

    fwd_tile: int
    bwd_tile: int
    fwd_smem: int
    prep_smem: int
    dkdv_smem: int
    dk_smem: int
    dq_smem: int
    kd: int


def _ring32_bytes(stages: int) -> int:
    """The barriers of an fp32 kernel: two for its own tiles, five a stage."""
    return 16 + 40 * stages


def _f32_fwd_smem(kd: int, tile: int, stages: int) -> int:
    # Q's hi / lo pair; per stage K's pair, V as it lands, V^T's pair
    return (2 * _tile_bytes(kd, 64, 4) + stages * 5 * _tile_bytes(kd, tile, 4)
            + _ring32_bytes(stages) + 1024)


def _f32_dkdv_smem(kd: int, tile: int, stages: int, dv: bool, dk: bool) -> int:
    # K's pair (and V's with dK); per stage Q's pair, dO's pair (dK) or dO as
    # it lands, Q^T's pair (dK), dO^T's pair (dV); per stage lse2 and D
    tiles = 2 + (2 if dk else 1) + (2 if dk else 0) + (2 if dv else 0)
    return ((4 if dk else 2) * _tile_bytes(kd, 64, 4) + stages * tiles * _tile_bytes(kd, tile, 4)
            + stages * 8 * tile + _ring32_bytes(stages) + 1024)


def _f32_dq_smem(kd: int, tile: int, stages: int) -> int:
    # Q's and dO's pairs; per stage K's, V's and K^T's pairs
    return (4 * _tile_bytes(kd, 64, 4) + stages * 6 * _tile_bytes(kd, tile, 4)
            + _ring32_bytes(stages) + 1024)


def _f32_wide_smem(kd: int, tile: int, slots: int) -> int:
    # Q's hi / lo pair; per slot a 64-column chunk of a tile three times (as
    # it lands, then K's lo or V^T's hi and lo)
    return (2 * _tile_bytes(kd, 64, 4) + slots * 3 * _tile_bytes(64, tile, 4)
            + _ring32_bytes(slots) + 1024)


@functools.lru_cache(maxsize=None)
def fp32_plan(kd: int) -> Fp32Plan:
    """The fp32 kernels' tiles at head width ``kd`` (64, 128 or 256,
    :func:`_fp32_kd`); pure and cached. One shape per width, the one built
    (with_plan in the sources).

    kd = 64: 64-row K/V tiles in two stages for K2 (193 KB); one stage of
    64-row tiles for K3's dK/dV kernel (each q tile's Q and dO as hi / lo
    pairs, K-major and transposed: 128 KB) and its dQ kernel. kd = 128: a
    64 x 128 fp32 tile's pair is 32 KB, so K2 streams 32-row tiles in two
    stages (its consumer holds O and a tile's P V, 64 registers a thread
    each), and K3 32-row tiles, dK and dV in two passes over them: the dV
    pass in two stages; the dK pass, whose block holds K's and V's pairs,
    and dQ in one. kd = 256 (the forward only): Q's pair takes 128 KB, and
    K and V stream through four slots of 64 head columns of 32-row tiles
    (24 KB each: the chunk as it lands, and its pair), 225 KB in all."""
    if kd == 64:
        return Fp32Plan(64, 64, fwd_smem=_f32_fwd_smem(64, 64, 2),
                        prep_smem=4 * _tile_bytes(64, 64, 4) + 8 + 1024,
                        dkdv_smem=_f32_dkdv_smem(64, 64, 1, True, True), dk_smem=0,
                        dq_smem=_f32_dq_smem(64, 64, 1), kd=64)
    if kd == 128:
        return Fp32Plan(32, 32, fwd_smem=_f32_fwd_smem(128, 32, 2),
                        prep_smem=4 * _tile_bytes(128, 64, 4) + 8 + 1024,
                        dkdv_smem=_f32_dkdv_smem(128, 32, 2, True, False),
                        dk_smem=_f32_dkdv_smem(128, 32, 1, False, True),
                        dq_smem=_f32_dq_smem(128, 32, 1), kd=128)
    if kd == 256:
        return Fp32Plan(32, 0, fwd_smem=_f32_wide_smem(256, 32, 4), prep_smem=0, dkdv_smem=0,
                        dk_smem=0, dq_smem=0, kd=256)
    raise ValueError(f"the fp32 attention kernels are built for kd 64, 128 and 256, not {kd}")


def bwd_scratch_shape(b: int, heads: int, L: int):
    """The fp32 scratch K3 takes (either dtype): per 64-row tile, the
    forward's lse in base 2 and D, padded to whole tiles."""
    return (b * heads, math.ceil(L / 64), 2, 64)


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fast: bool) -> torch.Tensor:
    """softmax(Q (K/sqrt(c))^T) V on (B, L, heads, c), unfused. Strict: fp32
    logits and softmax (run it with TF32 off); fast: logits in q's dtype,
    fp32 softmax. The weights are cast to q's dtype before PV."""
    c = k.shape[-1]
    if fast:
        w = torch.einsum("bqhc,bkhc->bhqk", q, (k / math.sqrt(c)).to(q.dtype))
        w = torch.softmax(w.float(), dim=-1).to(q.dtype)
    else:
        w = torch.einsum("bqhc,bkhc->bhqk", q.float(), (k / math.sqrt(c)).float())
        w = torch.softmax(w, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhc->bqhc", w, v)


def _plain_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                         fast: bool):
    """(dq, dk, dv) of :func:`_plain_attention` for the output gradient
    ``do``, by the math of ``_bwd_kernel`` over all rows at once: fp32
    logits and weights, the dV/dP legs on model-dtype operands, dS rounded
    to q's dtype only when ``fast``, fp32 sums throughout (run it with TF32
    off), results cast to the input dtypes."""
    scale = 1.0 / math.sqrt(k.shape[-1])
    # _prep: bf16 operands multiply exactly in fp32, so fp32 einsums of the
    # rounded operands are the kernel's bf16 products with fp32 accumulation
    k2 = (k * scale).to(q.dtype) if fast else k.float() * scale
    p = torch.softmax(torch.einsum("bqhc,bkhc->bhqk", q.float(), k2.float()), dim=-1)
    pc = p.to(v.dtype).float()
    dof = do.to(v.dtype).float()
    dv = torch.einsum("bhqk,bqhc->bkhc", pc, dof)
    dp = torch.einsum("bqhc,bkhc->bhqk", dof, v.float())
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if fast:
        ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhc->bqhc", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhc->bkhc", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kernel_layout(a: torch.Tensor) -> torch.Tensor:
    """``a`` as the kernels read it: a (B, L, heads, w) tensor with w =
    :func:`kernel_width` of its head dim, a unit-stride head dim and
    16-byte-aligned rows, any other strides. The U-Net block's q/k/v views
    of its qkv conv output already are (at every width the U-Net builds:
    c = 72 gives bf16 rows of 9 chunks), and pass as they are; any other
    view is copied to a new contiguous tensor (not ``contiguous()``, which
    keeps a contiguous but misaligned view), its columns past c zeros where
    w > c. This is layout normalisation, not a fallback: the kernel runs
    either way. Each copy counts under ``("kernel_layout",)`` in
    ``_build.LAUNCHES``."""
    if _in_place(a):
        return a
    _build.LAUNCHES[("kernel_layout",)] += 1
    c, w = a.shape[-1], kernel_width(a.shape[-1])
    if w == c:
        return a.clone(memory_format=torch.contiguous_format)
    out = a.new_zeros(*a.shape[:-1], w)
    out[..., :c] = a
    return out


def _in_place(a: torch.Tensor) -> bool:
    size = a.element_size()
    return (a.shape[-1] == kernel_width(a.shape[-1]) and a.stride(-1) == 1
            and a.data_ptr() % 16 == 0 and all(s * size % 16 == 0 for s in a.stride()[:-1]))


def _first_columns(a: torch.Tensor, c: int) -> torch.Tensor:
    """A kernel result's first ``c`` columns, contiguous (a copy only where
    the inputs were zero-padded past c)."""
    return a if a.shape[-1] == c else a[..., :c].contiguous()


def _strides(*tensors):
    """The (b, l, h) element strides of each (B, L, heads, w) tensor, in
    order, as the kernels' C entry points take them; raises on a tensor the
    kernels cannot read in place (see :func:`kernel_layout`)."""
    out = []
    for a in tensors:
        if not _in_place(a):
            raise ValueError(f"the attention kernels read (B, L, heads, w) tensors with a "
                             f"unit-stride head dim of kernel_width(c) columns and 16-byte-"
                             f"aligned rows, got shape {tuple(a.shape)}, strides "
                             f"{tuple(a.stride())}; pass it through kernel_layout first")
        out.extend(a.stride()[:3])
    return out


def _check_cuda(q, k, v):
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention kernels take fp32 or bf16 q/k/v of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    widest = MAX_HEAD_DIM if q.dtype == torch.float32 else MAX_BWD_HEAD_DIM
    if q.shape[-1] > widest:
        raise ValueError(f"the {'fp32' if widest == MAX_HEAD_DIM else 'bf16'} attention kernels "
                         f"take head dims up to {widest}, got q of shape {tuple(q.shape)}")


def _check_bwd_width(c: int) -> None:
    if c > MAX_BWD_HEAD_DIM:
        raise NotImplementedError(
            f"the attention backward kernels (K3, csrc/attention_bwd.cu) are built for head "
            f"dims up to {MAX_BWD_HEAD_DIM}, got {c}: there is no kD = 256 backward, so a "
            f"head this wide runs forward only (sampling)")


def _rows(q: torch.Tensor, fast: bool = False, kd: Optional[int] = None):
    """(K2's block rows, its K/V tile rows, K3's rows, kd) of a launch on q
    (B, L, heads, w), as the C entry points take them: for bf16 from
    :func:`plan` (K3's block rows in fast or strict mode), for fp32 from
    :func:`fp32_plan` (64-row blocks; K3's streamed tile rows). ``kd`` is
    the head width of the kernels to run: by default the narrowest built
    that holds w (:func:`_kd`, :func:`_fp32_kd`); a wider one (the kD = 128
    kernels at c <= 96, to compare) or one not built reaches the plan,
    which refuses what is not built, and the entry points, which refuse a
    kd narrower than w."""
    b, L, h, w = q.shape
    if q.dtype == torch.float32:
        p = fp32_plan(_fp32_kd(w) if kd is None else kd)
        return 64, p.fwd_tile, p.bwd_tile, p.kd
    p = plan(b, h, L, _build.num_sms(q.device.index), _kd(w) if kd is None else kd)
    return p.fwd_rows, p.fwd_tile, p.bwd_rows if fast else p.bwd_split_rows, p.kd


@torch.no_grad()
def _launch(q, k, v, with_lse: bool, c: Optional[int] = None, kd: Optional[int] = None):
    """K2 on q/k/v as they lie (see :func:`kernel_layout`), rows of w
    columns of which the first ``c`` (default w) are the head dim, the
    rest zeros: (out, lse), out (B, L, heads, w), lse the (B*H, L) fp32 row
    log-sum-exp of the logits when ``with_lse``, else None (the kernel then
    writes no more than out). ``kd``: the kernels' head width (see
    :func:`_rows`)."""
    b, L, h, w = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have the same shape")
    strides = _strides(q, k, v)
    c = w if c is None else c
    out = torch.empty(b, L, h, w, device=q.device, dtype=q.dtype)
    lse = torch.empty(b * h, L, device=q.device, dtype=torch.float32) if with_lse else None
    rows, tile, _, kd = _rows(q, kd=kd)
    bf16 = q.dtype == torch.bfloat16
    code = _build.lib().probunet_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, b, h, L, w, *strides,
        1.0 / math.sqrt(c), int(bf16), rows, tile, kd, _build.stream_handle(q.device))
    _build.check(code, "attention kernel")
    _build.LAUNCHES["attention_fwd", "bf16" if bf16 else "fp32", kd] += 1
    return out, lse


@torch.no_grad()
def _launch_bwd(q, k, v, out, lse, do, fast: bool, c: Optional[int] = None,
                kd: Optional[int] = None):
    """K3 on q/k/v/out/do as they lie (see :func:`kernel_layout`), rows of w
    columns of which the first ``c`` (default w) are the head dim: (dq, dk,
    dv), contiguous (B, L, heads, w). ``kd``: the kernels' head width (see
    :func:`_rows`)."""
    b, L, h, w = q.shape
    if any(a.shape != q.shape for a in (k, v, out, do)):
        raise ValueError("q, k, v, out and do must have the same shape")
    strides = _strides(q, k, v, out, do)
    c = w if c is None else c
    lse = lse.contiguous()
    scratch = torch.empty(bwd_scratch_shape(b, h, L), device=q.device, dtype=torch.float32)
    dq, dk, dv = (torch.empty(b, L, h, w, device=q.device, dtype=q.dtype) for _ in range(3))
    _, _, rows, kd = _rows(q, fast, kd)
    bf16 = q.dtype == torch.bfloat16
    code = _build.lib().probunet_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, L, w, *strides, 1.0 / math.sqrt(c), int(bf16), int(fast), rows, kd,
        _build.stream_handle(q.device))
    _build.check(code, "attention backward kernel")
    _build.LAUNCHES["attention_bwd", "bf16" if bf16 else "fp32", kd] += 1
    return dq, dk, dv


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: Optional[torch.Tensor],
                  lse: Optional[torch.Tensor], do: torch.Tensor, fast: bool = False,
                  c: Optional[int] = None):
    """(dq, dk, dv) of ``fused_attention(q, k, v, fast)`` for the output
    gradient ``do``, each (B, L, heads, c) in its input's dtype. CPU
    tensors take :func:`_plain_attention_bwd` (``out`` and ``lse`` unused);
    CUDA tensors launch kernel K3 on ``out`` (the forward kernel's output,
    c or kernel_width(c) columns) and the forward kernel's ``lse``, or
    raise. ``c`` is the head dim where q/k/v are already the kernels'
    zero-padded copies (default: their width)."""
    if q.device.type == "cpu":
        return _plain_attention_bwd(q, k, v, do, fast)
    if q.device.type != "cuda":
        raise RuntimeError(f"attention_bwd has no path for device {q.device}")
    _check_cuda(q, k, v)
    _check_bwd_width(q.shape[-1] if c is None else c)
    return _kernel_bwd(q, k, v, out, lse, do, fast, c)


def _kernel_bwd(q, k, v, out, lse, do, fast: bool, c: Optional[int] = None):
    """:func:`attention_bwd`'s CUDA path on tensors of any layout: each
    through :func:`kernel_layout`, K3, then the results' first ``c``
    columns."""
    b, L, h, w = q.shape
    c = w if c is None else c
    if out is None or lse is None or out.shape[:3] != q.shape[:3] or out.dtype != q.dtype \
            or lse.shape != (b * h, L) or lse.dtype != torch.float32:
        raise ValueError("attention_bwd needs the forward kernel's output "
                         "and its (B*heads, L) fp32 lse")
    q, k, v, out, do = map(kernel_layout, (q, k, v, out, do.to(q.dtype)))
    return tuple(_first_columns(g, c) for g in _launch_bwd(q, k, v, out, lse, do, fast, c))


class _FusedAttention(torch.autograd.Function):
    """K2 forward (saving its output and row log-sum-exp), K3 backward."""

    @staticmethod
    def forward(ctx, q, k, v, fast):
        ctx.c = c = q.shape[-1]
        if q.device.type == "cpu":
            out, lse = _plain_attention(q, k, v, fast), None
        else:
            q, k, v = map(kernel_layout, (q, k, v))
            out, lse = _launch(q, k, v, with_lse=True, c=c)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.fast = fast
        return _first_columns(out, c)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*attention_bwd(q, k, v, out, lse, do, ctx.fast, ctx.c), None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    fast: bool = False) -> torch.Tensor:
    """softmax(Q K^T / sqrt(c)) V without materializing the weights.

    q, k, v: (B, L, heads, c); CUDA tensors take c up to 128 (every head
    dim the ADM U-Net builds), and fp32 ones up to 256 in the forward (the
    backward raises past 128). The kernels read them where they lie when the
    head dim is unit-stride and rows are whole, 16-byte-aligned bf16 chunks,
    as in the U-Net block's views of its qkv conv output; other views (the
    stride-3 views of an interleaved qkv tensor, say, or a width that is
    not a multiple of 8) are copied first (:func:`kernel_layout`). Returns
    a contiguous (B, L, heads, c) tensor in q's dtype: fp32 in strict mode,
    bf16 with ``fast``. Differentiable: the backward is
    :func:`attention_bwd`, whose gradients come back in the inputs' dtypes.
    CPU tensors take the plain versions; CUDA tensors launch the kernels or
    raise."""
    if q.ndim != 4:
        raise ValueError(f"fused_attention takes (B, L, heads, c), got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have the same shape")
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"fused_attention has no path for device {q.device}")
    if q.device.type == "cuda":
        # The forward kernel's numerics follow the dtype: fp32 operands give
        # the strict math, bf16 operands the fast math (in strict mode with
        # bf16 activations both agree where K / sqrt(c) is exact in bf16, as
        # at c = 64).
        _check_cuda(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FusedAttention.apply(q, k, v, fast)
    if q.device.type == "cpu":
        return _plain_attention(q, k, v, fast)
    c = q.shape[-1]
    return _first_columns(_launch(*map(kernel_layout, (q, k, v)), with_lse=False, c=c)[0], c)
