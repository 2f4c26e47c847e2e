"""The attention kernels' launch plans on the CPU, without a card: the bf16
kernels' (``ops/attention.py::plan``) and the fp32 kernels'
(``fp32_plan``). At every attention site of the U-Net's paths and at edge
lengths, each kernel's shared memory fits a block on the H100 (227 KB),
the blocks and tiles take values the kernels are built for, and their
grids cover every row. The plans' shared-memory figures mirror the
kernels' own layouts (FwdSmem, BwdSmem; FwdSmem32, PrepSmem32, DkdvSmem32,
DqSmem32); chip_smoke.py phase 1 holds them against what the built kernels
report on the card. Past head dim 64 the bf16 kernels hold the narrowest
head width built (kD = 80 at the model_channels 96 path's head dim 72, 96,
or 128) and the fp32 kernels 128 columns; the kD = 128 plan stays callable
at every head dim past 64."""

import math

import pytest
import torch

from probunet_torch.config import Config
from probunet_torch.models.unet import build_unet_plan
from probunet_torch.ops import attention as tatt

NUM_SMS = 132


def _attention_sites(res):
    """{(L, heads)} of the default U-Net's attention blocks at res x res."""
    cfg = Config()
    enc, dec, _ = build_unet_plan((res, res), 4, cfg.model_channels, cfg.channel_mult,
                                  cfg.num_blocks, cfg.attn_resolutions)
    return sorted({(int(s.name.split("x")[0]) ** 2, s.out_channels // 64)
                   for s in enc + dec if s.attention})


# (B, L, heads): the 128x128 path at b8 (serving, training), the 256x256
# tile of the spatial path at b4, the 64x64 U-Net's sites down to L=64
PATH = ([(8, L, h) for L, h in _attention_sites(128)]
        + [(4, L, h) for L, h in _attention_sites(256)]
        + [(8, L, h) for L, h in _attention_sites(64)])
EDGE = [(1, 1, 1), (2, 65, 3), (2, 100, 2), (1, 4096, 2), (8, 4096, 8), (1, 127, 2),
        (64, 64, 8)]


def test_path_sites():
    assert _attention_sites(128) == [(256, 8), (1024, 6)]
    assert (4, 1024, 8) in PATH and any(L == 64 for _, L, _ in PATH)


def _check(b, L, heads):
    p = tatt.plan(b, heads, L, NUM_SMS)
    # the block shapes the kernels are built for (with_plan in the sources)
    assert (p.fwd_rows, p.fwd_tile) in {(64, 64), (64, 128), (128, 128)}
    assert p.bwd_rows == 64 and p.bwd_split_rows in (64, 128)
    assert max(p.fwd_smem, p.dkdv_smem, p.dq_smem) <= tatt.SMEM_LIMIT
    # K2: ceil(L / rows) blocks of query rows cover rows 0 .. L-1, each row
    # once; ceil(L / tile) K/V tiles cover every key
    for rows in (p.fwd_rows, p.bwd_rows, p.bwd_split_rows):
        blocks = math.ceil(L / rows)
        covered = [r for blk in range(blocks) for r in range(blk * rows, (blk + 1) * rows) if r < L]
        assert covered == list(range(L))
    tiles = math.ceil(L / p.fwd_tile)
    assert tiles * p.fwd_tile >= L > (tiles - 1) * p.fwd_tile
    # K3's scratch holds every row's lse and D, by 64-row tiles (both dtypes)
    shape = tatt.bwd_scratch_shape(b, heads, L)
    assert shape == (b * heads, math.ceil(L / 64), 2, 64) and shape[1] * 64 >= L
    return p


@pytest.mark.parametrize("b,L,heads", PATH, ids=lambda x: str(x))
def test_plan_fits_every_path_site(b, L, heads):
    p = _check(b, L, heads)
    # 128-row blocks (two consumer warpgroups) where they fill the card
    assert (p.fwd_rows == 128) == (L > 64 and b * heads * math.ceil(L / 128) >= NUM_SMS)
    assert p.bwd_split_rows == p.fwd_rows


@pytest.mark.parametrize("b,L,heads", EDGE, ids=lambda x: str(x))
def test_plan_at_edge_lengths(b, L, heads):
    p = _check(b, L, heads)
    assert p.fwd_tile == (64 if L <= 64 else 128)
    if L <= 64:
        assert p.fwd_rows == p.bwd_split_rows == 64


def test_plan_at_the_u_net_sites():
    """b8, 128x128: K2 takes 128-row blocks at the L=1024, 6-head sites (384
    per call) and 64-row blocks at the L=256, 8-head sites (256 per call,
    where 128 rows would leave 4 of 132 SMs idle); K3 takes 64-row blocks in
    fast mode, and K2's rule with dS split."""
    assert tatt.plan(8, 6, 1024, NUM_SMS)[:4] == (128, 128, 64, 128)
    assert tatt.plan(8, 8, 256, NUM_SMS)[:4] == (64, 128, 64, 64)
    assert tatt.plan(8, 8, 64, NUM_SMS).fwd_tile == 64


def test_plan_is_pure_and_cached():
    assert tatt.plan(8, 6, 1024, NUM_SMS) is tatt.plan(8, 6, 1024, NUM_SMS)
    assert tatt.plan(8, 6, 1024, 16).fwd_rows == 128 and tatt.plan(1, 1, 1024, 16).fwd_rows == 64


def _head_dim_sites(res, mc):
    """{(L, heads, c)} of the U-Net's attention blocks at res x res with
    ``model_channels`` mc: heads = width // 64 of c = width // heads."""
    cfg = Config()
    enc, dec, _ = build_unet_plan((res, res), 4, mc, cfg.channel_mult, cfg.num_blocks,
                                  cfg.attn_resolutions)
    return sorted({(int(s.name.split("x")[0]) ** 2, s.out_channels // 64,
                    s.out_channels // (s.out_channels // 64)) for s in enc + dec if s.attention})


def test_mc96_sites():
    """model_channels 96 at 128x128: 4 heads of 72 at the 288-wide 32x32
    level, 6 of 64 at the 384-wide 16x16 level."""
    assert _head_dim_sites(128, 96) == [(256, 6, 64), (1024, 4, 72)]
    assert _head_dim_sites(128, 128) == [(256, 8, 64), (1024, 6, 64)]


# (B, L, heads, c): the model_channels 96 path at b8 and its 256x256 tile
# at b4, then head dims past 64 at edge lengths
KD128 = ([(8, L, h, c) for L, h, c in _head_dim_sites(128, 96)]
         + [(4, L, h, c) for L, h, c in _head_dim_sites(256, 96)]
         + [(1, 1, 1, 72), (2, 65, 3, 100), (1, 4096, 2, 127), (8, 1024, 1, 96)])


@pytest.mark.parametrize("b,L,heads,c", KD128, ids=lambda x: str(x))
def test_plan_fits_head_dims_past_64(b, L, heads, c):
    """kD = 128 at every head dim past 64: 64-row blocks and tiles (one
    consumer warpgroup: O, dK and dV of 64 x 128 fp32 are 64 registers a
    thread each), every kernel's shared memory under SMEM_LIMIT; at head
    dim 64 the plan of the kD = 64 kernels, unchanged."""
    kd = 64 if tatt.kernel_width(c) == 64 else 128
    p = tatt.plan(b, heads, L, NUM_SMS, kd)
    assert p.kd == kd
    if kd == 64:
        assert p == tatt.plan(b, heads, L, NUM_SMS) == _check(b, L, heads)
        return
    assert (p.fwd_rows, p.fwd_tile, p.bwd_rows, p.bwd_split_rows) == (64, 64, 64, 64)
    assert max(p.fwd_smem, p.dkdv_smem, p.dq_smem) <= tatt.SMEM_LIMIT
    # the kernels' layouts: Q, three stages of K and V; K and V (Q and dO),
    # three stages of two streamed tiles (+ lse and D), the barriers, 1024
    # bytes to align: 64 x 128 bf16 tiles of 16 KB
    assert p.fwd_smem == 16384 * 7 + 8 * 10 + 1024 == 115_792
    assert p.dkdv_smem == 16384 * 8 + 3 * 512 + 8 * 7 + 1024 == 133_688
    assert p.dq_smem == 16384 * 8 + 8 * 7 + 1024 == 132_152


def test_plan_refuses_other_head_widths():
    """The bf16 kernels are built at kd 64, 80, 96 and 128 only."""
    for kd in (32, 72, 112, 256):
        with pytest.raises(ValueError, match=r"kd \(64, 80, 96, 128\)"):
            tatt.plan(8, 4, 1024, NUM_SMS, kd)


def test_kd_of_every_head_dim():
    """Every head dim 1..128 the kernels take gets the narrowest head width
    built that holds its row of kernel_width(c) columns: bf16 kd 64 up to
    64, 80 for 65-80, 96 for 81-96, 128 for 97-128 (the exact widths: 64
    columns and a tail of 16 or 32); fp32 kd 64 or 128, and 256 for the
    fp32 forward's 129-256. No row is wider than its kd, and none fits the
    next narrower one."""
    for c in range(1, 129):
        w = tatt.kernel_width(c)
        kd = tatt._kd(w)
        assert kd == (64 if c <= 64 else 80 if c <= 80 else 96 if c <= 96 else 128), c
        assert kd in tatt.BF16_KDS and w <= kd
        narrower = [k for k in tatt.BF16_KDS if k < kd]
        assert not narrower or w > max(narrower)
        assert tatt._fp32_kd(w) == (64 if c <= 64 else 128)
        assert tatt.plan(8, 4, 1024, NUM_SMS, kd).kd == kd
    for c in range(129, 257):
        w = tatt.kernel_width(c)
        assert tatt._fp32_kd(w) == 256 and 128 < w <= 256 and w % 8 == 0, c


# (B, L, heads, c) at the exact widths: the model_channels 96 path's 32x32
# site at b8 and its 256x256 tile's at b4, then head dims 65-96 at edge
# lengths (one row; a ragged 64-row tile; one 64-row tile; L = 4096)
EXACT = ([(8, L, h, c) for L, h, c in _head_dim_sites(128, 96) if c > 64]
         + [(4, L, h, c) for L, h, c in _head_dim_sites(256, 96) if c > 64]
         + [(1, 1, 1, 72), (2, 65, 3, 65), (2, 100, 2, 80), (2, 64, 4, 88), (1, 4096, 2, 96),
            (8, 1024, 1, 96), (64, 64, 8, 88), (1, 127, 2, 72)])
# the K2 block shapes (block rows, K/V tile rows) built at each exact width
# (attention_fwd.cu with_plan); K3 takes 64-row blocks there in both modes
EXACT_FWD_SHAPES = {80: {(128, 128), (64, 64)}, 96: {(64, 64)}}


@pytest.mark.parametrize("b,L,heads,c", EXACT, ids=lambda x: str(x))
def test_plan_fits_exact_widths(b, L, heads, c):
    """kd = 80 / 96 at every such site: the built shapes, every kernel's
    shared memory under SMEM_LIMIT, grids that cover every row (K2's blocks
    of query rows and K/V tiles, K3's 64-row blocks), and K3's scratch at
    64-row tiles."""
    kd = tatt._kd(tatt.kernel_width(c))
    assert kd in (80, 96)
    p = tatt.plan(b, heads, L, NUM_SMS, kd)
    assert p.kd == kd
    assert (p.fwd_rows, p.fwd_tile) in EXACT_FWD_SHAPES[kd]
    assert p.bwd_rows == p.bwd_split_rows == 64
    assert max(p.fwd_smem, p.dkdv_smem, p.dq_smem) <= tatt.SMEM_LIMIT
    for rows in (p.fwd_rows, p.bwd_rows):
        blocks = math.ceil(L / rows)
        covered = [r for blk in range(blocks) for r in range(blk * rows, (blk + 1) * rows) if r < L]
        assert covered == list(range(L))
    tiles = math.ceil(L / p.fwd_tile)
    assert tiles * p.fwd_tile >= L > (tiles - 1) * p.fwd_tile
    # two consumers only where the second has rows and 128-row blocks fill the card
    if p.fwd_rows == 128:
        assert L > 64 and b * heads * math.ceil(L / 128) >= NUM_SMS
    assert tatt.bwd_scratch_shape(b, heads, L)[1] * 64 >= L


def test_exact_width_plan_layouts():
    """The exact widths' shared bytes as the kernels lay them out: a 64-row
    tile is 64 x kd bf16 (10 KB at kd 80, 12 KB at 96), its 64-column atom
    then its 16- or 32-column tail; K2 holds its blocks' Q tiles and three
    stages of K and V tiles, K3 its two operand tiles and three stages of
    two streamed tiles (+ 512 bytes of lse and D in dK/dV); the barriers
    and 1024 bytes to align. At the model_channels 96 site K2 takes
    128-row blocks and tiles (two consumers), K3 64-row blocks."""
    p = tatt.plan(8, 4, 1024, NUM_SMS, 80)
    assert (p.fwd_rows, p.fwd_tile, p.bwd_rows, p.bwd_split_rows) == (128, 128, 64, 64)
    t80, t96 = 64 * 80 * 2, 64 * 96 * 2
    assert (t80, t96) == (10_240, 12_288)
    assert p.fwd_smem == 2 * t80 + 6 * 2 * t80 + 8 * 10 + 1024 == 144_464
    assert p.dkdv_smem == 2 * t80 + 3 * (2 * t80 + 512) + 8 * 7 + 1024 == 84_536
    assert p.dq_smem == 2 * t80 + 6 * t80 + 8 * 7 + 1024 == 83_000
    p = tatt.plan(8, 4, 1024, NUM_SMS, 96)
    assert (p.fwd_rows, p.fwd_tile, p.bwd_rows, p.bwd_split_rows) == (64, 64, 64, 64)
    assert p.fwd_smem == t96 + 6 * t96 + 8 * 10 + 1024 == 87_120
    assert p.dkdv_smem == 2 * t96 + 3 * (2 * t96 + 512) + 8 * 7 + 1024 == 100_920
    assert p.dq_smem == 2 * t96 + 6 * t96 + 8 * 7 + 1024 == 99_384
    assert tatt.plan(8, 4, 64, NUM_SMS, 80)[:4] == (64, 64, 64, 64)
    assert tatt.plan(1, 1, 1024, NUM_SMS, 80)[:4] == (64, 64, 64, 64)


# ---- the fp32 (3xTF32) kernels' plan ------------------------------------------------------

# (B, L, heads, c): every site above, at both head widths, and edge lengths
FP32_SITES = ([(b, L, h, 64) for b, L, h in PATH + EDGE] + KD128
              + [(1, 1, 1, 127), (2, 100, 2, 80), (1, 2048, 2, 120)])


@pytest.mark.parametrize("b,L,heads,c", FP32_SITES, ids=lambda x: str(x))
def test_fp32_plan_fits_every_site(b, L, heads, c):
    """The fp32 kernels at every site: the plan of their head width (kD 64
    at c <= 64, else 128), every kernel's shared memory under SMEM_LIMIT;
    64-row blocks whose grid covers the rows; streamed tiles that cover L
    and divide the 64-row tiles of K3's lse/D scratch (a q tile's stats are
    one bulk copy from one 64-row tile)."""
    kd = 64 if tatt.kernel_width(c) == 64 else 128
    p = tatt.fp32_plan(kd)
    assert p.kd == kd
    assert max(p.fwd_smem, p.prep_smem, p.dkdv_smem, p.dk_smem, p.dq_smem) <= tatt.SMEM_LIMIT
    assert (p.dk_smem == 0) == (kd == 64)
    blocks = math.ceil(L / 64)
    assert blocks * 64 >= L > (blocks - 1) * 64
    for tile in (p.fwd_tile, p.bwd_tile):
        assert tile in (32, 64) and 64 % tile == 0
        tiles = math.ceil(L / tile)
        assert tiles * tile >= L > (tiles - 1) * tile
        assert tiles * tile <= tatt.bwd_scratch_shape(b, heads, L)[1] * 64


def test_fp32_plan_layouts():
    """The fp32 kernels' layouts (64 x kd fp32 tiles: 16 KB at kd 64, 32 KB
    at kd 128; 1024 bytes to align; two barriers for the block's own tiles
    and five a stage): K2 holds Q's hi / lo pair and per stage K's pair, V
    as it lands and V^T's pair; the row pass dO's and O's pairs; K3's dK/dV
    kernel K's and V's pairs and per stage Q's, dO's, Q^T's and dO^T's
    pairs (the dV pass at kd 128: K's pair; Q's pair, dO as it lands, dO^T's
    pair; the dK pass: no dO^T) and the stage's lse2 and D; dQ Q's and dO's
    pairs and per stage K's, V's and K^T's pairs. Stages: at kd 64, two for
    K2 and one for K3's kernels; at kd 128, two for K2 and the dV pass, one
    for the dK pass and dQ."""
    t64, t128 = 64 * 64 * 4, 64 * 128 * 4
    p = tatt.fp32_plan(64)
    assert (p.fwd_tile, p.bwd_tile) == (64, 64)
    assert p.fwd_smem == 2 * t64 + 2 * 5 * t64 + 16 + 2 * 40 + 1024 == 197_728
    assert p.prep_smem == 4 * t64 + 8 + 1024 == 66_568
    assert p.dkdv_smem == 4 * t64 + 8 * t64 + 8 * 64 + 16 + 40 + 1024 == 198_200
    assert p.dq_smem == 4 * t64 + 6 * t64 + 16 + 40 + 1024 == 164_920
    p = tatt.fp32_plan(128)
    half = t128 // 2   # a 32-row tile at kd 128
    assert (p.fwd_tile, p.bwd_tile) == (32, 32)
    assert p.fwd_smem == 2 * t128 + 2 * 5 * half + 16 + 2 * 40 + 1024 == 230_496
    assert p.prep_smem == 4 * t128 + 8 + 1024 == 132_104
    assert p.dkdv_smem == 2 * t128 + 2 * 5 * half + 2 * 8 * 32 + 16 + 2 * 40 + 1024 == 231_008
    assert p.dk_smem == 4 * t128 + 6 * half + 8 * 32 + 16 + 40 + 1024 == 230_712
    assert p.dq_smem == 4 * t128 + 6 * half + 16 + 40 + 1024 == 230_456


def test_fp32_plan_at_kd256():
    """The fp32 forward at kd 256 (CorrDiff's one 256-wide head): Q's hi /
    lo pair (64 x 256 fp32, 64 KB each), then four slots of three 32-row
    tiles of 64 head columns (8 KB each: the chunk as it lands, K's lo or
    V^T's pair), five barriers a slot and two for Q: under SMEM_LIMIT, as
    csrc/attention_fwd.cu (WideSmem32) lays it out. 32-row K/V tiles cover
    any L; no backward is built, so its fields are 0."""
    p = tatt.fp32_plan(256)
    chunk = 32 * 64 * 4
    assert (p.kd, p.fwd_tile) == (256, 32)
    assert p.fwd_smem == 2 * 64 * 256 * 4 + 4 * 3 * chunk + 16 + 4 * 40 + 1024 == 230_576
    assert p.fwd_smem <= tatt.SMEM_LIMIT
    assert (p.bwd_tile, p.prep_smem, p.dkdv_smem, p.dk_smem, p.dq_smem) == (0, 0, 0, 0, 0)
    assert tatt._rows(torch.zeros(2, 784, 1, 256))[:2] == (64, 32)
    assert tatt._rows(torch.zeros(2, 784, 1, 256))[3] == 256


def test_fp32_plan_is_pure_and_cached():
    assert tatt.fp32_plan(64) is tatt.fp32_plan(64)
    assert tatt.fp32_plan(128) is tatt.fp32_plan(128) and tatt.fp32_plan(128).kd == 128


@pytest.mark.parametrize("kd", [32, 72, 96, 512])
def test_fp32_plan_refuses_other_head_widths(kd):
    with pytest.raises(ValueError, match="kd 64, 128 and 256"):
        tatt.fp32_plan(kd)
