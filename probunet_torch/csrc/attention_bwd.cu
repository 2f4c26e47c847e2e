// Fused self-attention backward: the gradients of O = softmax(Q (K s)^T) V,
// s = 1/sqrt(c) for a head dim c up to 128, with respect to Q, K and V;
// kernel K3 of the port, for Hopper (sm_90a), deterministic.
//
// Replaces probunet_tpu/ops/pallas_attn.py::_bwd_kernel (launched by
// _bwd_pallas). That kernel walks 256-row q chunks along a sequential grid
// axis and accumulates dK and dV across them in its output block
// (pl.when(ci == 0) zeroes it first). Hopper blocks run in no order, so the
// work is cut into kernels that each own what they write:
//   (a) the row pass D = rowsum(dO o O), one block per (batch * head,
//       64-row tile);
//   (b) dK/dV: one block per (batch * head, block of key rows) loops over
//       the q tiles and keeps dK and dV in registers;
//   (c) dQ: one block per (batch * head, block of query rows) loops over
//       the K/V tiles and keeps dQ in registers.
// (b) and (c) recompute the weights as P = exp(S s - lse) from the row
// log-sum-exp that the forward kernel (attention_fwd.cu) saved, so no
// (L, L) tensor reaches device memory; like the forward kernel they take
// the exponential in base 2 by the SFU's ex2 (about 2 ulp).
//
// Deterministic: every sum runs in one order fixed by the code, and each
// output element is written by one thread of one block, with no atomics;
// dQ in particular is summed over the K/V tiles inside one block (c), in
// tile order, so two calls give the same bits (chip_smoke.py phase 7 and
// tests/test_torch_cuda.py check it). This costs seven L x L x c
// products where five suffice (S and dP are recomputed in (c)). The
// five-product design, each dK/dV block also computing dS K for its keys
// (dS staged in shared memory, read MN-major) and adding it into an fp32
// scratch in a fixed order under a per-q-tile counter, ran 4.3x slower on
// the H100 (0.51 against 0.12 ms at L=1024, 6 heads, b8: every share
// waits for the one before it), and was dropped.
//
// Bound: operations, 10 * B * heads * L^2 * c FLOP (the TPU kernel's five
// L x L x c products: S, dV, dP, dQ, dK), against the H100's 989 TFLOP/s
// of bf16 tensor-core products (fast mode) or, in strict mode, the smaller
// of the fp32 CUDA-core time (67 TFLOP/s) and three TF32 products (495
// TFLOP/s). At the U-Net's sites (b8: L=1024 with 6 heads, L=256 with 8)
// the bf16 bound is 0.19 ms per backward of 11 sites.
//
// Head dims: as in the forward kernel, every kernel is instantiated for a
// head KD columns wide in shared memory (attention_hopper.cuh): bf16 at KD
// = 64, the exact widths 80 and 96 (64 < c <= 96: a 64-column atom and a
// 16- or 32-column tail atom) and 128 (96 < c <= 128); fp32 at 64 and 128,
// the columns past c zero. The bound at the model_channels 96 path's c = 72
// site (b8, L=1024, 4 heads) is 24 GFLOP, 24.4 us at 989 TFLOP/s.
//   KD = 128 runs the products over 128 columns where 72 are real, and (b)
//   as two passes over the q tiles, one for dV and one for dK, each
//   recomputing S^T: dK and dV of 64 keys by 128 columns are 128 fp32
//   registers a thread together, which beside S^T, dP^T and their A
//   operands would spill (bf16), and whose operands' hi / lo pairs would not
//   fit the block's shared memory (fp32).
//   KD = 80 / 96 (bf16) run S^T, dP^T, S and dP in KD / 16 k16 steps, each
//   output product as one m64n64k16 and one m64nTk16, and (b) as one pass
//   (kPassBoth, as at KD = 64): dK and dV are 80 / 96 registers a thread,
//   the consumer holds 188 / 204, none spilled. 64-row blocks of one
//   consumer (two would be held to 168), two blocks an SM at KD = 80 (one
//   at 96, by registers). What still holds it back: the serial order below,
//   the tail's m64nTk16 products, which cost about what a whole-atom
//   product does (dK/dV at KD = 80 took 66 us with them, 51 without, on an
//   H100), and dQ at 143 / 156 registers, two blocks an SM where KD = 64's
//   fits three (asking ptxas for three holds it to 128 registers, which
//   spills and serializes the products).
//
// bf16 (fast, and strict with bf16 activations): the machinery of
// attention_hopper.cuh, warp-specialised as the forward kernel:
//   (a) attention_bwd_prep_sm90: D on the CUDA cores in fp32, four threads
//       per row; it writes D and the forward's lse in base 2 into a padded
//       (batch * head, tile, 2, 64) fp32 scratch, rows past L as lse = +inf
//       (so P = 0 there) and D = 0;
//   (b) attention_bwd_dkdv_sm90: a producer warp loads the block's K and V
//       once and keeps TMA loads of 64-row Q and dO tiles, with their lse
//       and D (one bulk copy), in flight through a ring of kBwdStages
//       stages; consumer warpgroups of 64 keys compute S^T = K Q^T and
//       dP^T = V dO^T on wgmma with both operands K-major in shared memory;
//       P^T and dS^T stay in registers as the A operands of dV += P^T dO
//       and dK += dS^T Q, with dO and Q read MN-major;
//   (c) attention_bwd_dq_sm90: the same ring of 64-row K and V tiles
//       against the block's Q and dO: S = Q K^T, dP = dO V^T, then dQ += dS
//       K with dS in registers and K read MN-major.
//   K/V rows past L arrive as zeros (the TMA box is clipped by the map), so
//   their terms vanish in dQ, and the rows they give dK and dV are not
//   stored; no tile needs a mask. Block sizes come from
//   ops/attention.py::plan. The products of one tile run after the
//   elementwise work of the last, not beside it: overlapping them as the
//   forward kernel does needs a second set of S, dP and operand registers,
//   about 210 a thread, which spilled at the 168 that ptxas allows two
//   consumer warpgroups and left one 64-key block per SM otherwise, both
//   slower on the H100. What holds it back: that serial order, seven
//   products where five suffice, and the ex2 of P, recomputed twice.
// fp32 (strict): 3xTF32 on tf32 wgmma (attention_hopper.cuh, "fp32
// (strict) operands"), the three kernels of the bf16 design with a
// producer warpgroup in place of the producer warp:
//   (a) attention_bwd_prep_f32: D as the diagonal of dO O^T on the tensor
//       cores (the form of dP), into the bf16 row pass's stats layout;
//   (b) attention_bwd_dkdv_f32: the block's K and V are split once; each
//       R-row q tile lands by TMA, and the producer splits Q and dO in
//       place and writes Q^T's and dO^T's hi / lo pairs, the B operands of
//       dK += dS^T Q and dV += P^T dO (tf32 wgmma reads K-major operands
//       only); the consumer computes S^T = K Q^T and dP^T = V dO^T with
//       the terms of S = Q K^T and dP = dO V^T, P^T and dS^T in registers
//       as the A operands;
//   (c) attention_bwd_dq_f32: the block's Q and dO split once; per R-row
//       K/V tile the producer splits K and V and writes K^T's pair for dQ
//       += dS K.
//   R = 64 at KD = 64 (one stage: 194 KB in (b)); R = 32 at KD = 128, with
//   the dV pass on two stages and the dK pass and (c) on one, their
//   blocks' own pairs taking 64 or 128 KB. A stage's K-major pairs are
//   released once the first products have retired, so the producer loads
//   and splits the next tile while the consumer finishes this one. Rows
//   past L are TMA zeros and lse2 = +inf, as in bf16: no mask. What holds
//   it back: one consumer warpgroup per SM, whose products wait for the
//   exponentials and the splits of P and dS.
//
// Layout: q, k, v, o (the forward output) and dout are (B, L, heads, W)
// with any element strides and a unit-stride head dim, rows 16-byte
// aligned, W = 64 or a multiple of 8 in 72..128 (the head dim, or the
// wrapper's zero-padded width), W <= KD; dq, dk, dv are contiguous (B, L,
// heads, W).
//
// Numerics follow _bwd_kernel (pallas_attn.py:101-135):
//   - S is recomputed on the forward kernel's operands with the same
//     products (in (b) as S^T = K Q^T; in fp32 the 3xTF32 terms ordered as
//     in Q K^T). P = exp(S s - lse) is not bit-equal to the forward
//     kernel's weights, whose lse sums them in another order: they differ
//     by a few fp32 ulps;
//   - the dV and dP legs run at the model dtype: P is rounded to it before
//     dV = P^T dO, and dP = dO V^T multiplies model-dtype operands with
//     fp32 sums;
//   - dS = P o (dP - D) is fp32, rounded to bf16 before dQ and dK only in
//     fast mode; strict mode with bf16 activations keeps dS fp32 by
//     carrying it as two bf16 terms hi + lo (two products, ~2^-16
//     relative);
//   - fp32 (strict) products are 3xTF32; S^T and dP^T are summed in the
//     terms of S and dP, in an order wgmma sets per instruction;
//   - dQ = (dS K) * s with the raw K, dK = (dS^T Q) * s;
//   - D = rowsum(dO o O) stands for the TPU kernel's rowsum(dP o P). The two
//     are equal up to rounding in fp32; with bf16 activations (fast mode
//     and strict mode alike) O is stored as bf16, which moves dQ and dK by
//     ~1e-3 of their norm, within the bf16 tolerance of 5e-2 (chip_smoke.py
//     phase 7 measures it). In fp32 D is taken on the tensor cores in the
//     form of dP, so that dS = 0 exactly where the plain version's is (a
//     one-hot softmax row); the bf16 kernels' fp32 D leaves ~1e-6 there.

#include <math.h>

#include "attention_hopper.cuh"

namespace probunet {
namespace {

namespace sm90 {

using namespace hopper;

constexpr int kBwdStages = 3;
constexpr int kPrepThreads = 256;  // four per row of a 64-row tile

// (a) D = rowsum(dO o O) in fp32 and the forward's lse in base 2, per
// 64-row tile of one (batch * head) into stats[bh][tile] = {lse2[64],
// D[64]}; rows past L get lse2 = +inf (P = 0) and D = 0. At KD = 64 a
// row's four threads sum 16 columns each; at the other widths, 8-column
// chunks q, q + 4, ... of the row's W columns.
template <int KD>
__global__ void __launch_bounds__(kPrepThreads)
    attention_bwd_prep_sm90(const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                            float* __restrict__ stats, int H, int L, int W, Strides so,
                            Strides sdo) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H, tile = blockIdx.x;
  const int r = threadIdx.x / 4, part = threadIdx.x % 4, row = tile * 64 + r;
  float d = 0.f;
  if (row < L) {
    const __nv_bfloat16* po = o + b * so.b + h * so.h + row * so.l;
    const __nv_bfloat16* pd = dout + b * sdo.b + h * sdo.h + row * sdo.l;
    if constexpr (KD == 64) {
#pragma unroll
      for (int c = 0; c < 16; c += 8) {
        float x[8], y[8];
        load_vec<__nv_bfloat16, 8>(po + part * 16 + c, x);
        load_vec<__nv_bfloat16, 8>(pd + part * 16 + c, y);
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(y[i], x[i], d);
      }
    } else {
      for (int c = 8 * part; c < W; c += 32) {
        float x[8], y[8];
        load_vec<__nv_bfloat16, 8>(po + c, x);
        load_vec<__nv_bfloat16, 8>(pd + c, y);
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(y[i], x[i], d);
      }
    }
  }
  d = quad_sum(d);
  if (part == 0) {
    float* out = stats + ((size_t)bh * gridDim.x + tile) * 128;
    out[r] = row < L ? lse[(size_t)bh * L + row] * kLog2e : INFINITY;
    out[64 + r] = d;
  }
}

// Shared memory of (b) and (c): byte offsets from a 1024-byte boundary.
// Each holds its block's two operand tiles (NWG 64-row tiles each: K and
// V, or Q and dO) and kBwdStages stages of two streamed 64-row tiles; (b)
// also stages each q tile's 128 floats of stats.
template <int NWG, bool STATS, int KD> struct BwdSmem {
  static constexpr int kT = tile_bytes<KD>(64);
  static constexpr int own0 = 0, own1 = NWG * kT;                 // the block's tiles
  static constexpr int in0 = 2 * NWG * kT;                        // kBwdStages tiles
  static constexpr int in1 = in0 + kBwdStages * kT;               // kBwdStages tiles
  static constexpr int stats = in1 + kBwdStages * kT;             // kBwdStages x 512 bytes
  static constexpr int bars = stats + (STATS ? kBwdStages * 512 : 0);
  static constexpr int bytes = bars + 8 * (1 + 2 * kBwdStages) + 1024;
};

// The barriers of (b) and (c), initialised by thread 0: own_full for the
// block's tiles, then full and empty per stage.
template <int NWG, bool STATS, int KD>
__device__ __forceinline__ void bwd_barriers(unsigned char* smem, uint64_t*& own_full,
                                             uint64_t*& full, uint64_t*& empty) {
  own_full = reinterpret_cast<uint64_t*>(smem + BwdSmem<NWG, STATS, KD>::bars);
  full = own_full + 1;
  empty = full + kBwdStages;
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarpgroup * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer of (b) and (c): the block's own tiles (rows r0 on, of maps
// own0 and own1) once, then for each of n_tiles 64-row tiles the rows of
// maps in0 and in1 (and, with stats, the tile's 512 bytes from stats_bh)
// into the ring.
template <int NWG, bool STATS, int KD>
__device__ __forceinline__ void bwd_producer(unsigned char* smem, uint64_t* own_full,
                                             uint64_t* full, uint64_t* empty,
                                             const TileMap* own0, const TileMap* own1,
                                             const TileMap* in0, const TileMap* in1,
                                             const float* stats_bh, int h, int b, int r0,
                                             int n_tiles) {
  using Smem = BwdSmem<NWG, STATS, KD>;
  constexpr int kT = Smem::kT;
  mbar_expect_tx(own_full, 2 * NWG * kT);
  for (int w = 0; w < NWG; ++w) {
    tma_tile<KD, 64>(smem + Smem::own0 + w * kT, own0, own_full, h, r0 + 64 * w, b);
    tma_tile<KD, 64>(smem + Smem::own1 + w * kT, own1, own_full, h, r0 + 64 * w, b);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kBwdStages;
    mbar_wait(&empty[s], ((j / kBwdStages) & 1) ^ 1);
    mbar_expect_tx(&full[s], 2 * kT + (STATS ? 512 : 0));
    tma_tile<KD, 64>(smem + Smem::in0 + s * kT, in0, &full[s], h, 64 * j, b);
    tma_tile<KD, 64>(smem + Smem::in1 + s * kT, in1, &full[s], h, 64 * j, b);
    if constexpr (STATS)
      bulk_load(smem + Smem::stats + s * 512, stats_bh + 128 * j, 512, &full[s]);
  }
}

// What a dK/dV kernel computes: both (KD = 64, 80, 96), or at KD = 128 one
// of its two passes.
constexpr int kPassDV = 1, kPassDK = 2, kPassBoth = 3;

// P and dS of one tile from S and dP in registers: p = 2^(S c - lse2), dS =
// P o (dP - D), lse2 and D given per element by the functions; P rounded to
// bf16 into pa (when given), dS into hi and, with SPLIT, its bf16
// remainder into lo.
template <bool SPLIT, typename Lse, typename Dv>
__device__ __forceinline__ void grads(float (&p)[32], float (&ds)[32], float c, Lse lse2, Dv D,
                                      uint32_t (*pa)[4][4], uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p[i] = exp2_fast(fmaf(p[i], c, -lse2(i)));
    ds[i] = p[i] * (ds[i] - D(i));
  }
  if (pa != nullptr) to_a<64>(p, *pa);
  if constexpr (SPLIT) to_a<64>(ds, hi, lo);
  else to_a<64>(ds, hi);
}

// (b) dK and dV (per PASS) of 64 NWG key rows; SPLIT carries dS as bf16
// hi + lo.
template <int NWG, bool SPLIT, int KD, int PASS>
__global__ void __launch_bounds__(kBlockThreads<NWG>, 1)
    attention_bwd_dkdv_sm90(const __grid_constant__ TileMap tq, const __grid_constant__ TileMap tk,
                            const __grid_constant__ TileMap tv,
                            const __grid_constant__ TileMap tdo,
                            const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int H, int L, int W, float scale) {
  using Smem = BwdSmem<NWG, true, KD>;
  constexpr int kT = Smem::kT, kA = kAtoms<KD>, kTl = kTail<KD>;
  constexpr bool kDV = PASS & kPassDV, kDK = PASS & kPassDK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t *own_full, *full, *empty;
  bwd_barriers<NWG, true, KD>(smem, own_full, full, empty);
  auto Qs = [&](int s) { return smem + Smem::in0 + s * kT; };
  auto dOs = [&](int s) { return smem + Smem::in1 + s * kT; };
  auto stat = [&](int s) { return reinterpret_cast<const float*>(smem + Smem::stats + s * 512); };
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * 64 * NWG;
  const int n_tiles = (L + 63) / 64;

  if (threadIdx.x >= kWarpgroup * NWG) {  // the producer warp: K, V; Q, dO, stats per q tile
    if (threadIdx.x == kWarpgroup * NWG)
      bwd_producer<NWG, true, KD>(smem, own_full, full, empty, &tk, &tv, &tq, &tdo,
                                  stats + (size_t)bh * n_tiles * 128, h, b, k0, n_tiles);
    return;
  }

  // consumer warpgroup w: keys k0 + 64 w .. k0 + 64 w + 63, as rows; the
  // columns of S^T, dP^T are the q tile's queries 8 (i / 4) + 2 t + i % 2
  const int w = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const unsigned char* Kw = smem + Smem::own0 + w * kT;
  const unsigned char* Vw = smem + Smem::own1 + w * kT;
  const float c = scale * kLog2e;
  // p: S^T then P^T; ds: dP^T then dS^T (kDK only); dk_t, dv_t: the tail's
  float dk_acc[kA][32], dv_acc[kA][32], p[32], ds[32];
  TailAcc<KD> dk_t, dv_t;
  uint32_t pa[4][4], hi[4][4], lo[4][4];  // P^T, dS^T as A operands (lo: SPLIT only)
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[a][i] = dv_acc[a][i] = 0.f;
  if constexpr (kTl != 0) {
    zero(dk_t);
    zero(dv_t);
  }
  mbar_wait(own_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kBwdStages;
    const float* st = stat(s);
    auto lse2 = [&](int i) { return st[8 * (i / 4) + 2 * t + i % 2]; };
    mbar_wait(&full[s], (j / kBwdStages) & 1);
    wgmma_fence();
    mma_ss<64, KD>(p, Kw, Qs(s));                   // S^T = K Q^T
    if constexpr (kDK) mma_ss<64, KD>(ds, Vw, dOs(s));  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(p);
    if constexpr (kDK) {
      reg_fence(ds);
      grads<SPLIT>(
          p, ds, c, lse2, [&](int i) { return st[64 + 8 * (i / 4) + 2 * t + i % 2]; },
          kDV ? &pa : nullptr, hi, lo);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = exp2_fast(fmaf(p[i], c, -lse2(i)));
      to_a<64>(p, pa);
    }
    wgmma_fence();
    if constexpr (kDV) {
#pragma unroll
      for (int a = 0; a < kA; ++a) mma_rs<64>(dv_acc[a], pa, atom(dOs(s), a, 64));  // dV += P^T dO
      if constexpr (kTl != 0) mma_rs_tail<64, kTl>(dv_t, pa, tail<KD>(dOs(s), 64));
    }
    if constexpr (kDK) {
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        if constexpr (SPLIT) mma_rs<64>(dk_acc[a], lo, atom(Qs(s), a, 64));
        mma_rs<64>(dk_acc[a], hi, atom(Qs(s), a, 64));  // dK += dS^T Q
      }
      if constexpr (kTl != 0) {
        if constexpr (SPLIT) mma_rs_tail<64, kTl>(dk_t, lo, tail<KD>(Qs(s), 64));
        mma_rs_tail<64, kTl>(dk_t, hi, tail<KD>(Qs(s), 64));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      if constexpr (kDV) reg_fence(dv_acc[a]);
      if constexpr (kDK) reg_fence(dk_acc[a]);
    }
    if constexpr (kTl != 0) {
      if constexpr (kDV) reg_fence(dv_t);
      if constexpr (kDK) reg_fence(dk_t);
    }
    mbar_arrive(&empty[s]);  // this stage is free for the load kBwdStages tiles on
  }
  const int row0 = k0 + 64 * w + 16 * warp;
  const float one[2] = {1.f, 1.f}, s2[2] = {scale, scale};
#pragma unroll
  for (int a = 0; a < kA; ++a) {
    if constexpr (kDK) store_rows<KD>(dk, dk_acc[a], b, h, H, L, W, a, row0, lane, s2);
    if constexpr (kDV) store_rows<KD>(dv, dv_acc[a], b, h, H, L, W, a, row0, lane, one);
  }
  if constexpr (kTl != 0) {
    if constexpr (kDK) store_rows<KD, kTl>(dk, dk_t, b, h, H, L, W, kA, row0, lane, s2);
    if constexpr (kDV) store_rows<KD, kTl>(dv, dv_t, b, h, H, L, W, kA, row0, lane, one);
  }
}

// (c) dQ of 64 NWG query rows; SPLIT carries dS as bf16 hi + lo.
template <int NWG, bool SPLIT, int KD>
__global__ void __launch_bounds__(kBlockThreads<NWG>, 1)
    attention_bwd_dq_sm90(const __grid_constant__ TileMap tq, const __grid_constant__ TileMap tk,
                          const __grid_constant__ TileMap tv, const __grid_constant__ TileMap tdo,
                          const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq, int H,
                          int L, int W, float scale) {
  using Smem = BwdSmem<NWG, false, KD>;
  constexpr int kT = Smem::kT, kA = kAtoms<KD>, kTl = kTail<KD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t *own_full, *full, *empty;
  bwd_barriers<NWG, false, KD>(smem, own_full, full, empty);
  auto Ks = [&](int s) { return smem + Smem::in0 + s * kT; };
  auto Vs = [&](int s) { return smem + Smem::in1 + s * kT; };
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * 64 * NWG;
  const int n_tiles = (L + 63) / 64;

  if (threadIdx.x >= kWarpgroup * NWG) {  // the producer warp: Q, dO; K, V per tile
    if (threadIdx.x == kWarpgroup * NWG)
      bwd_producer<NWG, false, KD>(smem, own_full, full, empty, &tq, &tdo, &tk, &tv, nullptr, h,
                                   b, q0, n_tiles);
    return;
  }

  // consumer warpgroup w: query rows q0 + 64 w .. q0 + 64 w + 63
  const int w = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  const int warp = tid / 32, lane = tid % 32;
  const unsigned char* Qw = smem + Smem::own0 + w * kT;
  const unsigned char* dOw = smem + Smem::own1 + w * kT;
  // this thread's rows 16 warp + g and + 8 of the warpgroup's 64-row tile
  // (a tile past L, the second of a block at L <= 64, has no stats: P = 0)
  const int tile = q0 / 64 + w;
  float lse2[2] = {INFINITY, INFINITY}, D[2] = {0.f, 0.f};
  if (tile < n_tiles) {
    const float* st = stats + ((size_t)bh * n_tiles + tile) * 128 + 16 * warp + lane / 4;
    lse2[0] = st[0];
    lse2[1] = st[8];
    D[0] = st[64];
    D[1] = st[72];
  }
  const float c = scale * kLog2e;
  float dq_acc[kA][32], p[32], ds[32];  // p: S then P; ds: dP then dS
  TailAcc<KD> dq_t;
  uint32_t hi[4][4], lo[4][4];  // dS as the A operand (lo: SPLIT only)
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[a][i] = 0.f;
  if constexpr (kTl != 0) zero(dq_t);
  auto tile_grads = [&](uint32_t(&hi_)[4][4], uint32_t(&lo_)[4][4]) {
    grads<SPLIT>(
        p, ds, c, [&](int i) { return lse2[(i / 2) % 2]; }, [&](int i) { return D[(i / 2) % 2]; },
        nullptr, hi_, lo_);
  };
  mbar_wait(own_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kBwdStages;
    mbar_wait(&full[s], (j / kBwdStages) & 1);
    wgmma_fence();
    mma_ss<64, KD>(p, Qw, Ks(s));   // S = Q K^T
    mma_ss<64, KD>(ds, dOw, Vs(s));  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(p);
    reg_fence(ds);
    tile_grads(hi, lo);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      if constexpr (SPLIT) mma_rs<64>(dq_acc[a], lo, atom(Ks(s), a, 64));
      mma_rs<64>(dq_acc[a], hi, atom(Ks(s), a, 64));  // dQ += dS K, the raw K
    }
    if constexpr (kTl != 0) {
      if constexpr (SPLIT) mma_rs_tail<64, kTl>(dq_t, lo, tail<KD>(Ks(s), 64));
      mma_rs_tail<64, kTl>(dq_t, hi, tail<KD>(Ks(s), 64));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < kA; ++a) reg_fence(dq_acc[a]);
    if constexpr (kTl != 0) reg_fence(dq_t);
    mbar_arrive(&empty[s]);  // this stage is free for the load kBwdStages tiles on
  }
  const float s2[2] = {scale, scale};
  const int row0 = q0 + 64 * w + 16 * warp;
#pragma unroll
  for (int a = 0; a < kA; ++a) store_rows<KD>(dq, dq_acc[a], b, h, H, L, W, a, row0, lane, s2);
  if constexpr (kTl != 0) store_rows<KD, kTl>(dq, dq_t, b, h, H, L, W, kA, row0, lane, s2);
}

template <int NWG, bool SPLIT, int KD> struct Bwd {
  static constexpr int threads = kBlockThreads<NWG>;
  static constexpr int dkdv_smem = BwdSmem<NWG, true, KD>::bytes;
  static constexpr int dq_smem = BwdSmem<NWG, false, KD>::bytes;

  static cudaError_t launch(const TileMap& tq, const TileMap& tk, const TileMap& tv,
                            const TileMap& tdo, const void* o, const void* dout,
                            const float* lse, float* stats, void* dq, void* dk, void* dv, int B,
                            int H, int L, int W, Strides so, Strides sdo,
                            float scale, cudaStream_t stream) {
    const int n_tiles = (L + 63) / 64;
    attention_bwd_prep_sm90<KD><<<dim3(n_tiles, B * H), kPrepThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse,
        stats, H, L, W, so, sdo);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid((L + 64 * NWG - 1) / (64 * NWG), B * H);
    auto dkdv = [&](auto kernel) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
      if (e != cudaSuccess) return e;
      kernel<<<grid, threads, dkdv_smem, stream>>>(tq, tk, tv, tdo, stats,
                                                   static_cast<__nv_bfloat16*>(dk),
                                                   static_cast<__nv_bfloat16*>(dv), H, L, W,
                                                   scale);
      return cudaGetLastError();
    };
    if constexpr (KD != 128) {
      err = dkdv(attention_bwd_dkdv_sm90<NWG, SPLIT, KD, kPassBoth>);
    } else {  // the dV pass forms no dS: one kernel serves both SPLITs
      err = dkdv(attention_bwd_dkdv_sm90<NWG, false, KD, kPassDV>);
      if (err == cudaSuccess) err = dkdv(attention_bwd_dkdv_sm90<NWG, SPLIT, KD, kPassDK>);
    }
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_bwd_dq_sm90<NWG, SPLIT, KD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
    if (err != cudaSuccess) return err;
    attention_bwd_dq_sm90<NWG, SPLIT, KD><<<grid, threads, dq_smem, stream>>>(
        tq, tk, tv, tdo, stats, static_cast<__nv_bfloat16*>(dq), H, L, W, scale);
    return cudaGetLastError();
  }

  // kernel 0: (b) (at KD = 128 its dV pass), 1: (c), 2: (b)'s dK pass (KD =
  // 128), 3: the row pass (a)
  static cudaError_t query(int kernel, int* out) {
    if (kernel == 1)
      return hopper::query(attention_bwd_dq_sm90<NWG, SPLIT, KD>, threads, dq_smem, out);
    if (kernel == 3) return hopper::query(attention_bwd_prep_sm90<KD>, kPrepThreads, 0, out);
    if constexpr (KD != 128) {
      if (kernel == 0)
        return hopper::query(attention_bwd_dkdv_sm90<NWG, SPLIT, KD, kPassBoth>, threads,
                             dkdv_smem, out);
    } else {
      if (kernel == 0)
        return hopper::query(attention_bwd_dkdv_sm90<NWG, false, KD, kPassDV>, threads,
                             dkdv_smem, out);
      if (kernel == 2)
        return hopper::query(attention_bwd_dkdv_sm90<NWG, SPLIT, KD, kPassDK>, threads,
                             dkdv_smem, out);
    }
    return cudaErrorInvalidValue;
  }
};

// Op<NWG, SPLIT, KD> of a plan (ops/attention.py::plan): block_rows = 64
// NWG rows per block, kd = KD the head width, SPLIT with dS carried as hi +
// lo; the shapes the plan gives each width and no other (128 rows only with
// dS split at kd = 64: fast mode's plan is 64 rows, and kd = 80, 96 and 128
// take 64-row blocks only).
template <template <int, bool, int> class Op, typename F>
cudaError_t with_plan(int block_rows, bool split, int kd, F&& f) {
  if (kd == 64 && block_rows == 128 && split) return f(Op<2, true, 64>());
  if (kd == 64 && block_rows == 64) return split ? f(Op<1, true, 64>()) : f(Op<1, false, 64>());
  if (kd == 80 && block_rows == 64) return split ? f(Op<1, true, 80>()) : f(Op<1, false, 80>());
  if (kd == 96 && block_rows == 64) return split ? f(Op<1, true, 96>()) : f(Op<1, false, 96>());
  if (kd == 128 && block_rows == 64)
    return split ? f(Op<1, true, 128>()) : f(Op<1, false, 128>());
  return cudaErrorInvalidValue;
}

}  // namespace sm90

namespace f32 {

using namespace hopper;

// (a) D = rowsum(dO o O) as the diagonal of the tile product dO O^T, in
// 3xTF32 on tf32 wgmma in the same form as dP = dO V^T in (c) (and, with
// the terms swapped, dP^T = V dO^T in (b)), per 64-row tile of one (batch *
// head), into stats[bh][tile] = {lse2[64], D[64]} as the bf16 row pass
// writes it (lse in base 2; rows past L: lse2 = +inf, so P = 0, and D = 0).
// Where a row's softmax is one-hot (L = 1), O is that row of V as the
// forward kernel's P V rounds it, whose tf32 split is V's own, so D equals
// dP bit for bit and dS = P o (dP - D) vanishes as in the plain version (an
// fp32 D from CUDA-core FMAs leaves ~1e-6 there). One warpgroup: the TMA
// unit loads the dO and O tiles, the 128 threads split them and run the
// product.
template <int KD> struct PrepSmem32 {
  static constexpr int kT = f32_tile_bytes<KD>(64);
  static constexpr int do_hi = 0, do_lo = kT, o_hi = 2 * kT, o_lo = 3 * kT, bar = 4 * kT;
  static constexpr int bytes = bar + 8 + 1024;
};

template <int KD>
__global__ void __launch_bounds__(kWarpgroup)
    attention_bwd_prep_f32(const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap to, const float* __restrict__ lse,
                           float* __restrict__ stats, int H, int L, int W) {
  using Smem = PrepSmem32<KD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + Smem::bar);
  const int bh = blockIdx.y, b = bh / H, h = bh % H, tile = blockIdx.x, r0 = tile * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * Smem::kT);
    tma_tile_f32<KD, 64>(smem + Smem::do_hi, &tdo, bar, h, r0, b);
    tma_tile_f32<KD, 64>(smem + Smem::o_hi, &to, bar, h, r0, b);
  }
  mbar_wait(bar, 0);
  split_tile<Smem::kT>(smem + Smem::do_hi, smem + Smem::do_lo, tid);
  split_tile<Smem::kT>(smem + Smem::o_hi, smem + Smem::o_lo, tid);
  fence_async_smem();
  __syncthreads();
  float d[32];
  wgmma_fence();
  mma3_ss<64, KD / 8>(d, smem + Smem::do_hi, smem + Smem::do_lo, smem + Smem::o_hi,
                      smem + Smem::o_lo, 0, head_steps<KD>(W));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(d);
  float* out = stats + ((size_t)bh * gridDim.x + tile) * 128;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    if (8 * (i / 4) + 2 * t + i % 2 == row) out[64 + row] = r0 + row < L ? d[i] : 0.f;
  }
  if (tid < 64) out[tid] = r0 + tid < L ? lse[(size_t)bh * L + r0 + tid] * kLog2e : INFINITY;
}

using sm90::kPassBoth;
using sm90::kPassDK;
using sm90::kPassDV;

// Shared memory of (b): byte offsets from a 1024-byte boundary. The
// block's 64 keys: K's hi / lo pair, and V's for dP^T (the passes with dK);
// S stages of R-row q tiles: Q's pair (Q lands in q_hi); dO's pair for
// dP^T, or (the dV pass) dO as it lands; Q^T's pair for dK; dO^T's pair for
// dV; then each stage's lse2[R] and D[R], and the barriers.
template <int KD, int R, int S, int PASS> struct DkdvSmem32 {
  static constexpr bool kDV = PASS & kPassDV, kDK = PASS & kPassDK;
  static constexpr int kO = f32_tile_bytes<KD>(64), kT = f32_tile_bytes<KD>(R);
  static constexpr int k_hi = 0, k_lo = kO, v_hi = 2 * kO, v_lo = 3 * kO;
  static constexpr int stages = (kDK ? 4 : 2) * kO;
  static constexpr int q_hi = 0, q_lo = kT, do_hi = 2 * kT, do_lo = 3 * kT;
  static constexpr int qt_hi = (kDK ? 4 : 3) * kT, qt_lo = qt_hi + kT;
  static constexpr int dot_hi = qt_hi + (kDK ? 2 : 0) * kT, dot_lo = dot_hi + kT;
  static constexpr int stage = dot_hi + (kDV ? 2 : 0) * kT;
  static constexpr int stats = stages + S * stage;  // S x (lse2[R], D[R])
  static constexpr int bars = stats + S * 8 * R;
  static constexpr int bytes = bars + kRing32Bytes<S> + 1024;
};

// (b) dK and dV (per PASS) of 64 key rows: S^T = K Q^T and dP^T = V dO^T
// (B: the q tile's K-major pairs), then dV += P^T dO and dK += dS^T Q
// (B: dO^T and Q^T), P^T and dS^T split in registers as the A operands.
template <int KD, int R, int S, int PASS>
__global__ void __launch_bounds__(2 * kWarpgroup, 1)
    attention_bwd_dkdv_f32(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ stats, float* __restrict__ dk,
                           float* __restrict__ dv, int H, int L, int W, float scale) {
  using Smem = DkdvSmem32<KD, R, S, PASS>;
  constexpr bool kDV = Smem::kDV, kDK = Smem::kDK;
  constexpr int kO = Smem::kO, kT = Smem::kT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + Smem::bars);  // K/V loaded, ready
  Ring32* ring = reinterpret_cast<Ring32*>(own + 2);
  auto tile = [&](int s, int off) { return smem + Smem::stages + s * Smem::stage + off; };
  auto stat = [&](int s) { return reinterpret_cast<float*>(smem + Smem::stats + s * 8 * R); };
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * 64;
  const int n_tiles = (L + R - 1) / R, n64 = (L + 63) / 64;
  if (threadIdx.x == 0) ring32_init<S>(own, ring);
  __syncthreads();
  const int tid = threadIdx.x % kWarpgroup;

  if (threadIdx.x >= kWarpgroup) {  // the producer warpgroup
    if (tid == 0) {
      mbar_expect_tx(&own[0], (kDK ? 2 : 1) * kO);
      tma_tile_f32<KD, 64>(smem + Smem::k_hi, &tk, &own[0], h, k0, b);
      if constexpr (kDK) tma_tile_f32<KD, 64>(smem + Smem::v_hi, &tv, &own[0], h, k0, b);
    }
    mbar_wait(&own[0], 0);
    split_tile<kO>(smem + Smem::k_hi, smem + Smem::k_lo, tid);
    if constexpr (kDK) split_tile<kO>(smem + Smem::v_hi, smem + Smem::v_lo, tid);
    fence_async_smem();
    mbar_arrive(&own[1]);
    const float* stats_bh = stats + (size_t)bh * n64 * 128;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % S;
      const unsigned ph = (j / S) & 1;
      Ring32& st = ring[s];
      producer_sync();  // every producer thread is done with this stage's last tile
      if (tid == 0) {
        mbar_wait(&st.nat_empty, ph ^ 1);
        mbar_expect_tx(&st.loaded, 2 * kT + 8 * R);
        tma_tile_f32<KD, R>(tile(s, Smem::q_hi), &tq, &st.loaded, h, j * R, b);
        tma_tile_f32<KD, R>(tile(s, Smem::do_hi), &tdo, &st.loaded, h, j * R, b);
        // rows j R .. of the 64-row tiles' {lse2[64], D[64]}
        const float* src = stats_bh + (j * R / 64) * 128 + (j * R) % 64;
        bulk_load(stat(s), src, 4 * R, &st.loaded);
        bulk_load(stat(s) + R, src + 64, 4 * R, &st.loaded);
      }
      mbar_wait(&st.loaded, ph);
      split_tile<kT>(tile(s, Smem::q_hi), tile(s, Smem::q_lo), tid);
      if constexpr (kDK) split_tile<kT>(tile(s, Smem::do_hi), tile(s, Smem::do_lo), tid);
      fence_async_smem();
      mbar_arrive(&st.nat_full);
      mbar_wait(&st.t_empty, ph ^ 1);
      if constexpr (kDK) {
        producer_sync();  // the pairs split above, by every thread, are read across threads
        transpose_tile<KD, R, false>(tile(s, Smem::q_hi), tile(s, Smem::q_lo),
                                     tile(s, Smem::qt_hi), tile(s, Smem::qt_lo), tid);
      }
      if constexpr (kDV)  // from dO's pair, or (the dV pass) from dO as it landed
        transpose_tile<KD, R, !kDK>(tile(s, Smem::do_hi), tile(s, Smem::do_lo),
                                    tile(s, Smem::dot_hi), tile(s, Smem::dot_lo), tid);
      fence_async_smem();
      mbar_arrive(&st.t_full);
    }
    return;
  }

  // the consumer warpgroup: keys k0 .. k0 + 63 as rows; the columns of S^T
  // and dP^T are the q tile's queries 8 (i / 4) + 2 t + i % 2
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const float c = scale * kLog2e;
  const int steps = head_steps<KD>(W);
  float dk_acc[KD / 2], dv_acc[KD / 2], p[R / 2], ds[R / 2];  // p: S^T, P^T; ds: dP^T, dS^T
  uint32_t a_hi[R / 8][4], a_lo[R / 8][4];  // P^T, then dS^T, as the A operand
  zero(dk_acc);
  zero(dv_acc);
  mbar_wait(&own[1], 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % S;
    const unsigned ph = (j / S) & 1;
    Ring32& st = ring[s];
    mbar_wait(&st.loaded, ph);  // the stats, which the consumer reads itself
    mbar_wait(&st.nat_full, ph);
    wgmma_fence();
    mma3_ss<R, KD / 8, true>(p, smem + Smem::k_hi, smem + Smem::k_lo, tile(s, Smem::q_hi),
                             tile(s, Smem::q_lo), 0, steps);  // S^T = K Q^T, as S = Q K^T
    if constexpr (kDK)
      mma3_ss<R, KD / 8, true>(ds, smem + Smem::v_hi, smem + Smem::v_lo, tile(s, Smem::do_hi),
                               tile(s, Smem::do_lo), 0, steps);  // dP^T = V dO^T, as dP
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(p);
    if constexpr (kDK) reg_fence(ds);
    const float* lse2 = stat(s);
    const float* D = lse2 + R;
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int col = 8 * (i / 4) + 2 * t + i % 2;
      p[i] = exp2_fast(fmaf(p[i], c, -lse2[col]));
      if constexpr (kDK) ds[i] = p[i] * (ds[i] - D[col]);
    }
    // the stage's stats lie beside its K-major pairs and are reloaded with
    // them, so it is released only once this thread has read its lse2 and D
    mbar_arrive(&st.nat_empty);
    mbar_wait(&st.t_full, ph);
    if constexpr (kDV) {  // dV += P^T dO
      split_a<R>(p, a_hi, a_lo);
      wgmma_fence();
      mma3_rs<KD, R / 8>(dv_acc, a_hi, a_lo, tile(s, Smem::dot_hi), tile(s, Smem::dot_lo), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dv_acc);
    }
    if constexpr (kDK) {  // dK += dS^T Q
      split_a<R>(ds, a_hi, a_lo);
      wgmma_fence();
      mma3_rs<KD, R / 8>(dk_acc, a_hi, a_lo, tile(s, Smem::qt_hi), tile(s, Smem::qt_lo), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dk_acc);
    }
    mbar_arrive(&st.t_empty);
  }
  const int row0 = k0 + 16 * warp;
  const float one[2] = {1.f, 1.f}, s2[2] = {scale, scale};
  if constexpr (kDK) store_rows_f32<KD>(dk, dk_acc, b, h, H, L, W, row0, lane, s2);
  if constexpr (kDV) store_rows_f32<KD>(dv, dv_acc, b, h, H, L, W, row0, lane, one);
}

// Shared memory of (c): the block's 64 queries as Q's and dO's hi / lo
// pairs; S stages of R-row K/V tiles: K's pair, V's pair and K^T's pair;
// the barriers.
template <int KD, int R, int S> struct DqSmem32 {
  static constexpr int kO = f32_tile_bytes<KD>(64), kT = f32_tile_bytes<KD>(R);
  static constexpr int q_hi = 0, q_lo = kO, do_hi = 2 * kO, do_lo = 3 * kO, stages = 4 * kO;
  static constexpr int k_hi = 0, k_lo = kT, v_hi = 2 * kT, v_lo = 3 * kT, kt_hi = 4 * kT,
                       kt_lo = 5 * kT, stage = 6 * kT;
  static constexpr int bars = stages + S * stage;
  static constexpr int bytes = bars + kRing32Bytes<S> + 1024;
};

// (c) dQ of 64 query rows: S = Q K^T and dP = dO V^T, then dQ += dS K
// (B: K^T), dS split in registers as the A operand.
template <int KD, int R, int S>
__global__ void __launch_bounds__(2 * kWarpgroup, 1)
    attention_bwd_dq_f32(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ stats, float* __restrict__ dq, int H, int L,
                         int W, float scale) {
  using Smem = DqSmem32<KD, R, S>;
  constexpr int kO = Smem::kO, kT = Smem::kT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + Smem::bars);  // Q/dO loaded, ready
  Ring32* ring = reinterpret_cast<Ring32*>(own + 2);
  auto tile = [&](int s, int off) { return smem + Smem::stages + s * Smem::stage + off; };
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * 64;
  const int n_tiles = (L + R - 1) / R;
  if (threadIdx.x == 0) ring32_init<S>(own, ring);
  __syncthreads();
  const int tid = threadIdx.x % kWarpgroup;

  if (threadIdx.x >= kWarpgroup) {  // the producer warpgroup
    if (tid == 0) {
      mbar_expect_tx(&own[0], 2 * kO);
      tma_tile_f32<KD, 64>(smem + Smem::q_hi, &tq, &own[0], h, q0, b);
      tma_tile_f32<KD, 64>(smem + Smem::do_hi, &tdo, &own[0], h, q0, b);
    }
    mbar_wait(&own[0], 0);
    split_tile<kO>(smem + Smem::q_hi, smem + Smem::q_lo, tid);
    split_tile<kO>(smem + Smem::do_hi, smem + Smem::do_lo, tid);
    fence_async_smem();
    mbar_arrive(&own[1]);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % S;
      const unsigned ph = (j / S) & 1;
      Ring32& st = ring[s];
      producer_sync();  // every producer thread is done with this stage's last tile
      if (tid == 0) {
        mbar_wait(&st.nat_empty, ph ^ 1);
        mbar_expect_tx(&st.loaded, 2 * kT);
        tma_tile_f32<KD, R>(tile(s, Smem::k_hi), &tk, &st.loaded, h, j * R, b);
        tma_tile_f32<KD, R>(tile(s, Smem::v_hi), &tv, &st.loaded, h, j * R, b);
      }
      mbar_wait(&st.loaded, ph);
      split_tile<kT>(tile(s, Smem::k_hi), tile(s, Smem::k_lo), tid);
      split_tile<kT>(tile(s, Smem::v_hi), tile(s, Smem::v_lo), tid);
      fence_async_smem();
      mbar_arrive(&st.nat_full);
      mbar_wait(&st.t_empty, ph ^ 1);
      producer_sync();  // K's pair, split above by every thread, is read across threads
      transpose_tile<KD, R, false>(tile(s, Smem::k_hi), tile(s, Smem::k_lo),
                                   tile(s, Smem::kt_hi), tile(s, Smem::kt_lo), tid);
      fence_async_smem();
      mbar_arrive(&st.t_full);
    }
    return;
  }

  // the consumer warpgroup: query rows q0 .. q0 + 63, this thread's 16
  // warp + g and + 8 (rows past L have lse2 = +inf in the stats: P = 0)
  const int warp = tid / 32, lane = tid % 32;
  const float* st64 = stats + ((size_t)bh * ((L + 63) / 64) + q0 / 64) * 128 + 16 * warp + lane / 4;
  const float lse2[2] = {st64[0], st64[8]}, D[2] = {st64[64], st64[72]};
  const float c = scale * kLog2e;
  const int steps = head_steps<KD>(W);
  float dq_acc[KD / 2], p[R / 2], ds[R / 2];  // p: S then P; ds: dP then dS
  uint32_t a_hi[R / 8][4], a_lo[R / 8][4];    // dS as the A operand
  zero(dq_acc);
  mbar_wait(&own[1], 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % S;
    const unsigned ph = (j / S) & 1;
    Ring32& st = ring[s];
    mbar_wait(&st.nat_full, ph);
    wgmma_fence();
    mma3_ss<R, KD / 8>(p, smem + Smem::q_hi, smem + Smem::q_lo, tile(s, Smem::k_hi),
                       tile(s, Smem::k_lo), 0, steps);  // S = Q K^T
    mma3_ss<R, KD / 8>(ds, smem + Smem::do_hi, smem + Smem::do_lo, tile(s, Smem::v_hi),
                       tile(s, Smem::v_lo), 0, steps);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(p);
    reg_fence(ds);
    mbar_arrive(&st.nat_empty);
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int r = (i / 2) % 2;
      p[i] = exp2_fast(fmaf(p[i], c, -lse2[r]));
      ds[i] = p[i] * (ds[i] - D[r]);
    }
    split_a<R>(ds, a_hi, a_lo);
    mbar_wait(&st.t_full, ph);
    wgmma_fence();
    mma3_rs<KD, R / 8>(dq_acc, a_hi, a_lo, tile(s, Smem::kt_hi), tile(s, Smem::kt_lo),
                       1);  // dQ += dS K, the raw K (keys past L are zeros)
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq_acc);
    mbar_arrive(&st.t_empty);
  }
  const float s2[2] = {scale, scale};
  store_rows_f32<KD>(dq, dq_acc, b, h, H, L, W, q0 + 16 * warp, lane, s2);
}

// The kernels of an fp32 plan (ops/attention.py::fp32_plan) at head width
// KD with R-row streamed tiles: KD = 64, R = 64: one dK/dV kernel and dQ,
// one stage each; KD = 128, R = 32: a dV pass (two stages), a dK pass and
// dQ (one stage each), K's, V's, Q's and dO's pairs of 64 x 128 fp32 being
// 32 KB each.
template <int KD, int R> struct Bwd32 {
  static constexpr int threads = 2 * kWarpgroup, kDqStages = 1;
  static constexpr int kDkdvStages = KD == 64 ? 1 : 2, kDkStages = 1;
  static constexpr int kFirstPass = KD == 64 ? kPassBoth : kPassDV;
  static constexpr int prep_smem = PrepSmem32<KD>::bytes;
  static constexpr int dkdv_smem = DkdvSmem32<KD, R, kDkdvStages, kFirstPass>::bytes;
  static constexpr int dk_smem = DkdvSmem32<KD, R, kDkStages, kPassDK>::bytes;
  static constexpr int dq_smem = DqSmem32<KD, R, kDqStages>::bytes;

  template <typename Kernel>
  static cudaError_t prepare(Kernel kernel, int smem) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }

  static cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                            const CUtensorMap& to, const CUtensorMap& tdo, const float* lse,
                            float* stats, void* dq, void* dk, void* dv, int B, int H, int L,
                            int W, float scale, cudaStream_t stream) {
    const dim3 grid((L + 63) / 64, B * H);
    float *fdq = static_cast<float*>(dq), *fdk = static_cast<float*>(dk),
          *fdv = static_cast<float*>(dv);
    cudaError_t err = prepare(attention_bwd_prep_f32<KD>, prep_smem);
    if (err != cudaSuccess) return err;
    attention_bwd_prep_f32<KD><<<grid, kWarpgroup, prep_smem, stream>>>(tdo, to, lse, stats, H, L,
                                                                        W);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    auto first = attention_bwd_dkdv_f32<KD, R, kDkdvStages, kFirstPass>;
    if ((err = prepare(first, dkdv_smem)) != cudaSuccess) return err;
    first<<<grid, threads, dkdv_smem, stream>>>(tq, tk, tv, tdo, stats, fdk, fdv, H, L, W, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if constexpr (KD == 128) {
      auto second = attention_bwd_dkdv_f32<KD, R, kDkStages, kPassDK>;
      if ((err = prepare(second, dk_smem)) != cudaSuccess) return err;
      second<<<grid, threads, dk_smem, stream>>>(tq, tk, tv, tdo, stats, fdk, fdv, H, L, W,
                                                 scale);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    auto dqk = attention_bwd_dq_f32<KD, R, kDqStages>;
    if ((err = prepare(dqk, dq_smem)) != cudaSuccess) return err;
    dqk<<<grid, threads, dq_smem, stream>>>(tq, tk, tv, tdo, stats, fdq, H, L, W, scale);
    return cudaGetLastError();
  }

  // kernel 0: (b) (at KD = 128 its dV pass), 1: (c), 2: (b)'s dK pass (KD =
  // 128), 3: the row pass (a)
  static cudaError_t query(int kernel, int* out) {
    if (kernel == 0)
      return hopper::query(attention_bwd_dkdv_f32<KD, R, kDkdvStages, kFirstPass>, threads,
                           dkdv_smem, out);
    if (kernel == 1)
      return hopper::query(attention_bwd_dq_f32<KD, R, kDqStages>, threads, dq_smem, out);
    if (kernel == 3) return hopper::query(attention_bwd_prep_f32<KD>, kWarpgroup, prep_smem, out);
    if constexpr (KD == 128)
      if (kernel == 2)
        return hopper::query(attention_bwd_dkdv_f32<KD, R, kDkStages, kPassDK>, threads, dk_smem,
                             out);
    return cudaErrorInvalidValue;
  }
};

template <typename F> cudaError_t with_plan(int kd, int rows, F&& f) {
  if (kd == 64 && rows == 64) return f(Bwd32<64, 64>());
  if (kd == 128 && rows == 32) return f(Bwd32<128, 32>());
  return cudaErrorInvalidValue;
}

}  // namespace f32

}  // namespace
}  // namespace probunet

// q, k, v, o (the forward output), dout: (B, L, H, head_dim) of one dtype,
// element strides (*_sb, *_sl, *_sh), unit-stride head dim, 16-byte-aligned
// rows; head_dim 64, or a multiple of 8 in 72..128 (the head dim c, or the
// zero-padded width that ops/attention.py::kernel_width gives c). lse:
// (B*H, L) fp32 from the forward kernel. scratch: fp32 (B*H, ceil(L / 64),
// 2, 64): lse in base 2 and D per 64-row tile. dq, dk, dv: (B, L, H,
// head_dim) contiguous, q's dtype. scale is 1/sqrt(c). fast rounds dS to
// bf16 (bf16 only; fp32 ignores it). rows and kd are the plan's: bf16, the
// block rows of ops/attention.py::plan (64 or 128) and its kd (64, 80, 96
// or 128); fp32, the streamed tile rows of fp32_plan and its kd (64 or
// 128); a kd not built, or narrower than head_dim, is refused. Returns a
// cudaError_t code; 0 on success.
extern "C" int probunet_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    void* scratch, void* dq, void* dk, void* dv, int B, int H, int L, int head_dim,
    long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl,
    long long k_sh, long long v_sb, long long v_sl, long long v_sh, long long o_sb,
    long long o_sl, long long o_sh, long long do_sb, long long do_sl, long long do_sh,
    float scale, int is_bf16, int fast, int rows, int kd, void* stream) {
  using probunet::Strides;
  using probunet::hopper::make_map;
  const int W = head_dim;
  if (!probunet::hopper::head_width_ok(W, kd, is_bf16)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(scratch);
  if (!is_bf16) {
    const int box = probunet::hopper::kF32BoxRows;
    CUtensorMap tq, tk, tv, tdo, to;
    cudaError_t err = make_map(&tq, q, B, H, L, W, q_sb, q_sl, q_sh, 4, box);
    if (err == cudaSuccess) err = make_map(&tk, k, B, H, L, W, k_sb, k_sl, k_sh, 4, box);
    if (err == cudaSuccess) err = make_map(&tv, v, B, H, L, W, v_sb, v_sl, v_sh, 4, box);
    if (err == cudaSuccess) err = make_map(&tdo, dout, B, H, L, W, do_sb, do_sl, do_sh, 4, box);
    if (err == cudaSuccess) err = make_map(&to, o, B, H, L, W, o_sb, o_sl, o_sh, 4, box);
    if (err != cudaSuccess) return err;
    return probunet::f32::with_plan(kd, rows, [&](auto plan) {
      return plan.launch(tq, tk, tv, to, tdo, l, d, dq, dk, dv, B, H, L, W, scale, st);
    });
  }
  using probunet::hopper::make_tile_map;
  probunet::hopper::TileMap tq, tk, tv, tdo;
  cudaError_t err = make_tile_map(&tq, q, B, H, L, W, q_sb, q_sl, q_sh, kd);
  if (err == cudaSuccess) err = make_tile_map(&tk, k, B, H, L, W, k_sb, k_sl, k_sh, kd);
  if (err == cudaSuccess) err = make_tile_map(&tv, v, B, H, L, W, v_sb, v_sl, v_sh, kd);
  if (err == cudaSuccess) err = make_tile_map(&tdo, dout, B, H, L, W, do_sb, do_sl, do_sh, kd);
  if (err != cudaSuccess) return err;
  const Strides so{o_sb, o_sl, o_sh}, sdo{do_sb, do_sl, do_sh};
  return probunet::sm90::with_plan<probunet::sm90::Bwd>(
      rows, !fast, kd, [&](auto plan) {
        return plan.launch(tq, tk, tv, tdo, o, dout, l, d, dq, dk, dv, B, H, L, W, so, sdo, scale,
                           st);
      });
}

// What a bf16 backward kernel of a plan at head width kd (64, 80, 96 or
// 128) is on this card (kernel 0: dK/dV, at kd 128 its dV pass; 1: dQ; 2:
// at kd 128 the dK pass; 3: the row pass; split: strict mode's hi + lo dS):
// out = {threads, dynamic shared bytes, registers, local (spilled) bytes
// per thread, static shared bytes}. Returns a cudaError_t code; 0 on
// success.
extern "C" int probunet_attention_bwd_query(int kernel, int block_rows, int split, int kd,
                                            int* out) {
  return probunet::sm90::with_plan<probunet::sm90::Bwd>(
      block_rows, split != 0, kd, [&](auto plan) { return plan.query(kernel, out); });
}

// The same for an fp32 backward kernel of the fp32 plan at head width kd
// with streamed tiles of rows rows (kernels 0-2 as above, 3: the row pass).
extern "C" int probunet_attention_bwd_f32_query(int kernel, int kd, int rows, int* out) {
  return probunet::f32::with_plan(kd, rows, [&](auto plan) { return plan.query(kernel, out); });
}
