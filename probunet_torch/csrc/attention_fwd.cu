// Fused self-attention forward, softmax(Q (K s)^T) V with s = 1/sqrt(c) for
// a head dim c up to 128: kernel K2 of the port, for Hopper (sm_90a).
//
// Replaces probunet_tpu/ops/pallas_attn.py::_fwd_kernel (launched by
// _fwd_pallas). The TPU kernel holds the whole of K and V in VMEM and skips
// the online softmax; at L=1024 fp32 K plus V is 512 KB, beyond an SM's
// 227 KB of shared memory, so here K/V stream through shared memory in
// tiles with a running max and sum, and the (L, L) weights never reach
// device memory.
//
// Bound: operations, 4 * B * heads * L^2 * c FLOP (QK^T and PV), against
// the H100's 989 TFLOP/s of bf16 tensor-core products (fast mode, and
// strict mode with bf16 activations) and, for fp32, the smaller of the fp32
// CUDA-core time (67 TFLOP/s) and three TF32 products (495 TFLOP/s). At the
// U-Net's sites (b8: L=1024 with 6 heads, L=256 with 8) the bf16 bound is
// 0.080 ms per pass of 11 sites; the bytes (q, k, v read and o written
// once) take a quarter of that.
//
// Head dims: every kernel is instantiated for a head KD = 64 or 128 columns
// wide in shared memory (attention_hopper.cuh, attention_tiles.cuh): c = 64
// runs KD = 64, 64 < c <= 128 (72 at the U-Net's 288-wide level with
// model_channels 96) runs KD = 128 with the columns past c zero, and so
// does (128 / c) times the products of an exact-width kernel. At KD = 128
// the bf16 kernel takes 64-row blocks of one consumer warpgroup and 64-row
// K/V tiles (ops/attention.py::plan): O is 64 fp32 registers a thread, the
// consumer holds 155 (ptxas), and 128-row tiles would add S's 32 past the
// 168 that ptxas leaves a two-consumer block.
//
// bf16: attention_fwd_sm90 (machinery in attention_hopper.cuh), the
// FlashAttention-3 shape. One block per (batch * head, 64 NWG query rows):
// NWG consumer warpgroups of 64 query rows each and a producer warp, whose
// one thread loads the block's Q and then keeps TMA loads of BN-row K and V
// tiles in flight through a ring of kFwdStages stages under mbarriers. A
// consumer runs S = Q K^T on wgmma from the two shared tiles (m64nBNk16,
// K-major), the online softmax in fp32 registers, and O += P V on wgmma
// with P in registers as the A operand and V read MN-major (m64n64k16, one
// per 64 columns of the head).
// The two products overlap across tiles (FlashAttention-3's intra-
// warpgroup pipelining): S of tile j + 1 is issued together with PV of
// tile j, and the softmax of tile j + 1 runs on the CUDA cores while PV
// is on the tensor cores; no register an issued product reads is written
// before it retires, so ptxas keeps both in flight. The block sizes come
// from ops/attention.py::plan. Rows past L arrive as zeros (the TMA box is
// clipped by the map); the ragged last tile's columns are masked. What
// holds it back: at head dim 64 the softmax's ex2 (16 a clock per SM)
// takes about as long as the tile's products at the tensor cores' peak,
// and one or two consumer warpgroups per SM hide only part of it.
//
// fp32: attention_fwd, FlashAttention-2 style on mma.sync (tile machinery
// in attention_tiles.cuh): one block of four warps per (batch * head, 64
// query rows), 16 rows a warp; the Q tile and a 2-stage ring of 64-row
// K/V tiles are copied by cp.async; S = Q K^T and O += P V in 3xTF32 with
// fp32 accumulators; P goes from its accumulator registers straight into
// the A operand of PV. A ragged last tile is zero-filled and masked.
//
// Layout: q, k, v are (B, L, heads, W) with any element strides (sb, sl,
// sh) and a unit-stride head dim, each row 16-byte aligned, W = 64 or a
// multiple of 8 in 72..128 (the head dim, or the zero-padded width the
// wrapper copied it to): the U-Net block's q/k/v views of its qkv conv
// output are read where the conv wrote them. The output is contiguous (B,
// L, heads, W). Given a non-null lse,
// the kernel also writes each row's fp32 log-sum-exp of the logits,
// (B*heads, L), which the backward kernel (attention_bwd.cu) uses to
// recompute the weights; serving passes null and writes nothing more.
//
// Numerics by storage type:
//   fp32 (strict): 3xTF32 products, within a few fp32 ulps of the fp32
//     products of Precision.HIGHEST, with fp32 sums in another order.
//   bf16 (fast): products of bf16 operands accumulate in fp32; the
//     probabilities are rounded to bf16 before PV (as p.astype(v.dtype)
//     does). The logits are scaled by s after the product: at c = 64, s =
//     1/8 is a power of two, so that equals the product with K * s rounded
//     to bf16 (as _prep does), bit for bit, barring underflow; at other c
//     (s = 1/sqrt(72), say) the kernel's fp32 logits skip that rounding of
//     K * s, within the fast tolerance of 2e-2.
//   Both: the softmax is fp32, in base 2 (p = 2^(S s log2(e) - m)) by the
//     SFU's ex2, about 2 ulp from expf; the lse comes back in natural log.
//   Every sum runs in a fixed order: two calls give the same bits.

#include <math.h>

#include "attention_hopper.cuh"
#include "attention_tiles.cuh"

namespace probunet {
namespace {

namespace fp32 {

using namespace tiles;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ lse, int H, int L, int W, Strides sq,
                  Strides sk, Strides sv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = kPitch<T, D>;
  constexpr int kT = kTile<T, D>;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kT;       // two stages
  T* Vs = Ks + 2 * kT;   // two stages

  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_tile_async<T, D>(Qs, qb, sq.l, q0, L, W, tid);
  load_tile_async<T, D>(Ks, kb, sk.l, 0, L, W, tid);
  load_tile_async<T, D>(Vs, vb, sv.l, 0, L, W, tid);
  cp_async_commit();

  // the softmax runs in base 2 on the raw logits: p = 2^(s c - m), c = scale
  // * log2(e), m the running max of s c; tile 0 always holds column 0, so m
  // is finite from the first tile on
  const float c = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[D / 8][4];
  zero(acc);
  // this warp's 16 Q rows, loaded once at D = 64 (at D = 128 the fragments
  // would take 128 registers: they are read from shared memory per tile)
  AFrags<T> qf;
  const int n_tiles = (L + kRows - 1) / kRows;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {  // the next K/V tile into the other stage
      load_tile_async<T, D>(Ks + (st ^ 1) * kT, kb, sk.l, (j + 1) * kRows, L, W, tid);
      load_tile_async<T, D>(Vs + (st ^ 1) * kT, vb, sv.l, (j + 1) * kRows, L, W, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (D == 64)
      if (j == 0) load_a(qf, Qs + warp * 16 * P, lane);

    float s[8][4];
    zero(s);
    if constexpr (D == 64) mma_nt(s, qf, Ks + st * kT, lane);
    else mma_nt<D>(s, Qs + warp * 16 * P, Ks + st * kT, lane);

    if ((j + 1) * kRows > L) {  // the ragged last tile: columns past L drop out
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * kRows + 8 * n + 2 * t + (e % 2) >= L) s[n][e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * c);
      alpha[r] = exp2_fast(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_fast(fmaf(s[n][e], c, -m[e / 2]));
        rs[e / 2] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);

    // O += P V: the tensor cores' fp32 accumulation truncates, so a running
    // sum over 16 tiles (L=1024) drifts by ~1e-5 against the strict
    // tolerance of 2e-5; each tile's PV goes into a zeroed accumulator and
    // joins the sum by a rounded fp32 FMA instead
    float pv[D / 8][4];
    zero(pv);
    mma_nn<false, D>(pv, s, Vs + st * kT, lane);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], alpha[e / 2], pv[n][e]);
    __syncthreads();  // this stage is free for the load two tiles on
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int row0 = q0 + warp * 16;
  store_rows<T, D>(o, acc, b, h, H, L, W, row0, lane, inv);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + lane / 4 + 8 * r;
      if (row < L) lse[(size_t)bh * L + row] = (m[r] + log2f(l[r])) / kLog2e;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int L, int W, Strides sq, Strides sk, Strides sv, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = 5 * kTile<T, D> * sizeof(T);  // Q, two K and two V stages
  cudaError_t err = cudaFuncSetAttribute(attention_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kRows - 1) / kRows, B * H);
  attention_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, L, W, sq, sk, sv, scale);
  return cudaGetLastError();
}

}  // namespace fp32

namespace sm90 {

using namespace hopper;

constexpr int kFwdStages = 3;

// Shared memory of attention_fwd_sm90: byte offsets from a 1024-byte
// boundary, and the bytes to ask for (1024 to spare for the alignment).
template <int NWG, int BN, int KD> struct FwdSmem {
  static constexpr int q = 0;                                        // NWG 64-row tiles
  static constexpr int k = q + NWG * tile_bytes<KD>(64);             // kFwdStages tiles
  static constexpr int v = k + kFwdStages * tile_bytes<KD>(BN);      // kFwdStages tiles
  static constexpr int bars = v + kFwdStages * tile_bytes<KD>(BN);   // q_full, k_full, v_full, empty
  static constexpr int bytes = bars + 8 * (1 + 3 * kFwdStages) + 1024;
};

// The online softmax of one tile's logits sc, columns col0 .. col0 + BN - 1
// (those at or past L drop out), in place, in base 2 on the raw logits: p =
// 2^(s c - m), c = scale * log2(e), m the running max of s c (tile 0
// always holds column 0, so m is finite from the first tile on). Updates m
// and the running sum l and gives alpha, the factor of the output so far.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], int col0, int L, int t, float c,
                                             float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  if (col0 + BN > L) {  // the ragged last tile
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      if (col0 + 8 * (i / 4) + 2 * t + (i % 2) >= L) sc[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * c);
    alpha[r] = exp2_fast(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    sc[i] = exp2_fast(fmaf(sc[i], c, -m[(i / 2) % 2]));
    rs[(i / 2) % 2] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
}

// KD / 64 accumulators of 64 columns each (one per atom of the head).
template <int KD> using Acc = float[KD / 64][32];

template <int NWG, int BN, int KD>
__global__ void __launch_bounds__(kBlockThreads<NWG>, 1)
    attention_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int H, int L, int W, float scale) {
  using Smem = FwdSmem<NWG, BN, KD>;
  constexpr int kQ = tile_bytes<KD>(64), kKV = tile_bytes<KD>(BN), kA = KD / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Smem::bars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kFwdStages;
  uint64_t* empty = v_full + kFwdStages;
  auto Ks = [&](int s) { return smem + Smem::k + s * kKV; };
  auto Vs = [&](int s) { return smem + Smem::v + s * kKV; };

  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * 64 * NWG;
  const int n_tiles = (L + BN - 1) / BN;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kWarpgroup * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWarpgroup * NWG) {  // the producer warp
    if (threadIdx.x == kWarpgroup * NWG) {
      mbar_expect_tx(q_full, NWG * kQ);
      for (int w = 0; w < NWG; ++w)
        tma_tile<KD, 64>(smem + Smem::q + w * kQ, &tq, q_full, h, q0 + 64 * w, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kFwdStages;
        mbar_wait(&empty[s], ((j / kFwdStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], kKV);
        tma_tile<KD, BN>(Ks(s), &tk, &k_full[s], h, j * BN, b);
        mbar_expect_tx(&v_full[s], kKV);
        tma_tile<KD, BN>(Vs(s), &tv, &v_full[s], h, j * BN, b);
      }
    }
    return;
  }

  // consumer warpgroup w: query rows q0 + 64 w .. q0 + 64 w + 63
  const int w = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int row0 = q0 + 64 * w + 16 * warp;  // this thread's rows: row0 + g, row0 + g + 8
  const unsigned char* Qw = smem + Smem::q + w * kQ;
  const float c = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2], sc[BN / 2];
  Acc<KD> acc;
  uint32_t pa[BN / 16][4];  // P rounded to bf16 (as p.astype(v.dtype) rounds it)
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  uint64_t dq[KD / 16], dk[KD / 16], dv[kA][BN / 16];
#pragma unroll
  for (int k = 0; k < KD / 16; ++k) dq[k] = desc_k(Qw) + desc_k_step<64>(k);
  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);
  wgmma_fence();
  mma_ss<BN, KD>(sc, Qw, Ks(0));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(sc);
  softmax_tile<BN>(sc, 0, L, t, c, m, l, alpha);
  to_a<BN>(sc, pa);
  // Tile j: S of tile j + 1 is issued, then O += P V of tile j; the softmax
  // of tile j + 1 runs on the CUDA cores while PV is on the tensor cores.
  // As in FlashAttention-3, no operand of a product in flight is written:
  // the descriptors are set before the fence, the softmax works on S in
  // place, and P joins the A registers only once PV has retired.
  int j = 0;
  for (; j + 1 < n_tiles; ++j) {
    const int s = j % kFwdStages, s1 = (j + 1) % kFwdStages;
#pragma unroll
    for (int k = 0; k < KD / 16; ++k) dk[k] = desc_k(Ks(s1)) + desc_k_step<BN>(k);
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) dv[a][k] = desc_mn(atom(Vs(s), a, BN)) + k * kDescMN16;
    pin(dq);
    pin(dk);
#pragma unroll
    for (int a = 0; a < kA; ++a) pin(dv[a]);
    mbar_wait(&k_full[s1], ((j + 1) / kFwdStages) & 1);
    mbar_wait(&v_full[s], (j / kFwdStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KD / 16; ++k) Wgmma<BN>::ss(sc, dq[k], dk[k], k);
    wgmma_commit();
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) Wgmma<64>::rs_t(acc[a], pa[k], dv[a][k]);  // O += P V
    wgmma_commit();
    wgmma_wait<1>();  // S of tile j + 1; PV may still run
    reg_fence(sc);
    softmax_tile<BN>(sc, (j + 1) * BN, L, t, c, m, l, alpha);
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < kA; ++a) reg_fence(acc[a]);
    mbar_arrive(&empty[s]);  // this stage is free for the load kFwdStages tiles on
    to_a<BN>(sc, pa);
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] *= alpha[(i / 2) % 2];
  }
  mbar_wait(&v_full[j % kFwdStages], (j / kFwdStages) & 1);
  wgmma_fence();
#pragma unroll
  for (int a = 0; a < kA; ++a) mma_rs<BN>(acc[a], pa, atom(Vs(j % kFwdStages), a, BN));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < kA; ++a) reg_fence(acc[a]);

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int a = 0; a < kA; ++a) store_rows<KD>(o, acc[a], b, h, H, L, W, a, row0, lane, inv);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + lane / 4 + 8 * r;
      if (row < L) lse[(size_t)bh * L + row] = (m[r] + log2f(l[r])) / kLog2e;
    }
  }
}

template <int NWG, int BN, int KD> struct Fwd {
  static constexpr int threads = kBlockThreads<NWG>, smem = FwdSmem<NWG, BN, KD>::bytes;

  static cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                            void* o, float* lse, int B, int H, int L, int W, float scale,
                            cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_sm90<NWG, BN, KD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((L + 64 * NWG - 1) / (64 * NWG), B * H);
    attention_fwd_sm90<NWG, BN, KD><<<grid, threads, smem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H, L, W, scale);
    return cudaGetLastError();
  }

  static cudaError_t query(int* out) {
    return hopper::query(attention_fwd_sm90<NWG, BN, KD>, threads, smem, out);
  }
};

// Op<NWG, BN, KD> of a plan: block_rows = 64 NWG query rows, tile_rows = BN
// (128-row blocks only with 128-row tiles: at L <= 64 the second consumer
// would have no rows), kd the head width; kd = 128 takes 64-row blocks and
// tiles only.
template <template <int, int, int> class Op, typename F>
cudaError_t with_plan(int block_rows, int tile_rows, int kd, F&& f) {
  if (kd == 128) return block_rows == 64 && tile_rows == 64 ? f(Op<1, 64, 128>())
                                                             : cudaErrorInvalidValue;
  if (kd != 64) return cudaErrorInvalidValue;
  if (block_rows == 128 && tile_rows == 128) return f(Op<2, 128, 64>());
  if (block_rows == 64 && tile_rows == 128) return f(Op<1, 128, 64>());
  if (block_rows == 64 && tile_rows == 64) return f(Op<1, 64, 64>());
  return cudaErrorInvalidValue;
}

}  // namespace sm90

}  // namespace
}  // namespace probunet

// q, k, v: (B, L, H, head_dim) of one dtype, element strides (*_sb, *_sl,
// *_sh), unit-stride head dim, 16-byte-aligned rows; head_dim 64, or a
// multiple of 8 in 72..128 (the head dim c, or the zero-padded width that
// ops/attention.py::kernel_width gives c); o: (B, L, H, head_dim)
// contiguous, same dtype; lse: null or (B*H, L) fp32. scale is 1/sqrt(c).
// block_rows and tile_rows are the bf16 kernel's plan (ops/attention.py::
// plan; 64 or 128 each); fp32 ignores them. Returns a cudaError_t code; 0
// on success.
extern "C" int probunet_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int H, int L, int head_dim,
                                      long long q_sb, long long q_sl, long long q_sh,
                                      long long k_sb, long long k_sl, long long k_sh,
                                      long long v_sb, long long v_sl, long long v_sh, float scale,
                                      int is_bf16, int block_rows, int tile_rows, void* stream) {
  using probunet::tiles::Strides;
  const int W = head_dim;
  if (W != 64 && (W <= 64 || W > 128 || W % 8)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (!is_bf16) {
    const Strides sq{q_sb, q_sl, q_sh}, sk{k_sb, k_sl, k_sh}, sv{v_sb, v_sl, v_sh};
    if (W == 64)
      return probunet::fp32::launch<float, 64>(q, k, v, o, l, B, H, L, W, sq, sk, sv, scale, st);
    return probunet::fp32::launch<float, 128>(q, k, v, o, l, B, H, L, W, sq, sk, sv, scale, st);
  }
  CUtensorMap tq, tk, tv;
  cudaError_t err = probunet::hopper::make_map(&tq, q, B, H, L, W, q_sb, q_sl, q_sh);
  if (err == cudaSuccess) err = probunet::hopper::make_map(&tk, k, B, H, L, W, k_sb, k_sl, k_sh);
  if (err == cudaSuccess) err = probunet::hopper::make_map(&tv, v, B, H, L, W, v_sb, v_sl, v_sh);
  if (err != cudaSuccess) return err;
  return probunet::sm90::with_plan<probunet::sm90::Fwd>(
      block_rows, tile_rows, W == 64 ? 64 : 128,
      [&](auto plan) { return plan.launch(tq, tk, tv, o, l, B, H, L, W, scale, st); });
}

// What the bf16 kernel of a plan at head width kd (64 or 128) is on this
// card: out = {threads, dynamic shared bytes, registers, local (spilled)
// bytes per thread, static shared bytes}. Returns a cudaError_t code; 0 on
// success.
extern "C" int probunet_attention_fwd_query(int block_rows, int tile_rows, int kd, int* out) {
  return probunet::sm90::with_plan<probunet::sm90::Fwd>(
      block_rows, tile_rows, kd, [&](auto plan) { return plan.query(out); });
}
