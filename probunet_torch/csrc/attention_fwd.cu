// Fused self-attention forward, softmax(Q (K s)^T) V with s = 1/sqrt(c) for
// a head dim c up to 128 (fp32: 256): kernel K2 of the port, for Hopper
// (sm_90a).
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
// Head dims: every kernel is instantiated for a head KD columns wide in
// shared memory (attention_hopper.cuh). c = 64 runs KD = 64. The bf16
// kernel runs the exact widths KD = 80 (64 < c <= 80: 72 at the U-Net's
// 288-wide level with model_channels 96) and 96 (80 < c <= 96): a
// 64-column atom and a 16- or 32-column tail atom, S = Q K^T in ceil(W /
// 16) k16 steps and O += P V as one m64n64k16 and one m64nTk16 per 16 keys,
// 40 / 48 accumulators a thread. 96 < c <= 128, and the fp32 kernel past 64,
// run KD = 128 with the columns past c zero. The bound at the c = 72 site
// (b8, L=1024, 4 heads) is 9.7 GFLOP, 9.8 us at 989 TFLOP/s (its bytes 5.6
// us); kD = 128 did 128/72 = 1.78x those products, and held O in 64
// registers, which kept it to 64-row blocks of one consumer. At KD = 80
// O is 40 registers, and two consumers of 64 rows each fit ptxas's 168
// with 128-row K/V tiles (167, no spill; ops/attention.py::plan takes them
// where they fill the card); at KD = 96 two consumers spill, so 64-row
// blocks and tiles (137 registers, two blocks an SM). What still holds it
// back: the softmax's ex2, which does not shrink with c, and the tail's
// m64nTk16 products, which cost about what a whole-atom product does.
// The kD = 128 kernel stays callable at c <= 96 (ops/attention.py::_launch
// kd=128), and at its block shape the exact width gives its bits.
//
// bf16: attention_fwd_sm90 (machinery in attention_hopper.cuh), the
// FlashAttention-3 shape. One block per (batch * head, 64 NWG query rows):
// NWG consumer warpgroups of 64 query rows each and a producer warp, whose
// one thread loads the block's Q and then keeps TMA loads of BN-row K and V
// tiles in flight through a ring of kFwdStages stages under mbarriers. A
// consumer runs S = Q K^T on wgmma from the two shared tiles (m64nBNk16,
// K-major), the online softmax in fp32 registers, and O += P V on wgmma
// with P in registers as the A operand and V read MN-major (m64n64k16, one
// per 64-column atom of the head, and m64nTk16 on a tail atom).
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
// fp32: attention_fwd_f32, 3xTF32 on tf32 wgmma (attention_hopper.cuh,
// "fp32 (strict) operands"). One block per (batch * head, 64 query rows):
// a consumer warpgroup and a producer warpgroup. The producer's first
// thread loads Q once and each BN-row K/V tile by TMA into a ring of
// kFwdStages32 stages; its 128 threads split Q and each K tile into tf32 hi
// and lo in place, once per block (not once per warp per product), and
// write V's transpose as a hi / lo pair, since tf32 wgmma reads K-major
// operands only (FlashAttention-3's fp8 forward transposes V in its
// producer for the same reason). The consumer runs S = Q K^T (m64nBNk8, A
// and B from shared memory), the online softmax, and P V (m64nKDk8, P
// split in registers as the A operand), three products per k8 step; each
// tile's P V goes into a fresh accumulator and joins O by an fp32 FMA. BN =
// 64 at KD = 64; 32 at KD = 128, where O and P V are 64 registers a thread
// each (ops/attention.py::fp32_plan). A ragged last tile is masked. What
// holds it back: one consumer warpgroup per SM (the ring takes 193 KB at
// KD = 64, 225 KB at KD = 128), whose products wait for the softmax and
// the split of P.
//
// Layout: q, k, v are (B, L, heads, W) with any element strides (sb, sl,
// sh) and a unit-stride head dim, each row 16-byte aligned, W = 64 or a
// multiple of 8 in 72..KD (the head dim, or the zero-padded width the
// wrapper copied it to), W <= KD: the U-Net block's q/k/v views of its qkv
// conv output are read where the conv wrote them. The output is contiguous (B,
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

namespace probunet {
namespace {

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

// kAtoms accumulators of 64 columns each (one per whole atom of the head);
// the tail's is a TailAcc.
template <int KD> using Acc = float[kAtoms<KD>][32];

template <int NWG, int BN, int KD>
__global__ void __launch_bounds__(kBlockThreads<NWG>, 1)
    attention_fwd_sm90(const __grid_constant__ TileMap tq, const __grid_constant__ TileMap tk,
                       const __grid_constant__ TileMap tv, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int H, int L, int W, float scale) {
  using Smem = FwdSmem<NWG, BN, KD>;
  constexpr int kQ = tile_bytes<KD>(64), kKV = tile_bytes<KD>(BN), kA = kAtoms<KD>;
  constexpr int kT = kTail<KD>;
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
  TailAcc<KD> acc_t;
  uint32_t pa[BN / 16][4];  // P rounded to bf16 (as p.astype(v.dtype) rounds it)
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  if constexpr (kT != 0) zero(acc_t);
  // the tail's descriptors are one base, stepped at each product: pinning
  // all BN / 16 of them spilled a two-consumer block at KD = 80
  uint64_t dq[KD / 16], dk[KD / 16], dv[kA][BN / 16], dv_t[1];
#pragma unroll
  for (int k = 0; k < KD / 16; ++k) dq[k] = desc_k_at<64, KD>(Qw, k);
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
    for (int k = 0; k < KD / 16; ++k) dk[k] = desc_k_at<BN, KD>(Ks(s1), k);
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) dv[a][k] = desc_mn(atom(Vs(s), a, BN)) + k * kDescMN16;
    if constexpr (kT != 0) dv_t[0] = desc_mn_tail<kT>(tail<KD>(Vs(s), BN));
    pin(dq);
    pin(dk);
#pragma unroll
    for (int a = 0; a < kA; ++a) pin(dv[a]);
    if constexpr (kT != 0) pin(dv_t);
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
    if constexpr (kT != 0)
#pragma unroll
      for (int k = 0; k < BN / 16; ++k)
        Wgmma<kT>::rs_t(acc_t, pa[k], dv_t[0] + k * desc_mn_tail_step<kT>);
    wgmma_commit();
    wgmma_wait<1>();  // S of tile j + 1; PV may still run
    reg_fence(sc);
    softmax_tile<BN>(sc, (j + 1) * BN, L, t, c, m, l, alpha);
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < kA; ++a) reg_fence(acc[a]);
    if constexpr (kT != 0) reg_fence(acc_t);
    mbar_arrive(&empty[s]);  // this stage is free for the load kFwdStages tiles on
    to_a<BN>(sc, pa);
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] *= alpha[(i / 2) % 2];
    if constexpr (kT != 0)
#pragma unroll
      for (int i = 0; i < kT / 2; ++i) acc_t[i] *= alpha[(i / 2) % 2];
  }
  mbar_wait(&v_full[j % kFwdStages], (j / kFwdStages) & 1);
  wgmma_fence();
#pragma unroll
  for (int a = 0; a < kA; ++a) mma_rs<BN>(acc[a], pa, atom(Vs(j % kFwdStages), a, BN));
  if constexpr (kT != 0) mma_rs_tail<BN, kT>(acc_t, pa, tail<KD>(Vs(j % kFwdStages), BN));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < kA; ++a) reg_fence(acc[a]);
  if constexpr (kT != 0) reg_fence(acc_t);

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int a = 0; a < kA; ++a) store_rows<KD>(o, acc[a], b, h, H, L, W, a, row0, lane, inv);
  if constexpr (kT != 0) store_rows<KD, kT>(o, acc_t, b, h, H, L, W, kA, row0, lane, inv);
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

  static cudaError_t launch(const TileMap& tq, const TileMap& tk, const TileMap& tv, void* o,
                            float* lse, int B, int H, int L, int W, float scale,
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

// Op<NWG, BN, KD> of a plan (ops/attention.py::plan): block_rows = 64 NWG
// query rows, tile_rows = BN, kd = KD the head width; the shapes the plan
// gives each width and no other. 128-row blocks only with 128-row tiles (at
// L <= 64 the second consumer would have no rows); kd = 96 and 128 take
// 64-row blocks and tiles only (two consumers spill there).
template <template <int, int, int> class Op, typename F>
cudaError_t with_plan(int block_rows, int tile_rows, int kd, F&& f) {
  if (kd == 64 && block_rows == 128 && tile_rows == 128) return f(Op<2, 128, 64>());
  if (kd == 64 && block_rows == 64 && tile_rows == 128) return f(Op<1, 128, 64>());
  if (kd == 64 && block_rows == 64 && tile_rows == 64) return f(Op<1, 64, 64>());
  if (kd == 80 && block_rows == 128 && tile_rows == 128) return f(Op<2, 128, 80>());
  if (kd == 80 && block_rows == 64 && tile_rows == 64) return f(Op<1, 64, 80>());
  if (kd == 96 && block_rows == 64 && tile_rows == 64) return f(Op<1, 64, 96>());
  if (kd == 128 && block_rows == 64 && tile_rows == 64) return f(Op<1, 64, 128>());
  return cudaErrorInvalidValue;
}

}  // namespace sm90

namespace f32 {

using namespace hopper;

constexpr int kFwdStages32 = 2;

// Shared memory of attention_fwd_f32: byte offsets from a 1024-byte
// boundary. The block's Q as a hi / lo pair (Q lands in q_hi), then
// kFwdStages32 stages of BN-row tiles: K's pair (K lands in k_hi), V as it
// lands and V^T's pair; then the barriers.
template <int KD, int BN> struct FwdSmem32 {
  static constexpr int kQ = f32_tile_bytes<KD>(64), kT = f32_tile_bytes<KD>(BN);
  static constexpr int q_hi = 0, q_lo = kQ, stages = 2 * kQ;
  static constexpr int k_hi = 0, k_lo = kT, v_raw = 2 * kT, vt_hi = 3 * kT, vt_lo = 4 * kT,
                       stage = 5 * kT;
  static constexpr int bars = stages + kFwdStages32 * stage;
  static constexpr int bytes = bars + kRing32Bytes<kFwdStages32> + 1024;
};

// One block per (batch * head, 64 query rows): a consumer warpgroup runs S =
// Q K^T and O += P V, a producer warpgroup loads and splits Q once and each
// BN-row K/V tile (attention_hopper.cuh, "fp32 (strict) operands").
template <int KD, int BN>
__global__ void __launch_bounds__(2 * kWarpgroup, 1)
    attention_fwd_f32(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                      float* __restrict__ lse, int H, int L, int W, float scale) {
  using Smem = FwdSmem32<KD, BN>;
  constexpr int S = kFwdStages32, kQ = Smem::kQ, kT = Smem::kT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + Smem::bars);  // Q loaded, Q ready
  Ring32* ring = reinterpret_cast<Ring32*>(own + 2);
  auto tile = [&](int s, int off) { return smem + Smem::stages + s * Smem::stage + off; };
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * 64;
  const int n_tiles = (L + BN - 1) / BN;
  if (threadIdx.x == 0) ring32_init<S>(own, ring);
  __syncthreads();
  const int tid = threadIdx.x % kWarpgroup;

  if (threadIdx.x >= kWarpgroup) {  // the producer warpgroup
    if (tid == 0) {
      mbar_expect_tx(&own[0], kQ);
      tma_tile_f32<KD, 64>(smem + Smem::q_hi, &tq, &own[0], h, q0, b);
    }
    mbar_wait(&own[0], 0);
    split_tile<kQ>(smem + Smem::q_hi, smem + Smem::q_lo, tid);
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
        tma_tile_f32<KD, BN>(tile(s, Smem::k_hi), &tk, &st.loaded, h, j * BN, b);
        tma_tile_f32<KD, BN>(tile(s, Smem::v_raw), &tv, &st.loaded, h, j * BN, b);
      }
      mbar_wait(&st.loaded, ph);
      split_tile<kT>(tile(s, Smem::k_hi), tile(s, Smem::k_lo), tid);
      fence_async_smem();
      mbar_arrive(&st.nat_full);
      mbar_wait(&st.t_empty, ph ^ 1);
      transpose_tile<KD, BN, true>(tile(s, Smem::v_raw), nullptr, tile(s, Smem::vt_hi),
                                   tile(s, Smem::vt_lo), tid);
      fence_async_smem();
      mbar_arrive(&st.t_full);
    }
    return;
  }

  // the consumer warpgroup: query rows q0 .. q0 + 63, this thread's row0 +
  // g and row0 + g + 8
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int row0 = q0 + 16 * warp;
  const float c = scale * kLog2e;
  const int steps = head_steps<KD>(W);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2], sc[BN / 2], acc[KD / 2],
        pv[KD / 2];
  uint32_t pa_hi[BN / 8][4], pa_lo[BN / 8][4];  // P as the A operand of P V
  zero(acc);
  mbar_wait(&own[1], 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % S;
    const unsigned ph = (j / S) & 1;
    Ring32& st = ring[s];
    mbar_wait(&st.nat_full, ph);
    wgmma_fence();
    mma3_ss<BN, KD / 8>(sc, smem + Smem::q_hi, smem + Smem::q_lo, tile(s, Smem::k_hi),
                        tile(s, Smem::k_lo), 0, steps);  // S = Q K^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    mbar_arrive(&st.nat_empty);
    sm90::softmax_tile<BN>(sc, j * BN, L, t, c, m, l, alpha);
    split_a<BN>(sc, pa_hi, pa_lo);
    mbar_wait(&st.t_full, ph);
    // this tile's P V into a fresh accumulator, joined to O by a rounded fp32
    // FMA: the tensor cores' fp32 accumulation truncates, and a running sum
    // over the tiles of L = 1024 would drift towards the strict tolerance
    wgmma_fence();
    mma3_rs<KD, BN / 8>(pv, pa_hi, pa_lo, tile(s, Smem::vt_hi), tile(s, Smem::vt_lo), 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(pv);
    mbar_arrive(&st.t_empty);
#pragma unroll
    for (int i = 0; i < KD / 2; ++i) acc[i] = fmaf(acc[i], alpha[(i / 2) % 2], pv[i]);
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  store_rows_f32<KD>(o, acc, b, h, H, L, W, row0, lane, inv);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + lane / 4 + 8 * r;
      if (row < L) lse[(size_t)bh * L + row] = (m[r] + log2f(l[r])) / kLog2e;
    }
  }
}

template <int KD, int BN> struct Fwd32 {
  static constexpr int threads = 2 * kWarpgroup, smem = FwdSmem32<KD, BN>::bytes;

  static cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                            void* o, float* lse, int B, int H, int L, int W, float scale,
                            cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_f32<KD, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((L + 63) / 64, B * H);
    attention_fwd_f32<KD, BN><<<grid, threads, smem, stream>>>(
        tq, tk, tv, static_cast<float*>(o), lse, H, L, W, scale);
    return cudaGetLastError();
  }

  static cudaError_t query(int* out) {
    return hopper::query(attention_fwd_f32<KD, BN>, threads, smem, out);
  }
};

// ---- kD = 256: the head streamed through shared memory in chunks ----------
//
// A head of 256 fp32 columns (CorrDiff's one head at its 28x28 level) does
// not fit attention_fwd_f32's layout: Q's hi / lo pair alone is 128 KB, and
// one 32-row K tile's pair 64 KB more. So attention_fwd_f32_wide keeps Q's
// pair (split once, as above) and streams K and V through a ring of
// kWideSlots slots of kChunk (64) head columns each: per K/V tile, the
// KD / kChunk chunks of K, then the chunks of V that the block's output
// columns need. A K chunk is split into its hi / lo pair in place; a V
// chunk is transposed into its pair (V^T, kChunk rows of BN keys). The
// consumer runs S = Q K^T chunk by chunk, each chunk's product into a fresh
// accumulator joined to S by an fp32 add (the tensor cores' accumulation
// truncates; at most 8 k8 steps sum there, as at KD = 64), the online
// softmax, then P V chunk by chunk into a fresh accumulator joined to O by
// an fp32 FMA, as attention_fwd_f32 does per tile.
//
// Columns: each block computes S whole and O for OC of the 256 columns
// (blockIdx.z picks which): O is OC / 2 registers a thread, 64 at OC = 128
// where all 256 would take 128 and crowd the split of P and the products'
// accumulators. Two blocks per 64 query rows compute the same S twice (1.5
// times the products of one block), and double the blocks: at CorrDiff's
// site (b2, L = 784, one head) 26 blocks of 64 rows would leave 106 of the
// H100's 132 SMs idle.
//
// Bound: operations, 4 B heads L^2 c FLOP against three TF32 products (165
// TFLOP/s): 1.26 GFLOP, 7.6 us at CorrDiff's site; a block's 64 rows run
// 3/4 of a row's products of that site on one SM, in the ring's order.

constexpr int kWideSlots = 4;
constexpr int kChunk = 64;   // head columns per streamed chunk

// Shared memory of attention_fwd_f32_wide: Q's hi / lo pair (Q lands in
// q_hi), then kWideSlots slots of three chunk tiles of BN rows (a: the
// chunk as it lands, split in place; b, c: K's lo, or V^T's hi and lo).
template <int KD, int BN> struct WideSmem32 {
  static constexpr int kQ = f32_tile_bytes<KD>(64), kC = f32_tile_bytes<kChunk>(BN);
  static constexpr int q_hi = 0, q_lo = kQ, slots = 2 * kQ;
  static constexpr int a = 0, b = kC, c = 2 * kC, slot = 3 * kC;
  static constexpr int bars = slots + kWideSlots * slot;
  static constexpr int bytes = bars + kRing32Bytes<kWideSlots> + 1024;
};

// Rows row0 + g and row0 + g + 8 of a warp's accumulator of kChunk columns,
// scaled by mul, into columns col0 .. of a contiguous (B, L, H, W) fp32
// tensor; rows at or past L and columns at or past W are not written.
__device__ __forceinline__ void store_chunk_f32(float* __restrict__ out,
                                                const float (&d)[kChunk / 2], int b, int h,
                                                int H, int L, int W, int col0, int row0,
                                                int lane, const float (&mul)[2]) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
    float* p = out + (((size_t)b * L + row) * H + h) * W + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j)
      if (col0 + 8 * j + 2 * t < W)
        *reinterpret_cast<float2*>(p + 8 * j) =
            make_float2(d[4 * j + 2 * r] * mul[r], d[4 * j + 2 * r + 1] * mul[r]);
  }
}

// One block per (64 query rows, batch * head, OC output columns): a consumer
// and a producer warpgroup, as attention_fwd_f32.
template <int KD, int BN, int OC>
__global__ void __launch_bounds__(2 * kWarpgroup, 1)
    attention_fwd_f32_wide(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                           float* __restrict__ lse, int H, int L, int W, float scale) {
  using Smem = WideSmem32<KD, BN>;
  constexpr int S = kWideSlots, kKC = KD / kChunk, kVC = OC / kChunk;
  constexpr int kQC = f32_tile_bytes<kChunk>(64);  // a chunk of Q's 64 rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + Smem::bars);  // Q loaded, Q ready
  Ring32* ring = reinterpret_cast<Ring32*>(own + 2);
  auto slot = [&](int s, int off) { return smem + Smem::slots + s * Smem::slot + off; };
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * 64;
  const int col0 = blockIdx.z * OC;
  const int n_tiles = (L + BN - 1) / BN;
  if (threadIdx.x == 0) ring32_init<S>(own, ring);
  __syncthreads();
  const int tid = threadIdx.x % kWarpgroup;

  if (threadIdx.x >= kWarpgroup) {  // the producer warpgroup
    if (tid == 0) {
      mbar_expect_tx(&own[0], Smem::kQ);
      tma_tile_f32<KD, 64>(smem + Smem::q_hi, &tq, &own[0], h, q0, b);
    }
    mbar_wait(&own[0], 0);
    split_tile<Smem::kQ>(smem + Smem::q_hi, smem + Smem::q_lo, tid);
    fence_async_smem();
    mbar_arrive(&own[1]);
    int n = 0;  // chunks through the ring so far
    for (int j = 0; j < n_tiles; ++j) {
      for (int i = 0; i < kKC + kVC; ++i, ++n) {
        const int s = n % S;
        const unsigned ph = (n / S) & 1;
        const bool key = i < kKC;
        Ring32& st = ring[s];
        producer_sync();  // every producer thread is done with this slot's last chunk
        if (tid == 0) {
          mbar_wait(&st.nat_empty, ph ^ 1);
          mbar_expect_tx(&st.loaded, Smem::kC);
          const int col = key ? kChunk * i : col0 + kChunk * (i - kKC);
#pragma unroll
          for (int a = 0; a < kChunk / kF32Cols; ++a)
#pragma unroll
            for (int r = 0; r < BN / kF32BoxRows; ++r)
              tma_load(slot(s, Smem::a) + a * BN * kAtomBytes + r * kF32BoxRows * kAtomBytes,
                       key ? &tk : &tv, &st.loaded, h, j * BN + kF32BoxRows * r, b,
                       col + kF32Cols * a);
        }
        mbar_wait(&st.loaded, ph);
        if (key)
          split_tile<Smem::kC>(slot(s, Smem::a), slot(s, Smem::b), tid);
        else
          transpose_tile<kChunk, BN, true>(slot(s, Smem::a), nullptr, slot(s, Smem::b),
                                           slot(s, Smem::c), tid);
        fence_async_smem();
        mbar_arrive(&st.nat_full);
      }
    }
    return;
  }

  // the consumer warpgroup: query rows q0 .. q0 + 63, this thread's row0 +
  // g and row0 + g + 8
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int row0 = q0 + 16 * warp;
  const float c = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2], sc[BN / 2], part[BN / 2],
        pv[kChunk / 2], acc[kVC][kChunk / 2];
  uint32_t pa_hi[BN / 8][4], pa_lo[BN / 8][4];  // P as the A operand of P V
#pragma unroll
  for (int i = 0; i < kVC; ++i) zero(acc[i]);
  mbar_wait(&own[1], 0);
  int n = 0;
  for (int j = 0; j < n_tiles; ++j) {
#pragma unroll
    for (int i = 0; i < kKC; ++i, ++n) {  // S = Q K^T, a chunk of the head at a time
      Ring32& st = ring[n % S];
      mbar_wait(&st.nat_full, (n / S) & 1);
      wgmma_fence();
      mma3_ss<BN, kChunk / 8>(part, smem + Smem::q_hi + i * kQC, smem + Smem::q_lo + i * kQC,
                              slot(n % S, Smem::a), slot(n % S, Smem::b), 0, kChunk / 8);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(part);
      mbar_arrive(&st.nat_empty);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sc[e] = i == 0 ? part[e] : sc[e] + part[e];
    }
    sm90::softmax_tile<BN>(sc, j * BN, L, t, c, m, l, alpha);
    split_a<BN>(sc, pa_hi, pa_lo);
#pragma unroll
    for (int i = 0; i < kVC; ++i, ++n) {  // O += P V, a chunk of the output at a time
      Ring32& st = ring[n % S];
      mbar_wait(&st.nat_full, (n / S) & 1);
      wgmma_fence();
      mma3_rs<kChunk, BN / 8>(pv, pa_hi, pa_lo, slot(n % S, Smem::b), slot(n % S, Smem::c), 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(pv);
      mbar_arrive(&st.nat_empty);
#pragma unroll
      for (int e = 0; e < kChunk / 2; ++e) acc[i][e] = fmaf(acc[i][e], alpha[(e / 2) % 2], pv[e]);
    }
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int i = 0; i < kVC; ++i)
    store_chunk_f32(o, acc[i], b, h, H, L, W, col0 + kChunk * i, row0, lane, inv);
  if (lse != nullptr && blockIdx.z == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + lane / 4 + 8 * r;
      if (row < L) lse[(size_t)bh * L + row] = (m[r] + log2f(l[r])) / kLog2e;
    }
  }
}

template <int KD, int BN, int OC> struct Wide32 {
  static constexpr int threads = 2 * kWarpgroup, smem = WideSmem32<KD, BN>::bytes;

  static cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                            void* o, float* lse, int B, int H, int L, int W, float scale,
                            cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_f32_wide<KD, BN, OC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((L + 63) / 64, B * H, KD / OC);
    attention_fwd_f32_wide<KD, BN, OC><<<grid, threads, smem, stream>>>(
        tq, tk, tv, static_cast<float*>(o), lse, H, L, W, scale);
    return cudaGetLastError();
  }

  static cudaError_t query(int* out) {
    return hopper::query(attention_fwd_f32_wide<KD, BN, OC>, threads, smem, out);
  }
};

// The kernel of an fp32 plan (ops/attention.py::fp32_plan): head width kd,
// BN = tile_rows K/V rows per tile: 64 at kd 64; 32 at kd 128, where O and
// this tile's P V are 64 registers a thread each; 32 at kd 256, streamed in
// 64-column chunks, 128 output columns a block.
template <typename F> cudaError_t with_plan(int kd, int tile_rows, F&& f) {
  if (kd == 64 && tile_rows == 64) return f(Fwd32<64, 64>());
  if (kd == 128 && tile_rows == 32) return f(Fwd32<128, 32>());
  if (kd == 256 && tile_rows == 32) return f(Wide32<256, 32, 128>());
  return cudaErrorInvalidValue;
}

}  // namespace f32

}  // namespace
}  // namespace probunet

// q, k, v: (B, L, H, head_dim) of one dtype, element strides (*_sb, *_sl,
// *_sh), unit-stride head dim, 16-byte-aligned rows; head_dim 64, or a
// multiple of 8 in 72..128 (fp32: 72..256) (the head dim c, or the zero-padded width that
// ops/attention.py::kernel_width gives c); o: (B, L, H, head_dim)
// contiguous, same dtype; lse: null or (B*H, L) fp32. scale is 1/sqrt(c).
// block_rows, tile_rows and kd are the plan's (ops/attention.py::plan for
// bf16: 64 or 128 rows each, kd 64, 80, 96 or 128; fp32_plan for fp32: 64,
// its K/V tile rows and kd 64, 128 or 256); a kd not built, or narrower than
// head_dim, is refused. Returns a cudaError_t code; 0 on success.
extern "C" int probunet_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int H, int L, int head_dim,
                                      long long q_sb, long long q_sl, long long q_sh,
                                      long long k_sb, long long k_sl, long long k_sh,
                                      long long v_sb, long long v_sl, long long v_sh, float scale,
                                      int is_bf16, int block_rows, int tile_rows, int kd,
                                      void* stream) {
  using probunet::hopper::make_map;
  const int W = head_dim;
  if (!probunet::hopper::head_width_ok(W, kd, is_bf16)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (!is_bf16) {
    const int box = probunet::hopper::kF32BoxRows;
    CUtensorMap tq, tk, tv;
    cudaError_t err = make_map(&tq, q, B, H, L, W, q_sb, q_sl, q_sh, 4, box);
    if (err == cudaSuccess) err = make_map(&tk, k, B, H, L, W, k_sb, k_sl, k_sh, 4, box);
    if (err == cudaSuccess) err = make_map(&tv, v, B, H, L, W, v_sb, v_sl, v_sh, 4, box);
    if (err != cudaSuccess) return err;
    if (block_rows != 64) return cudaErrorInvalidValue;
    return probunet::f32::with_plan(
        kd, tile_rows, [&](auto plan) { return plan.launch(tq, tk, tv, o, l, B, H, L, W, scale, st); });
  }
  using probunet::hopper::make_tile_map;
  probunet::hopper::TileMap tq, tk, tv;
  cudaError_t err = make_tile_map(&tq, q, B, H, L, W, q_sb, q_sl, q_sh, kd);
  if (err == cudaSuccess) err = make_tile_map(&tk, k, B, H, L, W, k_sb, k_sl, k_sh, kd);
  if (err == cudaSuccess) err = make_tile_map(&tv, v, B, H, L, W, v_sb, v_sl, v_sh, kd);
  if (err != cudaSuccess) return err;
  return probunet::sm90::with_plan<probunet::sm90::Fwd>(
      block_rows, tile_rows, kd,
      [&](auto plan) { return plan.launch(tq, tk, tv, o, l, B, H, L, W, scale, st); });
}

// What the bf16 kernel of a plan at head width kd (64, 80, 96 or 128) is on
// this card: out = {threads, dynamic shared bytes, registers, local
// (spilled) bytes per thread, static shared bytes}. Returns a cudaError_t
// code; 0 on success.
extern "C" int probunet_attention_fwd_query(int block_rows, int tile_rows, int kd, int* out) {
  return probunet::sm90::with_plan<probunet::sm90::Fwd>(
      block_rows, tile_rows, kd, [&](auto plan) { return plan.query(out); });
}

// The same for the fp32 kernel of the fp32 plan at head width kd with K/V
// tiles of tile_rows rows.
extern "C" int probunet_attention_fwd_f32_query(int kd, int tile_rows, int* out) {
  return probunet::f32::with_plan(kd, tile_rows, [&](auto plan) { return plan.query(out); });
}
