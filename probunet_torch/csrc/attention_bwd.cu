// Fused self-attention backward for Hopper (sm_90a): the gradients of
// O = softmax(Q (K s)^T) V, s = 1/sqrt(64), with respect to Q, K and V,
// FlashAttention-2 style on the tensor cores, deterministic (no atomics).
//
// Replaces probunet_tpu/ops/pallas_attn.py::_bwd_kernel (launched by
// _bwd_pallas). That kernel walks 256-row q chunks along a sequential grid
// axis and accumulates dK and dV across them in its output block
// (pl.when(ci == 0) zeroes it first). Hopper blocks run in no order, so the
// work is cut into three kernels that each own what they write:
//   (a) attention_bwd_rowdot: D = rowsum(dO o O), one block per (batch *
//       head, 64-row tile), as the diagonal of dO O^T on the tensor cores;
//   (b) attention_bwd_dkdv: one block per (batch * head, 64-row K/V tile)
//       loops over the q tiles and keeps dK and dV in registers;
//   (c) attention_bwd_dq: one block per (batch * head, 64-row q tile) loops
//       over the K/V tiles and keeps dQ in registers.
// (b) and (c) recompute the weights as P = exp(S s - lse) from the row
// log-sum-exp that the forward kernel (attention_fwd.cu) saved, so no
// (L, L) tensor reaches device memory; like the forward kernel they take
// the exponential in base 2 by the SFU's ex2 (about 2 ulp).
//
// Bound: operations, 10 * B * heads * L^2 * 64 FLOP (the TPU kernel's five
// L x L x 64 products: S, dV, dP, dQ, dK), against the bf16 tensor-core
// rate in fast mode and, in strict mode, the smaller of the fp32 CUDA-core
// time and three TF32 tensor-core products. This design does seven
// products (S and dP in both (b) and (c)).
//
// Design (tile machinery in attention_tiles.cuh): four warps per block, 16
// rows each; the block's own tiles are loaded once and the streamed tiles
// pass through a 2-stage cp.async ring. Every product runs on mma.sync
// with fp32 accumulators in registers. In (b) each warp owns 16 keys and
// computes the transposed products S^T = K Q^T and dP^T = V dO^T directly,
// so P^T and dS^T sit in registers in the C layout and feed dV += P^T dO
// and dK += dS^T Q as A operands; the transposed B operands (dO and Q read
// down their rows) come from ldmatrix.trans in bf16 and from scalar shared
// reads in fp32. Neither P^T nor dS^T passes through shared memory.
//
// Layout: q, k, v, o (the forward output) and dout are (B, L, heads, 64)
// with any element strides and a unit-stride head dim, rows 16-byte
// aligned; dq, dk, dv are contiguous (B, L, heads, 64).
//
// Numerics follow _bwd_kernel (pallas_attn.py:101-135):
//   - S is recomputed on the forward kernel's operands with the same
//     products in the same order (in (b) as S^T = K Q^T, the 3xTF32 terms
//     ordered as in Q K^T). P = exp(S s - lse) is not bit-equal to the
//     forward kernel's weights, whose lse sums them in another order: they
//     differ by a few fp32 ulps;
//   - D and dP are the same tensor-core products (see (a)), so dS = 0
//     exactly where the plain version's is (a one-hot softmax row);
//   - the dV and dP legs run at the model dtype: P is rounded to T before
//     dV = P^T dO, and dP = dO V^T multiplies T-valued operands with fp32
//     sums;
//   - dS = P o (dP - D) is fp32, rounded to bf16 before dQ and dK only when
//     FAST; strict mode with bf16 activations keeps dS fp32 by carrying it
//     as two bf16 terms hi + lo (two products, ~2^-16 relative);
//   - fp32 (strict) products are 3xTF32;
//   - dQ = (dS K) * s with the raw K, dK = (dS^T Q) * s;
//   - D = rowsum(dO o O) stands for the TPU kernel's rowsum(dP o P). The two
//     are equal up to rounding in fp32; with bf16 activations (fast mode
//     and strict mode alike) O is stored as bf16, which moves dQ and dK by
//     ~1e-3 of their norm, within the bf16 tolerance of 5e-2 (chip_smoke.py
//     phase 7 measures it).
// A ragged last tile is zero-filled and masked (P = 0 there), so any L
// works.

#include <math.h>

#include "attention_tiles.cuh"

namespace probunet {
namespace {

using namespace tiles;

// D = rowsum(dO o O) as the diagonal of the tile product dO O^T, on the
// tensor cores in the same form as dP = dO V^T in (b) and (c). Where a row's
// softmax is one-hot (L = 1), O is that row of V as the forward kernel's
// PV product rounds it, D comes out equal to dP, and dS = P o (dP - D)
// vanishes as it does in the plain version (an fp32 D from CUDA-core FMAs
// left ~1e-6 there against 3xTF32's dP).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_rowdot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ D,
                         int H, int L, Strides so, Strides sdo) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = kPitch<T>;
  T* dOs = reinterpret_cast<T*>(smem);
  T* Os = dOs + kTile<T>;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  load_tile_async(dOs, dout + b * sdo.b + h * sdo.h, sdo.l, r0, L, tid);
  load_tile_async(Os, o + b * so.b + h * so.h, so.l, r0, L, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float acc[8][4];
  zero(acc);
  mma_nt(acc, dOs + warp * 16 * P, Os, lane);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = warp * 16 + lane / 4 + 8 * (e / 2);
      if (8 * n + 2 * t + (e % 2) == row && r0 + row < L)
        D[(size_t)bh * L + r0 + row] = acc[n][e];
    }
}

// Products with dS as the A operand: bf16 strict keeps dS fp32 as hi + lo.
template <typename T, bool FAST>
constexpr bool kSplitDs = !FAST && sizeof(T) == 2;

template <typename T, bool FAST>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ D, T* __restrict__ dk, T* __restrict__ dv, int H,
                       int L, Strides sq, Strides sk, Strides sv, Strides sdo, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = kPitch<T>;
  T* Ks = reinterpret_cast<T*>(smem);   // this block's K tile
  T* Vs = Ks + kTile<T>;                // this block's V tile
  T* Qs = Vs + kTile<T>;                // two stages
  T* dOs = Qs + 2 * kTile<T>;           // two stages
  float* stats = reinterpret_cast<float*>(dOs + 2 * kTile<T>);  // per stage: lse[64], D[64]

  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;

  load_tile_async(Ks, k + b * sk.b + h * sk.h, sk.l, k0, L, tid);
  load_tile_async(Vs, v + b * sv.b + h * sv.h, sv.l, k0, L, tid);
  // q tile j into stage st: Q and dO by cp.async, lse (in base 2) and D
  // (rows of a (B*H, L) array, not 16-byte aligned for every L) by plain
  // loads
  auto load_q_tile = [&](int j, int st) {
    load_tile_async(Qs + st * kTile<T>, qb, sq.l, j * kRows, L, tid);
    load_tile_async(dOs + st * kTile<T>, dob, sdo.l, j * kRows, L, tid);
    const int i = j * kRows + tid % kRows;
    const float* src = (tid < kRows ? lse : D) + (size_t)bh * L;
    stats[st * 2 * kRows + tid] = i < L ? src[i] * (tid < kRows ? kLog2e : 1.f) : 0.f;
  };
  load_q_tile(0, 0);
  cp_async_commit();

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  const int key0 = k0 + warp * 16 + lane / 4;  // this thread's keys: key0, key0 + 8
  const float c = scale * kLog2e;
  const int n_tiles = (L + kRows - 1) / kRows;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_q_tile(j + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + st * kTile<T>;
    const T* dOt = dOs + st * kTile<T>;
    const float* lse_s = stats + st * 2 * kRows;
    const float* D_s = lse_s + kRows;

    // P^T: rows are this warp's keys, columns the tile's queries
    float p[8][4];
    zero(p);
    mma_nt<true>(p, Ks + warp * 16 * P, Qt, lane);  // summed as the forward's S = Q K^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e % 2);
        const bool ok = key0 + 8 * (e / 2) < L && j * kRows + col < L;
        p[n][e] = ok ? exp2_fast(fmaf(p[n][e], c, -lse_s[col])) : 0.f;
      }
    mma_nn<false>(dv_acc, p, dOt, lane);  // dV += P^T dO, P^T rounded to T

    float ds[8][4];  // dP^T, then dS^T
    zero(ds);
    mma_nt<true>(ds, Vs + warp * 16 * P, dOt, lane);  // summed as (c)'s dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - D_s[8 * n + 2 * t + (e % 2)]);
    mma_nn<kSplitDs<T, FAST>>(dk_acc, ds, Qt, lane);  // dK += dS^T Q
    __syncthreads();  // this stage is free for the load two tiles on
  }
  const float one[2] = {1.f, 1.f}, s2[2] = {scale, scale};
  store_rows(dk, dk_acc, b, h, H, L, k0 + warp * 16, lane, s2);
  store_rows(dv, dv_acc, b, h, H, L, k0 + warp * 16, lane, one);
}

template <typename T, bool FAST>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ D, T* __restrict__ dq, int H, int L, Strides sq,
                     Strides sk, Strides sv, Strides sdo, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = kPitch<T>;
  T* Qs = reinterpret_cast<T*>(smem);   // this block's Q tile
  T* dOs = Qs + kTile<T>;               // this block's dO tile
  T* Ks = dOs + kTile<T>;               // two stages
  T* Vs = Ks + 2 * kTile<T>;            // two stages

  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_tile_async(Qs, q + b * sq.b + h * sq.h, sq.l, q0, L, tid);
  load_tile_async(dOs, dout + b * sdo.b + h * sdo.h, sdo.l, q0, L, tid);
  load_tile_async(Ks, kb, sk.l, 0, L, tid);
  load_tile_async(Vs, vb, sv.l, 0, L, tid);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  float lse_r[2], D_r[2], dq_acc[8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row0 + 8 * r < L;
    lse_r[r] = ok ? lse[(size_t)bh * L + row0 + 8 * r] * kLog2e : 0.f;  // base 2
    D_r[r] = ok ? D[(size_t)bh * L + row0 + 8 * r] : 0.f;
  }
  zero(dq_acc);
  const float c = scale * kLog2e;

  const int n_tiles = (L + kRows - 1) / kRows;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile_async(Ks + (st ^ 1) * kTile<T>, kb, sk.l, (j + 1) * kRows, L, tid);
      load_tile_async(Vs + (st ^ 1) * kTile<T>, vb, sv.l, (j + 1) * kRows, L, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * kTile<T>;

    float p[8][4], ds[8][4];  // S then P; dP then dS
    zero(p);
    zero(ds);
    mma_nt(p, Qs + warp * 16 * P, Kt, lane);
    mma_nt(ds, dOs + warp * 16 * P, Vs + st * kTile<T>, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const bool ok = row0 + 8 * r < L && j * kRows + 8 * n + 2 * t + (e % 2) < L;
        p[n][e] = ok ? exp2_fast(fmaf(p[n][e], c, -lse_r[r])) : 0.f;
        ds[n][e] = p[n][e] * (ds[n][e] - D_r[r]);
      }
    mma_nn<kSplitDs<T, FAST>>(dq_acc, ds, Kt, lane);  // dQ += dS K, the raw K
    __syncthreads();  // this stage is free for the load two tiles on
  }
  const float s2[2] = {scale, scale};
  store_rows(dq, dq_acc, b, h, H, L, q0 + warp * 16, lane, s2);
}

template <typename T, bool FAST>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* D, void* dq, void* dk, void* dv, int B, int H, int L,
                   Strides sq, Strides sk, Strides sv, Strides so, Strides sdo, float scale,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 grid((L + kRows - 1) / kRows, B * H);
  attention_bwd_rowdot<T><<<grid, kThreads, 2 * kTile<T> * sizeof(T), stream>>>(
      static_cast<const T*>(o), dot, D, H, L, so, sdo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // K, V, two Q and two dO stages, and two stages of lse and D
  constexpr size_t dkdv_smem = 6 * kTile<T> * sizeof(T) + 4 * kRows * sizeof(float);
  err = cudaFuncSetAttribute(attention_bwd_dkdv<T, FAST>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkdv_smem);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv<T, FAST><<<grid, kThreads, dkdv_smem, stream>>>(
      qt, kt, vt, dot, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), H, L, sq, sk, sv, sdo,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t dq_smem = 6 * kTile<T> * sizeof(T);  // Q, dO, two K and two V stages
  err = cudaFuncSetAttribute(attention_bwd_dq<T, FAST>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  attention_bwd_dq<T, FAST><<<grid, kThreads, dq_smem, stream>>>(
      qt, kt, vt, dot, lse, D, static_cast<T*>(dq), H, L, sq, sk, sv, sdo, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace probunet

// q, k, v, o (the forward output), dout: (B, L, H, 64) of one dtype, element
// strides (*_sb, *_sl, *_sh), unit-stride head dim, 16-byte-aligned rows.
// lse: (B*H, L) fp32 from the forward kernel; D: (B*H, L) fp32 scratch.
// dq, dk, dv: (B, L, H, 64) contiguous, q's dtype. fast rounds dS to bf16
// (it changes nothing for fp32). Returns a cudaError_t code; 0 on success.
extern "C" int probunet_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    void* D, void* dq, void* dk, void* dv, int B, int H, int L, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh, long long v_sb, long long v_sl,
    long long v_sh, long long o_sb, long long o_sl, long long o_sh, long long do_sb,
    long long do_sl, long long do_sh, float scale, int is_bf16, int fast, void* stream) {
  using probunet::tiles::Strides;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  const Strides sq{q_sb, q_sl, q_sh}, sk{k_sb, k_sl, k_sh}, sv{v_sb, v_sl, v_sh};
  const Strides so{o_sb, o_sl, o_sh}, sdo{do_sb, do_sl, do_sh};
  if (is_bf16 && fast)
    return probunet::launch<__nv_bfloat16, true>(q, k, v, o, dout, l, d, dq, dk, dv, B, H, L, sq,
                                                 sk, sv, so, sdo, scale, st);
  if (is_bf16)
    return probunet::launch<__nv_bfloat16, false>(q, k, v, o, dout, l, d, dq, dk, dv, B, H, L, sq,
                                                  sk, sv, so, sdo, scale, st);
  return probunet::launch<float, false>(q, k, v, o, dout, l, d, dq, dk, dv, B, H, L, sq, sk, sv,
                                        so, sdo, scale, st);
}
