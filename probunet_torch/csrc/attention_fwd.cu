// Fused self-attention forward, softmax(Q (K s)^T) V with s = 1/sqrt(64),
// for Hopper (sm_90a), in the FlashAttention-2 style on the tensor cores.
//
// Replaces probunet_tpu/ops/pallas_attn.py::_fwd_kernel (launched by
// _fwd_pallas). The TPU kernel holds the whole of K and V in VMEM and skips
// the online softmax; at L=1024 fp32 K plus V is 512 KB, beyond an SM's
// 227 KB of shared memory, so here K/V stream through shared memory in
// 64-row tiles with a running max and sum, and the (L, L) weights never
// reach device memory.
//
// Bound: operations, 4 * B * heads * L^2 * 64 FLOP (QK^T and PV), against
// the bf16 tensor-core rate in fast mode and, in strict mode, the smaller
// of the fp32 CUDA-core time and three TF32 tensor-core products.
//
// Design (tile machinery in attention_tiles.cuh): one block of four warps
// per (batch * head, 64 query rows); each warp owns 16 rows. The block's Q
// tile and a 2-stage ring of 64-row K/V tiles are copied into shared memory
// by cp.async, the next K/V tile in flight while the current one is used.
// S = Q K^T and O += P V run on mma.sync (bf16 m16n8k16, or 3xTF32
// m16n8k8 for fp32) with fp32 accumulators in registers; the online
// softmax stays in fp32 registers, and P goes from its accumulator
// registers straight into the A operand of PV, never through shared memory.
// A ragged last tile is zero-filled and masked, so any L works.
//
// Layout: q, k, v are (B, L, heads, 64) with any element strides (sb, sl,
// sh) and a unit-stride head dim, each row 16-byte aligned: the U-Net
// block's q/k/v views of its qkv conv output are read where the conv wrote
// them. The output is contiguous (B, L, heads, 64). Given a non-null lse,
// the kernel also writes each row's fp32 log-sum-exp of the logits,
// (B*heads, L), which the backward kernel (attention_bwd.cu) uses to
// recompute the weights; serving passes null and writes nothing more.
//
// Numerics by storage type T:
//   fp32 (strict): 3xTF32 products, within a few fp32 ulps of the fp32
//     products of Precision.HIGHEST, with fp32 sums in another order.
//   bf16 (fast): products of bf16 operands accumulate in fp32; the
//     probabilities are rounded to bf16 before PV (as p.astype(v.dtype)
//     does). The logits are scaled by s after the product: s = 1/8 is a
//     power of two, so that equals the product with K * s rounded to T (as
//     _prep does), bit for bit, barring underflow.
//   Both: the softmax is fp32, in base 2 (p = 2^(S s log2(e) - m)) by the
//     SFU's ex2, about 2 ulp from expf; the lse comes back in natural log.

#include <math.h>

#include "attention_tiles.cuh"

namespace probunet {
namespace {

using namespace tiles;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ lse, int H, int L, Strides sq,
                  Strides sk, Strides sv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = kPitch<T>;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kTile<T>;       // two stages
  T* Vs = Ks + 2 * kTile<T>;   // two stages

  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_tile_async(Qs, qb, sq.l, q0, L, tid);
  load_tile_async(Ks, kb, sk.l, 0, L, tid);
  load_tile_async(Vs, vb, sv.l, 0, L, tid);
  cp_async_commit();

  // the softmax runs in base 2 on the raw logits: p = 2^(s c - m), c = scale
  // * log2(e), m the running max of s c; tile 0 always holds column 0, so m
  // is finite from the first tile on
  const float c = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[8][4];
  zero(acc);
  AFrags<T> qf;  // this warp's 16 Q rows, loaded once
  const int n_tiles = (L + kRows - 1) / kRows;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {  // the next K/V tile into the other stage
      load_tile_async(Ks + (st ^ 1) * kTile<T>, kb, sk.l, (j + 1) * kRows, L, tid);
      load_tile_async(Vs + (st ^ 1) * kTile<T>, vb, sv.l, (j + 1) * kRows, L, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) load_a(qf, Qs + warp * 16 * P, lane);

    float s[8][4];
    zero(s);
    mma_nt(s, qf, Ks + st * kTile<T>, lane);

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

    // O += P V, P rounded to T as p.astype(v.dtype) rounds it
    if constexpr (sizeof(T) == 4) {
      // fp32: the tensor cores' fp32 accumulation truncates, so a running
      // sum over 16 tiles (L=1024) drifts by ~1e-5 against the strict
      // tolerance of 2e-5; each tile's PV goes into a zeroed accumulator
      // and joins the sum by a rounded fp32 FMA instead
      float pv[8][4];
      zero(pv);
      mma_nn<false>(pv, s, Vs + st * kTile<T>, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], alpha[e / 2], pv[n][e]);
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];
      mma_nn<false>(acc, s, Vs + st * kTile<T>, lane);
    }
    __syncthreads();  // this stage is free for the load two tiles on
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int row0 = q0 + warp * 16;
  store_rows(o, acc, b, h, H, L, row0, lane, inv);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + lane / 4 + 8 * r;
      if (row < L) lse[(size_t)bh * L + row] = (m[r] + log2f(l[r])) / kLog2e;
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int L, Strides sq, Strides sk, Strides sv, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = 5 * kTile<T> * sizeof(T);  // Q, two K and two V stages
  cudaError_t err = cudaFuncSetAttribute(attention_fwd<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kRows - 1) / kRows, B * H);
  attention_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, L, sq, sk, sv, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace probunet

// q, k, v: (B, L, H, 64) of one dtype, element strides (*_sb, *_sl, *_sh),
// unit-stride head dim, 16-byte-aligned rows; o: (B, L, H, 64) contiguous,
// same dtype; lse: null or (B*H, L) fp32. Returns a cudaError_t code; 0 on
// success.
extern "C" int probunet_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int H, int L, long long q_sb,
                                      long long q_sl, long long q_sh, long long k_sb,
                                      long long k_sl, long long k_sh, long long v_sb,
                                      long long v_sl, long long v_sh, float scale, int is_bf16,
                                      void* stream) {
  using probunet::tiles::Strides;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const Strides sq{q_sb, q_sl, q_sh}, sk{k_sb, k_sl, k_sh}, sv{v_sb, v_sl, v_sh};
  if (is_bf16)
    return probunet::launch<__nv_bfloat16>(q, k, v, o, l, B, H, L, sq, sk, sv, scale, st);
  return probunet::launch<float>(q, k, v, o, l, B, H, L, sq, sk, sv, scale, st);
}
