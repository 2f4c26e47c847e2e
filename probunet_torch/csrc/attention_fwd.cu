// Fused self-attention forward, softmax(Q (K s)^T) V with s = 1/sqrt(64),
// for Hopper (sm_90a), in the FlashAttention-2 style.
//
// Replaces probunet_tpu/ops/pallas_attn.py::_fwd_kernel (launched by
// _fwd_pallas). The TPU kernel holds the whole of K and V in VMEM and skips
// the online softmax; at L=1024 fp32 K plus V is 512 KB, beyond an SM's
// 227 KB of shared memory, so here K/V stream through shared memory in
// 64-row tiles with a running max and sum, and the (L, L) weights never
// reach device memory.
//
// Bound: operations, 4 * B * heads * L^2 * 64 FLOP (QK^T and PV), against
// the card's fp32 CUDA-core rate in strict mode and its bf16 tensor-core
// rate in fast mode. This first version runs both modes on CUDA cores;
// mma.sync / wgmma and TMA are later work.
//
// Layout: q, k, v are (B*heads, L, 64) contiguous; the output is written
// straight into (B, L, heads, 64), the U-Net block's layout. Given a
// non-null lse, the kernel also writes each row's fp32 log-sum-exp of the
// logits, (B*heads, L), which the backward kernel (attention_bwd.cu) uses to
// recompute the weights; serving passes null and writes nothing more.
//
// Numerics by storage type T:
//   fp32 (strict): IEEE fp32 FMAs on fp32 operands, equal to
//     Precision.HIGHEST up to summation order.
//   bf16 (fast): K * s is rounded to bf16 (as _prep does), products of bf16
//     operands accumulate in fp32, the softmax is fp32, and the
//     probabilities are rounded to bf16 before PV (as p.astype(v.dtype)
//     does); PV accumulates in fp32.
//
// One block of 256 threads per (batch * head, 64-row q tile). Thread
// (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i and columns tx + 16 j
// (i, j < 4) of each 64x64 logits tile and of the output tile. Rows pad to
// 65 floats so the column-strided shared reads hit distinct banks. A ragged
// last tile is masked, so any L works.

#include <math.h>

#include "common.cuh"

namespace probunet {
namespace {

constexpr int kD = 64;    // head dim
constexpr int kBQ = 64;   // q rows per block
constexpr int kBK = 64;   // k/v rows per tile
constexpr int kThreads = 256;
constexpr int kPad = kD + 1;
constexpr size_t kSmemBytes = (size_t)(kBQ * kPad + kBK * kPad + kBK * kD + kBQ * kPad) * sizeof(float);

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ lse, int H, int L, float scale) {
  extern __shared__ float sh[];
  float* Qs = sh;                   // kBQ x kPad
  float* Ks = Qs + kBQ * kPad;      // kBK x kPad, holds K * scale
  float* Vs = Ks + kBK * kPad;      // kBK x kD
  float* Ps = Vs + kBK * kD;        // kBQ x kPad

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t base = (size_t)bh * L * kD;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int i = tid; i < kBQ * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    Qs[r * kPad + d] = (q0 + r < L) ? to_float(qb[(size_t)(q0 + r) * kD + d]) : 0.f;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done with Ks, Vs, Ps
    for (int i = tid; i < kBK * kD; i += kThreads) {
      const int r = i / kD, d = i % kD;
      const bool ok = k0 + r < L;
      const size_t g = (size_t)(k0 + r) * kD + d;
      Ks[r * kPad + d] = ok ? round_to<T>(to_float(kb[g]) * scale) : 0.f;
      Vs[r * kD + d] = ok ? to_float(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * kPad + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * kPad + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= L) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // tile 0 always holds column 0, so m_new is finite from the start
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * kPad + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      float p[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPad + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[c * kD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  const int b = bh / H, head = bh % H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= L) continue;
    T* orow = o + (((size_t)b * L + r) * H + head) * kD;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[tx + 16 * j] = from_float<T>(acc[i][j] * inv);
    if (lse != nullptr && tx == 0) lse[(size_t)bh * L + r] = m[i] + logf(l[i]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int L, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_fwd<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBQ - 1) / kBQ, B * H);
  attention_fwd<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, L, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace probunet

// q, k, v: (B*H, L, 64) contiguous; o: (B, L, H, 64) contiguous, same dtype;
// lse: null or (B*H, L) fp32. Returns a cudaError_t code; 0 on success.
extern "C" int probunet_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int H, int L, float scale, int is_bf16,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16) return probunet::launch<__nv_bfloat16>(q, k, v, o, l, B, H, L, scale, st);
  return probunet::launch<float>(q, k, v, o, l, B, H, L, scale, st);
}
