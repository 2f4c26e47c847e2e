// Fused self-attention backward for Hopper (sm_90a): the gradients of
// O = softmax(Q (K s)^T) V, s = 1/sqrt(64), with respect to Q, K and V,
// FlashAttention-2 style and deterministic (no atomics).
//
// Replaces probunet_tpu/ops/pallas_attn.py::_bwd_kernel (launched by
// _bwd_pallas). That kernel walks 256-row q chunks along a sequential grid
// axis and accumulates dK and dV across them in its output block
// (pl.when(ci == 0) zeroes it first). Hopper blocks run in no order, so the
// work is cut into three kernels that each own what they write:
//   (a) attention_bwd_rowdot: D = rowsum(dO o O), one warp per row;
//   (b) attention_bwd_dkdv: one block per (batch * head, 64-row K/V tile)
//       loops over the q tiles and keeps dK and dV in registers;
//   (c) attention_bwd_dq: one block per (batch * head, 64-row q tile) loops
//       over the K/V tiles and keeps dQ in registers.
// (b) and (c) recompute the weights as P = exp(S - lse) from the row
// log-sum-exp that the forward kernel (attention_fwd.cu) saved, so no
// (L, L) tensor reaches device memory.
//
// Bound: operations, 10 * B * heads * L^2 * 64 FLOP (the TPU kernel's five
// L x L x 64 products: S, dV, dP, dQ, dK), against the card's fp32
// CUDA-core rate in strict mode and its bf16 tensor-core rate in fast mode.
// This design does seven products (S and dP in both (b) and (c)), all on
// CUDA cores; mma.sync / wgmma and TMA are later work.
//
// Numerics follow _bwd_kernel (pallas_attn.py:101-135):
//   - S is recomputed exactly as the forward kernel computes it: the same
//     operands (K * s rounded to the storage type T, as _prep does in fast
//     mode) and the same fp32 FMA order over the head dim;
//   - the dV and dP legs run at the model dtype: P is rounded to T before
//     dV = P^T dO, and dP = dO V^T multiplies T-valued operands with fp32
//     sums;
//   - dS = P o (dP - D) is fp32, rounded to bf16 before dQ and dK only when
//     FAST; strict mode with bf16 activations keeps dS, K and Q in fp32;
//   - dQ = (dS K) * s with the raw K, dK = (dS^T Q) * s;
//   - D = rowsum(dO o O) stands for the TPU kernel's rowsum(dP o P). The two
//     are equal up to rounding in fp32; in fast mode O is stored as bf16, a
//     difference within the fast tolerance of 5e-2.
//
// Tiles as in the forward kernel: 64 x 64, 256 threads, thread (ty, tx) =
// (tid / 16, tid % 16) owns rows ty + 16 i and columns tx + 16 j (i, j < 4)
// of each tile product; shared rows pad to 65 floats so column-strided reads
// hit distinct banks. A ragged last tile is masked (P = 0 there), so any L
// works.

#include <math.h>

#include "common.cuh"

namespace probunet {
namespace {

constexpr int kD = 64;    // head dim
constexpr int kB = 64;    // rows per q tile and per K/V tile
constexpr int kThreads = 256;
constexpr int kPad = kD + 1;
constexpr int kTile = kB * kPad;  // floats in one padded tile
constexpr int kRowsPerBlock = kThreads / 32;
constexpr size_t kDkdvSmem = (size_t)(5 * kTile + 2 * kB) * sizeof(float);
constexpr size_t kDqSmem = (size_t)(6 * kTile) * sizeof(float);

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0, int L,
                                          int tid) {
  for (int i = tid; i < kB * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    dst[r * kPad + d] = (r0 + r < L) ? to_float(src[(size_t)(r0 + r) * kD + d]) : 0.f;
  }
}

// K * s rounded to T, exactly the operand the forward kernel multiplies.
template <typename T>
__device__ __forceinline__ void load_scaled_k(float* dst, const T* __restrict__ k, int r0, int L,
                                              int tid, float scale) {
  for (int i = tid; i < kB * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    dst[r * kPad + d] =
        (r0 + r < L) ? round_to<T>(to_float(k[(size_t)(r0 + r) * kD + d]) * scale) : 0.f;
  }
}

// acc[i][j] += sum_d A[ra + 16 i][d] * B[rb + 16 j][d], d = 0..63 in order
// (A and B are padded row-major tiles): S and dP.
__device__ __forceinline__ void dot_rows(float (&acc)[4][4], const float* A, const float* B,
                                         int ra, int rb) {
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ra + 16 * i) * kPad + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(rb + 16 * j) * kPad + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c A[ra + 16 i][c] * B[c][cb + 16 j], c = 0..63: dV, dK, dQ.
__device__ __forceinline__ void dot_inner(float (&acc)[4][4], const float* A, const float* B,
                                          int ra, int cb) {
#pragma unroll 8
  for (int c = 0; c < kB; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ra + 16 * i) * kPad + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[c * kPad + cb + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Rows r0 + ty + 16 i of a (B*H, L, 64) result tile, written into the
// (B, L, H, 64) layout, times mul.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ out, const float (&acc)[4][4], int bh,
                                           int H, int L, int r0, int ty, int tx, float mul) {
  const int b = bh / H, head = bh % H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= L) continue;
    T* row = out + (((size_t)b * L + r) * H + head) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) row[tx + 16 * j] = from_float<T>(acc[i][j] * mul);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_rowdot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ D,
                         int H, int L, int rows) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const int bh = row / L, r = row % L, b = bh / H, head = bh % H;
  const T* orow = o + (((size_t)b * L + r) * H + head) * kD;
  const T* drow = dout + (size_t)row * kD;
  float acc = to_float(orow[lane]) * to_float(drow[lane]);
  acc = fmaf(to_float(orow[lane + 32]), to_float(drow[lane + 32]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[row] = acc;
}

template <typename T, bool FAST>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ D, T* __restrict__ dk, T* __restrict__ dv, int H,
                       int L, float scale) {
  extern __shared__ float sh[];
  float* Ks = sh;              // K * s, rounded as the forward kernel rounds it
  float* Vs = Ks + kTile;
  float* Qs = Vs + kTile;      // raw Q
  float* dOs = Qs + kTile;
  float* Ps = dOs + kTile;     // P^T rounded to T, then dS^T
  float* lse_s = Ps + kTile;   // kB
  float* D_s = lse_s + kB;     // kB

  const int bh = blockIdx.y, k0 = blockIdx.x * kB;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t base = (size_t)bh * L * kD;
  load_scaled_k<T>(Ks, k + base, k0, L, tid, scale);
  load_tile<T>(Vs, v + base, k0, L, tid);

  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < L; q0 += kB) {
    __syncthreads();  // the previous tile's readers are done with Qs, dOs, Ps
    load_tile<T>(Qs, q + base, q0, L, tid);
    load_tile<T>(dOs, dout + base, q0, L, tid);
    if (tid < kB) {
      const bool ok = q0 + tid < L;
      lse_s[tid] = ok ? lse[(size_t)bh * L + q0 + tid] : 0.f;
      D_s[tid] = ok ? D[(size_t)bh * L + q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T: rows are keys ty + 16 i, columns queries tx + 16 j
    float p[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = dp[i][j] = 0.f;
    dot_rows(p, Ks, Qs, ty, tx);
    dot_rows(dp, Vs, dOs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = k0 + ty + 16 * i < L && q0 + tx + 16 * j < L;
        p[i][j] = ok ? expf(p[i][j] - lse_s[tx + 16 * j]) : 0.f;
        Ps[(ty + 16 * i) * kPad + tx + 16 * j] = round_to<T>(p[i][j]);
      }
    __syncthreads();
    dot_inner(dv_acc, Ps, dOs, ty, tx);  // dV += P^T dO
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ds = p[i][j] * (dp[i][j] - D_s[tx + 16 * j]);
        Ps[(ty + 16 * i) * kPad + tx + 16 * j] = FAST ? round_to<T>(ds) : ds;
      }
    __syncthreads();
    dot_inner(dk_acc, Ps, Qs, ty, tx);  // dK += dS^T Q
  }
  store_tile<T>(dk, dk_acc, bh, H, L, k0, ty, tx, scale);
  store_tile<T>(dv, dv_acc, bh, H, L, k0, ty, tx, 1.f);
}

template <typename T, bool FAST>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ D, T* __restrict__ dq, int H, int L, float scale) {
  extern __shared__ float sh[];
  float* Qs = sh;              // raw Q
  float* dOs = Qs + kTile;
  float* Ks = dOs + kTile;     // K * s, rounded as the forward kernel rounds it
  float* Kr = Ks + kTile;      // raw K
  float* Vs = Kr + kTile;
  float* Ps = Vs + kTile;      // dS

  const int bh = blockIdx.y, q0 = blockIdx.x * kB;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t base = (size_t)bh * L * kD;
  load_tile<T>(Qs, q + base, q0, L, tid);
  load_tile<T>(dOs, dout + base, q0, L, tid);
  float lse_r[4], D_r[4], dq_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < L ? lse[(size_t)bh * L + r] : 0.f;
    D_r[i] = r < L ? D[(size_t)bh * L + r] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) dq_acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kB) {
    __syncthreads();  // the previous tile's readers are done with Ks, Kr, Vs, Ps
    load_scaled_k<T>(Ks, k + base, k0, L, tid, scale);
    load_tile<T>(Kr, k + base, k0, L, tid);
    load_tile<T>(Vs, v + base, k0, L, tid);
    __syncthreads();

    // S and dP: rows are queries ty + 16 i, columns keys tx + 16 j
    float p[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = dp[i][j] = 0.f;
    dot_rows(p, Qs, Ks, ty, tx);
    dot_rows(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = q0 + ty + 16 * i < L && k0 + tx + 16 * j < L;
        const float pij = ok ? expf(p[i][j] - lse_r[i]) : 0.f;
        const float ds = pij * (dp[i][j] - D_r[i]);
        Ps[(ty + 16 * i) * kPad + tx + 16 * j] = FAST ? round_to<T>(ds) : ds;
      }
    __syncthreads();
    dot_inner(dq_acc, Ps, Kr, ty, tx);  // dQ += dS K
  }
  store_tile<T>(dq, dq_acc, bh, H, L, q0, ty, tx, scale);
}

template <typename T, bool FAST>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* D, void* dq, void* dk, void* dv, int B, int H, int L,
                   float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = B * H * L;
  attention_bwd_rowdot<T><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, stream>>>(
      static_cast<const T*>(o), dot, D, H, L, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((L + kB - 1) / kB, B * H);
  err = cudaFuncSetAttribute(attention_bwd_dkdv<T, FAST>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDkdvSmem);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv<T, FAST><<<grid, kThreads, kDkdvSmem, stream>>>(
      qt, kt, vt, dot, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), H, L, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(attention_bwd_dq<T, FAST>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmem);
  if (err != cudaSuccess) return err;
  attention_bwd_dq<T, FAST><<<grid, kThreads, kDqSmem, stream>>>(
      qt, kt, vt, dot, lse, D, static_cast<T*>(dq), H, L, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace probunet

// q, k, v, dout: (B*H, L, 64) contiguous; o: the forward output, (B, L, H, 64)
// contiguous; all of one dtype. lse: (B*H, L) fp32 from the forward kernel;
// D: (B*H, L) fp32 scratch. dq, dk, dv: (B, L, H, 64) contiguous, q's dtype.
// fast rounds dS to bf16 (it changes nothing for fp32). Returns a
// cudaError_t code; 0 on success.
extern "C" int probunet_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* D, void* dq,
                                      void* dk, void* dv, int B, int H, int L, float scale,
                                      int is_bf16, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  if (is_bf16 && fast)
    return probunet::launch<__nv_bfloat16, true>(q, k, v, o, dout, l, d, dq, dk, dv, B, H, L,
                                                 scale, st);
  if (is_bf16)
    return probunet::launch<__nv_bfloat16, false>(q, k, v, o, dout, l, d, dq, dk, dv, B, H, L,
                                                  scale, st);
  return probunet::launch<float, false>(q, k, v, o, dout, l, d, dq, dk, dv, B, H, L, scale, st);
}
