// Fused GroupNorm + SiLU forward on NHWC activations, for Hopper (sm_90a).
//
// Replaces probunet_tpu/ops/pallas_gn.py::_kernel (launched by
// _forward_pallas). Per (batch, group): fp32 mean and variance over the
// (H*W, C/G) slice, rstd = 1/sqrt(var + eps), then
// y = (x - mean) * rstd * gamma + beta and out = y * sigmoid(y), stored in
// x's dtype (fp32 or bf16). (B, G) mean and rstd are written for the backward.
//
// Bound: bytes. The ideal is one read plus one write of x (2N element
// moves); this design reads x twice and writes it once (3N), because one
// sample at 128x128x384 fp32 is 25 MB and cannot stay on chip between the
// statistics and the normalization. The TPU kernel's one program per batch
// element would fill 8 of 132 SMs at batch 8, so the work is split instead:
//
//   1. gn_stats: grid (S chunks of H*W, B). Each block streams its chunk of
//      rows with 16-byte loads across all C channels (coalesced) and keeps a
//      per-channel Welford (count, mean, M2) in registers; the block merges
//      them by Chan's formula into one partial per group.
//   2. gn_finalize: grid (B). Merges the S partials of each group, in a fixed
//      order (no atomics, so results are deterministic), into mean and rstd.
//   3. gn_apply: grid (A, B). Elementwise pass with 16-byte loads and stores;
//      per-channel mean, rstd * gamma and beta sit in shared memory.
//
// Welford/Chan partials compute the same function as the TPU kernel's
// E[x^2] - mean^2 with less cancellation.

#include <math.h>

#include "common.cuh"

namespace probunet {
namespace {

constexpr int kStatsThreads = 256;
constexpr int kApplyThreads = 256;
constexpr int kApplyVecsPerThread = 8;

// Merge (nb, mb, m2b) into (n, m, m2): Chan et al.'s pairwise update.
__device__ __forceinline__ void chan_merge(float& n, float& m, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float delta = mb - m;
  const float f = nb / nn;
  m += delta * f;
  m2 += m2b + delta * delta * n * f;
  n = nn;
}

// partials: (B, S, G, 3) fp32 of (count, mean, M2).
template <typename T, int VEC>
__global__ void gn_stats(const T* __restrict__ x, float* __restrict__ partials, int HW, int C,
                         int G, int rows_per_chunk) {
  extern __shared__ float sh[];
  const int ncols = C / VEC;
  const int rows_per_iter = blockDim.x / ncols;
  float* sh_n = sh;                         // blockDim
  float* sh_mean = sh_n + blockDim.x;       // blockDim * VEC
  float* sh_m2 = sh_mean + blockDim.x * VEC;

  const int s = blockIdx.x, b = blockIdx.y, S = gridDim.x;
  const int tid = threadIdx.x;
  const int col = tid % ncols, roff = tid / ncols;
  const int r0 = s * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);
  const T* xb = x + (size_t)b * HW * C + (size_t)col * VEC;

  float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.f;
  if (roff < rows_per_iter) {
#pragma unroll 4
    for (int r = r0 + roff; r < r1; r += rows_per_iter) {
      float v[VEC];
      load_vec<T, VEC>(xb + (size_t)r * C, v);
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[i] - mean[i];
        mean[i] += d * inv;
        m2[i] += d * (v[i] - mean[i]);
      }
    }
  }
  sh_n[tid] = n;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sh_mean[tid * VEC + i] = mean[i];
    sh_m2[tid * VEC + i] = m2[i];
  }
  __syncthreads();

  // One thread per group merges its channels over the row offsets.
  const int cg = C / G;
  for (int g = tid; g < G; g += blockDim.x) {
    float gn = 0.f, gm = 0.f, gm2 = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      const int cc = c / VEC, e = c % VEC;
      for (int ro = 0; ro < rows_per_iter; ++ro) {
        const int t = ro * ncols + cc;
        chan_merge(gn, gm, gm2, sh_n[t], sh_mean[t * VEC + e], sh_m2[t * VEC + e]);
      }
    }
    float* p = partials + (((size_t)b * S + s) * G + g) * 3;
    p[0] = gn;
    p[1] = gm;
    p[2] = gm2;
  }
}

__global__ void gn_finalize(const float* __restrict__ partials, float* __restrict__ mean_out,
                            float* __restrict__ rstd_out, int S, int G, float eps) {
  const int b = blockIdx.x;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float n = 0.f, m = 0.f, m2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* p = partials + (((size_t)b * S + s) * G + g) * 3;
      chan_merge(n, m, m2, p[0], p[1], p[2]);
    }
    mean_out[b * G + g] = m;
    rstd_out[b * G + g] = 1.f / sqrtf(m2 / n + eps);
  }
}

template <typename T, int VEC>
__global__ void gn_apply(const T* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, const float* __restrict__ mean,
                         const float* __restrict__ rstd, T* __restrict__ out, int HW, int C,
                         int G) {
  extern __shared__ float sh[];
  float* sh_mean = sh;        // C
  float* sh_scale = sh + C;   // C: rstd * gamma
  float* sh_beta = sh + 2 * C;
  const int b = blockIdx.y;
  const int cg = C / G;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = b * G + c / cg;
    sh_mean[c] = mean[g];
    sh_scale[c] = rstd[g] * gamma[c];
    sh_beta[c] = beta[c];
  }
  __syncthreads();

  const size_t nvec = (size_t)HW * C / VEC;
  const T* xb = x + (size_t)b * HW * C;
  T* ob = out + (size_t)b * HW * C;
  for (size_t v = (size_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += (size_t)gridDim.x * blockDim.x) {
    const size_t e = v * VEC;
    const int c0 = (int)(e % C);
    float f[VEC];
    load_vec<T, VEC>(xb + e, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float y = (f[i] - sh_mean[c0 + i]) * sh_scale[c0 + i] + sh_beta[c0 + i];
      f[i] = y / (1.f + expf(-y));
    }
    store_vec<T, VEC>(ob + e, f);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const float* gamma, const float* beta, void* out, float* mean,
                   float* rstd, float* partials, int B, int HW, int C, int G, int S,
                   int rows_per_chunk, float eps, cudaStream_t stream) {
  const int ncols = C / VEC;
  int threads = kStatsThreads;
  if (ncols > threads) threads = ((ncols + 31) / 32) * 32;
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t stats_smem = (size_t)threads * (1 + 2 * VEC) * sizeof(float);
  gn_stats<T, VEC><<<dim3(S, B), threads, stats_smem, stream>>>(
      static_cast<const T*>(x), partials, HW, C, G, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  gn_finalize<<<B, ((G + 31) / 32) * 32, 0, stream>>>(partials, mean, rstd, S, G, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t nvec = (size_t)HW * C / VEC;
  const size_t per_block = (size_t)kApplyThreads * kApplyVecsPerThread;
  const int blocks = (int)((nvec + per_block - 1) / per_block);
  gn_apply<T, VEC><<<dim3(blocks, B), kApplyThreads, 3 * C * sizeof(float), stream>>>(
      static_cast<const T*>(x), gamma, beta, mean, rstd, static_cast<T*>(out), HW, C, G);
  return cudaGetLastError();
}

}  // namespace
}  // namespace probunet

// Returns a cudaError_t code; 0 on success. vec is the elements per access:
// 16 bytes' worth when C and the pointers allow it, else 1.
extern "C" int probunet_gn_silu_fwd(const void* x, const void* gamma, const void* beta, void* out,
                                    void* mean, void* rstd, void* partials, int B, int HW, int C,
                                    int G, int S, int rows_per_chunk, float eps, int is_bf16,
                                    int vec, void* stream) {
  using namespace probunet;
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* mn = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  float* pt = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vec == 8)
      return launch<__nv_bfloat16, 8>(x, g, bt, out, mn, rs, pt, B, HW, C, G, S, rows_per_chunk,
                                      eps, st);
    if (vec == 1)
      return launch<__nv_bfloat16, 1>(x, g, bt, out, mn, rs, pt, B, HW, C, G, S, rows_per_chunk,
                                      eps, st);
  } else {
    if (vec == 4)
      return launch<float, 4>(x, g, bt, out, mn, rs, pt, B, HW, C, G, S, rows_per_chunk, eps, st);
    if (vec == 1)
      return launch<float, 1>(x, g, bt, out, mn, rs, pt, B, HW, C, G, S, rows_per_chunk, eps, st);
  }
  return cudaErrorInvalidValue;
}
