// Fused GroupNorm + SiLU forward on NHWC activations, for Hopper (sm_90a).
//
// Replaces probunet_tpu/ops/pallas_gn.py::_kernel (launched by
// _forward_pallas). Per (batch, group): fp32 mean and variance over the
// (H*W, C/G) slice, rstd = 1/sqrt(var + eps), then
// y = (x - mean) * rstd * gamma + beta and out = y * sigmoid(y), stored in
// x's dtype (fp32 or bf16). (B, G) mean and rstd are written for the backward.
//
// Bound: bytes. One read and one write of x (2N element moves) is the least
// any kernel can move. The TPU kernel gets there by holding one sample's
// activation in VMEM, split into channel blocks of whole groups when VMEM is
// short (_split_factor). One sample at 128x128x384 fp32 is 25 MB, far more
// than one SM's 227 KB, so here the unit of work is (sample b, channel block
// of Cb channels holding whole groups), and one thread-block cluster of n <= 16
// blocks holds the unit's (H*W rows, Cb) slice in its distributed shared
// memory, each block a contiguous range of rows. One launch per call:
//
//   1. each block copies its rows into shared memory with 16-byte cp.async
//      (row segments of Cb channels, strided by C in x), in four groups,
//      and sums each group as soon as it lands. Each thread owns one
//      column of vectors and only ever reads what it copied itself, so the
//      copies need no block barrier;
//   2. it takes its rows' per-group (count, mean, M2) from those sums and a
//      second pass over the shared copy (centred sum of squares), fp32;
//   3. after a cluster barrier every block copies all n blocks' partials
//      through distributed shared memory (map_shared_rank; one float per
//      thread, so the remote reads overlap) and merges them in rank order by
//      Chan's formula: every block gets the same, exact group statistics,
//      with no atomics, so two calls give equal bits;
//   4. it normalizes, applies the affine map and SiLU from the shared copy
//      and stores 16-byte vectors; block rank 0 writes the unit's mean and
//      rstd. A thread's channels are fixed, so their mean, rstd * gamma and
//      beta sit in registers (no per-element channel index); the sigmoid
//      takes the fast exp2 and reciprocal (__expf, __fdividef), ~1e-6
//      relative, so that bf16's four bytes per element are not outpaced by
//      the arithmetic.
//      Loads ask L2 for 256 bytes around each strip and stores are marked
//      evict-first. A split cluster barrier (arrive after the remote reads,
//      wait before exit) keeps every block's shared memory alive while
//      others read it.
//
// The affine map may be modulated per (sample, channel) by operands of shape
// (B, C), or (1, C) read with batch stride 0 for every sample, fp32: the
// residual block's embedding terms (template parameter MOD).
//   kModScaleShift (ADM, adaptive_scale): silu((xhat * gamma + beta) * (1 + s)
//     + t), i.e. gamma' = gamma (1 + s) and beta' = beta (1 + s) + t, formed
//     in registers once per thread, as its channels are fixed;
//   kModShiftIn (DDPM++): silu(GN(x + t)); t is added to x as it is summed in
//     both statistics passes, and folded into the apply loop's mean as
//     mean - t, so the streamed plan's second read needs no add either.
// The unmodulated instantiation is the same code as before: no new loads.
//
// HBM traffic is 2N when the unit's slice fits the cluster ("on chip"; the
// host's plan sizes Cb and n so that every site of the U-Net fits, with up to
// ~100 KB of x per block so that two blocks share an SM and one's stores
// overlap the other's loads). Each block of a cluster costs several
// microseconds of fixed latency (H100 measurements in PERF.md), so the plan
// takes the fewest blocks per cluster that hold the slice. A unit that does not fit is streamed through shared memory
// in chunks of rows by the same kernel: the statistics loop merges each
// chunk's two-pass (count, mean, M2) into the block's partial, and the apply
// loop reads the chunks again (3N traffic, the last chunk not reloaded).

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace probunet {
namespace {

constexpr int kMaxCluster = 16;  // non-portable cluster size (8 is portable)
constexpr int kThreads = 256;    // per block, unless a row holds more vectors
constexpr int kMaxThreads = 512;
constexpr int kStages = 4;       // cp.async groups per chunk, summed as they land

// The modulation of the affine map (the header note).
constexpr int kModNone = 0, kModScaleShift = 1, kModShiftIn = 2, kMods = 3;

struct Params {
  const void* x;
  const float* gamma;
  const float* beta;
  void* out;
  float* mean;
  float* rstd;
  int hw, c, g;       // rows per sample, channels, groups
  int cb, cg;         // channels per block, channels per group
  int rows;           // rows per block of a cluster
  int chunk_rows;     // rows per pass through shared memory (= rows on chip)
  int vpr, rpi;       // vectors per row, rows per pass of the block's threads
  int slice_bytes;    // shared bytes of one chunk of rows
  float eps;
  const float* mscale;         // scale_shift's s, (B|1, C)
  const float* mshift;         // scale_shift's t or shift_in's t, (B|1, C)
  int mscale_bs, mshift_bs;    // their batch strides in elements (0: one row for all)
};

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

// The two halves of cluster.sync(): arrive publishes this block's shared
// writes (release); wait returns once every block of the cluster has arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// store_vec with an evict-first hint: the output is not read again here, and
// the strips of x fetched into L2 for the neighbouring clusters should stay.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec_cs(T* __restrict__ p, const float (&in)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_float<T>(in[0]);
  } else {
    Pack<T, VEC> pk;
#pragma unroll
    for (int i = 0; i < VEC; ++i) pk.v[i] = from_float<T>(in[i]);
    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&pk));
  }
}

// Wait until at most n of this thread's cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}
static_assert(kStages <= 4, "cp_async_wait_pending covers 4 stages");

// Copy this thread's rows of a chunk (its column of rows tr, tr + rpi, ...
// below nr; src row r at src + r * ld) into the packed shared rows (pitch
// cb). Every later pass reads only what the same thread copied, so no block
// barrier is needed around these copies.
template <typename T, int VEC>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ src, size_t ld, int i0,
                                          int i1, int tr, const Params& p) {
  static_assert(VEC == 1 || sizeof(T) * VEC == 16, "16-byte vectors or scalars");
  for (int i = i0; i < i1; ++i) {
    const int r = tr + i * p.rpi;
    if constexpr (VEC == 1) {
      dst[r * p.cb] = src[r * ld];
    } else {
      // L2 fetches the 256 bytes around each strip: the clusters of the
      // neighbouring channel blocks read the rest of those rows
      cp_async16_l2_256(dst + r * p.cb, src + r * ld);
    }
  }
}

// Load the thread's m rows of a chunk in kStages cp.async groups and add
// each stage into acc as soon as it has landed, while later stages are
// still in flight; with kModShiftIn each element plus its channel's tin.
template <typename T, int VEC, int MOD>
__device__ __forceinline__ void load_and_sum(T* dst, const T* __restrict__ src, size_t ld, int m,
                                             int tr, const Params& p, const float (&tin)[VEC],
                                             float (&acc)[VEC]) {
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    copy_rows<T, VEC>(dst, src, ld, m * s / kStages, m * (s + 1) / kStages, tr, p);
    cp_async_commit();
  }
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    cp_async_wait_pending(kStages - 1 - s);
    for (int i = m * s / kStages; i < m * (s + 1) / kStages; ++i) {
      float v[VEC];
      load_vec<T, VEC>(dst + (tr + i * p.rpi) * p.cb, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if constexpr (MOD == kModShiftIn) acc[e] += v[e] + tin[e];
        else acc[e] += v[e];
      }
    }
  }
}

// dst[g] = the block's sum of every thread's acc over the channels of local
// group g, in a fixed order: per-thread partials go to shared scratch (rpi
// rows of cb), then one warp per group adds its rows' cg entries (lane l
// takes rows l, l + 32, ...) and reduces by shuffles.
template <int VEC>
__device__ __forceinline__ void group_sums(const float (&acc)[VEC], float* scratch, float* dst,
                                           const Params& p, int tr, int tc, bool active) {
  if (active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) scratch[tr * p.cb + tc * VEC + i] = acc[i];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gb = p.cb / p.cg;
  for (int g = warp; g < gb; g += blockDim.x >> 5) {
    float v = 0.f;
    for (int r = lane; r < p.rpi; r += 32) {
      const float* s = scratch + r * p.cb + g * p.cg;
      for (int j = 0; j < p.cg; ++j) v += s[j];
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) dst[g] = v;
  }
  __syncthreads();
}

// Grid (n, C / cb, B), clusters of (n, 1, 1): one cluster per (sample,
// channel block); block rank k holds rows [k * rows, (k + 1) * rows).
template <typename T, int VEC, int MOD>
__global__ void __launch_bounds__(kMaxThreads) gn_silu_fused(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ncl = static_cast<int>(cluster.num_blocks());
  const int cbi = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, gb = p.cb / p.cg;
  const int tc = tid % p.vpr, tr = tid / p.vpr;  // this thread's column and first row
  const bool active = tr < p.rpi;

  T* slice = reinterpret_cast<T*>(smem) + tc * VEC;
  float* scratch = reinterpret_cast<float*>(smem + p.slice_bytes);  // rpi x cb
  float* gsum = scratch + p.rpi * p.cb;  // per local group: a chunk's sum
  float* gm2 = gsum + gb;                //   its centred sum of squares
  float* part = gm2 + gb;                //   (count, mean, M2) of this block's rows
  float* gstat = part + 3 * gb;          //   (mean, rstd) of the unit
  float* gathered = gstat + 2 * gb;      // the n blocks' partials, rank-major

  const int r0 = rank * p.rows, r1 = min(p.hw, r0 + p.rows);
  const int nchunks = r1 > r0 ? (r1 - r0 + p.chunk_rows - 1) / p.chunk_rows : 0;
  const size_t col = ((size_t)b * p.hw) * p.c + (size_t)cbi * p.cb + tc * VEC;
  const T* xg = static_cast<const T*>(p.x) + col;
  T* og = static_cast<T*>(p.out) + col;
  const size_t ld = p.c;

  int grp[VEC];  // local group of each of this thread's channels
#pragma unroll
  for (int i = 0; i < VEC; ++i) grp[i] = (tc * VEC + i) / p.cg;
  for (int g = tid; g < gb; g += blockDim.x) part[3 * g] = part[3 * g + 1] = part[3 * g + 2] = 0.f;
  float tin[VEC];  // kModShiftIn: this sample's shift of each of the thread's channels
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if constexpr (MOD == kModShiftIn)
      tin[i] = p.mshift[(size_t)b * p.mshift_bs + cbi * p.cb + tc * VEC + i];
    else
      tin[i] = 0.f;
  }

  // ---- statistics of this block's rows, chunk by chunk ------------------------
  int c0 = r0, nr = 0, m = 0;  // the chunk in shared memory: first row, rows, this thread's rows
  for (int k = 0; k < nchunks; ++k) {
    c0 = r0 + k * p.chunk_rows;
    nr = min(p.chunk_rows, r1 - c0);
    m = active && tr < nr ? (nr - tr + p.rpi - 1) / p.rpi : 0;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    load_and_sum<T, VEC, MOD>(slice, xg + c0 * ld, ld, m, tr, p, tin, acc);
    group_sums<VEC>(acc, scratch, gsum, p, tr, tc, active);
    const float cnt = static_cast<float>(nr) * p.cg;
    float mu[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mu[i] = gsum[grp[i]] / cnt;
      acc[i] = 0.f;
    }
    for (int i = 0; i < m; ++i) {
      float v[VEC];
      load_vec<T, VEC>(slice + (tr + i * p.rpi) * p.cb, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float d;
        if constexpr (MOD == kModShiftIn) d = (v[e] + tin[e]) - mu[e];
        else d = v[e] - mu[e];
        acc[e] += d * d;
      }
    }
    group_sums<VEC>(acc, scratch, gm2, p, tr, tc, active);
    for (int g = tid; g < gb; g += blockDim.x)
      chan_merge(part[3 * g], part[3 * g + 1], part[3 * g + 2], cnt, gsum[g] / cnt, gm2[g]);
  }

  // ---- merge the cluster's partials in rank order ---------------------------
  // Every block copies all n blocks' partials into its own shared memory, one
  // float per thread, so the remote reads are in flight together.
  cluster_arrive();
  cluster_wait();
  for (int i = tid; i < ncl * 3 * gb; i += blockDim.x) {
    const int q = i / (3 * gb);
    gathered[i] = cluster.map_shared_rank(part, q)[i - q * 3 * gb];
  }
  cluster_arrive();  // done reading the other blocks' shared memory
  __syncthreads();
  for (int g = tid; g < gb; g += blockDim.x) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int q = 0; q < ncl; ++q) {
      const float* pq = gathered + q * 3 * gb + 3 * g;
      chan_merge(n, mean, m2, pq[0], pq[1], pq[2]);
    }
    const float rs = 1.f / sqrtf(m2 / n + p.eps);
    gstat[2 * g] = mean;
    gstat[2 * g + 1] = rs;
    if (rank == 0) {
      const size_t o = (size_t)b * p.g + cbi * gb + g;
      p.mean[o] = mean;
      p.rstd[o] = rs;
    }
  }
  __syncthreads();

  // ---- normalize, affine, SiLU; the last chunk is still in shared memory -----
  // y = (x - mu) * sc + sh, the modulation folded into the three constants
  float mu[VEC], sc[VEC], sh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int ch = cbi * p.cb + tc * VEC + i;
    mu[i] = gstat[2 * grp[i]];
    sc[i] = gstat[2 * grp[i] + 1] * p.gamma[ch];
    sh[i] = p.beta[ch];
    if constexpr (MOD == kModScaleShift) {
      const float s1 = 1.f + p.mscale[(size_t)b * p.mscale_bs + ch];
      sc[i] *= s1;
      sh[i] = sh[i] * s1 + p.mshift[(size_t)b * p.mshift_bs + ch];
    } else if constexpr (MOD == kModShiftIn) {
      mu[i] -= tin[i];
    }
  }
  for (int k = nchunks - 1; k >= 0; --k) {
    if (k + 1 < nchunks) {  // streamed: copy this thread's rows of chunk k again
      c0 = r0 + k * p.chunk_rows;
      nr = min(p.chunk_rows, r1 - c0);
      m = active && tr < nr ? (nr - tr + p.rpi - 1) / p.rpi : 0;
      copy_rows<T, VEC>(slice, xg + c0 * ld, ld, 0, m, tr, p);
      cp_async_commit();
      cp_async_wait<0>();
    }
    for (int i = 0; i < m; ++i) {
      const int r = tr + i * p.rpi;
      float v[VEC];
      load_vec<T, VEC>(slice + r * p.cb, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float y = (v[e] - mu[e]) * sc[e] + sh[e];
        v[e] = __fdividef(y, 1.f + __expf(-y));
      }
      store_vec_cs<T, VEC>(og + (c0 + r) * ld, v);
    }
  }
  cluster_wait();  // no block leaves while another may still read its partials
}

using KernelFn = void (*)(Params);

constexpr int kKernels = 4 * kMods;

// The kernel of a storage type, vector width and modulation, and its index
// in the table; null if none.
KernelFn pick(int is_bf16, int vec, int mod, int* index) {
  static const KernelFn table[kKernels] = {
      gn_silu_fused<float, 1, kModNone>,       gn_silu_fused<float, 4, kModNone>,
      gn_silu_fused<__nv_bfloat16, 1, kModNone>, gn_silu_fused<__nv_bfloat16, 8, kModNone>,
      gn_silu_fused<float, 1, kModScaleShift>, gn_silu_fused<float, 4, kModScaleShift>,
      gn_silu_fused<__nv_bfloat16, 1, kModScaleShift>,
      gn_silu_fused<__nv_bfloat16, 8, kModScaleShift>,
      gn_silu_fused<float, 1, kModShiftIn>,    gn_silu_fused<float, 4, kModShiftIn>,
      gn_silu_fused<__nv_bfloat16, 1, kModShiftIn>, gn_silu_fused<__nv_bfloat16, 8, kModShiftIn>};
  const int i = is_bf16 ? (vec == 8 ? 3 : vec == 1 ? 2 : -1) : (vec == 4 ? 1 : vec == 1 ? 0 : -1);
  *index = i < 0 || mod < 0 || mod >= kMods ? -1 : 4 * mod + i;
  return *index < 0 ? nullptr : table[*index];
}

// Opt each kernel into large dynamic shared memory and clusters of up to 16
// blocks, once per device.
cudaError_t configure(KernelFn fn, int index) {
  static unsigned done[kKernels] = {};
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done[index] >> dev & 1u)) return cudaSuccess;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if (dev < 32) done[index] |= 1u << dev;
  return cudaSuccess;
}

// The launch's shape: kernel, parameters, threads and dynamic shared bytes.
struct Launch {
  KernelFn fn;
  Params p;
  int threads;
  size_t smem;
};

cudaError_t prepare(Launch& L, int is_bf16, int vec, int mod, int C, int G, int cb, int cluster,
                    int chunk_rows) {
  int index = -1;
  L.fn = pick(is_bf16, vec, mod, &index);
  if (!L.fn || G <= 0 || C % G || cb <= 0 || C % cb || cb % (C / G) || cb % vec ||
      cluster < 1 || cluster > kMaxCluster || chunk_rows < 1)
    return cudaErrorInvalidValue;
  const int vpr = cb / vec;
  L.threads = vpr <= kThreads ? kThreads : (vpr + 31) / 32 * 32;
  if (L.threads > kMaxThreads) return cudaErrorInvalidValue;
  const int rpi = L.threads / vpr, gb = cb / (C / G);
  const size_t slice = ((size_t)chunk_rows * cb * (is_bf16 ? 2 : 4) + 15) / 16 * 16;
  L.smem = slice + sizeof(float) * ((size_t)rpi * cb + (7 + 3 * cluster) * gb);
  L.p = Params{};
  L.p.c = C;
  L.p.g = G;
  L.p.cb = cb;
  L.p.cg = C / G;
  L.p.chunk_rows = chunk_rows;
  L.p.vpr = vpr;
  L.p.rpi = rpi;
  L.p.slice_bytes = static_cast<int>(slice);
  return configure(L.fn, index);
}

cudaLaunchConfig_t launch_config(const Launch& L, dim3 grid, int cluster, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(L.threads);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace
}  // namespace probunet

// Returns a cudaError_t code; 0 on success. One launch: grid (cluster,
// C / cb, B) in clusters of `cluster` blocks, each block `rows` rows of H*W,
// `chunk_rows` of them at a time in shared memory (chunk_rows >= rows: the
// unit stays on chip). vec is the elements per access: 16 bytes' worth when
// C and the pointers allow it, else 1. mod: 0 none, 1 scale_shift (mscale
// and mshift), 2 shift_in (mshift); each operand fp32 with unit channel
// stride and a batch stride of mscale_bs / mshift_bs elements (0 when one
// row serves every sample).
extern "C" int probunet_gn_silu_fwd(const void* x, const void* gamma, const void* beta, void* out,
                                    void* mean, void* rstd, int B, int HW, int C, int G, int cb,
                                    int cluster, int rows, int chunk_rows, float eps, int is_bf16,
                                    int vec, int mod, const void* mscale, const void* mshift,
                                    int mscale_bs, int mshift_bs, void* stream) {
  using namespace probunet;
  Launch L;
  cudaError_t err = prepare(L, is_bf16, vec, mod, C, G, cb, cluster, chunk_rows);
  if (err != cudaSuccess) return err;
  if (B < 1 || HW < 1 || rows < 1 || (long long)rows * cluster < HW) return cudaErrorInvalidValue;
  if ((mod == kModScaleShift && !mscale) || (mod != kModNone && !mshift) || mscale_bs < 0 ||
      mshift_bs < 0)
    return cudaErrorInvalidValue;
  L.p.x = x;
  L.p.gamma = static_cast<const float*>(gamma);
  L.p.beta = static_cast<const float*>(beta);
  L.p.out = out;
  L.p.mean = static_cast<float*>(mean);
  L.p.rstd = static_cast<float*>(rstd);
  L.p.hw = HW;
  L.p.rows = rows;
  L.p.eps = eps;
  L.p.mscale = static_cast<const float*>(mscale);
  L.p.mshift = static_cast<const float*>(mshift);
  L.p.mscale_bs = mscale_bs;
  L.p.mshift_bs = mshift_bs;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(L, dim3(cluster, C / cb, B), cluster,
                                               static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, L.fn, L.p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// What the kernel of a plan is on this device, into out[6]: clusters of
// `cluster` blocks that can be resident at once, threads per block, dynamic
// shared bytes per block, registers per thread, local (spilled) bytes per
// thread, static shared bytes; of the instantiation of modulation `mod`.
// Returns a cudaError_t code.
extern "C" int probunet_gn_silu_query(int is_bf16, int vec, int C, int G, int cb, int cluster,
                                      int chunk_rows, int mod, void* out) {
  using namespace probunet;
  Launch L;
  cudaError_t err = prepare(L, is_bf16, vec, mod, C, G, cb, cluster, chunk_rows);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, L.fn);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(L, dim3(cluster, 1, 1), cluster, 0, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, L.fn, &cfg);
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(out);
  o[0] = clusters;
  o[1] = L.threads;
  o[2] = static_cast<int>(L.smem);
  o[3] = fa.numRegs;
  o[4] = static_cast<int>(fa.localSizeBytes);
  o[5] = static_cast<int>(fa.sharedSizeBytes);
  return cudaSuccess;
}
