// Dropout's compare, scale and select in one launch each way, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package's dropout is flax's nn.Dropout
// (a Bernoulli mask, then select(mask, x / keep, 0)), which XLA fuses into
// the ops around it. The port's plain version (ops/dropout.py::plain) is
// torch.where(u < keep, x / keep, 0-dim zero) on uniforms u drawn by
// torch.rand: a compare, a division and a select, each a pass over memory,
// the select in PyTorch's non-vectorized broadcast kernel, and autograd
// keeps the bool mask (one byte an element) for a where and a division in
// the backward. This kernel computes, element by element, what those ops
// compute on the card, so its results are bit-equal to theirs:
//   keep_i = u_i < keep                 (fp32 compare: keep = fp32(1 - rate))
//   y_i    = keep_i ? T(x_i * inv) : +0 (inv = 1.0f / keep, the fp32 product
//                                        PyTorch's x / scalar takes, rounded
//                                        to T to nearest even)
// and the backward dx_i = keep_i ? T(dy_i * inv) : +0 (where(mask, dy, 0),
// then / keep), whatever x_i or dy_i holds at a dropped element (NaN, inf).
// The product is __fmul_rn, never contracted.
//
// Three modes:
//   element forward: u has x's n elements in x's memory order; writes y and
//     the mask as one bit an element (bit j of byte g is element 8 g + j,
//     so the bytes read as little-endian uint32 words hold element 32 w + b
//     at bit b of word w); bytes past ceil(n / 8) up to the last whole word
//     are written 0;
//   element backward: reads the bits and dy, writes dx;
//   row (stochastic depth, forward and backward alike): one uniform a row
//     of `row` consecutive elements, u[i / row]; nothing of x's size is
//     saved.
//
// Bound: bytes. Per element the element forward reads u (4 bytes) and x and
// writes y (2 + 2 in bf16) and an eighth of a byte of mask: 8.125 bytes in
// bf16 against ~14 for the plain chain; the backward 4.125, the row mode 4
// (a dropped row's x is not read). A thread takes groups of 8 consecutive
// elements, so its mask bits are one byte: one or two 16-byte accesses of
// each operand where every pointer is 16-byte aligned and the group is
// whole, one element at a time otherwise; a warp's accesses are one
// contiguous run. The grid walks the groups in strides of itself.

#include "common.cuh"

#include <algorithm>
#include <cstdint>

namespace probunet {
namespace {

constexpr int kDropThreads = 256;
constexpr long long kDropBlocksMax = 8192;
enum DropMode : int { kElementFwd = 0, kElementBwd = 1, kRow = 2 };

// 8 consecutive elements as fp32, in 16-byte accesses (one for bf16, two
// for fp32); p 16-byte aligned
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p, float (&v)[8]) {
  constexpr int kV = 16 / sizeof(T);
#pragma unroll
  for (int h = 0; h < 8 / kV; ++h) {
    float part[kV];
    load_vec<T, kV>(p + h * kV, part);
#pragma unroll
    for (int j = 0; j < kV; ++j) v[h * kV + j] = part[j];
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ p, const float (&v)[8]) {
  constexpr int kV = 16 / sizeof(T);
#pragma unroll
  for (int h = 0; h < 8 / kV; ++h) {
    float part[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) part[j] = v[h * kV + j];
    store_vec<T, kV>(p + h * kV, part);
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kDropThreads)
    dropout_kernel(const T* __restrict__ in, T* __restrict__ out, const float* __restrict__ u,
                   uint8_t* __restrict__ bits, long long n, long long row, float keep, float inv,
                   int vec) {
  const long long groups = (n + 7) >> 3;
  const long long stride = static_cast<long long>(gridDim.x) * kDropThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kDropThreads + threadIdx.x; g < groups;
       g += stride) {
    const long long i0 = g << 3;
    const int len = static_cast<int>(min(8LL, n - i0));
    const bool whole = vec && len == 8;
    unsigned mask = 0;   // bit j: element i0 + j kept
    if (MODE == kElementFwd) {
      float uv[8];
      if (whole) {
        load8(u + i0, uv);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) uv[j] = j < len ? u[i0 + j] : 1.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) mask |= static_cast<unsigned>(j < len && uv[j] < keep) << j;
    } else if (MODE == kElementBwd) {
      mask = bits[g];
    } else if (row % 8 == 0) {   // the group lies in one row
      mask = u[i0 / row] < keep ? (1u << len) - 1 : 0u;
    } else {
      for (int j = 0; j < len; ++j) mask |= static_cast<unsigned>(u[(i0 + j) / row] < keep) << j;
    }
    if (whole) {
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (mask) load8(in + i0, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = (mask >> j) & 1u ? __fmul_rn(v[j], inv) : 0.0f;
      store8(out + i0, v);
    } else {
      for (int j = 0; j < len; ++j) {   // a dropped element is not read
        const bool kept = (mask >> j) & 1u;
        out[i0 + j] = from_float<T>(kept ? __fmul_rn(to_float(in[i0 + j]), inv) : 0.0f);
      }
    }
    if (MODE == kElementFwd) {
      bits[g] = static_cast<uint8_t>(mask);
      if (g == groups - 1) {
        for (long long b = groups; b < ((n + 31) >> 5) << 2; ++b) bits[b] = 0;
      }
    }
  }
}

template <typename T, int MODE>
cudaError_t launch(const void* in, void* out, const void* u, void* bits, long long n,
                   long long row, float keep, float inv, int vec, cudaStream_t stream) {
  const long long groups = (n + 7) >> 3;
  const int blocks = static_cast<int>(
      std::min((groups + kDropThreads - 1) / kDropThreads, kDropBlocksMax));
  dropout_kernel<T, MODE><<<blocks, kDropThreads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), static_cast<const float*>(u),
      static_cast<uint8_t*>(bits), n, row, keep, inv, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(int mode, const void* in, void* out, const void* u, void* bits,
                        long long n, long long row, float keep, float inv, int vec,
                        cudaStream_t stream) {
  switch (mode) {
    case kElementFwd:
      return launch<T, kElementFwd>(in, out, u, bits, n, row, keep, inv, vec, stream);
    case kElementBwd:
      return launch<T, kElementBwd>(in, out, u, bits, n, row, keep, inv, vec, stream);
    default:
      return launch<T, kRow>(in, out, u, bits, n, row, keep, inv, vec, stream);
  }
}

template <typename T> const void* kernel_of(int mode) {
  switch (mode) {
    case kElementFwd: return reinterpret_cast<const void*>(dropout_kernel<T, kElementFwd>);
    case kElementBwd: return reinterpret_cast<const void*>(dropout_kernel<T, kElementBwd>);
    default: return reinterpret_cast<const void*>(dropout_kernel<T, kRow>);
  }
}

}  // namespace
}  // namespace probunet

// One pass over n elements of in (x forward, dy backward) into out, both
// dense in one memory order, fp32 or bf16 (is_bf16). mode 0 (element
// forward): u holds n fp32 uniforms in that order, bits receives
// ceil(n / 32) uint32 words of mask; mode 1 (element backward): bits is
// read; mode 2 (row): u holds n / row uniforms, one a row of `row`
// elements. keep and inv = 1.0f / keep in fp32. vec: every pointer the
// mode reads or writes element-wise is 16-byte aligned.
extern "C" int probunet_dropout(const void* in, void* out, const void* u, void* bits,
                                long long n, long long row, float keep, float inv, int is_bf16,
                                int mode, int vec, void* stream) {
  using namespace probunet;
  if (n < 0 || mode < kElementFwd || mode > kRow || (mode == kRow && row <= 0))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (!in || !out || (mode != kElementBwd && !u) || (mode != kRow && !bits))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_mode<__nv_bfloat16>(mode, in, out, u, bits, n, row, keep, inv, vec, s)
                 : launch_mode<float>(mode, in, out, u, bits, n, row, keep, inv, vec, s);
}

// The kernel of (is_bf16, mode): its threads, registers, spilled bytes
// (local memory), resident blocks per SM and the grid's cap, into out
// (int[5]).
extern "C" int probunet_dropout_query(int is_bf16, int mode, void* out) {
  using namespace probunet;
  if (mode < kElementFwd || mode > kRow) return cudaErrorInvalidValue;
  const void* fn = is_bf16 ? kernel_of<__nv_bfloat16>(mode) : kernel_of<float>(mode);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kDropThreads, 0);
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(out);
  o[0] = kDropThreads;
  o[1] = fa.numRegs;
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = blocks;
  o[4] = static_cast<int>(kDropBlocksMax);
  return cudaSuccess;
}
