// The 3xTF32 split of an fp32 convolution operand, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's convolutions are XLA's
// (lax.conv at Precision.HIGHEST), and the port's are cuDNN calls. Strict
// (fp32) convolutions run on cuDNN's TF32 tensor-core kernels in 3xTF32
// (ops/conv.py): each operand x is carried as hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest, ties away (cvt.rna, as the
// strict attention kernels split). A convolution is two cuDNN calls: hi*hi
// alone, and the two small products lo*hi + hi*lo in one call over the
// parts concatenated ([x_lo, x_hi] against [w_hi, w_lo]), summed in fp32.
// This kernel writes an operand's parts for both calls: it reads x once
// and writes hi alone into hi_out and each of the nslots slots (hi or lo, bit s of lo_mask) straight into the slices of the
// concatenated buffer out, one launch per operand.
//
// x is read as a 4-D view (d0, d1, d2, d3) with element strides s0..s3:
// an NCHW activation or gradient seen as NHWC (B, H, W, C), or an OIHW
// weight seen as (O, kh, kw, C). hi_out is contiguous (d0, d1, d2, d3),
// the channels_last layout of the operand. out is contiguous and puts the
// slot either just before d3 (slot_outer 0: concatenated along channels,
// (d0, d1, d2, nslots, d3), the channels_last layout of (B, nslots*C, H,
// W)) or first (slot_outer 1: stacked along the batch or the output
// channels, (nslots, d0, d1, d2, d3)).
//
// Bound: bytes. It reads S and writes (nslots + 1) * S (3S), the least
// any kernel that materialises the operand's parts for cuDNN moves. One thread takes
// VEC consecutive elements along d3 (16-byte loads and stores where d3 is
// unit-stride and a multiple of 4 and the pointers are aligned), so both
// reads and writes are coalesced along the channels.

#include "common.cuh"

namespace probunet {
namespace {

constexpr int kSplitThreads = 256;

template <int VEC>
__global__ void __launch_bounds__(kSplitThreads)
    tf32_split_kernel(const float* __restrict__ x, float* __restrict__ hi_out,
                      float* __restrict__ out, unsigned d1, unsigned d2, unsigned d3,
                      long long s0, long long s1, long long s2, long long s3, unsigned vectors,
                      long long slot_elems, int nslots, int lo_mask, int slot_outer) {
  const unsigned i = blockIdx.x * kSplitThreads + threadIdx.x;
  if (i >= vectors) return;
  const unsigned d3v = d3 / VEC;
  const unsigned c = (i % d3v) * VEC;
  const unsigned row = i / d3v;   // (i0, i1, i2) flattened
  const unsigned i2 = row % d2;
  const unsigned i1 = (row / d2) % d1;
  const unsigned i0 = row / d2 / d1;
  const float* src = x + i0 * s0 + i1 * s1 + i2 * s2 + c * s3;
  float hi[VEC], lo[VEC];
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    split_tf32(v.x, hi[0], lo[0]);
    split_tf32(v.y, hi[1], lo[1]);
    split_tf32(v.z, hi[2], lo[2]);
    split_tf32(v.w, hi[3], lo[3]);
  } else {
    split_tf32(src[0], hi[0], lo[0]);
  }
  float* dst_hi = hi_out + (long long)row * d3 + c;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst_hi) = make_float4(hi[0], hi[1], hi[2], hi[3]);
  } else {
    dst_hi[0] = hi[0];
  }
  // slot 0's element; the next slot is d3 further (inner) or a whole
  // operand further (outer)
  const long long base = slot_outer ? (long long)row * d3 + c
                                    : (long long)row * nslots * d3 + c;
  const long long step = slot_outer ? slot_elems : (long long)d3;
  for (int s = 0; s < nslots; ++s) {
    const bool l = (lo_mask >> s) & 1;
    float* dst = out + base + s * step;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(l ? lo[0] : hi[0], l ? lo[1] : hi[1],
                                                    l ? lo[2] : hi[2], l ? lo[3] : hi[3]);
    } else {
      dst[0] = l ? lo[0] : hi[0];
    }
  }
}

}  // namespace
}  // namespace probunet

// hi_out <- hi, out <- the nslots slots of x's split (see above). vec is 4 (d3 % 4 == 0, s3 == 1, s0..s2 multiples of 4, every
// pointer 16-byte aligned) or 1. The host keeps d0 * d1 * d2 * d3 under 2^31.
extern "C" int probunet_tf32_split(const void* x, void* hi_out, void* out, int d0, int d1,
                                   int d2, int d3, long long s0, long long s1, long long s2,
                                   long long s3, int nslots, int lo_mask, int slot_outer,
                                   int vec, void* stream) {
  using namespace probunet;
  if (d0 < 0 || d1 < 0 || d2 < 0 || d3 < 0 || nslots < 1 || nslots > 8 ||
      (vec != 1 && vec != 4) || (vec == 4 && (d3 % 4 || s3 != 1)))
    return cudaErrorInvalidValue;
  const long long elems = (long long)d0 * d1 * d2 * d3;
  if (elems >= (1LL << 31)) return cudaErrorInvalidValue;
  if (elems == 0) return cudaSuccess;
  const unsigned vectors = static_cast<unsigned>(elems / vec);
  const dim3 grid((vectors + kSplitThreads - 1) / kSplitThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* hf = static_cast<float*>(hi_out);
  float* of = static_cast<float*>(out);
  if (vec == 4)
    tf32_split_kernel<4><<<grid, kSplitThreads, 0, st>>>(xf, hf, of, d1, d2, d3, s0, s1, s2, s3,
                                                         vectors, elems, nslots, lo_mask,
                                                         slot_outer);
  else
    tf32_split_kernel<1><<<grid, kSplitThreads, 0, st>>>(xf, hf, of, d1, d2, d3, s0, s1, s2, s3,
                                                         vectors, elems, nslots, lo_mask,
                                                         slot_outer);
  return cudaGetLastError();
}
