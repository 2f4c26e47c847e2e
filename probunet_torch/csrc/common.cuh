// Helpers shared by the port's hand-written kernels: the (b, l, h) strides
// of an attention tensor, fp32 <-> storage-type conversion, 16-byte vector
// loads/stores, cp.async copies, the 3xTF32 split, and the base-2
// exponential and quad reductions of the attention kernels' softmax.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace probunet {

// Element strides of a (B, L, heads, W) tensor whose head dim is unit-stride.
struct Strides {
  long long b, l, h;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements of T loaded or stored as one access (16 bytes when
// sizeof(T) * VEC == 16).
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_float(pk.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&in)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.v[i] = from_float<T>(in[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, with L2 fetching the aligned 256 bytes around src.
__device__ __forceinline__ void cp_async16_l2_256(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x by the SFU's ex2 (about 2 ulp; 0 for -inf). The attention kernels
// take their softmax in base 2, the scale and log2(e) folded into one FMA
// per logit.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 3xTF32 split (cvt.rna: round to nearest, ties away, 10 mantissa
// bits): hi = tf32(x), lo = tf32(x - hi). The strict attention kernels and
// the convolutions' split kernel carry every fp32 operand so.
__device__ __forceinline__ float tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// Quad reductions: the four lanes t = 0..3 of an mma row hold its columns.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace probunet
