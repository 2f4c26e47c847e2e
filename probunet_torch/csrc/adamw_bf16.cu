// The bf16-state AdamW update of every parameter in one launch, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package's update is
// probunet_tpu/train/state.py::_scale_by_adam_bf16_state and its chain,
// which XLA fuses into a few passes. The port's plain version
// (ops/adamw_bf16.py::_plain_update) is torch._foreach_* ops with the bf16
// roundings tensor by tensor, five launches a parameter tensor. This
// kernel does the whole update, element by element, in the order those
// ops round, so its results are bit-equal to theirs:
//   g   = float(bf16(grad))
//   mu  = bf16(float(mu) * b1 + g * (1 - b1))                  (in place)
//   nu  = nu * b2 + (g * g) * (1 - b2)                          (fp32, in place)
//   upd = (float(mu) * rbc1) / (sqrt(nu * rbc2) + eps)
//   p  += ((upd + p * wd) * -lr)
// Every operation is an IEEE round-to-nearest intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never contracts into an
// FMA; the scalars are the fp32 values PyTorch's foreach ops take from the
// Python doubles. A list divided by a scalar is a multiply by the
// reciprocal taken in double and rounded to fp32 (PyTorch 2.11 on the
// H100: _foreach_div(list, s) equals list * float(1 / s), and neither the
// IEEE quotient nor the fp32 reciprocal's product), so the bias
// corrections come in as rbc1 = 1 / bc1 and rbc2 = 1 / bc2.
//
// Bound: bytes. Each element reads p, grad and nu in fp32 and mu in bf16
// and writes p, mu and nu: 24 bytes, 2.49 GB for the mc128 model's
// 103,541,083 parameters (0.74 ms at 3.35 TB/s). The launch is a
// multi-tensor apply: the host uploads a table of each tensor's pointers
// (p, grad, mu, nu) and length, and of chunks of at most kAdamChunk elements
// (tensor, chunk index); one block walks one chunk in groups of 4 elements
// (one float4 of p, grad and nu, one uint2 of mu: 16- and 8-byte accesses,
// each warp's a contiguous run) where the tensor's pointers allow them,
// and one element a thread for the rest. A chunk starts at a multiple of
// kAdamChunk, so its alignment is its tensor's.

#include "common.cuh"

#include <cstdint>

namespace probunet {
namespace {

constexpr int kAdamThreads = 256;
constexpr long long kAdamChunk = 65536;   // the host's CHUNK (ops/adamw_bf16.py)

// One row of the table's tensor part: five int64 words on the host.
struct AdamTensor {
  float* p;
  const float* g;
  __nv_bfloat16* mu;
  float* nu;
  long long n;
};

// One row of the table's chunk part: one int64 word, tensor in the low half.
struct AdamChunk {
  int tensor;
  int chunk;
};

struct AdamHyper {
  float b1, omb1, b2, omb2, rbc1, rbc2, eps, wd, neg_lr;
};

__device__ __forceinline__ void adamw_bf16_element(float& p, float graw, __nv_bfloat16& mu,
                                                   float& nu, const AdamHyper& h) {
  const float g = __bfloat162float(__float2bfloat16_rn(graw));
  mu = __float2bfloat16_rn(__fadd_rn(__fmul_rn(__bfloat162float(mu), h.b1),
                                     __fmul_rn(g, h.omb1)));
  nu = __fadd_rn(__fmul_rn(nu, h.b2), __fmul_rn(__fmul_rn(g, g), h.omb2));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(nu, h.rbc2)), h.eps);
  const float upd = __fdiv_rn(__fmul_rn(__bfloat162float(mu), h.rbc1), denom);
  p = __fadd_rn(p, __fmul_rn(__fadd_rn(upd, __fmul_rn(p, h.wd)), h.neg_lr));
}

// Four consecutive elements: p, grad and nu as one float4 each, mu as one uint2.
__device__ __forceinline__ void adamw_bf16_vec4(float4& p, const float4& g, uint2& mu,
                                                float4& nu, const AdamHyper& h) {
  __nv_bfloat16* m = reinterpret_cast<__nv_bfloat16*>(&mu);
  adamw_bf16_element(p.x, g.x, m[0], nu.x, h);
  adamw_bf16_element(p.y, g.y, m[1], nu.y, h);
  adamw_bf16_element(p.z, g.z, m[2], nu.z, h);
  adamw_bf16_element(p.w, g.w, m[3], nu.w, h);
}

__global__ void __launch_bounds__(kAdamThreads)
    adamw_bf16_kernel(const AdamTensor* __restrict__ tensors,
                      const AdamChunk* __restrict__ chunks, AdamHyper h) {
  const AdamChunk c = chunks[blockIdx.x];
  const AdamTensor t = tensors[c.tensor];
  const long long start = c.chunk * kAdamChunk;
  const int len = static_cast<int>(min(kAdamChunk, t.n - start));
  float* p = t.p + start;
  const float* g = t.g + start;
  __nv_bfloat16* mu = t.mu + start;
  float* nu = t.nu + start;
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(nu)) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(mu) & 7) == 0;
  // groups of 4 elements; a thread takes two a pass, kAdamThreads groups
  // apart, so each load of a warp is one contiguous run
  const int groups = aligned ? len / 4 : 0;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* nu4 = reinterpret_cast<float4*>(nu);
  uint2* mu4 = reinterpret_cast<uint2*>(mu);
  for (int i = threadIdx.x; i < groups; i += 2 * kAdamThreads) {
    const int j = i + kAdamThreads;
    float4 pv[2], gv[2], nv[2];
    uint2 mv[2];
    pv[0] = __ldcs(p4 + i);
    gv[0] = __ldcs(g4 + i);
    nv[0] = __ldcs(nu4 + i);
    mv[0] = __ldcs(mu4 + i);
    if (j < groups) {
      pv[1] = __ldcs(p4 + j);
      gv[1] = __ldcs(g4 + j);
      nv[1] = __ldcs(nu4 + j);
      mv[1] = __ldcs(mu4 + j);
    }
    adamw_bf16_vec4(pv[0], gv[0], mv[0], nv[0], h);
    __stcs(p4 + i, pv[0]);
    __stcs(nu4 + i, nv[0]);
    __stcs(mu4 + i, mv[0]);
    if (j < groups) {
      adamw_bf16_vec4(pv[1], gv[1], mv[1], nv[1], h);
      __stcs(p4 + j, pv[1]);
      __stcs(nu4 + j, nv[1]);
      __stcs(mu4 + j, mv[1]);
    }
  }
  for (int i = groups * 4 + threadIdx.x; i < len; i += kAdamThreads) {
    float pv = p[i], nv = nu[i];
    __nv_bfloat16 mv = mu[i];
    adamw_bf16_element(pv, g[i], mv, nv, h);
    p[i] = pv;
    mu[i] = mv;
    nu[i] = nv;
  }
}

}  // namespace
}  // namespace probunet

// One update of every tensor of the table (device memory: ntensors rows of
// (p, grad, mu, nu, n) as int64, then nchunks int64 words of tensor | chunk
// << 32, see above). b1, omb1 = 1 - b1, b2, omb2 = 1 - b2, the bias
// corrections' reciprocals rbc1 = 1 / (1 - b1^count) and rbc2 = 1 / (1 -
// b2^count), eps, the weight decay wd and neg_lr = -lr, each as fp32.
extern "C" int probunet_adamw_bf16(const void* table, int ntensors, int nchunks, float b1,
                                   float omb1, float b2, float omb2, float rbc1, float rbc2,
                                   float eps, float wd, float neg_lr, void* stream) {
  using namespace probunet;
  if (ntensors < 0 || nchunks < 0 || (nchunks > 0 && !table)) return cudaErrorInvalidValue;
  if (nchunks == 0) return cudaSuccess;
  const AdamTensor* tensors = static_cast<const AdamTensor*>(table);
  const AdamChunk* chunks = reinterpret_cast<const AdamChunk*>(tensors + ntensors);
  const AdamHyper h{b1, omb1, b2, omb2, rbc1, rbc2, eps, wd, neg_lr};
  adamw_bf16_kernel<<<nchunks, kAdamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tensors, chunks, h);
  return cudaGetLastError();
}

// The kernel's threads, registers, spilled bytes (local memory), the
// chunk length and its resident blocks per SM, into out (int[5]).
extern "C" int probunet_adamw_bf16_query(void* out) {
  using namespace probunet;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, adamw_bf16_kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, adamw_bf16_kernel, kAdamThreads,
                                                      0);
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(out);
  o[0] = kAdamThreads;
  o[1] = fa.numRegs;
  o[2] = static_cast<int>(fa.localSizeBytes);
  o[3] = static_cast<int>(kAdamChunk);
  o[4] = blocks;
  return cudaSuccess;
}
