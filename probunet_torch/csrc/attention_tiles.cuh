// Tile machinery of the fp32 (strict) attention kernels K2
// (attention_fwd.cu) and K3 (attention_bwd.cu): 64 x D tiles of a (B, L,
// heads, W) fp32 tensor copied into shared memory by cp.async, and
// warp-level 16 x 64 x D and 16 x D x 64 products on the tensor cores
// through mma.sync in 3xTF32. (The bf16 kernels run on wgmma and TMA:
// attention_hopper.cuh.) D, the head width a tile holds, is 64 or 128:
// rows of W <= D columns (the head dim, or attention.py::kernel_layout's
// zero-padded width, a multiple of 8) are loaded with the columns from W to
// D - 1 zero-filled, which leave QK^T unchanged and give zero columns of O,
// dQ, dK and dV, which are not stored.
//
// A warp owns 16 rows of a 64-row tile. Its 16 x N fp32 results live in
// registers in the mma "C" layout: acc[n][e] is row g + 8 * (e / 2), column
// 8 n + 2 t + (e % 2), with g = lane / 4 and t = lane % 4.
//
// Two product shapes cover every product of K2 and K3:
//   mma_nt: acc += A B^T, A = 16 rows of a shared tile, B = a 64-row shared
//           tile, both row-major over the D-wide head dim (S, dP and, with
//           K or V as A, the transposed S^T and dP^T of the dK/dV kernel);
//   mma_nn: acc += A B, A = a warp's 16 x 64 result still in registers (P,
//           P^T, dS, dS^T), B = a 64-row shared tile read down its rows
//           (PV, dV, dK, dQ), giving 16 x D.
// Numerics: 3xTF32 on mma.sync.m16n8k8: each operand x splits into
// hi = tf32(x) and lo = tf32(x - hi), and the product sums lo*hi + hi*lo +
// hi*hi in fp32, close to an fp32 product (the dropped lo*lo term is
// ~2^-22 relative). The split is explicit here, so PyTorch's TF32 switches
// play no part. tf32 wgmma reads only K-major B operands, so PV, dV, dK
// and dQ would need transposed tiles; this path stays on mma.sync.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace probunet {
namespace tiles {

constexpr int kRows = 64;       // rows per tile
constexpr int kThreads = 128;   // four warps, 16 tile rows each

// Element strides of a (B, L, heads, W) tensor whose head dim is unit-stride.
struct Strides {
  long long b, l, h;
};

// Shared row pitch in elements: D + 4 floats (68 or 132, 4 banks past a
// multiple of 32 either way) make the scalar fragment reads (4 g + t and
// 8 t + g banks) conflict-free.
template <typename T, int D> struct Pitch;
template <int D> struct Pitch<float, D> { static constexpr int value = D + 4; };
template <typename T, int D> constexpr int kPitch = Pitch<T, D>::value;
template <typename T, int D> constexpr int kTile = kRows * kPitch<T, D>;  // elements per tile

// Rows row0 .. row0 + 63 of one (batch, head) slice, row r at src + r * ld,
// W columns each, into a shared tile of width D; rows at or past L and
// columns at or past W are zero (W = 64 at D = 64). Asynchronous: commit
// and wait before reading.
template <typename T, int D>
__device__ __forceinline__ void load_tile_async(T* dst, const T* __restrict__ src, long long ld,
                                                int row0, int L, int W, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;  // 16-byte chunks per row
#pragma unroll
  for (int j = 0; j < kRows * kChunks / kThreads; ++j) {
    const int i = tid + j * kThreads, r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < L && (D == 64 || c * kVec < W);
    cp_async16(dst + r * kPitch<T, D> + c * kVec, ok ? src + (row0 + r) * ld + c * kVec : src,
               ok);
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a b in 3xTF32, the small terms first: lo*hi, hi*lo, hi*hi, or with
// SWAP hi*lo, lo*hi, hi*hi. A product computed once as X Y^T and once as
// Y X^T (swapped roles, SWAP on one of them) then runs the same sequence.
template <bool SWAP = false>
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  if constexpr (SWAP) {
    mma_tf32(c, ah, bl0, bl1);
    mma_tf32(c, al, bh0, bh1);
  } else {
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
  }
  mma_tf32(c, ah, bh0, bh1);
}

// ---- acc += A B^T: A = 16 rows at sA, B = 64 rows at sB, D deep -----------
// SWAP orders the 3xTF32 terms as the product with A and B in each other's
// roles would: S^T = K Q^T then adds up exactly as S = Q K^T.

// A's fragments for all of the 64-wide depth, for a warp that multiplies
// the same 16 rows by many B tiles (the forward kernel's Q at D = 64).
template <typename T> struct AFrags;
template <> struct AFrags<float> {
  uint32_t hi[8][4], lo[8][4];  // k steps of 8, split for 3xTF32
};

template <int D>
__device__ __forceinline__ void load_a(uint32_t (&ah)[4], uint32_t (&al)[4], const float* sA,
                                       int k, int lane) {
  constexpr int P = kPitch<float, D>;
  const int g = lane / 4, t = lane % 4;
  split_tf32(sA[g * P + k + t], ah[0], al[0]);
  split_tf32(sA[(g + 8) * P + k + t], ah[1], al[1]);
  split_tf32(sA[g * P + k + t + 4], ah[2], al[2]);
  split_tf32(sA[(g + 8) * P + k + t + 4], ah[3], al[3]);
}

__device__ __forceinline__ void load_a(AFrags<float>& f, const float* sA, int lane) {
#pragma unroll
  for (int k = 0; k < 64; k += 8) load_a<64>(f.hi[k / 8], f.lo[k / 8], sA, k, lane);
}

// One k step of acc += A B^T against all 64 rows of B.
template <bool SWAP, int D>
__device__ __forceinline__ void mma_nt_step(float (&acc)[8][4], const uint32_t (&ah)[4],
                                            const uint32_t (&al)[4], const float* sB, int k,
                                            int lane) {
  constexpr int P = kPitch<float, D>;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(sB[(n * 8 + g) * P + k + t], bh0, bl0);
    split_tf32(sB[(n * 8 + g) * P + k + t + 4], bh1, bl1);
    mma_tf32x3<SWAP>(acc[n], ah, al, bh0, bh1, bl0, bl1);
  }
}

// A from shared memory, one k step's fragments at a time. Eight k steps
// are unrolled: all of them at D = 64, half at D = 128, where the full
// unroll's hoisted loads spilled more and K3 ran slower (PERF.md,
// section 6).
template <int D, bool SWAP = false>
__device__ __forceinline__ void mma_nt(float (&acc)[8][4], const float* sA, const float* sB,
                                       int lane) {
#pragma unroll 8
  for (int k = 0; k < D; k += 8) {
    uint32_t ah[4], al[4];
    load_a<D>(ah, al, sA, k, lane);
    mma_nt_step<SWAP, D>(acc, ah, al, sB, k, lane);
  }
}

// A from registers (load_a), D = 64.
__device__ __forceinline__ void mma_nt(float (&acc)[8][4], const AFrags<float>& f,
                                       const float* sB, int lane) {
#pragma unroll
  for (int k = 0; k < 64; k += 8)
    mma_nt_step<false, 64>(acc, f.hi[k / 8], f.lo[k / 8], sB, k, lane);
}

// ---- acc += A B: A = a warp's 16 x 64 result in the C layout, B = 64 rows --

// 3xTF32; SPLIT has no meaning for fp32. The k order within each 8-wide step
// is permuted so that the C layout is the A fragment as it stands: k
// position t is column 2t of the tile, position t + 4 column 2t + 1, in A
// and in B alike, which leaves the sum unchanged.
template <bool SPLIT, int D>
__device__ __forceinline__ void mma_nn(float (&acc)[D / 8][4], const float (&a)[8][4],
                                       const float* sB, int lane) {
  constexpr int P = kPitch<float, D>;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(a[j][0], ah[0], al[0]);  // (g, column 2t)
    split_tf32(a[j][2], ah[1], al[1]);  // (g + 8, column 2t)
    split_tf32(a[j][1], ah[2], al[2]);  // (g, column 2t + 1)
    split_tf32(a[j][3], ah[3], al[3]);  // (g + 8, column 2t + 1)
    const float* b0 = sB + (8 * j + 2 * t) * P + g;
    const float* b1 = b0 + P;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b0[n * 8], bh0, bl0);
      split_tf32(b1[n * 8], bh1, bl1);
      mma_tf32x3(acc[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// ---- results ----------------------------------------------------------------

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// A warp's 16 x D result, rows row0 + g and row0 + g + 8 scaled by mul[0]
// and mul[1], into row (b, row, h) of a contiguous (B, L, H, W) tensor (W =
// 64 at D = 64); rows at or past L and columns at or past W are not written.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float (&acc)[D / 8][4],
                                           int b, int h, int H, int L, int W, int row0, int lane,
                                           const float (&mul)[2]) {
  const int g = lane / 4, t = lane % 4;
  const int pitch = D == 64 ? 64 : W;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
    T* p = out + (((size_t)b * L + row) * H + h) * pitch + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (D == 64 || 8 * n + 2 * t < W)
        store_pair(p + 8 * n, acc[n][2 * r] * mul[r], acc[n][2 * r + 1] * mul[r]);
  }
}

template <int N> __device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

}  // namespace tiles
}  // namespace probunet
