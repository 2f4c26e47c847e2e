// Hopper (sm_90a) machinery of the bf16 attention kernels K2
// (attention_fwd.cu) and K3 (attention_bwd.cu): TMA tensor maps, mbarrier
// rings and warpgroup products (wgmma). The fp32 (3xTF32) kernels keep
// mma.sync and cp.async (attention_tiles.cuh).
//
// Tensors. A (B, L, heads, W) bf16 tensor with element strides (sb, sl,
// sh) and a unit-stride head dim of W columns (the head dim c, or the
// zero-padded width attention.py::kernel_layout copied it to: W = 64, or a
// multiple of 8 in 72..128) is described to the TMA unit as a 4-D map (W,
// heads, L, B) with byte strides (2 sh, 2 sl, 2 sb), all multiples of 16
// as kernel_layout guarantees: the U-Net block's q/k/v views (row stride
// 3 heads c elements) are read where the conv wrote them. One box is 64
// rows by 64 columns of one (batch, head): 64 x 128 bytes. Rows at or past
// L, and columns at or past W, lie outside the map and arrive as zeros, so
// no kernel has a ragged-tile load path.
// The maps are encoded on the host by the CUDA driver's
// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (the
// library links no -lcuda), and reach the kernels as __grid_constant__
// parameters.
//
// Head width. The kernels are instantiated for a head KD = 64 or 128
// columns wide in shared memory. A tile of R rows is KD / 64 column blocks
// ("atoms") of R x 128 bytes, atom a (columns 64 a .. 64 a + 63) at byte
// a R 128: each TMA box lands in one atom. At W < KD the columns from W on
// are the map's zeros: zero columns of Q and K leave QK^T unchanged, zero
// columns of V and dO give zero columns of O, dQ, dK and dV, which are not
// stored.
//
// Shared layout. CU_TENSOR_MAP_SWIZZLE_128B: an atom's row is 128 bytes,
// and within each group of 8 rows (1024 bytes) the 16-byte chunk c of row r
// lands at chunk c ^ (r % 8). That is the canonical 128-byte swizzled
// layout of wgmma, in both readings:
//   K-major (a tile read along its rows: Q, K, V, dO as A or as B of
//     S = Q K^T, dP = dO V^T and their transposes): 8-row groups 1024
//     bytes apart (SBO); the next 16 columns start 32 bytes on, and the
//     fifth k16 step of KD = 128 starts at the second atom;
//   MN-major (a tile read down its rows: V in O += P V, dO in dV += P^T dO,
//     Q in dK += dS^T Q, K in dQ += dS K; the transpose bit set): one
//     64-wide atom is the N of one m64n64k16 product, so KD = 128 runs two,
//     one per atom; 8-row groups along the contraction 1024 bytes apart,
//     the next 16 rows 2048 bytes on.
// Tiles start on 1024-byte boundaries, so the descriptors' base offset is 0.
//
// Products. wgmma.mma_async m64nNk16 with bf16 operands and fp32
// accumulators: a warpgroup (4 warps) owns 64 rows, warp w rows 16 w ..
// 16 w + 15, and each thread holds the mma.sync "C" layout of its warp's
// rows: d[4 j + e] is row g + 8 (e / 2), column 8 j + 2 t + (e % 2), with
// g = lane / 4, t = lane % 4. An A operand in registers takes mma.sync's
// m16n8k16 A fragment layout, so an accumulator turns into the A operand
// of the next product in registers (to_a below): P, P^T, dS and dS^T
// never pass through shared memory.
//
// Synchronisation. A ring of stages, each with a "full" barrier (armed by
// the producer's expect-tx, completed by the TMA unit's byte count) and an
// "empty" barrier (every consumer thread arrives once it has waited for the
// products that read the stage). Phase parities follow the stage's round:
// the producer's first wait on an empty barrier passes at once.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; no driver function is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace probunet {
namespace hopper {

constexpr int kBoxRows = 64;                  // rows per TMA box
constexpr int kAtomBytes = 128;               // a box row: 64 bf16 columns, one swizzle atom
constexpr int kBoxBytes = kBoxRows * kAtomBytes;
constexpr int kWarpgroup = 128;

// A tile of R rows at head width KD, in bytes.
template <int KD> __host__ __device__ constexpr int tile_bytes(int rows) { return rows * KD * 2; }
// Atom a (columns 64 a ..) of a tile of R rows.
__device__ __forceinline__ const unsigned char* atom(const unsigned char* tile, int a, int rows) {
  return tile + a * rows * kAtomBytes;
}

// ---- host: tensor maps --------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The 4-D map of a (B, L, H, W) bf16 tensor at ptr with element strides
// (sb, sl, sh); boxes of 64 rows by 64 columns of one (batch, head),
// 128-byte swizzle, zeros outside. A dimension of extent 1 is given a
// packed stride (its stride is never used, and a view may carry any value
// there).
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int H, int L, int W,
                            long long sb, long long sl, long long sh) {
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const long long bh = H > 1 ? sh * 2 : W * 2;
  const long long bl = L > 1 ? sl * 2 : bh * H;
  const long long bb = B > 1 ? sb * 2 : bl * L;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)bh, (cuuint64_t)bl, (cuuint64_t)bb};
  const cuuint32_t box[4] = {kAtomBytes / 2, 1, kBoxRows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A block: NWG consumer warpgroups (threads 0 .. 128 NWG - 1), then one
// producer warp, whose first thread issues every load. With two consumers
// ptxas holds every thread to 168 registers, at 288 threads as at 384; a
// producer warpgroup handing registers to the consumers by setmaxnreg did
// not raise that (a consumer that needed more spilled or had its wgmma
// serialized), so the producer is one warp and there is no trade.
template <int NWG> constexpr int kBlockThreads = kWarpgroup * NWG + 32;

// What a kernel is on this card: out = {threads, dynamic shared bytes,
// registers, local (spilled) bytes per thread, static shared bytes}.
template <typename Kernel>
cudaError_t query(Kernel kernel, int threads, int smem, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  out[0] = threads;
  out[1] = smem;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = (int)attr.sharedSizeBytes;
  return err;
}

// ---- device: shared memory, barriers, TMA ---------------------------------------

// The first 1024-byte boundary at or after p (dynamic shared memory is
// allocated with 1024 bytes to spare).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// after every mbar_init, before any other thread touches the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Waits for the phase of the given parity to complete. A phase that never
// completes (a byte count or a parity out of step: a fault of the kernel)
// traps after 2^24 polls, a second or more, rather than hang the card.
constexpr unsigned kMaxPolls = 1u << 24;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == kMaxPolls) __trap();
  }
}

// One box (64 rows of head h of batch b from row0 on, 64 columns from col0
// on) into dst, its bytes counted on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                         int row0, int b, int col0 = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col0), "r"(h), "r"(row0),
      "r"(b)
      : "memory");
}

// A tile of R rows (R / 64 boxes down, KD / 64 atoms across) of head h of
// batch b from row0 on into dst, its tile_bytes<KD>(R) bytes counted on bar.
template <int KD, int R>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                         int h, int row0, int b) {
#pragma unroll
  for (int a = 0; a < KD / 64; ++a)
#pragma unroll
    for (int i = 0; i < R / kBoxRows; ++i)
      tma_load(dst + a * R * kAtomBytes + i * kBoxBytes, map, bar, h, row0 + kBoxRows * i, b,
               64 * a);
}

// bytes (a multiple of 16) from 16-byte-aligned src into dst, counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- device: wgmma ------------------------------------------------------------

__device__ __forceinline__ uint64_t smem_desc(const void* tile, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);  // layout 1: 128-byte swizzle
}
// A tile of whole 8-row groups read K-major; + 2 per 16 columns (32 bytes).
__device__ __forceinline__ uint64_t desc_k(const void* tile) { return smem_desc(tile, 16, 1024); }
// A tile read MN-major (the head dim is N); + 128 per 16 rows (2048 bytes).
// The head dim spans one swizzle atom, so the leading offset is never
// applied; it is given the group stride too.
__device__ __forceinline__ uint64_t desc_mn(const void* tile) {
  return smem_desc(tile, 1024, 1024);
}
constexpr uint64_t kDescK16 = 32 >> 4;     // next 16 columns, K-major
constexpr uint64_t kDescMN16 = 2048 >> 4;  // next 16 rows, MN-major
// k16 step k of a K-major tile of R rows: four steps per atom.
template <int R> __device__ __forceinline__ constexpr uint64_t desc_k_step(int k) {
  return (uint64_t)(k / 4) * (R * kAtomBytes >> 4) + (uint64_t)(k % 4) * kDescK16;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the accumulator registers in program order around the asynchronous
// products: the compiler may not move their reads or writes across it.
template <int N> __device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N> struct Wgmma;
template <> struct Wgmma<64> {
  // d (+)= A B^T: A 64 x 16 and B 64 x 16 K-major in shared memory
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  // d += A B: A 64 x 16 in registers (a warp's 16 rows, mma.sync's A
  // fragment layout), B 16 x 64 MN-major in shared memory (transposed)
  __device__ __forceinline__ static void rs_t(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<128> {
  // d (+)= A B^T: A 64 x 16 and B 128 x 16 K-major in shared memory
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
};

// d (+)= A B^T over the KD-wide head dim: A (64 rows) and B (N rows) both
// K-major tiles in shared memory; acc 0 overwrites d.
template <int N, int KD>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], const void* a, const void* b) {
  const uint64_t da = desc_k(a), db = desc_k(b);
#pragma unroll
  for (int k = 0; k < KD / 16; ++k)
    Wgmma<N>::ss(d, da + desc_k_step<64>(k), db + desc_k_step<N>(k), k);
}

// d += A B: A (64 x K) in registers as to_a gives it, B one 64-column atom
// of a tile of K rows, read MN-major.
template <int K>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[K / 16][4],
                                       const void* b) {
  const uint64_t db = desc_mn(b);
#pragma unroll
  for (int k = 0; k < K / 16; ++k) Wgmma<64>::rs_t(d, a[k], db + k * kDescMN16);
}

// The values as they stand at this point of the program: computed before
// the next asm statement (a wgmma.fence), not sunk past it.
template <int N> __device__ __forceinline__ void pin(uint64_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+l"(d[i]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An accumulator of N columns as the A operand of a product over those
// columns: k step j takes column blocks 2 j and 2 j + 1, rounded to bf16;
// with lo, also the bf16 remainders (x - bf16(x)), so that hi + lo carries
// the fp32 value to ~2^-16 relative.
template <int N>
__device__ __forceinline__ void to_a(const float (&d)[N / 2], uint32_t (&hi)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) hi[j][i] = pack_bf16(d[8 * j + 2 * i], d[8 * j + 2 * i + 1]);
}
template <int N>
__device__ __forceinline__ void to_a(const float (&d)[N / 2], uint32_t (&hi)[N / 16][4],
                                     uint32_t (&lo)[N / 16][4]) {
  to_a<N>(d, hi);
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[j][i]);
      lo[j][i] = pack_bf16(d[8 * j + 2 * i] - __low2float(h),
                           d[8 * j + 2 * i + 1] - __high2float(h));
    }
}

// Rows row0 + g and row0 + g + 8 of a warp's accumulator of atom a
// (columns 64 a ..), scaled by mul, into a contiguous (B, L, H, W) bf16
// tensor (W = 64 at KD = 64); rows at or past L and columns at or past W
// are not written.
template <int KD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, const float (&d)[32],
                                           int b, int h, int H, int L, int W, int a, int row0,
                                           int lane, const float (&mul)[2]) {
  const int g = lane / 4, t = lane % 4;
  const int pitch = KD == 64 ? 64 : W, col0 = 64 * a + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
    __nv_bfloat16* p = out + (((size_t)b * L + row) * H + h) * pitch + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (KD == 64 || col0 + 8 * j < W)
        *reinterpret_cast<uint32_t*>(p + 8 * j) =
            pack_bf16(d[4 * j + 2 * r] * mul[r], d[4 * j + 2 * r + 1] * mul[r]);
  }
}

}  // namespace hopper
}  // namespace probunet
