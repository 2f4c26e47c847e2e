// Hopper (sm_90a) machinery of the attention kernels K2 (attention_fwd.cu)
// and K3 (attention_bwd.cu): TMA tensor maps, mbarrier rings and warpgroup
// products (wgmma), for bf16 operands and, in the section "fp32 (strict)
// operands" below, for fp32 operands multiplied in 3xTF32.
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
// Head width. The kernels are instantiated for a head KD = 64, 80, 96 or
// 128 columns wide in shared memory. A tile of R rows is kAtoms = KD / 64
// column blocks ("atoms") of R x 128 bytes, atom a (columns 64 a .. 64 a +
// 63) at byte a R 128, each the landing place of one TMA box; at KD = 80 /
// 96 a tail atom of T = KD - 64 = 16 / 32 columns (R x 2T bytes) follows at
// byte R 128, loaded by a second map per tensor whose boxes are T columns
// wide (TileMap). tile_bytes<KD>(R) = 2 R KD either way. At W < KD the
// columns from W on are the map's zeros: zero columns of Q and K leave QK^T
// unchanged, zero columns of V and dO give zero columns of O, dQ, dK and
// dV, which are not stored.
// The exact widths are for heads of 65-96 columns, such as the 4 heads of
// 72 at model_channels 96's 288-wide level (b8, L=1024): bf16 bounds of
// 4 and 10 B heads L^2 c FLOP, 9.8 and 24.4 us a site for K2 and K3 at 989
// TFLOP/s. KD = 128 ran 128/72 = 1.78x those products and held 64
// accumulators a thread per output, which kept K2 to one consumer and K3's
// dK/dV to two passes; at KD = 80 K2 runs two consumers and K3 one pass.
// What still holds them back: the softmax's ex2, which does not shrink
// with c, and the tail's m64nTk16 products, which cost about what a
// whole-atom m64n64k16 does (the A fragment goes to the tensor cores
// either way).
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
// The tail atom of T columns lands in the 32-byte (T = 16) or 64-byte (T =
// 32) swizzle (CUTLASS's Layout_K_SW32/SW64 and Layout_MN_SW32/SW64 atoms):
// rows of 2T bytes, chunk c of row r at c ^ ((r / 4) % 2) or c ^ ((r / 2) %
// 4), the pattern repeating every 8 rows (16 T bytes). Its descriptors carry
// that layout type (3: 32-byte, 2: 64-byte) and 8-row groups 16 T bytes
// apart (SBO); K-major, its T / 16 k16 steps are 32 bytes apart; MN-major,
// it is the whole N of one m64nTk16 product per 16 rows, 32 T bytes on. The
// leading offset spans swizzle atoms along the swizzled dimension, of which
// each read takes one, so it is never applied.
// Tiles start on 1024-byte boundaries, and every tile is a whole number of
// KB (R 2 KD bytes at R = 64, 128), so each atom does too and the
// descriptors' base offset is 0.
//
// Products. wgmma.mma_async m64nNk16 with bf16 operands and fp32
// accumulators: a warpgroup (4 warps) owns 64 rows, warp w rows 16 w ..
// 16 w + 15, and each thread holds the mma.sync "C" layout of its warp's
// rows: d[4 j + e] is row g + 8 (e / 2), column 8 j + 2 t + (e % 2), with
// g = lane / 4, t = lane % 4. An A operand in registers takes mma.sync's
// m16n8k16 A fragment layout, so an accumulator turns into the A operand
// of the next product in registers (to_a below): P, P^T, dS and dS^T
// never pass through shared memory. A product over the head dim (S, dP)
// takes KD / 16 k16 steps: ceil(W / 16) at the exact widths, where the plan
// sends W = KD - 8 or KD, and all 8 at KD = 128, whatever W. An output
// product (O, dQ, dK, dV) is one m64n64 per atom and, at KD = 80 / 96, one
// m64nTk16 on the tail: 40 / 48 accumulators a thread where KD = 128 holds
// 64.
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
// Whole 64-column atoms of a head of KD columns, and the columns of its
// tail atom (0 at KD = 64, 128).
template <int KD> constexpr int kAtoms = KD / 64;
template <int KD> constexpr int kTail = KD % 64;
// Atom a (columns 64 a ..) of a tile of R rows.
__device__ __forceinline__ const unsigned char* atom(const unsigned char* tile, int a, int rows) {
  return tile + a * rows * kAtomBytes;
}
// The tail atom (columns 64 kAtoms ..) of a tile of R rows at head width KD.
template <int KD>
__device__ __forceinline__ const unsigned char* tail(const unsigned char* tile, int rows) {
  return tile + kAtoms<KD> * rows * kAtomBytes;
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

// The 4-D map of a (B, L, H, W) tensor at ptr with element strides (sb,
// sl, sh) and elements of esize bytes (2: bf16, 4: fp32); boxes of
// box_rows rows by box_bytes bytes of columns (one swizzle atom: 128 bytes,
// 64 bf16 or 32 fp32 columns; a bf16 tail atom of 32 or 64 bytes) of one
// (batch, head), swizzled within box_bytes, zeros outside. A dimension of
// extent 1 is given a packed stride (its stride is never used, and a view
// may carry any value there).
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int H, int L, int W,
                            long long sb, long long sl, long long sh, int esize = 2,
                            int box_rows = kBoxRows, int box_bytes = kAtomBytes) {
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const long long bh = H > 1 ? sh * esize : W * esize;
  const long long bl = L > 1 ? sl * esize : bh * H;
  const long long bb = B > 1 ? sb * esize : bl * L;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)bh, (cuuint64_t)bl, (cuuint64_t)bb};
  const cuuint32_t box[4] = {(cuuint32_t)(box_bytes / esize), 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_bytes == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUresult r = encode(map, esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            4, const_cast<void*>(ptr),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of one bf16 tensor at head width kd: 64-column boxes for its
// whole atoms and, at kd = 80 / 96, (kd - 64)-column boxes for the tail
// atom (left unencoded at kd = 64, 128, where no load reads it).
struct TileMap {
  CUtensorMap atoms, tail;
};
inline cudaError_t make_tile_map(TileMap* map, const void* ptr, int B, int H, int L, int W,
                                 long long sb, long long sl, long long sh, int kd) {
  cudaError_t err = make_map(&map->atoms, ptr, B, H, L, W, sb, sl, sh);
  if (err == cudaSuccess && kd % 64)
    err = make_map(&map->tail, ptr, B, H, L, W, sb, sl, sh, 2, kBoxRows, 2 * (kd % 64));
  return err;
}

// Whether the kernels of head width kd take rows of W columns: W = 64 or a
// multiple of 8 in 72..kd, kd one built for the dtype (bf16: 64, 80, 96,
// 128; fp32: 64, 128 and, for the forward, 256) and no narrower than W, and
// W = 64 at kd = 64 (whose results are stored 64 columns wide).
inline bool head_width_ok(int W, int kd, bool bf16) {
  const bool built = kd == 64 || kd == 128 || (bf16 ? kd == 80 || kd == 96 : kd == 256);
  return built && (W == 64 || (W > 64 && W <= kd && W % 8 == 0)) && (kd != 64 || W == 64);
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

// A tile of R rows (R / 64 boxes down; kAtoms atoms and the tail across) of
// head h of batch b from row0 on into dst, its tile_bytes<KD>(R) bytes
// counted on bar.
template <int KD, int R>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const TileMap* map, uint64_t* bar,
                                         int h, int row0, int b) {
#pragma unroll
  for (int a = 0; a < kAtoms<KD>; ++a)
#pragma unroll
    for (int i = 0; i < R / kBoxRows; ++i)
      tma_load(dst + a * R * kAtomBytes + i * kBoxBytes, &map->atoms, bar, h,
               row0 + kBoxRows * i, b, 64 * a);
  if constexpr (kTail<KD> != 0) {
    unsigned char* t = dst + kAtoms<KD> * R * kAtomBytes;
#pragma unroll
    for (int i = 0; i < R / kBoxRows; ++i)
      tma_load(t + i * kBoxRows * 2 * kTail<KD>, &map->tail, bar, h, row0 + kBoxRows * i, b,
               64 * kAtoms<KD>);
  }
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

// layout: 1 = 128-byte swizzle, 2 = 64-byte, 3 = 32-byte
__device__ __forceinline__ uint64_t smem_desc(const void* tile, unsigned lbo, unsigned sbo,
                                              unsigned layout = 1) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
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
// The tail atom of T columns (rows of 2T bytes, 8-row groups 16 T bytes
// apart) in its swizzle: read K-major (+ kDescK16 per 16 columns) or
// MN-major (+ desc_mn_tail_step<T> per 16 rows).
template <int T> constexpr unsigned kTailLayout = T == 16 ? 3u : 2u;
template <int T> __device__ __forceinline__ uint64_t desc_k_tail(const void* t) {
  return smem_desc(t, 16, 16 * T, kTailLayout<T>);
}
template <int T> __device__ __forceinline__ uint64_t desc_mn_tail(const void* t) {
  return smem_desc(t, 16 * T, 16 * T, kTailLayout<T>);
}
template <int T> constexpr uint64_t desc_mn_tail_step = (32 * T) >> 4;
// k16 step k (of KD / 16) over the head dim of a K-major tile of R rows:
// four per whole atom, then the tail's.
template <int R, int KD>
__device__ __forceinline__ uint64_t desc_k_at(const unsigned char* tile, int k) {
  if (k < 4 * kAtoms<KD>) return desc_k(tile) + desc_k_step<R>(k);
  if constexpr (kTail<KD> != 0)
    return desc_k_tail<kTail<KD>>(tail<KD>(tile, R)) + (uint64_t)(k - 4 * kAtoms<KD>) * kDescK16;
  return 0;
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

// The tail atom's output products at KD = 80 / 96: d += A B, A 64 x 16 in
// registers as in Wgmma<64>::rs_t, B 16 x N MN-major in shared memory
// (transposed), N = 16 / 32 columns.
template <> struct Wgmma<16> {
  __device__ __forceinline__ static void rs_t(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<32> {
  __device__ __forceinline__ static void rs_t(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
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

// d (+)= A B^T over the KD-wide head dim (KD / 16 k16 steps, the tail's
// last): A (64 rows) and B (N rows) both K-major tiles in shared memory;
// acc 0 overwrites d.
template <int N, int KD>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], const unsigned char* a,
                                       const unsigned char* b) {
#pragma unroll
  for (int k = 0; k < KD / 16; ++k)
    Wgmma<N>::ss(d, desc_k_at<64, KD>(a, k), desc_k_at<N, KD>(b, k), k);
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

// The same on the tail atom of T columns of a tile of K rows (m64nTk16).
template <int K, int T>
__device__ __forceinline__ void mma_rs_tail(float (&d)[T / 2], const uint32_t (&a)[K / 16][4],
                                            const void* t) {
  const uint64_t db = desc_mn_tail<T>(t);
#pragma unroll
  for (int k = 0; k < K / 16; ++k) Wgmma<T>::rs_t(d, a[k], db + k * desc_mn_tail_step<T>);
}

// The accumulator of a tail of T columns (one float where there is no tail,
// never read).
template <int KD> using TailAcc = float[kTail<KD> ? kTail<KD> / 2 : 1];

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

// Rows row0 + g and row0 + g + 8 of a warp's accumulator of N columns from
// column 64 a on (an atom, N = 64, or the tail, N = kTail<KD>), scaled by
// mul, into a contiguous (B, L, H, W) bf16 tensor (W = 64 at KD = 64); rows
// at or past L and columns at or past W are not written.
template <int KD, int N = 64>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           const float (&d)[N / 2], int b, int h, int H, int L,
                                           int W, int a, int row0, int lane,
                                           const float (&mul)[2]) {
  const int g = lane / 4, t = lane % 4;
  const int pitch = KD == 64 ? 64 : W, col0 = 64 * a + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
    __nv_bfloat16* p = out + (((size_t)b * L + row) * H + h) * pitch + col0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      if (KD == 64 || col0 + 8 * j < W)
        *reinterpret_cast<uint32_t*>(p + 8 * j) =
            pack_bf16(d[4 * j + 2 * r] * mul[r], d[4 * j + 2 * r + 1] * mul[r]);
  }
}

// ---- fp32 (strict) operands: 3xTF32 on tf32 wgmma ----------------------------
//
// Numerics. Each fp32 operand x is carried as hi = tf32(x) (cvt.rna: round
// to nearest, ties away, 10 mantissa bits) and lo = tf32(x - hi), and a
// product sums lo*hi + hi*lo + hi*hi per k8 step with fp32 accumulators,
// within a few fp32 ulps of the fp32 product (the dropped lo*lo is ~2^-22
// relative). The split is explicit, so PyTorch's TF32 switches play no part.
//
// Tiles. An fp32 tile of R rows and KD columns is KD / 32 atoms of R x 128
// bytes (32 columns), the layout a TMA box of R rows by 32 columns with the
// 128-byte swizzle lands; a k8 step of a K-major read is 32 bytes, four per
// atom, so desc_k and desc_k_step serve fp32 tiles as they serve bf16 ones.
// tf32 wgmma reads K-major operands only (it has no transpose bit). Where a
// product contracts over a tile's rows (O += P V, dV += P^T dO, dK += dS^T
// Q, dQ += dS K), the operand is the tile's transpose: KD rows of R columns,
// R / 32 atoms of KD x 128 bytes, written by the block's producer
// warpgroup (transpose_tile). Its k order is permuted within each 8-column
// step: position p holds source row 2 p (p < 4) or 2 (p - 4) + 1, so that
// an accumulator in the C layout is the A fragment of the next product as
// it stands (split_a), with no shuffle.
//
// Block. A consumer warpgroup (threads 0-127) runs the products and a
// producer warpgroup (128-255) loads and prepares the operands: its first
// thread issues the TMA loads; all 128 threads split each landed tile into
// hi (in place) and lo once (split_tile), write the transposed pairs
// (transpose_tile), fence the writes for the async proxy that wgmma reads
// through, and arrive on the stage's barriers. 256 threads leave every
// thread up to 255 registers.
//
// Stages. Each stage of a ring has five barriers (Ring32): loaded (the TMA
// unit's byte count), nat_full / nat_empty (the K-major operands, ready for
// and released by the consumer) and t_full / t_empty (the transposed ones).
// The consumer releases the K-major operands as soon as their products have
// retired (and, in K3's dK/dV kernel, the stage's lse2 / D, loaded with them,
// have been read), so with one stage the producer loads and splits the next
// tile while the consumer finishes this one.

constexpr int kF32Cols = kAtomBytes / 4;   // fp32 columns per swizzle atom (one TMA box)
constexpr int kF32BoxRows = 32;            // rows per fp32 TMA box

// An fp32 tile of R rows at head width KD, in bytes (also its transpose's).
template <int KD> __host__ __device__ constexpr int f32_tile_bytes(int rows) {
  return rows * KD * 4;
}

struct Ring32 {
  uint64_t loaded, nat_full, nat_empty, t_full, t_empty;
};

// Thread 0 initialises own (loaded, ready) and S stages of a ring.
template <int S> __device__ __forceinline__ void ring32_init(uint64_t* own, Ring32* ring) {
  mbar_init(&own[0], 1);
  mbar_init(&own[1], kWarpgroup);
  for (int s = 0; s < S; ++s) {
    mbar_init(&ring[s].loaded, 1);
    mbar_init(&ring[s].nat_full, kWarpgroup);
    mbar_init(&ring[s].nat_empty, kWarpgroup);
    mbar_init(&ring[s].t_full, kWarpgroup);
    mbar_init(&ring[s].t_empty, kWarpgroup);
  }
  mbar_fence_init();
}
// bytes of the barriers of own and S stages
template <int S> constexpr int kRing32Bytes = 16 + S * (int)sizeof(Ring32);

// Generic-proxy writes to shared memory made visible to wgmma's (async
// proxy) reads that the next barrier orders after them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The producer warpgroup's 128 threads, and only they (named barrier 1).
__device__ __forceinline__ void producer_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// A tile of R rows (R / 32 boxes down, KD / 32 atoms across) of head h of
// batch b from row0 on into dst, its f32_tile_bytes<KD>(R) bytes counted
// on bar; the map's boxes are kF32BoxRows x kF32Cols.
template <int KD, int R>
__device__ __forceinline__ void tma_tile_f32(unsigned char* dst, const CUtensorMap* map,
                                             uint64_t* bar, int h, int row0, int b) {
#pragma unroll
  for (int a = 0; a < KD / kF32Cols; ++a)
#pragma unroll
    for (int i = 0; i < R / kF32BoxRows; ++i)
      tma_load(dst + a * R * kAtomBytes + i * kF32BoxRows * kAtomBytes, map, bar, h,
               row0 + kF32BoxRows * i, b, kF32Cols * a);
}

// hi = tf32(x) in place and lo = tf32(x - hi) at the same offset, over a
// tile of BYTES bytes; by the 128 threads (tid) of a warpgroup, 16 bytes a
// thread at a time (the layout does not matter: each element keeps its place).
template <int BYTES>
__device__ __forceinline__ void split_tile(unsigned char* hi, unsigned char* lo, int tid) {
  float4* h = reinterpret_cast<float4*>(hi);
  float4* l = reinterpret_cast<float4*>(lo);
#pragma unroll 4
  for (int i = tid; i < BYTES / 16; i += kWarpgroup) {
    const float4 x = h[i];
    float4 a, c;
    split_tf32(x.x, a.x, c.x);
    split_tf32(x.y, a.y, c.y);
    split_tf32(x.z, a.z, c.z);
    split_tf32(x.w, a.w, c.w);
    h[i] = a;
    l[i] = c;
  }
}

// The transposed hi / lo pair of a tile of R rows at head width KD into
// dst_hi / dst_lo (KD rows of R columns, k order permuted as above): from
// the tile's hi / lo pair, or with RAW from the raw tile src_hi, split
// here. By the 128 threads (tid) of a warpgroup: a thread takes one column
// d and one 8-row chunk of the source, lanes on consecutive columns (the
// swizzle puts 32 consecutive columns of a row in 32 banks), and writes two
// 16-byte pieces of row d of each destination (the 8 threads of a
// quarter-warp on 8 rows, 8 different chunks).
template <int KD, int R, bool RAW>
__device__ __forceinline__ void transpose_tile(const unsigned char* src_hi,
                                               const unsigned char* src_lo, unsigned char* dst_hi,
                                               unsigned char* dst_lo, int tid) {
  constexpr int kColAtoms = KD / kF32Cols;
#pragma unroll 2
  for (int i = tid; i < KD * R / 8; i += kWarpgroup) {
    const int dl = i % kF32Cols, da = (i / kF32Cols) % kColAtoms, c8 = i / kF32Cols / kColAtoms;
    const int src = da * R * kAtomBytes + 8 * c8 * kAtomBytes + (dl % 4) * 4;
    float hi[8], lo[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // source row 8 c8 + k: its swizzle phase is k
      const int off = src + k * kAtomBytes + (((dl / 4) ^ k) << 4);
      if constexpr (RAW) {
        split_tf32(*reinterpret_cast<const float*>(src_hi + off), hi[k], lo[k]);
      } else {
        hi[k] = *reinterpret_cast<const float*>(src_hi + off);
        lo[k] = *reinterpret_cast<const float*>(src_lo + off);
      }
    }
    // row d = 32 da + dl of atom c8 / 4, 16-byte chunks 2 (c8 % 4) and + 1
    const int d = kF32Cols * da + dl, chunk = 2 * (c8 % 4);
    const int row = (c8 / 4) * KD * kAtomBytes + d * kAtomBytes;
    const int o0 = row + ((chunk ^ (d % 8)) << 4), o1 = row + (((chunk + 1) ^ (d % 8)) << 4);
    *reinterpret_cast<float4*>(dst_hi + o0) = make_float4(hi[0], hi[2], hi[4], hi[6]);
    *reinterpret_cast<float4*>(dst_hi + o1) = make_float4(hi[1], hi[3], hi[5], hi[7]);
    *reinterpret_cast<float4*>(dst_lo + o0) = make_float4(lo[0], lo[2], lo[4], lo[6]);
    *reinterpret_cast<float4*>(dst_lo + o1) = make_float4(lo[1], lo[3], lo[5], lo[7]);
  }
}

template <int N> struct WgmmaTf32;
template <> struct WgmmaTf32<32> {
  // d (+)= A B^T: A 64 x 8 and B 32 x 8, K-major tf32 tiles in shared memory
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct WgmmaTf32<64> {
  // d (+)= A B^T: A 64 x 8 and B 64 x 8, K-major tf32 tiles in shared memory
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  // d (+)= A B^T: A 64 x 8 in registers (tf32, split_a's fragments), B 64 x 8
  // K-major in shared memory
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <> struct WgmmaTf32<128> {
  // d (+)= A B^T: A 64 x 8 in registers (tf32, split_a's fragments), B 128 x 8
  // K-major in shared memory
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// The k8 steps of a product over the head dim that hold its W columns: all
// KD / 8 at KD = 64; at KD = 128 ceil(W / 8), the columns from W on being
// zeros (at c = 72, 9 of 16).
template <int KD> __device__ __forceinline__ int head_steps(int W) {
  return KD == 64 ? KD / 8 : (W + 7) / 8;
}

// d (+)= A B^T over the first 8 ksteps of 8 KSTEPS columns in 3xTF32: A (64
// rows) and B (N rows) hi / lo pairs of K-major tiles in shared memory; each
// k8 step adds lo*hi, hi*lo, hi*hi, or with SWAP hi*lo, lo*hi, hi*hi, so
// that B^T's transpose computed as B A^T sums as A B^T does (S^T = K Q^T in
// the order of S = Q K^T). acc 0 starts d afresh.
template <int N, int KSTEPS, bool SWAP = false>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], const void* a_hi, const void* a_lo,
                                        const void* b_hi, const void* b_lo, int acc,
                                        int ksteps) {
  const uint64_t ah = desc_k(a_hi), al = desc_k(a_lo), bh = desc_k(b_hi), bl = desc_k(b_lo);
#pragma unroll
  for (int k = 0; k < KSTEPS; ++k) {
    if (k >= ksteps) break;
    const uint64_t sa = desc_k_step<64>(k), sb = desc_k_step<N>(k);
    if constexpr (SWAP) {
      WgmmaTf32<N>::ss(d, ah + sa, bl + sb, k > 0 || acc);
      WgmmaTf32<N>::ss(d, al + sa, bh + sb, 1);
    } else {
      WgmmaTf32<N>::ss(d, al + sa, bh + sb, k > 0 || acc);
      WgmmaTf32<N>::ss(d, ah + sa, bl + sb, 1);
    }
    WgmmaTf32<N>::ss(d, ah + sa, bh + sb, 1);
  }
}

// d (+)= A B^T over 8 KSTEPS columns in 3xTF32: A in registers as split_a
// gives it, B (N rows) the hi / lo pair of a K-major tile (a transposed
// tile: N = KD rows); lo*hi, hi*lo, hi*hi per k8 step.
template <int N, int KSTEPS>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2], const uint32_t (&a_hi)[KSTEPS][4],
                                        const uint32_t (&a_lo)[KSTEPS][4], const void* b_hi,
                                        const void* b_lo, int acc) {
  const uint64_t bh = desc_k(b_hi), bl = desc_k(b_lo);
#pragma unroll
  for (int k = 0; k < KSTEPS; ++k) {
    const uint64_t sb = desc_k_step<N>(k);
    WgmmaTf32<N>::rs(d, a_lo[k], bh + sb, k > 0 || acc);
    WgmmaTf32<N>::rs(d, a_hi[k], bl + sb, 1);
    WgmmaTf32<N>::rs(d, a_hi[k], bh + sb, 1);
  }
}

// An accumulator of N columns as the tf32 A operand (hi and lo) of a
// product over those columns: k8 step j takes columns 8 j .. 8 j + 7, its k
// position t (t + 4) holding column 8 j + 2 t (+ 1), the order of the
// transposed tiles' permuted columns; a0..a3 are rows (g, g + 8) x
// positions (t, t + 4) as the tf32 A fragment orders them.
template <int N>
__device__ __forceinline__ void split_a(const float (&d)[N / 2], uint32_t (&hi)[N / 8][4],
                                        uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float x[4] = {d[4 * j], d[4 * j + 2], d[4 * j + 1], d[4 * j + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float h, l;
      split_tf32(x[i], h, l);
      hi[j][i] = __float_as_uint(h);
      lo[j][i] = __float_as_uint(l);
    }
  }
}

// Rows row0 + g and row0 + g + 8 of a warp's accumulator of KD columns
// (mma.sync's C layout: d[4 j + e] is column 8 j + 2 t + e % 2), scaled by
// mul, into a contiguous (B, L, H, W) fp32 tensor (W = 64 at KD = 64); rows
// at or past L and columns at or past W are not written.
template <int KD>
__device__ __forceinline__ void store_rows_f32(float* __restrict__ out, const float (&d)[KD / 2],
                                               int b, int h, int H, int L, int W, int row0,
                                               int lane, const float (&mul)[2]) {
  const int g = lane / 4, t = lane % 4;
  const int pitch = KD == 64 ? 64 : W;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
    float* p = out + (((size_t)b * L + row) * H + h) * pitch + 2 * t;
#pragma unroll
    for (int j = 0; j < KD / 8; ++j)
      if (KD == 64 || 8 * j + 2 * t < W)
        *reinterpret_cast<float2*>(p + 8 * j) =
            make_float2(d[4 * j + 2 * r] * mul[r], d[4 * j + 2 * r + 1] * mul[r]);
  }
}

template <int N> __device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

}  // namespace hopper
}  // namespace probunet
