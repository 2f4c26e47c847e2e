// Fused self-attention backward: the gradients of O = softmax(Q (K s)^T) V,
// s = 1/sqrt(c) for a head dim c up to 128, with respect to Q, K and V;
// kernel K3 of the port, for Hopper (sm_90a), deterministic.
//
// Replaces probunet_tpu/ops/pallas_attn.py::_bwd_kernel (launched by
// _bwd_pallas). That kernel walks 256-row q chunks along a sequential grid
// axis and accumulates dK and dV across them in its output block
// (pl.when(ci == 0) zeroes it first). Hopper blocks run in no order, so the
// work is cut into kernels that each own what they write:
//   (a) the row pass D = rowsum(dO o O), one block per (batch * head,
//       64-row tile);
//   (b) dK/dV: one block per (batch * head, block of key rows) loops over
//       the q tiles and keeps dK and dV in registers;
//   (c) dQ: one block per (batch * head, block of query rows) loops over
//       the K/V tiles and keeps dQ in registers.
// (b) and (c) recompute the weights as P = exp(S s - lse) from the row
// log-sum-exp that the forward kernel (attention_fwd.cu) saved, so no
// (L, L) tensor reaches device memory; like the forward kernel they take
// the exponential in base 2 by the SFU's ex2 (about 2 ulp).
//
// Deterministic: every sum runs in one order fixed by the code, and each
// output element is written by one thread of one block, with no atomics;
// dQ in particular is summed over the K/V tiles inside one block (c), in
// tile order, so two calls give the same bits (chip_smoke.py phase 7 and
// tests/test_torch_cuda.py check it). This costs seven L x L x c
// products where five suffice (S and dP are recomputed in (c)). The
// five-product design, each dK/dV block also computing dS K for its keys
// (dS staged in shared memory, read MN-major) and adding it into an fp32
// scratch in a fixed order under a per-q-tile counter, ran 4.3x slower on
// the H100 (0.51 against 0.12 ms at L=1024, 6 heads, b8: every share
// waits for the one before it), and was dropped.
//
// Bound: operations, 10 * B * heads * L^2 * c FLOP (the TPU kernel's five
// L x L x c products: S, dV, dP, dQ, dK), against the H100's 989 TFLOP/s
// of bf16 tensor-core products (fast mode) or, in strict mode, the smaller
// of the fp32 CUDA-core time (67 TFLOP/s) and three TF32 products (495
// TFLOP/s). At the U-Net's sites (b8: L=1024 with 6 heads, L=256 with 8)
// the bf16 bound is 0.19 ms per backward of 11 sites.
//
// Head dims: as in the forward kernel, every kernel is instantiated for a
// head KD = 64 or 128 columns wide in shared memory, 64 < c <= 128 running
// KD = 128 with the columns past c zero (attention_hopper.cuh,
// attention_tiles.cuh). At KD = 128 the bf16 kernels take 64-row blocks of
// one consumer warpgroup, and (b) runs as two passes over the q tiles, one
// for dV and one for dK, each recomputing S^T: dK and dV of 64 keys by
// 128 columns are 128 fp32 registers a thread together, which beside S^T,
// dP^T and their bf16 A operands would spill. The fp32 kernels at KD = 128
// hold the same accumulators in one pass and spill (ptxas -v in
// chip_smoke.py phase 1's build log; PERF.md section 6).
//
// bf16 (fast, and strict with bf16 activations): the machinery of
// attention_hopper.cuh, warp-specialised as the forward kernel:
//   (a) attention_bwd_prep_sm90: D on the CUDA cores in fp32, four threads
//       per row; it writes D and the forward's lse in base 2 into a padded
//       (batch * head, tile, 2, 64) fp32 scratch, rows past L as lse = +inf
//       (so P = 0 there) and D = 0;
//   (b) attention_bwd_dkdv_sm90: a producer warp loads the block's K and V
//       once and keeps TMA loads of 64-row Q and dO tiles, with their lse
//       and D (one bulk copy), in flight through a ring of kBwdStages
//       stages; consumer warpgroups of 64 keys compute S^T = K Q^T and
//       dP^T = V dO^T on wgmma with both operands K-major in shared memory;
//       P^T and dS^T stay in registers as the A operands of dV += P^T dO
//       and dK += dS^T Q, with dO and Q read MN-major;
//   (c) attention_bwd_dq_sm90: the same ring of 64-row K and V tiles
//       against the block's Q and dO: S = Q K^T, dP = dO V^T, then dQ += dS
//       K with dS in registers and K read MN-major.
//   K/V rows past L arrive as zeros (the TMA box is clipped by the map), so
//   their terms vanish in dQ, and the rows they give dK and dV are not
//   stored; no tile needs a mask. Block sizes come from
//   ops/attention.py::plan. The products of one tile run after the
//   elementwise work of the last, not beside it: overlapping them as the
//   forward kernel does needs a second set of S, dP and operand registers,
//   about 210 a thread, which spilled at the 168 that ptxas allows two
//   consumer warpgroups and left one 64-key block per SM otherwise, both
//   slower on the H100. What holds it back: that serial order, seven
//   products where five suffice, and the ex2 of P, recomputed twice.
// fp32 (strict): attention_bwd_rowdot (D as the diagonal of dO O^T on the
// tensor cores), attention_bwd_dkdv and attention_bwd_dq on mma.sync in
// 3xTF32 (tile machinery in attention_tiles.cuh): four warps per block, 16
// rows each; the block's own tiles are loaded once and the streamed tiles
// pass through a 2-stage cp.async ring. In (b) each warp owns 16 keys and
// computes the transposed products S^T = K Q^T and dP^T = V dO^T directly,
// so P^T and dS^T sit in registers in the C layout and feed dV += P^T dO
// and dK += dS^T Q as A operands. A ragged last tile is zero-filled and
// masked (P = 0 there).
//
// Layout: q, k, v, o (the forward output) and dout are (B, L, heads, W)
// with any element strides and a unit-stride head dim, rows 16-byte
// aligned, W = 64 or a multiple of 8 in 72..128 (the head dim, or the
// wrapper's zero-padded width); dq, dk, dv are contiguous (B, L, heads, W).
//
// Numerics follow _bwd_kernel (pallas_attn.py:101-135):
//   - S is recomputed on the forward kernel's operands with the same
//     products (in (b) as S^T = K Q^T; in fp32 the 3xTF32 terms ordered as
//     in Q K^T). P = exp(S s - lse) is not bit-equal to the forward
//     kernel's weights, whose lse sums them in another order: they differ
//     by a few fp32 ulps;
//   - the dV and dP legs run at the model dtype: P is rounded to it before
//     dV = P^T dO, and dP = dO V^T multiplies model-dtype operands with
//     fp32 sums;
//   - dS = P o (dP - D) is fp32, rounded to bf16 before dQ and dK only in
//     fast mode; strict mode with bf16 activations keeps dS fp32 by
//     carrying it as two bf16 terms hi + lo (two products, ~2^-16
//     relative);
//   - fp32 (strict) products are 3xTF32;
//   - dQ = (dS K) * s with the raw K, dK = (dS^T Q) * s;
//   - D = rowsum(dO o O) stands for the TPU kernel's rowsum(dP o P). The two
//     are equal up to rounding in fp32; with bf16 activations (fast mode
//     and strict mode alike) O is stored as bf16, which moves dQ and dK by
//     ~1e-3 of their norm, within the bf16 tolerance of 5e-2 (chip_smoke.py
//     phase 7 measures it). In fp32 D is taken on the tensor cores in the
//     form of dP, so that dS = 0 exactly where the plain version's is (a
//     one-hot softmax row); the bf16 kernels' fp32 D leaves ~1e-6 there.

#include <math.h>

#include "attention_hopper.cuh"
#include "attention_tiles.cuh"

namespace probunet {
namespace {

namespace fp32 {

using namespace tiles;

// D = rowsum(dO o O) as the diagonal of the tile product dO O^T, on the
// tensor cores in the same form as dP = dO V^T in (b) and (c). Where a row's
// softmax is one-hot (L = 1), O is that row of V as the forward kernel's
// PV product rounds it, D comes out equal to dP, and dS = P o (dP - D)
// vanishes as it does in the plain version (an fp32 D from CUDA-core FMAs
// left ~1e-6 there against 3xTF32's dP).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_rowdot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ D,
                         int H, int L, int W, Strides so, Strides sdo) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = kPitch<T, HD>;
  T* dOs = reinterpret_cast<T*>(smem);
  T* Os = dOs + kTile<T, HD>;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  load_tile_async<T, HD>(dOs, dout + b * sdo.b + h * sdo.h, sdo.l, r0, L, W, tid);
  load_tile_async<T, HD>(Os, o + b * so.b + h * so.h, so.l, r0, L, W, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float acc[8][4];
  zero(acc);
  mma_nt<HD>(acc, dOs + warp * 16 * P, Os, lane);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = warp * 16 + lane / 4 + 8 * (e / 2);
      if (8 * n + 2 * t + (e % 2) == row && r0 + row < L)
        D[(size_t)bh * L + r0 + row] = acc[n][e];
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ D, T* __restrict__ dk, T* __restrict__ dv, int H,
                       int L, int W, Strides sq, Strides sk, Strides sv, Strides sdo,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = kPitch<T, HD>;
  constexpr int kT = kTile<T, HD>;
  T* Ks = reinterpret_cast<T*>(smem);   // this block's K tile
  T* Vs = Ks + kT;                      // this block's V tile
  T* Qs = Vs + kT;                      // two stages
  T* dOs = Qs + 2 * kT;                 // two stages
  float* stats = reinterpret_cast<float*>(dOs + 2 * kT);  // per stage: lse[64], D[64]

  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;

  load_tile_async<T, HD>(Ks, k + b * sk.b + h * sk.h, sk.l, k0, L, W, tid);
  load_tile_async<T, HD>(Vs, v + b * sv.b + h * sv.h, sv.l, k0, L, W, tid);
  // q tile j into stage st: Q and dO by cp.async, lse (in base 2) and D
  // (rows of a (B*H, L) array, not 16-byte aligned for every L) by plain
  // loads
  auto load_q_tile = [&](int j, int st) {
    load_tile_async<T, HD>(Qs + st * kT, qb, sq.l, j * kRows, L, W, tid);
    load_tile_async<T, HD>(dOs + st * kT, dob, sdo.l, j * kRows, L, W, tid);
    const int i = j * kRows + tid % kRows;
    const float* src = (tid < kRows ? lse : D) + (size_t)bh * L;
    stats[st * 2 * kRows + tid] = i < L ? src[i] * (tid < kRows ? kLog2e : 1.f) : 0.f;
  };
  load_q_tile(0, 0);
  cp_async_commit();

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  const int key0 = k0 + warp * 16 + lane / 4;  // this thread's keys: key0, key0 + 8
  const float c = scale * kLog2e;
  const int n_tiles = (L + kRows - 1) / kRows;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_q_tile(j + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + st * kT;
    const T* dOt = dOs + st * kT;
    const float* lse_s = stats + st * 2 * kRows;
    const float* D_s = lse_s + kRows;

    // P^T: rows are this warp's keys, columns the tile's queries
    float p[8][4];
    zero(p);
    mma_nt<HD, true>(p, Ks + warp * 16 * P, Qt, lane);  // summed as the forward's S = Q K^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e % 2);
        const bool ok = key0 + 8 * (e / 2) < L && j * kRows + col < L;
        p[n][e] = ok ? exp2_fast(fmaf(p[n][e], c, -lse_s[col])) : 0.f;
      }
    mma_nn<false, HD>(dv_acc, p, dOt, lane);  // dV += P^T dO

    float ds[8][4];  // dP^T, then dS^T
    zero(ds);
    mma_nt<HD, true>(ds, Vs + warp * 16 * P, dOt, lane);  // summed as (c)'s dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - D_s[8 * n + 2 * t + (e % 2)]);
    mma_nn<false, HD>(dk_acc, ds, Qt, lane);  // dK += dS^T Q
    __syncthreads();  // this stage is free for the load two tiles on
  }
  const float one[2] = {1.f, 1.f}, s2[2] = {scale, scale};
  store_rows<T, HD>(dk, dk_acc, b, h, H, L, W, k0 + warp * 16, lane, s2);
  store_rows<T, HD>(dv, dv_acc, b, h, H, L, W, k0 + warp * 16, lane, one);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ D, T* __restrict__ dq, int H, int L, int W,
                     Strides sq, Strides sk, Strides sv, Strides sdo, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = kPitch<T, HD>;
  constexpr int kT = kTile<T, HD>;
  T* Qs = reinterpret_cast<T*>(smem);   // this block's Q tile
  T* dOs = Qs + kT;                     // this block's dO tile
  T* Ks = dOs + kT;                     // two stages
  T* Vs = Ks + 2 * kT;                  // two stages

  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_tile_async<T, HD>(Qs, q + b * sq.b + h * sq.h, sq.l, q0, L, W, tid);
  load_tile_async<T, HD>(dOs, dout + b * sdo.b + h * sdo.h, sdo.l, q0, L, W, tid);
  load_tile_async<T, HD>(Ks, kb, sk.l, 0, L, W, tid);
  load_tile_async<T, HD>(Vs, vb, sv.l, 0, L, W, tid);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  float lse_r[2], D_r[2], dq_acc[HD / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row0 + 8 * r < L;
    lse_r[r] = ok ? lse[(size_t)bh * L + row0 + 8 * r] * kLog2e : 0.f;  // base 2
    D_r[r] = ok ? D[(size_t)bh * L + row0 + 8 * r] : 0.f;
  }
  zero(dq_acc);
  const float c = scale * kLog2e;

  const int n_tiles = (L + kRows - 1) / kRows;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile_async<T, HD>(Ks + (st ^ 1) * kT, kb, sk.l, (j + 1) * kRows, L, W, tid);
      load_tile_async<T, HD>(Vs + (st ^ 1) * kT, vb, sv.l, (j + 1) * kRows, L, W, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * kT;

    float p[8][4], ds[8][4];  // S then P; dP then dS
    zero(p);
    zero(ds);
    mma_nt<HD>(p, Qs + warp * 16 * P, Kt, lane);
    mma_nt<HD>(ds, dOs + warp * 16 * P, Vs + st * kT, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const bool ok = row0 + 8 * r < L && j * kRows + 8 * n + 2 * t + (e % 2) < L;
        p[n][e] = ok ? exp2_fast(fmaf(p[n][e], c, -lse_r[r])) : 0.f;
        ds[n][e] = p[n][e] * (ds[n][e] - D_r[r]);
      }
    mma_nn<false, HD>(dq_acc, ds, Kt, lane);  // dQ += dS K, the raw K
    __syncthreads();  // this stage is free for the load two tiles on
  }
  const float s2[2] = {scale, scale};
  store_rows<T, HD>(dq, dq_acc, b, h, H, L, W, q0 + warp * 16, lane, s2);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* D, void* dq, void* dk, void* dv, int B, int H, int L,
                   int W, Strides sq, Strides sk, Strides sv, Strides so, Strides sdo,
                   float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 grid((L + kRows - 1) / kRows, B * H);
  constexpr size_t rowdot_smem = 2 * kTile<T, HD> * sizeof(T);  // dO and O
  cudaError_t err = cudaSuccess;
  if constexpr (rowdot_smem > 48 * 1024)
    err = cudaFuncSetAttribute(attention_bwd_rowdot<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rowdot_smem);
  if (err != cudaSuccess) return err;
  attention_bwd_rowdot<T, HD><<<grid, kThreads, rowdot_smem, stream>>>(
      static_cast<const T*>(o), dot, D, H, L, W, so, sdo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // K, V, two Q and two dO stages, and two stages of lse and D
  constexpr size_t dkdv_smem = 6 * kTile<T, HD> * sizeof(T) + 4 * kRows * sizeof(float);
  err = cudaFuncSetAttribute(attention_bwd_dkdv<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkdv_smem);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv<T, HD><<<grid, kThreads, dkdv_smem, stream>>>(
      qt, kt, vt, dot, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), H, L, W, sq, sk, sv,
      sdo, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t dq_smem = 6 * kTile<T, HD> * sizeof(T);  // Q, dO, two K and two V stages
  err = cudaFuncSetAttribute(attention_bwd_dq<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  attention_bwd_dq<T, HD><<<grid, kThreads, dq_smem, stream>>>(
      qt, kt, vt, dot, lse, D, static_cast<T*>(dq), H, L, W, sq, sk, sv, sdo, scale);
  return cudaGetLastError();
}

}  // namespace fp32

namespace sm90 {

using namespace hopper;

constexpr int kBwdStages = 3;
constexpr int kPrepThreads = 256;  // four per row of a 64-row tile

// (a) D = rowsum(dO o O) in fp32 and the forward's lse in base 2, per
// 64-row tile of one (batch * head) into stats[bh][tile] = {lse2[64],
// D[64]}; rows past L get lse2 = +inf (P = 0) and D = 0. At KD = 64 a
// row's four threads sum 16 columns each; at KD = 128, 8-column chunks
// q, q + 4, ... of the row's W columns.
template <int KD>
__global__ void __launch_bounds__(kPrepThreads)
    attention_bwd_prep_sm90(const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                            float* __restrict__ stats, int H, int L, int W, tiles::Strides so,
                            tiles::Strides sdo) {
  const int bh = blockIdx.y, b = bh / H, h = bh % H, tile = blockIdx.x;
  const int r = threadIdx.x / 4, part = threadIdx.x % 4, row = tile * 64 + r;
  float d = 0.f;
  if (row < L) {
    const __nv_bfloat16* po = o + b * so.b + h * so.h + row * so.l;
    const __nv_bfloat16* pd = dout + b * sdo.b + h * sdo.h + row * sdo.l;
    if constexpr (KD == 64) {
#pragma unroll
      for (int c = 0; c < 16; c += 8) {
        float x[8], y[8];
        load_vec<__nv_bfloat16, 8>(po + part * 16 + c, x);
        load_vec<__nv_bfloat16, 8>(pd + part * 16 + c, y);
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(y[i], x[i], d);
      }
    } else {
      for (int c = 8 * part; c < W; c += 32) {
        float x[8], y[8];
        load_vec<__nv_bfloat16, 8>(po + c, x);
        load_vec<__nv_bfloat16, 8>(pd + c, y);
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(y[i], x[i], d);
      }
    }
  }
  d = quad_sum(d);
  if (part == 0) {
    float* out = stats + ((size_t)bh * gridDim.x + tile) * 128;
    out[r] = row < L ? lse[(size_t)bh * L + row] * kLog2e : INFINITY;
    out[64 + r] = d;
  }
}

// Shared memory of (b) and (c): byte offsets from a 1024-byte boundary.
// Each holds its block's two operand tiles (NWG 64-row tiles each: K and
// V, or Q and dO) and kBwdStages stages of two streamed 64-row tiles; (b)
// also stages each q tile's 128 floats of stats.
template <int NWG, bool STATS, int KD> struct BwdSmem {
  static constexpr int kT = tile_bytes<KD>(64);
  static constexpr int own0 = 0, own1 = NWG * kT;                 // the block's tiles
  static constexpr int in0 = 2 * NWG * kT;                        // kBwdStages tiles
  static constexpr int in1 = in0 + kBwdStages * kT;               // kBwdStages tiles
  static constexpr int stats = in1 + kBwdStages * kT;             // kBwdStages x 512 bytes
  static constexpr int bars = stats + (STATS ? kBwdStages * 512 : 0);
  static constexpr int bytes = bars + 8 * (1 + 2 * kBwdStages) + 1024;
};

// The barriers of (b) and (c), initialised by thread 0: own_full for the
// block's tiles, then full and empty per stage.
template <int NWG, bool STATS, int KD>
__device__ __forceinline__ void bwd_barriers(unsigned char* smem, uint64_t*& own_full,
                                             uint64_t*& full, uint64_t*& empty) {
  own_full = reinterpret_cast<uint64_t*>(smem + BwdSmem<NWG, STATS, KD>::bars);
  full = own_full + 1;
  empty = full + kBwdStages;
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarpgroup * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer of (b) and (c): the block's own tiles (rows r0 on, of maps
// own0 and own1) once, then for each of n_tiles 64-row tiles the rows of
// maps in0 and in1 (and, with stats, the tile's 512 bytes from stats_bh)
// into the ring.
template <int NWG, bool STATS, int KD>
__device__ __forceinline__ void bwd_producer(unsigned char* smem, uint64_t* own_full,
                                             uint64_t* full, uint64_t* empty,
                                             const CUtensorMap* own0, const CUtensorMap* own1,
                                             const CUtensorMap* in0, const CUtensorMap* in1,
                                             const float* stats_bh, int h, int b, int r0,
                                             int n_tiles) {
  using Smem = BwdSmem<NWG, STATS, KD>;
  constexpr int kT = Smem::kT;
  mbar_expect_tx(own_full, 2 * NWG * kT);
  for (int w = 0; w < NWG; ++w) {
    tma_tile<KD, 64>(smem + Smem::own0 + w * kT, own0, own_full, h, r0 + 64 * w, b);
    tma_tile<KD, 64>(smem + Smem::own1 + w * kT, own1, own_full, h, r0 + 64 * w, b);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kBwdStages;
    mbar_wait(&empty[s], ((j / kBwdStages) & 1) ^ 1);
    mbar_expect_tx(&full[s], 2 * kT + (STATS ? 512 : 0));
    tma_tile<KD, 64>(smem + Smem::in0 + s * kT, in0, &full[s], h, 64 * j, b);
    tma_tile<KD, 64>(smem + Smem::in1 + s * kT, in1, &full[s], h, 64 * j, b);
    if constexpr (STATS)
      bulk_load(smem + Smem::stats + s * 512, stats_bh + 128 * j, 512, &full[s]);
  }
}

// What a dK/dV kernel computes: both (KD = 64), or at KD = 128 one of its
// two passes.
constexpr int kPassDV = 1, kPassDK = 2, kPassBoth = 3;

// P and dS of one tile from S and dP in registers: p = 2^(S c - lse2), dS =
// P o (dP - D), lse2 and D given per element by the functions; P rounded to
// bf16 into pa (when given), dS into hi and, with SPLIT, its bf16
// remainder into lo.
template <bool SPLIT, typename Lse, typename Dv>
__device__ __forceinline__ void grads(float (&p)[32], float (&ds)[32], float c, Lse lse2, Dv D,
                                      uint32_t (*pa)[4][4], uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p[i] = exp2_fast(fmaf(p[i], c, -lse2(i)));
    ds[i] = p[i] * (ds[i] - D(i));
  }
  if (pa != nullptr) to_a<64>(p, *pa);
  if constexpr (SPLIT) to_a<64>(ds, hi, lo);
  else to_a<64>(ds, hi);
}

// (b) dK and dV (per PASS) of 64 NWG key rows; SPLIT carries dS as bf16
// hi + lo.
template <int NWG, bool SPLIT, int KD, int PASS>
__global__ void __launch_bounds__(kBlockThreads<NWG>, 1)
    attention_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int H, int L, int W, float scale) {
  using Smem = BwdSmem<NWG, true, KD>;
  constexpr int kT = Smem::kT, kA = KD / 64;
  constexpr bool kDV = PASS & kPassDV, kDK = PASS & kPassDK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t *own_full, *full, *empty;
  bwd_barriers<NWG, true, KD>(smem, own_full, full, empty);
  auto Qs = [&](int s) { return smem + Smem::in0 + s * kT; };
  auto dOs = [&](int s) { return smem + Smem::in1 + s * kT; };
  auto stat = [&](int s) { return reinterpret_cast<const float*>(smem + Smem::stats + s * 512); };
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * 64 * NWG;
  const int n_tiles = (L + 63) / 64;

  if (threadIdx.x >= kWarpgroup * NWG) {  // the producer warp: K, V; Q, dO, stats per q tile
    if (threadIdx.x == kWarpgroup * NWG)
      bwd_producer<NWG, true, KD>(smem, own_full, full, empty, &tk, &tv, &tq, &tdo,
                                  stats + (size_t)bh * n_tiles * 128, h, b, k0, n_tiles);
    return;
  }

  // consumer warpgroup w: keys k0 + 64 w .. k0 + 64 w + 63, as rows; the
  // columns of S^T, dP^T are the q tile's queries 8 (i / 4) + 2 t + i % 2
  const int w = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const unsigned char* Kw = smem + Smem::own0 + w * kT;
  const unsigned char* Vw = smem + Smem::own1 + w * kT;
  const float c = scale * kLog2e;
  // p: S^T then P^T; ds: dP^T then dS^T (kDK only)
  float dk_acc[kA][32], dv_acc[kA][32], p[32], ds[32];
  uint32_t pa[4][4], hi[4][4], lo[4][4];  // P^T, dS^T as A operands (lo: SPLIT only)
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[a][i] = dv_acc[a][i] = 0.f;
  mbar_wait(own_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kBwdStages;
    const float* st = stat(s);
    auto lse2 = [&](int i) { return st[8 * (i / 4) + 2 * t + i % 2]; };
    mbar_wait(&full[s], (j / kBwdStages) & 1);
    wgmma_fence();
    mma_ss<64, KD>(p, Kw, Qs(s));                   // S^T = K Q^T
    if constexpr (kDK) mma_ss<64, KD>(ds, Vw, dOs(s));  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(p);
    if constexpr (kDK) {
      reg_fence(ds);
      grads<SPLIT>(
          p, ds, c, lse2, [&](int i) { return st[64 + 8 * (i / 4) + 2 * t + i % 2]; },
          kDV ? &pa : nullptr, hi, lo);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = exp2_fast(fmaf(p[i], c, -lse2(i)));
      to_a<64>(p, pa);
    }
    wgmma_fence();
    if constexpr (kDV)
#pragma unroll
      for (int a = 0; a < kA; ++a) mma_rs<64>(dv_acc[a], pa, atom(dOs(s), a, 64));  // dV += P^T dO
    if constexpr (kDK)
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        if constexpr (SPLIT) mma_rs<64>(dk_acc[a], lo, atom(Qs(s), a, 64));
        mma_rs<64>(dk_acc[a], hi, atom(Qs(s), a, 64));  // dK += dS^T Q
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      if constexpr (kDV) reg_fence(dv_acc[a]);
      if constexpr (kDK) reg_fence(dk_acc[a]);
    }
    mbar_arrive(&empty[s]);  // this stage is free for the load kBwdStages tiles on
  }
  const int row0 = k0 + 64 * w + 16 * warp;
  const float one[2] = {1.f, 1.f}, s2[2] = {scale, scale};
#pragma unroll
  for (int a = 0; a < kA; ++a) {
    if constexpr (kDK) store_rows<KD>(dk, dk_acc[a], b, h, H, L, W, a, row0, lane, s2);
    if constexpr (kDV) store_rows<KD>(dv, dv_acc[a], b, h, H, L, W, a, row0, lane, one);
  }
}

// (c) dQ of 64 NWG query rows; SPLIT carries dS as bf16 hi + lo.
template <int NWG, bool SPLIT, int KD>
__global__ void __launch_bounds__(kBlockThreads<NWG>, 1)
    attention_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq, int H,
                          int L, int W, float scale) {
  using Smem = BwdSmem<NWG, false, KD>;
  constexpr int kT = Smem::kT, kA = KD / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t *own_full, *full, *empty;
  bwd_barriers<NWG, false, KD>(smem, own_full, full, empty);
  auto Ks = [&](int s) { return smem + Smem::in0 + s * kT; };
  auto Vs = [&](int s) { return smem + Smem::in1 + s * kT; };
  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * 64 * NWG;
  const int n_tiles = (L + 63) / 64;

  if (threadIdx.x >= kWarpgroup * NWG) {  // the producer warp: Q, dO; K, V per tile
    if (threadIdx.x == kWarpgroup * NWG)
      bwd_producer<NWG, false, KD>(smem, own_full, full, empty, &tq, &tdo, &tk, &tv, nullptr, h,
                                   b, q0, n_tiles);
    return;
  }

  // consumer warpgroup w: query rows q0 + 64 w .. q0 + 64 w + 63
  const int w = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  const int warp = tid / 32, lane = tid % 32;
  const unsigned char* Qw = smem + Smem::own0 + w * kT;
  const unsigned char* dOw = smem + Smem::own1 + w * kT;
  // this thread's rows 16 warp + g and + 8 of the warpgroup's 64-row tile
  // (a tile past L, the second of a block at L <= 64, has no stats: P = 0)
  const int tile = q0 / 64 + w;
  float lse2[2] = {INFINITY, INFINITY}, D[2] = {0.f, 0.f};
  if (tile < n_tiles) {
    const float* st = stats + ((size_t)bh * n_tiles + tile) * 128 + 16 * warp + lane / 4;
    lse2[0] = st[0];
    lse2[1] = st[8];
    D[0] = st[64];
    D[1] = st[72];
  }
  const float c = scale * kLog2e;
  float dq_acc[kA][32], p[32], ds[32];  // p: S then P; ds: dP then dS
  uint32_t hi[4][4], lo[4][4];  // dS as the A operand (lo: SPLIT only)
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[a][i] = 0.f;
  auto tile_grads = [&](uint32_t(&hi_)[4][4], uint32_t(&lo_)[4][4]) {
    grads<SPLIT>(
        p, ds, c, [&](int i) { return lse2[(i / 2) % 2]; }, [&](int i) { return D[(i / 2) % 2]; },
        nullptr, hi_, lo_);
  };
  mbar_wait(own_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kBwdStages;
    mbar_wait(&full[s], (j / kBwdStages) & 1);
    wgmma_fence();
    mma_ss<64, KD>(p, Qw, Ks(s));   // S = Q K^T
    mma_ss<64, KD>(ds, dOw, Vs(s));  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(p);
    reg_fence(ds);
    tile_grads(hi, lo);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      if constexpr (SPLIT) mma_rs<64>(dq_acc[a], lo, atom(Ks(s), a, 64));
      mma_rs<64>(dq_acc[a], hi, atom(Ks(s), a, 64));  // dQ += dS K, the raw K
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < kA; ++a) reg_fence(dq_acc[a]);
    mbar_arrive(&empty[s]);  // this stage is free for the load kBwdStages tiles on
  }
  const float s2[2] = {scale, scale};
#pragma unroll
  for (int a = 0; a < kA; ++a)
    store_rows<KD>(dq, dq_acc[a], b, h, H, L, W, a, q0 + 64 * w + 16 * warp, lane, s2);
}

template <int NWG, bool SPLIT, int KD> struct Bwd {
  static constexpr int threads = kBlockThreads<NWG>;
  static constexpr int dkdv_smem = BwdSmem<NWG, true, KD>::bytes;
  static constexpr int dq_smem = BwdSmem<NWG, false, KD>::bytes;

  static cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                            const CUtensorMap& tdo, const void* o, const void* dout,
                            const float* lse, float* stats, void* dq, void* dk, void* dv, int B,
                            int H, int L, int W, tiles::Strides so, tiles::Strides sdo,
                            float scale, cudaStream_t stream) {
    const int n_tiles = (L + 63) / 64;
    attention_bwd_prep_sm90<KD><<<dim3(n_tiles, B * H), kPrepThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse,
        stats, H, L, W, so, sdo);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid((L + 64 * NWG - 1) / (64 * NWG), B * H);
    auto dkdv = [&](auto kernel) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
      if (e != cudaSuccess) return e;
      kernel<<<grid, threads, dkdv_smem, stream>>>(tq, tk, tv, tdo, stats,
                                                   static_cast<__nv_bfloat16*>(dk),
                                                   static_cast<__nv_bfloat16*>(dv), H, L, W,
                                                   scale);
      return cudaGetLastError();
    };
    if constexpr (KD == 64) {
      err = dkdv(attention_bwd_dkdv_sm90<NWG, SPLIT, KD, kPassBoth>);
    } else {  // the dV pass forms no dS: one kernel serves both SPLITs
      err = dkdv(attention_bwd_dkdv_sm90<NWG, false, KD, kPassDV>);
      if (err == cudaSuccess) err = dkdv(attention_bwd_dkdv_sm90<NWG, SPLIT, KD, kPassDK>);
    }
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_bwd_dq_sm90<NWG, SPLIT, KD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
    if (err != cudaSuccess) return err;
    attention_bwd_dq_sm90<NWG, SPLIT, KD><<<grid, threads, dq_smem, stream>>>(
        tq, tk, tv, tdo, stats, static_cast<__nv_bfloat16*>(dq), H, L, W, scale);
    return cudaGetLastError();
  }

  // kernel 0: (b) (at KD = 128 its dV pass), 1: (c), 2: (b)'s dK pass (KD = 128)
  static cudaError_t query(int kernel, int* out) {
    if (kernel == 1)
      return hopper::query(attention_bwd_dq_sm90<NWG, SPLIT, KD>, threads, dq_smem, out);
    if constexpr (KD == 64) {
      if (kernel == 0)
        return hopper::query(attention_bwd_dkdv_sm90<NWG, SPLIT, KD, kPassBoth>, threads,
                             dkdv_smem, out);
    } else {
      if (kernel == 0)
        return hopper::query(attention_bwd_dkdv_sm90<NWG, false, KD, kPassDV>, threads,
                             dkdv_smem, out);
      if (kernel == 2)
        return hopper::query(attention_bwd_dkdv_sm90<NWG, SPLIT, KD, kPassDK>, threads,
                             dkdv_smem, out);
    }
    return cudaErrorInvalidValue;
  }
};

// Op<NWG, SPLIT, KD> of a plan: block_rows = 64 NWG rows per block (128
// only with dS split at KD = 64: fast mode's plan is 64 rows, and KD = 128
// takes 64-row blocks only).
template <template <int, bool, int> class Op, typename F>
cudaError_t with_plan(int block_rows, bool split, int kd, F&& f) {
  if (kd == 128) {
    if (block_rows != 64) return cudaErrorInvalidValue;
    return split ? f(Op<1, true, 128>()) : f(Op<1, false, 128>());
  }
  if (kd != 64) return cudaErrorInvalidValue;
  if (block_rows == 128 && split) return f(Op<2, true, 64>());
  if (block_rows == 64) return split ? f(Op<1, true, 64>()) : f(Op<1, false, 64>());
  return cudaErrorInvalidValue;
}

}  // namespace sm90

}  // namespace
}  // namespace probunet

// q, k, v, o (the forward output), dout: (B, L, H, head_dim) of one dtype,
// element strides (*_sb, *_sl, *_sh), unit-stride head dim, 16-byte-aligned
// rows; head_dim 64, or a multiple of 8 in 72..128 (the head dim c, or the
// zero-padded width that ops/attention.py::kernel_width gives c). lse:
// (B*H, L) fp32 from the forward kernel. scratch: fp32, (B*H, L) for fp32
// inputs (D), (B*H, ceil(L / 64), 2, 64) for bf16 (lse in base 2 and D per
// 64-row tile). dq, dk, dv: (B, L, H, head_dim) contiguous, q's dtype.
// scale is 1/sqrt(c). fast rounds dS to bf16 (bf16 only; fp32 ignores it).
// block_rows is the bf16 kernels' plan (ops/attention.py::plan; 64 or
// 128). Returns a cudaError_t code; 0 on success.
extern "C" int probunet_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    void* scratch, void* dq, void* dk, void* dv, int B, int H, int L, int head_dim,
    long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl,
    long long k_sh, long long v_sb, long long v_sl, long long v_sh, long long o_sb,
    long long o_sl, long long o_sh, long long do_sb, long long do_sl, long long do_sh,
    float scale, int is_bf16, int fast, int block_rows, void* stream) {
  using probunet::tiles::Strides;
  const int W = head_dim;
  if (W != 64 && (W <= 64 || W > 128 || W % 8)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(scratch);
  const Strides so{o_sb, o_sl, o_sh}, sdo{do_sb, do_sl, do_sh};
  if (!is_bf16) {
    const Strides sq{q_sb, q_sl, q_sh}, sk{k_sb, k_sl, k_sh}, sv{v_sb, v_sl, v_sh};
    if (W == 64)
      return probunet::fp32::launch<float, 64>(q, k, v, o, dout, l, d, dq, dk, dv, B, H, L, W,
                                               sq, sk, sv, so, sdo, scale, st);
    return probunet::fp32::launch<float, 128>(q, k, v, o, dout, l, d, dq, dk, dv, B, H, L, W, sq,
                                              sk, sv, so, sdo, scale, st);
  }
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = probunet::hopper::make_map(&tq, q, B, H, L, W, q_sb, q_sl, q_sh);
  if (err == cudaSuccess) err = probunet::hopper::make_map(&tk, k, B, H, L, W, k_sb, k_sl, k_sh);
  if (err == cudaSuccess) err = probunet::hopper::make_map(&tv, v, B, H, L, W, v_sb, v_sl, v_sh);
  if (err == cudaSuccess)
    err = probunet::hopper::make_map(&tdo, dout, B, H, L, W, do_sb, do_sl, do_sh);
  if (err != cudaSuccess) return err;
  return probunet::sm90::with_plan<probunet::sm90::Bwd>(
      block_rows, !fast, W == 64 ? 64 : 128, [&](auto plan) {
        return plan.launch(tq, tk, tv, tdo, o, dout, l, d, dq, dk, dv, B, H, L, W, so, sdo, scale,
                           st);
      });
}

// What a bf16 backward kernel of a plan at head width kd (64 or 128) is on
// this card (kernel 0: dK/dV, at kd 128 its dV pass; 1: dQ; 2: at kd 128
// the dK pass; split: strict mode's hi + lo dS): out = {threads, dynamic
// shared bytes, registers, local (spilled) bytes per thread, static shared
// bytes}. Returns a cudaError_t code; 0 on success.
extern "C" int probunet_attention_bwd_query(int kernel, int block_rows, int split, int kd,
                                            int* out) {
  return probunet::sm90::with_plan<probunet::sm90::Bwd>(
      block_rows, split != 0, kd, [&](auto plan) { return plan.query(kernel, out); });
}
