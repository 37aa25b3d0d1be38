// B1's bf16 basic OS launch on Hopper's tensor cores: the tile that serving's
// prefill takes (M > 16) and the one its decode takes (M <= 16).
//
// Both keep the k chain of every other GEMM kernel of the port
// (gemm_common.cuh): each output element is one f32 accumulator that starts
// at 0 and adds one mma.sync m16n8k16 per 16-deep k chunk in ascending k
// (mma_bf16_add), over round_up(K, 32) (zeros past K), then B1's epilogue.
// So their outputs equal the 64 x 64 walk kernels' (every anchor and
// residency) bit for bit.
// No split-k, in a CTA or across CTAs: that would change the bits, and a
// row's result would depend on how the work was cut.
//
// Prefill tile (tc_prefill_kernel): a CTA owns a 128 x 64 output tile (128
// CTAs at M = 512, N = 2048: about one wave on 132 SMs), its 8 warps each a
// 32 x 32 block (2 x 4 mma tiles, 32 f32 accumulators a thread). A and B
// stream through a 4-stage cp.async ring of 32-deep k steps in dynamic shared
// memory, rows padded by 16 bytes so the ldmatrix fragment loads hit distinct
// banks. Bound at M = 512: the tensor cores' operations (12.9 GFLOP).
//
// Decode tile (tc_decode_kernel): M <= 16 rows are one m16 block; a CTA owns
// 16 columns (128 CTAs at N = 2048, 384 at N = 6144), each of its 2 warps 8
// of them, and runs their k chain alone. The weight stream bounds it (25 MB
// at K = 6144, N = 2048: 7.5 us at 3.35 TB/s), so B streams through an
// 8-stage ring of 256-deep k steps (57 KB of weights in flight per CTA) and
// only A's real rows are copied; its padding rows stay zero. Each step's
// chunk products are independent (summed from zero) and in flight together.
//
// The two shapes come from a sweep on an H100 (bench/tile_sweep.cu,
// PERF.md): 128 x 64 x 32 (4 stages) against 128 x 64 x 64, 128 x 128,
// 64 x 64 and 64 x 128; 16 columns x 256 (8 stages) against 8 and 32
// columns, 64- to 256-deep steps and 8 to 16 stages. No variant was faster
// at both of qwen3-1.7b's MLP shapes, and every variant gave the same bits.
//
// Operands that are not whole 16-byte vectors (K or N not a multiple of 8, or
// an unaligned pointer) take element loads into the same rings, without the
// asynchronous copy.
#pragma once

#include "gemm_common.cuh"

namespace gemm {

// The rows of a k stage a tile kernel copies: `rows` x `cols` bf16 from
// (r0, c0) of a row-major (nrows, ncols) source with ld columns into a
// row-major tile of stride LD; zeros outside the source. NT threads.
template <bool VEC, int NT, int LD>
__device__ __forceinline__ void copy_stage(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int ld,
                                           int nrows, int ncols, int r0,
                                           int c0, int rows, int cols) {
  if constexpr (VEC) {
    const int vpr = cols / 8;
    for (int i = threadIdx.x; i < rows * vpr; i += NT) {
      const int r = i / vpr, c = (i % vpr) * 8;
      const bool in = r0 + r < nrows && c0 + c < ncols;
      tc::cp_async16(dst + r * LD + c,
                     in ? src + (size_t)(r0 + r) * ld + c0 + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += NT) {
      const int r = i / cols, c = i % cols;
      const bool in = r0 + r < nrows && c0 + c < ncols;
      dst[r * LD + c] = in ? src[(size_t)(r0 + r) * ld + c0 + c]
                           : tzero<__nv_bfloat16>();
    }
  }
}

// A prefill tile: TBM x TBN outputs per CTA, WM x WN warps (each MI x NI
// mma tiles of 16 x 8), TBK-deep k steps through a STAGES-deep ring.
template <int TBM_, int TBN_, int TBK_, int STAGES_, int WM_, int WN_>
struct PrefillCfg {
  static constexpr int TBM = TBM_, TBN = TBN_, TBK = TBK_, STAGES = STAGES_;
  static constexpr int WM = WM_, WN = WN_, NT = WM * WN * 32;
  static constexpr int MI = TBM / WM / 16, NI = TBN / WN / 8;
  static constexpr int ALD = TBK + 8, BLD = TBN + 8;  // 16 bytes of padding
  static constexpr int A_ELEMS = TBM * ALD, B_ELEMS = TBK * BLD;
  static constexpr size_t SMEM = (size_t)STAGES * (A_ELEMS + B_ELEMS) * 2;
  static_assert(TBK % BK == 0 || BK % TBK == 0, "k steps tile the k padding");
  static_assert(NI % 2 == 0, "B fragments load two column tiles at once");
};

template <class C, bool VEC>
__global__ void __launch_bounds__(C::NT)
tc_prefill_kernel(const __nv_bfloat16* __restrict__ a,
                  const __nv_bfloat16* __restrict__ b, void* __restrict__ c,
                  int m, int n, int k, Epi e) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = as + C::STAGES * C::A_ELEMS;
  const int row0 = blockIdx.y * C::TBM, col0 = blockIdx.x * C::TBN;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp / C::WN) * (C::TBM / C::WM), wc = (warp % C::WN) * (C::TBN / C::WN);
  const int kp = round_up(k, BK), steps = cdiv(kp, C::TBK);
  float acc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  auto load = [&](int s) {
    const int slot = s % C::STAGES, k0 = s * C::TBK;
    copy_stage<VEC, C::NT, C::ALD>(as + slot * C::A_ELEMS, a, k, m, k, row0, k0,
                                   C::TBM, C::TBK);
    copy_stage<VEC, C::NT, C::BLD>(bs + slot * C::B_ELEMS, b, n, k, n, k0, col0,
                                   C::TBK, C::TBN);
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps) load(s);
    tc::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<C::STAGES - 2>();  // step s has landed
    __syncthreads();                     // and step s - 1's slot is consumed
    if (s + C::STAGES - 1 < steps) load(s + C::STAGES - 1);
    tc::cp_async_commit();
    const __nv_bfloat16* at = as + (s % C::STAGES) * C::A_ELEMS;
    const __nv_bfloat16* bt = bs + (s % C::STAGES) * C::B_ELEMS;
    // Chunks past kp (a last step deeper than the k padding) are skipped,
    // so every element adds exactly kp / 16 chunks, as in the walks.
    const int chunks = min(C::TBK, kp - s * C::TBK) / 16;
#pragma unroll
    for (int q = 0; q < C::TBK / 16; ++q) {
      if (q >= chunks) break;
      uint32_t af[C::MI][4], bf[C::NI][2];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
        tc::frag_a_rowmajor(af[mi], at, C::ALD, wr + mi * 16, q * 16);
#pragma unroll
      for (int ni = 0; ni < C::NI; ni += 2)
        tc::frag_b2_rowmajor(bf[ni], bf[ni + 1], bt, C::BLD, q * 16, wc + ni * 8);
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni)
          tc::mma_bf16_add(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  tc::cp_async_wait<0>();

  const int g = tc::lane() >> 2, t = tc::lane() & 3;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = row0 + wr + mi * 16 + g + (j >> 1) * 8;
        const int cc = col0 + wc + ni * 8 + 2 * t + (j & 1);
        if (r < m && cc < n) store_one(c, acc[mi][ni][j], r, cc, n, e);
      }
}

// A decode tile: the M <= 16 rows by TBN columns per CTA, one warp per 8
// columns, TBK-deep k steps through a STAGES-deep ring.
template <int TBN_, int TBK_, int STAGES_>
struct DecodeCfg {
  static constexpr int MAX_M = 16, TBN = TBN_, TBK = TBK_, STAGES = STAGES_;
  static constexpr int NT = TBN / 8 * 32;
  static constexpr int ALD = TBK + 8, BLD = TBN + 8;  // 16 bytes of padding
  static constexpr int A_ELEMS = MAX_M * ALD, B_ELEMS = TBK * BLD;
  static constexpr size_t SMEM = (size_t)STAGES * (A_ELEMS + B_ELEMS) * 2;
  static_assert(TBK % BK == 0, "k steps tile the k padding");
};

template <class C, bool VEC>
__global__ void __launch_bounds__(C::NT)
tc_decode_kernel(const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b, void* __restrict__ c,
                 int m, int n, int k, Epi e) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = as + C::STAGES * C::A_ELEMS;
  const int col0 = blockIdx.x * C::TBN, wc = (threadIdx.x >> 5) * 8;
  const int kp = round_up(k, BK), steps = cdiv(kp, C::TBK);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  // A's rows past m stay zero in every slot: only rows < m are copied.
  for (int i = threadIdx.x; i < C::STAGES * C::A_ELEMS / 8; i += C::NT)
    reinterpret_cast<uint4*>(as)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  auto load = [&](int s) {
    const int slot = s % C::STAGES, k0 = s * C::TBK;
    copy_stage<VEC, C::NT, C::ALD>(as + slot * C::A_ELEMS, a, k, m, k, 0, k0, m,
                                   C::TBK);
    copy_stage<VEC, C::NT, C::BLD>(bs + slot * C::B_ELEMS, b, n, k, n, k0, col0,
                                   C::TBK, C::TBN);
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps) load(s);
    tc::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    if (s + C::STAGES - 1 < steps) load(s + C::STAGES - 1);
    tc::cp_async_commit();
    const __nv_bfloat16* at = as + (s % C::STAGES) * C::A_ELEMS;
    const __nv_bfloat16* bt = bs + (s % C::STAGES) * C::B_ELEMS;
    // The step's chunks are independent products from zero (mma_bf16_add's
    // first half), all in flight at once; they are then added in k order.
    // The last step may reach past kp (TBK > BK): those chunks (zeros) are
    // not added, so every element adds exactly kp / 16 chunks, as in the
    // walks.
    const int chunks = min(C::TBK, kp - s * C::TBK) / 16;
    float part[C::TBK / 16][4];
#pragma unroll
    for (int q = 0; q < C::TBK / 16; ++q) {
      uint32_t af[4], bf[2];
      tc::frag_a_rowmajor(af, at, C::ALD, 0, q * 16);
      tc::frag_b_rowmajor(bf, bt, C::BLD, q * 16, wc);
#pragma unroll
      for (int j = 0; j < 4; ++j) part[q][j] = 0.f;
      tc::mma_bf16(part[q], af, bf);
    }
#pragma unroll
    for (int q = 0; q < C::TBK / 16; ++q)
      if (q < chunks)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = __fadd_rn(acc[j], part[q][j]);
  }
  tc::cp_async_wait<0>();

  const int g = tc::lane() >> 2, t = tc::lane() & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = g + (j >> 1) * 8, cc = col0 + wc + 2 * t + (j & 1);
    if (r < m && cc < n) store_one(c, acc[j], r, cc, n, e);
  }
}

// The tiles the bf16 basic OS launch takes (matmul_df.py's planner keeps a
// copy, PREFILL_TILE and DECODE_TILE with their stages, checked against
// each launch's Took).
using Prefill = PrefillCfg<128, 64, 32, 4, 4, 2>;
using Decode = DecodeCfg<16, 256, 8>;

// One tile kernel over `grid`, with C::SMEM bytes of dynamic shared memory
// (opting in above 48 KB).
template <class C, bool VEC>
int launch_cfg(void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*,
                              void*, int, int, int, Epi),
               dim3 grid, const __nv_bfloat16* a, const __nv_bfloat16* b,
               void* c, int m, int n, int k, const Epi& e,
               cudaStream_t stream) {
  if (C::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, C::NT, C::SMEM, stream>>>(a, b, c, m, n, k, e);
  return launch_status();
}

// Launches the prefill tile C (any M) or the decode tile C (M <= 16).
template <class C>
int launch_prefill(const __nv_bfloat16* a, const __nv_bfloat16* b, void* c,
                   int m, int n, int k, const Epi& e, cudaStream_t stream,
                   Took* took = nullptr) {
  if (cdiv(m, C::TBM) > 65535) return REPRO_BAD_ARGUMENT;
  const dim3 grid(cdiv(n, C::TBN), cdiv(m, C::TBM));
  if (took) *took = {TILE_PREFILL, (int)C::SMEM, (int)(grid.x * grid.y)};
  return vec_ok<__nv_bfloat16>(a, b, n, k)
             ? launch_cfg<C, true>(tc_prefill_kernel<C, true>, grid, a, b, c, m, n, k, e, stream)
             : launch_cfg<C, false>(tc_prefill_kernel<C, false>, grid, a, b, c, m, n, k, e, stream);
}
template <class C>
int launch_decode(const __nv_bfloat16* a, const __nv_bfloat16* b, void* c,
                  int m, int n, int k, const Epi& e, cudaStream_t stream,
                  Took* took = nullptr) {
  if (m > C::MAX_M) return REPRO_BAD_ARGUMENT;
  const dim3 grid(cdiv(n, C::TBN));
  if (took) *took = {TILE_DECODE, (int)C::SMEM, (int)grid.x};
  return vec_ok<__nv_bfloat16>(a, b, n, k)
             ? launch_cfg<C, true>(tc_decode_kernel<C, true>, grid, a, b, c, m, n, k, e, stream)
             : launch_cfg<C, false>(tc_decode_kernel<C, false>, grid, a, b, c, m, n, k, e, stream);
}

// The bf16 basic OS launch: the decode tile for M <= 16, else the prefill
// tile; `took` names it.
inline int launch_tc(const void* a, const void* b, void* c, int m, int n,
                     int k, const Epi& e, cudaStream_t stream, Took* took) {
  const auto* ah = static_cast<const __nv_bfloat16*>(a);
  const auto* bh = static_cast<const __nv_bfloat16*>(b);
  if (m <= Decode::MAX_M) return launch_decode<Decode>(ah, bh, c, m, n, k, e, stream, took);
  return launch_prefill<Prefill>(ah, bh, c, m, n, k, e, stream, took);
}

}  // namespace gemm
