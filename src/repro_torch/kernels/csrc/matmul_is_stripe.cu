// B5b: input-stationary GEMM with a resident output stripe.
//
// Replaces the TPU kernel repro/kernels/matmul_df.py `_is_stripe_kernel`
// (built by `_build_is` for an IS anchor with an OS STRIPE/WHOLE aux): grid
// (gm, gk, gn), so each (bm, bk) input block is fetched once and the (bm, N)
// output stripe stays resident across the whole reduction and is written
// once. With b_whole (WS WHOLE aux) all of B is resident too.
//
// CTA i owns the output row stripe i: its f32 partial sums, (rows, N) with
// rows = min(64, M), live in shared memory. The CTA walks k steps outer and
// column tiles j inner: each 64x32 A tile is loaded once, the 32x64 B tiles
// stream past it (or are read from the resident B), and the thread that owns
// a 4x4 block of the stripe reads it, adds one fmaf per k of the step and
// writes it back. After the last k step the epilogue runs on the stripe and
// each element is written once. What does not fit in a block's 227 KB (N
// above ~800 columns at 64 rows) is refused (the Python planner says so
// first, naming the bytes), never run as another dataflow.
//
// Arithmetic: the loads, per-element k order, k step (bf16 on the tensor
// cores, f32 and int8 on the CUDA cores) and epilogue of B1
// (gemm_common.cuh); the partial sums pass through shared memory in f32,
// which is exact, so every output element equals B1's bit for bit. The
// reference accumulates a float stripe in the output dtype; this kernel
// always accumulates in f32 (ROADMAP C). int8 and packed int4/int5 weights
// keep an int32 stripe, with B1's sidecar at the flush; a resident packed B
// stays packed and is decoded at each use.
//
// bf16 operands over 2 to 32 column tiles take the cluster kernel of
// gemm_cluster.cuh instead (reported to the caller as the tile
// "matmul_is_stripe_cluster"): a cluster of C CTAs per row stripe, CTA r
// owning column tiles r, r + C, ... with its part of the stripe in
// registers across the reduction, each input chunk fetched once per cluster
// and multicast into every CTA by the TMA (or exchanged over distributed
// shared memory), each CTA streaming its own B tiles (with b_whole too: a
// CTA holds only its own columns). f32, int8 and packed operands, a single
// column tile, and more column tiles than 16 CTAs can hold in registers
// (feasible only below 64 rows) keep the kernel below.
//
// Bound on H100: as B1. The one-CTA kernel gives gm CTAs, and every k step
// re-reads and re-writes the stripe in shared memory.
#include "gemm_cluster.cuh"

namespace is_stripe {

using namespace gemm;

template <typename T, bool VEC, class B, bool B_WHOLE_RES>
__global__ void __launch_bounds__(THREADS)
is_stripe_kernel(const T* __restrict__ a, B b, void* __restrict__ c, int m,
                 int n, int k, Epi e) {
  using Acc = typename B::Acc;
  constexpr bool TC = kTC<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ra = min(BM, round_up(m, TM)), gn = cdiv(n, BN), np = gn * BN;
  const int gk = cdiv(k, BK), kp = gk * BK;
  Acc* as = reinterpret_cast<Acc*>(smem);
  Acc* bs = as + TILE_FLOATS;  // unused with B whole
  Acc* st = bs + (B_WHOLE_RES ? 0 : TILE_FLOATS);  // the stripe, (ra, np)
  void* bw = st + (size_t)ra * np;                 // B whole, (kp, np)
  const int row0 = blockIdx.x * BM, steps = gk * gn;
  const int r_own = ty() * TM, c_own = tx() * TN;
  const bool own = r_own < ra;  // ra is a multiple of TM
  // bf16 tiles stay bf16 for the tensor cores (gemm_common.cuh).
  typename std::conditional<TC, HTile<VEC, BM, BK, TA_LD>, ATile<T, VEC>>::type at;
  typename std::conditional<TC, HTile<VEC, BK, BN, TB_LD>, typename B::Tile>::type bt;

  if (B_WHOLE_RES) b.load_panel(bw, k, n, kp, 0, np);
  // Step s is (k step s / gn, column tile s % gn); a new A tile at column 0.
  auto fetch = [&](int s) {
    const int kb = s / gn, j = s % gn;
    if constexpr (TC) {
      if (j == 0) at.fetch(a, k, m, k, row0, kb * BK);
      if (!B_WHOLE_RES) bt.fetch(b.p, n, k, n, kb * BK, j * BN);
    } else {
      if (j == 0) at.fetch(a, m, k, row0, kb * BK);
      if (!B_WHOLE_RES) bt.fetch(b, k, n, kb * BK, j * BN);
    }
  };
  auto stash = [&](int s) {
    if (s % gn == 0) at.stash(as);
    if (!B_WHOLE_RES) bt.stash(bs);
  };

  fetch(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (more) fetch(s + 1);
    const int kb = s / gn, tile_col = (s % gn) * BN, col = tile_col + c_own;
    if constexpr (TC) {
      if (wrow() < ra) {  // warp-uniform: the mma takes the warp
        float acc[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int r = own_row<TC>(i, j);
            acc[i][j] = kb == 0 || r >= ra
                            ? 0.f
                            : st[(size_t)r * np + tile_col + own_col<TC>(i, j)];
          }
        const uint16_t* bh = static_cast<const uint16_t*>(bw);
        mma_step_tc(acc, streamed_afrag(as), [&](int kc, int c0, uint32_t* f) {
          if constexpr (B_WHOLE_RES)
            tc::frag_b_gather(
                f,
                [&](int kk, int cc) -> uint16_t {
                  return bh[(size_t)(kb * BK + kk) * np + tile_col + cc];
                },
                kc, c0);
          else
            tc::frag_b_rowmajor(f, reinterpret_cast<const __nv_bfloat16*>(bs),
                                TB_LD, kc, c0);
        });
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int r = own_row<TC>(i, j);
            if (r < ra) st[(size_t)r * np + tile_col + own_col<TC>(i, j)] = acc[i][j];
          }
      }
    } else if (own) {
      Acc acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = kb == 0 ? Acc(0) : st[(size_t)(r_own + i) * np + col + j];
      mma_step(acc, [&](int kk, int i) { return as[kk * TILE_LD + r_own + i]; },
               [&](int kk, int j) -> Acc {
                 if (B_WHOLE_RES) return B::at(bw, kb * BK + kk, col + j, np, kp);
                 return bs[kk * TILE_LD + c_own + j];
               });
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) st[(size_t)(r_own + i) * np + col + j] = acc[i][j];
    }
    __syncthreads();
    if (more) {
      stash(s + 1);
      __syncthreads();
    }
  }

  // The flush: each thread's own stripe elements, epilogue, one write.
  for (int j0 = 0; j0 < gn; ++j0) {
    Acc acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = own_row<TC>(i, j);
        acc[i][j] = r < ra ? st[(size_t)r * np + j0 * BN + own_col<TC>(i, j)] : Acc(0);
      }
    store_tile<TC>(c, acc, row0, j0 * BN, m, n, e);
  }
}

// bf16 over 2 to 32 column tiles: the cluster kernel of gemm_cluster.cuh,
// reported as TILE_CLUSTER (B whole or not: each CTA streams its own
// columns).
template <typename T>
int launch_cluster(const void* a, const void* b, void* c, int m, int n, int k,
                   const Epi& e, cudaStream_t s, Took* took) {
  static_assert(kTC<T>, "the cluster kernel takes bf16 operands");
  const int gm = cdiv(m, BM), gn = cdiv(n, BN), C = cl::is_stripe_cluster(m, n);
  if (C > cl::MAX_CLUSTER || cdiv(gn, C) > cl::STRIPE_TILES) return REPRO_BAD_ARGUMENT;
  const size_t smem = cl::stripe_smem(gn, C);
  if (took) *took = {TILE_CLUSTER, (int)smem, gm * C, C};
  const auto* ah = static_cast<const T*>(a);
  const auto* bh = static_cast<const T*>(b);
  CUtensorMap ma{}, mb{};
  if (vec_ok<T>(a, b, n, k)) {
    // A in 8-row pieces of a chunk's 64 k, B in a chunk's 64 k rows of a tile
    int rc = cl::make_map(&ma, a, m, k, k, 8, cl::STRIPE_KC * BK, CU_TENSOR_MAP_SWIZZLE_128B);
    if (!rc)
      rc = cl::make_map(&mb, b, k, n, n, cl::STRIPE_KC * BK, BN, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
    return cl::launch_in_clusters(cl::is_stripe_cluster_kernel<true>, gm * C,
                                  cl::TMA_THREADS, C, smem, s, ah, bh, c, m, n, k, e,
                                  ma, mb);
  }
  return cl::launch_in_clusters(cl::is_stripe_cluster_kernel<false>, gm * C, THREADS,
                                C, smem, s, ah, bh, c, m, n, k, e, ma, mb);
}

template <typename T, int WB>
int launch(int b_whole, const void* a, const void* b, const void* b_hi, void* c,
           int m, int n, int k, const Epi& e, cudaStream_t s, Took* took) {
  if constexpr (kTC<T>) {
    if (cl::is_stripe_on_cluster(n)) return launch_cluster<T>(a, b, c, m, n, k, e, s, took);
  }
  const int ra = min(BM, round_up(m, TM)), np = round_up(n, BN);
  const int kp = round_up(k, BK);
  const dim3 grid(cdiv(m, BM));
  return with_b<T, WB>(b, b_hi, vec_ok<T>(a, b, n, k), [&](auto bop, auto vec) {
    using B = decltype(bop);
    constexpr bool V = decltype(vec)::value;
    const size_t smem = TILE_FLOATS * 4 * (b_whole ? 1 : 2) + (size_t)ra * np * 4 +
                        (b_whole ? B::panel_bytes(kp, np) : 0);
    if (b_whole)
      return launch_with_smem<T>(is_stripe_kernel<T, V, B, true>, grid, smem, s,
                                 a, bop, c, m, n, k, e);
    return launch_with_smem<T>(is_stripe_kernel<T, V, B, false>, grid, smem, s,
                               a, bop, c, m, n, k, e);
  });
}

#define IS_SIGNATURE(T, WB)                                                  \
  int launch<T, WB>(int, const void*, const void*, const void*, void*, int, \
                    int, int, const Epi&, cudaStream_t, Took*)

// One translation unit per input kind (-DREPRO_PART=0..4, kernels/_build.py).
#if defined(REPRO_PART)
#if REPRO_PART == 0
template IS_SIGNATURE(float, 0);
#elif REPRO_PART == 1
template IS_SIGNATURE(__nv_bfloat16, 0);
#elif REPRO_PART == 2
template IS_SIGNATURE(int8_t, 0);
#elif REPRO_PART == 3
template IS_SIGNATURE(int8_t, 4);
#else
template IS_SIGNATURE(int8_t, 5);
#endif
#else
extern template IS_SIGNATURE(float, 0);
extern template IS_SIGNATURE(__nv_bfloat16, 0);
extern template IS_SIGNATURE(int8_t, 0);
extern template IS_SIGNATURE(int8_t, 4);
extern template IS_SIGNATURE(int8_t, 5);
#endif

}  // namespace is_stripe

#if !defined(REPRO_PART)
// Operands as matmul_os. b_whole: 0 streams B, 1 holds all of B in shared
// memory. took (may be null): the cluster kernel's report (gemm::Took), or
// TILE_WALK for the one-CTA kernel.
extern "C" int matmul_is_stripe(const void* a, const void* b, void* c, int m,
                                int n, int k, int in_dtype, int out_dtype,
                                const float* scale, int scale_mode,
                                const float* bias, int act,
                                const float* residual, int weight_bits,
                                const void* b_hi, const int* sidx,
                                const int* sdelta, int sr, int b_whole,
                                gemm::Took* took, void* stream) {
  if (took) *took = gemm::Took{};
  if (gemm::bad_args(m, n, k, in_dtype, out_dtype, scale_mode, scale, bias,
                     act, residual, weight_bits, b_hi, sidx, sdelta, sr))
    return REPRO_BAD_ARGUMENT;
  const gemm::Epi e = GEMM_EPI(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using is_stripe::launch;
  GEMM_DISPATCH_DTYPES(launch, b_whole, a, b, b_hi, c, m, n, k, e, s, took);
}
#endif
