// B5a: weight-stationary GEMM with a resident output stripe.
//
// Replaces the TPU kernel repro/kernels/matmul_df.py `_ws_stripe_kernel`
// (built by `_build_ws` for a WS anchor with an OS STRIPE/WHOLE aux): grid
// (gn, gk, gm), so each (bk, bn) weight block is fetched once and the (M, bn)
// output stripe stays resident across the whole reduction and is written once.
//
// CTA j owns the output column stripe j: its f32 partial sums, (M, 64), live
// in shared memory. The CTA walks k steps outer and row tiles i inner: each
// 32x64 B tile is loaded once, each 64x32 A tile streams past it, and the
// thread that owns a 4x4 block of the stripe reads it, adds one fmaf per k of
// the step and writes it back. After the last k step the epilogue runs on the
// stripe and each element is written once. A stripe that does not fit in a
// block's 227 KB (M above ~860 rows) is refused (the Python planner says so
// first, naming the bytes), never run as another dataflow.
//
// Arithmetic: the loads, per-element k order, k step (bf16 on the tensor
// cores, f32 and int8 on the CUDA cores) and epilogue of B1
// (gemm_common.cuh); the partial sums pass through shared memory in f32,
// which is exact, so every output element equals B1's bit for bit. The
// reference accumulates a float stripe in the output dtype (bf16 for a bf16
// output); this kernel always accumulates in f32 (ROADMAP C). int8 and
// packed int4/int5 weights keep an int32 stripe (the reference's int32
// scratch under an integer epilogue), with B1's sidecar at the flush.
//
// bf16 operands over two row tiles or more take the cluster kernel of
// gemm_cluster.cuh instead (reported to the caller as the tile
// "matmul_ws_stripe_cluster"): a cluster of C CTAs per column stripe, CTA r
// owning row tiles r, r + C, ... with its part of the stripe in registers
// across the reduction, each weight chunk fetched once per cluster and
// multicast into every CTA by the TMA (or exchanged over distributed shared
// memory). f32 and int8 operands, and a single row tile, keep the kernel
// below.
//
// Bound on H100: as B1. The one-CTA kernel gives gn CTAs, and every k step
// re-reads and re-writes the stripe in shared memory.
#include "gemm_cluster.cuh"

namespace {

using namespace gemm;

__host__ __device__ constexpr size_t ws_stripe_smem(int m) {
  return 2 * TILE_FLOATS * 4 + (size_t)round_up(m, TM) * BN * 4;
}

template <typename T, bool VEC, class B>
__global__ void __launch_bounds__(THREADS)
ws_stripe_kernel(const T* __restrict__ a, B b, void* __restrict__ c, int m,
                 int n, int k, Epi e) {
  using Acc = typename B::Acc;
  constexpr bool TC = kTC<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* as = reinterpret_cast<Acc*>(smem);
  Acc* bs = as + TILE_FLOATS;
  Acc* st = bs + TILE_FLOATS;  // the stripe, (mr, BN) row-major
  const int mr = round_up(m, TM), gm = cdiv(m, BM), gk = cdiv(k, BK);
  const int col0 = blockIdx.x * BN, steps = gk * gm;
  const int r_own = ty() * TM, c_own = tx() * TN;
  // bf16 tiles stay bf16 for the tensor cores (gemm_common.cuh).
  typename std::conditional<TC, HTile<VEC, BM, BK, TA_LD>, ATile<T, VEC>>::type at;
  typename std::conditional<TC, HTile<VEC, BK, BN, TB_LD>, typename B::Tile>::type bt;

  // Step s is (k step s / gm, row tile s % gm); a new B tile at row tile 0.
  auto fetch = [&](int s) {
    const int kb = s / gm, i = s % gm;
    if constexpr (TC) {
      at.fetch(a, k, m, k, i * BM, kb * BK);
      if (i == 0) bt.fetch(b.p, n, k, n, kb * BK, col0);
    } else {
      at.fetch(a, m, k, i * BM, kb * BK);
      if (i == 0) bt.fetch(b, k, n, kb * BK, col0);
    }
  };
  auto stash = [&](int s) {
    at.stash(as);
    if (s % gm == 0) bt.stash(bs);
  };

  fetch(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (more) fetch(s + 1);
    const int kb = s / gm, tile_row = (s % gm) * BM;
    if constexpr (TC) {
      if (tile_row + wrow() < mr) {  // warp-uniform: the mma takes the warp
        float acc[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int r = tile_row + own_row<TC>(i, j);
            acc[i][j] = kb == 0 || r >= mr ? 0.f : st[r * BN + own_col<TC>(i, j)];
          }
        mma_step_tc(acc, streamed_afrag(as), streamed_bfrag(bs));
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int r = tile_row + own_row<TC>(i, j);
            if (r < mr) st[r * BN + own_col<TC>(i, j)] = acc[i][j];
          }
      }
    } else if (tile_row + r_own < mr) {  // mr is a multiple of TM
      const int row0 = tile_row + r_own;
      Acc acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = kb == 0 ? Acc(0) : st[(row0 + i) * BN + c_own + j];
      mma_step(acc, [&](int kk, int i) { return as[kk * TILE_LD + r_own + i]; },
               [&](int kk, int j) { return bs[kk * TILE_LD + c_own + j]; });
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) st[(row0 + i) * BN + c_own + j] = acc[i][j];
    }
    __syncthreads();
    if (more) {
      stash(s + 1);
      __syncthreads();
    }
  }

  // The flush: each thread's own stripe elements, epilogue, one write.
  for (int i0 = 0; i0 < gm; ++i0) {
    Acc acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = i0 * BM + own_row<TC>(i, j);
        acc[i][j] = r < mr ? st[r * BN + own_col<TC>(i, j)] : Acc(0);
      }
    store_tile<TC>(c, acc, i0 * BM, col0, m, n, e);
  }
}

// bf16 over two row tiles or more: the cluster kernel of gemm_cluster.cuh,
// reported as TILE_CLUSTER.
int launch_cluster(const void* a, const void* b, void* c, int m, int n, int k,
                   const Epi& e, cudaStream_t s, Took* took) {
  const int gn = cdiv(n, BN), C = cl::ws_stripe_cluster(m, n);
  if (C > 8 || cdiv(cdiv(m, BM), C) > cl::STRIPE_TILES) return REPRO_BAD_ARGUMENT;
  const size_t smem = cl::stripe_smem(cdiv(m, BM), C);
  if (took) *took = {TILE_CLUSTER, (int)smem, gn * C, C};
  const auto* ah = static_cast<const __nv_bfloat16*>(a);
  const auto* bh = static_cast<const __nv_bfloat16*>(b);
  CUtensorMap ma{}, mb{};
  if (vec_ok<__nv_bfloat16>(a, b, n, k)) {
    const int rc = cl::make_maps(&ma, &mb, a, b, m, n, k, cl::STRIPE_KC * BK / C, false);
    if (rc) return rc;
    return cl::launch_in_clusters(cl::ws_stripe_cluster_kernel<true>, gn * C,
                                  cl::TMA_THREADS, C, smem, s, ah, bh, c, m, n, k, e,
                                  ma, mb);
  }
  return cl::launch_in_clusters(cl::ws_stripe_cluster_kernel<false>, gn * C, THREADS,
                                C, smem, s, ah, bh, c, m, n, k, e, ma, mb);
}

template <typename T, int WB>
int launch(const void* a, const void* b, const void* b_hi, void* c, int m,
           int n, int k, const Epi& e, cudaStream_t s, Took* took) {
  if constexpr (kTC<T>) {
    if (cdiv(m, BM) >= 2) return launch_cluster(a, b, c, m, n, k, e, s, took);
  }
  const dim3 grid(cdiv(n, BN));
  const size_t smem = ws_stripe_smem(m);
  return with_b<T, WB>(b, b_hi, vec_ok<T>(a, b, n, k), [&](auto bop, auto vec) {
    return launch_with_smem<T>(
        ws_stripe_kernel<T, decltype(vec)::value, decltype(bop)>, grid, smem,
        s, a, bop, c, m, n, k, e);
  });
}

}  // namespace

// Operands as matmul_os. took (may be null): the cluster kernel's report
// (gemm::Took), or TILE_WALK for the one-CTA kernel.
extern "C" int matmul_ws_stripe(const void* a, const void* b, void* c, int m,
                                int n, int k, int in_dtype, int out_dtype,
                                const float* scale, int scale_mode,
                                const float* bias, int act,
                                const float* residual, int weight_bits,
                                const void* b_hi, const int* sidx,
                                const int* sdelta, int sr, gemm::Took* took,
                                void* stream) {
  if (took) *took = gemm::Took{};
  if (gemm::bad_args(m, n, k, in_dtype, out_dtype, scale_mode, scale, bias,
                     act, residual, weight_bits, b_hi, sidx, sdelta, sr))
    return REPRO_BAD_ARGUMENT;
  const gemm::Epi e = GEMM_EPI(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GEMM_DISPATCH_DTYPES(launch, a, b, b_hi, c, m, n, k, e, s, took);
}
