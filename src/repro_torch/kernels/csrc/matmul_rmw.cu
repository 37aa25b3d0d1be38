// B4: the basic weight-stationary (WS) and input-stationary (IS) GEMMs.
//
// Replaces the TPU kernel repro/kernels/matmul_df.py `_rmw_kernel` (built by
// `_build_rmw`): the paper's basic WS and IS dataflows, lowered as one
// dispatch with the reduction innermost and each output tile revisited in
// place, the epilogue applied at its last k step. The anchored operand stays
// resident while the other grid dimension is swept:
//   m_minor (WS, grid (gn, gm, gk)): CTA j holds B's column stripe (K, 64) in
//     shared memory, fetched once, and walks the row tiles i; with a_stripe
//     (IS STRIPE aux) it also holds A's row stripe (64, K), loaded per i.
//   IS (grid (gm, gn, gk)): CTA i holds A's row stripe (64, K), fetched once,
//     and walks the column tiles j, streaming B or, with b_res = whole (WS
//     WHOLE aux), holding all of B (K, N), loaded once per CTA. A WS STRIPE
//     aux cannot survive the m sweep and is streamed (the reference demotes it
//     the same way; the Python planner reports it).
// The output tile's accumulators stay in registers across its k loop, so the
// TPU's in-place revisits become one write after the epilogue.
//
// bf16 operands over a sweep of two tiles or more take the cluster walk of
// gemm_cluster.cuh: a cluster of C CTAs holds the anchored stripe, fetched
// once per cluster and multicast into every CTA by the TMA (or exchanged
// over distributed shared memory), and splits the sweep (reported to the
// caller as the tile "matmul_rmw_cluster").
//
// Arithmetic: the loads, k loop and epilogue of B1 (gemm_common.cuh), so for
// the same inputs every output element equals B1's bit for bit; int8 and
// packed int4/int5 weights take B1's integer k loop and sidecar.
//
// Bound on H100: as B1 (operations at prefill M, bytes at decode M). The
// one-CTA walk gives gn (WS) or gm (IS) CTAs where B1 has gm * gn, which is
// what it pays for fetching its anchored operand once; the cluster walk
// gives C times as many.
#include "gemm_cluster.cuh"

// The walks this library instantiates: two per float input type and walk
// order, all four per int8 kind (int8 B, packed 4-bit, packed 5-bit); each
// group is compiled in its own translation unit (-DREPRO_PART=0..6), and
// the bf16 cluster walks in one more (7).
#define RMW_WALKS_0(X, T, WB) \
  X(T, WB, WALK_M, false, B_STRIPE) X(T, WB, WALK_M, true, B_STRIPE)
#define RMW_WALKS_1(X, T, WB) \
  X(T, WB, WALK_N, true, B_STREAMED) X(T, WB, WALK_N, true, B_WHOLE)
#define RMW_ALL(X, T, WB) RMW_WALKS_0(X, T, WB) RMW_WALKS_1(X, T, WB)
#define RMW_CLUSTERS(X)                                              \
  X(WALK_M, false, B_STRIPE) X(WALK_M, true, B_STRIPE)               \
  X(WALK_N, true, B_STREAMED) X(WALK_N, true, B_WHOLE)

namespace gemm {
#if defined(REPRO_PART)
#if REPRO_PART == 0
RMW_WALKS_0(GEMM_WALK_DEFINE, float, 0)
#elif REPRO_PART == 1
RMW_WALKS_1(GEMM_WALK_DEFINE, float, 0)
#elif REPRO_PART == 2
RMW_WALKS_0(GEMM_WALK_DEFINE, __nv_bfloat16, 0)
#elif REPRO_PART == 3
RMW_WALKS_1(GEMM_WALK_DEFINE, __nv_bfloat16, 0)
#elif REPRO_PART == 4
RMW_ALL(GEMM_WALK_DEFINE, int8_t, 0)
#elif REPRO_PART == 5
RMW_ALL(GEMM_WALK_DEFINE, int8_t, 4)
#elif REPRO_PART == 6
RMW_ALL(GEMM_WALK_DEFINE, int8_t, 5)
#else
RMW_CLUSTERS(GEMM_CLUSTER_DEFINE)
#endif
#else
RMW_CLUSTERS(GEMM_CLUSTER_EXTERN)
RMW_ALL(GEMM_WALK_EXTERN, float, 0)
RMW_ALL(GEMM_WALK_EXTERN, __nv_bfloat16, 0)
RMW_ALL(GEMM_WALK_EXTERN, int8_t, 0)
RMW_ALL(GEMM_WALK_EXTERN, int8_t, 4)
RMW_ALL(GEMM_WALK_EXTERN, int8_t, 5)
#endif
}  // namespace gemm

#if !defined(REPRO_PART)
namespace {

using namespace gemm;

template <typename T, int WB>
int launch(int m_minor, int a_stripe, int b_res, const void* a, const void* b,
           const void* b_hi, void* c, int m, int n, int k, const Epi& e,
           cudaStream_t s, Took* took) {
  constexpr int CL = TILE_CLUSTER;
  if (m_minor) {
    if (b_res != B_STRIPE) return REPRO_BAD_ARGUMENT;
    return a_stripe
               ? launch_resident<T, WB, WALK_M, true, B_STRIPE>(a, b, b_hi, c, m, n, k, e, s, took, CL)
               : launch_resident<T, WB, WALK_M, false, B_STRIPE>(a, b, b_hi, c, m, n, k, e, s, took, CL);
  }
  if (!a_stripe) return REPRO_BAD_ARGUMENT;
  if (b_res == B_WHOLE)
    return launch_resident<T, WB, WALK_N, true, B_WHOLE>(a, b, b_hi, c, m, n, k, e, s, took, CL);
  if (b_res == B_STREAMED)
    return launch_resident<T, WB, WALK_N, true, B_STREAMED>(a, b, b_hi, c, m, n, k, e, s, took, CL);
  return REPRO_BAD_ARGUMENT;
}

}  // namespace

// Operands as matmul_os. m_minor: 1 WS, 0 IS; a_stripe: 0/1 (1 for IS);
// b_res: 0 streamed, 1 stripe (WS), 2 whole (IS). took (may be null): the
// cluster walk's report (gemm::Took), or TILE_WALK for the one-CTA walk.
extern "C" int matmul_rmw(const void* a, const void* b, void* c, int m, int n,
                          int k, int in_dtype, int out_dtype,
                          const float* scale, int scale_mode,
                          const float* bias, int act, const float* residual,
                          int weight_bits, const void* b_hi, const int* sidx,
                          const int* sdelta, int sr, int m_minor, int a_stripe,
                          int b_res, gemm::Took* took, void* stream) {
  if (took) *took = gemm::Took{};
  if (gemm::bad_args(m, n, k, in_dtype, out_dtype, scale_mode, scale, bias,
                     act, residual, weight_bits, b_hi, sidx, sdelta, sr))
    return REPRO_BAD_ARGUMENT;
  const gemm::Epi e = GEMM_EPI(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GEMM_DISPATCH_DTYPES(launch, m_minor, a_stripe, b_res, a, b, b_hi, c, m, n,
                       k, e, s, took);
}
#endif
