// B1: the output-stationary (OS) fused-epilogue GEMM.
//
// Replaces the TPU kernel repro/kernels/matmul_df.py `_os_kernel` (built by
// `_build_os`): C = act(scale * (A @ B) + bias) + residual, with each output
// tile's f32 accumulator held on chip across the whole k loop and written to
// device memory once, after the epilogue.
//
// bf16 operands under the basic OS dataflow (the serving path) run on the
// tensor cores in the tiles of gemm_tc.cuh: a 128x64 tile fed by a cp.async
// ring for M > 16 (prefill) and a 16-row, 16-column tile streaming the
// weights through a deep ring for M <= 16 (decode). int8 operands under the
// basic OS dataflow (an int8 B, or packed planes decoded into the mma
// fragments: the packed-MLP serving path) take the integer tensor-core
// tiles of gemm_tc_i8.cuh, of the same two kinds. Every other launch runs
// the walk kernel of gemm_common.cuh: one CTA per 64x64 output tile (or per
// stripe, below), bf16 on the tensor cores (8 warps of 16x32), f32 and int8
// on the CUDA cores (256 threads each keeping a 4x4 block of accumulators)
// while 64x32 A and 32x64 B tiles stream through shared memory. Every
// output element sums over k in ascending order (one mma.sync per 16-deep k
// chunk added to it for bf16, one fmaf or integer multiply-add per k
// otherwise), whatever
// M, the tile it falls in or the other rows: a row's result does not depend
// on the batch it rides in, which the serving invariant (mixed-length
// batches emit the same tokens as requests decoded alone) needs, and every
// dataflow gives the basic launch's bits. No split-k, no atomics.
//
// The auxiliary residencies of `_build_os` hold an operand in the CTA's
// shared memory across a walk over the grid dimension the TPU kernel revisits
// it in (the TPU grid runs in order on one core; Hopper's CTAs run in no
// order, so the walk moves inside the CTA):
//   a_stripe (IS STRIPE/WHOLE): CTA i holds A's row stripe (64, K) and walks
//     the column tiles j; the stripe is fetched once.
//   b_res = stripe (WS STRIPE, the n-first grid): CTA j holds B's column
//     stripe (K, 64) and walks the row tiles i (with a_stripe, A's stripe is
//     loaded per i, as the TPU kernel's (bm, K) block is).
//   b_res = whole (WS WHOLE): CTA i holds all of B (K, N), loaded once per CTA,
//     and walks j.
// What does not fit in a block's 227 KB is refused (the Python planner says
// so first, naming the bytes), never run as another dataflow. bf16 operands
// over a sweep of two tiles or more take the cluster walk of
// gemm_cluster.cuh (the same as B4's): a cluster of CTAs holds the resident
// operands, each fetched once per cluster, and splits the sweep (reported
// as the tile "matmul_os_cluster").
//
// int8 operands (an int8 B, or the packed int4/int5 planes that B6 decodes at
// the tile load) take the same residency walks with the integer k loop of
// gemm_common.cuh: exact int32 sums, the outlier sidecar and the epilogue at
// the flush; exact in any order, so they equal the integer tiles bit for
// bit.
//
// Bound on H100: at the decode shapes (M = batch rows) the weight stream,
// i.e. bytes; at prefill shapes (M in the hundreds) the tensor cores'
// operations. The f32 path and the integer walks run on the CUDA cores and
// reach neither. The resident walks trade the grid's parallelism (gm or gn CTAs
// instead of gm * gn) for the fetch-once traffic.
#include "gemm_cluster.cuh"
#include "gemm_tc.cuh"
#include "gemm_tc_i8.cuh"

// The walks this library instantiates: two halves per float input type, the
// five residency walks per int8 kind (int8 B, packed 4-bit, packed 5-bit),
// and the int8 tensor-core tiles of the three kinds; each group is compiled
// in its own translation unit (-DREPRO_PART=0..7), the bf16 cluster walks in
// one more (8). bf16 and int8 have no
// basic walk: their basic launch takes the tensor-core tiles (gemm_tc.cuh,
// compiled with the entry point; gemm_tc_i8.cuh, part 7).
#define OS_RES_0(X, T, WB) \
  X(T, WB, WALK_N, true, B_STREAMED) X(T, WB, WALK_M, false, B_STRIPE)
#define OS_WALKS_0(X, T, WB) \
  X(T, WB, WALK_NONE, false, B_STREAMED) OS_RES_0(X, T, WB)
#define OS_WALKS_1(X, T, WB)                                          \
  X(T, WB, WALK_M, true, B_STRIPE) X(T, WB, WALK_N, false, B_WHOLE)   \
  X(T, WB, WALK_N, true, B_WHOLE)
#define OS_ALL(X, T, WB) OS_WALKS_0(X, T, WB) OS_WALKS_1(X, T, WB)
#define OS_RES(X, T, WB) OS_RES_0(X, T, WB) OS_WALKS_1(X, T, WB)
#define OS_CLUSTERS(X)                                                   \
  X(WALK_N, true, B_STREAMED) X(WALK_M, false, B_STRIPE)                 \
  X(WALK_M, true, B_STRIPE) X(WALK_N, false, B_WHOLE) X(WALK_N, true, B_WHOLE)

namespace gemm {
#if defined(REPRO_PART)
#if REPRO_PART == 0
OS_WALKS_0(GEMM_WALK_DEFINE, float, 0)
#elif REPRO_PART == 1
OS_WALKS_1(GEMM_WALK_DEFINE, float, 0)
#elif REPRO_PART == 2
OS_RES_0(GEMM_WALK_DEFINE, __nv_bfloat16, 0)
#elif REPRO_PART == 3
OS_WALKS_1(GEMM_WALK_DEFINE, __nv_bfloat16, 0)
#elif REPRO_PART == 4
OS_RES(GEMM_WALK_DEFINE, int8_t, 0)
#elif REPRO_PART == 5
OS_RES(GEMM_WALK_DEFINE, int8_t, 4)
#elif REPRO_PART == 6
OS_RES(GEMM_WALK_DEFINE, int8_t, 5)
#elif REPRO_PART == 8
OS_CLUSTERS(GEMM_CLUSTER_DEFINE)
#else
namespace i8 {
GEMM_I8_DEFINE(0) GEMM_I8_DEFINE(4) GEMM_I8_DEFINE(5)
}
#endif
#else
OS_CLUSTERS(GEMM_CLUSTER_EXTERN)
OS_ALL(GEMM_WALK_EXTERN, float, 0)
OS_RES(GEMM_WALK_EXTERN, __nv_bfloat16, 0)
OS_RES(GEMM_WALK_EXTERN, int8_t, 0)
OS_RES(GEMM_WALK_EXTERN, int8_t, 4)
OS_RES(GEMM_WALK_EXTERN, int8_t, 5)
namespace i8 {
GEMM_I8_EXTERN(0) GEMM_I8_EXTERN(4) GEMM_I8_EXTERN(5)
}
#endif
}  // namespace gemm

#if !defined(REPRO_PART)
namespace {

using namespace gemm;

template <typename T, int WB>
int launch(int a_stripe, int b_res, const void* a, const void* b,
           const void* b_hi, void* c, int m, int n, int k, const Epi& e,
           cudaStream_t s, Took* took) {
  constexpr int CL = TILE_OS_CLUSTER;
  if (b_res == B_STRIPE)
    return a_stripe
               ? launch_resident<T, WB, WALK_M, true, B_STRIPE>(a, b, b_hi, c, m, n, k, e, s, took, CL)
               : launch_resident<T, WB, WALK_M, false, B_STRIPE>(a, b, b_hi, c, m, n, k, e, s, took, CL);
  if (b_res == B_WHOLE)
    return a_stripe
               ? launch_resident<T, WB, WALK_N, true, B_WHOLE>(a, b, b_hi, c, m, n, k, e, s, took, CL)
               : launch_resident<T, WB, WALK_N, false, B_WHOLE>(a, b, b_hi, c, m, n, k, e, s, took, CL);
  if (b_res != B_STREAMED) return REPRO_BAD_ARGUMENT;
  if (a_stripe)
    return launch_resident<T, WB, WALK_N, true, B_STREAMED>(a, b, b_hi, c, m, n, k, e, s, took, CL);
  if constexpr (kTC<T>) return launch_tc(a, b, c, m, n, k, e, s, took);
  else if constexpr (std::is_same<T, int8_t>::value)
    return i8::launch<WB>(a, b, b_hi, c, m, n, k, e, s, took);
  else return launch_walk<T, WB, WALK_NONE, false, B_STREAMED>(a, b, b_hi, c, m, n, k, e, s);
}

}  // namespace

// in_dtype f32/bf16 with a B of the same type, or int8 with an int8 B
// (weight_bits 0) or packed planes (weight_bits 4, 5; b_hi the bit plane at
// 5 bits; the sidecar sidx (sr,), sdelta (sr, n)). a_stripe: 0/1; b_res:
// 0 streamed, 1 stripe (n-first walk), 2 whole. took (may be null): the
// tile the launch took, its shared memory bytes, CTAs and cluster size
// (gemm::Took).
extern "C" int matmul_os(const void* a, const void* b, void* c, int m, int n,
                         int k, int in_dtype, int out_dtype,
                         const float* scale, int scale_mode, const float* bias,
                         int act, const float* residual, int weight_bits,
                         const void* b_hi, const int* sidx, const int* sdelta,
                         int sr, int a_stripe, int b_res, gemm::Took* took,
                         void* stream) {
  if (took) *took = gemm::Took{};
  if (gemm::bad_args(m, n, k, in_dtype, out_dtype, scale_mode, scale, bias,
                     act, residual, weight_bits, b_hi, sidx, sdelta, sr))
    return REPRO_BAD_ARGUMENT;
  const gemm::Epi e = GEMM_EPI(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GEMM_DISPATCH_DTYPES(launch, a_stripe, b_res, a, b, b_hi, c, m, n, k, e, s,
                       took);
}
#endif
