// B4 and B5a on Hopper's thread-block clusters: the bf16 walks of the basic
// WS and IS dataflows (B4, matmul_rmw.cu; B1's residencies, matmul_os.cu,
// run the very same walks) and WS with a resident output stripe (B5a,
// matmul_ws_stripe.cu).
//
// Replaces, for bf16 operands over a sweep of two tiles or more, the walk
// kernels in which one CTA held the resident operand and walked the whole
// sweep alone (2 CTAs on 132 SMs for WS at the paper's layer (56,3,1,128)).
// Here a cluster of C CTAs on neighbouring SMs owns each resident stripe:
// - Multicast. Each resident operand (B's column stripe, A's row stripe,
//   B whole) is cut into 4 KB k-step slots and CTA r of the cluster fetches
//   slots r, r + C, ...: with the TMA, one box copy multicast into every CTA
//   of the cluster; otherwise with cp.async (or element) copies, each CTA
//   then copying the others' slots from their shared memory (distributed
//   shared memory) after a cluster barrier. Either way the stripe leaves
//   device memory once per cluster, as the reference charges it once per
//   stripe (repro/kernels/matmul_df.py:414-418), and every CTA holds all
//   of it.
// - Split sweep. CTA r walks the sweep's tiles r, r + C, ... (row tiles for
//   WS, column tiles for IS); its streamed operand goes through a ring of up
//   to 16 k-step slots, the next tile's first steps in flight while the
//   current tile ends.
// - Fragments by ldmatrix. A slots keep 64-byte rows, B slots 128-byte
//   rows, each row's 16-byte chunks XOR-swizzled by the row (exactly the
//   TMA's 64- and 128-byte swizzles), so the 8 rows an ldmatrix (.trans for
//   B) reads hit 8 distinct bank groups; no padding, so a resident stripe
//   takes the same bytes as the one-CTA walk's, and the plan refuses
//   exactly what it refused before.
// - A producer warp. Where every row is whole 16-byte vectors, a ninth warp
//   issues every TMA copy; the 8 warps that compute wait on a slot's `full`
//   mbarrier and arrive on its `spent` one, with no __syncthreads a k step.
//   Elsewhere (K or N not a multiple of 8, an unaligned operand, a resident
//   A stripe of fewer than 64 rows) the walks take cp.async copies and a
//   __syncthreads a step.
// B5a: a cluster per output column stripe; CTA r owns the stripe's row
// tiles r, r + C, ... (at most STRIPE_TILES, so its part of the (M, 64) f32
// stripe stays in registers across the whole reduction). The weight column
// streams in chunks of STRIPE_KC k steps, each chunk's rows cut among the
// cluster's CTAs and multicast by the TMA (element loads exchanged over
// distributed shared memory where rows are not whole 16-byte vectors),
// STRIPE_SLOTS chunks held; a chunk's slot is refilled once every CTA of
// the cluster is done with it. Each CTA streams its own A tiles. The epilogue runs once, after the last
// chunk, and each output element is written once.
//
// Arithmetic: B1's k chain (gemm_common.cuh): per 16-deep k chunk one
// mma.sync m16n8k16 from zero, added to the f32 accumulator with one rounded
// add, in ascending k over round_up(K, 32) (zeros past K), then B1's
// epilogue; built with -fmad=false. Each warp owns the 16 x 32 block of a
// 64 x 64 tile that the walk kernel's warps own. So every output element
// equals B1's bit for bit.
//
// A cluster the card cannot place (cudaOccupancyMaxActiveClusters is 0 at
// the chosen size and shared memory) is refused with REPRO_NO_CLUSTER; the
// caller raises and never runs another walk instead.
//
// Bound on H100: at the timed shape of B4 (M=2916 K=1152 N=128) the bytes
// (0.0025 ms) over the tensor cores' 0.86 GFLOP (0.0009 ms); B5a at M=512
// K=6144 N=2048 the operations (12.9 GFLOP, 0.0130 ms). Measured far from
// both (PERF.md): a k step of the walks costs several times what the same
// step costs in isolation (bench/cluster_sweep.cu).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no libcuda is linked)

#include "gemm_common.cuh"

namespace gemm {
namespace cl {

constexpr int SLOT = 4096;        // bytes of a 64 x 32 A or a 32 x 64 B k step
constexpr int RING = 16;          // k-step slots of a streamed operand's ring (most)
constexpr int MAX_CLUSTER = 16;   // above 8 needs the non-portable opt-in
constexpr int CARD_SMS = 132;     // H100 SXM
constexpr int STRIPE_KC = 2;      // B5a: k steps a chunk
constexpr int STRIPE_SLOTS = 4;   // B5a: chunks held at once
constexpr int STRIPE_TILES = 2;   // B5a: most row tiles a CTA owns

// The cluster size of a sweep of g tiles under `anchors` clusters: doubled
// from 2 while the card has SMs without a CTA, up to MAX_CLUSTER and to g
// (every CTA gets a tile); at least lo. matmul_df.cluster_size mirrors it.
__host__ __device__ inline int cluster_size(int anchors, int g, int lo) {
  int c = 2;
  while (c < MAX_CLUSTER && 2 * c <= g && anchors * c < CARD_SMS) c *= 2;
  return c > lo ? c : lo;
}
__host__ __device__ inline int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

__device__ __forceinline__ int rank_in_cluster() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int ctas_in_cluster() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
// The cluster barrier, split: arrive publishes this thread's prior writes
// (and retires its prior reads of other CTAs) cluster-wide; wait returns once
// every thread of the cluster has arrived, and sees their writes.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of this CTA's shared memory location p in CTA `rank`.
__device__ __forceinline__ uint32_t peer(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(tc::smem_addr(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ uint4 ld_peer(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// Byte offset of element (r, c) of an A slot (rows of 32 bf16, 64 bytes):
// chunk c / 8 of row r sits at chunk (c / 8) ^ ((r / 2) % 4).
__device__ __forceinline__ int a_off(int r, int c) {
  return r * 64 + ((((c >> 3) ^ (r >> 1)) & 3) << 4) + ((c & 7) << 1);
}
// ... of a B slot (rows of 64 bf16, 128 bytes): chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ int b_off(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

// Eight bf16 at (gr, gc..gc+7) of a row-major source (ld columns, rows x
// cols valid) to dst, zeros outside: one 16-byte cp.async (VEC: cols, ld
// and the source 16-byte aligned), else element loads.
template <bool VEC>
__device__ __forceinline__ void load8(unsigned char* dst,
                                      const __nv_bfloat16* src, int ld,
                                      int rows, int cols, int gr, int gc) {
  if constexpr (VEC) {
    const bool in = gr < rows && gc < cols;
    tc::cp_async16(dst, in ? src + (size_t)gr * ld + gc : src, in);
  } else {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(src) + (size_t)gr * ld;
    uint16_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = gr < rows && gc + j < cols ? s[gc + j] : 0;
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(tc::pack2(v[0], v[1]), tc::pack2(v[2], v[3]),
                   tc::pack2(v[4], v[5]), tc::pack2(v[6], v[7]));
  }
}

// One k-step slot: `nrows` rows of COLS (32: an A slot, 64: a B slot)
// from (r0, c0) of the source.
template <bool VEC, int COLS>
__device__ __forceinline__ void load_slot(unsigned char* dst,
                                          const __nv_bfloat16* src, int ld,
                                          int rows, int cols, int r0, int c0,
                                          int nrows) {
  constexpr int VPR = COLS / 8;
  for (int i = threadIdx.x; i < nrows * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    load8<VEC>(dst + (COLS == 32 ? a_off(r, c) : b_off(r, c)), src, ld, rows,
               cols, r0 + r, c0 + c);
  }
}

// Waits until at most n (0..N) of this thread's cp.async groups are in
// flight.
template <int N = RING - 1>
__device__ __forceinline__ void wait_upto(int n) {
  if constexpr (N == 0) {
    tc::cp_async_wait<0>();
  } else {
    if (n >= N) tc::cp_async_wait<N>();
    else wait_upto<N - 1>(n);
  }
}

using tc::ldsm_x4;
using tc::ldsm_x4_trans;

// One 32-deep k step of a warp's 16 x 32 block (gemm_common.cuh's wrow,
// wcol): A from the A slot at shared address `as` with `arows` rows (rows
// past it read its last row; they feed only output rows that are never
// stored), or with `a_col` >= 0 from columns a_col.. of a wide A slot (64
// rows of 64 k, 128-byte rows laid out as a B slot's), B from the B slot at
// `bs`.
__device__ __forceinline__ void step(float acc[TM][TN], uint32_t as, int arows,
                                     uint32_t bs, int a_col = -1) {
  const int l = tc::lane(), wr = wrow(), wc = wcol();
  const int ar = min(wr + (l & 7) + ((l >> 3) & 1) * 8, arows - 1);
  const int br = (l & 7) + ((l >> 3) & 1) * 8, bc = (l >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < BK; kc += 16) {
    uint32_t a[4], r0[4], r1[4];
    const int ac = kc + (l >> 4) * 8;
    ldsm_x4(a, as + (a_col < 0 ? a_off(ar, ac) : b_off(ar, a_col + ac)));
    ldsm_x4_trans(r0, bs + b_off(kc + br, wc + bc));
    ldsm_x4_trans(r1, bs + b_off(kc + br, wc + 16 + bc));
    const uint32_t b[TM][2] = {{r0[0], r0[1]}, {r0[2], r0[3]},
                               {r1[0], r1[1]}, {r1[2], r1[3]}};
#pragma unroll
    for (int i = 0; i < TM; ++i) tc::mma_bf16_add(acc[i], a, b[i]);
  }
}

__device__ __forceinline__ void zero(float acc[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// --- TMA and mbarriers -----------------------------------------------------
//
// Where the operands' rows are whole 16-byte vectors (K and N multiples of
// 8, 16-byte aligned), the walks load their k-step slots with the Tensor
// Memory Accelerator: one thread issues a 2-D box copy (cp.async.bulk.tensor)
// that lands in shared memory in the slots' own swizzled layout (64-byte
// rows with the 64-byte swizzle for A, 128-byte rows with the 128-byte
// swizzle for B: a_off and b_off are exactly those), zero past the matrix,
// and reports its bytes to an mbarrier. A resident slot is multicast: the
// CTA that issues it writes it into every CTA of the cluster at once.

// Threads of the TMA kernels: 8 warps that compute and a producer warp.
constexpr int TMA_THREADS = THREADS + 32;

// Shared memory kept for a kernel's mbarriers (after its slots): a
// walk's resident one and a `full` and a `spent` one per ring slot.
__host__ __device__ constexpr int bar_bytes(int ring) {
  return round_up(8 * (1 + 2 * ring), 128);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_addr(bar)),
               "r"(count));
}
// Makes this CTA's initialized mbarriers visible to the cluster and to the
// TMA unit.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` more from copies in flight.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tc::smem_addr(bar))
               : "memory");
}
// One arrival on the mbarrier at bar's offset in CTA `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar, int rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   peer(bar, rank))
               : "memory");
}
// Waits for the phase of parity `parity` to complete; CLUSTER: with
// cluster-scope acquire, for arrivals of other CTAs (the TMA's bytes, even
// multicast from another CTA, need only the CTA's). A wait that never ends
// traps, so a fault in the copies' bookkeeping fails the launch instead of
// hanging the card.
template <bool CLUSTER = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = tc::smem_addr(bar);
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    if constexpr (CLUSTER)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    if (done) return;
    if (spin == (1u << 28)) __trap();
  }
}
// The box of `map` at (column c0, row r0) into dst, its bytes reported to
// bar; with a mask, into every CTA of the mask at the same offsets.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, int c0,
                                         int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(r0), "r"(tc::smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_multicast(void* dst, const CUtensorMap& map,
                                              int c0, int r0, uint64_t* bar,
                                              uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(r0), "r"(tc::smem_addr(bar)),
      "h"(mask)
      : "memory");
}

// The box of a 3-D `map` at (c0, r0, z0), multicast as tma_multicast.
__device__ __forceinline__ void tma_multicast_3d(void* dst, const CUtensorMap& map,
                                                 int c0, int r0, int z0, uint64_t* bar,
                                                 uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(r0), "r"(z0),
      "r"(tc::smem_addr(bar)), "h"(mask)
      : "memory");
}

// cuTensorMapEncodeTiled, through cudaGetDriverEntryPoint so the libraries
// need no libcuda (null where the driver does not give it).
using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                            const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                            const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline Encode encoder() {
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault) ==
        cudaSuccess)
      encode = reinterpret_cast<Encode>(fn);
  }
  return encode;
}
// A tensor map of a row-major bf16 array (or one of `type`) of `rank` (2 or
// 3) dimensions, dims[0] the contiguous one, strides[i] the bytes between
// steps of dimension i + 1, in boxes of `box`, each box row's 16-byte chunks
// swizzled by `swizzle`; zeros past the array.
inline int make_map_nd(CUtensorMap* map, const void* base, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box, CUtensorMapSwizzle swizzle,
                       CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const Encode encode = encoder();
  if (!encode) return REPRO_BAD_ARGUMENT;
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, type, (cuuint32_t)rank,
                            const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : REPRO_BAD_ARGUMENT;
}
// A (rows, cols) matrix with ld columns, in boxes of box_rows x box_cols.
inline int make_map(CUtensorMap* map, const void* base, int rows, int cols,
                    int ld, int box_rows, int box_cols,
                    CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return make_map_nd(map, base, 2, dims, strides, box, swizzle);
}
// The A slots' map (64 x 32 boxes with the 64-byte swizzle, or wide: 64 x
// 64 with the 128-byte one) and the B slots' (`b_rows` x 64, 128-byte
// swizzle) of A (m, k) and B (k, n).
inline int make_maps(CUtensorMap* ma, CUtensorMap* mb, const void* a,
                     const void* b, int m, int n, int k, int b_rows, bool wide_a) {
  const int rc = make_map(ma, a, m, k, k, BM, wide_a ? 2 * BK : BK,
                          wide_a ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  return rc ? rc : make_map(mb, b, k, n, n, b_rows, BN, CU_TENSOR_MAP_SWIZZLE_128B);
}

// B4's walks (and B1's residencies) on a cluster. WALK_M: cluster j holds
// B's column stripe j (B_STRIPE) and its CTAs split the row tiles, each
// streaming its A tiles, or with A_RES its A row stripe per tile (a ring of
// all the tile's k steps). WALK_N: cluster i holds A's row stripe i (A_RES)
// and/or B whole (B_WHOLE), its CTAs split the column tiles, streaming B
// (B_STREAMED) or A (no A_RES). `ring`: slots of the streamed operand.
//
// This kernel takes operands whose rows are not whole 16-byte vectors (and
// a resident A stripe of fewer than 64 rows): cp.async 16-byte copies
// (VEC) or element loads, the resident slots exchanged over distributed
// shared memory after a cluster barrier, and a __syncthreads a k step.
// walk_tma_kernel below takes the rest.
template <bool VEC, int WALK, bool A_RES, int B_RES>
__global__ void __launch_bounds__(THREADS)
walk_cluster_kernel(const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ b, void* __restrict__ c,
                    int m, int n, int k, Epi e, int ring) {
  constexpr bool HOLD_A = WALK == WALK_N && A_RES;
  constexpr bool STREAM_A = WALK == WALK_M || !A_RES;
  constexpr bool STREAM_B = WALK == WALK_N && B_RES == B_STREAMED;
  constexpr bool STREAMS = STREAM_A || STREAM_B;
  static_assert(!(STREAM_A && STREAM_B), "one operand streams");
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = tc::smem_addr(smem);
  const int C = ctas_in_cluster(), rank = rank_in_cluster();
  const int anchor = blockIdx.x / C;
  const int ks = round_up(k, BK) / BK, gm = cdiv(m, BM), gn = cdiv(n, BN);
  const int g = WALK == WALK_M ? gm : gn;
  const int row0 = anchor * BM, col0 = anchor * BN;  // WALK_N, WALK_M
  // Resident: A's row stripe (ra rows a slot), then B's stripe or B whole;
  // then the ring.
  const int ra = HOLD_A ? min(BM, round_up(m, TM)) : BM;
  const int a_slots = HOLD_A ? ks : 0;
  const int b_slots = (B_RES == B_STRIPE ? 1 : B_RES == B_WHOLE ? gn : 0) * ks;
  const int held = a_slots + b_slots;
  unsigned char* ares = smem;
  unsigned char* bres = smem + (size_t)a_slots * ra * 64;
  unsigned char* rbase = bres + (size_t)b_slots * SLOT;
  auto held_slot = [&](int q) {
    return q < a_slots ? ares + (size_t)q * ra * 64 : bres + (size_t)(q - a_slots) * SLOT;
  };
  auto held_bytes = [&](int q) { return q < a_slots ? ra * 64 : SLOT; };
  const int nt = rank < g ? cdiv(g - rank, C) : 0;  // tiles rank, rank + C, ...
  const int total = nt * ks;
  const int d = STREAMS ? min(RING - 1, ring - 1) : 0;  // steps in flight ahead
  // The k step x of this CTA's sweep: tile rank + (x / ks) C, depth x % ks.
  auto step_origin = [&](int x, int* c0, int* r0) {
    const int t = rank + (x / ks) * C, s = x % ks;
    if constexpr (STREAM_A) {
      *c0 = s * BK;
      *r0 = WALK == WALK_M ? t * BM : row0;
    } else {
      *c0 = t * BN;
      *r0 = s * BK;
    }
  };

  {  // This CTA's share of the resident slots, then the ring's first steps.
    for (int q = rank; q < held; q += C) {
      if (q < a_slots) {
        load_slot<VEC, 32>(held_slot(q), a, k, m, k, row0, q * BK, ra);
      } else {
        const int p = q - a_slots;
        load_slot<VEC, 64>(held_slot(q), b, n, k, n, (p % ks) * BK,
                           B_RES == B_STRIPE ? col0 : (p / ks) * BN, BK);
      }
    }
    tc::cp_async_commit();
    auto load_step = [&](int x) {
      int c0, r0;
      step_origin(x, &c0, &r0);
      unsigned char* dst = rbase + (x % ring) * SLOT;
      if constexpr (STREAM_A) load_slot<VEC, 32>(dst, a, k, m, k, r0, c0, BM);
      else load_slot<VEC, 64>(dst, b, n, k, n, r0, c0, BK);
    };
    for (int x = 0; x < d; ++x) {
      if (x < total) load_step(x);
      tc::cp_async_commit();
    }
    wait_upto(d);  // this CTA's share has landed; the ring's may not have
    cluster_arrive();
    cluster_wait();
    // The other CTAs' slots, four slots' loads in flight at once.
    for (int q0 = 0; q0 < held; q0 += 4) {
      uint4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + j;
        if (q < held && q % C != rank && threadIdx.x * 16 < held_bytes(q))
          v[j] = ld_peer(peer(held_slot(q) + threadIdx.x * 16, q % C));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + j;
        if (q < held && q % C != rank && threadIdx.x * 16 < held_bytes(q))
          *reinterpret_cast<uint4*>(held_slot(q) + threadIdx.x * 16) = v[j];
      }
    }
    cluster_arrive();  // done reading the others' memory (waited for at exit)
    __syncthreads();
  }

  float acc[TM][TN];
  for (int x = 0; x < total; ++x) {
    const int u = x / ks, s = x % ks, t = rank + u * C;
    const int slot = STREAMS ? x % ring : 0;
    if constexpr (STREAMS) {
      wait_upto(d - 1);  // step x's slot has landed (this thread's copies)
      __syncthreads();   // ... everyone's; step x - 1's slot is consumed
      if (x + d < total) {
        int c0, r0;
        step_origin(x + d, &c0, &r0);
        unsigned char* dst = rbase + ((x + d) % ring) * SLOT;
        if constexpr (STREAM_A) load_slot<VEC, 32>(dst, a, k, m, k, r0, c0, BM);
        else load_slot<VEC, 64>(dst, b, n, k, n, r0, c0, BK);
      }
      tc::cp_async_commit();
    }
    if (s == 0) zero(acc);
    const int tr = WALK == WALK_M ? t * BM : row0, tcol = WALK == WALK_M ? col0 : t * BN;
    const unsigned char* as = STREAM_A ? rbase + slot * SLOT : ares + (size_t)s * ra * 64;
    const unsigned char* bs =
        STREAM_B ? rbase + slot * SLOT
                 : bres + (size_t)((B_RES == B_WHOLE ? t : 0) * ks + s) * SLOT;
    if (tr + wrow() < m)  // warp-uniform
      step(acc, sbase + (uint32_t)(as - smem), STREAM_A ? BM : ra,
           sbase + (uint32_t)(bs - smem));
    if (s == ks - 1) store_tile<true>(c, acc, tr, tcol, m, n, e);
  }
  tc::cp_async_wait<0>();
  cluster_wait();  // no CTA of the cluster still reads this one's memory
}

// The same walks where the operands' rows are whole 16-byte vectors: on the
// TMA, with a producer warp (warp 8) beside the 8 warps that compute. The
// producer issues this CTA's resident slots r, r + C, ... multicast into
// the whole cluster (all reported to the `held` mbarrier of every CTA),
// then the streamed operand into the ring, two k steps a box (8 KB: 64 rows
// of 64 k of A, or 64 k rows of B; one step where the ring has fewer than
// 4 slots of one), a box as soon as all 8 warps have arrived on its slot's
// `spent` mbarrier; a computing warp waits on the slot's `full` mbarrier,
// so no k step takes a __syncthreads.
template <int WALK, bool A_RES, int B_RES>
__global__ void __launch_bounds__(TMA_THREADS)
walk_tma_kernel(void* __restrict__ c, int m, int n, int k, Epi e, int ring,
                const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b) {
  constexpr bool HOLD_A = WALK == WALK_N && A_RES;
  constexpr bool STREAM_A = WALK == WALK_M || !A_RES;
  constexpr bool STREAM_B = WALK == WALK_N && B_RES == B_STREAMED;
  constexpr bool STREAMS = STREAM_A || STREAM_B;
  static_assert(!(STREAM_A && STREAM_B), "one operand streams");
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = tc::smem_addr(smem);
  const int C = ctas_in_cluster(), rank = rank_in_cluster();
  const int anchor = blockIdx.x / C;
  const int ks = round_up(k, BK) / BK, gm = cdiv(m, BM), gn = cdiv(n, BN);
  const int g = WALK == WALK_M ? gm : gn;
  const int row0 = anchor * BM, col0 = anchor * BN;  // WALK_N, WALK_M
  // Resident: A's row stripe (64 rows), then B's stripe or B whole; then
  // the ring; then the mbarriers.
  const int a_slots = HOLD_A ? ks : 0;
  const int held = a_slots + (B_RES == B_STRIPE ? 1 : B_RES == B_WHOLE ? gn : 0) * ks;
  unsigned char* rbase = smem + (size_t)held * SLOT;
  uint64_t* held_bar = reinterpret_cast<uint64_t*>(rbase + (size_t)ring * SLOT);
  uint64_t* full = held_bar + 1;
  uint64_t* spent = full + ring;
  const int nt = rank < g ? cdiv(g - rank, C) : 0;  // tiles rank, rank + C, ...
  // A streamed box holds `depth` k steps; the ring `boxes` of them.
  const int depth = STREAMS && ring >= 4 ? 2 : 1, boxes = ring / depth;
  const int kd = cdiv(ks, depth), total = nt * kd;

  if (threadIdx.x == 0) {
    mbar_init(held_bar, 1);
    for (int i = 0; i < boxes; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&spent[i], THREADS / 32);
    }
    mbar_init_fence();
  }
  cluster_arrive();  // every CTA's mbarriers exist before any copy lands
  cluster_wait();
  if (threadIdx.x == THREADS) {  // the producer
    mbar_expect(held_bar, (uint32_t)held * SLOT);
    const uint16_t all = (uint16_t)((1u << C) - 1);
    for (int q = rank; q < held; q += C) {
      const int p = q - a_slots;
      const CUtensorMap& map = q < a_slots ? map_a : map_b;
      const int c0 = q < a_slots ? q * BK : B_RES == B_STRIPE ? col0 : (p / ks) * BN;
      const int r0 = q < a_slots ? row0 : (p % ks) * BK;
      tma_multicast(smem + (size_t)q * SLOT, map, c0, r0, held_bar, all);
    }
    if constexpr (STREAMS) {
      for (int y = 0; y < total; ++y) {
        const int ys = y % boxes, t = rank + (y / kd) * C, s = (y % kd) * depth;
        if (y >= boxes) mbar_wait(&spent[ys], (y / boxes - 1) & 1);
        mbar_expect(&full[ys], depth * SLOT);
        unsigned char* dst = rbase + (size_t)ys * depth * SLOT;
        if constexpr (STREAM_A)
          tma_load(dst, map_a, s * BK, WALK == WALK_M ? t * BM : row0, &full[ys]);
        else
          tma_load(dst, map_b, t * BN, s * BK, &full[ys]);
      }
    }
  } else if (threadIdx.x < THREADS) {
    mbar_wait(held_bar, 0);
    int slot = 0, phase = 0;  // the streamed box: its slot and its use's parity
    for (int t = rank; t < g; t += C) {
      const int tr = WALK == WALK_M ? t * BM : row0, tcol = WALK == WALK_M ? col0 : t * BN;
      const bool rows = tr + wrow() < m;  // warp-uniform
      float acc[TM][TN];
      zero(acc);
      for (int sd = 0; sd < kd; ++sd) {
        if constexpr (STREAMS) mbar_wait(&full[slot], phase);
        const unsigned char* box = rbase + (size_t)slot * depth * SLOT;
        for (int h = 0; h < depth && sd * depth + h < ks; ++h) {
          const int s = sd * depth + h;
          const unsigned char* as = STREAM_A ? box : smem + (size_t)s * SLOT;
          const unsigned char* bs =
              STREAM_B ? box + h * SLOT
                       : smem + (size_t)(a_slots + (B_RES == B_WHOLE ? t : 0) * ks + s) * SLOT;
          if (rows)
            step(acc, sbase + (uint32_t)(as - smem), BM, sbase + (uint32_t)(bs - smem),
                 STREAM_A && depth == 2 ? h * BK : -1);
        }
        if constexpr (STREAMS) {
          __syncwarp();
          if (tc::lane() == 0) mbar_arrive(&spent[slot]);  // this warp is done with it
          if (++slot == boxes) slot = 0, phase ^= 1;
        }
      }
      store_tile<true>(c, acc, tr, tcol, m, n, e);
    }
  }
  __syncwarp();
  cluster_arrive();  // no CTA leaves while copies it issued may still land
  cluster_wait();
}

// Bytes of dynamic shared memory of a cluster walk and the slots of its
// ring (0: nothing streams): the resident slots, the ring, and the
// mbarriers (none beside a resident A stripe of fewer than 64 rows, which
// takes no TMA; a streamed ring's ring slots leave room for a full ring's
// mbarriers). matmul_df.cluster_walk_smem mirrors it.
template <int WALK, bool A_RES, int B_RES>
size_t walk_smem(int m, int n, int k, int* ring) {
  const int ks = round_up(k, BK) / BK, gn = cdiv(n, BN);
  const int ra = WALK == WALK_N && A_RES ? min(BM, round_up(m, TM)) : BM;
  const bool tma = ra == BM;  // the mbarriers' bytes, kept whenever the TMA may run
  const size_t held =
      (WALK == WALK_N && A_RES ? (size_t)ks * ra * 64 : 0) +
      (size_t)(B_RES == B_STRIPE ? 1 : B_RES == B_WHOLE ? gn : 0) * ks * SLOT;
  int r = 0;
  if (WALK == WALK_M && A_RES) {
    r = ks > 2 ? ks : 2;
  } else if (WALK == WALK_M || !A_RES || B_RES == B_STREAMED) {
    const size_t most = held + (tma ? bar_bytes(RING) : 0);
    r = most >= MAX_SMEM ? 0 : min(RING, (int)((MAX_SMEM - most) / SLOT));
  }
  *ring = r;
  return held + (size_t)r * SLOT + (tma ? bar_bytes(r) : 0);
}

// B5a on a cluster (above): chunks of KC k steps, S of them held.
//
// TMA (whole 16-byte rows): a producer warp (warp 8) issues each chunk's
// 1/C of the weight rows multicast into every CTA of the cluster and this
// CTA's own A tiles, all reported to the chunk slot's `full` mbarrier, and
// refills a slot once every CTA of the cluster has arrived on its `spent`
// mbarrier (each CTA's 8 computing warps meet at a named barrier, then
// arrive on every CTA's). Otherwise: element loads of each CTA's share,
// exchanged over distributed shared memory after a cluster barrier a
// chunk, S - 2 chunks in flight ahead.
//
// Three CTAs an SM (their shared memory allows three): with two, the 32
// clusters of 8 at M=512 N=2048 do not all fit at once, and the kernel took
// 1.5x as long (75 registers a thread instead of at most 72).
template <bool TMA>
__global__ void __launch_bounds__(TMA ? TMA_THREADS : THREADS, 3)
ws_stripe_cluster_kernel(const __nv_bfloat16* __restrict__ a,
                         const __nv_bfloat16* __restrict__ b,
                         void* __restrict__ c, int m, int n, int k, Epi e,
                         const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b) {
  constexpr int KC = STRIPE_KC, S = STRIPE_SLOTS;
  static_assert(S >= 3, "a chunk's slot is refilled two chunks after use");
  constexpr int VECS = KC * SLOT / 16;  // 16-byte vectors of a chunk's B
  constexpr int AHEAD = S - 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = tc::smem_addr(smem);
  const int C = ctas_in_cluster(), rank = rank_in_cluster();
  const int col0 = (blockIdx.x / C) * BN;
  const int ks = round_up(k, BK) / BK, gm = cdiv(m, BM);
  const int chunks = cdiv(ks, KC);
  const int nt = rank < gm ? cdiv(gm - rank, C) : 0;  // row tiles rank, rank + C
  // A chunk's slot: its B part (KC k steps), then this CTA's A tiles (KC
  // steps each), sized for the most tiles a CTA of the cluster has so every
  // CTA's B parts sit at the same offsets; then the mbarriers.
  const size_t chunk_bytes = (size_t)KC * SLOT * (1 + cdiv(gm, C));
  auto bpart = [&](int ch) { return smem + (ch % S) * chunk_bytes; };
  auto apart = [&](int ch, int u, int s) {
    return bpart(ch) + (size_t)KC * SLOT * (1 + u) + s * SLOT;
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * chunk_bytes);
  uint64_t* spent = full + S;
  float acc[STRIPE_TILES][TM][TN];
#pragma unroll
  for (int u = 0; u < STRIPE_TILES; ++u) zero(acc[u]);
  auto compute = [&](int ch) {
    const int steps = min(KC, ks - ch * KC);
    for (int s = 0; s < steps; ++s)
#pragma unroll
      for (int u = 0; u < STRIPE_TILES; ++u)
        if (u < nt && (rank + u * C) * BM + wrow() < m)  // warp-uniform
          step(acc[u], sbase + (uint32_t)(apart(ch, u, s) - smem), BM,
               sbase + (uint32_t)(bpart(ch) + s * SLOT - smem));
  };

  if constexpr (TMA) {
    const int rows = KC * BK / C;  // weight rows of a CTA's part (a box)
    auto issue = [&](int ch) {     // the producer
      const int sl = ch % S;
      if (ch >= S) mbar_wait<true>(&spent[sl], (ch / S - 1) & 1);
      mbar_expect(&full[sl], (uint32_t)(KC * SLOT * (1 + nt)));
      tma_multicast(bpart(ch) + rank * rows * 128, map_b, col0, ch * KC * BK + rank * rows,
                    &full[sl], (uint16_t)((1u << C) - 1));
      for (int u = 0; u < nt; ++u)
        for (int s = 0; s < KC; ++s)
          tma_load(apart(ch, u, s), map_a, (ch * KC + s) * BK, (rank + u * C) * BM,
                   &full[sl]);
    };
    if (threadIdx.x == 0) {
      for (int i = 0; i < S; ++i) {
        mbar_init(&full[i], 1);
        mbar_init(&spent[i], C);
      }
      mbar_init_fence();
    }
    cluster_arrive();  // every CTA's mbarriers exist before any copy lands
    cluster_wait();
    if (threadIdx.x == THREADS) {
      for (int ch = 0; ch < chunks; ++ch) issue(ch);
    } else if (threadIdx.x < THREADS) {
      for (int ch = 0; ch < chunks; ++ch) {
        mbar_wait(&full[ch % S], (ch / S) & 1);
        compute(ch);
        // the 8 computing warps are done with chunk ch's slot
        asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
        if (threadIdx.x < C) mbar_arrive_peer(&spent[ch % S], threadIdx.x);
      }
    }
    __syncwarp();
  } else {
    const int per = VECS / C, lo = rank * per;  // B vectors a CTA loads
    auto load_own = [&](int ch) {
      const int s0 = ch * KC, steps = min(KC, ks - s0);
      for (int v = lo + threadIdx.x; v < lo + per; v += THREADS) {
        const int s = v / 256, r = (v % 256) / 8, cc = (v % 8) * 8;
        if (s < steps)
          load8<false>(bpart(ch) + s * SLOT + b_off(r, cc), b, n, k, n,
                       (s0 + s) * BK + r, col0 + cc);
      }
      for (int u = 0; u < nt; ++u)
        for (int s = 0; s < steps; ++s)
          load_slot<false, 32>(apart(ch, u, s), a, k, m, k, (rank + u * C) * BM,
                               (s0 + s) * BK, BM);
    };
    // The other CTAs' parts of chunk ch's B (vector v from CTA v / per, at
    // the same offset: a part is whole swizzled rows).
    auto copy_peers = [&](int ch) {
      unsigned char* dst = bpart(ch);
      uint4 v[VECS / THREADS];
#pragma unroll
      for (int j = 0; j < VECS / THREADS; ++j) {
        const int i = threadIdx.x + j * THREADS;
        if (i / per != rank) v[j] = ld_peer(peer(dst + i * 16, i / per));
      }
#pragma unroll
      for (int j = 0; j < VECS / THREADS; ++j) {
        const int i = threadIdx.x + j * THREADS;
        if (i / per != rank) *reinterpret_cast<uint4*>(dst + i * 16) = v[j];
      }
    };
    // Chunk ch + AHEAD's own loads go into the slot chunk ch - 2 left: this
    // CTA consumed it before the last __syncthreads, and every other CTA
    // copied from it before arriving at the barrier this CTA last waited on.
    for (int ch = 0; ch < AHEAD; ++ch) {
      if (ch < chunks) load_own(ch);
      tc::cp_async_commit();
    }
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch + AHEAD < chunks) load_own(ch + AHEAD);
      tc::cp_async_commit();
      tc::cp_async_wait<AHEAD>();  // this CTA's part of chunk ch has landed
      cluster_arrive();            // ... and its reads of chunk ch - 1 are done
      if (ch > 0) compute(ch - 1);
      cluster_wait();  // every part of chunk ch has landed
      copy_peers(ch);
      __syncthreads();
    }
    compute(chunks - 1);
    tc::cp_async_wait<0>();
  }
  cluster_arrive();
  if (threadIdx.x < THREADS)
#pragma unroll
    for (int u = 0; u < STRIPE_TILES; ++u)
      if (u < nt) store_tile<true>(c, acc[u], (rank + u * C) * BM, col0, m, n, e);
  cluster_wait();  // no CTA of the cluster still reads or writes this one
}

// B5b on a cluster: B5a's mirror. A cluster per output row stripe; CTA r
// owns the stripe's column tiles r, r + C, ... (at most STRIPE_TILES, so its
// part of the (64, N) f32 stripe stays in registers across the whole
// reduction). The input row stripe, the input-stationary operand, streams in
// chunks of STRIPE_KC k steps, a chunk one wide A slot (64 rows of 64 k,
// 128-byte rows laid out as a B slot's); each chunk's 8-row pieces are cut
// among the cluster's CTAs and multicast by the TMA (element loads exchanged
// over distributed shared memory where rows are not whole 16-byte vectors),
// so the stripe leaves device memory once per stripe, as the reference
// charges it (repro/kernels/matmul_df.py `_build_is`); STRIPE_SLOTS chunks
// held, a chunk's slot refilled once every CTA of the cluster is done with
// it. Each CTA streams its own B tiles: with B whole, each CTA holds only
// its own columns, so B too leaves memory once per cluster. The epilogue
// runs once, after the last chunk, and each output element is written once.
template <bool TMA>
__global__ void __launch_bounds__(TMA ? TMA_THREADS : THREADS, 3)
is_stripe_cluster_kernel(const __nv_bfloat16* __restrict__ a,
                         const __nv_bfloat16* __restrict__ b,
                         void* __restrict__ c, int m, int n, int k, Epi e,
                         const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b) {
  constexpr int KC = STRIPE_KC, S = STRIPE_SLOTS;
  static_assert(S >= 3, "a chunk's slot is refilled two chunks after use");
  static_assert(KC * BK == 2 * BK, "a chunk's A is one wide slot");
  constexpr int VECS = KC * SLOT / 16;  // 16-byte vectors of a chunk's A
  constexpr int PIECES = BM / 8;        // 8-row boxes of a chunk's A
  constexpr int AHEAD = S - 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = tc::smem_addr(smem);
  const int C = ctas_in_cluster(), rank = rank_in_cluster();
  const int row0 = (blockIdx.x / C) * BM;
  const int ks = round_up(k, BK) / BK, gn = cdiv(n, BN);
  const int chunks = cdiv(ks, KC);
  const int nt = rank < gn ? cdiv(gn - rank, C) : 0;  // column tiles rank, rank + C
  // A chunk's slot: its wide A slot, then this CTA's B tiles (KC steps
  // each), sized for the most tiles a CTA of the cluster has so every CTA's
  // A slots sit at the same offsets; then the mbarriers.
  const size_t chunk_bytes = (size_t)KC * SLOT * (1 + cdiv(gn, C));
  auto apart = [&](int ch) { return smem + (ch % S) * chunk_bytes; };
  auto bpart = [&](int ch, int u, int s) {
    return apart(ch) + (size_t)KC * SLOT * (1 + u) + s * SLOT;
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * chunk_bytes);
  uint64_t* spent = full + S;
  float acc[STRIPE_TILES][TM][TN];
#pragma unroll
  for (int u = 0; u < STRIPE_TILES; ++u) zero(acc[u]);
  auto compute = [&](int ch) {
    const int steps = min(KC, ks - ch * KC);
    if (row0 + wrow() >= m) return;  // warp-uniform
    for (int s = 0; s < steps; ++s)
#pragma unroll
      for (int u = 0; u < STRIPE_TILES; ++u)
        if (u < nt)
          step(acc[u], sbase + (uint32_t)(apart(ch) - smem), BM,
               sbase + (uint32_t)(bpart(ch, u, s) - smem), s * BK);
  };

  if constexpr (TMA) {
    auto issue = [&](int ch) {  // the producer
      const int sl = ch % S;
      if (ch >= S) mbar_wait<true>(&spent[sl], (ch / S - 1) & 1);
      mbar_expect(&full[sl], (uint32_t)(KC * SLOT * (1 + nt)));
      for (int p = rank; p < PIECES; p += C)
        tma_multicast(apart(ch) + p * 8 * 128, map_a, ch * KC * BK, row0 + p * 8, &full[sl],
                      (uint16_t)((1u << C) - 1));
      for (int u = 0; u < nt; ++u)
        tma_load(bpart(ch, u, 0), map_b, (rank + u * C) * BN, ch * KC * BK, &full[sl]);
    };
    if (threadIdx.x == 0) {
      for (int i = 0; i < S; ++i) {
        mbar_init(&full[i], 1);
        mbar_init(&spent[i], C);
      }
      mbar_init_fence();
    }
    cluster_arrive();  // every CTA's mbarriers exist before any copy lands
    cluster_wait();
    if (threadIdx.x == THREADS) {
      for (int ch = 0; ch < chunks; ++ch) issue(ch);
    } else if (threadIdx.x < THREADS) {
      for (int ch = 0; ch < chunks; ++ch) {
        mbar_wait(&full[ch % S], (ch / S) & 1);
        compute(ch);
        // the 8 computing warps are done with chunk ch's slot
        asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
        if (threadIdx.x < C) mbar_arrive_peer(&spent[ch % S], threadIdx.x);
      }
    }
    __syncwarp();
  } else {
    const int per = VECS / C, lo = rank * per;  // A vectors a CTA loads
    auto load_own = [&](int ch) {
      const int s0 = ch * KC, steps = min(KC, ks - s0);
      for (int v = lo + threadIdx.x; v < lo + per; v += THREADS) {
        const int r = v / 8, cc = (v % 8) * 8;
        load8<false>(apart(ch) + b_off(r, cc), a, k, m, k, row0 + r, s0 * BK + cc);
      }
      for (int u = 0; u < nt; ++u)
        for (int s = 0; s < steps; ++s)
          load_slot<false, 64>(bpart(ch, u, s), b, n, k, n, (s0 + s) * BK,
                               (rank + u * C) * BN, BK);
    };
    // The other CTAs' parts of chunk ch's A (vector v from CTA v / per, at
    // the same offset: a part is whole swizzled rows).
    auto copy_peers = [&](int ch) {
      unsigned char* dst = apart(ch);
      uint4 v[VECS / THREADS];
#pragma unroll
      for (int j = 0; j < VECS / THREADS; ++j) {
        const int i = threadIdx.x + j * THREADS;
        if (i / per != rank) v[j] = ld_peer(peer(dst + i * 16, i / per));
      }
#pragma unroll
      for (int j = 0; j < VECS / THREADS; ++j) {
        const int i = threadIdx.x + j * THREADS;
        if (i / per != rank) *reinterpret_cast<uint4*>(dst + i * 16) = v[j];
      }
    };
    // Chunk ch + AHEAD's own loads go into the slot chunk ch - 2 left: this
    // CTA consumed it before the last __syncthreads, and every other CTA
    // copied from it before arriving at the barrier this CTA last waited on.
    for (int ch = 0; ch < AHEAD; ++ch) {
      if (ch < chunks) load_own(ch);
      tc::cp_async_commit();
    }
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch + AHEAD < chunks) load_own(ch + AHEAD);
      tc::cp_async_commit();
      tc::cp_async_wait<AHEAD>();  // this CTA's part of chunk ch has landed
      cluster_arrive();            // ... and its reads of chunk ch - 1 are done
      if (ch > 0) compute(ch - 1);
      cluster_wait();  // every part of chunk ch has landed
      copy_peers(ch);
      __syncthreads();
    }
    compute(chunks - 1);
    tc::cp_async_wait<0>();
  }
  cluster_arrive();
  if (threadIdx.x < THREADS)
#pragma unroll
    for (int u = 0; u < STRIPE_TILES; ++u)
      if (u < nt) store_tile<true>(c, acc[u], row0, (rank + u * C) * BN, m, n, e);
  cluster_wait();  // no CTA of the cluster still reads or writes this one
}

// Launches `kernel` on `ctas` CTAs of `threads` in clusters of `cluster`,
// with `smem` bytes of dynamic shared memory; refuses a cluster the card
// cannot place.
template <class... Params, class... Args>
int launch_in_clusters(void (*kernel)(Params...), int ctas, int threads,
                       int cluster, size_t smem, cudaStream_t stream,
                       Args... args) {
  if (smem > MAX_SMEM || cluster < 1 || cluster > MAX_CLUSTER) return REPRO_BAD_ARGUMENT;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int placed = 0;
  err = cudaOccupancyMaxActiveClusters(&placed, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (placed < 1) return REPRO_NO_CLUSTER;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return launch_status();
}

// The sweep a walk splits: row tiles (WALK_M) or column tiles (WALK_N).
inline int sweep_tiles(int walk, int m, int n) {
  return walk == WALK_M ? cdiv(m, BM) : cdiv(n, BN);
}

// Launches B4's cluster walk, reporting it as tile `code` with its shared
// memory, CTAs and cluster size.
template <int WALK, bool A_RES, int B_RES>
int launch_walk(const void* a, const void* b, void* c, int m, int n, int k,
                const Epi& e, cudaStream_t s, Took* took, int code) {
  const int anchors = WALK == WALK_M ? cdiv(n, BN) : cdiv(m, BM);
  const int g = sweep_tiles(WALK, m, n);
  const int C = cluster_size(anchors, g, 1);
  int ring = 0;
  const size_t smem = walk_smem<WALK, A_RES, B_RES>(m, n, k, &ring);
  const bool streams = WALK == WALK_M || !A_RES || B_RES == B_STREAMED;
  if (smem > MAX_SMEM || (streams && ring < 2) || (size_t)anchors * C > 0x7fffffff)
    return REPRO_BAD_ARGUMENT;
  if (took) *took = {code, (int)smem, anchors * C, C};
  const auto* ah = static_cast<const __nv_bfloat16*>(a);
  const auto* bh = static_cast<const __nv_bfloat16*>(b);
  const bool vec = vec_ok<__nv_bfloat16>(a, b, n, k);
  const bool full_a = !(WALK == WALK_N && A_RES) || min(BM, round_up(m, TM)) == BM;
  if (vec && full_a) {
    // two k steps a streamed box where the ring holds 4 slots of one
    const int depth = streams && ring >= 4 ? 2 : 1;
    const bool stream_a = WALK == WALK_M || !A_RES;
    CUtensorMap ma, mb;
    const int rc = make_maps(&ma, &mb, a, b, m, n, k,
                             stream_a ? BK : depth * BK, stream_a && depth == 2);
    if (rc) return rc;
    return launch_in_clusters(walk_tma_kernel<WALK, A_RES, B_RES>, anchors * C,
                              TMA_THREADS, C, smem, s, c, m, n, k, e, ring, ma, mb);
  }
  if (vec)
    return launch_in_clusters(walk_cluster_kernel<true, WALK, A_RES, B_RES>,
                              anchors * C, THREADS, C, smem, s, ah, bh, c, m, n,
                              k, e, ring);
  return launch_in_clusters(walk_cluster_kernel<false, WALK, A_RES, B_RES>,
                            anchors * C, THREADS, C, smem, s, ah, bh, c, m, n, k,
                            e, ring);
}

// Shared memory of B5a's and B5b's cluster kernels over a sweep of `tiles`
// row (B5a) or column (B5b) tiles: STRIPE_SLOTS chunks of STRIPE_KC k steps
// of the multicast operand and of the busiest CTA's streamed tiles, and the
// mbarriers. matmul_df.stripe_cluster_smem mirrors it.
inline size_t stripe_smem(int tiles, int cluster) {
  return (size_t)STRIPE_SLOTS * STRIPE_KC * SLOT * (1 + cdiv(tiles, cluster)) +
         bar_bytes(STRIPE_SLOTS);
}

// B5a's cluster size for an (m, n) output: enough CTAs that none owns more
// than STRIPE_TILES row tiles. A stripe that one CTA could hold (the
// reference's feasibility) takes at most 8, so a CTA's part of a chunk's
// weight rows is whole 1024-byte swizzle rows, as the TMA's 128-byte
// swizzle needs; matmul_ws_stripe.cu refuses more.
inline int ws_stripe_cluster(int m, int n) {
  const int gm = cdiv(m, BM);
  return cluster_size(cdiv(n, BN), gm, pow2_ceil(cdiv(gm, STRIPE_TILES)));
}

// B5b's: enough CTAs that none owns more than STRIPE_TILES column tiles. It
// takes a stripe of 2 to STRIPE_TILES * MAX_CLUSTER column tiles (more are
// feasible only below 64 rows, and keep the one-CTA kernel); A's 8-row pieces
// go to CTAs r < 8 of a larger cluster.
inline bool is_stripe_on_cluster(int n) {
  const int gn = cdiv(n, BN);
  return gn >= 2 && gn <= STRIPE_TILES * MAX_CLUSTER;
}
inline int is_stripe_cluster(int m, int n) {
  const int gn = cdiv(n, BN);
  return cluster_size(cdiv(m, BM), gn, pow2_ceil(cdiv(gn, STRIPE_TILES)));
}

}  // namespace cl

// Each library compiles its cluster walks in a translation unit of their own
// (-DREPRO_PART, kernels/_build.py): the entry point's unit declares them
// with GEMM_CLUSTER_EXTERN, that part defines them with GEMM_CLUSTER_DEFINE.
#define GEMM_CLUSTER_SIGNATURE(WALK, A_RES, B_RES)                              \
  int cl::launch_walk<WALK, A_RES, B_RES>(const void*, const void*, void*, int, \
                                          int, int, const Epi&, cudaStream_t,   \
                                          Took*, int)
#define GEMM_CLUSTER_EXTERN(WALK, A_RES, B_RES) \
  extern template GEMM_CLUSTER_SIGNATURE(WALK, A_RES, B_RES);
#define GEMM_CLUSTER_DEFINE(WALK, A_RES, B_RES) \
  template GEMM_CLUSTER_SIGNATURE(WALK, A_RES, B_RES);

// A resident walk of B1 or B4: for bf16 operands over a sweep of two tiles
// or more the cluster walk (reported as tile `code`), else gemm_common.cuh's
// walk, in which one CTA walks the sweep.
template <typename T, int WB, int WALK, bool A_RES, int B_RES>
int launch_resident(const void* a, const void* b, const void* b_hi, void* c,
                    int m, int n, int k, const Epi& e, cudaStream_t s,
                    Took* took, int code) {
  if constexpr (kTC<T>) {
    if (cl::sweep_tiles(WALK, m, n) >= 2)
      return cl::launch_walk<WALK, A_RES, B_RES>(a, b, c, m, n, k, e, s, took, code);
  }
  return launch_walk<T, WB, WALK, A_RES, B_RES>(a, b, b_hi, c, m, n, k, e, s);
}

}  // namespace gemm
