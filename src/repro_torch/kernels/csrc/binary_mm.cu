// B9: the binary (+-1) GEMM on bit-packed words, with the fused binary
// epilogue.
//
// Replaces the TPU kernel repro/kernels/binary_mm.py `_binary_kernel` (built
// by `binary_mm_df`): A (M, Kp) and B (Kp, N) hold 32 binary channels per
// 32-bit word (bit 1 = +1), and each output is the exact +-1 dot product
// dot = n_bits - 2 * sum_k popc(a[m,k] xor b[k,n]), counted in an int32
// accumulator held in registers across the whole packed reduction. Words
// past Kp, rows past M and columns past N read as 0 on both sides, xor to 0
// and drop out of the count, so ragged shapes are masked, never padded.
//
// The BinaryEpilogue runs at the flush, in float32, each stage rounded on
// its own (__fmul_rn / __fadd_rn: nothing contracts into an FMA):
//   y = scale * dot + bias + residual;  out = binarize ? (y >= 0 ? +1 : -1) : y
// with scale per tensor (1, 1) or per column (1, N). Outputs: the raw dot as
// int32 (or its float image), +-1 as int8 (or any other type), y as f32 or
// bf16. The plain PyTorch version (kernels/ref.py binary_matmul_fused_ref)
// rounds the same stages the same way, so the two agree bit for bit.
//
// Dataflows (spec anchor; the reference's kernel reads no auxiliary
// residency, and neither does this one):
//   OS (the basic launch, serving's): one of two tiles on Hopper's binary
//     tensor cores (mma.sync m16n8k256 .b1 .and.popc, mma_common.cuh), the
//     prefill tile for M > 16 and the decode tile for M <= 16; the launch
//     reports the tile it took (Took), which the Python planner holds
//     against its own copy (binary_mm.plan).
//   WS (WALK_M): CTA j holds B's column stripe (Kp, 64) in shared memory,
//     fetched once, and walks the row tiles i, streaming A.
//   IS (WALK_N): CTA i holds A's row stripe (64, Kp), fetched once, and walks
//     the column tiles j, streaming B.
// A stripe that does not fit a block's 227 KB is refused (the Python planner
// says so first, naming the bytes). The result is exact integer arithmetic,
// so every anchor and both tiles give the same bits.
//
// The walks (WS, IS) run on the CUDA cores: a word pair costs a xor, a popc
// and an add, 4 x 4 outputs a thread. The tiles count popc(a AND b) on the
// tensor cores, 256 channels of a 16 x 8 block per mma, and turn it into the
// xor count with popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b): each
// warp adds the popcounts of the A and B fragment words it already holds
// (one popc per word, on the CUDA cores; a row's and a column's sums are
// taken over the 4 lanes that hold them), so no operand is read twice.
// sm_90a has no XOR form in hardware: ptxas takes mma ... .xor.popc but
// emits BMMA.168256.AND.POPC for it, and a tile built on it ran 15-50%
// slower than the AND form with these popcounts (PERF.md).
//
// Prefill tile (bin_prefill_kernel): a CTA owns 64 x 64 outputs (768 CTAs
// at the served up projection, M = 511, N = 6144), its 8 warps each 16 x 32
// (1 x 4 mma tiles). A and B stream through a 3-stage cp.async ring of
// 32-word (1024-channel) k stages: A rows k-contiguous, padded to 36 words so
// the ldmatrix.x4 rows of a fragment land on distinct banks (an 8 x 8 b16
// matrix is 8 rows of 4 words: lane 4g + t gets word t of row g, the b1 A
// fragment as it is); B as it lies in device memory, (k, n) rows padded to
// 72 words, its fragments read as plain words (bank 8t + g: conflict-free).
// The weights keep the reference's (Kp, N) layout. The flushed tile is
// staged in the consumed ring and written 16 bytes a thread: the up
// projection's 3.1 M int8 outputs stored a byte a lane cost 16% more. Of the
// variants swept (bench/binary_sweep.cu: 64 x 64 on 2 x 2, 4 x 2, 2 x 4 and
// 4 x 4 warps, 128 x 32, 32 x 128 and 128 x 128, 16- to 64-word stages, 3 or
// 4 stages) none was faster at both served projections.
//
// Decode tile (bin_decode_kernel): M <= 16 rows are one m16 block (rows past
// M read as zero words and are never stored). A CTA owns 16 columns (384
// CTAs at N = 6144, 128 at N = 2048: the 132 SMs are filled), and its 8 warps
// split the 256-channel k steps between them (warp w takes steps w, w + 8,
// ...), loading their fragments straight from device memory, two steps in
// flight; the int32 partial counts meet in shared memory (exact in any
// order). The 1.5 MB weight of either served projection bounds it (0.47 us
// at 3.35 TB/s); an empty kernel takes ~5 us by the same timing, and of the
// variants swept (8 to 32 columns, 4 to 16 warps, 1 to 4 steps in flight)
// none was more than ~1 us faster at both projections.
#include "mma_common.cuh"

namespace bin {

constexpr int BM = 64, BN = 64, BKW = 16;  // output tile; words per k step
constexpr int TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int LD = BM + 4;                      // BM == BN: one stride for both
constexpr int TILE_WORDS = BKW * LD;
constexpr size_t MAX_SMEM = 232448;
constexpr int A_IT = BM * BKW / THREADS, B_IT = BKW * BN / THREADS;

enum Walk { WALK_NONE = 0, WALK_M = 1, WALK_N = 2 };
enum ScaleMode { SCALE_NONE = 0, SCALE_TENSOR = 1, SCALE_COL = 2 };

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return cdiv(a, b) * b; }

struct Epi {
  int n_bits;
  const float* scale;
  int scale_mode;
  const float* bias;
  const float* residual;  // (M, N) float32
  int binarize;
  int out_dtype;
};

__device__ __forceinline__ int ty() { return threadIdx.x / (BN / TN); }
__device__ __forceinline__ int tx() { return threadIdx.x % (BN / TN); }

__device__ __forceinline__ void store_float(void* out, size_t at, float y,
                                            int dtype) {
  if (dtype == REPRO_BF16) static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(y);
  else static_cast<float*>(out)[at] = y;
}

__device__ __forceinline__ void store_int(void* out, size_t at, int v, int dtype) {
  switch (dtype) {
    case REPRO_I8: static_cast<int8_t*>(out)[at] = (int8_t)v; break;
    case REPRO_I32: static_cast<int*>(out)[at] = v; break;
    default: store_float(out, at, __int2float_rn(v), dtype);
  }
}

// The flush of output (r, c), written to element `at` of `out` (the output,
// or a tile staged in shared memory).
__device__ __forceinline__ void flush_to(void* out, size_t at, int pops, int r,
                                         int c, int n, const Epi& e) {
  const int dot = e.n_bits - 2 * pops;
  if (!e.scale_mode && !e.bias && !e.residual && !e.binarize) {
    store_int(out, at, dot, e.out_dtype);
    return;
  }
  float y = __int2float_rn(dot);
  if (e.scale_mode == SCALE_TENSOR) y = __fmul_rn(y, e.scale[0]);
  else if (e.scale_mode == SCALE_COL) y = __fmul_rn(y, e.scale[c]);
  if (e.bias) y = __fadd_rn(y, e.bias[c]);
  if (e.residual) y = __fadd_rn(y, e.residual[(size_t)r * n + c]);
  if (e.binarize) store_int(out, at, y >= 0.f ? 1 : -1, e.out_dtype);
  else store_float(out, at, y, e.out_dtype);
}

// The flush of one output element.
__device__ __forceinline__ void flush(void* out, int pops, int r, int c, int n,
                                      const Epi& e) {
  flush_to(out, (size_t)r * n + c, pops, r, c, n, e);
}

__host__ __device__ constexpr int dtype_bytes(int dtype) {
  return dtype == REPRO_I8 ? 1 : dtype == REPRO_BF16 ? 2 : 4;
}

// A streamed (BM x BKW) tile of A, stored k-major (as[kw * LD + r]).
struct ATile {
  uint32_t r[A_IT];
  __device__ __forceinline__ void fetch(const uint32_t* a, int m, int kp,
                                        int row0, int k0) {
#pragma unroll
    for (int it = 0; it < A_IT; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int gr = row0 + i / BKW, gk = k0 + i % BKW;
      r[it] = (gr < m && gk < kp) ? a[(size_t)gr * kp + gk] : 0u;
    }
  }
  __device__ __forceinline__ void stash(uint32_t* as) const {
#pragma unroll
    for (int it = 0; it < A_IT; ++it) {
      const int i = threadIdx.x + it * THREADS;
      as[(i % BKW) * LD + i / BKW] = r[it];
    }
  }
};

// A streamed (BKW x BN) tile of B.
struct BTile {
  uint32_t r[B_IT];
  __device__ __forceinline__ void fetch(const uint32_t* b, int kp, int n,
                                        int k0, int col0) {
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int gk = k0 + i / BN, gc = col0 + i % BN;
      r[it] = (gk < kp && gc < n) ? b[(size_t)gk * n + gc] : 0u;
    }
  }
  __device__ __forceinline__ void stash(uint32_t* bs) const {
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int i = threadIdx.x + it * THREADS;
      bs[(i / BN) * LD + i % BN] = r[it];
    }
  }
};

// The whole packed reduction of the output tile at (row0, col0) into acc.
// A comes from the streamed tile `as` or, when A_RES, from the resident row
// stripe (same layout, kpp rows deep); B likewise. Ends with a barrier, so
// the caller may refill the tiles right after.
template <bool A_RES, bool B_RES>
__device__ __forceinline__ void tile_kloop(int acc[TM][TN], const uint32_t* a,
                                           const uint32_t* b, int m, int n,
                                           int kp, int row0, int col0,
                                           uint32_t* as, uint32_t* bs) {
  ATile at;
  BTile bt;
  const int kpp = round_up(kp, BKW);
  // Warps whose rows all lie past M (decode: M = 4) skip the popcounts.
  const bool live = row0 + ty() * TM < m;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  if (!A_RES) at.fetch(a, m, kp, row0, 0);
  if (!B_RES) bt.fetch(b, kp, n, 0, col0);
  if (!A_RES) at.stash(as);
  if (!B_RES) bt.stash(bs);
  __syncthreads();
  for (int k0 = 0; k0 < kpp; k0 += BKW) {
    const bool more = k0 + BKW < kpp;
    if (more) {  // in flight while this step is consumed
      if (!A_RES) at.fetch(a, m, kp, row0, k0 + BKW);
      if (!B_RES) bt.fetch(b, kp, n, k0 + BKW, col0);
    }
    const uint32_t* ab = (A_RES ? as + k0 * LD : as) + ty() * TM;
    const uint32_t* bb = (B_RES ? bs + k0 * LD : bs) + tx() * TN;
    if (live) {
#pragma unroll
      for (int kw = 0; kw < BKW; ++kw) {
        const uint4 av = *reinterpret_cast<const uint4*>(ab + kw * LD);
        const uint4 bv = *reinterpret_cast<const uint4*>(bb + kw * LD);
        const uint32_t aw[TM] = {av.x, av.y, av.z, av.w};
        const uint32_t bw[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += __popc(aw[i] ^ bw[j]);
      }
    }
    __syncthreads();
    if (more && !(A_RES && B_RES)) {
      if (!A_RES) at.stash(as);
      if (!B_RES) bt.stash(bs);
      __syncthreads();
    }
  }
}

__device__ __forceinline__ void store_tile(void* out, const int acc[TM][TN],
                                           int row0, int col0, int m, int n,
                                           const Epi& e) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty() * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx() * TN + j;
      if (c < n) flush(out, acc[i][j], r, c, n, e);
    }
  }
}

// Shared memory of a walk (WS, IS), in bytes: one streamed tile and the
// resident stripe, kpp words deep. The Python planner (binary_mm.plan)
// computes the same sum.
__host__ __device__ constexpr size_t walk_smem(int kp) {
  return ((size_t)TILE_WORDS + (size_t)round_up(kp, BKW) * LD) * 4;
}

template <int WALK>
__global__ void __launch_bounds__(THREADS)
binary_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              void* __restrict__ out, int m, int n, int kp, Epi e) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int kpp = round_up(kp, BKW);
  uint32_t* as = smem;
  uint32_t* bs = as + (WALK == WALK_N ? kpp * LD : TILE_WORDS);
  int acc[TM][TN];
  if (WALK == WALK_M) {  // WS: B's column stripe resident, walk i
    const int col0 = blockIdx.x * BN;
    for (int i = threadIdx.x; i < kpp * BN; i += THREADS) {
      const int kw = i / BN, c = i % BN;
      bs[kw * LD + c] = (kw < kp && col0 + c < n) ? b[(size_t)kw * n + col0 + c] : 0u;
    }
    __syncthreads();
    for (int row0 = 0; row0 < m; row0 += BM) {
      tile_kloop<false, true>(acc, a, b, m, n, kp, row0, col0, as, bs);
      store_tile(out, acc, row0, col0, m, n, e);
    }
  } else {  // IS: A's row stripe resident, walk j
    const int row0 = blockIdx.x * BM;
    for (int i = threadIdx.x; i < BM * kpp; i += THREADS) {
      const int r = i / kpp, kw = i % kpp;
      as[kw * LD + r] = (row0 + r < m && kw < kp) ? a[(size_t)(row0 + r) * kp + kw] : 0u;
    }
    __syncthreads();
    for (int col0 = 0; col0 < n; col0 += BN) {
      tile_kloop<true, false>(acc, a, b, m, n, kp, row0, col0, as, bs);
      store_tile(out, acc, row0, col0, m, n, e);
    }
  }
}

template <int WALK>
int launch_walk(const void* a, const void* b, void* out, int m, int n, int kp,
                const Epi& e, cudaStream_t stream) {
  const size_t smem = walk_smem(kp);
  if (smem > MAX_SMEM) return REPRO_BAD_ARGUMENT;
  auto kernel = binary_kernel<WALK>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid = WALK == WALK_M ? dim3(cdiv(n, BN)) : dim3(cdiv(m, BM));
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const uint32_t*>(a),
                                          static_cast<const uint32_t*>(b), out,
                                          m, n, kp, e);
  return launch_status();
}

// ---------------------------------------------------------------------------
// The basic OS launch on the binary tensor cores.
// ---------------------------------------------------------------------------

// The tile a basic OS launch took, reported to the caller as three ints
// (kernels/_build.py BINARY_TILES[tile - 1]): its code, dynamic shared memory
// bytes and CTAs.
enum TileCode { TILE_WALK = 0, TILE_PREFILL = 1, TILE_DECODE = 2 };
struct Took {
  int tile, smem, ctas;
};

__device__ __forceinline__ int popc_sum(uint32_t x, uint32_t y) {
  return __popc(x) + __popc(y);
}

// x summed over the 4 lanes of a quad (the lanes t = 0..3 of one group g).
__device__ __forceinline__ int quad_sum(int x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The popcounts the AND form needs beside its counts: per lane, those of
// the A words of rows g and g + 8 and of the B words of column g it holds.
template <int MI, int NI>
struct OperandPops {
  int a[MI][2], b[NI];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) a[mi][0] = a[mi][1] = 0;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) b[ni] = 0;
  }
  __device__ __forceinline__ void add_a(int mi, const uint32_t f[4]) {
    a[mi][0] += popc_sum(f[0], f[2]);
    a[mi][1] += popc_sum(f[1], f[3]);
  }
  __device__ __forceinline__ void add_b(int ni, const uint32_t f[2]) {
    b[ni] += popc_sum(f[0], f[1]);
  }
  // Whole rows and columns (over the quad), then this lane's four outputs
  // of tile (mi, ni) turned from AND counts into xor counts: columns 2t and
  // 2t + 1 have their sums in groups 2t and 2t + 1. Every lane must call.
  __device__ __forceinline__ void reduce() {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      a[mi][0] = quad_sum(a[mi][0]);
      a[mi][1] = quad_sum(a[mi][1]);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) b[ni] = quad_sum(b[ni]);
  }
  __device__ __forceinline__ void to_xor(int mi, int ni, int c[4]) const {
    const int t = threadIdx.x & 3;
    const int b0 = __shfl_sync(0xffffffffu, b[ni], 8 * t);
    const int b1 = __shfl_sync(0xffffffffu, b[ni], 8 * t + 4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = a[mi][j >> 1] + ((j & 1) ? b1 : b0) - 2 * c[j];
  }
};

// A prefill tile: TBM x TBN outputs a CTA, WM x WN warps (each MI x NI
// mma tiles of 16 x 8), KW-word (32 KW-channel) stages through a
// STAGES-deep ring; A rows padded to KW + 4 words (ldmatrix rows on
// distinct banks), B rows to TBN + 8 (fragment words on distinct banks).
template <int TBM_, int TBN_, int KW_, int STAGES_, int WM_, int WN_>
struct PrefillCfg {
  static constexpr int TBM = TBM_, TBN = TBN_, KW = KW_, STAGES = STAGES_;
  static constexpr int WM = WM_, WN = WN_, NT = WM * WN * 32;
  static constexpr int MI = TBM / WM / 16, NI = TBN / WN / 8;
  static constexpr int A_LD = KW + 4, B_LD = TBN + 8;
  static constexpr int A_STAGE = TBM * A_LD, B_STAGE = KW * B_LD;
  static constexpr size_t SMEM = (size_t)STAGES * (A_STAGE + B_STAGE) * 4;
  static_assert(KW % 8 == 0 && MI >= 1 && NI >= 1, "whole mma tiles");
  static_assert(SMEM >= (size_t)TBM * TBN * 4, "the output tile fits the ring");
};

// A decode tile: M <= 16 rows, TBN columns a CTA (TBN / 8 mma tiles),
// WARPS warps taking the 8-word k steps in turn, UNROLL steps of a warp in
// flight; the warps' int32 partial counts meet in shared memory.
template <int TBN_, int WARPS_, int UNROLL_>
struct DecodeCfg {
  static constexpr int TBN = TBN_, WARPS = WARPS_, UNROLL = UNROLL_;
  static constexpr int NT = WARPS * 32, NI = TBN / 8, MAX_M = 16;
  static constexpr size_t SMEM = (size_t)WARPS * MAX_M * TBN * 4;
  static_assert(NI >= 1 && NT >= MAX_M * TBN, "a thread per output at the flush");
};

// One ring stage: A rows row0.. (TBM x KW words from word k0) and B's k rows
// k0.. (KW x TBN words from column col0); zeros outside the operands. VEC:
// 16-byte cp.async (Kp and N multiples of 4, 16-byte aligned operands);
// else element loads into the same layout.
template <class C, bool VEC>
__device__ __forceinline__ void load_stage(uint32_t* as, uint32_t* bs,
                                           const uint32_t* a,
                                           const uint32_t* b, int m, int n,
                                           int kp, int row0, int col0,
                                           int k0) {
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < C::TBM * C::KW / 4; i += C::NT) {
      const int r = i / (C::KW / 4), c = (i % (C::KW / 4)) * 4;
      const bool in = row0 + r < m && k0 + c < kp;
      tc::cp_async16(as + r * C::A_LD + c, in ? a + (size_t)(row0 + r) * kp + k0 + c : a, in);
    }
    for (int i = threadIdx.x; i < C::KW * C::TBN / 4; i += C::NT) {
      const int kw = i / (C::TBN / 4), c = (i % (C::TBN / 4)) * 4;
      const bool in = k0 + kw < kp && col0 + c < n;
      tc::cp_async16(bs + kw * C::B_LD + c, in ? b + (size_t)(k0 + kw) * n + col0 + c : b, in);
    }
  } else {
    for (int i = threadIdx.x; i < C::TBM * C::KW; i += C::NT) {
      const int r = i / C::KW, c = i % C::KW;
      as[r * C::A_LD + c] = (row0 + r < m && k0 + c < kp) ? a[(size_t)(row0 + r) * kp + k0 + c] : 0u;
    }
    for (int i = threadIdx.x; i < C::KW * C::TBN; i += C::NT) {
      const int kw = i / C::TBN, c = i % C::TBN;
      bs[kw * C::B_LD + c] = (k0 + kw < kp && col0 + c < n) ? b[(size_t)(k0 + kw) * n + col0 + c] : 0u;
    }
  }
}

// A flushed TBM x TBN tile of `elt`-byte outputs, staged row-major in
// shared memory, written to rows row0.. and columns col0.. of out (m, n):
// 16 bytes a thread where whole rows of out are 16-byte aligned, else an
// element at a time.
template <class C>
__device__ __forceinline__ void write_tile(void* out, const void* staged,
                                           int row0, int col0, int m, int n,
                                           int elt) {
  auto* o = static_cast<unsigned char*>(out);
  const auto* tile = static_cast<const unsigned char*>(staged);
  const int row_bytes = C::TBN * elt;
  if ((size_t)n * elt % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    const int chunks = row_bytes / 16;
    for (int i = threadIdx.x; i < C::TBM * chunks; i += C::NT) {
      const int rl = i / chunks, cb = (i % chunks) * 16;
      if (row0 + rl < m && col0 + cb / elt < n)
        *reinterpret_cast<uint4*>(o + ((size_t)(row0 + rl) * n + col0) * elt + cb) =
            *reinterpret_cast<const uint4*>(tile + rl * row_bytes + cb);
    }
    return;
  }
  for (int i = threadIdx.x; i < C::TBM * C::TBN; i += C::NT) {
    const int rl = i / C::TBN, cl = i % C::TBN;
    if (row0 + rl >= m || col0 + cl >= n) continue;
    unsigned char* dst = o + ((size_t)(row0 + rl) * n + col0 + cl) * elt;
    const unsigned char* src = tile + (rl * C::TBN + cl) * elt;
    for (int b = 0; b < elt; ++b) dst[b] = src[b];
  }
}

template <class C, bool VEC>
__global__ void __launch_bounds__(C::NT)
bin_prefill_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, void* __restrict__ out,
                   int m, int n, int kp, Epi e) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int MI = C::MI, NI = C::NI;
  const int row0 = blockIdx.y * C::TBM, col0 = blockIdx.x * C::TBN;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  const int wr = (warp / C::WN) * (C::TBM / C::WM), wc = (warp % C::WN) * (C::TBN / C::WN);
  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;
  OperandPops<MI, NI> pops;
  pops.zero();
  const int steps = cdiv(kp, C::KW);
  auto load = [&](int s) {
    uint32_t* as = smem + (s % C::STAGES) * (C::A_STAGE + C::B_STAGE);
    load_stage<C, VEC>(as, as + C::A_STAGE, a, b, m, n, kp, row0, col0, s * C::KW);
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps) load(s);
    tc::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<C::STAGES - 2>();  // stage s has landed
    __syncthreads();                     // and stage s - 1's slot is consumed
    if (s + C::STAGES - 1 < steps) load(s + C::STAGES - 1);
    tc::cp_async_commit();
    const uint32_t* as = smem + (s % C::STAGES) * (C::A_STAGE + C::B_STAGE);
    const uint32_t* bs = as + C::A_STAGE;
    // Zero words past Kp add nothing to any count, so the last stage runs
    // whole.
#pragma unroll
    for (int ks = 0; ks < C::KW / 8; ++ks) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        tc::ldmatrix_x4(af[mi], as + (wr + mi * 16 + (l & 7) + ((l >> 3) & 1) * 8) * C::A_LD +
                                    ks * 8 + (l >> 4) * 4);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        bf[ni][0] = bs[(ks * 8 + t) * C::B_LD + wc + ni * 8 + g];
        bf[ni][1] = bs[(ks * 8 + 4 + t) * C::B_LD + wc + ni * 8 + g];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) tc::mma_b1_and(acc[mi][ni], af[mi], bf[ni]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) pops.add_a(mi, af[mi]);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) pops.add_b(ni, bf[ni]);
    }
  }
  tc::cp_async_wait<0>();
  pops.reduce();
  // The flushed tile is written to the (consumed) ring first, then out in
  // 16-byte rows.
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      pops.to_xor(mi, ni, acc[mi][ni]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = wr + mi * 16 + g + (j >> 1) * 8;
        const int cl = wc + ni * 8 + 2 * t + (j & 1);
        const int r = row0 + rl, c = col0 + cl;
        if (r >= m || c >= n) continue;
        flush_to(smem, rl * C::TBN + cl, acc[mi][ni][j], r, c, n, e);
      }
    }
  __syncthreads();
  write_tile<C>(out, smem, row0, col0, m, n, dtype_bytes(e.out_dtype));
}

template <class C>
__global__ void __launch_bounds__(C::NT)
bin_decode_kernel(const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ b, void* __restrict__ out,
                  int m, int n, int kp, Epi e) {
  constexpr int NI = C::NI, U = C::UNROLL;
  __shared__ int part[C::WARPS][C::MAX_M][C::TBN];
  const int col0 = blockIdx.x * C::TBN;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  const int steps = cdiv(kp, 8);
  const bool row_lo = g < m, row_hi = g + 8 < m;
  const uint32_t* a_lo = a + (size_t)g * kp;
  const uint32_t* a_hi = a + (size_t)(g + 8) * kp;
  int acc[NI][4];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[ni][j] = 0;
  OperandPops<1, NI> pops;
  pops.zero();
  for (int s0 = warp; s0 < steps; s0 += C::WARPS * U) {
    uint32_t af[U][4], bf[U][NI][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every load of the steps, then the mma
      const int kw = (s0 + u * C::WARPS) * 8 + t;  // words kw and kw + 4
      const bool k_lo = kw < kp, k_hi = kw + 4 < kp;
      af[u][0] = row_lo && k_lo ? __ldg(a_lo + kw) : 0u;
      af[u][1] = row_hi && k_lo ? __ldg(a_hi + kw) : 0u;
      af[u][2] = row_lo && k_hi ? __ldg(a_lo + kw + 4) : 0u;
      af[u][3] = row_hi && k_hi ? __ldg(a_hi + kw + 4) : 0u;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int c = col0 + ni * 8 + g;
        bf[u][ni][0] = k_lo && c < n ? __ldg(b + (size_t)kw * n + c) : 0u;
        bf[u][ni][1] = k_hi && c < n ? __ldg(b + (size_t)(kw + 4) * n + c) : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        tc::mma_b1_and(acc[ni], af[u], bf[u][ni]);
        pops.add_b(ni, bf[u][ni]);
      }
      pops.add_a(0, af[u]);
    }
  }
  // This warp's share of each output's xor count, from its k steps.
  pops.reduce();
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    pops.to_xor(0, ni, acc[ni]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[warp][g + (j >> 1) * 8][ni * 8 + 2 * t + (j & 1)] = acc[ni][j];
  }
  __syncthreads();
  if (threadIdx.x >= C::MAX_M * C::TBN) return;
  const int r = threadIdx.x / C::TBN, cc = threadIdx.x % C::TBN, c = col0 + cc;
  int count = 0;
#pragma unroll
  for (int w = 0; w < C::WARPS; ++w) count += part[w][r][cc];
  if (r < m && c < n) flush(out, count, r, c, n, e);
}

inline bool vec_ok(const void* a, const void* b, int n, int kp) {
  return kp % 4 == 0 && n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <class C, bool VEC>
int launch_prefill_cfg(const uint32_t* a, const uint32_t* b, void* out, int m,
                       int n, int kp, const Epi& e, cudaStream_t stream) {
  auto kernel = bin_prefill_kernel<C, VEC>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(cdiv(n, C::TBN), cdiv(m, C::TBM)), C::NT, C::SMEM, stream>>>(
      a, b, out, m, n, kp, e);
  return launch_status();
}

// The prefill tile C (any M) or the decode tile C (M <= 16); `took` names it.
template <class C>
int launch_prefill(const uint32_t* a, const uint32_t* b, void* out, int m,
                   int n, int kp, const Epi& e, cudaStream_t stream,
                   Took* took = nullptr) {
  if (cdiv(m, C::TBM) > 65535) return REPRO_BAD_ARGUMENT;
  if (took) *took = {TILE_PREFILL, (int)C::SMEM, cdiv(n, C::TBN) * cdiv(m, C::TBM)};
  return vec_ok(a, b, n, kp) ? launch_prefill_cfg<C, true>(a, b, out, m, n, kp, e, stream)
                             : launch_prefill_cfg<C, false>(a, b, out, m, n, kp, e, stream);
}
template <class C>
int launch_decode(const uint32_t* a, const uint32_t* b, void* out, int m,
                  int n, int kp, const Epi& e, cudaStream_t stream,
                  Took* took = nullptr) {
  if (m > C::MAX_M) return REPRO_BAD_ARGUMENT;
  const int ctas = cdiv(n, C::TBN);
  if (took) *took = {TILE_DECODE, (int)C::SMEM, ctas};
  bin_decode_kernel<C><<<ctas, C::NT, 0, stream>>>(a, b, out, m, n, kp, e);
  return launch_status();
}

// The tiles the basic OS launch takes (binary_mm.py's planner keeps a copy,
// PREFILL_TILE, PREFILL_STAGES, DECODE_TILE and DECODE_WARPS, checked
// against each launch's Took).
using Prefill = PrefillCfg<64, 64, 32, 3, 4, 2>;
using Decode = DecodeCfg<16, 8, 2>;

// The basic OS launch: the decode tile for M <= 16, else the prefill tile.
inline int launch_tile(const void* av, const void* bv, void* out, int m, int n,
                       int kp, const Epi& e, cudaStream_t stream, Took* took) {
  const auto* a = static_cast<const uint32_t*>(av);
  const auto* b = static_cast<const uint32_t*>(bv);
  if (m <= Decode::MAX_M) return launch_decode<Decode>(a, b, out, m, n, kp, e, stream, took);
  return launch_prefill<Prefill>(a, b, out, m, n, kp, e, stream, took);
}

}  // namespace bin

// walk: 0 OS (the tiles), 1 WS, 2 IS. scale_mode: 0 none, 1 (1, 1), 2 (1, N).
// took (may be null): the tile the launch took, its shared memory bytes and
// CTAs (bin::Took; all zero for a walk).
extern "C" int binary_mm(const void* a, const void* b, void* out, int m,
                         int n, int kp, int n_bits, int out_dtype,
                         const float* scale, int scale_mode, const float* bias,
                         const float* residual, int binarize, int walk,
                         int* took, void* stream) {
  using namespace bin;
  if (took) took[0] = took[1] = took[2] = 0;
  if (m <= 0 || n <= 0 || kp <= 0 || n_bits < 0 || n_bits > 32 * kp ||
      cdiv(m, BM) > 65535 || cdiv(n, BN) > 65535 || out_dtype < REPRO_F32 ||
      out_dtype > REPRO_I32 || scale_mode < SCALE_NONE ||
      scale_mode > SCALE_COL || (scale_mode != SCALE_NONE && !scale) ||
      walk < WALK_NONE || walk > WALK_N)
    return REPRO_BAD_ARGUMENT;
  const Epi e{n_bits, scale, scale_mode, bias, residual, binarize, out_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (walk == WALK_M) return launch_walk<WALK_M>(a, b, out, m, n, kp, e, s);
  if (walk == WALK_N) return launch_walk<WALK_N>(a, b, out, m, n, kp, e, s);
  return launch_tile(a, b, out, m, n, kp, e, s, reinterpret_cast<Took*>(took));
}
