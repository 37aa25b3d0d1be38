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
//   OS (WALK_NONE): one CTA per 64x64 output tile; 64x16-word A and
//     16x64-word B tiles stream through shared memory.
//   WS (WALK_M): CTA j holds B's column stripe (Kp, 64) in shared memory,
//     fetched once, and walks the row tiles i, streaming A.
//   IS (WALK_N): CTA i holds A's row stripe (64, Kp), fetched once, and walks
//     the column tiles j, streaming B.
// A stripe that does not fit a block's 227 KB is refused (the Python planner
// says so first, naming the bytes). The result is exact integer arithmetic,
// so every anchor gives the same bits.
//
// Bound on H100: the popcounts. A word pair costs a xor, a popc and an add;
// the CUDA cores issue 16 popc per SM per clock (a quarter of the integer
// rate), so at the served shapes (qwen3-1.7b's binary MLP: up M x 64 words ->
// 6144, down M x 192 words -> 2048) the kernel is bound by operations, not
// by the 32x smaller operand bytes. This version runs on the CUDA cores; the
// b1 tensor-core path (mma.sync ... .xor.popc) is later work.
#include "common.cuh"

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

// The flush of one output element.
__device__ __forceinline__ void flush(void* out, int pops, int r, int c, int n,
                                      const Epi& e) {
  const size_t at = (size_t)r * n + c;
  const int dot = e.n_bits - 2 * pops;
  if (!e.scale_mode && !e.bias && !e.residual && !e.binarize) {
    store_int(out, at, dot, e.out_dtype);
    return;
  }
  float y = __int2float_rn(dot);
  if (e.scale_mode == SCALE_TENSOR) y = __fmul_rn(y, e.scale[0]);
  else if (e.scale_mode == SCALE_COL) y = __fmul_rn(y, e.scale[c]);
  if (e.bias) y = __fadd_rn(y, e.bias[c]);
  if (e.residual) y = __fadd_rn(y, e.residual[at]);
  if (e.binarize) store_int(out, at, y >= 0.f ? 1 : -1, e.out_dtype);
  else store_float(out, at, y, e.out_dtype);
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

// Shared memory of a walk, in bytes: two streamed tiles (OS), or one
// streamed tile and the resident stripe, kpp words deep (WS, IS). The Python
// planner (binary_mm.plan) computes the same sum.
__host__ __device__ constexpr size_t walk_smem(int walk, int kp) {
  return walk == WALK_NONE
             ? 2 * (size_t)TILE_WORDS * 4
             : ((size_t)TILE_WORDS + (size_t)round_up(kp, BKW) * LD) * 4;
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
  if (WALK == WALK_NONE) {
    const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
    tile_kloop<false, false>(acc, a, b, m, n, kp, row0, col0, as, bs);
    store_tile(out, acc, row0, col0, m, n, e);
  } else if (WALK == WALK_M) {  // WS: B's column stripe resident, walk i
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
int launch(const void* a, const void* b, void* out, int m, int n, int kp,
           const Epi& e, cudaStream_t stream) {
  const size_t smem = walk_smem(WALK, kp);
  if (smem > MAX_SMEM) return REPRO_BAD_ARGUMENT;
  auto kernel = binary_kernel<WALK>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid = WALK == WALK_NONE ? dim3(cdiv(n, BN), cdiv(m, BM))
                    : WALK == WALK_M  ? dim3(cdiv(n, BN))
                                      : dim3(cdiv(m, BM));
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const uint32_t*>(a),
                                          static_cast<const uint32_t*>(b), out,
                                          m, n, kp, e);
  return launch_status();
}

}  // namespace bin

// walk: 0 OS, 1 WS, 2 IS. scale_mode: 0 none, 1 (1, 1), 2 (1, N).
extern "C" int binary_mm(const void* a, const void* b, void* out, int m,
                         int n, int kp, int n_bits, int out_dtype,
                         const float* scale, int scale_mode, const float* bias,
                         const float* residual, int binarize, int walk,
                         void* stream) {
  using namespace bin;
  if (m <= 0 || n <= 0 || kp <= 0 || n_bits < 0 || n_bits > 32 * kp ||
      cdiv(m, BM) > 65535 || cdiv(n, BN) > 65535 || out_dtype < REPRO_F32 ||
      out_dtype > REPRO_I32 || scale_mode < SCALE_NONE ||
      scale_mode > SCALE_COL || (scale_mode != SCALE_NONE && !scale) ||
      walk < WALK_NONE || walk > WALK_N)
    return REPRO_BAD_ARGUMENT;
  const Epi e{n_bits, scale, scale_mode, bias, residual, binarize, out_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (walk == WALK_M) return launch<WALK_M>(a, b, out, m, n, kp, e, s);
  if (walk == WALK_N) return launch<WALK_N>(a, b, out, m, n, kp, e, s);
  return launch<WALK_NONE>(a, b, out, m, n, kp, e, s);
}
