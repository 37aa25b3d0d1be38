// B8: the direct NHWC convolution with the fused epilogue.
//
// Replaces the TPU kernel repro/kernels/conv2d_df.py `_conv_kernel` (built by
// `conv2d_df`): x (N, H, W, Cin), w (fh, fw, Cin, Cout), VALID padding,
// stride s; out[n, oy, ox, co] = sum over (ky, kx, ci) of
// x[n, oy*s + ky, ox*s + kx, ci] * w[ky, kx, ci, co], with one accumulator
// per output element held in registers across the whole reduction and one
// write of the post-epilogue value. Float inputs (f32, bf16) accumulate in
// f32, one fmaf per reduction index; int8 inputs exactly in int32.
//
// The reduction runs over kk = (ky * fw + kx) * Cin + ci in ascending order
// (the (fh, fw, Cin, Cout) filter read as a (K, Cout) matrix), in 32-deep
// steps, K padded with zeros to whole steps. The epilogue is B1's
// (gemm_common.cuh): act(scale * acc + bias) + residual in f32, scale (1, 1)
// or (1, Cout). The library is built with -fmad=false, so every dataflow
// below rounds each output element the same: they all give OS's bits.
//
// A CTA owns a 64-pixel x 64-channel output tile: 64 consecutive output
// pixels of one image (row-major over (oy, ox), so a run of output rows) and
// 64 output channels. Each k step gathers the tile's strided input window
// (64 pixels x 32 reduction indices; a warp reads 32 consecutive channels of
// one tap) and a 32 x 64 filter block into shared memory, while the next
// step's loads are in flight. Cin, Cout and the pixel count are masked at
// the edges, so nothing is padded (the TPU kernel's channel padding to 128
// lanes and its _strided_window reshapes are not carried over).
//
// Dataflows (the TPU kernel's anchors differ only in grid order; on Hopper
// the walk over the revisited grid dimension moves inside one CTA, which
// holds the anchored operand in shared memory):
//   OS (WALK_NONE): one CTA per (image, pixel tile, channel tile); both
//     operands stream.
//   WS (WALK_M): CTA j holds the (fh, fw, Cin, 64) weight block of channel
//     tile j, fetched once, and walks every (image, pixel tile).
//   IS (WALK_N): CTA n holds image n (H, W, Cin), fetched once, and walks
//     (channel tile, pixel tile).
// A resident operand that does not fit beside the two staging tiles in a
// block's 227 KB is refused (the Python planner says so first, naming the
// bytes).
//
// Bound on H100: at the ResNet-18 and VGG layers, operations (2*M*K*N for
// the implicit GEMM M = N*oh*ow, K = fh*fw*Cin, N = Cout). This version runs
// on the CUDA cores (f32 fmaf, int32 multiply-add), far from the tensor
// cores' int8/bf16 rates; WS and IS give up the grid's parallelism (Cout/64
// or N CTAs) for their fetch-once traffic.
#include "gemm_common.cuh"

namespace conv {

using gemm::BK;
using gemm::BM;
using gemm::BN;
using gemm::cdiv;
using gemm::round_up;
using gemm::THREADS;
using gemm::TILE_FLOATS;
using gemm::TILE_LD;
using gemm::TM;
using gemm::TN;

constexpr int A_IT = BM * BK / THREADS, B_IT = BK * BN / THREADS;  // 8, 8
constexpr int ROWS_PER_PASS = THREADS / BK;
static_assert(THREADS % BK == 0, "a thread's reduction column is fixed");
// The two staging tiles, static shared memory beside the resident operand.
constexpr size_t TILE_BYTES = 2 * TILE_FLOATS * 4;

enum Walk { WALK_NONE = 0, WALK_M = 1, WALK_N = 2 };

template <typename T>
struct AccOf {
  using type = float;
  using quad = float4;
};
template <>
struct AccOf<int8_t> {
  using type = int;
  using quad = int4;
};

template <typename T>
__device__ __forceinline__ T zero_of() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int widen(int8_t v) { return v; }

__device__ __forceinline__ float mac(float acc, float a, float b) { return fmaf(a, b, acc); }
__device__ __forceinline__ int mac(int acc, int a, int b) { return acc + a * b; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }

struct Geo {
  int n, h, w, cin, fh, fw, s, cout;
  int oh, ow, p;  // output rows, columns and pixels per image
  int k;          // fh * fw * cin
  int tiles;      // 64-pixel tiles per image
};

// The gathered (64 pixels x 32 reduction indices) input window of one k
// step, stored k-major. Thread t loads reduction index k0 + t % 32 for the
// pixels t / 32 + 8 * it; it tracks that index's tap (ky, kx, ci) as k0
// advances instead of dividing.
template <typename T>
struct ATile {
  T r[A_IT];
  int base[A_IT];  // window origin of each pixel in the image, -1 past p
  int c, kx, ky;

  __device__ __forceinline__ void start(const Geo& g, int t) {
#pragma unroll
    for (int it = 0; it < A_IT; ++it) {
      const int q = t * BM + threadIdx.x / BK + it * ROWS_PER_PASS;
      base[it] = q < g.p ? ((q / g.ow) * g.s * g.w + (q % g.ow) * g.s) * g.cin : -1;
    }
    const int kk = threadIdx.x % BK, tap = kk / g.cin;
    c = kk % g.cin;
    kx = tap % g.fw;
    ky = tap / g.fw;
  }
  __device__ __forceinline__ void advance(const Geo& g) {
    c += BK;
    while (c >= g.cin) {
      c -= g.cin;
      if (++kx == g.fw) {
        kx = 0;
        ++ky;
      }
    }
  }
  __device__ __forceinline__ void fetch(const T* img, const Geo& g) {
    const bool in = ky < g.fh;  // kk < K
    const int off = (ky * g.w + kx) * g.cin + c;
#pragma unroll
    for (int it = 0; it < A_IT; ++it)
      r[it] = (in && base[it] >= 0) ? img[base[it] + off] : zero_of<T>();
  }
  template <typename Acc>
  __device__ __forceinline__ void stash(Acc* as) const {
#pragma unroll
    for (int it = 0; it < A_IT; ++it)
      as[(threadIdx.x % BK) * TILE_LD + threadIdx.x / BK + it * ROWS_PER_PASS] =
          widen(r[it]);
  }
};

// A (32 x 64) block of the filter read as a (K, ld) matrix: rows at or past
// kvalid and columns at or past nvalid read as 0.
template <typename T>
struct BTile {
  T r[B_IT];
  __device__ __forceinline__ void fetch(const T* wt, int ld, int kvalid,
                                        int nvalid, int k0, int col0) {
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int kk = k0 + i / BN, cc = col0 + i % BN;
      r[it] = (kk < kvalid && cc < nvalid) ? wt[(size_t)kk * ld + cc] : zero_of<T>();
    }
  }
  template <typename Acc>
  __device__ __forceinline__ void stash(Acc* bs) const {
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int i = threadIdx.x + it * THREADS;
      bs[(i / BN) * TILE_LD + i % BN] = widen(r[it]);
    }
  }
};

// The whole reduction of pixel tile t of image `img` against the filter
// columns col0.. of wt (a (K, ld) matrix, kvalid rows and nvalid columns
// real), into acc. Ends with a barrier, so the caller may refill the tiles.
template <typename T, typename Acc>
__device__ __forceinline__ void conv_tile(Acc acc[TM][TN], const T* img,
                                          const T* wt, int ld, int kvalid,
                                          int nvalid, int col0, const Geo& g,
                                          int t, Acc* as, Acc* bs) {
  using Quad = typename AccOf<T>::quad;
  ATile<T> at;
  BTile<T> bt;
  const int kp = round_up(g.k, BK);
  const int ar = (threadIdx.x / (BN / TN)) * TM, bc = (threadIdx.x % (BN / TN)) * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  at.start(g, t);
  at.fetch(img, g);
  bt.fetch(wt, ld, kvalid, nvalid, 0, col0);
  at.stash(as);
  bt.stash(bs);
  __syncthreads();
  for (int k0 = 0; k0 < kp; k0 += BK) {
    const bool more = k0 + BK < kp;
    if (more) {  // in flight while this step is consumed
      at.advance(g);
      at.fetch(img, g);
      bt.fetch(wt, ld, kvalid, nvalid, k0 + BK, col0);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const Quad a4 = *reinterpret_cast<const Quad*>(as + kk * TILE_LD + ar);
      const Quad b4 = *reinterpret_cast<const Quad*>(bs + kk * TILE_LD + bc);
      const Acc av[TM] = {a4.x, a4.y, a4.z, a4.w};
      const Acc bv[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mac(acc[i][j], av[i], bv[j]);
    }
    __syncthreads();
    if (more) {
      at.stash(as);
      bt.stash(bs);
      __syncthreads();
    }
  }
}

// The epilogue (B1's, when any stage is on) and the one write of each
// output element inside the (N, oh, ow, Cout) output.
template <typename Acc>
__device__ __forceinline__ void store_tile(void* out, const Acc acc[TM][TN],
                                           const Geo& g, int img, int t,
                                           int col0, const gemm::Epi& e,
                                           bool epi, int out_dtype) {
  const int ar = (threadIdx.x / (BN / TN)) * TM, bc = (threadIdx.x % (BN / TN)) * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int q = t * BM + ar + i;
    if (q >= g.p) continue;
    const int r = img * g.p + q;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + bc + j;
      if (c >= g.cout) continue;
      const size_t at = (size_t)r * g.cout + c;
      if (!epi && out_dtype == REPRO_I32) {
        static_cast<int*>(out)[at] = (int)acc[i][j];
        continue;
      }
      float x = to_float(acc[i][j]);
      if (epi) x = gemm::epilogue(x, r, c, g.cout, e);
      if (out_dtype == REPRO_BF16) store_f32(static_cast<__nv_bfloat16*>(out) + at, x);
      else store_f32(static_cast<float*>(out) + at, x);
    }
  }
}

// Copies `count` elements into shared memory, 16 bytes a thread where the
// source allows it.
template <typename T>
__device__ __forceinline__ void copy_to_shared(T* dst, const T* src, size_t count) {
  size_t done = 0;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const size_t vecs = count * sizeof(T) / 16;
    for (size_t i = threadIdx.x; i < vecs; i += THREADS)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = vecs * 16 / sizeof(T);
  }
  for (size_t i = done + threadIdx.x; i < count; i += THREADS) dst[i] = src[i];
}

template <typename T, int WALK>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const T* __restrict__ x, const T* __restrict__ w, void* __restrict__ out,
            Geo g, gemm::Epi e, int epi, int out_dtype) {
  using Acc = typename AccOf<T>::type;
  __shared__ __align__(16) Acc as[TILE_FLOATS];
  __shared__ __align__(16) Acc bs[TILE_FLOATS];
  extern __shared__ __align__(16) unsigned char smem[];  // the resident operand
  T* res = reinterpret_cast<T*>(smem);
  const int kp = round_up(g.k, BK), gn = cdiv(g.cout, BN);
  const size_t hwc = (size_t)g.h * g.w * g.cin;
  Acc acc[TM][TN];
  if (WALK == WALK_NONE) {
    const int col0 = blockIdx.x * BN, img = blockIdx.y / g.tiles, t = blockIdx.y % g.tiles;
    conv_tile(acc, x + img * hwc, w, g.cout, g.k, g.cout, col0, g, t, as, bs);
    store_tile(out, acc, g, img, t, col0, e, epi, out_dtype);
  } else if (WALK == WALK_M) {  // WS: channel tile j's weight block resident
    const int col0 = blockIdx.x * BN;
    for (int i = threadIdx.x; i < kp * BN; i += THREADS) {
      const int kk = i / BN, c = col0 + i % BN;
      res[i] = (kk < g.k && c < g.cout) ? w[(size_t)kk * g.cout + c] : zero_of<T>();
    }
    __syncthreads();
    for (int img = 0; img < g.n; ++img)
      for (int t = 0; t < g.tiles; ++t) {
        conv_tile(acc, x + img * hwc, res, BN, kp, BN, 0, g, t, as, bs);
        store_tile(out, acc, g, img, t, col0, e, epi, out_dtype);
      }
  } else {  // IS: image n resident
    const int img = blockIdx.x;
    copy_to_shared(res, x + img * hwc, hwc);
    __syncthreads();
    for (int j = 0; j < gn; ++j)
      for (int t = 0; t < g.tiles; ++t) {
        conv_tile(acc, res, w, g.cout, g.k, g.cout, j * BN, g, t, as, bs);
        store_tile(out, acc, g, img, t, j * BN, e, epi, out_dtype);
      }
  }
}

// Dynamic shared memory of a walk, in bytes (the resident operand); the
// Python planner (conv2d_df.plan) adds TILE_BYTES the same way.
template <typename T>
size_t resident_bytes(int walk, const Geo& g) {
  if (walk == WALK_M) return (size_t)round_up(g.k, BK) * BN * sizeof(T);
  if (walk == WALK_N) return ((size_t)g.h * g.w * g.cin * sizeof(T) + 15) / 16 * 16;
  return 0;
}

template <typename T, int WALK>
int launch(const void* x, const void* w, void* out, const Geo& g,
           const gemm::Epi& e, int epi, int out_dtype, cudaStream_t stream) {
  const size_t smem = resident_bytes<T>(WALK, g);
  if (smem + TILE_BYTES > gemm::MAX_SMEM) return REPRO_BAD_ARGUMENT;
  auto kernel = conv_kernel<T, WALK>;
  if (smem + TILE_BYTES > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int gn = cdiv(g.cout, BN);
  const dim3 grid = WALK == WALK_NONE ? dim3(gn, g.tiles * g.n)
                    : WALK == WALK_M  ? dim3(gn)
                                      : dim3(g.n);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x),
                                          static_cast<const T*>(w), out, g, e,
                                          epi, out_dtype);
  return launch_status();
}

#define CONV_SIGNATURE(T, WALK)                                            \
  int launch<T, WALK>(const void*, const void*, void*, const Geo&,         \
                      const gemm::Epi&, int, int, cudaStream_t)
#define CONV_EXTERN(T, WALK) extern template CONV_SIGNATURE(T, WALK);
#define CONV_DEFINE(T, WALK) template CONV_SIGNATURE(T, WALK);
#define CONV_WALKS(X, T) X(T, WALK_NONE) X(T, WALK_M) X(T, WALK_N)

// One translation unit per input type (-DREPRO_PART=0..2, kernels/_build.py).
#if defined(REPRO_PART)
#if REPRO_PART == 0
CONV_WALKS(CONV_DEFINE, float)
#elif REPRO_PART == 1
CONV_WALKS(CONV_DEFINE, __nv_bfloat16)
#else
CONV_WALKS(CONV_DEFINE, int8_t)
#endif
#else
CONV_WALKS(CONV_EXTERN, float)
CONV_WALKS(CONV_EXTERN, __nv_bfloat16)
CONV_WALKS(CONV_EXTERN, int8_t)

template <typename T>
int dispatch(int walk, const void* x, const void* w, void* out, const Geo& g,
             const gemm::Epi& e, int epi, int out_dtype, cudaStream_t s) {
  if (walk == WALK_M) return launch<T, WALK_M>(x, w, out, g, e, epi, out_dtype, s);
  if (walk == WALK_N) return launch<T, WALK_N>(x, w, out, g, e, epi, out_dtype, s);
  return launch<T, WALK_NONE>(x, w, out, g, e, epi, out_dtype, s);
}
#endif

}  // namespace conv

#if !defined(REPRO_PART)
// walk: 0 OS, 1 WS, 2 IS. scale_mode: 0 none, 1 (1, 1), 2 (1, Cout);
// act as gemm_common.cuh. Float inputs take f32/bf16 outputs; int8 inputs
// int32 (without an epilogue), f32 or bf16.
extern "C" int conv2d(const void* x, const void* w, void* out, int n, int h,
                      int wd, int cin, int fh, int fw, int stride, int cout,
                      int in_dtype, int out_dtype, const float* scale,
                      int scale_mode, const float* bias, int act,
                      const float* residual, int walk, void* stream) {
  using namespace conv;
  const bool epi = scale_mode != gemm::SCALE_NONE || bias || act != gemm::ACT_NONE || residual;
  const bool int_in = in_dtype == REPRO_I8;
  if (n <= 0 || cin <= 0 || cout <= 0 || fh <= 0 || fw <= 0 || stride <= 0 ||
      h < fh || wd < fw || (size_t)h * wd * cin >= (1u << 31) ||
      (in_dtype != REPRO_F32 && in_dtype != REPRO_BF16 && !int_in) ||
      !(out_dtype == REPRO_F32 || out_dtype == REPRO_BF16 ||
        (int_in && !epi && out_dtype == REPRO_I32)) ||
      scale_mode < gemm::SCALE_NONE || scale_mode > gemm::SCALE_COL ||
      (scale_mode != gemm::SCALE_NONE && !scale) || act < gemm::ACT_NONE ||
      act > gemm::ACT_SILU || walk < WALK_NONE || walk > WALK_N)
    return REPRO_BAD_ARGUMENT;
  Geo g{n, h, wd, cin, fh, fw, stride, cout};
  g.oh = (h - fh) / stride + 1;
  g.ow = (wd - fw) / stride + 1;
  g.p = g.oh * g.ow;
  g.k = fh * fw * cin;
  g.tiles = cdiv(g.p, BM);
  if ((size_t)g.tiles * n > 65535 || (size_t)n * g.p * cout >= (1u << 31))
    return REPRO_BAD_ARGUMENT;
  const gemm::Epi e{scale, scale_mode, bias, act, residual, out_dtype == REPRO_BF16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == REPRO_F32) return dispatch<float>(walk, x, w, out, g, e, epi, out_dtype, s);
  if (in_dtype == REPRO_BF16)
    return dispatch<__nv_bfloat16>(walk, x, w, out, g, e, epi, out_dtype, s);
  return dispatch<int8_t>(walk, x, w, out, g, e, epi, out_dtype, s);
}
#endif
