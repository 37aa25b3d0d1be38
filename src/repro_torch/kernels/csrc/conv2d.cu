// B8: the direct NHWC convolution with the fused epilogue.
//
// Replaces the TPU kernel repro/kernels/conv2d_df.py `_conv_kernel` (built by
// `conv2d_df`): x (N, H, W, Cin), w (fh, fw, Cin, Cout), VALID padding,
// stride s; out[n, oy, ox, co] = sum over (ky, kx, ci) of
// x[n, oy*s + ky, ox*s + kx, ci] * w[ky, kx, ci, co], with one accumulator
// per output element held in registers across the whole reduction and one
// write of the post-epilogue value. The reduction runs over kk = (ky * fw +
// kx) * Cin + ci (the (fh, fw, Cin, Cout) filter read as a (K, Cout) matrix);
// the epilogue is B1's (gemm_common.cuh): act(scale * acc + bias) + residual
// in f32, scale (1, 1) or (1, Cout). The library is built with -fmad=false,
// so every dataflow below rounds each output element the same: they all give
// OS's bits.
//
// int8 images (with an int8 or a packed int4/int5 filter) and bf16 ones run
// on the tensor cores as an implicit GEMM (conv_tc.cuh): OS on the tile its
// rule picks (integers split k across CTAs where the tiles leave SMs idle),
// WS and IS on their walks with the same k step. The entry point reports the
// tile it took (gemm::Took: tile code, shared memory bytes, CTAs, split).
//
// f32 stays on the CUDA cores, without TF32: one fmaf per reduction index in
// ascending order, a CTA owning a 64-pixel x 64-channel output tile (64
// consecutive output pixels of one image, row-major over (oy, ox), and 64
// output channels). Each k step gathers the tile's strided input window (64
// pixels x 32 reduction indices; a warp reads 32 consecutive channels of one
// tap) and a 32 x 64 filter block into shared memory, while the next step's
// loads are in flight. Cin, Cout and the pixel count are masked at the edges,
// so nothing is padded (the TPU kernel's channel padding to 128 lanes and its
// _strided_window reshapes are not carried over). Its dataflows (the TPU
// kernel's anchors differ only in grid order; on Hopper the walk over the
// revisited grid dimension moves inside one CTA, which holds the anchored
// operand in shared memory):
//   OS (WALK_NONE): one CTA per (image, pixel tile, channel tile); both
//     operands stream.
//   WS (WALK_M): CTA j holds the (fh, fw, Cin, 64) weight block of channel
//     tile j, fetched once, and walks every (image, pixel tile).
//   IS (WALK_N): CTA n holds image n (H, W, Cin), fetched once, and walks
//     (channel tile, pixel tile).
// A resident operand that does not fit beside the two staging tiles in a
// block's 227 KB is refused (the Python planner says so first, naming the
// bytes); the tensor-core walks keep that limit.
//
// Packed int4/int5 filters (weight_bits 4, 5; int8 images): the planes of
// repro_torch/kernels/pack.py laid out per tap, (fh, fw, Cin_pad/8, Cout)
// nibble words and (fh, fw, Cin_pad/32, Cout) bit-plane words, Cin_pad =
// Cin rounded up to 32, decoded into the mma fragments (pack_common.cuh,
// B6). The outlier rows (one image channel of one tap each) are added to the
// int32 accumulator at the flush: slot s reads the pixel's window at offset
// soff[s] (-1: empty) times sdelta[s, co].
//
// Bound on H100: at the ResNet-18 and VGG layers, operations (2*M*K*N for
// the implicit GEMM M = N*oh*ow, K = fh*fw*Cin, N = Cout) at the tensor
// cores' int8/bf16 rate, or the bytes where the output dominates (the
// ResNet-18 layer the kernels phase times); f32 at the CUDA cores' rate.
#include "conv_tc.cuh"

namespace conv {

using gemm::BK;
using gemm::BM;
using gemm::BN;
using gemm::THREADS;
using gemm::TILE_FLOATS;
using gemm::TILE_LD;
using gemm::TM;
using gemm::TN;

constexpr int A_IT = BM * BK / THREADS, B_IT = BK * BN / THREADS;  // 8, 8
constexpr int ROWS_PER_PASS = THREADS / BK;
static_assert(THREADS % BK == 0, "a thread's reduction column is fixed");

// The gathered (64 pixels x 32 reduction indices) f32 input window of one k
// step, stored k-major. Thread t loads reduction index k0 + t % 32 for the
// pixels t / 32 + 8 * it; it tracks that index's tap (ky, kx, c) as k0
// advances instead of dividing.
struct ATile {
  float r[A_IT];
  int base[A_IT];  // window origin of each pixel in the image, -1 past p
  int c, kx, ky;

  __device__ __forceinline__ void start(const Geo& g, int t) {
#pragma unroll
    for (int it = 0; it < A_IT; ++it)
      base[it] = pixel_base(g, t * BM + threadIdx.x / BK + it * ROWS_PER_PASS);
    const int kk = threadIdx.x % BK, tap = kk / g.cr;
    c = kk % g.cr;
    kx = tap % g.fw;
    ky = tap / g.fw;
  }
  __device__ __forceinline__ void advance(const Geo& g) {
    c += BK;
    while (c >= g.cr) {
      c -= g.cr;
      if (++kx == g.fw) {
        kx = 0;
        ++ky;
      }
    }
  }
  __device__ __forceinline__ void fetch(const float* img, const Geo& g) {
    const bool in = ky < g.fh;  // kk < K
    const int off = (ky * g.w + kx) * g.cin + c;
#pragma unroll
    for (int it = 0; it < A_IT; ++it) r[it] = (in && base[it] >= 0) ? img[base[it] + off] : 0.f;
  }
  __device__ __forceinline__ void stash(float* as) const {
#pragma unroll
    for (int it = 0; it < A_IT; ++it)
      as[(threadIdx.x % BK) * TILE_LD + threadIdx.x / BK + it * ROWS_PER_PASS] = r[it];
  }
};

// The filter read as a (K, ld) matrix: rows at or past kvalid and columns at
// or past nvalid read as 0; each step's (32 x 64) block is staged through
// registers.
struct DenseW {
  const float* w;
  int ld, kvalid, nvalid;

  struct Tile {
    float r[B_IT];
    __device__ __forceinline__ void fetch(const DenseW& o, int k0, int col0) {
#pragma unroll
      for (int it = 0; it < B_IT; ++it) {
        const int i = threadIdx.x + it * THREADS;
        const int kk = k0 + i / BN, cc = col0 + i % BN;
        r[it] = (kk < o.kvalid && cc < o.nvalid) ? o.w[(size_t)kk * o.ld + cc] : 0.f;
      }
    }
    __device__ __forceinline__ void stash(float* bs) const {
#pragma unroll
      for (int it = 0; it < B_IT; ++it) {
        const int i = threadIdx.x + it * THREADS;
        bs[(i / BN) * TILE_LD + i % BN] = r[it];
      }
    }
  };
};

// The whole reduction of pixel tile t of image `img` against the filter
// columns col0.. of wt, into acc. Ends with a barrier, so the caller may
// refill the tiles.
__device__ __forceinline__ void conv_tile(float acc[TM][TN], const float* img, const DenseW& wt,
                                          int col0, const Geo& g, int t, float* as, float* bs) {
  ATile at;
  DenseW::Tile bt;
  const int kp = round_up(g.k, BK);
  const int ar = (threadIdx.x / (BN / TN)) * TM, bc = (threadIdx.x % (BN / TN)) * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  at.start(g, t);
  at.fetch(img, g);
  bt.fetch(wt, 0, col0);
  at.stash(as);
  bt.stash(bs);
  __syncthreads();
  for (int k0 = 0; k0 < kp; k0 += BK) {
    const bool more = k0 + BK < kp;
    if (more) {  // in flight while this step is consumed
      at.advance(g);
      at.fetch(img, g);
      bt.fetch(wt, k0 + BK, col0);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(as + kk * TILE_LD + ar);
      const float4 b4 = *reinterpret_cast<const float4*>(bs + kk * TILE_LD + bc);
      const float av[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = gemm::mac(acc[i][j], av[i], bv[j]);
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
__device__ __forceinline__ void store_tile(void* out, float acc[TM][TN], const Geo& g,
                                           int n_img, int t, int col0, const Epi& e,
                                           bool epi) {
  const int ar = (threadIdx.x / (BN / TN)) * TM, bc = (threadIdx.x % (BN / TN)) * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int q = t * BM + ar + i;
    if (q >= g.p) continue;
    const int r = n_img * g.p + q;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + bc + j;
      if (c >= g.cout) continue;
      const size_t at = (size_t)r * g.cout + c;
      float x = acc[i][j];
      if (epi) x = gemm::epilogue(x, r, c, g.cout, e);
      if (e.out_dtype == REPRO_BF16) store_f32(static_cast<__nv_bfloat16*>(out) + at, x);
      else store_f32(static_cast<float*>(out) + at, x);
    }
  }
}

template <int WALK>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w, void* __restrict__ out,
            Geo g, Epi e, int epi) {
  __shared__ __align__(16) float as[TILE_FLOATS];
  __shared__ __align__(16) float bs[TILE_FLOATS];
  extern __shared__ __align__(16) unsigned char smem[];  // the resident operand
  const int gn = cdiv(g.cout, BN);
  const size_t hwc = (size_t)g.h * g.w * g.cin;
  const DenseW whole{w, g.cout, g.k, g.cout};
  float acc[TM][TN];
  if (WALK == WALK_NONE) {
    const int col0 = blockIdx.x * BN, img = blockIdx.y / g.tiles, t = blockIdx.y % g.tiles;
    conv_tile(acc, x + img * hwc, whole, col0, g, t, as, bs);
    store_tile(out, acc, g, img, t, col0, e, epi);
  } else if (WALK == WALK_M) {  // WS: channel tile j's weight block resident
    const int col0 = blockIdx.x * BN, kp = round_up(g.k, BK);
    float* res = reinterpret_cast<float*>(smem);
    for (int i = threadIdx.x; i < kp * BN; i += THREADS) {
      const int kk = i / BN, c = col0 + i % BN;
      res[i] = (kk < g.k && c < g.cout) ? w[(size_t)kk * g.cout + c] : 0.f;
    }
    __syncthreads();
    const DenseW block{res, BN, kp, BN};
    for (int img = 0; img < g.n; ++img)
      for (int t = 0; t < g.tiles; ++t) {
        conv_tile(acc, x + img * hwc, block, 0, g, t, as, bs);
        store_tile(out, acc, g, img, t, col0, e, epi);
      }
  } else {  // IS: image n resident
    const int img = blockIdx.x;
    float* res = reinterpret_cast<float*>(smem);
    const float* src = x + img * hwc;
    size_t done = 0;
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      const size_t vecs = hwc / 4;
      for (size_t i = threadIdx.x; i < vecs; i += THREADS)
        reinterpret_cast<float4*>(res)[i] = reinterpret_cast<const float4*>(src)[i];
      done = vecs * 4;
    }
    for (size_t i = done + threadIdx.x; i < hwc; i += THREADS) res[i] = src[i];
    __syncthreads();
    for (int j = 0; j < gn; ++j)
      for (int t = 0; t < g.tiles; ++t) {
        conv_tile(acc, res, whole, j * BN, g, t, as, bs);
        store_tile(out, acc, g, img, t, j * BN, e, epi);
      }
  }
}

// The f32 walk: dynamic shared memory is the resident operand (the Python
// planner, conv2d_df.plan, adds TILE_BYTES the same way).
template <int WALK>
int launch_f32(const void* x, const void* w, void* out, const Geo& g, const Epi& e, int epi,
               cudaStream_t stream) {
  const size_t smem = WALK == WALK_M   ? (size_t)round_up(g.k, BK) * BN * 4
                      : WALK == WALK_N ? image_bytes(g, 4)
                                       : 0;
  if (smem + TILE_BYTES > gemm::MAX_SMEM) return REPRO_BAD_ARGUMENT;
  auto kernel = conv_kernel<WALK>;
  if (smem + TILE_BYTES > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int gn = cdiv(g.cout, BN);
  const dim3 grid = WALK == WALK_NONE ? dim3(gn, g.tiles * g.n)
                    : WALK == WALK_M  ? dim3(gn)
                                      : dim3(g.n);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const float*>(x),
                                          static_cast<const float*>(w), out, g, e, epi);
  return launch_status();
}

// The tensor-core launches of one input type and weight bits: the OS tile
// the rule picks, or a walk.
template <typename T, int WB>
int launch_tc(int walk, const void* x, const void* w, const void* w_hi, void* out,
              const Geo& g, const Epi& e, int* ws, size_t ws_ints, unsigned* counters,
              int n_counters, cudaStream_t s, gemm::Took* took);

#define CONV_TC_SIGNATURE(T, WB)                                                       \
  int launch_tc<T, WB>(int, const void*, const void*, const void*, void*, const Geo&, \
                       const Epi&, int*, size_t, unsigned*, int, cudaStream_t, gemm::Took*)

template <typename T, int WB>
int launch_tc(int walk, const void* x, const void* w, const void* w_hi, void* out,
              const Geo& g, const Epi& e, int* ws, size_t ws_ints, unsigned* counters,
              int n_counters, cudaStream_t s, gemm::Took* took) {
  using Ws = typename std::conditional<std::is_same<T, int8_t>::value, WsI8, WsBf16>::type;
  using Is = typename std::conditional<std::is_same<T, int8_t>::value, IsI8, IsBf16>::type;
  if (walk == WALK_M) return launch_walk<Ws, WB, WALK_M>(x, w, w_hi, out, g, e, s, took);
  if (walk == WALK_N) return launch_walk<Is, WB, WALK_N>(x, w, w_hi, out, g, e, s, took);
  const OsChoice c = os_tile<T>(g);
  auto os = [&](auto cfg) {
    using C = decltype(cfg);
    return launch_os<C, WB>(x, w, w_hi, out, g, e, c.split, ws, ws_ints, counters, n_counters,
                            s, took);
  };
  if (c.tile == 0) return os(Os0<T>());
  if (c.tile == 1) return os(Os1<T>());
  return os(Os2<T>());
}

// One translation unit per input type and weight bits (-DREPRO_PART=0..4,
// kernels/_build.py), and the entry point's.
#if defined(REPRO_PART)
#if REPRO_PART == 0
template int launch_f32<WALK_NONE>(const void*, const void*, void*, const Geo&, const Epi&,
                                   int, cudaStream_t);
template int launch_f32<WALK_M>(const void*, const void*, void*, const Geo&, const Epi&, int,
                                cudaStream_t);
template int launch_f32<WALK_N>(const void*, const void*, void*, const Geo&, const Epi&, int,
                                cudaStream_t);
#elif REPRO_PART == 1
template CONV_TC_SIGNATURE(__nv_bfloat16, 0);
#elif REPRO_PART == 2
template CONV_TC_SIGNATURE(int8_t, 0);
#elif REPRO_PART == 3
template CONV_TC_SIGNATURE(int8_t, 4);
#else
template CONV_TC_SIGNATURE(int8_t, 5);
#endif
#else
extern template int launch_f32<WALK_NONE>(const void*, const void*, void*, const Geo&,
                                          const Epi&, int, cudaStream_t);
extern template int launch_f32<WALK_M>(const void*, const void*, void*, const Geo&, const Epi&,
                                       int, cudaStream_t);
extern template int launch_f32<WALK_N>(const void*, const void*, void*, const Geo&, const Epi&,
                                       int, cudaStream_t);
extern template CONV_TC_SIGNATURE(__nv_bfloat16, 0);
extern template CONV_TC_SIGNATURE(int8_t, 0);
extern template CONV_TC_SIGNATURE(int8_t, 4);
extern template CONV_TC_SIGNATURE(int8_t, 5);
#endif

}  // namespace conv

#if !defined(REPRO_PART)
// walk: 0 OS, 1 WS, 2 IS. scale_mode: 0 none, 1 (1, 1), 2 (1, Cout);
// act as gemm_common.cuh. Float inputs take f32/bf16 outputs; int8 inputs
// int32 (without an epilogue), f32 or bf16. weight_bits 4 or 5 (int8 inputs
// only): w is the packed nibble plane, w_hi the bit plane at 5 bits, and the
// sidecar soff (sr,) window offsets (-1 empty) with sdelta (sr, Cout). An
// integer OS launch that splits k takes ws (ws_ints int32 partial sums) and
// counters (n_counters zeroed arrival counters, left zeroed). `took` receives
// the tile the launch took (conv::TileCode, shared memory bytes, CTAs,
// split).
extern "C" int conv2d(const void* x, const void* w, void* out, int n, int h,
                      int wd, int cin, int fh, int fw, int stride, int cout,
                      int in_dtype, int out_dtype, const float* scale,
                      int scale_mode, const float* bias, int act,
                      const float* residual, int weight_bits, const void* w_hi,
                      const int* soff, const int* sdelta, int sr, int walk, int* ws,
                      int ws_ints, unsigned* counters, int n_counters,
                      gemm::Took* took, void* stream) {
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
      act > gemm::ACT_SILU || walk < WALK_NONE || walk > WALK_N ||
      (weight_bits != 0 && weight_bits != 4 && weight_bits != 5) ||
      (weight_bits != 0 && !int_in) || (weight_bits == 5 && !w_hi) || sr < 0 ||
      (sr > 0 && (weight_bits == 0 || !soff || !sdelta)) || ws_ints < 0 || n_counters < 0)
    return REPRO_BAD_ARGUMENT;
  Geo g{n, h, wd, cin, fh, fw, stride, cout};
  g.oh = (h - fh) / stride + 1;
  g.ow = (wd - fw) / stride + 1;
  g.p = g.oh * g.ow;
  g.cr = weight_bits ? gemm::round_up(cin, pack::WORD_BITS) : cin;
  g.k = fh * fw * g.cr;
  g.tiles = gemm::cdiv(g.p, gemm::BM);
  if ((size_t)g.tiles * n > 65535 || (size_t)n * g.p * cout >= (1u << 31))
    return REPRO_BAD_ARGUMENT;
  gemm::Epi e{scale, scale_mode, bias, act, residual, out_dtype};
  e.sidx = soff;
  e.sdelta = sdelta;
  e.sr = sr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (took) *took = gemm::Took{};
  if (in_dtype == REPRO_F32) {
    if (walk == WALK_M) return launch_f32<WALK_M>(x, w, out, g, e, epi, s);
    if (walk == WALK_N) return launch_f32<WALK_N>(x, w, out, g, e, epi, s);
    return launch_f32<WALK_NONE>(x, w, out, g, e, epi, s);
  }
  const size_t wsn = (size_t)ws_ints;
  if (in_dtype == REPRO_BF16)
    return launch_tc<__nv_bfloat16, 0>(walk, x, w, w_hi, out, g, e, ws, wsn, counters,
                                       n_counters, s, took);
  if (weight_bits == 4)
    return launch_tc<int8_t, 4>(walk, x, w, w_hi, out, g, e, ws, wsn, counters, n_counters, s,
                                took);
  if (weight_bits == 5)
    return launch_tc<int8_t, 5>(walk, x, w, w_hi, out, g, e, ws, wsn, counters, n_counters, s,
                                took);
  return launch_tc<int8_t, 0>(walk, x, w, w_hi, out, g, e, ws, wsn, counters, n_counters, s,
                              took);
}
#endif
