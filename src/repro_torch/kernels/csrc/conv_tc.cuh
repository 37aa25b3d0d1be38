// B8 on Hopper's tensor cores: the direct NHWC convolution as an implicit
// GEMM, for int8 images with an int8 or a packed int4/int5 filter (B6) and
// for bf16 images and filters (conv2d.cu holds the entry point and the f32
// walk, which stays on the CUDA cores).
//
// The GEMM: A (pixels x K) is the image's strided windows, row q of image n
// the window of output pixel q (row-major over (oy, ox)) and column kk =
// (ky * fw + kx) * cr + c the input channel c of tap (ky, kx) (cr = Cin, or
// Cin rounded up to 32 for a packed filter, whose pad channels read 0); B
// (K x Cout) is the (fh, fw, cr, Cout) filter read as a matrix, or its
// packed planes read as B1's packed B ((K/8, Cout) nibble words, (K/32,
// Cout) bit-plane words). Nothing is materialised: each k step gathers its
// A rows straight from the image.
//
// The k step is B1's (gemm_tc_i8.cuh, gemm_tc.cuh), and its fragment code is
// theirs:
// - int8: one mma.sync m16n8k32 .s8 per 32-deep chunk into int32
//   accumulators (i8::frag_a; i8::Frags: the swizzled dense B read by
//   ldmatrix.x4.trans, or packed words decoded into the fragments). Integer
//   sums are exact in any order, so every tile, split and walk gives the
//   plain version's bits.
// - bf16: one mma.sync m16n8k16 per 16-deep chunk of the flat kk order, each
//   chunk summed from zero and added to the f32 sum with one rounded add
//   (mma_bf16_add), over K rounded up to 32, in ascending k: B1's order. No
//   split of k. Every bf16 tile and walk adds the same chunks in the same
//   order, so OS, WS and IS give one another's bits.
//
// A gather: pixel q's window origin ((q / ow) * s * W + (q % ow) * s) * Cin
// is computed once per tile; reduction index kk maps to the offset
// ((ky * W + kx) * Cin + c) in the window, each thread's column tracked
// from step to step without dividing (Cursor). When Cin is a whole number of
// 16-byte units (16 int8 or 8 bf16 channels) and the pointers are 16-byte
// aligned, a unit never crosses a tap and each is one cp.async of 16 bytes;
// otherwise (ragged Cin, an unaligned view) single elements are stored into
// the same ring. Pixels past the image, indices past K and a packed filter's
// pad channels read 0. A stays int8 / bf16 in shared memory, in the layout
// B1's fragments read.
//
// OS (conv_os_kernel): a CTA owns TBM consecutive pixels of one image by
// TBN output channels; A and B stream through a STAGES-deep cp.async ring of
// TBK-deep steps. The tile is picked by the CTAs it gives (os_tile: the
// largest of the library's tiles that gives every SM two CTAs, bf16 one),
// an integer conv splitting its k steps over `split` CTAs where its tiles
// alone fall short: each writes its int32 partial sums to a workspace, and the tile's
// last CTA (an atomicInc that wraps the tile's counter back to zero, as B3
// merges its chunks) adds them, then the sidecar, then runs the flush once.
// WS (conv_ws_kernel): CTA j holds channel tile j's weight block (int8 in
// the swizzled units of i8's dense B, packed planes as pack::load_panel
// writes them, bf16 rows with XOR-swizzled 16-byte units), fetched once, and
// walks every (image, pixel tile); only A streams. IS (conv_is_kernel): CTA n
// holds image n and walks (channel tile, pixel tile); each step's A rows are
// copied from the resident image into the ring, B streams. The walks' rings
// fit in TILE_BYTES (the staging the CUDA-core walk took beside its
// resident operand), so a walk fits exactly where it did before.
//
// Flush: the packed filter's outlier rows are added to the int32
// accumulator that owns (pixel, channel) (slot s adds the image at window
// offset sidx[s] times sdelta[s, channel]); then the int32 result is written
// as it is, or converted to f32 and put through B1's epilogue (every
// element's epilogue before the stores), a bf16 output rounded once.
//
// Bound on H100 at the ResNet-18 and VGG layers: the tensor cores'
// operations or the bytes of image, filter and output, whichever is larger;
// at ResNet-18's first layer (2 916 x 576 x 64) the output's bytes (f32).
// These layers are small, so what the tiles do about it is fill the card:
// narrower tiles and the integer split give most of the 132 SMs work (the
// tile shapes and the rule: bench/conv_sweep.cu, PERF.md).
#pragma once

#include <algorithm>

#include "gemm_tc.cuh"
#include "gemm_tc_i8.cuh"

namespace conv {

using gemm::cdiv;
using gemm::Epi;
using gemm::round_up;

struct Geo {
  int n, h, w, cin, fh, fw, s, cout;
  int oh, ow, p;  // output rows, columns and pixels per image
  int cr;         // reduction channels per tap: cin, or cin_pad when packed
  int k;          // fh * fw * cr
  int tiles;      // 64-pixel tiles per image (the f32 walk)
};

enum Walk { WALK_NONE = 0, WALK_M = 1, WALK_N = 2 };

// The tile a launch took, as kernels/_build.py TILE_LIBRARIES["conv2d"]
// names them (counting from 1; 0: the f32 walk). The report's fourth field
// is the split of k (1: none).
enum TileCode { TILE_F32 = 0, TILE_OS_I8, TILE_OS_BF16, TILE_WS_I8, TILE_IS_I8,
                TILE_WS_BF16, TILE_IS_BF16 };

// Bytes the walks' rings may take beside their resident operand: the two
// staging tiles of the f32 walk (conv2d_df.TILE_BYTES).
constexpr int TILE_BYTES = 2 * gemm::TILE_FLOATS * 4;
// SMs of an H100 (the tile rule's target; conv2d_df.CARD_SMS).
constexpr int CARD_SMS = 132;

// Output pixel q's window origin in its image, in elements; -1 past p.
__device__ __forceinline__ int pixel_base(const Geo& g, int q) {
  return q < g.p ? ((q / g.ow) * g.s * g.w + (q % g.ow) * g.s) * g.cin : -1;
}
// A tile: TBM pixels x TBN channels, WM x WN warps (each MI x NI mma tiles
// of 16 x 8), TBK-deep k steps through a STAGES-deep ring.
template <typename T, int TBM_, int TBN_, int TBK_, int STAGES_, int WM_, int WN_>
struct Cfg {
  using Elem = T;
  using Acc = typename gemm::AccOf<T>::type;
  static constexpr bool INT = std::is_same<T, int8_t>::value;
  static constexpr int TBM = TBM_, TBN = TBN_, TBK = TBK_, STAGES = STAGES_;
  static constexpr int WM = WM_, WN = WN_, NT = WM * WN * 32;
  static constexpr int MI = TBM / WM / 16, NI = TBN / WN / 8;
  static constexpr int EPU = 16 / (int)sizeof(T);  // elements of a 16-byte unit
  static constexpr int U = TBK / EPU;              // units of a pixel's step
  static constexpr int ROWS = TBM * U / NT;        // pixels a thread gathers
  // A rows: i8's conflict-free stride, or bf16 rows padded by 16 bytes.
  static constexpr int ALD = INT ? gemm::i8::a_ld(TBK) : TBK + 8;
  static constexpr int BLD = TBN + 8;  // a bf16 B row
  static constexpr int A_ELEMS = TBM * ALD, A_BYTES = A_ELEMS * (int)sizeof(T);
  static constexpr int SLD = TBN + 4;  // a row of the flush's staged f32 tile
  __host__ __device__ static constexpr int b_bytes(int wb) {
    return INT ? gemm::i8::b_bytes(wb, TBK, TBN) : TBK * BLD * 2;
  }
  // The ring with B streamed (OS, IS) or resident (WS).
  __host__ __device__ static constexpr int ring(int wb, bool b_streams) {
    return STAGES * (A_BYTES + (b_streams ? b_bytes(wb) : 0));
  }
  static_assert(TBM * U % NT == 0 && NT % TBK == 0, "gather ownership");
  static_assert(INT ? TBK % 32 == 0 : TBK % 16 == 0 && (32 % TBK == 0 || TBK % 32 == 0),
                "int8: whole 32-deep chunks; bf16: 16-deep chunks, steps that tile 32");
};

// The accumulators' element j of mma tile (mi, ni) of the warp at (wr, wc):
// its tile row and column (the column by B's fragment layout).
template <class C, int WB>
__device__ __forceinline__ int col_of(int wc, int ni, int j) {
  if constexpr (C::INT)
    return gemm::i8::Frags<WB, C::TBK, C::TBN, C::NI>::col(wc, ni, j);
  else
    return wc + ni * 8 + 2 * (tc::lane() & 3) + (j & 1);
}
__device__ __forceinline__ int row_of(int wr, int mi, int j) {
  return wr + mi * 16 + (tc::lane() >> 2) + (j >> 1) * 8;
}

// The window origins of the pixels a thread gathers in tile q0.. (VEC).
template <class C>
__device__ __forceinline__ void pixel_bases(int base[C::ROWS], const Geo& g, int q0) {
#pragma unroll
  for (int i = 0; i < C::ROWS; ++i)
    base[i] = pixel_base(g, q0 + threadIdx.x / C::U + i * (C::NT / C::U));
}

// The window offset of the reduction index a thread gathers (its column of
// every k step), advanced one step at a time: divisions only where it
// starts (dividing by Cr and fw anew in every step cost about a third of a
// bf16 step at 7x7x512 on an H100; PERF.md).
struct Cursor {
  int c, kx, ky;
  __device__ __forceinline__ void start(const Geo& g, int kk) {
    const int tap = kk / g.cr;
    c = kk - tap * g.cr;
    kx = tap % g.fw;
    ky = tap / g.fw;
  }
  // The offset in a pixel's window; -1 past K or for a pad channel.
  __device__ __forceinline__ int offset(const Geo& g) const {
    return ky < g.fh && c < g.cin ? (ky * g.w + kx) * g.cin + c : -1;
  }
  __device__ __forceinline__ void advance(const Geo& g, int by) {
    c += by;
    while (c >= g.cr) {
      c -= g.cr;
      if (++kx == g.fw) {
        kx = 0;
        ++ky;
      }
    }
  }
};

// The first reduction index of a thread's gather column in a k step.
template <class C, bool VEC>
__device__ __forceinline__ int gather_col() {
  return VEC ? (int)threadIdx.x % C::U * C::EPU : (int)threadIdx.x % C::TBK;
}

// One k step of A (pixels q0.., the thread's column at window offset
// `off`) into a row-major tile of ALD elements a row: 16-byte units by
// cp.async from the image in device memory, or copied from the resident
// image in shared memory (SMEM), when VEC; single elements otherwise. Zeros
// outside the image and K.
template <class C, bool VEC, bool SMEM>
__device__ __forceinline__ void gather_a(typename C::Elem* dst,
                                         const typename C::Elem* img, const Geo& g,
                                         const int base[C::ROWS], int q0, int off) {
  using T = typename C::Elem;
  const int col = gather_col<C, VEC>();
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < C::ROWS; ++i) {
      const int r = threadIdx.x / C::U + i * (C::NT / C::U);
      const bool in = off >= 0 && base[i] >= 0;
      T* to = dst + r * C::ALD + col;
      if constexpr (SMEM)
        *reinterpret_cast<uint4*>(to) =
            in ? *reinterpret_cast<const uint4*>(img + base[i] + off) : make_uint4(0, 0, 0, 0);
      else
        tc::cp_async16(to, in ? img + base[i] + off : img, in);
    }
  } else {
    for (int r = threadIdx.x / C::TBK; r < C::TBM; r += C::NT / C::TBK) {
      const int b = pixel_base(g, q0 + r);
      dst[r * C::ALD + col] = off >= 0 && b >= 0 ? img[b + off] : gemm::tzero<T>();
    }
  }
}

// One k step of B (rows k0.. (TBK), channels col0.. (TBN)) from device
// memory into its ring slot: B1's int8 tile loads (dense or packed), or its
// bf16 stage copy.
template <class C, int WB, bool VEC>
__device__ __forceinline__ void load_b(void* dst, const void* w, const uint32_t* w_hi,
                                       const Geo& g, int k0, int col0) {
  if constexpr (C::INT)
    gemm::i8::copy_b<WB, VEC, C::NT, C::TBK, C::TBN>(dst, w, w_hi, g.cout, g.k, k0, col0);
  else
    gemm::copy_stage<VEC, C::NT, C::BLD>(static_cast<__nv_bfloat16*>(dst),
                                         static_cast<const __nv_bfloat16*>(w), g.cout,
                                         g.k, g.cout, k0, col0, C::TBK, C::TBN);
}

// The products of one k step into acc: A from the ring slot `at`, B's
// fragments of chunk q from bfrag(q, bf). bf16 adds only the step's first
// `chunks` 16-deep chunks (those before K's 32-padding ends), so every
// element adds the same chunks whatever the step depth.
template <class C, class BFrag>
__device__ __forceinline__ void mma_step(typename C::Acc acc[C::MI][C::NI][4],
                                         const typename C::Elem* at, int wr, BFrag bfrag,
                                         int chunks) {
  if constexpr (C::INT) {
#pragma unroll
    for (int q = 0; q < C::TBK / 32; ++q) {
      uint32_t af[C::MI][4], bf[C::NI][2];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
        gemm::i8::frag_a(af[mi], at, C::ALD, wr + mi * 16, q * 32);
      bfrag(q, bf);
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni) tc::mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < C::TBK / 16; ++q) {
      if (C::TBK > 32 && q >= chunks) break;
      uint32_t af[C::MI][4], bf[C::NI][2];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
        tc::frag_a_rowmajor(af[mi], at, C::ALD, wr + mi * 16, q * 16);
      bfrag(q, bf);
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni) tc::mma_bf16_add(acc[mi][ni], af[mi], bf[ni]);
    }
  }
}

// B's fragments from a streamed ring slot.
template <class C, int WB>
__device__ __forceinline__ auto ring_frags(const unsigned char* bt, int wc) {
  return [=](int q, uint32_t (&bf)[C::NI][2]) {
    if constexpr (C::INT) {
      gemm::i8::Frags<WB, C::TBK, C::TBN, C::NI>::b(bf, bt, q, wc);
    } else {
      const auto* b = reinterpret_cast<const __nv_bfloat16*>(bt);
#pragma unroll
      for (int ni = 0; ni < C::NI; ni += 2)
        tc::frag_b2_rowmajor(bf[ni], bf[ni + 1], b, C::BLD, q * 16, wc + ni * 8);
    }
  };
}

// The flush of a warp's accumulators for pixels q0.. of image n_img and
// channels col0..: the sidecar (integers), then the walks' store.
template <class C, int WB>
__device__ __forceinline__ void flush(typename C::Acc acc[C::MI][C::NI][4], void* out,
                                      const typename C::Elem* img, const Geo& g,
                                      int n_img, int q0, int col0, int wr, int wc,
                                      const Epi& e, void* stage) {
  if constexpr (C::INT) {
    // The warp reads the slots' offsets 32 at a time and walks the filled
    // ones (a ballot), as B1's int8 flush does.
    for (int s0 = 0; s0 < e.sr; s0 += 32) {
      const int mine = s0 + tc::lane() < e.sr ? e.sidx[s0 + tc::lane()] : -1;
      unsigned filled = __ballot_sync(0xffffffffu, mine >= 0);
      while (filled) {
        const int bit = __ffs(filled) - 1, s = s0 + bit;
        filled &= filled - 1;
        const int off = __shfl_sync(0xffffffffu, mine, bit);
        int av[C::MI][2], dv[C::NI][2];
#pragma unroll
        for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int b = pixel_base(g, q0 + row_of(wr, mi, 2 * h));
            av[mi][h] = b >= 0 ? (int)img[b + off] : 0;
          }
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = col0 + col_of<C, WB>(wc, ni, h);
            dv[ni][h] = c < g.cout ? e.sdelta[(size_t)s * g.cout + c] : 0;
          }
#pragma unroll
        for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mi][ni][j] += av[mi][j >> 1] * dv[ni][j & 1];
      }
    }
  }
  // Every element's epilogue first (B1's, element by element), so its
  // loads (scale, bias, residual) are not held behind stores they might
  // alias; then the tile through shared memory (the ring, free after the k
  // loop), written a row at a time in 16-byte units.
  const bool raw = C::INT && e.out_dtype == REPRO_I32;
  float v[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + row_of(wr, mi, j), c = col0 + col_of<C, WB>(wc, ni, j);
        v[mi][ni][j] = raw ? __int_as_float((int)acc[mi][ni][j])
                       : q >= g.p || c >= g.cout
                           ? 0.f
                           : gemm::epilogue(gemm::to_float(acc[mi][ni][j]), n_img * g.p + q,
                                            c, g.cout, e);
      }
  float* st = static_cast<float*>(stage);
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st[row_of(wr, mi, j) * C::SLD + col_of<C, WB>(wc, ni, j)] = v[mi][ni][j];
  __syncthreads();
  constexpr int UNITS = C::TBN / 4;
  const bool whole = g.cout % 4 == 0;  // every unit is 4 aligned outputs or past Cout
  for (int i = threadIdx.x; i < C::TBM * UNITS; i += C::NT) {
    const int tr = i / UNITS, tcol = i % UNITS * 4, q = q0 + tr, c = col0 + tcol;
    if (q >= g.p || c >= g.cout) continue;
    const size_t at = (size_t)(n_img * g.p + q) * g.cout + c;
    const float4 x = *reinterpret_cast<const float4*>(st + tr * C::SLD + tcol);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    if (e.out_dtype == REPRO_BF16) {
      if (whole) {
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + at) =
            make_uint2(tc::pack2_rn(x.x, x.y), tc::pack2_rn(x.z, x.w));
      } else {
        for (int u = 0; u < 4 && c + u < g.cout; ++u)
          store_f32(static_cast<__nv_bfloat16*>(out) + at + u, xs[u]);
      }
    } else if (whole) {  // f32, or int32 bits
      *reinterpret_cast<float4*>(static_cast<float*>(out) + at) = x;
    } else {
      for (int u = 0; u < 4 && c + u < g.cout; ++u) static_cast<float*>(out)[at + u] = xs[u];
    }
  }
  __syncthreads();  // the ring may be refilled
}

template <class C>
__device__ __forceinline__ void zero(typename C::Acc acc[C::MI][C::NI][4]) {
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;
}

// Steps of the reduction: K padded to 32 (bf16: exactly kp / TBK steps, so
// every element adds kp / 16 chunks; int8: chunks of zeros past K add 0).
template <class C>
__host__ __device__ __forceinline__ int steps_of(const Geo& g) {
  return cdiv(round_up(g.k, 32), C::TBK);
}

// The k loop over steps [s0, s1) of pixels q0.. and channels col0..: A by
// gather(slot, k0), B by load_b(slot, k0) (nothing when B is resident), the
// products by frags(slot, k0) -> B's fragment source. Ends with every
// thread's copies landed and a barrier, so the caller may refill the ring.
template <class C, class LoadA, class LoadB, class Frags>
__device__ __forceinline__ void kloop(typename C::Acc acc[C::MI][C::NI][4], const Geo& g,
                                      int s0, int s1, int wr, LoadA load_a, LoadB load_b_,
                                      Frags frags) {
  const int kp = round_up(g.k, 32);
  const int n = s1 - s0;
  auto load = [&](int s) {
    load_a(s % C::STAGES, (s0 + s) * C::TBK);
    load_b_(s % C::STAGES, (s0 + s) * C::TBK);
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n) load(s);
    tc::cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    tc::cp_async_wait<C::STAGES - 2>();  // step s has landed
    __syncthreads();                     // and step s - 1's slot is consumed
    if (s + C::STAGES - 1 < n) load(s + C::STAGES - 1);
    tc::cp_async_commit();
    const int k0 = (s0 + s) * C::TBK;
    mma_step<C>(acc, frags.a(s % C::STAGES), wr, frags.b(s % C::STAGES, k0),
                min(C::TBK, kp - k0) / 16);
  }
  tc::cp_async_wait<0>();
  __syncthreads();
}

// The ring slots of A (and of a streamed B) in dynamic shared memory.
template <class C, int WB>
struct Ring {
  typename C::Elem* as;
  unsigned char* bs;
  int wc;
  __device__ const typename C::Elem* a(int slot) const { return as + slot * C::A_ELEMS; }
  __device__ auto b(int slot, int) const {
    return ring_frags<C, WB>(bs + slot * C::b_bytes(WB), wc);
  }
};

// OS: one CTA per (channel tile, image x pixel tile, split part).
template <class C, int WB, bool VEC>
__global__ void __launch_bounds__(C::NT)
conv_os_kernel(const typename C::Elem* __restrict__ x, const void* __restrict__ w,
               const uint32_t* __restrict__ w_hi, void* __restrict__ out, Geo g, Epi e,
               int split, int* __restrict__ ws, unsigned* __restrict__ counters) {
  using T = typename C::Elem;
  extern __shared__ __align__(16) unsigned char smem[];
  const Ring<C, WB> ring{reinterpret_cast<T*>(smem), smem + C::STAGES * C::A_BYTES,
                         (int)(threadIdx.x >> 5) % C::WN * (C::TBN / C::WN)};
  const int tiles = cdiv(g.p, C::TBM);
  const int col0 = blockIdx.x * C::TBN, n_img = blockIdx.y / tiles;
  const int q0 = (blockIdx.y % tiles) * C::TBM;
  const int wr = (int)(threadIdx.x >> 5) / C::WN * (C::TBM / C::WM), wc = ring.wc;
  const T* img = x + (size_t)n_img * g.h * g.w * g.cin;
  const int steps = steps_of<C>(g), per = cdiv(steps, split);
  const int s0 = min(steps, (int)blockIdx.z * per), s1 = min(steps, s0 + per);
  int base[C::ROWS];
  if constexpr (VEC) pixel_bases<C>(base, g, q0);
  Cursor cur;
  cur.start(g, s0 * C::TBK + gather_col<C, VEC>());
  typename C::Acc acc[C::MI][C::NI][4];
  zero<C>(acc);
  kloop<C>(
      acc, g, s0, s1, wr,
      [&](int slot, int) {
        gather_a<C, VEC, false>(ring.as + slot * C::A_ELEMS, img, g, base, q0, cur.offset(g));
        cur.advance(g, C::TBK);
      },
      [&](int slot, int k0) {
        load_b<C, WB, VEC>(ring.bs + slot * C::b_bytes(WB), w, w_hi, g, k0, col0);
      },
      ring);
  if constexpr (C::INT) {
    if (split > 1) {  // the tile's last CTA adds every part's sums
      __shared__ int last;
      constexpr int R = C::MI * C::NI * 4;
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      int* part = ws + ((size_t)tile * split + blockIdx.z) * R * C::NT + threadIdx.x;
#pragma unroll
      for (int i = 0; i < R; ++i) part[i * C::NT] = acc[i / (C::NI * 4)][i / 4 % C::NI][i % 4];
      __threadfence();
      __syncthreads();
      // atomicInc stores 0 where the count reaches split - 1: the last CTA.
      if (threadIdx.x == 0)
        last = atomicInc(counters + tile, split - 1) == (unsigned)(split - 1);
      __syncthreads();
      if (!last) return;
      __threadfence();
      for (int z = 0; z < split; ++z) {
        if (z == (int)blockIdx.z) continue;
        const int* other = ws + ((size_t)tile * split + z) * R * C::NT + threadIdx.x;
#pragma unroll
        for (int i = 0; i < R; ++i)
          acc[i / (C::NI * 4)][i / 4 % C::NI][i % 4] += __ldcg(other + i * C::NT);
      }
    }
  }
  flush<C, WB>(acc, out, img, g, n_img, q0, col0, wr, wc, e, smem);
}

// The WS-resident weight block of channel tile col0 (64 columns, K rounded
// up to 32 rows), and its B fragments at step k0.
template <class C, int WB>
struct WsBlock {
  static_assert(C::TBN == 64 && C::TBK == 32, "the walks' 64-channel, 32-deep steps");
  const void* res;
  int kp, wc;

  // Bytes of the block (conv2d_df.plan's resident operand).
  __host__ static size_t bytes(const Geo& g) {
    const int kp = round_up(g.k, 32);
    return WB ? pack::panel_bytes<WB == 5 ? 5 : 4>(kp, C::TBN)
              : (size_t)kp * C::TBN * sizeof(typename C::Elem);
  }
  template <bool VEC>
  __device__ static void load(void* dst, const void* w, const uint32_t* w_hi, const Geo& g,
                              int col0) {
    const int kp = round_up(g.k, 32);
    if constexpr (WB != 0) {  // the planes as load_panel lays them out
      pack::load_panel<WB, C::NT>(static_cast<uint32_t*>(dst), static_cast<const uint32_t*>(w),
                                  w_hi, g.cout, kp, col0, C::TBN, g.cout);
    } else if constexpr (C::INT) {  // i8's swizzled units, 32 rows at a time
      for (int k0 = 0; k0 < kp; k0 += 32)
        gemm::i8::copy_b<0, VEC, C::NT, 32, C::TBN>(static_cast<int8_t*>(dst) + k0 * C::TBN, w,
                                                    nullptr, g.cout, g.k, k0, col0);
    } else {  // bf16 rows of 8 units, unit u of row kk at u ^ (kk & 7)
      auto* d = static_cast<__nv_bfloat16*>(dst);
      const auto* src = static_cast<const __nv_bfloat16*>(w);
      for (int i = threadIdx.x; i < kp * 8; i += C::NT) {
        const int kk = i / 8, u = i % 8, c = col0 + u * 8;
        __nv_bfloat16* to = d + (kk * 8 + (u ^ (kk & 7))) * 8;
        if constexpr (VEC) {
          const bool in = kk < g.k && c < g.cout;
          tc::cp_async16(to, in ? src + (size_t)kk * g.cout + c : src, in);
        } else {
#pragma unroll
          for (int v = 0; v < 8; ++v)
            to[v] = kk < g.k && c + v < g.cout ? src[(size_t)kk * g.cout + c + v]
                                               : gemm::tzero<__nv_bfloat16>();
        }
      }
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
  }
  __device__ auto frags(int k0) const {
    const int wc_ = wc, kp_ = kp;
    const void* r = res;
    return [=](int q, uint32_t (&bf)[C::NI][2]) {
      if constexpr (WB != 0) {
        const auto* p = static_cast<const uint32_t*>(r);
        gemm::i8::frag_b_packed<WB, C::NI>(bf, p + k0 / 8 * C::TBN,
                                           p + (kp_ / 8 + k0 / 32) * C::TBN, C::TBN, q, wc_);
      } else if constexpr (C::INT) {
        gemm::i8::Frags<0, C::TBK, C::TBN, C::NI>::b(
            bf, static_cast<const int8_t*>(r) + k0 * C::TBN, q, wc_);
      } else {
        const auto* p = static_cast<const __nv_bfloat16*>(r);
        const int l = tc::lane();
#pragma unroll
        for (int ni = 0; ni < C::NI; ni += 2) {
          const int row = k0 + q * 16 + (l & 7) + ((l >> 3) & 1) * 8;
          const int unit = (wc_ + ni * 8) / 8 + (l >> 4);
          uint32_t t[4];
          tc::ldmatrix_x4_trans(t, p + (row * 8 + (unit ^ (row & 7))) * 8);
          bf[ni][0] = t[0];
          bf[ni][1] = t[1];
          bf[ni + 1][0] = t[2];
          bf[ni + 1][1] = t[3];
        }
      }
    };
  }
};

// The WS walk's operands: A from the ring, B from the resident block.
template <class C, int WB>
struct WsSource {
  typename C::Elem* as;
  WsBlock<C, WB> block;
  __device__ const typename C::Elem* a(int slot) const { return as + slot * C::A_ELEMS; }
  __device__ auto b(int, int k0) const { return block.frags(k0); }
};

// WS: CTA j holds channel tile j's weight block and walks every (image,
// pixel tile); A streams through the ring (in the first TILE_BYTES of
// dynamic shared memory), the block after it.
template <class C, int WB, bool VEC>
__global__ void __launch_bounds__(C::NT)
conv_ws_kernel(const typename C::Elem* __restrict__ x, const void* __restrict__ w,
               const uint32_t* __restrict__ w_hi, void* __restrict__ out, Geo g, Epi e) {
  using T = typename C::Elem;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, wr = warp / C::WN * (C::TBM / C::WM);
  const int wc = warp % C::WN * (C::TBN / C::WN), col0 = blockIdx.x * C::TBN;
  T* as = reinterpret_cast<T*>(smem);
  const WsBlock<C, WB> block{smem + TILE_BYTES, round_up(g.k, 32), wc};
  WsBlock<C, WB>::template load<VEC>(smem + TILE_BYTES, w, w_hi, g, col0);
  const WsSource<C, WB> frags{as, block};
  const int tiles = cdiv(g.p, C::TBM), steps = steps_of<C>(g);
  const size_t hwc = (size_t)g.h * g.w * g.cin;
  for (int n_img = 0; n_img < g.n; ++n_img)
    for (int t = 0; t < tiles; ++t) {
      const T* img = x + n_img * hwc;
      const int q0 = t * C::TBM;
      int base[C::ROWS];
      if constexpr (VEC) pixel_bases<C>(base, g, q0);
      Cursor cur;
      cur.start(g, gather_col<C, VEC>());
      typename C::Acc acc[C::MI][C::NI][4];
      zero<C>(acc);
      kloop<C>(
          acc, g, 0, steps, wr,
          [&](int slot, int) {
            gather_a<C, VEC, false>(as + slot * C::A_ELEMS, img, g, base, q0, cur.offset(g));
            cur.advance(g, C::TBK);
          },
          [](int, int) {}, frags);
      flush<C, WB>(acc, out, img, g, n_img, q0, col0, wr, wc, e, smem);
    }
}

// Bytes of image n in shared memory (IS), rounded up to 16.
__host__ __device__ inline size_t image_bytes(const Geo& g, int elt) {
  return ((size_t)g.h * g.w * g.cin * elt + 15) / 16 * 16;
}

// IS: CTA n holds image n (after the ring's TILE_BYTES) and walks (channel
// tile, pixel tile); each step's A rows are copied from it into the ring,
// B streams.
template <class C, int WB, bool VEC>
__global__ void __launch_bounds__(C::NT)
conv_is_kernel(const typename C::Elem* __restrict__ x, const void* __restrict__ w,
               const uint32_t* __restrict__ w_hi, void* __restrict__ out, Geo g, Epi e) {
  using T = typename C::Elem;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, wr = warp / C::WN * (C::TBM / C::WM);
  const int wc = warp % C::WN * (C::TBN / C::WN), n_img = blockIdx.x;
  const Ring<C, WB> ring{reinterpret_cast<T*>(smem), smem + C::STAGES * C::A_BYTES, wc};
  T* res = reinterpret_cast<T*>(smem + TILE_BYTES);
  const size_t hwc = (size_t)g.h * g.w * g.cin;
  const T* img = x + n_img * hwc;
  {  // the image, in 16-byte units where its start allows, then the tail
    size_t done = 0;
    if (reinterpret_cast<uintptr_t>(img) % 16 == 0) {
      const size_t units = hwc * sizeof(T) / 16;
      for (size_t i = threadIdx.x; i < units; i += C::NT)
        tc::cp_async16(reinterpret_cast<uint4*>(res) + i, reinterpret_cast<const uint4*>(img) + i,
                       true);
      done = units * 16 / sizeof(T);
    }
    for (size_t i = done + threadIdx.x; i < hwc; i += C::NT) res[i] = img[i];
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
  }
  const int tiles = cdiv(g.p, C::TBM), steps = steps_of<C>(g), gn = cdiv(g.cout, C::TBN);
  for (int j = 0; j < gn; ++j)
    for (int t = 0; t < tiles; ++t) {
      const int q0 = t * C::TBM, col0 = j * C::TBN;
      int base[C::ROWS];
      if constexpr (VEC) pixel_bases<C>(base, g, q0);
      Cursor cur;
      cur.start(g, gather_col<C, VEC>());
      typename C::Acc acc[C::MI][C::NI][4];
      zero<C>(acc);
      kloop<C>(
          acc, g, 0, steps, wr,
          [&](int slot, int) {
            gather_a<C, VEC, true>(ring.as + slot * C::A_ELEMS, res, g, base, q0, cur.offset(g));
            cur.advance(g, C::TBK);
          },
          [&](int slot, int k0) {
            load_b<C, WB, VEC>(ring.bs + slot * C::b_bytes(WB), w, w_hi, g, k0, col0);
          },
          ring);
      flush<C, WB>(acc, out, img, g, n_img, q0, col0, wr, wc, e, smem);
    }
}

// The library's tiles (conv2d_df.py keeps a copy, checked against each
// launch's report), from the sweep (bench/conv_sweep.cu, PERF.md): OS in
// 64-deep steps (bf16: four chunks a step, 5-13% faster than two at the
// 32 x 32 tile), the 128 x 64 bf16 tile on 3 stages; the walks: 64 x 64 on 4
// warps in 32-deep steps (bf16 IS in 16-deep steps, so that A and B stages
// fit TILE_BYTES).
template <typename T>
using Os0 = Cfg<T, 128, 64, 64, std::is_same<T, int8_t>::value ? 4 : 3, 4, 2>;
template <typename T>
using Os1 = Cfg<T, 64, 64, 64, 4, 2, 2>;
template <typename T>
using Os2 = Cfg<T, 32, 32, 64, 4, 2, 2>;
constexpr int OS_TILES = 3;
using WsI8 = Cfg<int8_t, 64, 64, 32, 4, 2, 2>;
using IsI8 = Cfg<int8_t, 64, 64, 32, 4, 2, 2>;
using WsBf16 = Cfg<__nv_bfloat16, 64, 64, 32, 3, 2, 2>;
using IsBf16 = Cfg<__nv_bfloat16, 64, 64, 16, 3, 2, 2>;
static_assert(WsI8::ring(0, false) <= TILE_BYTES && IsI8::ring(0, true) <= TILE_BYTES &&
                  IsI8::ring(5, true) <= TILE_BYTES && WsBf16::ring(0, false) <= TILE_BYTES &&
                  IsBf16::ring(0, true) <= TILE_BYTES,
              "the walks' rings fit the staging the f32 walk takes");

// The rule's target: two CTAs an SM for integers, one for bf16, which
// cannot split k and so buys CTAs only with narrower tiles (at the
// ResNet-18 and VGG layers the sweep's fastest tiles and splits gave 1.4
// to 4.8 CTAs an SM for int8, 0.1 to 2.8 for bf16; bench/conv_sweep.cu).
// The integer split of k: parts of at least MIN_PART steps, at most
// MAX_SPLIT.
template <typename T>
constexpr int TARGET_CTAS = std::is_same<T, int8_t>::value ? 2 * CARD_SMS : CARD_SMS;
constexpr int MIN_PART = 5, MAX_SPLIT = 8;

// The OS tile (index into Os0..Os2) and split the rule takes for g: the
// first tile whose CTAs reach TARGET_CTAS, an integer conv splitting k as
// far as that needs, else the last tile with its split.
struct OsChoice {
  int tile, ctas, split;
};
template <typename T>
OsChoice os_tile(const Geo& g) {
  const int tbm[OS_TILES] = {Os0<T>::TBM, Os1<T>::TBM, Os2<T>::TBM};
  const int tbn[OS_TILES] = {Os0<T>::TBN, Os1<T>::TBN, Os2<T>::TBN};
  const int steps = cdiv(round_up(g.k, 32), Os0<T>::TBK);  // every OS tile's TBK
  OsChoice c{};
  for (int i = 0; i < OS_TILES; ++i) {
    const int outputs = g.n * cdiv(g.p, tbm[i]) * cdiv(g.cout, tbn[i]);
    const int split = std::is_same<T, int8_t>::value
                          ? std::max(1, std::min({cdiv(TARGET_CTAS<T>, outputs),
                                                  steps / MIN_PART, MAX_SPLIT}))
                          : 1;
    c = {i, outputs, split};
    if ((long long)outputs * split >= TARGET_CTAS<T>) break;
  }
  return c;
}

template <class C, int WB>
bool vec_ok(const void* x, const void* w, const void* w_hi, const Geo& g) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int n_unit = C::INT ? (WB == 0 ? 16 : 4) : 8;
  return aligned(x) && aligned(w) && (WB != 5 || aligned(w_hi)) && g.cin % C::EPU == 0 &&
         g.cout % n_unit == 0;
}

// Launches `kernel` over `grid` with `smem` bytes of dynamic shared memory
// (opting in above 48 KB).
template <typename K, typename... Args>
int launch_kernel(K kernel, dim3 grid, int nt, size_t smem, cudaStream_t stream,
                  Args... args) {
  if (smem > gemm::MAX_SMEM) return REPRO_BAD_ARGUMENT;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, nt, smem, stream>>>(args...);
  return launch_status();
}

// The OS tile C over the whole conv with k split `split` ways (integers;
// ws: split x CTAs x TBM x TBN int32 partial sums, counters: one zeroed
// counter per output tile).
template <class C, int WB>
int launch_os(const void* x, const void* w, const void* w_hi, void* out, const Geo& g,
              const Epi& e, int split, int* ws, size_t ws_ints, unsigned* counters,
              int n_counters, cudaStream_t stream, gemm::Took* took) {
  const int tiles = cdiv(g.p, C::TBM), gn = cdiv(g.cout, C::TBN);
  if ((long long)tiles * g.n > 65535 || split < 1 || split > MAX_SPLIT ||
      (!C::INT && split != 1))
    return REPRO_BAD_ARGUMENT;
  const size_t outputs = (size_t)tiles * g.n * gn;
  if (split > 1 && (!ws || !counters || ws_ints < outputs * split * C::TBM * C::TBN ||
                    (size_t)n_counters < outputs))
    return REPRO_BAD_ARGUMENT;
  const dim3 grid(gn, tiles * g.n, split);
  const size_t smem = C::ring(WB, true);
  static_assert(C::TBM * C::SLD * 4 <= C::ring(WB, true), "the flush stages in the ring");
  if (took)
    *took = {C::INT ? TILE_OS_I8 : TILE_OS_BF16, (int)smem, (int)(outputs * split), split};
  using T = typename C::Elem;
  const auto kernel = vec_ok<C, WB>(x, w, w_hi, g) ? conv_os_kernel<C, WB, true>
                                                  : conv_os_kernel<C, WB, false>;
  return launch_kernel(kernel, grid, C::NT, smem, stream, static_cast<const T*>(x), w,
                       static_cast<const uint32_t*>(w_hi), out, g, e, split, ws, counters);
}

// A walk (WS: WALK_M, IS: WALK_N) of tile C: its ring in TILE_BYTES, the
// resident operand after it.
template <class C, int WB, int WALK>
int launch_walk(const void* x, const void* w, const void* w_hi, void* out, const Geo& g,
                const Epi& e, cudaStream_t stream, gemm::Took* took) {
  using T = typename C::Elem;
  size_t smem = TILE_BYTES;
  static_assert(C::TBM * C::SLD * 4 <= TILE_BYTES, "the flush stages in the ring's bytes");
  if constexpr (WALK == WALK_M) smem += WsBlock<C, WB>::bytes(g);
  else smem += image_bytes(g, sizeof(T));
  const dim3 grid(WALK == WALK_M ? cdiv(g.cout, C::TBN) : g.n);
  if (took)
    *took = {WALK == WALK_M ? (C::INT ? TILE_WS_I8 : TILE_WS_BF16)
                            : (C::INT ? TILE_IS_I8 : TILE_IS_BF16),
             (int)smem, (int)grid.x, 1};
  const bool vec = vec_ok<C, WB>(x, w, w_hi, g);
  auto pick = [&](auto vec_kernel, auto elem_kernel) {
    return launch_kernel(vec ? vec_kernel : elem_kernel, grid, C::NT, smem, stream,
                         static_cast<const T*>(x), w, static_cast<const uint32_t*>(w_hi), out,
                         g, e);
  };
  if constexpr (WALK == WALK_M)
    return pick(conv_ws_kernel<C, WB, true>, conv_ws_kernel<C, WB, false>);
  else
    return pick(conv_is_kernel<C, WB, true>, conv_is_kernel<C, WB, false>);
}

}  // namespace conv
