// B1's int8 basic OS launch on Hopper's integer tensor cores: int8 A with an
// int8 B or the packed int4/int5 planes of repro_torch/kernels/pack.py (B6),
// in the tile that serving's prefill takes (M > 16) and the one its decode
// takes (M <= 16).
//
// Replaces the int8 path of repro/kernels/matmul_df.py `_os_kernel`, which
// runs the int8 dot on the MXU with int32 results and decodes a packed block
// once per VMEM load (`_load_b`, pack.py `unpack_block`). Here each 32-deep
// k chunk is one mma.sync m16n8k32 .s8 (mma_common.cuh mma_s8) added into
// int32 accumulators. Integer sums are exact in any order and cannot
// overflow here (|sum| <= 127 * 128 * K < 2^31 for K < 2^17), so every
// output equals the integer walk's (gemm_common.cuh, every residency, B4,
// B5) bit for bit whatever the tile, the k order or the fragment layout.
// No split-k, in a CTA or across CTAs.
//
// Fragments: lane t of a quad takes physical k 8t..8t+7 of each 32-deep
// chunk for A and B alike (mma_s8's note), so that
// - A: two 8-byte shared loads a 16-row block (rows g and g + 8), from a
//   row-major int8 tile whose row stride keeps them free of bank conflicts;
// - a packed B: one nibble word is one lane's whole fragment (8 rows of one
//   column), decoded in registers (pack_common.cuh decode_frag). The planes
//   are staged packed by cp.async; lane g of a warp takes NI neighbouring
//   columns, so its words for the NI column tiles are one vector load;
// - a dense B (K, N) row-major: ldmatrix .trans cannot transpose bytes, so
//   one ldmatrix.x4.trans reads a 32 x 16 byte block as 2 x 2 byte pairs,
//   rows chosen so that lane t holds rows 8t..8t+7 of columns 2g and
//   2g + 1, and four byte permutes split them into the fragments of two
//   column tiles (the even and the odd columns of the 16). The tile's
//   16-byte units are XOR-swizzled so each ldmatrix phase hits 8 distinct
//   bank groups.
//
// Prefill tile (i8_prefill_kernel): a CTA owns a TBM x TBN output tile, its
// WM x WN warps each (TBM/WM) x (TBN/WN) (MI x NI mma tiles), A and B
// streaming through a STAGES-deep cp.async ring of TBK-deep k steps. Bound
// at M = 512: the int8 tensor cores' operations (12.9 GOP: 6.5 us).
//
// Decode tile (i8_decode_kernel): M <= 16 rows are one m16 block; a CTA owns
// TBN columns, each of its NW warps TBN/NW of them over the whole k loop. The
// weight stream bounds it (6.3 MB packed at K = 6144, N = 2048: 1.9 us at
// 3.35 TB/s), so B streams through a deep ring of long k steps; only A's
// real rows are copied, its padding rows stay zero. Chunks rotate over NACC
// accumulator sets, summed at the flush, so successive mmas do not wait on
// each other.
//
// Both flush as the walks do: the packed weight's outlier sidecar is added
// to the int32 accumulator that owns (row, col), then the int32 result is
// written as it is with no epilogue stage, else converted to f32 and put
// through B1's epilogue (store_one). Operands that are not whole 16-byte
// vectors (K not a multiple of 16, N not a multiple of 16 (dense) or 4
// (packed words), an unaligned pointer) take element loads into the same
// rings. The tile shapes come from a sweep on an H100 (bench/tile_sweep.cu,
// PERF.md).
#pragma once

#include "gemm_common.cuh"

namespace gemm {
namespace i8 {

// Bytes of a row of a k step's A tile: the 8-byte fragment loads of rows
// g = 0..3 then fall on distinct 32-byte bank groups (stride = 32 or 96
// mod 128).
__host__ __device__ constexpr int a_ld(int tbk) {
  return tbk % 64 == 0 ? tbk + 32 : tbk;
}
// Words of a row of a packed k step's planes (8 words of padding: the
// fragment loads of 4 word rows fall on distinct banks).
__host__ __device__ constexpr int w_ld(int tbn) { return tbn + 8; }
// Bytes of one k step's B tile.
__host__ __device__ constexpr int b_bytes(int wb, int tbk, int tbn) {
  return wb == 0 ? tbk * tbn
                 : (tbk / pack::WORD_NIBBLES + (wb == 5 ? tbk / pack::WORD_BITS : 0)) *
                       w_ld(tbn) * 4;
}

// The 16-byte unit that holds (row kk, unit c) of a dense B tile with C
// units a row: the unit index XOR-swizzled in its low 3 bits by higher
// bits of kk, so the 8 rows {8i + 2j + b} one ldmatrix phase reads fall on
// 8 distinct units mod 8 (bank groups).
template <int C>
__device__ __forceinline__ int b_unit(int kk, int c) {
  int z;
  if constexpr (C == 1) z = ((kk >> 3) & 3) << 1;
  else if constexpr (C == 2) z = ((kk >> 3) & 1) | (((kk >> 4) & 1) << 2);
  else if constexpr (C == 4) z = (kk >> 3) & 3;
  else z = ((kk >> 3) & 3) | ((kk & 1) << 2);
  return (kk * C + c) ^ z;
}

// The A fragment of rows r0.. (16), chunk kb.. (32) of a row-major int8 tile
// with ld bytes a row.
__device__ __forceinline__ void frag_a(uint32_t f[4], const int8_t* s, int ld,
                                       int r0, int kb) {
  const int g = tc::lane() >> 2, t = tc::lane() & 3;
  const uint2 lo = *reinterpret_cast<const uint2*>(s + (r0 + g) * ld + kb + 8 * t);
  const uint2 hi = *reinterpret_cast<const uint2*>(s + (r0 + g + 8) * ld + kb + 8 * t);
  f[0] = lo.x;
  f[1] = hi.x;
  f[2] = lo.y;
  f[3] = hi.y;
}

// The B fragments of the even (fe) and odd (fo) columns of 16-byte unit cg,
// chunk kb.. (32), of a dense B tile with C units a row.
template <int C>
__device__ __forceinline__ void frag_b_dense(uint32_t fe[2], uint32_t fo[2],
                                             const int8_t* s, int kb, int cg) {
  const int l = tc::lane(), j = l >> 3, i = l & 7;
  uint32_t r[4];  // r[j]: rows 8t + 2j, 8t + 2j + 1 of columns 2g, 2g + 1
  tc::ldmatrix_x4_trans(r, s + b_unit<C>(kb + 8 * (i >> 1) + 2 * j + (i & 1), cg) * 16);
  fe[0] = __byte_perm(r[0], r[1], 0x6420);
  fo[0] = __byte_perm(r[0], r[1], 0x7531);
  fe[1] = __byte_perm(r[2], r[3], 0x6420);
  fo[1] = __byte_perm(r[2], r[3], 0x7531);
}

// NI consecutive 32-bit words from shared memory (4 * NI-byte aligned).
template <int NI>
__device__ __forceinline__ void load_words(uint32_t w[NI], const uint32_t* p) {
  if constexpr (NI % 4 == 0) {
#pragma unroll
    for (int v = 0; v < NI; v += 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + v);
      w[v] = x.x;
      w[v + 1] = x.y;
      w[v + 2] = x.z;
      w[v + 3] = x.w;
    }
  } else if constexpr (NI == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x;
    w[1] = x.y;
  } else {
#pragma unroll
    for (int v = 0; v < NI; ++v) w[v] = p[v];
  }
}

// The B operand of a tile kernel, by weight bits WB: its fragments for a
// warp's NI column tiles (columns wc.. of the tile) at chunk q of a k step,
// and the tile column of accumulator element j of column tile ni.
template <int WB, int TBK, int TBN, int NI>
struct Frags;

template <int TBK, int TBN, int NI>
struct Frags<0, TBK, TBN, NI> {  // dense int8 B: column pairs per 16
  static_assert(NI % 2 == 0 && TBN % 16 == 0, "dense B tiles pair columns");
  static constexpr int C = TBN / 16;
  __device__ static __forceinline__ void b(uint32_t f[NI][2], const void* bt,
                                           int q, int wc) {
#pragma unroll
    for (int ni = 0; ni < NI; ni += 2)
      frag_b_dense<C>(f[ni], f[ni + 1], static_cast<const int8_t*>(bt), q * 32,
                      wc / 16 + ni / 2);
  }
  __device__ static __forceinline__ int col(int wc, int ni, int j) {
    return wc + 16 * (ni >> 1) + 4 * (tc::lane() & 3) + 2 * (j & 1) + (ni & 1);
  }
};

template <int WB, int TBK, int TBN, int NI>
struct Frags {  // packed planes: lane g takes columns wc + g * NI + ni
  static constexpr int LD = w_ld(TBN);
  __device__ static __forceinline__ void b(uint32_t f[NI][2], const void* bt,
                                           int q, int wc) {
    const int g = tc::lane() >> 2, t = tc::lane() & 3;
    const uint32_t* words = static_cast<const uint32_t*>(bt);
    uint32_t w[NI], h[NI];
    load_words<NI>(w, words + (q * 4 + t) * LD + wc + g * NI);
    if constexpr (WB == 5)
      load_words<NI>(h, words + (TBK / pack::WORD_NIBBLES + q) * LD + wc + g * NI);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      pack::decode_frag<WB>(w[ni], WB == 5 ? h[ni] >> (8 * t) : 0u, f[ni]);
  }
  __device__ static __forceinline__ int col(int wc, int ni, int j) {
    return wc + (2 * (tc::lane() & 3) + (j & 1)) * NI + ni;
  }
};

// Copies one k step of A (rows r0.. (rows of them, only those < m), k bytes
// k0.. (TBK)) into a row-major tile of LD bytes a row: 16-byte cp.async
// units when VEC, single bytes otherwise; zeros past m and k.
template <bool VEC, int NT, int TBK, int LD>
__device__ __forceinline__ void copy_a(int8_t* dst, const int8_t* a, int m,
                                       int k, int r0, int k0, int rows) {
  if constexpr (VEC) {
    constexpr int U = TBK / 16;
    for (int i = threadIdx.x; i < rows * U; i += NT) {
      const int r = i / U, c = (i % U) * 16;
      const bool in = r0 + r < m && k0 + c < k;
      tc::cp_async16(dst + r * LD + c, in ? a + (size_t)(r0 + r) * k + k0 + c : a, in);
    }
  } else {
    for (int i = threadIdx.x; i < rows * TBK; i += NT) {
      const int r = i / TBK, c = i % TBK;
      const bool in = r0 + r < m && k0 + c < k;
      dst[r * LD + c] = in ? a[(size_t)(r0 + r) * k + k0 + c] : int8_t(0);
    }
  }
}

// Copies one k step of B (k rows k0.. (TBK), columns c0.. (TBN)) into the
// tile layout of WB: a dense int8 B (k, n) into swizzled 16-byte units, or
// the packed planes (kp/8, n) and (kp/32, n) words, rows of w_ld(TBN) words;
// zeros outside.
template <int WB, bool VEC, int NT, int TBK, int TBN>
__device__ __forceinline__ void copy_b(void* dst, const void* b, const uint32_t* b_hi,
                                       int n, int k, int k0, int c0) {
  if constexpr (WB == 0) {
    constexpr int C = TBN / 16;
    int8_t* d = static_cast<int8_t*>(dst);
    const int8_t* src = static_cast<const int8_t*>(b);
    for (int i = threadIdx.x; i < TBK * C; i += NT) {
      const int r = i / C, u = i % C, gk = k0 + r, gc = c0 + u * 16;
      int8_t* to = d + b_unit<C>(r, u) * 16;
      if constexpr (VEC) {
        const bool in = gk < k && gc < n;
        tc::cp_async16(to, in ? src + (size_t)gk * n + gc : src, in);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          to[e] = gk < k && gc + e < n ? src[(size_t)gk * n + gc + e] : int8_t(0);
      }
    }
  } else {
    constexpr int LD = w_ld(TBN), U = TBN / 4;
    constexpr int NW = TBK / pack::WORD_NIBBLES, NH = WB == 5 ? TBK / pack::WORD_BITS : 0;
    const int kp = round_up(k, pack::WORD_BITS);
    uint32_t* d = static_cast<uint32_t*>(dst);
    for (int i = threadIdx.x; i < (NW + NH) * U; i += NT) {
      const int r = i / U, c = (i % U) * 4, gc = c0 + c;
      const bool hi = r >= NW;  // a bit-plane row
      const int gr = hi ? k0 / pack::WORD_BITS + r - NW : k0 / pack::WORD_NIBBLES + r;
      const int rows = hi ? kp / pack::WORD_BITS : kp / pack::WORD_NIBBLES;
      const uint32_t* src = hi ? b_hi : static_cast<const uint32_t*>(b);
      uint32_t* to = d + r * LD + c;
      if constexpr (VEC) {
        const bool in = gr < rows && gc < n;
        tc::cp_async16(to, in ? src + (size_t)gr * n + gc : src, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          to[e] = gr < rows && gc + e < n ? src[(size_t)gr * n + gc + e] : 0u;
      }
    }
  }
}

// The flush of a warp's MI x NI int32 accumulators: row_of(mi, j) and
// col_of(ni, j) give the output row and column of element j of mma tile
// (mi, ni). The outlier sidecar is added to the element that owns (row,
// col), then the walks' store. The warp reads the sidecar's slot indices 32
// at a time, one a lane, and walks only the filled slots (a ballot), so the
// empty capacity costs no chain of dependent loads.
template <int MI, int NI, class Row, class Col>
__device__ __forceinline__ void flush(int acc[MI][NI][4], Row row_of, Col col_of,
                                      void* c, int m, int n, const Epi& e) {
  for (int s0 = 0; s0 < e.sr; s0 += 32) {
    const int mine = s0 + tc::lane() < e.sr ? e.sidx[s0 + tc::lane()] : -1;
    unsigned filled = __ballot_sync(0xffffffffu, mine >= 0 && mine < e.sk);
    while (filled) {
      const int bit = __ffs(filled) - 1, s = s0 + bit;
      filled &= filled - 1;
      const int kc = __shfl_sync(0xffffffffu, mine, bit);
      int av[MI][2], dv[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row_of(mi, 2 * h);
          av[mi][h] = r < m ? e.sa[(size_t)r * e.sk + kc] : 0;
        }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cc = col_of(ni, h);
          dv[ni][h] = cc < n ? e.sdelta[(size_t)s * n + cc] : 0;
        }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] += av[mi][j >> 1] * dv[ni][j & 1];
    }
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = row_of(mi, j), cc = col_of(ni, j);
        if (r >= m || cc >= n) continue;
        if (e.out_dtype == REPRO_I32)
          static_cast<int*>(c)[(size_t)r * n + cc] = acc[mi][ni][j];
        else
          store_one(c, to_float(acc[mi][ni][j]), r, cc, n, e);
      }
}

// A prefill tile: TBM x TBN outputs per CTA, WM x WN warps (each MI x NI
// mma tiles of 16 x 8), TBK-deep k steps through a STAGES-deep ring.
template <int TBM_, int TBN_, int TBK_, int STAGES_, int WM_, int WN_>
struct PrefillCfg {
  static constexpr int TBM = TBM_, TBN = TBN_, TBK = TBK_, STAGES = STAGES_;
  static constexpr int WM = WM_, WN = WN_, NT = WM * WN * 32;
  static constexpr int MI = TBM / WM / 16, NI = TBN / WN / 8;
  static constexpr int ALD = a_ld(TBK), A_BYTES = TBM * ALD;
  static constexpr size_t smem(int wb) {
    return (size_t)STAGES * (A_BYTES + b_bytes(wb, TBK, TBN));
  }
  static_assert(TBK % 32 == 0 && TBN % 8 == 0, "32-deep chunks, 8-column tiles");
};

template <class C, bool VEC, int WB>
__global__ void __launch_bounds__(C::NT)
i8_prefill_kernel(const int8_t* __restrict__ a, const void* __restrict__ b,
                  const uint32_t* __restrict__ b_hi, void* __restrict__ c,
                  int m, int n, int k, Epi e) {
  using F = Frags<WB, C::TBK, C::TBN, C::NI>;
  constexpr int B_BYTES = b_bytes(WB, C::TBK, C::TBN);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* as = reinterpret_cast<int8_t*>(smem);
  unsigned char* bs = smem + C::STAGES * C::A_BYTES;
  const int row0 = blockIdx.y * C::TBM, col0 = blockIdx.x * C::TBN;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp / C::WN) * (C::TBM / C::WM), wc = (warp % C::WN) * (C::TBN / C::WN);
  const int kp = round_up(k, BK), steps = cdiv(kp, C::TBK);
  int acc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  auto load = [&](int s) {
    const int slot = s % C::STAGES, k0 = s * C::TBK;
    copy_a<VEC, C::NT, C::TBK, C::ALD>(as + slot * C::A_BYTES, a, m, k, row0, k0, C::TBM);
    copy_b<WB, VEC, C::NT, C::TBK, C::TBN>(bs + slot * B_BYTES, b, b_hi, n, k, k0, col0);
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps) load(s);
    tc::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<C::STAGES - 2>();  // step s has landed
    __syncthreads();                     // and step s - 1's slot is consumed
    if (s + C::STAGES - 1 < steps) load(s + C::STAGES - 1);
    tc::cp_async_commit();
    const int8_t* at = as + (s % C::STAGES) * C::A_BYTES;
    const unsigned char* bt = bs + (s % C::STAGES) * B_BYTES;
    // A last step reaching past kp adds chunks of zeros (A is zero past
    // k): no branch, so the chunks' loads need not wait on each other's mma
    // (a branch at kp there doubled the decode tile's time on an H100).
#pragma unroll
    for (int q = 0; q < C::TBK / 32; ++q) {
      uint32_t af[C::MI][4], bf[C::NI][2];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi) frag_a(af[mi], at, C::ALD, wr + mi * 16, q * 32);
      F::b(bf, bt, q, wc);
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni) tc::mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  tc::cp_async_wait<0>();

  const int g = tc::lane() >> 2;
  flush<C::MI, C::NI>(
      acc, [&](int mi, int j) { return row0 + wr + mi * 16 + g + (j >> 1) * 8; },
      [&](int ni, int j) { return col0 + F::col(wc, ni, j); }, c, m, n, e);
}

// A decode tile: the M <= 16 rows by TBN columns per CTA, NW warps of
// TBN/NW columns, TBK-deep k steps through a STAGES-deep ring.
template <int TBN_, int NW_, int TBK_, int STAGES_>
struct DecodeCfg {
  static constexpr int MAX_M = 16, TBN = TBN_, NW = NW_, TBK = TBK_, STAGES = STAGES_;
  static constexpr int NT = NW * 32, NI = TBN / NW / 8;
  static constexpr int NACC = TBK / 32 < 4 ? TBK / 32 : 4;
  static constexpr int ALD = a_ld(TBK), A_BYTES = MAX_M * ALD;
  static constexpr size_t smem(int wb) {
    return (size_t)STAGES * (A_BYTES + b_bytes(wb, TBK, TBN));
  }
  static_assert(TBK % 32 == 0 && TBN % 8 == 0, "32-deep chunks, 8-column tiles");
};

template <class C, bool VEC, int WB>
__global__ void __launch_bounds__(C::NT)
i8_decode_kernel(const int8_t* __restrict__ a, const void* __restrict__ b,
                 const uint32_t* __restrict__ b_hi, void* __restrict__ c,
                 int m, int n, int k, Epi e) {
  using F = Frags<WB, C::TBK, C::TBN, C::NI>;
  constexpr int B_BYTES = b_bytes(WB, C::TBK, C::TBN);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* as = reinterpret_cast<int8_t*>(smem);
  unsigned char* bs = smem + C::STAGES * C::A_BYTES;
  const int col0 = blockIdx.x * C::TBN, wc = (threadIdx.x >> 5) * (C::TBN / C::NW);
  const int kp = round_up(k, BK), steps = cdiv(kp, C::TBK);
  int acc[C::NACC][C::NI][4];
#pragma unroll
  for (int x = 0; x < C::NACC; ++x)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[x][ni][j] = 0;

  // A's rows past m stay zero in every slot: only rows < m are copied.
  for (int i = threadIdx.x; i < C::STAGES * C::A_BYTES / 16; i += C::NT)
    reinterpret_cast<uint4*>(as)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  auto load = [&](int s) {
    const int slot = s % C::STAGES, k0 = s * C::TBK;
    copy_a<VEC, C::NT, C::TBK, C::ALD>(as + slot * C::A_BYTES, a, m, k, 0, k0, m);
    copy_b<WB, VEC, C::NT, C::TBK, C::TBN>(bs + slot * B_BYTES, b, b_hi, n, k, k0, col0);
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps) load(s);
    tc::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    if (s + C::STAGES - 1 < steps) load(s + C::STAGES - 1);
    tc::cp_async_commit();
    const int8_t* at = as + (s % C::STAGES) * C::A_BYTES;
    const unsigned char* bt = bs + (s % C::STAGES) * B_BYTES;
#pragma unroll
    for (int q = 0; q < C::TBK / 32; ++q) {  // zeros past kp, as above
      uint32_t af[4], bf[C::NI][2];
      frag_a(af, at, C::ALD, 0, q * 32);
      F::b(bf, bt, q, wc);
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) tc::mma_s8(acc[q % C::NACC][ni], af, bf[ni]);
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int x = 1; x < C::NACC; ++x)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[0][ni][j] += acc[x][ni][j];
  const int g = tc::lane() >> 2;
  flush<1, C::NI>(
      acc, [&](int, int j) { return g + (j >> 1) * 8; },
      [&](int ni, int j) { return col0 + F::col(wc, ni, j); }, c, m, n, e);
}

// The tiles the int8 basic OS launch takes (matmul_df.py's planner keeps a
// copy, I8_PREFILL_TILE, I8_DECODE_TILE and PACKED_DECODE_TILE with their
// stages, checked against each launch's Took): the sweep's fastest at serving's mix of qwen3-1.7b's MLP shapes (two K=2048 N=6144
// launches to one K=6144 N=2048) with the dequant flush (scale -> f32)
// those launches take; the decode tile per B kind.
using Prefill = PrefillCfg<128, 64, 128, 4, 4, 2>;
using DecodeDense = DecodeCfg<64, 4, 512, 3>;
using DecodePacked = DecodeCfg<32, 4, 512, 4>;
template <int WB>
using Decode = typename std::conditional<WB == 0, DecodeDense, DecodePacked>::type;

// Whether the tile loads may take 16-byte vectors.
template <int WB>
bool vec_ok(const void* a, const void* b, const void* b_hi, int n, int k) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return k % 16 == 0 && n % (WB == 0 ? 16 : 4) == 0 && aligned(a) && aligned(b) &&
         (WB != 5 || aligned(b_hi));
}

using Kernel = void (*)(const int8_t*, const void*, const uint32_t*, void*, int,
                        int, int, Epi);

// One tile kernel over `grid`, NT threads, smem bytes of dynamic shared
// memory (opting in above 48 KB).
inline int launch_cfg(Kernel kernel, dim3 grid, int nt, size_t smem,
                      const void* a, const void* b, const void* b_hi, void* c,
                      int m, int n, int k, const Epi& e, cudaStream_t stream) {
  if (smem > MAX_SMEM) return REPRO_BAD_ARGUMENT;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, nt, smem, stream>>>(static_cast<const int8_t*>(a), b,
                                     static_cast<const uint32_t*>(b_hi), c, m, n, k, e);
  return launch_status();
}

// Launches the prefill tile C (any M) or the decode tile C (M <= 16).
template <class C, int WB>
int launch_prefill(const void* a, const void* b, const void* b_hi, void* c, int m,
                   int n, int k, const Epi& e, cudaStream_t stream, Took* took = nullptr) {
  if (cdiv(m, C::TBM) > 65535) return REPRO_BAD_ARGUMENT;
  const dim3 grid(cdiv(n, C::TBN), cdiv(m, C::TBM));
  if (took) *took = {TILE_I8_PREFILL, (int)C::smem(WB), (int)(grid.x * grid.y)};
  const Kernel kernel = vec_ok<WB>(a, b, b_hi, n, k) ? i8_prefill_kernel<C, true, WB>
                                                     : i8_prefill_kernel<C, false, WB>;
  return launch_cfg(kernel, grid, C::NT, C::smem(WB), a, b, b_hi, c, m, n, k, e, stream);
}
template <class C, int WB>
int launch_decode(const void* a, const void* b, const void* b_hi, void* c, int m,
                  int n, int k, const Epi& e, cudaStream_t stream, Took* took = nullptr) {
  if (m > C::MAX_M) return REPRO_BAD_ARGUMENT;
  const dim3 grid(cdiv(n, C::TBN));
  if (took) *took = {TILE_I8_DECODE, (int)C::smem(WB), (int)grid.x};
  const Kernel kernel = vec_ok<WB>(a, b, b_hi, n, k) ? i8_decode_kernel<C, true, WB>
                                                     : i8_decode_kernel<C, false, WB>;
  return launch_cfg(kernel, grid, C::NT, C::smem(WB), a, b, b_hi, c, m, n, k, e, stream);
}

// The int8 basic OS launch with a B of weight bits WB (0: int8): the decode
// tile for M <= 16, else the prefill tile; `took` names it. matmul_os.cu
// instantiates it in a translation unit of its own (GEMM_I8_DEFINE).
template <int WB>
int launch(const void* a, const void* b, const void* b_hi, void* c, int m, int n,
           int k, const Epi& e, cudaStream_t stream, Took* took = nullptr) {
  if (m <= Decode<WB>::MAX_M)
    return launch_decode<Decode<WB>, WB>(a, b, b_hi, c, m, n, k, e, stream, took);
  return launch_prefill<Prefill, WB>(a, b, b_hi, c, m, n, k, e, stream, took);
}

#define GEMM_I8_SIGNATURE(WB)                                                         \
  int launch<WB>(const void*, const void*, const void*, void*, int, int, int, const Epi&, \
                 cudaStream_t, Took*)
#define GEMM_I8_EXTERN(WB) extern template GEMM_I8_SIGNATURE(WB);
#define GEMM_I8_DEFINE(WB) template GEMM_I8_SIGNATURE(WB);

}  // namespace i8
}  // namespace gemm
