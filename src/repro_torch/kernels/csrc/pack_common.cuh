// B6: the in-kernel decompress of packed int4/int5 weight planes.
//
// Replaces repro/kernels/pack.py `unpack_block`, which the TPU kernels call
// inside B1/B4/B5's `_load_b` (matmul_df.py:116-143) and B8's `_conv_kernel`
// (conv2d_df.py:100-107) to decode the active weight block in VMEM. Here
// B1's int8 tensor-core tiles decode each word straight into mma fragments
// (decode_frag, gemm_tc_i8.cuh), and the walk kernels' B-tile staging
// (gemm_common.cuh `PackedB`) and the conv's filter-block staging (conv2d.cu
// `PackedW`) decode at the load: a weight never exists as int8 in device
// memory, only its planes do.
//
// Planes (repro_torch/kernels/pack.py): a nibble plane of (K/8, N) 32-bit
// words, row 8*r + t of column c in bits [4t, 4t+4) of word (r, c), and at 5
// bits a bit plane of (K/32, N) words, row 32*r + t in bit t of word (r, c).
// K is padded to a multiple of 32 at pack time, so one 32-deep k step of a
// column is 4 nibble words plus 1 bit-plane word. The code is
// u = nibble | bit << 4 and the value u - 2^(bits-1), in [-8, 7] or
// [-16, 15]; the outlier rows' exact corrections are added to the int32
// accumulator at the flush (gemm_common.cuh `add_sidecar`, conv2d.cu). The
// words are decoded with unsigned shifts, so no sign bit is dragged in.
//
// Bound on H100: this is part of the GEMM's or conv's tile load. It cuts the
// weight bytes to 1/2 (4 bits) or 5/8 (5 bits) of int8's, which is what
// bounds a decode GEMM (M = batch rows). In the walks the decode costs a
// shift, two masks and a subtraction per weight value on the CUDA cores; in
// B1's tensor-core tiles (decode_frag) about 8 integer instructions per 8
// values (14 at 5 bits).
#pragma once

#include "common.cuh"

namespace pack {

constexpr int WORD_NIBBLES = 8;  // rows per nibble-plane word
constexpr int WORD_BITS = 32;    // rows per bit-plane word

// The value of row t of nibble word w, whose code bit 4 is bit r of the
// bit-plane word h (5 bits only).
template <int BITS>
__device__ __forceinline__ int decode(uint32_t w, uint32_t h, int t, int r) {
  uint32_t u = (w >> (4 * t)) & 0xFu;
  if (BITS == 5) u |= ((h >> r) & 1u) << 4;
  return (int)u - (1 << (BITS - 1));
}

// Bytes of the planes of a (rows, width) block, rows a multiple of 32: the
// nibble words, then the bit-plane words.
template <int BITS>
__host__ __device__ constexpr size_t panel_bytes(int rows, int width) {
  return ((size_t)rows / WORD_NIBBLES +
          (BITS == 5 ? (size_t)rows / WORD_BITS : 0)) * width * 4;
}

// Copies the planes of rows [0, rows) and columns [col0, col0 + width) of
// (codes, hi) (row stride ld, nvalid columns real) into shared memory as one
// panel: (rows/8, width) nibble words, then (rows/32, width) bit-plane words;
// columns at or past nvalid hold 0.
template <int BITS, int THREADS>
__device__ __forceinline__ void load_panel(uint32_t* dst, const uint32_t* codes,
                                           const uint32_t* hi, size_t ld,
                                           int rows, int col0, int width,
                                           int nvalid) {
  const int nw = rows / WORD_NIBBLES * width;
  for (int i = threadIdx.x; i < nw; i += THREADS) {
    const int r = i / width, c = col0 + i % width;
    dst[i] = c < nvalid ? codes[(size_t)r * ld + c] : 0u;
  }
  if (BITS == 5) {
    const int hw = rows / WORD_BITS * width;
    for (int i = threadIdx.x; i < hw; i += THREADS) {
      const int r = i / width, c = col0 + i % width;
      dst[nw + i] = c < nvalid ? hi[(size_t)r * ld + c] : 0u;
    }
  }
}

// The value at row kk, column c of a panel that load_panel wrote.
template <int BITS>
__device__ __forceinline__ int panel_at(const uint32_t* panel, int kk, int c,
                                        int width, int rows) {
  const uint32_t w = panel[(size_t)(kk / WORD_NIBBLES) * width + c];
  const uint32_t h =
      BITS == 5 ? panel[(size_t)(rows / WORD_NIBBLES + kk / WORD_BITS) * width + c]
                : 0u;
  return decode<BITS>(w, h, kk % WORD_NIBBLES, kk % WORD_BITS);
}

// The tensor-core decode (gemm_tc_i8.cuh): the 8 rows of one nibble word
// w (at 5 bits, their code bit 4 in the low 8 bits of h8) as an mma B
// fragment, f[0] rows 0-3 and f[1] rows 4-7, four signed bytes each (the
// lowest row in the low byte). The nibbles are spread to bytes with one
// byte permute per register, bit 4 is spread by a multiply, and the offset
// 2^(bits-1) is taken from each byte without a borrow: u - 8 is
// (u + 0x78) ^ 0x80 for u in [0, 16), u - 16 is (u + 0x70) ^ 0x80 for u in
// [0, 32). Packed planes stay packed in shared memory; no int tile.
template <int BITS>
__device__ __forceinline__ void decode_frag(uint32_t w, uint32_t h8,
                                            uint32_t f[2]) {
  const uint32_t lo = w & 0x0F0F0F0Fu;         // rows 0, 2, 4, 6
  const uint32_t hi = (w >> 4) & 0x0F0F0F0Fu;  // rows 1, 3, 5, 7
  uint32_t u0 = __byte_perm(lo, hi, 0x5140), u1 = __byte_perm(lo, hi, 0x7362);
  if (BITS == 5) {  // bit i of x to bit 4 of byte i: x * 0x02040810
    u0 |= ((h8 & 0xFu) * 0x02040810u) & 0x10101010u;
    u1 |= (((h8 >> 4) & 0xFu) * 0x02040810u) & 0x10101010u;
  }
  constexpr uint32_t bias = BITS == 5 ? 0x70707070u : 0x78787878u;
  f[0] = (u0 + bias) ^ 0x80808080u;
  f[1] = (u1 + bias) ^ 0x80808080u;
}

// One 32 x BN weight tile of a k step, staged through registers: thread i
// loads nibble word (i / BN) of column i % BN (and the column's bit-plane
// word), neighbouring threads on neighbouring columns, and stashes its 8
// decoded values into a k-major int tile (row stride LD). Columns at or past
// nvalid read as words of 0 (they decode to -2^(bits-1), in output columns no
// kernel writes).
template <int BITS, int BN, int THREADS, int LD>
struct Tile {
  static_assert(32 * BN / WORD_NIBBLES == THREADS, "one nibble word a thread");
  uint32_t w, h;

  __device__ __forceinline__ void fetch(const uint32_t* codes, const uint32_t* hi,
                                        size_t ld, int nvalid, int k0, int col0) {
    const int wr = threadIdx.x / BN, c = col0 + threadIdx.x % BN;
    const bool in = c < nvalid;
    w = in ? codes[(size_t)(k0 / WORD_NIBBLES + wr) * ld + c] : 0u;
    h = (BITS == 5 && in) ? hi[(size_t)(k0 / WORD_BITS) * ld + c] : 0u;
  }
  __device__ __forceinline__ void stash(int* bs) const {
    const int wr = threadIdx.x / BN, c = threadIdx.x % BN;
#pragma unroll
    for (int t = 0; t < WORD_NIBBLES; ++t) {
      const int r = wr * WORD_NIBBLES + t;
      bs[r * LD + c] = decode<BITS>(w, h, t, r);
    }
  }
};

}  // namespace pack
