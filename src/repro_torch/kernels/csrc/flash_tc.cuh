// The bf16 flash step on the tensor cores, shared by B2 (flash_attention.cu
// `flash_tc_kernel`, output-stationary) and B7 (kv_stationary.cu
// `kv_cluster_kernel`, KV-stationary).
//
// One warp folds one 64-key K/V tile into the online-softmax state of its 16
// query rows (flash_tc_step.cuh): S = Q K^T on mma.sync m16n8k16, each
// 16-deep chunk summed from zero and added to the f32 scores with one
// rounded add; mask, scale and the online softmax on the accumulator
// fragments (quad shuffles for the row max and sum); P split exactly into
// three bf16 parts (hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi -
// mid)), so it enters P V with an f32's ~24 bits; each 16-key chunk's
// products (lo, mid, then hi) summed from zero and added to O with one f32
// add. Both kernels take the same 64-row q tiles (16 rows a warp), the same
// 64-key tiles, the same band (`band`) and per-warp skip (`warp_sees`), and
// fold each tile a warp sees in ascending order: with the state exact
// wherever it is kept, every output row gets the same bits from either
// kernel. The K and V tiles stay where each kernel keeps them (B2: padded
// rows; B7: the TMA's swizzled rows), read through the includer's macros.
#pragma once

#include "mma_common.cuh"

namespace fa {

constexpr int TQ = 64;   // query rows of a tile: 16 per warp
constexpr int TKV = 64;  // keys of a K/V tile
constexpr int WARPS = TQ / 16;

// The KV band [lo, hi] (in 64-key tiles) of the q tile whose first row is
// q0: hi stops at the last valid key and at the causal diagonal of the
// tile's last row, lo starts at the sliding window of its first row (the
// rule of attention_df.py `_band_lo_hi`); lo > hi: the tile sees no key.
__device__ __forceinline__ void band(int q0, int sq, int skv, int kv_valid,
                                     int causal, int window, int* lo, int* hi) {
  const int off = kv_valid - sq;
  int h = min((kv_valid + TKV - 1) / TKV, (skv + TKV - 1) / TKV) - 1;
  if (causal) {
    const int qmax = min(q0 + TQ, sq) - 1 + off;
    h = min(h, qmax >= 0 ? qmax / TKV : -1);
  }
  *hi = h;
  *lo = window > 0 ? max(0, (q0 + off - window + 1) / TKV) : 0;
}

// Whether the warp whose first row is wq sees a key of the tile at k0: a
// warp whose rows are all past sq, or that sees no key of the tile (causal
// or window), leaves its state as it is.
__device__ __forceinline__ bool warp_sees(int wq, int sq, int off, int k0,
                                          int causal, int window) {
  const int wq_last = min(wq + 15, sq - 1) + off;  // the warp's last position
  return wq < sq && (!causal || k0 <= wq_last) &&
         (window <= 0 || k0 + TKV - 1 > wq + off - window);
}

// Four int8 codes (the bytes of w, code 0 lowest) as four exact bf16
// (|q| <= 127 fits bf16's 8-bit significand), codes 0 and 1 in lo, 2 and 3
// in hi: each byte, biased by 128, becomes the low byte of the f32 2^23 +
// 128 + q, from which one add leaves q exactly, and the f32's high half is
// its bf16. Full-rate adds and byte permutes, no conversion instruction.
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) -
                           8388736.f);
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

}  // namespace fa
