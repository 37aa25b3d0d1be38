// The online-softmax step shared by the flash (B2, float32) and
// KV-stationary (B7, float32) attention kernels: one warp folds one KV tile
// of at most 32 keys (key j on lane j) into one query row's running (m, l,
// acc) state. (B3 folds with all of a CTA's warps, in paged_attention.cu.)
//
// Over int8 K/V (SCALED) the tile holds the codes as floats and each lane
// also carries its key's K and V scales: the K scale multiplies the score
// after `* scale`, the V scale the probability after it has been summed
// into l, the order of ref.attention_ref's folded dequant (B2's bf16 int8
// path folds the same way, flash_tc_step.cuh).
#pragma once

#include "common.cuh"

// Output columns a lane owns: l, l + 32, ... below D (at D = 16 lanes 0-15
// own one each and lanes 16-31 none).
template <int D>
__device__ __forceinline__ bool owns_col(int lane, int t) {
  return D % 32 == 0 || lane + 32 * t < D;
}

// Running state of one query row. Lane l owns output columns l, l+32, ...
template <int D>
struct RowState {
  static constexpr int COLS = (D + 31) / 32;  // columns a lane owns, at most
  float m, l, acc[COLS];

  __device__ __forceinline__ void init() {
    m = REPRO_NEG_INF;
    l = 0.f;
#pragma unroll
    for (int t = 0; t < COLS; ++t) acc[t] = 0.f;
  }
};

// int8 codes as floats (exact), 16 at a time, for load_tiles.
template <>
struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ static __forceinline__ void unpack(const uint4& u, float* o) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = (float)(int8_t)(w[i >> 2] >> (8 * (i & 3)));
  }
};

// qs: the row's query (D floats, shared memory); ks: [32][D + 1] keys, padded
// one float per row so lane j's reads of key j hit distinct banks; vs:
// [32][D] values. nkeys (warp-uniform) bounds the tile; `valid` is this lane's
// mask bit; ksc and vsc (SCALED) its key's K and V scales. A masked lane
// contributes exactly 0 (explicit zeroing, as the TPU kernel does), so a
// fully masked tile leaves the state unchanged even while m is still
// NEG_INF. Every lane of the warp must call this.
template <int D, bool SCALED = false>
__device__ __forceinline__ void fold_tile(const float* qs, const float* ks,
                                          const float* vs, int nkeys,
                                          bool valid, float scale,
                                          RowState<D>& st, float ksc = 1.f,
                                          float vsc = 1.f) {
  const int lane = threadIdx.x & 31;
  float s = REPRO_NEG_INF;
  if (valid) {
    const float* kr = ks + lane * (D + 1);
    float dot = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) dot = fmaf(qs[d], kr[d], dot);
    s = dot * scale;
    if constexpr (SCALED) s *= ksc;
  }
  const float m_new = fmaxf(st.m, warp_max(s));
  float p = valid ? expf(s - m_new) : 0.f;
  const float alpha = expf(st.m - m_new);
  // One fused rounding, spelled out: left to the compiler, the choice
  // between an FMA and a multiply and an add differed between B2's and
  // B7's D = 16 instantiations (1 ulp apart on an H100, nvcc 12.8), and
  // every output of the two kernels must round alike.
  st.l = fmaf(alpha, st.l, warp_sum(p));
  if constexpr (SCALED) p *= vsc;
#pragma unroll
  for (int t = 0; t < RowState<D>::COLS; ++t) st.acc[t] *= alpha;
  for (int j = 0; j < nkeys; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
    const float* vr = vs + j * D;
#pragma unroll
    for (int t = 0; t < RowState<D>::COLS; ++t)
      if (owns_col<D>(lane, t)) st.acc[t] = fmaf(pj, vr[lane + 32 * t], st.acc[t]);
  }
  st.m = m_new;
}

// acc / l; a row that saw no valid key (l == 0) writes zeros.
template <typename T, int D>
__device__ __forceinline__ void write_row(T* out, const RowState<D>& st) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < RowState<D>::COLS; ++t)
    if (owns_col<D>(lane, t))
      store_f32(out + lane + 32 * t, st.l > 0.f ? st.acc[t] / st.l : 0.f);
}
