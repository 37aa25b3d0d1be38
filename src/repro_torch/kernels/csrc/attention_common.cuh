// The online-softmax step shared by the flash (B2, float32) and
// KV-stationary (B7) attention kernels: one warp folds one KV tile of at
// most 32 keys (key j on lane j) into one query row's running (m, l, acc)
// state. (B3 folds with all of a CTA's warps, in paged_attention.cu.)
#pragma once

#include "common.cuh"

// Running state of one query row. Lane l owns output columns l, l+32, ...
template <int D>
struct RowState {
  float m, l, acc[D / 32];

  __device__ __forceinline__ void init() {
    m = REPRO_NEG_INF;
    l = 0.f;
#pragma unroll
    for (int t = 0; t < D / 32; ++t) acc[t] = 0.f;
  }
};

// qs: the row's query (D floats, shared memory); ks: [32][D + 1] keys, padded
// one float per row so lane j's reads of key j hit distinct banks; vs:
// [32][D] values. nkeys (warp-uniform) bounds the tile; `valid` is this lane's
// mask bit. A masked lane contributes exactly 0 (explicit zeroing, as the TPU
// kernel does), so a fully masked tile leaves the state unchanged even while
// m is still NEG_INF. Every lane of the warp must call this.
template <int D>
__device__ __forceinline__ void fold_tile(const float* qs, const float* ks,
                                          const float* vs, int nkeys,
                                          bool valid, float scale,
                                          RowState<D>& st) {
  const int lane = threadIdx.x & 31;
  float s = REPRO_NEG_INF;
  if (valid) {
    const float* kr = ks + lane * (D + 1);
    float dot = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) dot = fmaf(qs[d], kr[d], dot);
    s = dot * scale;
  }
  const float m_new = fmaxf(st.m, warp_max(s));
  const float p = valid ? expf(s - m_new) : 0.f;
  const float alpha = expf(st.m - m_new);
  st.l = alpha * st.l + warp_sum(p);
#pragma unroll
  for (int t = 0; t < D / 32; ++t) st.acc[t] *= alpha;
  for (int j = 0; j < nkeys; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
    const float* vr = vs + j * D;
#pragma unroll
    for (int t = 0; t < D / 32; ++t)
      st.acc[t] = fmaf(pj, vr[lane + 32 * t], st.acc[t]);
  }
  st.m = m_new;
}

// acc / l; a row that saw no valid key (l == 0) writes zeros.
template <typename T, int D>
__device__ __forceinline__ void write_row(T* out, const RowState<D>& st) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < D / 32; ++t)
    store_f32(out + lane + 32 * t, st.l > 0.f ? st.acc[t] / st.l : 0.f);
}
