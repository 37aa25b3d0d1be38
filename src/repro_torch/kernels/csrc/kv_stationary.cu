// B7: KV-stationary (weight-stationary) GQA attention.
//
// Replaces the TPU kernel repro/kernels/attention_df.py `_kv_stationary_kernel`
// / `_kv_single_kernel` (built by `kv_stationary_attention`): the WS anchor of
// attention. Each KV block is fetched once, and the q tiles stream past it;
// each q row's online-softmax state (acc, m, l) goes through device memory
// once per KV block it sees (the paper's WS output traffic).
//
// The TPU's single-dispatch form relies on the grid running in order; CTAs on
// Hopper run in no order, so the order is made explicit: one CTA per
// (batch*head) walks the KV blocks outer and the q tiles inner, and owns
// every state row it touches, so no other CTA reads or writes them. For each
// visible (KV block, 16-row q tile) pair the tile's rows load their state
// from global memory (or start it, at the first block of the tile's band),
// fold the block in with the online-softmax step B2 uses (attention_common.cuh,
// one warp per row, one key per lane), and store it again (or, at the last
// block of the band, write acc / l, with l == 0 -> 0). Pairs outside a tile's
// band (the valid length, per batch row or shared; the causal diagonal; the
// sliding window: the band rule of B2 and attention_df.py `_band_lo_hi`) are
// skipped and update nothing; tiles with an empty band write zeros. The state
// is f32 in device memory, which is exact, so each row's output equals B2's
// for the same inputs.
//
// Bound on H100: the arithmetic at prefill lengths, as B2; the state's round
// trips add 2 * (D + 2) * 4 bytes per visible (row, KV block) pair, mostly
// served from L2. One CTA per (batch*head) is the price of fetching each KV
// block once: at batch 1 the kernel runs on Hq of the 132 SMs.
#include "attention_common.cuh"

namespace {

constexpr int BQ = 16;   // query rows per tile: one per warp
constexpr int BKV = 32;  // keys per KV block: one per lane
constexpr int WARPS = BQ;

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ acc_st, float* __restrict__ ml_st, int sq,
          int skv, int group, int heads_per_row, const int* __restrict__ kv_lens,
          int kv_len, int window, int causal, float scale) {
  __shared__ float qs[BQ][D];
  __shared__ float ks[BKV][D + 1];
  __shared__ float vs[BKV][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int kv_valid = kv_lens ? kv_lens[bh / heads_per_row] : kv_len;
  const int off = kv_valid - sq;
  const size_t kv_base = (size_t)(bh / group) * skv * D;
  const int gq = (sq + BQ - 1) / BQ;

  // Band of q tile t, in KV blocks (B2's rule).
  auto band = [&](int t, int& lo, int& hi) {
    const int q0 = t * BQ;
    hi = min((kv_valid + BKV - 1) / BKV, (skv + BKV - 1) / BKV) - 1;
    if (causal) {
      const int qmax = min(q0 + BQ, sq) - 1 + off;
      hi = min(hi, qmax >= 0 ? qmax / BKV : -1);
    }
    lo = window > 0 ? max(0, (q0 + off - window + 1) / BKV) : 0;
  };
  // Every block some tile sees: tile 0 starts lowest, the last tile ends
  // highest.
  int blo, bhi, unused;
  band(0, blo, unused);
  band(gq - 1, unused, bhi);

  for (int blk = blo; blk <= bhi; ++blk) {
    __syncthreads();  // the previous block and q tile are consumed
    const size_t tile = kv_base + (size_t)blk * BKV * D;
    load_tiles<T, BKV, D, D + 1, D, WARPS * 32>(
        &ks[0][0], k + tile, &vs[0][0], v + tile, D, skv - blk * BKV);
    const int kpos = blk * BKV + lane;
    for (int t = 0; t < gq; ++t) {
      int lo, hi;
      band(t, lo, hi);
      if (blk < lo || blk > hi) continue;  // out of band: no update
      const int q0 = t * BQ;
      __syncthreads();  // the previous q tile is consumed (and K/V loaded)
      load_tiles<T, BQ, D, D, D, WARPS * 32>(
          &qs[0][0], q + ((size_t)bh * sq + q0) * D, nullptr, nullptr, D,
          sq - q0);
      __syncthreads();
      const int r = q0 + warp;
      if (r >= sq) continue;  // warp-uniform
      const size_t row = (size_t)bh * sq + r;
      RowState<D> st;
      if (blk == lo) {
        st.init();
      } else {
        st.m = ml_st[2 * row];
        st.l = ml_st[2 * row + 1];
#pragma unroll
        for (int c = 0; c < D / 32; ++c) st.acc[c] = acc_st[row * D + lane + 32 * c];
      }
      const int qpos = r + off;
      bool valid = kpos < kv_valid && kpos < skv;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && kpos > qpos - window;
      fold_tile<D>(qs[warp], &ks[0][0], &vs[0][0], BKV, valid, scale, st);
      if (blk == hi) {
        write_row<T, D>(o + row * D, st);
      } else {
#pragma unroll
        for (int c = 0; c < D / 32; ++c) acc_st[row * D + lane + 32 * c] = st.acc[c];
        if (lane == 0) {
          ml_st[2 * row] = st.m;
          ml_st[2 * row + 1] = st.l;
        }
      }
    }
  }

  // Tiles whose band is empty see no key: their rows write zeros.
  for (int t = 0; t < gq; ++t) {
    int lo, hi;
    band(t, lo, hi);
    const int r = t * BQ + warp;
    if (lo <= hi || r >= sq) continue;
    RowState<D> st;
    st.init();
    write_row<T, D>(o + ((size_t)bh * sq + r) * D, st);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* acc,
           float* ml, int bh, int sq, int skv, int group, int heads_per_row,
           const int* kv_lens, int kv_len, int window, int causal, float scale,
           cudaStream_t stream) {
  kv_kernel<T, D><<<bh, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), acc, ml, sq, skv, group,
      heads_per_row, kv_lens, kv_len, window, causal, scale);
  return launch_status();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             float* acc, float* ml, int bh, int sq, int skv, int group,
             int heads_per_row, const int* kv_lens, int kv_len, int window,
             int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, acc, ml, bh, sq, skv, group,
                           heads_per_row, kv_lens, kv_len, window, causal,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, acc, ml, bh, sq, skv, group,
                           heads_per_row, kv_lens, kv_len, window, causal,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, acc, ml, bh, sq, skv, group,
                            heads_per_row, kv_lens, kv_len, window, causal,
                            scale, stream);
    default:
      return REPRO_BAD_ARGUMENT;
  }
}

}  // namespace

// q (bh, sq, d); k, v (bh / group, skv, d); o like q; acc (bh, sq, d) and
// ml (bh, sq, 2) f32 scratch for the running state (written before it is
// read). kv_lens: null (every head row uses kv_len) or bh / heads_per_row
// lengths on the device. window <= 0: no sliding window.
extern "C" int kv_stationary(const void* q, const void* k, const void* v,
                             void* o, float* acc, float* ml, int dtype, int d,
                             int bh, int sq, int skv, int group,
                             int heads_per_row, const int* kv_lens, int kv_len,
                             int window, int causal, float scale,
                             void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || group <= 0 || bh % group ||
      (kv_lens && (heads_per_row <= 0 || bh % heads_per_row)))
    return REPRO_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch_d<float>(d, q, k, v, o, acc, ml, bh, sq, skv, group,
                           heads_per_row, kv_lens, kv_len, window, causal,
                           scale, s);
  if (dtype == REPRO_BF16)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, acc, ml, bh, sq, skv, group,
                                   heads_per_row, kv_lens, kv_len, window,
                                   causal, scale, s);
  return REPRO_BAD_ARGUMENT;
}
