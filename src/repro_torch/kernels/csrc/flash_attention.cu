// B2: banded causal GQA flash attention (output-stationary).
//
// Replaces the TPU kernel repro/kernels/attention_df.py `_flash_kernel`
// (built by `flash_attention`). One CTA owns one (batch*head, 16-row q tile);
// its 4 warps each carry 4 query rows' online-softmax state (m, l, acc) in
// registers across the KV sweep, and the output is written once.
//
// Banding: the valid KV length of the tile's batch row comes from device
// memory (`kv_lens[bh / heads_per_row]`) or, for one length shared by the
// whole call, from the `kv_len` argument. q rows right-align against it
// (q row r sits at position r + kv_valid - sq). The CTA loops over only the
// KV tiles in its band [lo, hi]: hi stops at the last valid key and at the
// causal diagonal of the tile's last row, lo starts at the sliding window of
// its first row (the rule of attention_df.py `_band_lo_hi`). Tiles outside
// the band are never read. Inside a tile every lane masks its key with the
// exact per-(row, key) rule, and rows that see no valid key write zeros.
// GQA: kv head = bh / group. The ragged q and KV edges are masked here, so
// the caller pads nothing.
//
// Bound on H100: at prefill lengths the arithmetic (4*D flops per visited
// (row, key) pair), at short q tiles against long caches the KV bytes. This
// version computes on the CUDA cores from f32 copies in shared memory (each
// tile's K and V arrive as 16-byte loads all in flight together), one key
// per lane; tensor-core (wgmma) tiles come later (see PERF.md).
#include "attention_common.cuh"

namespace {

constexpr int BQ = 16;   // query rows per CTA
constexpr int BKV = 32;  // keys per KV tile: one per lane
constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = BQ / WARPS;

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
             int group, int heads_per_row, const int* __restrict__ kv_lens,
             int kv_len, int window, int causal, float scale) {
  __shared__ float qs[BQ][D];
  __shared__ float ks[BKV][D + 1];
  __shared__ float vs[BKV][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kv_valid = kv_lens ? kv_lens[bh / heads_per_row] : kv_len;
  const int off = kv_valid - sq;
  const size_t kv_base = (size_t)(bh / group) * skv * D;

  load_tiles<T, BQ, D, D, D, WARPS * 32>(
      &qs[0][0], q + ((size_t)bh * sq + q0) * D, nullptr, nullptr, D,
      sq - q0);

  // The tile's KV band, in tiles.
  int hi = min((kv_valid + BKV - 1) / BKV, (skv + BKV - 1) / BKV) - 1;
  if (causal) {
    const int qmax = min(q0 + BQ, sq) - 1 + off;
    hi = min(hi, qmax >= 0 ? qmax / BKV : -1);
  }
  int lo = 0;
  if (window > 0) lo = max(0, (q0 + off - window + 1) / BKV);

  RowState<D> st[ROWS_PER_WARP];
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) st[rr].init();

  for (int blk = lo; blk <= hi; ++blk) {
    __syncthreads();  // the previous tile is consumed (and qs is loaded)
    const size_t tile = kv_base + (size_t)blk * BKV * D;
    load_tiles<T, BKV, D, D + 1, D, WARPS * 32>(
        &ks[0][0], k + tile, &vs[0][0], v + tile, D, skv - blk * BKV);
    __syncthreads();
    const int kpos = blk * BKV + lane;
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      if (q0 + r >= sq) break;  // warp-uniform
      const int qpos = q0 + r + off;
      bool valid = kpos < kv_valid && kpos < skv;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && kpos > qpos - window;
      fold_tile<D>(qs[r], &ks[0][0], &vs[0][0], BKV, valid, scale, st[rr]);
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    if (q0 + r < sq) write_row<T, D>(o + ((size_t)bh * sq + q0 + r) * D, st[rr]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int skv, int group, int heads_per_row, const int* kv_lens,
           int kv_len, int window, int causal, float scale,
           cudaStream_t stream) {
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_kernel<T, D><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, group,
      heads_per_row, kv_lens, kv_len, window, causal, scale);
  return launch_status();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int bh, int sq, int skv, int group, int heads_per_row,
             const int* kv_lens, int kv_len, int window, int causal,
             float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, bh, sq, skv, group, heads_per_row,
                           kv_lens, kv_len, window, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, sq, skv, group, heads_per_row,
                           kv_lens, kv_len, window, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, sq, skv, group, heads_per_row,
                            kv_lens, kv_len, window, causal, scale, stream);
    default:
      return REPRO_BAD_ARGUMENT;
  }
}

}  // namespace

// q (bh, sq, d); k, v (bh / group, skv, d); o like q. kv_lens: null (every
// head row uses kv_len) or bh / heads_per_row lengths on the device.
// window <= 0: no sliding window.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int d, int bh, int sq,
                               int skv, int group, int heads_per_row,
                               const int* kv_lens, int kv_len, int window,
                               int causal, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || skv <= 0 || group <= 0 ||
      bh % group || (kv_lens && (heads_per_row <= 0 || bh % heads_per_row)))
    return REPRO_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch_d<float>(d, q, k, v, o, bh, sq, skv, group, heads_per_row,
                           kv_lens, kv_len, window, causal, scale, s);
  if (dtype == REPRO_BF16)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, bh, sq, skv, group,
                                   heads_per_row, kv_lens, kv_len, window,
                                   causal, scale, s);
  return REPRO_BAD_ARGUMENT;
}
