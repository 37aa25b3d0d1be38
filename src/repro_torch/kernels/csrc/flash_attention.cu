// B2: banded causal GQA flash attention (output-stationary).
//
// Replaces the TPU kernel repro/kernels/attention_df.py `_flash_kernel`
// (built by `flash_attention`). A CTA owns one (batch*head, q tile); each
// query row's online-softmax state (m, l, acc) stays in registers across the
// KV sweep, and the output is written once.
//
// Banding: the valid KV length of the tile's batch row comes from device
// memory (`kv_lens[bh / heads_per_row]`) or, for one length shared by the
// whole call, from the `kv_len` argument. q rows right-align against it
// (q row r sits at position r + kv_valid - sq). The CTA loops over only the
// KV tiles in its band [lo, hi]: hi stops at the last valid key and at the
// causal diagonal of the tile's last row, lo starts at the sliding window of
// its first row (the rule of attention_df.py `_band_lo_hi`). Tiles outside
// the band are never read. Inside a tile every (row, key) pair is masked
// with the exact rule, and rows that see no valid key write zeros. GQA: kv
// head = bh / group. The ragged q and KV edges are masked here, so the
// caller pads nothing.
//
// Bound on H100: at prefill lengths the arithmetic (4*D flops per visited
// (row, key) pair), at short q tiles against long caches the KV bytes.
//
// bf16 (flash_tc_kernel, the serving path) runs on the tensor cores, in the
// FlashAttention-2 shape: a CTA of 4 warps takes 64 q rows (16 a warp, Q's
// fragments in registers across the sweep); 64-key K and V tiles arrive as
// bf16 through a double-buffered cp.async ring; each warp folds each tile it
// sees with flash_tc.cuh's step (flash_tc_step.cuh: S = Q K^T and O += P V
// on mma.sync m16n8k16, each 16-deep chunk summed from zero and added to the
// f32 accumulator with one rounded add, as the GEMMs do; the softmax on the
// accumulator fragments; P split exactly into three bf16 parts, so P keeps
// an f32's ~24 bits: rounded to one bf16 (or two), it moved the served
// binary MLP's sign thresholds, its 2-layer logits falling to cosine 0.83
// (0.94) against the plain path on an H100). B7's bf16 kernel
// (kv_stationary.cu) takes the same step over the same tiles.
//
// f32 (flash_kernel) keeps the CUDA cores: one CTA per 16 q rows, its 4 warps
// each carrying 4 rows, one key per lane, f32 copies of Q, K and V in shared
// memory.
#include <type_traits>

#include "attention_common.cuh"
#include "flash_tc.cuh"

namespace {

// The f32 CUDA-core tile.
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

// The bf16 tensor-core tile (flash_tc.cuh).
using fa::TQ;
using fa::TKV;

template <int D>
constexpr size_t tc_smem() {  // Q, then K and V double-buffered
  return (size_t)5 * TKV * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int sq, int skv, int group,
                int heads_per_row, const int* __restrict__ kv_lens, int kv_len,
                int window, int causal, float scale) {
  constexpr int LD = D + 8;  // 16 bytes of padding: ldmatrix rows on distinct banks
  constexpr int TILE = TKV * LD, NT = WARPS * 32, VPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + TILE;      // two buffers
  __nv_bfloat16* vs = ks + 2 * TILE;  // two buffers
  const int warp = threadIdx.x >> 5, g = tc::lane() >> 2, t = tc::lane() & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * TQ;
  const int kv_valid = kv_lens ? kv_lens[bh / heads_per_row] : kv_len;
  const int off = kv_valid - sq;
  const size_t kv_base = (size_t)(bh / group) * skv * D;
  const __nv_bfloat16* qsrc = q + ((size_t)bh * sq + q0) * D;

  int lo, hi;  // the tile's KV band, in tiles
  fa::band(q0, sq, skv, kv_valid, causal, window, &lo, &hi);

  // 64 rows of D bf16 from src (rows past `rows` read as zero) into dst.
  auto copy_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int rows) {
    for (int i = threadIdx.x; i < TKV * VPR; i += NT) {
      const int r = i / VPR, c = (i % VPR) * 8;
      const bool in = r < rows;
      tc::cp_async16(dst + r * LD + c, in ? src + (size_t)r * D + c : src, in);
    }
  };
  auto load_kv = [&](int blk, int buf) {
    const size_t at = kv_base + (size_t)blk * TKV * D;
    copy_tile(ks + buf * TILE, k + at, skv - blk * TKV);
    copy_tile(vs + buf * TILE, v + at, skv - blk * TKV);
  };

  // This warp's rows and the positions they sit at.
  const int wq = q0 + warp * 16;
  const int qpos0 = wq + g + off, qpos1 = qpos0 + 8;
  float m_run[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l_run[2] = {0.f, 0.f};
  float oacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;

  if (lo <= hi) {
    copy_tile(qs, qsrc, sq - q0);
    tc::cp_async_commit();
    load_kv(lo, 0);
    tc::cp_async_commit();
  }
  uint32_t qf[D / 16][4];
  for (int blk = lo; blk <= hi; ++blk) {
    const int buf = (blk - lo) & 1;
    if (blk < hi) load_kv(blk + 1, buf ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // Q and this tile have landed
    __syncthreads();
    if (blk == lo) {
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        tc::frag_a_rowmajor(qf[c], qs, LD, warp * 16, c * 16);
    }
    const int k0 = blk * TKV;
    if (fa::warp_sees(wq, sq, off, k0, causal, window)) {
      const __nv_bfloat16* kt = ks + buf * TILE;
      const __nv_bfloat16* vt = vs + buf * TILE;
#define FA_LDSM_K(r, row, col) tc::ldmatrix_x4(r, kt + (size_t)(row) * LD + col)
#define FA_FRAG_V(b0, b1, kr, cc) tc::frag_b2_rowmajor(b0, b1, vt, LD, kr, cc)
#include "flash_tc_step.cuh"
#undef FA_LDSM_K
#undef FA_FRAG_V
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }
  tc::cp_async_wait<0>();

  // acc / l; a row that saw no valid key (l == 0) writes zeros.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wq + g + h * 8;
    if (row >= sq) continue;
    const float l = l_run[h];
    uint32_t* dst = reinterpret_cast<uint32_t*>(o + ((size_t)bh * sq + row) * D);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      dst[(i * 8 + 2 * t) / 2] =
          l > 0.f ? tc::pack2_rn(oacc[i][2 * h] / l, oacc[i][2 * h + 1] / l) : 0u;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int skv, int group, int heads_per_row, const int* kv_lens,
           int kv_len, int window, int causal, float scale,
           cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr size_t smem = tc_smem<D>();
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((sq + TQ - 1) / TQ, bh);
    flash_tc_kernel<D><<<grid, WARPS * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), sq, skv, group,
        heads_per_row, kv_lens, kv_len, window, causal, scale);
  } else {
    const dim3 grid((sq + BQ - 1) / BQ, bh);
    flash_kernel<T, D><<<grid, WARPS * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), sq, skv, group,
        heads_per_row, kv_lens, kv_len, window, causal, scale);
  }
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
