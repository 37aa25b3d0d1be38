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
// int8 K/V under bf16 queries (the int8 KV cache; the TPU kernel's
// `_load_kv` dequantizes at the block load) takes the same kernel: the
// 64-key int8 tiles stream through the cp.async ring at half the bytes, each
// is converted exactly to bf16 (|q| <= 127 fits bf16's significand) a tile
// ahead of the fold, so the step's mma.sync runs on the codes, and the step
// folds the per-position f32 scales per key: K's into each score after
// `* scale`, V's into each probability after it has been summed into l (the
// folded dequant of ref.attention_ref). The bf16 path's code is as it was.
//
// f32 (flash_kernel) keeps the CUDA cores: one CTA per 16 q rows, its 4 warps
// each carrying 4 rows, one key per lane, f32 copies of Q, K and V in shared
// memory.
//
// int8 K/V under f32 queries (a float32 config's int8 KV cache) takes the same
// f32 kernel: the 32-key int8 tiles are read 16 codes a thread and held as
// exact floats in the same shared tiles, and each lane carries its key's K
// and V scales (read beside the tile) into the fold, which folds them as
// ref.attention_ref does (attention_common.cuh: K's into the score after
// `* scale`, V's into the probability after it has been summed into l). B7's
// f32 kernel (kv_stationary.cu kv_kernel) folds the same tiles with the same
// step, so its int8 output equals this one's bit for bit.
//
// Row statistics (lse non-null; the cache attention split over the keys of a
// device mesh): every path also writes, for each q row, the log of its
// softmax's normaliser, m + log(l) from the online softmax's final state, in
// f32, or -inf for a row that saw no key (whose output row is 0, as always).
// A rank's partial output over its key range and this statistic are all the
// log-sum-exp merge across ranks needs (models/parallel.py). The epilogue
// writes it; nothing before the epilogue looks at lse, so a launch without
// it computes and writes what it always did.
//
// The valid length may lie outside [0, skv]: a buffer holding keys [k0, k0 +
// skv) of a longer sequence is banded by kv_len - k0. The band's upper tile
// is clipped to the buffer (band / the f32 rule: min of the valid tiles and
// the buffer's), a length <= 0 gives an empty band, and the loads are masked
// at skv, so no length reads past the buffer.
//
// Every path is built for d_head 16, 32, 64 and 128. At D = 16 a bf16 row is
// two 16-byte chunks and an int8 row one; the tensor-core step's QK^T is one
// m16n8k16 chunk and its PV two n8 fragments, summed in the same chunk order;
// the f32 fold's lanes 16-31 own no output column.
#include <type_traits>

#include "attention_common.cuh"
#include "flash_tc.cuh"

namespace {

// The statistic of a row that sees no key: a true -inf (REPRO_NEG_INF, the
// online softmax's starting max, is a finite -1e30).
#define REPRO_NO_KEY_LSE __int_as_float(0xff800000u)

// The f32 CUDA-core tile.
constexpr int BQ = 16;   // query rows per CTA
constexpr int BKV = 32;  // keys per KV tile: one per lane
constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = BQ / WARPS;

// KV = T: float K/V. KV = int8_t: int8 codes with per-position f32 scales
// (k_scale, v_scale (bh / group, skv)), folded per key.
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_kernel(const T* __restrict__ q, const KV* __restrict__ k,
             const KV* __restrict__ v, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, T* __restrict__ o,
             float* __restrict__ lse, int sq, int skv, int group, int heads_per_row,
             const int* __restrict__ kv_lens, int kv_len, int window, int causal,
             float scale) {
  constexpr bool I8 = std::is_same<KV, int8_t>::value;
  __shared__ float qs[BQ][D];
  __shared__ float ks[BKV][D + 1];
  __shared__ float vs[BKV][D];
  __shared__ float scs[2][BKV];  // int8: the tile's K and V scales
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
    load_tiles<KV, BKV, D, D + 1, D, WARPS * 32>(
        &ks[0][0], k + tile, &vs[0][0], v + tile, D, skv - blk * BKV);
    if constexpr (I8) {
      // thread j < 32 stores K's scale of the tile's key j, 32 + j V's; 0
      // past skv
      if (threadIdx.x < 2 * BKV) {
        const int j = threadIdx.x & (BKV - 1), key = blk * BKV + j;
        const float* src = threadIdx.x < BKV ? k_scale : v_scale;
        scs[threadIdx.x / BKV][j] = key < skv ? src[(size_t)(bh / group) * skv + key] : 0.f;
      }
    }
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
      if constexpr (I8)
        fold_tile<D, true>(qs[r], &ks[0][0], &vs[0][0], BKV, valid, scale, st[rr],
                           scs[0][lane], scs[1][lane]);
      else
        fold_tile<D>(qs[r], &ks[0][0], &vs[0][0], BKV, valid, scale, st[rr]);
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    if (q0 + r >= sq) continue;
    write_row<T, D>(o + ((size_t)bh * sq + q0 + r) * D, st[rr]);
    if (lse && lane == 0)
      lse[(size_t)bh * sq + q0 + r] =
          st[rr].l > 0.f ? st[rr].m + logf(st[rr].l) : REPRO_NO_KEY_LSE;
  }
}

// The bf16 tensor-core tile (flash_tc.cuh).
using fa::TQ;
using fa::TKV;

// int8 K/V: one tile's K and V codes (rows of D bytes) converted exactly
// to bf16 into dst (the K tile, then the V tile TILE elements on, rows of
// LD), 16 codes a thread at a time (fa::codes_to_bf16).
template <int D>
__device__ __forceinline__ void convert_codes(__nv_bfloat16* dst, const int8_t* src) {
  constexpr int LD = D + 8, CPR = D / 16, CHUNKS = 2 * TKV * CPR;
#pragma unroll 2
  for (int j = 0; j < CHUNKS / (WARPS * 32); ++j) {
    const int i = threadIdx.x + j * WARPS * 32;
    const int kv = i / (TKV * CPR), r = (i / CPR) % TKV, c = (i % CPR) * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(src + (kv * TKV + r) * D + c);
    uint4 a, b;
    fa::codes_to_bf16(w.x, a.x, a.y);
    fa::codes_to_bf16(w.y, a.z, a.w);
    fa::codes_to_bf16(w.z, b.x, b.y);
    fa::codes_to_bf16(w.w, b.z, b.w);
    uint4* out = reinterpret_cast<uint4*>(dst + kv * TKV * LD + r * LD + c);
    out[0] = a;
    out[1] = b;
  }
}

template <int D, typename KV>
constexpr size_t tc_smem() {
  if constexpr (std::is_same<KV, int8_t>::value)
    // Q, two converted K and V tiles, the int8 ring (two K and V tiles),
    // two tiles' scales
    return (size_t)5 * TKV * (D + 8) * 2 + (size_t)4 * TKV * D + 4 * TKV * 4;
  else
    return (size_t)5 * TKV * (D + 8) * 2;  // Q, then K and V double-buffered
}

// KV = __nv_bfloat16: K and V tiles double-buffered as bf16. KV = int8_t:
// int8 K and V tiles stream through a two-slot ring at half the bytes, and
// the loop is pipelined a tile deep: while the warps fold tile j (its bf16
// copy and scales in buffer j % 2), they convert tile j + 1's codes
// (convert_codes) and store its 64 K and 64 V scales (read from device
// memory a tile ahead, one a thread) into buffer (j + 1) % 2, and tile j +
// 2's codes land in the ring slot tile j held; one barrier a tile. The
// step folds the scales per key (FA_KSCALE, FA_VSCALE).
template <int D, typename KV>
__global__ void __launch_bounds__(WARPS * 32)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                const KV* __restrict__ v, const float* __restrict__ k_scale,
                const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int sq, int skv, int group, int heads_per_row,
                const int* __restrict__ kv_lens, int kv_len, int window, int causal,
                float scale) {
  constexpr bool I8 = std::is_same<KV, int8_t>::value;
  constexpr int LD = D + 8;  // 16 bytes of padding: ldmatrix rows on distinct banks
  constexpr int TILE = TKV * LD, NT = WARPS * 32, VPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + TILE;      // two buffers (int8: K, V of one tile each)
  __nv_bfloat16* vs = ks + 2 * TILE;  // two buffers
  int8_t* ring = reinterpret_cast<int8_t*>(vs + 2 * TILE);  // int8: two K/V slots
  float* scs = reinterpret_cast<float*>(ring + 4 * TKV * D);  // int8: two tiles' scales
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
  // ... and 64 rows of D int8 codes, unpadded.
  auto copy_codes = [&](int8_t* dst, const int8_t* src, int rows) {
    for (int i = threadIdx.x; i < TKV * (D / 16); i += NT) {
      const int r = i / (D / 16), c = (i % (D / 16)) * 16;
      const bool in = r < rows;
      tc::cp_async16(dst + r * D + c, in ? src + (size_t)r * D + c : src, in);
    }
  };
  auto load_kv = [&](int blk, int buf) {
    const size_t at = kv_base + (size_t)blk * TKV * D;
    if constexpr (I8) {
      copy_codes(ring + buf * 2 * TKV * D, k + at, skv - blk * TKV);
      copy_codes(ring + (buf * 2 + 1) * TKV * D, v + at, skv - blk * TKV);
    } else {
      copy_tile(ks + buf * TILE, k + at, skv - blk * TKV);
      copy_tile(vs + buf * TILE, v + at, skv - blk * TKV);
    }
  };
  // int8: thread j < 64 carries K's scale of a tile's key j, thread 64 + j
  // V's; 0 past skv.
  auto load_scale = [&](int blk) {
    const int j = threadIdx.x & (TKV - 1), key = blk * TKV + j;
    const float* src = threadIdx.x < TKV ? k_scale : v_scale;
    return key < skv ? src[(size_t)(bh / group) * skv + key] : 0.f;
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

  uint32_t qf[D / 16][4];
  if constexpr (I8) {
    // Prologue: Q and tile lo, then tile lo + 1 in flight; tile lo
    // converted and its scales stored before the loop.
    float sc = 0.f;
    if (lo <= hi) {
      copy_tile(qs, qsrc, sq - q0);
      load_kv(lo, 0);
      tc::cp_async_commit();
      if (lo < hi) load_kv(lo + 1, 1);
      tc::cp_async_commit();
      scs[threadIdx.x] = load_scale(lo);
      if (lo < hi) sc = load_scale(lo + 1);
      tc::cp_async_wait<1>();
      __syncthreads();
      convert_codes<D>(ks, ring);
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        tc::frag_a_rowmajor(qf[c], qs, LD, warp * 16, c * 16);
    }
    for (int blk = lo; blk <= hi; ++blk) {
      const int buf = (blk - lo) & 1;
      tc::cp_async_wait<0>();  // tile blk + 1 has landed
      __syncthreads();         // tile blk converted; tile blk - 1 folded
      if (blk < hi) {
        if (blk + 2 <= hi) load_kv(blk + 2, buf);  // the slot tile blk held
        tc::cp_async_commit();
        convert_codes<D>(ks + (buf ^ 1) * 2 * TILE, ring + (buf ^ 1) * 2 * TKV * D);
        scs[(buf ^ 1) * 2 * TKV + threadIdx.x] = sc;
        if (blk + 2 <= hi) sc = load_scale(blk + 2);
      }
      const int k0 = blk * TKV;
      if (fa::warp_sees(wq, sq, off, k0, causal, window)) {
        const __nv_bfloat16* kt = ks + buf * 2 * TILE;
        const __nv_bfloat16* vt = kt + TILE;
        const float* ksc = scs + buf * 2 * TKV;
        const float* vsc = ksc + TKV;
#define FA_LDSM_K(r, row, col) tc::ldmatrix_x4(r, kt + (size_t)(row) * LD + col)
#define FA_FRAG_V(b0, b1, kr, cc) tc::frag_b2_rowmajor(b0, b1, vt, LD, kr, cc)
#define FA_KSCALE(j) ksc[j]
#define FA_VSCALE(j) vsc[j]
#include "flash_tc_step.cuh"
#undef FA_KSCALE
#undef FA_VSCALE
#undef FA_LDSM_K
#undef FA_FRAG_V
      }
    }
  } else {
    if (lo <= hi) {
      copy_tile(qs, qsrc, sq - q0);
      tc::cp_async_commit();
      load_kv(lo, 0);
      tc::cp_async_commit();
    }
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
    // the row's statistic: the quad's four threads hold the same m and l
    if (lse && t == 0)
      lse[(size_t)bh * sq + row] = l > 0.f ? m_run[h] + logf(l) : REPRO_NO_KEY_LSE;
  }
}

template <int D, typename KV>
int launch_tc(const void* q, const void* k, const void* v, const float* k_scale,
              const float* v_scale, void* o, float* lse, int bh, int sq, int skv, int group,
              int heads_per_row, const int* kv_lens, int kv_len, int window, int causal,
              float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem<D, KV>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((sq + TQ - 1) / TQ, bh);
  flash_tc_kernel<D, KV><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), k_scale, v_scale, static_cast<__nv_bfloat16*>(o), lse,
      sq, skv, group, heads_per_row, kv_lens, kv_len, window, causal, scale);
  return launch_status();
}

template <int D, typename KV>
int launch_f32(const void* q, const void* k, const void* v, const float* k_scale,
               const float* v_scale, void* o, float* lse, int bh, int sq, int skv, int group,
               int heads_per_row, const int* kv_lens, int kv_len, int window,
               int causal, float scale, cudaStream_t stream) {
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_kernel<float, KV, D><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), k_scale, v_scale, static_cast<float*>(o), lse, sq,
      skv, group, heads_per_row, kv_lens, kv_len, window, causal, scale);
  return launch_status();
}

// dtype: q's element type (REPRO_F32 or REPRO_BF16); kv: K's and V's
// (the same, or REPRO_I8).
template <int D>
int launch(int dtype, int kv, const void* q, const void* k, const void* v,
           const float* k_scale, const float* v_scale, void* o, float* lse, int bh, int sq,
           int skv, int group, int heads_per_row, const int* kv_lens, int kv_len,
           int window, int causal, float scale, cudaStream_t stream) {
  if (dtype == REPRO_F32 && kv == REPRO_F32)
    return launch_f32<D, float>(q, k, v, nullptr, nullptr, o, lse, bh, sq, skv, group,
                                heads_per_row, kv_lens, kv_len, window, causal, scale,
                                stream);
  if (dtype == REPRO_F32)
    return launch_f32<D, int8_t>(q, k, v, k_scale, v_scale, o, lse, bh, sq, skv, group,
                                 heads_per_row, kv_lens, kv_len, window, causal, scale,
                                 stream);
  if (kv == REPRO_BF16)
    return launch_tc<D, __nv_bfloat16>(q, k, v, nullptr, nullptr, o, lse, bh, sq, skv, group,
                                       heads_per_row, kv_lens, kv_len, window, causal,
                                       scale, stream);
  return launch_tc<D, int8_t>(q, k, v, k_scale, v_scale, o, lse, bh, sq, skv, group,
                              heads_per_row, kv_lens, kv_len, window, causal, scale,
                              stream);
}

}  // namespace

// q (bh, sq, d); k, v (bh / group, skv, d); o like q; lse null, or (bh, sq)
// f32 for the rows' statistics. dtype: q's (and o's)
// element type, float32 or bf16; kv_dtype: K's and V's, the same, or int8
// with k_scale and v_scale (bh / group, skv) f32, one per position. kv_lens:
// null (every head row uses kv_len) or bh / heads_per_row lengths on the
// device, any int (a length outside [0, skv] bands a range of a longer
// sequence). window <= 0: no sliding window. d: 16, 32, 64 or 128.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const float* k_scale, const float* v_scale, void* o,
                               float* lse,
                               int dtype, int kv_dtype, int d, int bh, int sq,
                               int skv, int group, int heads_per_row,
                               const int* kv_lens, int kv_len, int window,
                               int causal, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || skv <= 0 || group <= 0 ||
      bh % group || (kv_lens && (heads_per_row <= 0 || bh % heads_per_row)))
    return REPRO_BAD_ARGUMENT;
  if (dtype != REPRO_F32 && dtype != REPRO_BF16) return REPRO_BAD_ARGUMENT;
  const bool i8 = kv_dtype == REPRO_I8 && k_scale && v_scale;
  if (!i8 && kv_dtype != dtype) return REPRO_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(dtype, kv_dtype, q, k, v, k_scale, v_scale, o, lse, bh, sq, skv,
                        group, heads_per_row, kv_lens, kv_len, window, causal, scale, s);
    case 32:
      return launch<32>(dtype, kv_dtype, q, k, v, k_scale, v_scale, o, lse, bh, sq, skv,
                        group, heads_per_row, kv_lens, kv_len, window, causal, scale, s);
    case 64:
      return launch<64>(dtype, kv_dtype, q, k, v, k_scale, v_scale, o, lse, bh, sq, skv,
                        group, heads_per_row, kv_lens, kv_len, window, causal, scale, s);
    case 128:
      return launch<128>(dtype, kv_dtype, q, k, v, k_scale, v_scale, o, lse, bh, sq, skv,
                         group, heads_per_row, kv_lens, kv_len, window, causal, scale,
                         s);
    default:
      return REPRO_BAD_ARGUMENT;
  }
}
