// B7: KV-stationary (weight-stationary) GQA attention.
//
// Replaces the TPU kernel repro/kernels/attention_df.py `_kv_stationary_kernel`
// / `_kv_single_kernel` (built by `kv_stationary_attention`): the WS anchor of
// attention. Each 64-key K and V block leaves device memory once per kv head
// (the q heads of its GQA group all fold it), the query tiles stream past it,
// and each query row's online-softmax state (acc, m, l) goes through device
// memory once per KV block it sees (the paper's WS output traffic), except
// where a CTA holds a single query tile and keeps its state in registers.
//
// bf16 (kv_cluster_kernel) runs on thread-block clusters and the tensor
// cores. A unit is one (q head of the group, 64-row q tile); a cluster of C
// CTAs owns every unit of one (batch row, kv head), CTA r taking units r,
// r + C, ... (C from the rule of gemm_cluster.cuh's cl::cluster_size: doubled
// from 2 while the card has SMs without a CTA, up to 16 and to the units).
// The walk is KV-block-outer: every CTA finishes block j for all its units
// before it uses block j + 1. A producer warp in each CTA issues its share of
// each block's 8-row pieces with one TMA copy multicast into every CTA of the
// cluster (128-byte rows with the 128-byte swizzle, 64-byte rows with the
// 64-byte one at D = 32; zeros past the keys), so the block leaves device
// memory once per cluster, through a ring of KV_STAGES blocks on mbarriers;
// a block's slot is refilled once every CTA of the cluster has arrived on its
// `spent` mbarrier, including CTAs whose units see no key of the block. Four
// warps fold: each warp takes flash_tc.cuh's step (B2's, on mma.sync
// m16n8k16, P in three bf16 parts) over the tiles B2's band and per-warp
// skip give its 16 rows, in ascending order. A CTA with one unit keeps the
// state and Q's fragments in registers; a CTA with several loads each
// unit's Q fragments and f32 state from device memory at each block of its
// band and stores the state again (the `acc` / `ml` scratch), which is exact.
// So every bf16 output equals B2's bit for bit.
//
// int8 K/V under bf16 queries (the int8 KV cache) takes the same cluster
// kernel: the TMA multicasts each block's int8 codes (a UINT8 tensor map,
// 8-row pieces of D bytes, unswizzled) at half the bytes; each CTA converts
// its copy exactly to bf16 into work tiles laid out as the bf16 ring's
// swizzled slots (releasing the ring slot to the cluster at once), reads the
// block's 64 K and 64 V scales from device memory (a block ahead; a tensor
// map of the scales would need Skv % 4 == 0), and its warps fold with the
// step and the scale macros of B2's int8 path, so every int8 output equals
// B2's int8 output bit for bit too.
//
// float32 (kv_kernel) keeps the CUDA cores: one CTA per (batch*head) walks
// the KV blocks outer (each fetched once per q head) and 16-row q tiles
// inner; for each visible (KV block, q tile) pair the tile's rows load their
// state from device memory (or start it, at the first block of the tile's
// band), fold the block in with attention_common.cuh's step (one warp per
// row, one key per lane) and store it again (or, at the last block of the
// band, write acc / l, with l == 0 -> 0). Tiles with an empty band write
// zeros. The band and mask are B2's (attention_df.py `_band_lo_hi`).
// int8 K/V under f32 queries takes the same kernel: the 32-key int8 tiles
// held as exact floats, each lane's key's K and V scales folded as B2's f32
// kernel folds them (attention_common.cuh), so its output equals B2's f32
// int8 output bit for bit.
//
// Both kernels are built for d_head 16, 32, 64 and 128: at D = 16 the
// cluster kernel's bf16 rows are 32 bytes, copied with the TMA's 32-byte
// swizzle (an int8 row, 16 bytes, unswizzled).
//
// Bound on H100: the arithmetic at prefill lengths, as B2. bf16: the walk
// gives B x Hkv clusters of C CTAs (8 x 16 at qwen3-1.7b's prefill); a CTA
// with several units adds 2 * (D + 2) * 4 bytes of state traffic per visible
// (row, KV block) pair, mostly served from L2. float32: one CTA per
// (batch*head), Hq of the 132 SMs at batch 1.
#include <climits>
#include <type_traits>

#include "attention_common.cuh"
#include "flash_tc.cuh"
#include "gemm_cluster.cuh"

namespace {

using fa::TKV;  // flash_tc_step.cuh's tile

constexpr int BQ = 16;   // query rows per tile: one per warp
constexpr int BKV = 32;  // keys per KV block: one per lane
constexpr int WARPS = BQ;

// KV = T: float K/V. KV = int8_t: int8 codes with per-position f32 scales
// (k_scale, v_scale (bh / group, skv)), folded per key.
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(WARPS * 32)
kv_kernel(const T* __restrict__ q, const KV* __restrict__ k,
          const KV* __restrict__ v, const float* __restrict__ k_scale,
          const float* __restrict__ v_scale, T* __restrict__ o,
          float* __restrict__ acc_st, float* __restrict__ ml_st, int sq,
          int skv, int group, int heads_per_row, const int* __restrict__ kv_lens,
          int kv_len, int window, int causal, float scale) {
  constexpr bool I8 = std::is_same<KV, int8_t>::value;
  __shared__ float qs[BQ][D];
  __shared__ float ks[BKV][D + 1];
  __shared__ float vs[BKV][D];
  __shared__ float scs[2][BKV];  // int8: the block's K and V scales
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
    load_tiles<KV, BKV, D, D + 1, D, WARPS * 32>(
        &ks[0][0], k + tile, &vs[0][0], v + tile, D, skv - blk * BKV);
    if constexpr (I8) {
      // thread j < 32 stores K's scale of the block's key j, 32 + j V's; 0
      // past skv (read after the q tile's barrier below)
      if (threadIdx.x < 2 * BKV) {
        const int j = threadIdx.x & (BKV - 1), key = blk * BKV + j;
        const float* src = threadIdx.x < BKV ? k_scale : v_scale;
        scs[threadIdx.x / BKV][j] = key < skv ? src[(size_t)(bh / group) * skv + key] : 0.f;
      }
    }
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
        for (int c = 0; c < RowState<D>::COLS; ++c)
          if (owns_col<D>(lane, c)) st.acc[c] = acc_st[row * D + lane + 32 * c];
      }
      const int qpos = r + off;
      bool valid = kpos < kv_valid && kpos < skv;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && kpos > qpos - window;
      if constexpr (I8)
        fold_tile<D, true>(qs[warp], &ks[0][0], &vs[0][0], BKV, valid, scale, st,
                           scs[0][lane], scs[1][lane]);
      else
        fold_tile<D>(qs[warp], &ks[0][0], &vs[0][0], BKV, valid, scale, st);
      if (blk == hi) {
        write_row<T, D>(o + row * D, st);
      } else {
#pragma unroll
        for (int c = 0; c < RowState<D>::COLS; ++c)
          if (owns_col<D>(lane, c)) acc_st[row * D + lane + 32 * c] = st.acc[c];
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

// The bf16 cluster kernel (above).
// KV blocks held at once, and two CTAs an SM (__launch_bounds__): at 255
// registers, one CTA an SM, an H100 placed 7 clusters of 16 at once, so
// qwen3-1.7b's 8 kv heads took two waves (PERF.md, PR 22).
constexpr int KV_STAGES = 2;
constexpr int KV_THREADS = fa::WARPS * 32 + 32;    // 4 warps that fold, a producer
// kv_stationary's one tile: the cluster kernel (kernels/_build.py).
constexpr int TILE_KV_CLUSTER = 1;

template <int D, bool I8 = false>
__host__ __device__ constexpr int kv_stage_bytes() {  // a K block and a V block
  return 2 * fa::TKV * D * (I8 ? 1 : 2);
}
// int8: the block's K and V converted to bf16 (the TMA's swizzled layout),
// then its 64 K and 64 V scales.
template <int D>
__host__ __device__ constexpr int kv_work_bytes() {
  return kv_stage_bytes<D>() + 2 * fa::TKV * 4;
}
template <int D, bool I8 = false>
constexpr size_t kv_cluster_smem() {  // the ring, (int8) the work tiles, the mbarriers
  return (size_t)KV_STAGES * kv_stage_bytes<D, I8>() + (I8 ? kv_work_bytes<D>() : 0) +
         gemm::round_up(16 * KV_STAGES, 128);
}
// CTAs of a cluster for `clusters` clusters of `units` units each (one CTA
// for a single unit). attention_df.kv_stationary_plan mirrors it.
inline int kv_cluster_size(int clusters, int units) {
  return units < 2 ? 1 : gemm::cl::cluster_size(clusters, units, 1);
}

// Byte offset of the 16-byte chunk (key r, columns c..c+7) in a K or V slot:
// 64-column panels of 64 rows, 128-byte rows with the TMA's 128-byte swizzle
// (64-byte rows with its 64-byte swizzle at D = 32; 32-byte rows with its
// 32-byte swizzle at D = 16, chunk (c / 8) ^ ((r / 4) % 2): the 8 rows of an
// ldmatrix then fall on distinct banks).
template <int D>
__device__ __forceinline__ uint32_t kv_off(int r, int c) {
  if constexpr (D == 16)
    return (uint32_t)(r * 32 + ((((c >> 3) ^ (r >> 2)) & 1) << 4) + ((c & 7) << 1));
  else if constexpr (D == 32) return (uint32_t)gemm::cl::a_off(r, c);
  else return (uint32_t)((c >> 6) * fa::TKV * 128 + gemm::cl::b_off(r, c & 63));
}

// Q's fragments of the warp's rows wq.., wq + 15 of a (sq x D) bf16 head in
// device memory, rows past sq as zeros (B2's Q tile holds the same).
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4],
                                       const __nv_bfloat16* qh, int wq, int sq) {
  const int g = tc::lane() >> 2, t = tc::lane() & 3;
  const int r0 = wq + g, r1 = r0 + 8;
  const uint32_t* q0 = reinterpret_cast<const uint32_t*>(qh + (size_t)r0 * D);
  const uint32_t* q1 = reinterpret_cast<const uint32_t*>(qh + (size_t)r1 * D);
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    qf[c][0] = r0 < sq ? q0[c * 8 + t] : 0u;
    qf[c][1] = r1 < sq ? q1[c * 8 + t] : 0u;
    qf[c][2] = r0 < sq ? q0[c * 8 + 4 + t] : 0u;
    qf[c][3] = r1 < sq ? q1[c * 8 + 4 + t] : 0u;
  }
}

// A warp's running state: m and l of its rows g (h = 0) and g + 8 (h = 1),
// and their accumulator fragments (o[i][j]: row g + 8 (j >> 1), column
// 8 i + 2 t + (j & 1)).
template <int D>
struct State {
  float m[2], l[2], o[D / 8][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int h = 0; h < 2; ++h) m[h] = REPRO_NEG_INF, l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }
  // Through device memory: acc (rows x D) and ml (rows x 2), f32, rows of
  // the head from row0; rows past sq keep the initial state.
  __device__ __forceinline__ void load(const float* acc, const float* ml, size_t row0,
                                       int wq, int sq) {
    const int g = tc::lane() >> 2, t = tc::lane() & 3;
    init();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wq + g + 8 * h;
      if (r >= sq) continue;
      const float* a = acc + (row0 + r) * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float2 x = *reinterpret_cast<const float2*>(a + i * 8 + 2 * t);
        o[i][2 * h] = x.x;
        o[i][2 * h + 1] = x.y;
      }
      m[h] = ml[2 * (row0 + r)];
      l[h] = ml[2 * (row0 + r) + 1];
    }
  }
  __device__ __forceinline__ void store(float* acc, float* ml, size_t row0, int wq,
                                        int sq) const {
    const int g = tc::lane() >> 2, t = tc::lane() & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wq + g + 8 * h;
      if (r >= sq) continue;
      float* a = acc + (row0 + r) * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(a + i * 8 + 2 * t) = make_float2(o[i][2 * h], o[i][2 * h + 1]);
      if (t == 0) {  // the quad's four lanes hold the same m and l
        ml[2 * (row0 + r)] = m[h];
        ml[2 * (row0 + r) + 1] = l[h];
      }
    }
  }
  // acc / l into the warp's rows wq.. of a (sq x D) bf16 head; a row that
  // saw no valid key (l == 0) writes zeros (B2's write).
  __device__ __forceinline__ void write(__nv_bfloat16* out, int wq, int sq) const {
    const int g = tc::lane() >> 2, t = tc::lane() & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wq + g + h * 8;
      if (row >= sq) continue;
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)row * D);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        dst[(i * 8 + 2 * t) / 2] =
            l[h] > 0.f ? tc::pack2_rn(o[i][2 * h] / l[h], o[i][2 * h + 1] / l[h]) : 0u;
    }
  }
};

// The B fragments of V's 16 keys from kr and columns c.., c + 8.. in a
// swizzled slot at shared address vt (mma_common.cuh's frag_b2_rowmajor).
template <int D>
__device__ __forceinline__ void frag_v(uint32_t b0[2], uint32_t b1[2], uint32_t vt, int kr,
                                       int c) {
  const int l = tc::lane();
  uint32_t r[4];
  tc::ldsm_x4_trans(r, vt + kv_off<D>(kr + (l & 7) + ((l >> 3) & 1) * 8, c + (l >> 4) * 8));
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

// int8: the block's codes (rows of D bytes, unswizzled, in slot `codes`)
// converted exactly to bf16 into the work tiles at kv_off's places, 16 codes
// a thread of the 4 folding warps at a time (fa::codes_to_bf16).
template <int D>
__device__ __forceinline__ void convert_codes(unsigned char* work,
                                              const unsigned char* codes) {
  constexpr int CPR = D / 16, WT = fa::TKV * D * 2;  // chunks a row; a work tile's bytes
  constexpr int CHUNKS = 2 * fa::TKV * CPR, NT = fa::WARPS * 32;
#pragma unroll 2
  for (int j = 0; j < CHUNKS / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int kv = i / (fa::TKV * CPR), r = (i / CPR) % fa::TKV, c = (i % CPR) * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(codes + (kv * fa::TKV + r) * D + c);
    uint4 a, b;
    fa::codes_to_bf16(w.x, a.x, a.y);
    fa::codes_to_bf16(w.y, a.z, a.w);
    fa::codes_to_bf16(w.z, b.x, b.y);
    fa::codes_to_bf16(w.w, b.z, b.w);
    unsigned char* dst = work + kv * WT;
    *reinterpret_cast<uint4*>(dst + kv_off<D>(r, c)) = a;
    *reinterpret_cast<uint4*>(dst + kv_off<D>(r, c + 8)) = b;
  }
}

// Cluster kvh / C's (batch row, kv head) is kvh: its q heads are
// kvh * group .. kvh * group + group - 1; unit u is (q tile u / group, q head
// u % group). I8: K and V are int8 codes with per-position f32 scales
// (k_scale, v_scale (clusters, skv)); each CTA converts each multicast block
// of codes into bf16 work tiles with the block's scales, and folds them with
// the step and the macros of B2's int8 path.
template <int D, bool I8>
__global__ void __launch_bounds__(KV_THREADS, 2)
kv_cluster_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ acc_st, float* __restrict__ ml_st, int sq, int skv,
                  int group, int heads_per_row, const int* __restrict__ kv_lens,
                  int kv_len, int window, int causal, float scale,
                  const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v) {
  using namespace gemm::cl;
  constexpr int STAGE = kv_stage_bytes<D, I8>(), TILE = STAGE / 2;
  // bf16: 128-byte rows with the 128-byte swizzle (64-byte ones at D = 32,
  // 32-byte ones at D = 16), in 64-column panels; int8: rows of D bytes, one
  // panel.
  constexpr int ROW = I8 ? D : D < 64 ? 2 * D : 128;
  constexpr int PANELS = I8 || D < 64 ? 1 : D / 64;
  constexpr int PIECES = 2 * PANELS * fa::TKV / 8;  // 8-row boxes a K and V block
  constexpr int FOLD = fa::WARPS * 32;              // threads that fold
  constexpr int WORK = KV_STAGES * STAGE;           // int8: the work tiles' offset
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = tc::smem_addr(smem);
  float* ksc = reinterpret_cast<float*>(smem + WORK + kv_stage_bytes<D>());  // int8
  float* vsc = ksc + fa::TKV;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + WORK + (I8 ? kv_work_bytes<D>() : 0));
  uint64_t* spent = full + KV_STAGES;
  const int C = ctas_in_cluster(), rank = rank_in_cluster();
  const int kvh = blockIdx.x / C;
  const int kv_valid = kv_lens ? kv_lens[kvh * group / heads_per_row] : kv_len;
  const int off = kv_valid - sq;
  const int gq = gemm::cdiv(sq, fa::TQ), units = gq * group;
  // The blocks the cluster walks: from the first block of the lowest band
  // to the last of the highest (tiles that see no key have none).
  int blo = INT_MAX, bhi = -1;
  for (int t = 0; t < gq; ++t) {
    int lo, hi;
    fa::band(t * fa::TQ, sq, skv, kv_valid, causal, window, &lo, &hi);
    if (lo <= hi) blo = min(blo, lo), bhi = max(bhi, hi);
  }
  const int blocks = bhi >= 0 ? bhi - blo + 1 : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < KV_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&spent[i], C);
    }
    mbar_init_fence();
  }
  cluster_arrive();  // every CTA's mbarriers exist before any copy lands
  cluster_wait();
  if (threadIdx.x == FOLD) {  // the producer: this CTA's pieces of each block
    const uint16_t all = (uint16_t)((1u << C) - 1);
    for (int x = 0; x < blocks; ++x) {
      const int sl = x % KV_STAGES, k0 = (blo + x) * fa::TKV;
      if (x >= KV_STAGES) mbar_wait<true>(&spent[sl], (x / KV_STAGES - 1) & 1);
      mbar_expect(&full[sl], STAGE);
      for (int p = rank; p < PIECES; p += C) {
        const int kv = p / (PIECES / 2), panel = (p % (PIECES / 2)) / 8, rg = p % 8;
        tma_multicast_3d(smem + sl * STAGE + kv * TILE + (panel * fa::TKV + rg * 8) * ROW,
                         kv ? map_v : map_k, panel * 64, k0 + rg * 8, kvh, &full[sl], all);
      }
    }
  } else if (threadIdx.x < FOLD) {
    const int warp = threadIdx.x >> 5, g = tc::lane() >> 2, t = tc::lane() & 3;
    const int nu = rank < units ? gemm::cdiv(units - rank, C) : 0;
    const bool held = nu == 1;  // state and Q fragments stay in registers
    State<D> st;
    st.init();
    uint32_t qf[D / 16][4];
    // int8: thread j < 64 carries K's scale of the block's key j, thread
    // 64 + j V's, read a block ahead; 0 past skv.
    auto load_scale = [&](int blk) {
      const int j = threadIdx.x & (fa::TKV - 1), key = blk * fa::TKV + j;
      const float* src = threadIdx.x < fa::TKV ? k_scale : v_scale;
      return key < skv ? src[(size_t)kvh * skv + key] : 0.f;
    };
    float sc_next = 0.f;
    if constexpr (I8) {
      if (blocks) sc_next = load_scale(blo);
    }
    for (int x = 0; x < blocks; ++x) {
      const int sl = x % KV_STAGES, blk = blo + x, k0 = blk * fa::TKV;
      const uint32_t kt = sbase + (I8 ? WORK : sl * STAGE), vt = kt + (I8 ? TILE * 2 : TILE);
      mbar_wait(&full[sl], (x / KV_STAGES) & 1);
      if constexpr (I8) {
        convert_codes<D>(smem + WORK, smem + sl * STAGE);
        (threadIdx.x < fa::TKV ? ksc : vsc)[threadIdx.x & (fa::TKV - 1)] = sc_next;
        if (x + 1 < blocks) sc_next = load_scale(blk + 1);
        asm volatile("bar.sync 1, %0;\n" ::"n"(FOLD) : "memory");
        // the codes are converted: every CTA of the cluster hears that the
        // slot may be refilled while this CTA folds the work tiles
        if (threadIdx.x < C) mbar_arrive_peer(&spent[sl], threadIdx.x);
      }
      for (int i = 0; i < nu; ++i) {
        const int u = rank + i * C, q0 = u / group * fa::TQ;
        const size_t row0 = (size_t)(kvh * group + u % group) * sq;  // the head's rows
        int lo, hi;
        fa::band(q0, sq, skv, kv_valid, causal, window, &lo, &hi);
        if (blk < lo || blk > hi) continue;  // out of band: no update
        const int wq = q0 + warp * 16;
        if (blk == lo || !held) load_q<D>(qf, q + row0 * D, wq, sq);
        if (blk == lo) st.init();
        else if (!held) st.load(acc_st, ml_st, row0, wq, sq);
        if (fa::warp_sees(wq, sq, off, k0, causal, window)) {
          const int qpos0 = wq + g + off, qpos1 = qpos0 + 8;
          float(&m_run)[2] = st.m;
          float(&l_run)[2] = st.l;
          float(&oacc)[D / 8][4] = st.o;
#define FA_LDSM_K(r, row, col) tc::ldsm_x4(r, kt + kv_off<D>(row, col))
#define FA_FRAG_V(b0, b1, kr, cc) frag_v<D>(b0, b1, vt, kr, cc)
          if constexpr (I8) {
#define FA_KSCALE(j) ksc[j]
#define FA_VSCALE(j) vsc[j]
#include "flash_tc_step.cuh"
#undef FA_KSCALE
#undef FA_VSCALE
          } else {
#include "flash_tc_step.cuh"
          }
#undef FA_LDSM_K
#undef FA_FRAG_V
        }
        if (blk == hi) st.write(o + row0 * D, wq, sq);
        else if (!held) st.store(acc_st, ml_st, row0, wq, sq);
      }
      // the four warps are done with the slot (int8: with the work tiles):
      // every CTA of the cluster hears
      asm volatile("bar.sync 1, %0;\n" ::"n"(FOLD) : "memory");
      if (!I8 && threadIdx.x < C) mbar_arrive_peer(&spent[sl], threadIdx.x);
    }
    // Units whose band is empty see no key: their rows write zeros.
    for (int i = 0; i < nu; ++i) {
      const int u = rank + i * C, q0 = u / group * fa::TQ;
      int lo, hi;
      fa::band(q0, sq, skv, kv_valid, causal, window, &lo, &hi);
      if (lo > hi) {
        st.init();
        st.write(o + (size_t)(kvh * group + u % group) * sq * D, q0 + warp * 16, sq);
      }
    }
  }
  __syncwarp();
  cluster_arrive();  // no CTA leaves while copies or arrivals into it may land
  cluster_wait();
}

template <int D, bool I8>
int launch_cluster(const void* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, void* o, float* acc, float* ml, int bh, int sq,
                   int skv, int group, int heads_per_row, const int* kv_lens, int kv_len,
                   int window, int causal, float scale, cudaStream_t stream,
                   gemm::Took* took) {
  const int clusters = bh / group, units = gemm::cdiv(sq, fa::TQ) * group;
  const int C = kv_cluster_size(clusters, units);
  const size_t smem = kv_cluster_smem<D, I8>();
  if ((long long)clusters * C > INT_MAX) return REPRO_BAD_ARGUMENT;
  if (took) *took = {TILE_KV_CLUSTER, (int)smem, clusters * C, C};
  // K and V as (clusters, skv, D): bf16 in 8-row boxes of one 64-column
  // panel (of all D columns at D = 16 and 32), swizzled; int8 in 8-row boxes
  // of all D columns, unswizzled; zeros past skv.
  const int elt = I8 ? 1 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)skv, (cuuint64_t)clusters};
  const cuuint64_t strides[2] = {(cuuint64_t)D * elt, (cuuint64_t)skv * D * elt};
  const cuuint32_t box[3] = {(cuuint32_t)(I8 || D < 64 ? D : 64), 8, 1};
  const CUtensorMapSwizzle sw = I8        ? CU_TENSOR_MAP_SWIZZLE_NONE
                                : D == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapDataType type =
      I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mk, mv;
  int rc = gemm::cl::make_map_nd(&mk, k, 3, dims, strides, box, sw, type);
  if (!rc) rc = gemm::cl::make_map_nd(&mv, v, 3, dims, strides, box, sw, type);
  if (rc) return rc;
  return gemm::cl::launch_in_clusters(
      kv_cluster_kernel<D, I8>, clusters * C, KV_THREADS, C, smem, stream,
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), acc, ml, sq,
      skv, group, heads_per_row, kv_lens, kv_len, window, causal, scale, k_scale, v_scale,
      mk, mv);
}

template <bool I8>
int launch_cluster_d(int d, const void* q, const void* k, const void* v,
                     const float* k_scale, const float* v_scale, void* o, float* acc,
                     float* ml, int bh, int sq, int skv, int group, int heads_per_row,
                     const int* kv_lens, int kv_len, int window, int causal, float scale,
                     cudaStream_t s, gemm::Took* took) {
  switch (d) {
    case 16:
      return launch_cluster<16, I8>(q, k, v, k_scale, v_scale, o, acc, ml, bh, sq, skv,
                                    group, heads_per_row, kv_lens, kv_len, window, causal,
                                    scale, s, took);
    case 32:
      return launch_cluster<32, I8>(q, k, v, k_scale, v_scale, o, acc, ml, bh, sq, skv,
                                    group, heads_per_row, kv_lens, kv_len, window, causal,
                                    scale, s, took);
    case 64:
      return launch_cluster<64, I8>(q, k, v, k_scale, v_scale, o, acc, ml, bh, sq, skv,
                                    group, heads_per_row, kv_lens, kv_len, window, causal,
                                    scale, s, took);
    case 128:
      return launch_cluster<128, I8>(q, k, v, k_scale, v_scale, o, acc, ml, bh, sq, skv,
                                     group, heads_per_row, kv_lens, kv_len, window, causal,
                                     scale, s, took);
    default:
      return REPRO_BAD_ARGUMENT;
  }
}

template <typename KV>
int launch_f32(const void* q, const void* k, const void* v, const float* k_scale,
               const float* v_scale, void* o, float* acc, float* ml, int d, int bh,
               int sq, int skv, int group, int heads_per_row, const int* kv_lens,
               int kv_len, int window, int causal, float scale, cudaStream_t stream) {
  auto go = [&](auto kernel) {
    kernel<<<bh, WARPS * 32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const KV*>(k),
        static_cast<const KV*>(v), k_scale, v_scale, static_cast<float*>(o), acc, ml,
        sq, skv, group, heads_per_row, kv_lens, kv_len, window, causal, scale);
    return launch_status();
  };
  switch (d) {
    case 16: return go(&kv_kernel<float, KV, 16>);
    case 32: return go(&kv_kernel<float, KV, 32>);
    case 64: return go(&kv_kernel<float, KV, 64>);
    case 128: return go(&kv_kernel<float, KV, 128>);
    default: return REPRO_BAD_ARGUMENT;
  }
}

}  // namespace

// q (bh, sq, d); k, v (bh / group, skv, d); o like q; acc (bh, sq, d) and
// ml (bh, sq, 2) f32 scratch for the running state (written before it is
// read). dtype: q's (and o's) element type, float32 or bf16; kv_dtype: K's
// and V's, the same, or int8 with k_scale and v_scale (bh / group, skv) f32,
// one per position. d: 16, 32, 64 or 128. kv_lens: null (every head row uses kv_len) or bh /
// heads_per_row lengths on the device. window <= 0: no sliding window. took
// (may be null): the cluster kernel's report (gemm::Took: TILE_KV_CLUSTER,
// its shared memory, CTAs and cluster size), TILE_WALK for the f32 kernel.
extern "C" int kv_stationary(const void* q, const void* k, const void* v,
                             const float* k_scale, const float* v_scale, void* o,
                             float* acc, float* ml, int dtype, int kv_dtype, int d,
                             int bh, int sq, int skv, int group,
                             int heads_per_row, const int* kv_lens, int kv_len,
                             int window, int causal, float scale,
                             gemm::Took* took, void* stream) {
  if (took) *took = gemm::Took{};
  if (bh <= 0 || sq <= 0 || skv <= 0 || group <= 0 || bh % group ||
      (kv_lens && (heads_per_row <= 0 || bh % heads_per_row)))
    return REPRO_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32 && kv_dtype == REPRO_F32)
    return launch_f32<float>(q, k, v, nullptr, nullptr, o, acc, ml, d, bh, sq, skv,
                             group, heads_per_row, kv_lens, kv_len, window, causal,
                             scale, s);
  if (dtype == REPRO_F32 && kv_dtype == REPRO_I8 && k_scale && v_scale)
    return launch_f32<int8_t>(q, k, v, k_scale, v_scale, o, acc, ml, d, bh, sq, skv,
                              group, heads_per_row, kv_lens, kv_len, window, causal,
                              scale, s);
  if (dtype != REPRO_BF16) return REPRO_BAD_ARGUMENT;
  if (kv_dtype == REPRO_BF16)
    return launch_cluster_d<false>(d, q, k, v, nullptr, nullptr, o, acc, ml, bh, sq, skv,
                                   group, heads_per_row, kv_lens, kv_len, window, causal,
                                   scale, s, took);
  if (kv_dtype == REPRO_I8 && k_scale && v_scale)
    return launch_cluster_d<true>(d, q, k, v, k_scale, v_scale, o, acc, ml, bh, sq, skv,
                                  group, heads_per_row, kv_lens, kv_len, window, causal,
                                  scale, s, took);
  return REPRO_BAD_ARGUMENT;
}
