// B3: paged decode attention (one query row per sequence, Sq == 1).
//
// Replaces the TPU kernel repro/kernels/attention_df.py `_paged_kernel`
// (built by `paged_flash_attention`), where the block table rode the
// scalar-prefetch index map. Each row reads its valid length from `kv_lens`
// and visits its logical pages lo..hi (hi: the last valid page; lo: the
// first page the sliding window reaches, as at attention_df.py:602-608),
// reading each physical page id from the row's block table in device
// memory. A row with kv_len == 0 visits no page and writes zeros; a page id
// outside the pool is treated as fully masked.
//
// Bound on H100: bytes (every visited K/V key is read once; the arithmetic
// is 4*D flops per key), but at decode's few rows the latency of one walk
// over a row's keys sets the time. So the walk is split:
//   - A row's keys, from the 32-key slice of page lo that holds the
//     window's first key to its last valid key, are cut into chunks of
//     CHUNK_TILES tiles. A tile is 32 keys of the row's logical key range
//     (tile_keys: whole pages where a page holds fewer, as many as fit), and
//     each key maps to (logical page, offset) by kpos / page and kpos % page,
//     so a page over 32 keys spans several tiles and one of 48 keys needs no
//     special case. The cut depends on nothing but the row's own kv_len,
//     window and page size, so a row gets the same bits in any batch. One
//     CTA per (chunk, kv head, row): 5 x 8 CTAs for the 527-key row at
//     qwen3-1.7b's 8 kv heads.
//   - A CTA streams its chunk's tiles through a STAGES-deep cp.async ring in
//     shared memory, the next tiles' K and V in flight while one folds (keys
//     past the row's end are zero-filled, not read); the page ids of the
//     pages the chunk's keys lie on are read once, up front.
//   - All G warps fold: each (q head of the GQA group, part of D) has a warp
//     whose lanes take the tile's 32 keys, so a score is a few partial dots
//     summed in shared memory; one warp per q head runs the online softmax
//     over the tile (key j on lane j); then every thread folds P V into the
//     outputs it owns, 32 keys a tile, with no shuffles.
//   - G, the group bound, is a template parameter: a CTA of G warps holds the
//     q rows, probabilities and (m, l) of up to G q heads. A group of at most
//     8 takes the 8-warp kernel; a group of 9 to 16 (qwen3-moe-235b-a22b's
//     64 q heads over 4 kv heads) the 16-warp one, so every thread still owns
//     cdiv(8 * D, 256) outputs and every K/V key is still read once per
//     (chunk, kv head).
//   - Each chunk of a row with more than one writes its partial (m, l, acc)
//     to a workspace the wrapper sizes from the shapes; the last CTA of the
//     (row, kv head) to finish merges the partials in chunk order. It is
//     found by an atomicInc that wraps the row's counter back to zero as it
//     arrives, so every launch leaves the counters zero for the next one on
//     its stream (the wrapper keeps one buffer per device and stream). A row of one chunk writes
//     its output straight away.
// The fold is this kernel's own (B2's f32 fold in attention_common.cuh
// keeps its roundings). Built for d_head 16, 32, 64 and 128: at D = 16 a
// bf16 key row is two 16-byte vectors, so with a small group some score
// warps take no vector and store a zero partial, and the outputs are owned
// by the first 8 * G threads.
#include "mma_common.cuh"

namespace {

constexpr int MAX_GROUP = 16;  // q heads per kv head: the larger G
constexpr int TILE_KEYS = 32;  // keys a tile holds at most: one per lane
constexpr int CHUNK_TILES = 4; // tiles a chunk (attention_df.py keeps a copy)
constexpr int STAGES = 3;      // ring depth, in tiles

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// Keys of a tile, and of a chunk, at `page` keys a page: whole pages up to
// 32 keys (32 at a page of 16, 30 at a page of 5), else a 32-key slice.
__host__ __device__ constexpr int tile_keys(int page) {
  return page >= TILE_KEYS ? TILE_KEYS : TILE_KEYS / page * page;
}
__host__ __device__ constexpr int chunk_keys(int page) {
  return CHUNK_TILES * tile_keys(page);
}
// Pages a chunk's keys can lie on: a chunk starts on a page boundary where a
// page holds 32 keys or fewer, anywhere on a 32-key slice where it holds more.
__host__ __device__ constexpr int chunk_page_ids(int page) {
  return cdiv(chunk_keys(page) - 1, page) + 1;
}

// Threads of the CTA of group bound G: a warp per q head.
__host__ __device__ constexpr int threads(int g) { return 32 * g; }

// Shared memory of one CTA, in bytes: the ring of K and V tiles (rows padded
// by 16 bytes, an odd number of 16-byte units, so the lanes' vector loads of
// 32 keys hit distinct banks), q, the score partials (a row a warp), the
// probabilities, alpha and (m, l) per q head; then the chunk's page ids,
// chunk_page_ids(page) of them, sized at launch.
template <typename T, int D, int G>
struct Smem {
  static constexpr int V = 16 / sizeof(T);  // elements of a 16-byte vector
  static constexpr int LD = D + V;          // elements of a padded key row
  static constexpr int TILE = TILE_KEYS * LD;
  static constexpr size_t RING = (size_t)STAGES * 2 * TILE * sizeof(T);
  static constexpr size_t FLOATS = G * D + G * TILE_KEYS + G * TILE_KEYS + 3 * G;
  static constexpr size_t BASE = RING + FLOATS * 4;
  static size_t bytes(int page) { return BASE + (size_t)chunk_page_ids(page) * 4; }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(threads(G))
paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
             const T* __restrict__ v_pages, const int* __restrict__ tables,
             const int* __restrict__ kv_lens, T* __restrict__ o,
             float* __restrict__ ws_acc, float* __restrict__ ws_ml,
             int* __restrict__ counters, int hq, int group, int n_pages,
             int page, int max_pages, int max_chunks, int window,
             float scale) {
  using S = Smem<T, D, G>;
  constexpr int V = S::V, LD = S::LD, THREADS = threads(G);
  // outputs a thread owns, at most (D = 16: one for the first 8 * G threads)
  constexpr int OUTS = cdiv(G * D, THREADS);
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + S::RING);  // [G][D]
  float* sp = qs + G * D;                 // [G warps][32 keys] partial dots
  float* ps = sp + G * TILE_KEYS;         // [G][32] probabilities
  float* alpha_s = ps + G * TILE_KEYS;    // [G]
  float* ml_s = alpha_s + G;              // [G][2]: m, l
  int* ids = reinterpret_cast<int*>(smem + S::BASE);
  __shared__ int is_last;

  const int chunk = blockIdx.x, kvh = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv = kv_lens[row];
  const int hi = min(cdiv(kv, page), max_pages) - 1;
  int lo = 0;
  if (window > 0 && hi >= 0) lo = min(max(0, (kv - window) / page), hi);
  // The row's keys k_lo .. k_end - 1: from the 32-key slice of page lo that
  // holds the window's first key (page lo's first key at a page of 32 or
  // fewer) to the last valid key the table holds.
  const int k_end = hi < 0 ? 0 : min(kv, (hi + 1) * page);
  int k_lo = lo * page;
  if (window > 0) k_lo += max(0, kv - window - k_lo) / TILE_KEYS * TILE_KEYS;
  const int tk = tile_keys(page), ck = chunk_keys(page);
  const int n_chunks = k_end > k_lo ? cdiv(k_end - k_lo, ck) : 0;
  const size_t q_row = (size_t)row * hq + (size_t)kvh * group;
  T* out = o + q_row * D;
  const int outs = group * D;
  if (n_chunks == 0) {  // no key (kv_len 0): chunk 0 writes zeros
    if (chunk == 0)
      for (int i = tid; i < outs; i += THREADS) store_f32(out + i, 0.f);
    return;
  }
  if (chunk >= n_chunks) return;

  // This chunk's keys c_lo .. c_end - 1, on pages p0 .. p0 + n_ids - 1.
  const int c_lo = k_lo + chunk * ck, c_end = min(k_end, c_lo + ck);
  const int p0 = c_lo / page, n_ids = (c_end - 1) / page - p0 + 1;
  const int n_tiles = cdiv(c_end - c_lo, tk);
  const int* table = tables + (size_t)row * max_pages + p0;
  for (int i = tid; i < n_ids; i += THREADS) {
    const int pid = table[i];
    ids[i] = pid >= 0 && pid < n_pages ? pid : -1;
  }
  load_tiles<T, G, D, D, D, THREADS>(qs, q + q_row * D, nullptr, nullptr,
                                     D, group);
  __syncthreads();

  const size_t pool = (size_t)kvh * n_pages * page * D;
  auto load = [&](int ti) {  // tile ti's K and V rows into its ring slot
    T* kt = ring + (ti % STAGES) * 2 * S::TILE;
    T* vt = kt + S::TILE;
    constexpr int VPR = D / V;
    for (int i = tid; i < tk * VPR; i += THREADS) {
      const int j = i / VPR, c = (i % VPR) * V, kpos = c_lo + ti * tk + j;
      const int pid = kpos < c_end ? ids[kpos / page - p0] : -1;
      const size_t src =
          pool + ((size_t)max(pid, 0) * page + kpos % page) * D + c;
      tc::cp_async16(kt + j * LD + c, k_pages + src, pid >= 0);
      tc::cp_async16(vt + j * LD + c, v_pages + src, pid >= 0);
    }
  };

  // Scores: warp w < group * tpp takes q head w / tpp and every tpp-th
  // 16-byte vector of D from w % tpp; its lane j takes key j. (G = 16 takes
  // groups over 8 only: one warp a q head.)
  const int tpp = group == 1 ? 8 : group == 2 ? 4 : group <= 4 ? 2 : 1;
  float m_run = REPRO_NEG_INF, l_run = 0.f;  // warp h < group: q head h
  float acc[OUTS];
#pragma unroll
  for (int i = 0; i < OUTS; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load(s);
    tc::cp_async_commit();
  }
  for (int ti = 0; ti < n_tiles; ++ti) {
    tc::cp_async_wait<STAGES - 2>();  // tile ti has landed
    __syncthreads();                  // and tile ti - 1's slot is consumed
    if (ti + STAGES - 1 < n_tiles) load(ti + STAGES - 1);
    tc::cp_async_commit();
    const T* kt = ring + (ti % STAGES) * 2 * S::TILE;
    const T* vt = kt + S::TILE;

    if (warp < group * tpp && lane < tk) {
      const float* qh = qs + (warp / tpp) * D;
      const T* kr = kt + lane * LD;
      float dot = 0.f;
      for (int v = warp % tpp; v < D / V; v += tpp) {
        float f[V];
        Vec16<T>::unpack(*reinterpret_cast<const uint4*>(kr + v * V), f);
#pragma unroll
        for (int e = 0; e < V; ++e) dot = fmaf(qh[v * V + e], f[e], dot);
      }
      sp[warp * TILE_KEYS + lane] = dot;
    }
    __syncthreads();

    if (warp < group) {  // online softmax of q head `warp`, key `lane`
      const int kpos = c_lo + ti * tk + lane;
      bool valid = lane < tk && kpos < c_end && ids[kpos / page - p0] >= 0;
      if (window > 0) valid = valid && kpos > kv - 1 - window;
      float s = REPRO_NEG_INF;
      if (valid) {
        float dot = 0.f;
        for (int sub = 0; sub < tpp; ++sub)
          dot += sp[(warp * tpp + sub) * TILE_KEYS + lane];
        s = dot * scale;
      }
      const float m_new = fmaxf(m_run, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      // no valid key yet (a 32-key slice of a page over 32 keys can lie
      // wholly before the window): nothing to rescale
      const float alpha = m_new == REPRO_NEG_INF ? 1.f : expf(m_run - m_new);
      l_run = alpha * l_run + warp_sum(p);
      m_run = m_new;
      ps[warp * TILE_KEYS + lane] = p;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < OUTS; ++i) {
      const int oi = tid + i * THREADS, h = oi / D, d = oi % D;
      if (oi >= outs) break;
      const float* ph = ps + h * TILE_KEYS;
      float a = acc[i] * alpha_s[h];
      for (int j = 0; j < tk; ++j) a = fmaf(ph[j], load_f32(vt + j * LD + d), a);
      acc[i] = a;
    }
  }
  tc::cp_async_wait<0>();
  if (warp < group && lane == 0) {
    ml_s[2 * warp] = m_run;
    ml_s[2 * warp + 1] = l_run;
  }
  __syncthreads();

  if (n_chunks == 1) {  // acc / l; a row that saw no valid key writes zeros
#pragma unroll
    for (int i = 0; i < OUTS; ++i) {
      const int oi = tid + i * THREADS;
      if (oi >= outs) break;
      const float l = ml_s[2 * (oi / D) + 1];
      store_f32(out + oi, l > 0.f ? acc[i] / l : 0.f);
    }
    return;
  }

  // This chunk's partial state, then the row's last CTA merges them all.
  const size_t part = q_row * max_chunks;  // (q head row, chunk) slots
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    const int oi = tid + i * THREADS, h = oi / D, d = oi % D;
    if (oi >= outs) break;
    ws_acc[((part + (size_t)h * max_chunks) + chunk) * D + d] = acc[i];
  }
  if (tid < group) {
    ws_ml[(part + (size_t)tid * max_chunks + chunk) * 2] = ml_s[2 * tid];
    ws_ml[(part + (size_t)tid * max_chunks + chunk) * 2 + 1] = ml_s[2 * tid + 1];
  }
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)row * gridDim.y + kvh;
  // atomicInc stores 0 where the count reaches n_chunks - 1: the last CTA.
  if (tid == 0)
    is_last = atomicInc(reinterpret_cast<unsigned*>(counter), n_chunks - 1) == n_chunks - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    const int oi = tid + i * THREADS, h = oi / D, d = oi % D;
    if (oi >= outs) break;
    const size_t base = part + (size_t)h * max_chunks;
    float mx = REPRO_NEG_INF;
    for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, __ldcg(ws_ml + (base + c) * 2));
    float l = 0.f, a = 0.f;
    for (int c = 0; c < n_chunks; ++c) {  // in chunk order
      const float w = expf(__ldcg(ws_ml + (base + c) * 2) - mx);
      l = fmaf(w, __ldcg(ws_ml + (base + c) * 2 + 1), l);
      a = fmaf(w, __ldcg(ws_acc + (base + c) * D + d), a);
    }
    store_f32(out + oi, l > 0.f ? a / l : 0.f);
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* kv_lens, void* o, float* ws_acc, float* ws_ml,
           int* counters, int rows, int hq, int hkv, int n_pages, int page,
           int max_pages, int max_chunks, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = Smem<T, D, G>::bytes(page);
  auto kernel = paged_kernel<T, D, G>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(max_chunks, hkv, rows);
  kernel<<<grid, threads(G), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, kv_lens, static_cast<T*>(o), ws_acc,
      ws_ml, counters, hq, hq / hkv, n_pages, page, max_pages, max_chunks,
      window, scale);
  return launch_status();
}

template <typename T, int G>
int launch_d(int d, const void* q, const void* kp, const void* vp,
             const int* tables, const int* kv_lens, void* o, float* ws_acc,
             float* ws_ml, int* counters, int rows, int hq, int hkv,
             int n_pages, int page, int max_pages, int max_chunks, int window,
             float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16, G>(q, kp, vp, tables, kv_lens, o, ws_acc, ws_ml,
                           counters, rows, hq, hkv, n_pages, page, max_pages,
                           max_chunks, window, scale, stream);
    case 32:
      return launch<T, 32, G>(q, kp, vp, tables, kv_lens, o, ws_acc, ws_ml,
                           counters, rows, hq, hkv, n_pages, page, max_pages,
                           max_chunks, window, scale, stream);
    case 64:
      return launch<T, 64, G>(q, kp, vp, tables, kv_lens, o, ws_acc, ws_ml,
                           counters, rows, hq, hkv, n_pages, page, max_pages,
                           max_chunks, window, scale, stream);
    case 128:
      return launch<T, 128, G>(q, kp, vp, tables, kv_lens, o, ws_acc, ws_ml,
                            counters, rows, hq, hkv, n_pages, page, max_pages,
                            max_chunks, window, scale, stream);
    default:
      return REPRO_BAD_ARGUMENT;
  }
}

}  // namespace

// q (rows * hq, d); k_pages, v_pages (hkv, n_pages, page, d); tables
// (rows, max_pages) int32; kv_lens (rows,) int32; o like q. Workspace:
// ws_acc (rows * hq, max_chunks, d) and ws_ml (rows * hq, max_chunks, 2)
// float32, counters (rows * hkv) int32, zero (and left zero).
// max_chunks must be cdiv(max_pages * page, chunk keys). window <= 0: no
// sliding window.
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const int* tables,
                               const int* kv_lens, void* o, float* ws_acc,
                               float* ws_ml, int* counters, int dtype, int d,
                               int rows, int hq, int hkv, int n_pages,
                               int page, int max_pages, int max_chunks,
                               float scale, int window, void* stream) {
  if (rows <= 0 || rows > 65535 || hkv <= 0 || hkv > 65535 || hq % hkv ||
      hq / hkv > MAX_GROUP || page <= 0 || n_pages <= 0 || max_pages <= 0 ||
      (long long)max_pages * page > (1 << 30) ||
      max_chunks != cdiv(max_pages * page, chunk_keys(page)) ||
      !ws_acc || !ws_ml || !counters)
    return REPRO_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = hq / hkv > 8;  // the 16-warp kernel
  if (dtype == REPRO_F32)
    return (wide ? launch_d<float, 16> : launch_d<float, 8>)(
        d, q, k_pages, v_pages, tables, kv_lens, o, ws_acc, ws_ml, counters,
        rows, hq, hkv, n_pages, page, max_pages, max_chunks, window, scale, s);
  if (dtype == REPRO_BF16)
    return (wide ? launch_d<__nv_bfloat16, 16> : launch_d<__nv_bfloat16, 8>)(
        d, q, k_pages, v_pages, tables, kv_lens, o, ws_acc, ws_ml, counters,
        rows, hq, hkv, n_pages, page, max_pages, max_chunks, window, scale, s);
  return REPRO_BAD_ARGUMENT;
}
