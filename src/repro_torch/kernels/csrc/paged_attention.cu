// B3: paged decode attention (one query row per sequence, Sq == 1).
//
// Replaces the TPU kernel repro/kernels/attention_df.py `_paged_kernel`
// (built by `paged_flash_attention`), where the block table rode the
// scalar-prefetch index map. Here one CTA owns one (sequence row, kv head)
// and runs one warp per query head of the GQA group, so each K/V page is
// read from device memory once for the whole group. The CTA reads the row's
// valid length from `kv_lens` and walks its logical pages lo..hi (hi: the
// last valid page; lo: the first page the sliding window reaches, as at
// attention_df.py:602-608), reading each physical page id from the row's
// block table in device memory. A row with kv_len == 0 visits no page and
// writes zeros; a page id outside the pool is treated as fully masked.
//
// Bound on H100: bytes (every visited K/V page is read once; the arithmetic
// is 4*D flops per key). All 8 warps load each page as 16-byte vectors, in
// flight together; one page per iteration and no prefetch of the next, so a
// long row is still latency-bound.
#include "attention_common.cuh"

namespace {

constexpr int MAX_PAGE = 32;   // keys per page: one per lane
constexpr int MAX_GROUP = 8;   // q heads per kv head: one warp each
constexpr int THREADS = MAX_GROUP * 32;  // every warp loads; `group` compute

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
             const T* __restrict__ v_pages, const int* __restrict__ tables,
             const int* __restrict__ kv_lens, T* __restrict__ o, int hq,
             int group, int n_pages, int page, int max_pages, int window,
             float scale) {
  __shared__ float qs[MAX_GROUP][D];
  __shared__ float ks[MAX_PAGE][D + 1];
  __shared__ float vs[MAX_PAGE][D];
  const int kvh = blockIdx.x, row = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv_valid = kv_lens[row];
  const size_t pool = (size_t)kvh * n_pages * page * D;
  const size_t q_row = (size_t)row * hq + (size_t)kvh * group;

  load_tiles<T, MAX_GROUP, D, D, D, THREADS>(&qs[0][0], q + q_row * D,
                                             nullptr, nullptr, D, group);

  const int hi = min((kv_valid + page - 1) / page, max_pages) - 1;
  int lo = 0;
  if (window > 0 && hi >= 0) lo = min(max(0, (kv_valid - window) / page), hi);
  const int* table = tables + (size_t)row * max_pages;

  RowState<D> st;
  st.init();
  for (int blk = lo; blk <= hi; ++blk) {
    const int pid = table[blk];
    const bool pid_ok = pid >= 0 && pid < n_pages;
    __syncthreads();  // the previous page is consumed (and qs is loaded)
    const size_t base = pool + (size_t)(pid_ok ? pid : 0) * page * D;
    load_tiles<T, MAX_PAGE, D, D + 1, D, THREADS>(
        &ks[0][0], k_pages + base, &vs[0][0], v_pages + base, D,
        pid_ok ? page : 0);
    __syncthreads();
    if (warp < group) {  // warp-uniform
      const int kpos = blk * page + lane;
      bool valid = pid_ok && lane < page && kpos < kv_valid;
      if (window > 0) valid = valid && kpos > kv_valid - 1 - window;
      fold_tile<D>(qs[warp], &ks[0][0], &vs[0][0], pid_ok ? page : 0, valid,
                   scale, st);
    }
  }
  if (warp < group) write_row<T, D>(o + (q_row + warp) * D, st);
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* kv_lens, void* o, int rows, int hq, int hkv,
           int n_pages, int page, int max_pages, int window, float scale,
           cudaStream_t stream) {
  const dim3 grid(hkv, rows);
  paged_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, kv_lens, static_cast<T*>(o), hq,
      hq / hkv, n_pages, page, max_pages, window, scale);
  return launch_status();
}

template <typename T>
int launch_d(int d, const void* q, const void* kp, const void* vp,
             const int* tables, const int* kv_lens, void* o, int rows, int hq,
             int hkv, int n_pages, int page, int max_pages, int window,
             float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, kp, vp, tables, kv_lens, o, rows, hq, hkv,
                           n_pages, page, max_pages, window, scale, stream);
    case 64:
      return launch<T, 64>(q, kp, vp, tables, kv_lens, o, rows, hq, hkv,
                           n_pages, page, max_pages, window, scale, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, tables, kv_lens, o, rows, hq, hkv,
                            n_pages, page, max_pages, window, scale, stream);
    default:
      return REPRO_BAD_ARGUMENT;
  }
}

}  // namespace

// q (rows * hq, d); k_pages, v_pages (hkv, n_pages, page, d); tables
// (rows, max_pages) int32; kv_lens (rows,) int32; o like q.
// window <= 0: no sliding window.
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const int* tables,
                               const int* kv_lens, void* o, int dtype, int d,
                               int rows, int hq, int hkv, int n_pages,
                               int page, int max_pages, float scale,
                               int window, void* stream) {
  if (rows <= 0 || rows > 65535 || hkv <= 0 || hkv > 65535 || hq % hkv ||
      hq / hkv > MAX_GROUP || page <= 0 || page > MAX_PAGE || n_pages <= 0 ||
      max_pages <= 0)
    return REPRO_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return launch_d<float>(d, q, k_pages, v_pages, tables, kv_lens, o, rows,
                           hq, hkv, n_pages, page, max_pages, window, scale,
                           s);
  if (dtype == REPRO_BF16)
    return launch_d<__nv_bfloat16>(d, q, k_pages, v_pages, tables, kv_lens, o,
                                   rows, hq, hkv, n_pages, page, max_pages,
                                   window, scale, s);
  return REPRO_BAD_ARGUMENT;
}
