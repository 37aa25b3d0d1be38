// Times the cluster walks of csrc/gemm_cluster.cuh on the card over cluster
// sizes C in {1, 2, 4, 8, 16} at the three timed shapes: B4's WS and IS
// walks at the paper's layer (56,3,1,128) (M=2916 K=1152 N=128) and B5a at
// M=512 K=6144 N=2048. Variants at each size:
// - "multicast": the library's TMA kernel, each CTA fetching 1/C of the
//   resident operand (B5a: of each weight chunk) and multicasting it into
//   every CTA of the cluster;
// - "copies": the same walk with per-CTA copies (each CTA fetches all of it
//   itself, the L2 serving the repeats; B5a's CTAs then share nothing), the
//   kernels below;
// - "exchange": the library's kernel for rows that are not whole 16-byte
//   vectors, each CTA's share exchanged over distributed shared memory after
//   a cluster barrier (B4: cp.async copies; B5a: element loads).
// The one-CTA walks of gemm_common.cuh that they replace are timed beside
// them (B4's; B5a's kernel is private to matmul_ws_stripe.cu). Every variant
// must give B1's bits (the prefill tile of gemm_tc.cuh on the same inputs).
// One JSON line per variant. Build and run from the repo root:
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//     -o cluster_sweep src/repro_torch/bench/cluster_sweep.cu && ./cluster_sweep
//
// Times are CUDA-event medians of 15 launches, each after a 256 MiB write
// that empties the 50 MB L2, so the operands come from device memory.
#include <algorithm>
#include <cstdio>
#include <cstring>
#include <vector>

#include "../kernels/csrc/gemm_cluster.cuh"
#include "../kernels/csrc/gemm_tc.cuh"

using namespace gemm;

namespace {

template <class F>
float median_ms(F launch, void* flush, size_t flush_bytes) {
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  for (int i = 0; i < 2; ++i) launch();
  std::vector<float> ms;
  for (int i = 0; i < 15; ++i) {
    cudaMemsetAsync(flush, i, flush_bytes);
    cudaEventRecord(start);
    launch();
    cudaEventRecord(end);
    cudaEventSynchronize(end);
    float t;
    cudaEventElapsedTime(&t, start, end);
    ms.push_back(t);
  }
  std::sort(ms.begin(), ms.end());
  return ms[ms.size() / 2];
}

std::vector<uint16_t> random_bf16(size_t count, uint32_t seed, float scale) {
  std::vector<uint16_t> out(count);
  uint32_t x = seed;
  for (auto& v : out) {
    x = x * 1664525u + 1013904223u;
    const float f = ((x >> 8) * (1.f / 16777216.f) * 2.f - 1.f) * scale;
    uint32_t bits;
    memcpy(&bits, &f, 4);
    v = (uint16_t)(bits >> 16);
  }
  return out;
}

struct Shape {
  const char* walk;
  int m, k, n;
};

// What a 32-deep k step of the cluster walks costs apart from its loads:
// `steps` steps of cl::step on one A and one B slot held in shared memory
// (a __syncthreads after each when SYNC), 8 warps a CTA, as in the walks.
// MODE 1: random bf16 operands instead of ones and zeros; 2: also an
// mbarrier arrival a warp a step, as the walks make.
template <bool SYNC, int MODE = 0>
__global__ void __launch_bounds__(THREADS) step_only(float* out, int steps) {
  __shared__ __align__(128) unsigned char slots[2 * cl::SLOT];
  __shared__ uint64_t bar;
  for (int i = threadIdx.x; i < 2 * cl::SLOT / 4; i += THREADS) {
    uint32_t x = (uint32_t)i * 2654435761u + 12345u;
    x ^= x >> 13;
    reinterpret_cast<uint32_t*>(slots)[i] =
        MODE ? ((x & 0x807f807fu) | 0x3c003c00u) : 0x3f803f80u * (i & 1);
  }
  if (threadIdx.x == 0) cl::mbar_init(&bar, (1 << 20) - 1);
  __syncthreads();
  float acc[TM][TN];
  cl::zero(acc);
  for (int s = 0; s < steps; ++s) {
    cl::step(acc, tc::smem_addr(slots), BM, tc::smem_addr(slots) + cl::SLOT);
    if (MODE == 2) {
      __syncwarp();
      if (tc::lane() == 0) cl::mbar_arrive(&bar);
    }
    if (SYNC) __syncthreads();
  }
  float x = 0.f;
  for (int i = 0; i < TM; ++i)
    for (int j = 0; j < TN; ++j) x += acc[i][j];
  out[blockIdx.x * THREADS + threadIdx.x] = x;
}

// ... and its loads apart from its products: the WS walk's A stream (64 x 32
// slots of a (m, k) A, 15 steps ahead in a 16-slot ring, a __syncthreads a
// step), one CTA a column of row tiles.
__global__ void __launch_bounds__(THREADS)
loads_only(const __nv_bfloat16* a, int m, int k, int tiles, float* out) {
  extern __shared__ __align__(128) unsigned char ring[];
  const int ks = k / BK, total = tiles * ks, d = cl::RING - 1;
  auto load = [&](int x) {
    cl::load_slot<true, 32>(ring + (x % cl::RING) * cl::SLOT, a, k, m, k,
                            ((blockIdx.x * tiles + x / ks) * BM) % m,
                            (x % ks) * BK, BM);
  };
  for (int x = 0; x < d; ++x) {
    if (x < total) load(x);
    tc::cp_async_commit();
  }
  float sum = 0.f;
  for (int x = 0; x < total; ++x) {
    tc::cp_async_wait<cl::RING - 2>();
    __syncthreads();
    if (x + d < total) load(x + d);
    tc::cp_async_commit();
    sum += reinterpret_cast<const float*>(ring + (x % cl::RING) * cl::SLOT)[threadIdx.x];
  }
  out[blockIdx.x * THREADS + threadIdx.x] = sum;
}

// The TMA's rate into one SM: `boxes` boxes of box_rows x box_cols of a
// (m, k) bf16 matrix streamed through an 8-slot ring (one thread issuing,
// every thread waiting on the slot's mbarrier, a __syncthreads a box).
__global__ void __launch_bounds__(THREADS)
tma_stream(const __grid_constant__ CUtensorMap map, int box_rows, int box_cols,
           int m, int k, int boxes, float* out) {
  extern __shared__ __align__(1024) unsigned char ring[];
  const int bytes = box_rows * box_cols * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 8 * bytes);
  const int per_row = k / box_cols, rows = m / box_rows;
  auto issue = [&](int i) {
    const int at = blockIdx.x * 7 + i;
    cl::mbar_expect(&full[i % 8], bytes);
    cl::tma_load(ring + (i % 8) * bytes, map, (at % per_row) * box_cols,
                 ((at / per_row) % rows) * box_rows, &full[i % 8]);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 8; ++i) cl::mbar_init(&full[i], 1);
    cl::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < 7 && i < boxes; ++i) issue(i);
  float sum = 0.f;
  for (int i = 0; i < boxes; ++i) {
    cl::mbar_wait(&full[i % 8], (i / 8) & 1);
    sum += reinterpret_cast<const float*>(ring + (i % 8) * bytes)[threadIdx.x];
    __syncthreads();
    if (threadIdx.x == 0 && i + 7 < boxes) issue(i + 7);
  }
  out[blockIdx.x * THREADS + threadIdx.x] = sum;
}

// B4's TMA walk (cl::walk_tma_kernel) with per-CTA copies: every CTA of
// the cluster fetches the whole resident stripe itself. The two timed walks
// only: WS (B's column stripe resident, A streamed) and IS (A's row stripe
// resident, B streamed).
template <int WALK>
__global__ void __launch_bounds__(cl::TMA_THREADS)
walk_copies_kernel(void* c, int m, int n, int k, Epi e, int ring,
                   const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b) {
  constexpr bool WS = WALK == WALK_M;
  constexpr int SLOT = cl::SLOT;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = tc::smem_addr(smem);
  const int C = cl::ctas_in_cluster(), rank = cl::rank_in_cluster();
  const int anchor = blockIdx.x / C, ks = round_up(k, BK) / BK;
  const int g = WS ? cdiv(m, BM) : cdiv(n, BN);
  unsigned char* rbase = smem + (size_t)ks * SLOT;
  uint64_t* held_bar = reinterpret_cast<uint64_t*>(rbase + (size_t)ring * SLOT);
  uint64_t* full = held_bar + 1;
  uint64_t* spent = full + ring;
  const int nt = rank < g ? cdiv(g - rank, C) : 0;
  const int depth = ring >= 4 ? 2 : 1, boxes = ring / depth;
  const int kd = cdiv(ks, depth), total = nt * kd;
  if (threadIdx.x == 0) {
    cl::mbar_init(held_bar, 1);
    for (int i = 0; i < boxes; ++i) {
      cl::mbar_init(&full[i], 1);
      cl::mbar_init(&spent[i], THREADS / 32);
    }
    cl::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == THREADS) {  // the producer
    cl::mbar_expect(held_bar, (uint32_t)ks * SLOT);
    for (int s = 0; s < ks; ++s)
      cl::tma_load(smem + (size_t)s * SLOT, WS ? map_b : map_a, WS ? anchor * BN : s * BK,
                   WS ? s * BK : anchor * BM, held_bar);
    for (int y = 0; y < total; ++y) {
      const int ys = y % boxes, t = rank + (y / kd) * C, s = (y % kd) * depth;
      if (y >= boxes) cl::mbar_wait(&spent[ys], (y / boxes - 1) & 1);
      cl::mbar_expect(&full[ys], depth * SLOT);
      unsigned char* dst = rbase + (size_t)ys * depth * SLOT;
      if (WS) cl::tma_load(dst, map_a, s * BK, t * BM, &full[ys]);
      else cl::tma_load(dst, map_b, t * BN, s * BK, &full[ys]);
    }
  } else if (threadIdx.x < THREADS) {
    cl::mbar_wait(held_bar, 0);
    int slot = 0, phase = 0;
    for (int t = rank; t < g; t += C) {
      const int tr = WS ? t * BM : anchor * BM, tcol = WS ? anchor * BN : t * BN;
      float acc[TM][TN];
      cl::zero(acc);
      for (int sd = 0; sd < kd; ++sd) {
        cl::mbar_wait(&full[slot], phase);
        const unsigned char* box = rbase + (size_t)slot * depth * SLOT;
        for (int h = 0; h < depth && sd * depth + h < ks; ++h) {
          const unsigned char* held = smem + (size_t)(sd * depth + h) * SLOT;
          const unsigned char* as = WS ? box : held;
          const unsigned char* bs = WS ? held : box + h * SLOT;
          if (tr + wrow() < m)
            cl::step(acc, sbase + (uint32_t)(as - smem), BM, sbase + (uint32_t)(bs - smem),
                     WS && depth == 2 ? h * BK : -1);
        }
        __syncwarp();
        if (tc::lane() == 0) cl::mbar_arrive(&spent[slot]);
        if (++slot == boxes) slot = 0, phase ^= 1;
      }
      store_tile<true>(c, acc, tr, tcol, m, n, e);
    }
  }
}

// B5a's TMA kernel (cl::ws_stripe_cluster_kernel<true>) with per-CTA
// copies: every CTA fetches each whole weight chunk itself (one box of
// STRIPE_KC k steps) and refills a chunk's slot once its own warps are done
// with it, so the CTAs of a cluster share nothing. Three CTAs an SM, as the
// library's kernel.
__global__ void __launch_bounds__(cl::TMA_THREADS, 3)
ws_stripe_copies_kernel(void* c, int m, int n, int k, Epi e,
                        const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b) {
  constexpr int KC = cl::STRIPE_KC, S = cl::STRIPE_SLOTS, SLOT = cl::SLOT;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = tc::smem_addr(smem);
  const int C = cl::ctas_in_cluster(), rank = cl::rank_in_cluster();
  const int col0 = (blockIdx.x / C) * BN;
  const int ks = round_up(k, BK) / BK, gm = cdiv(m, BM), chunks = cdiv(ks, KC);
  const int nt = rank < gm ? cdiv(gm - rank, C) : 0;
  const size_t chunk_bytes = (size_t)KC * SLOT * (1 + cdiv(gm, C));
  auto bpart = [&](int ch) { return smem + (ch % S) * chunk_bytes; };
  auto apart = [&](int ch, int u, int s) {
    return bpart(ch) + (size_t)KC * SLOT * (1 + u) + s * SLOT;
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * chunk_bytes);
  uint64_t* spent = full + S;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      cl::mbar_init(&full[i], 1);
      cl::mbar_init(&spent[i], THREADS / 32);
    }
    cl::mbar_init_fence();
  }
  __syncthreads();
  float acc[cl::STRIPE_TILES][TM][TN];
#pragma unroll
  for (int u = 0; u < cl::STRIPE_TILES; ++u) cl::zero(acc[u]);
  if (threadIdx.x == THREADS) {
    for (int ch = 0; ch < chunks; ++ch) {
      const int sl = ch % S;
      if (ch >= S) cl::mbar_wait(&spent[sl], (ch / S - 1) & 1);
      cl::mbar_expect(&full[sl], (uint32_t)(KC * SLOT * (1 + nt)));
      cl::tma_load(bpart(ch), map_b, col0, ch * KC * BK, &full[sl]);
      for (int u = 0; u < nt; ++u)
        for (int s = 0; s < KC; ++s)
          cl::tma_load(apart(ch, u, s), map_a, (ch * KC + s) * BK, (rank + u * C) * BM,
                       &full[sl]);
    }
  } else if (threadIdx.x < THREADS) {
    for (int ch = 0; ch < chunks; ++ch) {
      cl::mbar_wait(&full[ch % S], (ch / S) & 1);
      for (int s = 0; s < min(KC, ks - ch * KC); ++s)
#pragma unroll
        for (int u = 0; u < cl::STRIPE_TILES; ++u)
          if (u < nt && (rank + u * C) * BM + wrow() < m)
            cl::step(acc[u], sbase + (uint32_t)(apart(ch, u, s) - smem), BM,
                     sbase + (uint32_t)(bpart(ch) + s * SLOT - smem));
      __syncwarp();
      if (tc::lane() == 0) cl::mbar_arrive(&spent[ch % S]);
    }
#pragma unroll
    for (int u = 0; u < cl::STRIPE_TILES; ++u)
      if (u < nt) store_tile<true>(c, acc[u], (rank + u * C) * BM, col0, m, n, e);
  }
}

}  // namespace

int main(int argc, char** argv) {
  // `quick`: the library's launches only.
  const bool quick = argc > 1 && !strcmp(argv[1], "quick");
  const size_t flush_bytes = 256u << 20;
  void* flush;
  cudaMalloc(&flush, flush_bytes);
  const Epi e{nullptr, SCALE_NONE, nullptr, ACT_NONE, nullptr, REPRO_F32};
  if (!quick) {  // the k step's parts, 36 steps a tile as at K = 1152
    float* out;
    cudaMalloc(&out, 1024 * THREADS * 4);
    for (int ctas : {32, 132}) {
      for (int steps : {36, 360}) {
        const float ms_sync = median_ms([&] { step_only<true><<<ctas, THREADS>>>(out, steps); }, flush, flush_bytes);
        const float ms_free = median_ms([&] { step_only<false><<<ctas, THREADS>>>(out, steps); }, flush, flush_bytes);
        printf("{\"bench\": \"cluster_step_parts\", \"part\": \"products\", \"ctas\": %d, "
               "\"steps\": %d, \"ms_with_syncthreads\": %.5f, \"ms_without\": %.5f}\n",
               ctas, steps, ms_sync, ms_free);
      }
    }
    // ... with random operands, and with an mbarrier arrival a step
    for (int mode : {1, 2}) {
      for (int steps : {36, 360}) {
        const float ms = median_ms([&] {
          if (mode == 1) step_only<false, 1><<<32, THREADS>>>(out, steps);
          else step_only<false, 2><<<32, THREADS>>>(out, steps);
        }, flush, flush_bytes);
        printf("{\"bench\": \"cluster_step_parts\", \"part\": \"products %s\", "
               "\"ctas\": 32, \"steps\": %d, \"ms_without\": %.5f}\n",
               mode == 1 ? "random operands" : "random operands, mbarrier arrivals",
               steps, ms);
      }
    }
    // ... and launched in clusters, as the walks are
    for (int cluster : {1, 2, 16}) {
      for (int steps : {36, 360}) {
        const float ms = median_ms([&] {
          cl::launch_in_clusters(step_only<false>, 32, THREADS, cluster, 0, 0, out, steps);
        }, flush, flush_bytes);
        printf("{\"bench\": \"cluster_step_parts\", \"part\": \"products in clusters\", "
               "\"cluster\": %d, \"ctas\": 32, \"steps\": %d, \"ms_without\": %.5f}\n",
               cluster, steps, ms);
      }
    }
    __nv_bfloat16* a;
    const int m = 2944, k = 1152;
    cudaMalloc(&a, (size_t)m * k * 2);
    cudaMemset(a, 0, (size_t)m * k * 2);
    cudaFuncSetAttribute(loads_only, cudaFuncAttributeMaxDynamicSharedMemorySize, cl::RING * cl::SLOT);
    for (int ctas : {32, 132}) {
      for (int tiles : {1, 3}) {
        const float ms = median_ms([&] { loads_only<<<ctas, THREADS, cl::RING * cl::SLOT>>>(a, m, k, tiles, out); }, flush, flush_bytes);
        printf("{\"bench\": \"cluster_step_parts\", \"part\": \"loads\", \"ctas\": %d, "
               "\"steps\": %d, \"ms\": %.5f, \"error\": \"%s\"}\n",
               ctas, tiles * k / BK, ms, cudaGetErrorString(cudaGetLastError()));
      }
    }
    // The TMA's rate into one SM by box size.
    for (auto box : {std::make_pair(64, 32), std::make_pair(32, 64), std::make_pair(64, 64),
                     std::make_pair(128, 64), std::make_pair(256, 64)}) {
      CUtensorMap map;
      const int rc = cl::make_map(&map, a, m, k, k, box.first, box.second,
                                  box.second == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_128B);
      const int bytes = box.first * box.second * 2;
      const size_t smem = 8 * (size_t)bytes + 128;
      cudaFuncSetAttribute(tma_stream, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      for (int ctas : {32, 132}) {
        const int boxes = (1 << 20) * 4 / bytes;  // 4 MiB a CTA
        const float ms = median_ms([&] { tma_stream<<<ctas, THREADS, smem>>>(map, box.first, box.second, m, k, boxes, out); },
                                   flush, flush_bytes);
        printf("{\"bench\": \"cluster_step_parts\", \"part\": \"tma box rate\", \"box\": [%d, %d], "
               "\"ctas\": %d, \"ms\": %.5f, \"gb_per_s_an_sm\": %.2f, \"error\": \"%s %d\"}\n",
               box.first, box.second, ctas, ms, 4.0 * (1 << 20) / (ms * 1e-3) / 1e9,
               cudaGetErrorString(cudaGetLastError()), rc);
      }
    }
    fflush(stdout);
    cudaFree(a);
    cudaFree(out);
  }
  const Shape shapes[] = {{"ws_basic", 2916, 1152, 128},
                          {"is_basic", 2916, 1152, 128},
                          {"ws_o_stripe", 512, 6144, 2048}};
  for (const Shape& sh : shapes) {
    const int m = sh.m, k = sh.k, n = sh.n;
    __nv_bfloat16 *a, *b;
    float *c, *want;
    cudaMalloc(&a, (size_t)m * k * 2);
    cudaMalloc(&b, (size_t)k * n * 2);
    cudaMalloc(&c, (size_t)m * n * 4);
    cudaMalloc(&want, (size_t)m * n * 4);
    const auto ha = random_bf16((size_t)m * k, 1u, 1.f);
    const auto hb = random_bf16((size_t)k * n, 2u, 1.f / 32.f);
    cudaMemcpy(a, ha.data(), ha.size() * 2, cudaMemcpyHostToDevice);
    cudaMemcpy(b, hb.data(), hb.size() * 2, cudaMemcpyHostToDevice);
    launch_tc(a, b, want, m, n, k, e, 0, nullptr);
    std::vector<float> x((size_t)m * n), y((size_t)m * n);
    cudaMemcpy(y.data(), want, y.size() * 4, cudaMemcpyDeviceToHost);
    auto report = [&](const char* variant, int cluster, int rc, float ms,
                      const Took& took) {
      size_t bad = 0;
      if (rc == 0) {
        cudaMemcpy(x.data(), c, x.size() * 4, cudaMemcpyDeviceToHost);
        for (size_t i = 0; i < x.size(); ++i) bad += x[i] != y[i];
      }
      printf("{\"bench\": \"cluster_sweep\", \"walk\": \"%s\", \"m\": %d, "
             "\"k\": %d, \"n\": %d, \"variant\": \"%s\", \"cluster\": %d, "
             "\"ms\": %.5f, \"ctas\": %d, \"smem_bytes\": %d, "
             "\"elements_differing\": %zu, \"error\": \"%s\"}\n",
             sh.walk, m, k, n, variant, cluster, rc == 0 ? ms : -1.f,
             took.ctas, took.smem, bad,
             rc == 0 ? "no error"
             : rc >= REPRO_BAD_ARGUMENT ? "refused"
                                        : cudaGetErrorString((cudaError_t)rc));
      fflush(stdout);
    };
    const bool ws = sh.walk[0] == 'w' && sh.walk[3] == 'b';
    const bool is = sh.walk[0] == 'i';
    if ((ws || is) && !quick) {  // the one-CTA walk the cluster walk replaces
      auto walk = [&] {
        return ws ? launch_walk<__nv_bfloat16, 0, WALK_M, false, B_STRIPE>(
                        a, b, nullptr, c, m, n, k, e, 0)
                  : launch_walk<__nv_bfloat16, 0, WALK_N, true, B_STREAMED>(
                        a, b, nullptr, c, m, n, k, e, 0);
      };
      cudaMemset(c, 0, (size_t)m * n * 4);
      const int rc = walk();
      const float ms = rc == 0 ? median_ms(walk, flush, flush_bytes) : 0.f;
      Took took{};
      took.ctas = ws ? cdiv(n, BN) : cdiv(m, BM);
      report("one_cta_walk", 1, rc, ms, took);
    }
    // B5a at cluster size C: the library's TMA kernel (multicast), the
    // sweep's per-CTA copies, or the library's element-load exchange. A CTA
    // keeps at most STRIPE_TILES row tiles; the multicast box of 64 / C
    // weight rows must be whole 1024-byte swizzle rows.
    auto b5a = [&](bool mc, bool copies, int C, Took& took) {
      const int gn = cdiv(n, BN);
      const size_t smem = cl::stripe_smem(cdiv(m, BM), C);
      took = {TILE_CLUSTER, (int)smem, gn * C, C};
      if (cdiv(cdiv(m, BM), C) > cl::STRIPE_TILES || (mc && C > 8)) return (int)REPRO_BAD_ARGUMENT;
      CUtensorMap ma{}, mb{};
      if (!mc && !copies)
        return cl::launch_in_clusters(cl::ws_stripe_cluster_kernel<false>, gn * C, THREADS, C, smem,
                                      0, a, b, c, m, n, k, e, ma, mb);
      const int rc = cl::make_maps(&ma, &mb, a, b, m, n, k, cl::STRIPE_KC * BK / (mc ? C : 1), false);
      if (rc) return rc;
      if (mc)
        return cl::launch_in_clusters(cl::ws_stripe_cluster_kernel<true>, gn * C, cl::TMA_THREADS, C,
                                      smem, 0, a, b, c, m, n, k, e, ma, mb);
      return cl::launch_in_clusters(ws_stripe_copies_kernel, gn * C, cl::TMA_THREADS, C, smem, 0, c,
                                    m, n, k, e, ma, mb);
    };
    // The library's own launch (its cluster size), then every cluster size
    // of each variant.
    auto sweep = [&](const char* variant, auto run) {
      Took took{};
      cudaMemset(c, 0, (size_t)m * n * 4);
      int rc = run(took);
      if (rc == 0) rc = (int)cudaDeviceSynchronize();
      const float ms = rc == 0 ? median_ms([&] { run(took); }, flush, flush_bytes) : 0.f;
      // and with the operands left in the L2 by the launch before
      const float hot = rc == 0 ? median_ms([&] { run(took); }, flush, 0) : 0.f;
      report(variant, took.cluster, rc, ms, took);
      printf("{\"bench\": \"cluster_sweep_hot_l2\", \"walk\": \"%s\", \"variant\": \"%s\", "
             "\"cluster\": %d, \"ms\": %.5f}\n", sh.walk, variant, took.cluster, hot);
      cudaGetLastError();
    };
    sweep("library", [&](Took& took) {
      if (ws) return cl::launch_walk<WALK_M, false, B_STRIPE>(a, b, c, m, n, k, e, 0, &took, TILE_CLUSTER);
      if (is) return cl::launch_walk<WALK_N, true, B_STREAMED>(a, b, c, m, n, k, e, 0, &took, TILE_CLUSTER);
      return b5a(true, false, cl::ws_stripe_cluster(m, n), took);
    });
    for (int cluster : {1, 2, 4, 8, 16}) {
      if (quick) break;
      for (const char* variant : {"multicast", "copies", "exchange"}) {
        const bool mc = variant[0] == 'm', copies = variant[0] == 'c';
        sweep(variant, [&](Took& took) {
          const int C = cluster;
          if (ws || is) {  // B4: the smem and maps of cl::launch_walk
            const int anchors = ws ? cdiv(n, BN) : cdiv(m, BM);
            int ring = 0;
            const size_t smem = ws ? cl::walk_smem<WALK_M, false, B_STRIPE>(m, n, k, &ring)
                                   : cl::walk_smem<WALK_N, true, B_STREAMED>(m, n, k, &ring);
            took = {TILE_CLUSTER, (int)smem, anchors * C, C};
            if (!mc && !copies) {
              return ws ? cl::launch_in_clusters(cl::walk_cluster_kernel<true, WALK_M, false, B_STRIPE>,
                                                 anchors * C, THREADS, C, smem, 0, a, b, c, m, n, k, e, ring)
                        : cl::launch_in_clusters(cl::walk_cluster_kernel<true, WALK_N, true, B_STREAMED>,
                                                 anchors * C, THREADS, C, smem, 0, a, b, c, m, n, k, e, ring);
            }
            const int depth = ring >= 4 ? 2 : 1;
            CUtensorMap ma, mb;
            const int rc = cl::make_maps(&ma, &mb, a, b, m, n, k, ws ? BK : depth * BK, ws && depth == 2);
            if (rc) return rc;
            if (mc)
              return ws ? cl::launch_in_clusters(cl::walk_tma_kernel<WALK_M, false, B_STRIPE>, anchors * C,
                                                 cl::TMA_THREADS, C, smem, 0, c, m, n, k, e, ring, ma, mb)
                        : cl::launch_in_clusters(cl::walk_tma_kernel<WALK_N, true, B_STREAMED>, anchors * C,
                                                 cl::TMA_THREADS, C, smem, 0, c, m, n, k, e, ring, ma, mb);
            return ws ? cl::launch_in_clusters(walk_copies_kernel<WALK_M>, anchors * C, cl::TMA_THREADS, C,
                                               smem, 0, c, m, n, k, e, ring, ma, mb)
                      : cl::launch_in_clusters(walk_copies_kernel<WALK_N>, anchors * C, cl::TMA_THREADS, C,
                                               smem, 0, c, m, n, k, e, ring, ma, mb);
          }
          return b5a(mc, copies, C, took);
        });
      }
    }
    cudaFree(a);
    cudaFree(b);
    cudaFree(c);
    cudaFree(want);
  }
  return 0;
}
