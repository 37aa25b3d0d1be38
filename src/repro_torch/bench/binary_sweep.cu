// Times variants of B9's binary tensor-core tiles (csrc/binary_mm.cu) on the
// card at the served shapes of qwen3-1.7b's binary MLP: up (M x 64 words ->
// 6144, scale + bias + sign -> int8) and down (M x 192 words -> 2048, scale +
// bias -> float32), prefill M = 511 and decode M = 4, against the tile the
// library uses: tile shapes, warp layouts, stage depths and steps in flight.
// Every variant must give the bits of the WS walk on the CUDA cores. One
// JSON line per (tile, shape). Before the tiles it reads the tensor cores'
// rates for mma.sync m16n8k256 .b1 (the AND form the tiles use, and the XOR
// form, which ptxas lowers to AND products on sm_90a) and for m16n8k32 .s8,
// each from a loop of independent products on every SM (2 M N K operations
// a product, K in bits for b1): the rate chip_smoke.py bounds B9 by.
// Build and run from the repo root:
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//     -o binary_sweep src/repro_torch/bench/binary_sweep.cu && ./binary_sweep
//
// Times are CUDA-event medians of 15 launches: "ms" each after a 256 MiB
// write that empties the 50 MB L2 (the operands come from device memory),
// "hot_ms" back to back (the operands in L2); "empty_ms" is an empty
// kernel's, timed the same way.
#include <algorithm>
#include <cstdio>
#include <cstring>
#include <vector>

#include "../kernels/csrc/binary_mm.cu"

using namespace bin;

namespace {

__global__ void empty_kernel() {}

// The XOR form of mma_common.cuh's mma_b1_and, for the rate probe alone.
__device__ __forceinline__ void mma_b1_xor(int c[4], const uint32_t a[4],
                                           const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

enum Product { B1_AND = 0, B1_XOR = 1, S8 = 2 };
constexpr int RATE_CHAINS = 8, RATE_ITERS = 2048, RATE_WARPS = 8;

// RATE_ITERS rounds of RATE_CHAINS independent products a warp on operands
// held in registers; the sums are stored so nothing is dropped.
template <int P>
__global__ void __launch_bounds__(RATE_WARPS * 32) rate_kernel(int* sink) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = 0x9e3779b9u * (threadIdx.x + 7 * i + 1);
  b[0] = 0x85ebca6bu * (threadIdx.x + 3);
  b[1] = 0xc2b2ae35u * (threadIdx.x + 5);
  int acc[RATE_CHAINS][4] = {};
  for (int it = 0; it < RATE_ITERS; ++it)
#pragma unroll
    for (int c = 0; c < RATE_CHAINS; ++c) {
      if constexpr (P == B1_AND) tc::mma_b1_and(acc[c], a, b);
      else if constexpr (P == B1_XOR) mma_b1_xor(acc[c], a, b);
      else tc::mma_s8(acc[c], a, b);
    }
  int s = 0;
#pragma unroll
  for (int c = 0; c < RATE_CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <class F>
float median_ms(F launch, void* flush, size_t flush_bytes) {
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  for (int i = 0; i < 2; ++i) launch();
  std::vector<float> ms;
  for (int i = 0; i < 15; ++i) {
    if (flush) cudaMemsetAsync(flush, i, flush_bytes);
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

// The rate of product P in operations a second, on 4 CTAs of RATE_WARPS
// warps an SM.
template <int P>
void rate(const char* name, int k) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int ctas = 4 * sms;
  int* sink;
  cudaMalloc(&sink, (size_t)ctas * RATE_WARPS * 32 * 4);
  const float ms = median_ms([&] { rate_kernel<P><<<ctas, RATE_WARPS * 32>>>(sink); },
                             nullptr, 0);
  const double ops = 2.0 * 16 * 8 * k * RATE_CHAINS * RATE_ITERS * ctas * RATE_WARPS;
  printf("{\"bench\": \"mma_rate\", \"product\": \"%s\", \"ctas\": %d, "
         "\"ms\": %.5f, \"tera_ops_per_s\": %.1f, \"error\": \"%s\"}\n",
         name, ctas, ms, ops / (ms * 1e-3) / 1e12, cudaGetErrorString(cudaGetLastError()));
  cudaFree(sink);
}

struct Bench {
  uint32_t *a, *b;
  float *scale, *bias;
  unsigned char *c, *want;
  void* flush;
  size_t flush_bytes = 256u << 20;

  Epi epi(int k_bits, bool up) const {
    return Epi{k_bits, scale, SCALE_COL, bias, nullptr, up ? 1 : 0,
               up ? REPRO_I8 : REPRO_F32};
  }

  size_t differing(size_t bytes) const {
    std::vector<unsigned char> x(bytes), y(bytes);
    cudaMemcpy(x.data(), c, bytes, cudaMemcpyDeviceToHost);
    cudaMemcpy(y.data(), want, bytes, cudaMemcpyDeviceToHost);
    size_t bad = 0;
    for (size_t i = 0; i < bytes; ++i) bad += x[i] != y[i];
    return bad;
  }

  // Runs `launch(out)` for the tile named `name` at the served shape
  // (m, up or down) after the WS walk wrote the reference bits.
  template <class L>
  void run(const char* name, size_t smem, int m, bool up, L launch) {
    const int kp = up ? 64 : 192, n = up ? 6144 : 2048;
    const Epi e = epi(32 * kp, up);
    launch_walk<WALK_M>(a, b, want, m, n, kp, e, 0);
    cudaMemset(c, 0xff, (size_t)m * n * 4);
    const float ms = median_ms([&] { launch(c, m, n, kp, e); }, flush, flush_bytes);
    const float hot = median_ms([&] { launch(c, m, n, kp, e); }, nullptr, 0);
    const cudaError_t err = cudaGetLastError();
    printf("{\"bench\": \"b9_tile_sweep\", \"tile\": \"%s\", \"shape\": \"%s\", "
           "\"m\": %d, \"kp\": %d, \"n\": %d, \"ms\": %.5f, \"hot_ms\": %.5f, "
           "\"smem_bytes\": %zu, \"bytes_differing\": %zu, \"error\": \"%s\"}\n",
           name, up ? "up" : "down", m, kp, n, ms, hot, smem,
           differing((size_t)m * n * (up ? 1 : 4)), cudaGetErrorString(err));
  }
};

template <class C>
void prefill(Bench& bench, const char* name) {
  for (bool up : {true, false})
    bench.run(name, C::SMEM, 511, up, [&](void* out, int m, int n, int kp, const Epi& e) {
      launch_prefill<C>(bench.a, bench.b, out, m, n, kp, e, 0);
    });
}

template <class C>
void decode(Bench& bench, const char* name) {
  for (bool up : {true, false})
    bench.run(name, C::SMEM, 4, up, [&](void* out, int m, int n, int kp, const Epi& e) {
      launch_decode<C>(bench.a, bench.b, out, m, n, kp, e, 0);
    });
}

}  // namespace

int main() {
  Bench bench;
  cudaMalloc(&bench.flush, bench.flush_bytes);
  const size_t a_words = (size_t)511 * 192, b_words = (size_t)192 * 6144;
  cudaMalloc(&bench.a, a_words * 4);
  cudaMalloc(&bench.b, b_words * 4);
  cudaMalloc(&bench.scale, 6144 * 4);
  cudaMalloc(&bench.bias, 6144 * 4);
  cudaMalloc(&bench.c, (size_t)511 * 6144 * 4);
  cudaMalloc(&bench.want, (size_t)511 * 6144 * 4);
  // Words, scales and biases from a multiplicative hash of the index.
  std::vector<uint32_t> words(b_words);
  for (size_t i = 0; i < b_words; ++i) words[i] = (uint32_t)(i * 2654435761u) ^ (uint32_t)(i >> 7);
  cudaMemcpy(bench.b, words.data(), b_words * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(bench.a, words.data() + 12345, a_words * 4, cudaMemcpyHostToDevice);
  std::vector<float> sc(6144), bi(6144);
  for (int i = 0; i < 6144; ++i) {
    sc[i] = 0.01f + 0.0001f * (float)(i % 97);
    bi[i] = 0.5f * (float)((int)(i * 7919 % 31) - 15);
  }
  cudaMemcpy(bench.scale, sc.data(), 6144 * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(bench.bias, bi.data(), 6144 * 4, cudaMemcpyHostToDevice);

  rate<B1_AND>("m16n8k256 .b1 .and.popc", 256);
  rate<B1_XOR>("m16n8k256 .b1 .xor.popc", 256);
  rate<S8>("m16n8k32 .s8", 32);
  printf("{\"bench\": \"b9_tile_sweep\", \"empty_ms\": %.5f, \"empty_hot_ms\": %.5f}\n",
         median_ms([] { empty_kernel<<<1, 32>>>(); }, bench.flush, bench.flush_bytes),
         median_ms([] { empty_kernel<<<1, 32>>>(); }, nullptr, 0));
  prefill<Prefill>(bench, "64x64, k32 words, 3 stages, 4x2 warps (library)");
  prefill<PrefillCfg<64, 64, 32, 3, 2, 2>>(bench, "64x64, k32, 3 stages, 2x2 warps");
  prefill<PrefillCfg<64, 64, 32, 3, 2, 4>>(bench, "64x64, k32, 3 stages, 2x4 warps");
  prefill<PrefillCfg<64, 64, 32, 3, 4, 4>>(bench, "64x64, k32, 3 stages, 4x4 warps");
  prefill<PrefillCfg<64, 64, 16, 4, 4, 2>>(bench, "64x64, k16, 4 stages, 4x2 warps");
  prefill<PrefillCfg<64, 64, 64, 2, 4, 2>>(bench, "64x64, k64, 2 stages, 4x2 warps");
  prefill<PrefillCfg<64, 64, 32, 4, 4, 2>>(bench, "64x64, k32, 4 stages, 4x2 warps");
  prefill<PrefillCfg<128, 32, 32, 3, 8, 1>>(bench, "128x32, k32, 3 stages, 8x1 warps");
  prefill<PrefillCfg<128, 32, 32, 3, 4, 2>>(bench, "128x32, k32, 3 stages, 4x2 warps");
  prefill<PrefillCfg<32, 128, 32, 3, 2, 4>>(bench, "32x128, k32, 3 stages, 2x4 warps");
  prefill<PrefillCfg<128, 128, 32, 3, 2, 4>>(bench, "128x128, k32, 3 stages, 2x4 warps");
  decode<Decode>(bench, "16 cols, 8 warps, 2 steps in flight (library)");
  decode<DecodeCfg<16, 8, 1>>(bench, "16 cols, 8 warps, 1 step");
  decode<DecodeCfg<16, 8, 4>>(bench, "16 cols, 8 warps, 4 steps");
  decode<DecodeCfg<8, 4, 1>>(bench, "8 cols, 4 warps, 1 step");
  decode<DecodeCfg<8, 4, 4>>(bench, "8 cols, 4 warps, 4 steps");
  decode<DecodeCfg<8, 8, 4>>(bench, "8 cols, 8 warps, 4 steps");
  decode<DecodeCfg<16, 16, 2>>(bench, "16 cols, 16 warps, 2 steps");
  decode<DecodeCfg<32, 16, 2>>(bench, "32 cols, 16 warps, 2 steps");
  return 0;
}
