// Times variants of B1's bf16 tensor-core tiles (csrc/gemm_tc.cuh) on the
// card at qwen3-1.7b's MLP shapes, each against the tile the library uses,
// and checks that every variant gives the library tile's bits. One JSON
// line per (tile, shape). Build and run from the repo root:
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//     -o tile_sweep src/repro_torch/bench/tile_sweep.cu && ./tile_sweep
//
// Times are CUDA-event medians of 15 launches, each after a 256 MiB write
// that empties the 50 MB L2, so the operands come from device memory.
#include <algorithm>
#include <cstdio>
#include <utility>
#include <vector>

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

struct Bench {
  __nv_bfloat16 *a, *b;
  float *c, *want;
  void* flush;
  size_t flush_bytes = 256u << 20;
  Epi e{nullptr, SCALE_NONE, nullptr, ACT_NONE, nullptr, REPRO_F32};

  size_t differing(int m, int n) const {
    std::vector<float> x((size_t)m * n), y((size_t)m * n);
    cudaMemcpy(x.data(), c, x.size() * 4, cudaMemcpyDeviceToHost);
    cudaMemcpy(y.data(), want, y.size() * 4, cudaMemcpyDeviceToHost);
    size_t bad = 0;
    for (size_t i = 0; i < x.size(); ++i) bad += x[i] != y[i];
    return bad;
  }

  // Runs `launch(out)` for the tile named `name` at (m, k, n) after the
  // library tile `base(out)` wrote the reference bits.
  template <class L, class B>
  void run(const char* name, size_t smem, int m, int k, int n, L launch,
           B base) {
    base(want);
    const float ms = median_ms([&] { launch(c); }, flush, flush_bytes);
    const cudaError_t err = cudaGetLastError();
    printf("{\"bench\": \"b1_tile_sweep\", \"tile\": \"%s\", \"m\": %d, "
           "\"k\": %d, \"n\": %d, \"ms\": %.5f, \"smem_bytes\": %zu, "
           "\"elements_differing\": %zu, \"error\": \"%s\"}\n",
           name, m, k, n, ms, smem, differing(m, n), cudaGetErrorString(err));
  }
};

template <class C>
void prefill(Bench& bench, const char* name) {
  for (auto kn : {std::pair<int, int>{6144, 2048}, {2048, 6144}}) {
    const int m = 512, k = kn.first, n = kn.second;
    bench.run(
        name, C::SMEM, m, k, n,
        [&](float* out) { launch_prefill<C>(bench.a, bench.b, out, m, n, k, bench.e, 0); },
        [&](float* out) {
          launch_prefill<Prefill>(bench.a, bench.b, out, m, n, k, bench.e, 0);
        });
  }
}

template <class C>
void decode(Bench& bench, const char* name) {
  for (auto kn : {std::pair<int, int>{6144, 2048}, {2048, 6144}}) {
    const int m = 4, k = kn.first, n = kn.second;
    bench.run(
        name, C::SMEM, m, k, n,
        [&](float* out) { launch_decode<C>(bench.a, bench.b, out, m, n, k, bench.e, 0); },
        [&](float* out) {
          launch_decode<Decode>(bench.a, bench.b, out, m, n, k, bench.e, 0);
        });
  }
}

}  // namespace

int main() {
  Bench bench;
  cudaMalloc(&bench.flush, bench.flush_bytes);
  const size_t elems = (size_t)6144 * 6144;
  cudaMalloc(&bench.a, (size_t)512 * 6144 * 2);
  cudaMalloc(&bench.b, elems * 2);
  cudaMalloc(&bench.c, (size_t)512 * 6144 * 4);
  cudaMalloc(&bench.want, (size_t)512 * 6144 * 4);
  // bf16 values in [2^-9, 2^-5), from a multiplicative hash of the index.
  std::vector<uint16_t> host(elems);
  for (size_t i = 0; i < elems; ++i)
    host[i] = 0x3b00 + (uint16_t)((i * 2654435761u >> 20) & 0x1ff);
  cudaMemcpy(bench.b, host.data(), elems * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(bench.a, host.data(), (size_t)512 * 6144 * 2, cudaMemcpyHostToDevice);

  prefill<Prefill>(bench, "128x64, k32, 4 stages, 4x2 warps (library)");
  prefill<PrefillCfg<128, 64, 64, 4, 4, 2>>(bench, "128x64, k64, 4 stages, 4x2 warps");
  prefill<PrefillCfg<128, 64, 64, 3, 4, 2>>(bench, "128x64, k64, 3 stages, 4x2 warps");
  prefill<PrefillCfg<128, 64, 32, 8, 4, 2>>(bench, "128x64, k32, 8 stages, 4x2 warps");
  prefill<PrefillCfg<128, 128, 32, 4, 2, 4>>(bench, "128x128, k32, 4 stages, 2x4 warps");
  prefill<PrefillCfg<128, 128, 64, 3, 2, 4>>(bench, "128x128, k64, 3 stages, 2x4 warps");
  prefill<PrefillCfg<64, 64, 64, 4, 2, 2>>(bench, "64x64, k64, 4 stages, 2x2 warps");
  prefill<PrefillCfg<64, 128, 64, 4, 2, 2>>(bench, "64x128, k64, 4 stages, 2x2 warps");
  decode<Decode>(bench, "16 cols, k256, 8 stages (library)");
  decode<DecodeCfg<16, 128, 8>>(bench, "16 cols, k128, 8 stages");
  decode<DecodeCfg<16, 128, 16>>(bench, "16 cols, k128, 16 stages");
  decode<DecodeCfg<16, 64, 16>>(bench, "16 cols, k64, 16 stages");
  decode<DecodeCfg<16, 256, 10>>(bench, "16 cols, k256, 10 stages");
  decode<DecodeCfg<8, 128, 8>>(bench, "8 cols, k128, 8 stages");
  decode<DecodeCfg<32, 128, 8>>(bench, "32 cols, k128, 8 stages");
  return 0;
}
