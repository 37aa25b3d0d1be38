// Times variants of B1's tensor-core tiles on the card at qwen3-1.7b's MLP
// shapes: the bf16 tiles (csrc/gemm_tc.cuh), each against the tile the
// library uses, and the int8 tiles (csrc/gemm_tc_i8.cuh) on an int8 B and
// on packed 4-bit planes, each against the integer walk of gemm_common.cuh
// (the CUDA cores' exact k loop). Every variant must give its reference's
// bits. One JSON line per (tile, shape). Build and run from the repo root:
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//     -o tile_sweep src/repro_torch/bench/tile_sweep.cu && ./tile_sweep
//
// (`./tile_sweep bf16` or `./tile_sweep int8` runs one of the two sweeps.)
//
// Times are CUDA-event medians of 15 launches, each after a 256 MiB write
// that empties the 50 MB L2, so the operands come from device memory.
#include <algorithm>
#include <cstdio>
#include <cstring>
#include <utility>
#include <vector>

#include "../kernels/csrc/gemm_tc.cuh"
#include "../kernels/csrc/gemm_tc_i8.cuh"

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

// The int8 tiles: A (512, 6144) int8, B an int8 (6144, 6144) or packed
// 4-bit planes (768, 6144) words, int32 out (no epilogue stage).
struct I8Bench {
  int8_t *a, *b;
  uint32_t* w;
  int *c, *want;
  void* flush;
  size_t flush_bytes = 256u << 20;
  Epi e{nullptr, SCALE_NONE, nullptr, ACT_NONE, nullptr, REPRO_I32};

  const void* bop(int wb) const {
    return wb == 0 ? static_cast<const void*>(b) : static_cast<const void*>(w);
  }

  size_t differing(int m, int n) const {
    std::vector<int> x((size_t)m * n), y((size_t)m * n);
    cudaMemcpy(x.data(), c, x.size() * 4, cudaMemcpyDeviceToHost);
    cudaMemcpy(y.data(), want, y.size() * 4, cudaMemcpyDeviceToHost);
    size_t bad = 0;
    for (size_t i = 0; i < x.size(); ++i) bad += x[i] != y[i];
    return bad;
  }

  // The flush's variants: f32 out through a per-column scale, and the
  // packed weight's outlier sidecar (2 filled slots of a K-deep weight's
  // capacity, 3 per 256 rows), as serve_packed's launches take them.
  float* scale;
  int *sidx, *sdelta;

  Epi flush_epi(bool scaled, bool sidecar, int k) const {
    Epi f{nullptr, SCALE_NONE, nullptr, ACT_NONE, nullptr, REPRO_I32};
    if (scaled) {
      f.scale = scale;
      f.scale_mode = SCALE_COL;
      f.out_dtype = REPRO_F32;
    }
    if (sidecar) {
      f.sa = a;
      f.sidx = sidx;
      f.sdelta = sdelta;
      f.sr = (3 * k + 255) / 256;
      f.sk = k;
    }
    return f;
  }

  // Runs the tile `launch(out)` at (m, k, n) after the integer walk wrote
  // the reference bits (with the same epilogue e).
  template <int WB, class L>
  void run(const char* name, size_t smem, int m, int k, int n, L launch) {
    launch_walk<int8_t, WB, WALK_NONE, false, B_STREAMED>(a, bop(WB), nullptr, want, m,
                                                          n, k, e, 0);
    const float ms = median_ms([&] { launch(c); }, flush, flush_bytes);
    const cudaError_t err = cudaGetLastError();
    printf("{\"bench\": \"b1_i8_tile_sweep\", \"b\": \"%s\", \"tile\": \"%s\", "
           "\"flush\": \"%s%s\", \"m\": %d, \"k\": %d, \"n\": %d, \"ms\": %.5f, "
           "\"smem_bytes\": %zu, \"elements_differing\": %zu, \"error\": \"%s\"}\n",
           WB == 0 ? "int8" : "packed 4-bit", name,
           e.scale_mode ? "scale -> f32" : "int32", e.sr ? ", sidecar" : "", m, k, n, ms,
           smem, differing(m, n), cudaGetErrorString(err));
  }
};

// The library tiles with each flush: int32, scale -> f32, the sidecar
// (packed only), both.
template <int WB>
void i8_flushes(I8Bench& bench) {
  const Epi plain = bench.e;
  for (int variant = 1; variant < (WB == 0 ? 2 : 4); ++variant) {
    for (int m : {512, 4})
      for (auto kn : {std::pair<int, int>{6144, 2048}, {2048, 6144}}) {
        const int k = kn.first, n = kn.second;
        bench.e = bench.flush_epi(variant & 1, variant & 2, k);
        bench.run<WB>("library", 0, m, k, n, [&](int* out) {
          i8::launch<WB>(bench.a, bench.bop(WB), nullptr, out, m, n, k, bench.e, 0);
        });
      }
  }
  bench.e = plain;
}

// The operands here are whole 16-byte vectors, so only the tiles' vector
// loads are instantiated.
template <class C, int WB>
void i8_prefill(I8Bench& bench, const char* name) {
  for (auto kn : {std::pair<int, int>{6144, 2048}, {2048, 6144}}) {
    const int m = 512, k = kn.first, n = kn.second;
    bench.run<WB>(name, C::smem(WB), m, k, n, [&](int* out) {
      i8::launch_cfg(i8::i8_prefill_kernel<C, true, WB>,
                     dim3(cdiv(n, C::TBN), cdiv(m, C::TBM)), C::NT, C::smem(WB),
                     bench.a, bench.bop(WB), nullptr, out, m, n, k, bench.e, 0);
    });
  }
}

template <class C, int WB>
void i8_decode(I8Bench& bench, const char* name) {
  for (auto kn : {std::pair<int, int>{6144, 2048}, {2048, 6144}}) {
    const int m = 4, k = kn.first, n = kn.second;
    bench.run<WB>(name, C::smem(WB), m, k, n, [&](int* out) {
      i8::launch_cfg(i8::i8_decode_kernel<C, true, WB>, dim3(cdiv(n, C::TBN)), C::NT,
                     C::smem(WB), bench.a, bench.bop(WB), nullptr, out, m, n, k,
                     bench.e, 0);
    });
  }
}

template <int WB>
void i8_prefills(I8Bench& bench) {
  using i8::PrefillCfg;
  i8_prefill<i8::Prefill, WB>(bench, "128x64, k128, 4 stages, 4x2 warps (library)");
  i8_prefill<PrefillCfg<128, 64, 64, 4, 4, 2>, WB>(bench, "128x64, k64, 4 stages, 4x2 warps");
  i8_prefill<PrefillCfg<128, 64, 256, 3, 4, 2>, WB>(bench, "128x64, k256, 3 stages, 4x2 warps");
  i8_prefill<PrefillCfg<128, 64, 128, 4, 2, 1>, WB>(bench, "128x64, k128, 4 stages, 2x1 warps");
  i8_prefill<PrefillCfg<128, 128, 128, 3, 2, 4>, WB>(bench, "128x128, k128, 3 stages, 2x4 warps");
  i8_prefill<PrefillCfg<128, 128, 128, 4, 2, 2>, WB>(bench, "128x128, k128, 4 stages, 2x2 warps");
  i8_prefill<PrefillCfg<64, 128, 128, 4, 2, 2>, WB>(bench, "64x128, k128, 4 stages, 2x2 warps");
  i8_prefill<PrefillCfg<64, 128, 256, 3, 2, 2>, WB>(bench, "64x128, k256, 3 stages, 2x2 warps");
  i8_prefill<PrefillCfg<64, 128, 128, 4, 1, 2>, WB>(bench, "64x128, k128, 4 stages, 1x2 warps");
  i8_prefill<PrefillCfg<64, 64, 128, 4, 2, 2>, WB>(bench, "64x64, k128, 4 stages, 2x2 warps");
  i8_prefill<PrefillCfg<64, 64, 256, 3, 2, 2>, WB>(bench, "64x64, k256, 3 stages, 2x2 warps");
}

void i8_sweep() {
  I8Bench bench;
  cudaMalloc(&bench.flush, bench.flush_bytes);
  const size_t elems = (size_t)6144 * 6144;
  cudaMalloc(&bench.a, (size_t)512 * 6144);
  cudaMalloc(&bench.b, elems);
  cudaMalloc(&bench.w, elems / 2);
  cudaMalloc(&bench.c, (size_t)512 * 6144 * 4);
  cudaMalloc(&bench.want, (size_t)512 * 6144 * 4);
  // Bytes and words from a multiplicative hash of the index: int8 values
  // in [-127, 127], packed words of any nibbles.
  std::vector<uint32_t> host(elems / 4);
  for (size_t i = 0; i < host.size(); ++i) {
    uint32_t x = (uint32_t)(i * 2654435761u) ^ (uint32_t)(i >> 7) * 40503u;
    for (int j = 0; j < 4; ++j) {
      const uint32_t byte = (x >> (8 * j)) & 0xffu;
      if (byte == 0x80u) x ^= 1u << (8 * j);  // no -128
    }
    host[i] = x;
  }
  cudaMemcpy(bench.b, host.data(), elems, cudaMemcpyHostToDevice);
  cudaMemcpy(bench.w, host.data(), elems / 2, cudaMemcpyHostToDevice);
  cudaMemcpy(bench.a, host.data() + 12345, (size_t)512 * 6144, cudaMemcpyHostToDevice);
  // Per-column scales in [2^-12, 2^-11); the sidecar's filled slots at rows
  // 100 and 2000 (< every K here), the rest empty (index 1 << 30), deltas
  // in [-127, 127].
  std::vector<float> sc(6144);
  for (int i = 0; i < 6144; ++i) sc[i] = (1.0f + (float)(i % 97) / 97.0f) / 4096.0f;
  std::vector<int> idx(72, 1 << 30), delta((size_t)72 * 6144);
  idx[0] = 100;
  idx[1] = 2000;
  for (size_t i = 0; i < delta.size(); ++i) delta[i] = (int)(host[i] % 255u) - 127;
  cudaMalloc(&bench.scale, sc.size() * 4);
  cudaMalloc(&bench.sidx, idx.size() * 4);
  cudaMalloc(&bench.sdelta, delta.size() * 4);
  cudaMemcpy(bench.scale, sc.data(), sc.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(bench.sidx, idx.data(), idx.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(bench.sdelta, delta.data(), delta.size() * 4, cudaMemcpyHostToDevice);
  i8_flushes<4>(bench);
  i8_flushes<0>(bench);

  using i8::DecodeCfg;
  i8_decode<i8::DecodePacked, 4>(bench, "32 cols, 4 warps, k512, 4 stages (library)");
  i8_decode<DecodeCfg<16, 2, 512, 6>, 4>(bench, "16 cols, 2 warps, k512, 6 stages");
  i8_decode<DecodeCfg<16, 2, 2048, 2>, 4>(bench, "16 cols, 2 warps, k2048, 2 stages");
  i8_decode<DecodeCfg<8, 1, 1024, 4>, 4>(bench, "8 cols, 1 warp, k1024, 4 stages");
  i8_decode<DecodeCfg<32, 4, 1024, 3>, 4>(bench, "32 cols, 4 warps, k1024, 3 stages");
  i8_decode<DecodeCfg<32, 4, 256, 8>, 4>(bench, "32 cols, 4 warps, k256, 8 stages");
  i8_decode<DecodeCfg<64, 8, 512, 3>, 4>(bench, "64 cols, 8 warps, k512, 3 stages");
  i8_decode<DecodeCfg<32, 2, 512, 4>, 4>(bench, "32 cols, 2 warps, k512, 4 stages");
  i8_decode<i8::DecodeDense, 0>(bench, "64 cols, 4 warps, k512, 3 stages (library)");
  i8_decode<DecodeCfg<16, 1, 512, 6>, 0>(bench, "16 cols, 1 warp, k512, 6 stages");
  i8_decode<DecodeCfg<16, 1, 1024, 4>, 0>(bench, "16 cols, 1 warp, k1024, 4 stages");
  i8_decode<DecodeCfg<32, 2, 512, 4>, 0>(bench, "32 cols, 2 warps, k512, 4 stages");
  i8_decode<DecodeCfg<32, 2, 256, 8>, 0>(bench, "32 cols, 2 warps, k256, 8 stages");
  i8_prefills<4>(bench);
  i8_prefills<0>(bench);
}

}  // namespace

int main(int argc, char** argv) {
  const bool all = argc < 2;
  if (all || !strcmp(argv[1], "int8")) i8_sweep();
  if (!all && strcmp(argv[1], "bf16")) return 0;
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
