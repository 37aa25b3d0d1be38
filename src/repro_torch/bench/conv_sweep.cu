// Times B8's tensor-core tiles (kernels/csrc/conv_tc.cuh) on the card at
// every ResNet-18 layer (bench/conv.py RESNET18) and every VGG layer of Fig.
// 9 (bench/binary.py VGG_LAYERS), batch 1: the OS tile at several shapes,
// the int8 ones at several splits of k, on an int8 filter, packed 4-bit
// planes (int8 images, dequant scale and bias, f32 out) and bf16 (f32 out),
// and the WS and IS walks where they fit. Every variant must give the bits of
// the library's 64 x 64 tile without a split. One JSON line per (variant,
// layer), then the library's rule (conv::os_tile) at each layer. Build and
// run from the repo root:
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//     -o conv_sweep src/repro_torch/bench/conv_sweep.cu && ./conv_sweep
//
// (`./conv_sweep quick` runs the first layer only.) Built with
// -DCONV_SWEEP_DIAG instead, it times where the library tile's time goes
// at each layer: the timer's floor (an empty kernel), the tile with a warm
// L2, with int32 out, with deeper rings and one warp, its k loop with the
// loads, the products or both taken out, and B1's int8 and bf16 prefill
// tiles on a GEMM of the same size (each variant is its own kernel, so the
// two builds take minutes each).
//
// Times are CUDA-event medians of 15 launches, each after a 256 MiB write
// that empties the 50 MB L2, so the operands come from device memory.
#include <algorithm>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

#include "../kernels/csrc/conv_tc.cuh"

using namespace conv;

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
  cudaEventDestroy(start);
  cudaEventDestroy(end);
  std::sort(ms.begin(), ms.end());
  return ms[ms.size() / 2];
}

struct Layer {
  const char* net;
  int ih, iw, f, s, cin, cout;
};
const Layer LAYERS[] = {
    {"resnet18", 56, 56, 3, 1, 64, 64},   {"resnet18", 56, 56, 3, 2, 64, 128},
    {"resnet18", 28, 28, 3, 1, 128, 128}, {"resnet18", 28, 28, 3, 2, 128, 256},
    {"resnet18", 14, 14, 3, 1, 256, 256}, {"resnet18", 14, 14, 3, 2, 256, 512},
    {"resnet18", 7, 7, 3, 1, 512, 512},   {"vgg", 56, 56, 3, 1, 256, 256},
    {"vgg", 56, 56, 3, 1, 256, 512},      {"vgg", 28, 28, 3, 1, 512, 512},
    {"vgg", 14, 14, 3, 1, 512, 512},
};

Geo geo(const Layer& l, int wb) {
  Geo g{1, l.ih, l.iw, l.cin, l.f, l.f, l.s, l.cout};
  g.oh = (l.ih - l.f) / l.s + 1;
  g.ow = (l.iw - l.f) / l.s + 1;
  g.p = g.oh * g.ow;
  g.cr = wb ? round_up(l.cin, 32) : l.cin;
  g.k = l.f * l.f * g.cr;
  g.tiles = cdiv(g.p, 64);
  return g;
}

struct Bench {
  void *x, *w, *w_hi, *out, *want, *flush;
  int* ws;
  unsigned* counters;
  float *scale, *bias;
  size_t flush_bytes = 256u << 20, ws_ints = 16u << 20, out_bytes = 0;
  gemm::Epi e{};

  size_t differing() const {
    std::vector<unsigned> a(out_bytes / 4), b(out_bytes / 4);
    cudaMemcpy(a.data(), out, out_bytes, cudaMemcpyDeviceToHost);
    cudaMemcpy(b.data(), want, out_bytes, cudaMemcpyDeviceToHost);
    size_t bad = 0;
    for (size_t i = 0; i < a.size(); ++i) bad += a[i] != b[i];
    return bad;
  }

  template <class L>
  void report(const char* kind, const char* tile, int split, const Layer& l, const Geo& g,
              int ctas, size_t smem, L launch) {
    const float ms = median_ms(launch, flush, flush_bytes);
    const cudaError_t err = cudaGetLastError();
    printf("{\"bench\": \"conv_tile_sweep\", \"kind\": \"%s\", \"tile\": \"%s\", "
           "\"split\": %d, \"layer\": [%d, %d, %d, %d, %d, %d], \"m\": %d, \"k\": %d, "
           "\"n\": %d, \"ctas\": %d, \"smem_bytes\": %zu, \"ms\": %.5f, "
           "\"elements_differing\": %zu, \"error\": \"%s\"}\n",
           kind, tile, split, l.ih, l.iw, l.f, l.s, l.cin, l.cout, g.p, g.k, g.cout, ctas, smem,
           ms, differing(), cudaGetErrorString(err));
    fflush(stdout);
  }

  template <class C, int WB>
  void os(const char* kind, const char* tile, const Layer& l, int split) {
    const Geo g = geo(l, WB);
    if (C::INT ? cdiv(round_up(g.k, 32), C::TBK) < split : split > 1) return;
    gemm::Took took{};
    auto run = [&] {
      return launch_os<C, WB>(x, w, w_hi, out, g, e, split, ws, ws_ints, counters, 1 << 16, 0,
                              &took);
    };
    if (run() != 0) return;
    report(kind, tile, split, l, g, took.ctas, took.smem, run);
  }

  template <class C, int WB, int WALK>
  void walk(const char* kind, const char* tile, const Layer& l) {
    const Geo g = geo(l, WB);
    gemm::Took took{};
    auto run = [&] { return launch_walk<C, WB, WALK>(x, w, w_hi, out, g, e, 0, &took); };
    if (run() != 0) {  // does not fit a block
      cudaGetLastError();
      return;
    }
    report(kind, tile, 1, l, g, took.ctas, took.smem, run);
  }

  // The reference bits of one layer: the 64 x 64 tile without a split.
  template <typename T, int WB>
  void reference(const Layer& l) {
    const Geo g = geo(l, WB);
    launch_os<Os1<T>, WB>(x, w, w_hi, want, g, e, 1, ws, ws_ints, counters, 1 << 16, 0,
                          nullptr);
    cudaDeviceSynchronize();
  }
};

#if !defined(CONV_SWEEP_DIAG)
// The variants of one input kind at one layer.
template <typename T, int WB>
void sweep(Bench& b, const char* kind, const Layer& l) {
  using S4 = Cfg<T, 64, 64, 64, 3, 2, 2>;
  using T64x32 = Cfg<T, 64, 32, 64, 4, 2, 2>;
  using T32x64 = Cfg<T, 32, 64, 64, 4, 2, 2>;
  b.reference<T, WB>(l);
  const int splits[] = {1, 2, 4, 8};
  for (int split : splits) {
    if (split > 1 && !std::is_same<T, int8_t>::value) break;
    b.os<Os0<T>, WB>(kind, "128x64", l, split);
    b.os<Os1<T>, WB>(kind, "64x64", l, split);
    b.os<Os2<T>, WB>(kind, "32x32", l, split);
    b.os<T64x32, WB>(kind, "64x32", l, split);
    b.os<T32x64, WB>(kind, "32x64", l, split);
    b.os<S4, WB>(kind, "64x64 3 stages", l, split);
  }
  // the library's rule, with its own split
  const Geo g = geo(l, WB);
  const OsChoice c = os_tile<T>(g);
  if (c.tile == 0) b.os<Os0<T>, WB>(kind, "rule: 128x64", l, c.split);
  else if (c.tile == 1) b.os<Os1<T>, WB>(kind, "rule: 64x64", l, c.split);
  else b.os<Os2<T>, WB>(kind, "rule: 32x32", l, c.split);
  if constexpr (!std::is_same<T, int8_t>::value) {  // two chunks a step
    b.os<Cfg<T, 128, 64, 32, 4, 4, 2>, WB>(kind, "128x64 k32", l, 1);
    b.os<Cfg<T, 64, 64, 32, 4, 2, 2>, WB>(kind, "64x64 k32", l, 1);
    b.os<Cfg<T, 32, 32, 32, 4, 2, 2>, WB>(kind, "32x32 k32", l, 1);
  }
  if constexpr (std::is_same<T, int8_t>::value) {
    using K128 = Cfg<T, 128, 64, 128, 4, 4, 2>;
    using K128s = Cfg<T, 64, 64, 128, 4, 2, 2>;
    for (int split : splits) {
      b.os<K128, WB>(kind, "128x64 k128", l, split);
      b.os<K128s, WB>(kind, "64x64 k128", l, split);
    }
    b.walk<WsI8, WB, WALK_M>(kind, "ws", l);
    b.walk<IsI8, WB, WALK_N>(kind, "is", l);
  } else {
    b.walk<WsBf16, WB, WALK_M>(kind, "ws", l);
    b.walk<IsBf16, WB, WALK_N>(kind, "is", l);
  }
}

#else
__global__ void empty_kernel() {}

// The OS k loop with parts taken out, to time them apart: MODE 0 the whole
// loop, 1 without the products, 2 without the loads (the ring's stale bytes
// multiplied), 3 the barriers alone. Writes one value a CTA so no part is
// dead code.
template <class C, int MODE>
__global__ void __launch_bounds__(C::NT)
probe_kernel(const int8_t* __restrict__ x, const void* __restrict__ w, int* out, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Ring<C, 0> ring{reinterpret_cast<int8_t*>(smem), smem + C::STAGES * C::A_BYTES,
                        (int)(threadIdx.x >> 5) % C::WN * (C::TBN / C::WN)};
  const int tiles = cdiv(g.p, C::TBM), q0 = (blockIdx.y % tiles) * C::TBM;
  const int col0 = blockIdx.x * C::TBN, wr = (int)(threadIdx.x >> 5) / C::WN * (C::TBM / C::WM);
  int base[C::ROWS];
  pixel_bases<C>(base, g, q0);
  Cursor cur;
  cur.start(g, gather_col<C, true>());
  int acc[C::MI][C::NI][4];
  zero<C>(acc);
  const int steps = steps_of<C>(g);
  auto load = [&](int s) {
    if constexpr (MODE == 0 || MODE == 1) {
      gather_a<C, true, false>(ring.as + (s % C::STAGES) * C::A_ELEMS, x, g, base, q0,
                               cur.offset(g));
      cur.advance(g, C::TBK);
      load_b<C, 0, true>(ring.bs + (s % C::STAGES) * C::b_bytes(0), w, nullptr, g, s * C::TBK,
                         col0);
    }
  };
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps) load(s);
    tc::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    if (s + C::STAGES - 1 < steps) load(s + C::STAGES - 1);
    tc::cp_async_commit();
    if constexpr (MODE == 0 || MODE == 2)
      mma_step<C>(acc, ring.a(s % C::STAGES), wr, ring.b(s % C::STAGES, 0), C::TBK / 16);
  }
  tc::cp_async_wait<0>();
  int sum = 0;
  for (int mi = 0; mi < C::MI; ++mi)
    for (int ni = 0; ni < C::NI; ++ni)
      for (int j = 0; j < 4; ++j) sum += acc[mi][ni][j];
  if (sum == 12345) out[blockIdx.x] = sum;
}

template <class C, int MODE>
float probe_ms(Bench& b, const Geo& g) {
  const dim3 grid(cdiv(g.cout, C::TBN), cdiv(g.p, C::TBM));
  const size_t smem = C::ring(0, true);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(probe_kernel<C, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  return median_ms([&] {
    probe_kernel<C, MODE><<<grid, C::NT, smem>>>(static_cast<const int8_t*>(b.x), b.w,
                                                 b.ws, g);
  }, b.flush, b.flush_bytes);
}

// Where a tile's time goes at one layer: the timer's floor (an empty
// kernel), the library tile with a warm L2 (no flush), without the
// epilogue (raw int32), with deeper rings, and B1's int8 / bf16 prefill
// tile on the im2col'd operands of the same GEMM (M = pixels).
void diagnose(Bench& b, const Layer& l) {
  const Geo g = geo(l, 0);
  const Epi dequant = b.e;
  auto line = [&](const char* what, float ms) {
    printf("{\"bench\": \"conv_tile_diag\", \"what\": \"%s\", \"layer\": [%d, %d, %d, %d, "
           "%d, %d], \"ms\": %.5f, \"error\": \"%s\"}\n",
           what, l.ih, l.iw, l.f, l.s, l.cin, l.cout, ms, cudaGetErrorString(cudaGetLastError()));
    fflush(stdout);
  };
  line("empty kernel", median_ms([&] { empty_kernel<<<1, 32>>>(); }, b.flush, b.flush_bytes));
  line("empty kernel, 184 CTAs of 128", median_ms([&] { empty_kernel<<<184, 128>>>(); }, b.flush,
                                                   b.flush_bytes));
  const char* modes[4] = {"whole loop", "loads only", "products only", "barriers only"};
  auto probes = [&](auto cfg, const char* tile) {
    using C = decltype(cfg);
    const float ms[4] = {probe_ms<C, 0>(b, g), probe_ms<C, 1>(b, g), probe_ms<C, 2>(b, g),
                         probe_ms<C, 3>(b, g)};
    for (int m = 0; m < 4; ++m) {
      char what[96];
      snprintf(what, sizeof what, "probe %s %s, %d steps", tile, modes[m], steps_of<C>(g));
      line(what, ms[m]);
    }
  };
  probes(Os2<int8_t>(), "int8 32x32");
  probes(Os1<int8_t>(), "int8 64x64");
  probes(Cfg<int8_t, 64, 64, 128, 4, 2, 2>(), "int8 64x64 k128");
  const OsChoice c = os_tile<int8_t>(g);
  auto lib = [&](const Epi& e, void* flush, size_t bytes) {
    auto run = [&] {
      if (c.tile == 0)
        launch_os<Os0<int8_t>, 0>(b.x, b.w, nullptr, b.out, g, e, c.split, b.ws, b.ws_ints,
                                  b.counters, 1 << 16, 0, nullptr);
      else if (c.tile == 1)
        launch_os<Os1<int8_t>, 0>(b.x, b.w, nullptr, b.out, g, e, c.split, b.ws, b.ws_ints,
                                  b.counters, 1 << 16, 0, nullptr);
      else
        launch_os<Os2<int8_t>, 0>(b.x, b.w, nullptr, b.out, g, e, c.split, b.ws, b.ws_ints,
                                  b.counters, 1 << 16, 0, nullptr);
    };
    return median_ms(run, flush, bytes);
  };
  line("int8 library tile, flushed", lib(dequant, b.flush, b.flush_bytes));
  line("int8 library tile, warm L2", lib(dequant, b.flush, 0));
  Epi raw{nullptr, gemm::SCALE_NONE, nullptr, gemm::ACT_NONE, nullptr, REPRO_I32};
  line("int8 library tile, int32 out", lib(raw, b.flush, b.flush_bytes));
  using D8 = Cfg<int8_t, 32, 32, 64, 8, 2, 2>;
  line("int8 32x32 8 stages", median_ms([&] {
    launch_os<D8, 0>(b.x, b.w, nullptr, b.out, g, dequant, c.split, b.ws, b.ws_ints,
                     b.counters, 1 << 16, 0, nullptr);
  }, b.flush, b.flush_bytes));
  using W1 = Cfg<int8_t, 32, 32, 32, 4, 1, 1>;
  line("int8 32x32 one warp", median_ms([&] {
    launch_os<W1, 0>(b.x, b.w, nullptr, b.out, g, dequant, c.split, b.ws, b.ws_ints,
                     b.counters, 1 << 16, 0, nullptr);
  }, b.flush, b.flush_bytes));
  // B1's int8 prefill tile on an (M, K) A of the same size (the image's
  // bytes reused as A: only the time matters here)
  line("B1 int8 prefill tile, same GEMM", median_ms([&] {
    gemm::i8::launch<0>(b.x, b.w, nullptr, b.out, g.p, g.cout, g.k, dequant, 0);
  }, b.flush, b.flush_bytes));
  Epi none{nullptr, gemm::SCALE_NONE, nullptr, gemm::ACT_NONE, nullptr, REPRO_F32};
  gemm::Took took{};
  line("B1 bf16 prefill tile, same GEMM", median_ms([&] {
    gemm::launch_tc(b.x, b.w, b.out, g.p, g.cout, g.k, none, 0, &took);
  }, b.flush, b.flush_bytes));
}

#endif

}  // namespace

int main(int argc, char** argv) {
  const bool quick = argc > 1 && !strcmp(argv[1], "quick");
  Bench b;
  const size_t in_bytes = 8u << 20;
  cudaMalloc(&b.x, 4 * in_bytes);  // room for B1's tiles on im2col-sized A
  cudaMalloc(&b.w, 4 * in_bytes);
  cudaMalloc(&b.w_hi, in_bytes);
  cudaMalloc(&b.out, 32u << 20);
  cudaMalloc(&b.want, 32u << 20);
  cudaMalloc(&b.flush, b.flush_bytes);
  cudaMalloc(&b.ws, b.ws_ints * 4);
  cudaMalloc(&b.counters, (1 << 16) * 4);
  cudaMemset(b.counters, 0, (1 << 16) * 4);
  cudaMalloc(&b.scale, 4096 * 4);
  cudaMalloc(&b.bias, 4096 * 4);
  std::mt19937 rng(7);
  std::vector<int8_t> bytes(in_bytes);
  for (auto& v : bytes) v = (int8_t)(rng() % 255 - 127);
  cudaMemcpy(b.x, bytes.data(), in_bytes, cudaMemcpyHostToDevice);
  for (auto& v : bytes) v = (int8_t)(rng() % 255 - 127);
  cudaMemcpy(b.w, bytes.data(), in_bytes, cudaMemcpyHostToDevice);
  for (auto& v : bytes) v = (int8_t)rng();
  cudaMemcpy(b.w_hi, bytes.data(), in_bytes, cudaMemcpyHostToDevice);
  std::vector<float> f(4096);
  for (auto& v : f) v = (rng() % 1000) * 1e-7f;
  cudaMemcpy(b.scale, f.data(), f.size() * 4, cudaMemcpyHostToDevice);
  for (auto& v : f) v = (float)(rng() % 2001) * 1e-3f - 1.f;
  cudaMemcpy(b.bias, f.data(), f.size() * 4, cudaMemcpyHostToDevice);
  std::vector<__nv_bfloat16> h(in_bytes / 2);
  for (auto& v : h) v = __float2bfloat16(((int)(rng() % 2001) - 1000) * 1e-3f);
  const int n_layers = quick ? 1 : (int)(sizeof(LAYERS) / sizeof(LAYERS[0]));
  for (int i = 0; i < n_layers; ++i) {
    const Layer& l = LAYERS[i];
    const Geo g = geo(l, 0);
    b.out_bytes = (size_t)g.p * g.cout * 4;
    // int8 and packed: dequant scale per channel, bias, f32 out
    b.e = gemm::Epi{b.scale, gemm::SCALE_COL, b.bias, gemm::ACT_NONE, nullptr, REPRO_F32};
#if defined(CONV_SWEEP_DIAG)
    diagnose(b, l);
#else
    sweep<int8_t, 0>(b, "int8", l);
    sweep<int8_t, 4>(b, "packed4", l);
    // bf16: f32 out, no epilogue stage
    b.e = gemm::Epi{nullptr, gemm::SCALE_NONE, nullptr, gemm::ACT_NONE, nullptr, REPRO_F32};
    cudaMemcpy(b.x, h.data(), in_bytes, cudaMemcpyHostToDevice);
    cudaMemcpy(b.w, h.data() + 1000, in_bytes - 2000, cudaMemcpyHostToDevice);
    sweep<__nv_bfloat16, 0>(b, "bf16", l);
    // int8 images again for the next layer
    for (auto& v : bytes) v = (int8_t)(rng() % 255 - 127);
    cudaMemcpy(b.x, bytes.data(), in_bytes, cudaMemcpyHostToDevice);
    cudaMemcpy(b.w, bytes.data() + 4096, in_bytes - 4096, cudaMemcpyHostToDevice);
    for (int wb : {0, 4}) {
      const Geo gw = geo(l, wb);
      const OsChoice c = os_tile<int8_t>(gw);
      printf("{\"bench\": \"conv_tile_rule\", \"kind\": \"%s\", \"layer\": [%d, %d, %d, %d, "
             "%d, %d], \"tile\": %d, \"ctas\": %d, \"split\": %d}\n",
             wb ? "packed4" : "int8", l.ih, l.iw, l.f, l.s, l.cin, l.cout, c.tile, c.ctas,
             c.split);
    }
    const OsChoice c = os_tile<__nv_bfloat16>(g);
    printf("{\"bench\": \"conv_tile_rule\", \"kind\": \"bf16\", \"layer\": [%d, %d, %d, %d, %d, "
           "%d], \"tile\": %d, \"ctas\": %d, \"split\": %d}\n",
           l.ih, l.iw, l.f, l.s, l.cin, l.cout, c.tile, c.ctas, c.split);
#endif
  }
  const cudaError_t err = cudaDeviceSynchronize();
  printf("{\"bench\": \"conv_tile_sweep_done\", \"error\": \"%s\"}\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
