// B1: the output-stationary (OS) fused-epilogue GEMM.
//
// Replaces the TPU kernel repro/kernels/matmul_df.py `_os_kernel` (built by
// `_build_os`): C = act(scale * (A @ B) + bias) + residual, with each output
// tile's f32 accumulator held on chip across the whole k loop and written to
// device memory once, after the epilogue.
//
// One CTA owns a 64x64 output tile; its 256 threads each keep a 4x4 block of
// accumulators in registers while 64x32 A and 32x64 B tiles stream through
// shared memory (converted to f32 at the load; the next tile's 16-byte loads
// are in flight while the current one is consumed). Every output element sums
// over k in ascending order with one fmaf per step, whatever M, the tile it
// falls in or the other rows: a row's result does not depend on the batch
// it rides in, which the serving invariant (mixed-length batches emit the
// same tokens as requests decoded alone) needs. No split-k, no atomics.
//
// Bound on H100: at the decode shapes (M = batch rows) the weight stream,
// i.e. bytes; at prefill shapes (M in the hundreds) the arithmetic. This
// version runs on the CUDA cores in f32 (no tensor cores, no TMA), so it
// reaches neither bound; wgmma tiles are the next step (see PERF.md).
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

// Epilogue codes, as repro_torch/kernels/matmul_df.py encodes them.
enum ScaleMode { SCALE_NONE = 0, SCALE_TENSOR = 1, SCALE_COL = 2, SCALE_ROW = 3 };
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(x, 0.f);
    case ACT_GELU: {  // tanh approximation (jax.nn.gelu's default)
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case ACT_SILU:
      return x / (1.f + expf(-x));
    default:
      return x;
  }
}

// Global -> register -> shared staging of one operand element group:
// 16-byte vectors when the rows allow it (VEC), single elements otherwise.
template <typename T, bool VEC>
struct TileIO;

template <typename T>
struct TileIO<T, true> {
  static constexpr int V = Vec16<T>::N;
  using Reg = uint4;
  __device__ static __forceinline__ Reg load(const T* p, bool in) {
    return in ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ static __forceinline__ void unpack(const Reg& r, float* o) {
    Vec16<T>::unpack(r, o);
  }
};

template <typename T>
struct TileIO<T, false> {
  static constexpr int V = 1;
  using Reg = float;
  __device__ static __forceinline__ Reg load(const T* p, bool in) {
    return in ? load_f32(p) : 0.f;
  }
  __device__ static __forceinline__ void unpack(const Reg& r, float* o) {
    o[0] = r;
  }
};

template <typename T, typename O, bool VEC>
__global__ void __launch_bounds__(THREADS)
matmul_os_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 O* __restrict__ c, int m, int n, int k,
                 const float* __restrict__ scale, int scale_mode,
                 const float* __restrict__ bias, int act,
                 const float* __restrict__ residual) {
  using IO = TileIO<T, VEC>;
  constexpr int V = IO::V;
  constexpr int A_VPR = BK / V, A_IT = BM * A_VPR / THREADS;
  constexpr int B_VPR = BN / V, B_IT = BK * B_VPR / THREADS;
  __shared__ float as[BK][BM + 4];  // A tile, k-major
  __shared__ float bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  typename IO::Reg ra[A_IT], rb[B_IT];

  // Issue every load of the k tile at k0 into registers.
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < A_IT; ++it) {
      const int i = tid + it * THREADS;
      const int gr = row0 + i / A_VPR, gk = k0 + (i % A_VPR) * V;
      ra[it] = IO::load(a + (size_t)gr * k + gk, gr < m && gk < k);
    }
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int i = tid + it * THREADS;
      const int gk = k0 + i / B_VPR, gc = col0 + (i % B_VPR) * V;
      rb[it] = IO::load(b + (size_t)gk * n + gc, gk < k && gc < n);
    }
  };
  // Convert the fetched tile to f32 in shared memory.
  auto stash = [&]() {
    float v[V];
#pragma unroll
    for (int it = 0; it < A_IT; ++it) {
      const int i = tid + it * THREADS;
      IO::unpack(ra[it], v);
#pragma unroll
      for (int j = 0; j < V; ++j) as[(i % A_VPR) * V + j][i / A_VPR] = v[j];
    }
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int i = tid + it * THREADS;
      IO::unpack(rb[it], v);
#pragma unroll
      for (int j = 0; j < V; ++j) bs[i / B_VPR][(i % B_VPR) * V + j] = v[j];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < k; k0 += BK) {
    const bool more = k0 + BK < k;
    if (more) fetch(k0 + BK);  // in flight while this tile is consumed
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }

  // The flush: the epilogue runs on the registers, then the one write.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cc = col0 + tx * TN + j;
      if (cc >= n) continue;
      float x = acc[i][j];
      if (scale_mode == SCALE_TENSOR) x *= scale[0];
      else if (scale_mode == SCALE_COL) x *= scale[cc];
      else if (scale_mode == SCALE_ROW) x *= scale[r];
      if (bias) x += bias[cc];
      x = activate(x, act);
      if (residual) x += residual[(size_t)r * n + cc];
      store_f32(c + (size_t)r * n + cc, x);
    }
  }
}

template <typename T, typename O>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           const float* scale, int scale_mode, const float* bias, int act,
           const float* residual, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  constexpr int V = Vec16<T>::N;
  const bool vec = k % V == 0 && n % V == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (vec)
    matmul_os_kernel<T, O, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<O*>(c), m, n, k, scale, scale_mode, bias, act, residual);
  else
    matmul_os_kernel<T, O, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<O*>(c), m, n, k, scale, scale_mode, bias, act, residual);
  return launch_status();
}

template <typename T>
int launch_out(int out_dtype, const void* a, const void* b, void* c, int m,
               int n, int k, const float* scale, int scale_mode,
               const float* bias, int act, const float* residual,
               cudaStream_t stream) {
  if (out_dtype == REPRO_F32)
    return launch<T, float>(a, b, c, m, n, k, scale, scale_mode, bias, act,
                            residual, stream);
  if (out_dtype == REPRO_BF16)
    return launch<T, __nv_bfloat16>(a, b, c, m, n, k, scale, scale_mode, bias,
                                    act, residual, stream);
  return REPRO_BAD_ARGUMENT;
}

}  // namespace

extern "C" int matmul_os(const void* a, const void* b, void* c, int m, int n,
                         int k, int in_dtype, int out_dtype,
                         const float* scale, int scale_mode, const float* bias,
                         int act, const float* residual, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + BM - 1) / BM > 65535 ||
      scale_mode < SCALE_NONE || scale_mode > SCALE_ROW || act < ACT_NONE ||
      act > ACT_SILU || (scale_mode != SCALE_NONE && scale == nullptr))
    return REPRO_BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == REPRO_F32)
    return launch_out<float>(out_dtype, a, b, c, m, n, k, scale, scale_mode,
                             bias, act, residual, s);
  if (in_dtype == REPRO_BF16)
    return launch_out<__nv_bfloat16>(out_dtype, a, b, c, m, n, k, scale,
                                     scale_mode, bias, act, residual, s);
  return REPRO_BAD_ARGUMENT;
}
