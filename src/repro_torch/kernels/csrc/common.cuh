// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel library exposes a plain C interface (loaded with ctypes by
// repro_torch/kernels/_build.py): each entry point launches on the stream it
// is given, allocates nothing, and returns cudaGetLastError() (or
// REPRO_BAD_ARGUMENT for a shape or type it does not take) so the Python
// wrapper can raise right after the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Element types as the Python wrappers encode them.
#define REPRO_F32 0
#define REPRO_BF16 1
#define REPRO_I8 2
#define REPRO_I32 3

// Returned for an argument the kernel does not take (never a CUDA error).
#define REPRO_BAD_ARGUMENT 10000
// Returned when the card cannot place a thread-block cluster of the size a
// kernel chose (gemm_cluster.cuh).
#define REPRO_NO_CLUSTER 10001

// Finite stand-in for -inf in running softmax maxima, as the TPU kernels
// use: exp(NEG_INF - NEG_INF) stays 1 instead of NaN.
#define REPRO_NEG_INF (-1e30f)

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to(bf16)
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16-byte vectors of T, unpacked to floats (bf16 -> f32 is exact: the 16
// bits become the high half of the float).
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void unpack(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static __forceinline__ void unpack(const uint4& u, float* o) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Copies ROWS x COLS tiles of T from up to two row-major sources (row r at
// src + r * src_ld) into float tiles in shared memory (row r at
// dst + r * DST_LD), THREADS threads taking one 16-byte vector each per
// pass. Rows at or past valid_rows read as 0. Every load of the call is
// issued before the first store, so they are in flight together. COLS and
// src_ld must be multiples of the vector width and the sources 16-byte
// aligned (the Python wrappers check).
template <typename T, int ROWS, int COLS, int DST_LD0, int DST_LD1,
          int THREADS>
__device__ __forceinline__ void load_tiles(float* dst0, const T* src0,
                                           float* dst1, const T* src1,
                                           size_t src_ld, int valid_rows) {
  constexpr int V = Vec16<T>::N, VPR = COLS / V, TOTAL = ROWS * VPR;
  constexpr int ITERS = (TOTAL + THREADS - 1) / THREADS;
  static_assert(COLS % V == 0, "tile width must be whole 16-byte vectors");
  uint4 b0[ITERS], b1[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / VPR, c = (i % VPR) * V;
    const bool in = i < TOTAL && r < valid_rows;
    b0[it] = in ? *reinterpret_cast<const uint4*>(src0 + r * src_ld + c)
                : make_uint4(0u, 0u, 0u, 0u);
    if (src1)
      b1[it] = in ? *reinterpret_cast<const uint4*>(src1 + r * src_ld + c)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (i >= TOTAL) break;
    const int r = i / VPR, c = (i % VPR) * V;
    float v[V];
    Vec16<T>::unpack(b0[it], v);
#pragma unroll
    for (int j = 0; j < V; ++j) dst0[r * DST_LD0 + c + j] = v[j];
    if (src1) {
      Vec16<T>::unpack(b1[it], v);
#pragma unroll
      for (int j = 0; j < V; ++j) dst1[r * DST_LD1 + c + j] = v[j];
    }
  }
}

static inline int launch_status() { return (int)cudaGetLastError(); }

// Defined once per library: in the unit with its entry point, not in the
// units that only hold instantiations (-DREPRO_PART, kernels/_build.py).
#if !defined(REPRO_PART)
extern "C" const char* repro_error_string(int code) {
  if (code == REPRO_BAD_ARGUMENT) return "argument not supported by this kernel";
  if (code == REPRO_NO_CLUSTER)
    return "the card cannot place a thread-block cluster of this size and "
           "shared memory (cudaOccupancyMaxActiveClusters is 0)";
  return cudaGetErrorString((cudaError_t)code);
}
#endif
