// The tiles, loads, k loop and epilogue shared by the port's GEMM kernels:
// B1 (matmul_os.cu, with its bf16 tensor-core tiles in gemm_tc.cuh), B4
// (matmul_rmw.cu), B5a (matmul_ws_stripe.cu) and B5b (matmul_is_stripe.cu).
//
// Every kernel computes C = act(scale * (A @ B) + bias) + residual with A
// (M, K) and B (K, N) row-major. Each output element is one f32 accumulator
// that starts at 0 and sums k in ascending order, k padded with zeros to a
// multiple of BK, and then takes the one epilogue below: whatever the
// dataflow, the grid, the tile or the other rows, an output element gets the
// same bits. The libraries are built with -fmad=false, so nothing outside
// the explicit fmaf is contracted and the epilogue rounds the same in every
// kernel.
//
// The k step depends on the input type:
// - bf16 operands run on the tensor cores: one mma.sync m16n8k16 (bf16 in,
//   f32 out) per 16-deep k chunk, in ascending k, each chunk summed from
//   zero and added to the f32 accumulator with one rounded add
//   (mma_common.cuh's mma_bf16_add).
//   The streamed tiles hold bf16, row-major, in the bytes the f32 tiles take;
//   the 8 warps of a CTA each own a 16 x 32 block of the 64 x 64 tile.
// - f32 operands take one fmaf per k on the CUDA cores (no TF32), each
//   thread a 4 x 4 block of the tile from f32 tiles in shared memory.
// - int8 operands take the integer k loop: the same tiles hold int32 values,
//   each output element is one int32 accumulator and every step is an
//   integer multiply-add, exact in any order. B is then either int8 (DenseB)
//   or the packed int4/int5 planes of repro_torch/kernels/pack.py (PackedB),
//   decoded at the load (pack_common.cuh, B6); the packed weight's outlier
//   rows are added to the accumulator at the flush (add_sidecar). The int32
//   result is written as it is when no epilogue stage is set, else converted
//   to f32 and put through the epilogue.
//
// A dataflow differs only in which operand a CTA holds in shared memory
// across its walk (resident) and which it streams through 64x32 / 32x64
// tiles, the next tile's loads in flight while the current one is consumed.
// Resident operands are kept in their own type (bf16 stays bf16, packed
// planes stay packed), zero-padded to whole BK steps, and converted (or, for
// bf16, gathered into tensor-core fragments) at each use.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma_common.cuh"
#include "pack_common.cuh"

namespace gemm {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int TILE_LD = BM + 4;                 // BM == BN: one stride for both
constexpr int TILE_FLOATS = BK * TILE_LD;       // elements (4 bytes each)
// Shared memory a block can use on Hopper (cudaFuncAttribute opt-in limit).
constexpr size_t MAX_SMEM = 232448;

// The bf16 tensor-core path of the 64 x 64 tile: A streamed row-major
// (BM x TA_LD), B row-major (BK x TB_LD), each row padded by 16 bytes so
// ldmatrix reads 8 rows from distinct banks; both fit in the bytes of one
// f32 tile.
template <typename T>
constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
constexpr int TA_LD = BK + 8, TB_LD = BN + 8;
static_assert(BM * TA_LD * 2 <= TILE_FLOATS * 4 && BK * TB_LD * 2 <= TILE_FLOATS * 4,
              "bf16 tiles must fit in the f32 tiles' bytes");

// Residency of the B operand in the walk kernels.
enum BRes { B_STREAMED = 0, B_STRIPE = 1, B_WHOLE = 2 };
// Which grid index a walk kernel's CTA owns: one tile (NONE), the column
// stripe j, walking i (M: the WS order), or the row stripe i, walking j (N).
enum Walk { WALK_NONE = 0, WALK_M = 1, WALK_N = 2 };

// Epilogue codes, as repro_torch/kernels/matmul_df.py encodes them.
enum ScaleMode { SCALE_NONE = 0, SCALE_TENSOR = 1, SCALE_COL = 2, SCALE_ROW = 3 };
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3 };

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return cdiv(a, b) * b; }

// The accumulator of an input type: f32 for f32 and bf16, int32 for int8.
template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<int8_t> {
  using type = int;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int widen(int8_t v) { return v; }

__device__ __forceinline__ float mac(float acc, float a, float b) { return fmaf(a, b, acc); }
__device__ __forceinline__ int mac(int acc, int a, int b) { return acc + a * b; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }

template <typename T>
__device__ __forceinline__ T tzero() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 tzero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

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

struct Epi {
  const float* scale;
  int scale_mode;
  const float* bias;
  int act;
  const float* residual;
  int out_dtype;  // REPRO_F32, REPRO_BF16, or REPRO_I32 (int8, no stage)
  // The packed weight's outlier sidecar: sr slots, slot s adding
  // A[row, sidx[s]] * sdelta[s, col] to the int32 accumulator at the flush;
  // a slot with sidx[s] outside [0, sk) is empty. A is sa (M, sk) int8.
  const int8_t* sa = nullptr;
  const int* sidx = nullptr;
  const int* sdelta = nullptr;
  int sr = 0;
  int sk = 0;
};

// The tile a GEMM launch took, reported to its caller (the entry points of
// matmul_os.cu, matmul_rmw.cu and matmul_ws_stripe.cu): TILE_WALK for the
// walk kernel, else the tile (the position of its name in the library's
// tuple of kernels/_build.py TILE_LIBRARIES, counting from 1), with its
// dynamic shared memory bytes, CTAs and, for a cluster walk
// (gemm_cluster.cuh), the CTAs of a cluster. The tile configurations of
// gemm_tc.cuh, gemm_tc_i8.cuh and gemm_cluster.cuh are the source of these
// numbers; the Python planner's copy is held against them at every launch.
enum TileCode { TILE_WALK = 0, TILE_PREFILL, TILE_DECODE, TILE_I8_PREFILL, TILE_I8_DECODE,
                TILE_OS_CLUSTER };
// matmul_rmw's and matmul_ws_stripe's one tile: their cluster walk.
constexpr int TILE_CLUSTER = 1;
struct Took {
  int tile = TILE_WALK;
  int smem = 0;
  int ctas = 0;
  int cluster = 0;
};

__device__ __forceinline__ float epilogue(float x, int r, int c, int n,
                                          const Epi& e) {
  if (e.scale_mode == SCALE_TENSOR) x *= e.scale[0];
  else if (e.scale_mode == SCALE_COL) x *= e.scale[c];
  else if (e.scale_mode == SCALE_ROW) x *= e.scale[r];
  if (e.bias) x += e.bias[c];
  x = activate(x, e.act);
  if (e.residual) x += e.residual[(size_t)r * n + c];
  return x;
}

// Thread (ty, tx) of a CTA owns rows ty*TM.. and columns tx*TN.. of a tile.
__device__ __forceinline__ int ty() { return threadIdx.x / (BN / TN); }
__device__ __forceinline__ int tx() { return threadIdx.x % (BN / TN); }

// On the tensor-core path warp w owns rows wrow().. (16) and columns
// wcol().. (32) of a tile: four 16 x 8 mma tiles, accumulator acc[i][j]
// holding register j of column tile i (mma_common.cuh's C layout).
__device__ __forceinline__ int wrow() { return (threadIdx.x >> 6) * 16; }
__device__ __forceinline__ int wcol() { return ((threadIdx.x >> 5) & 1) * 32; }

// The tile row and column of a thread's accumulator acc[i][j].
template <bool TC>
__device__ __forceinline__ int own_row(int i, int j) {
  if (TC) return wrow() + (tc::lane() >> 2) + (j >> 1) * 8;
  return ty() * TM + i;
}
template <bool TC>
__device__ __forceinline__ int own_col(int i, int j) {
  if (TC) return wcol() + i * 8 + (tc::lane() & 3) * 2 + (j & 1);
  return tx() * TN + j;
}

// The outlier rows of a packed weight, added to a thread's int32
// accumulators of the output tile at (row0, col0).
__device__ __forceinline__ void add_sidecar(int acc[TM][TN], int row0, int col0,
                                            int m, int n, const Epi& e) {
  for (int s = 0; s < e.sr; ++s) {
    const int col = e.sidx[s];
    if (col < 0 || col >= e.sk) continue;
    int av[TM], dv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + ty() * TM + i;
      av[i] = r < m ? e.sa[(size_t)r * e.sk + col] : 0;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cc = col0 + tx() * TN + j;
      dv[j] = cc < n ? e.sdelta[(size_t)s * n + cc] : 0;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * dv[j];
  }
}
__device__ __forceinline__ void add_sidecar(float (*)[TN], int, int, int, int,
                                            const Epi&) {}

// Runs the epilogue on one output element and writes it, in the element type
// e.out_dtype names.
__device__ __forceinline__ void store_one(void* c, float acc, int r, int cc,
                                          int n, const Epi& e) {
  const float x = epilogue(acc, r, cc, n, e);
  const size_t at = (size_t)r * n + cc;
  if (e.out_dtype == REPRO_BF16) store_f32(static_cast<__nv_bfloat16*>(c) + at, x);
  else store_f32(static_cast<float*>(c) + at, x);
}

// Runs the epilogue on a thread's accumulators (after the sidecar) and writes
// the ones inside the (m, n) output. TC: the tensor-core ownership.
template <bool TC = false, typename Acc>
__device__ __forceinline__ void store_tile(void* c, Acc acc[TM][TN], int row0,
                                           int col0, int m, int n, const Epi& e) {
  add_sidecar(acc, row0, col0, m, n, e);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = row0 + own_row<TC>(i, j), cc = col0 + own_col<TC>(i, j);
      if (r >= m || cc >= n) continue;
      if constexpr (std::is_same<Acc, int>::value) {
        if (e.out_dtype == REPRO_I32) {
          static_cast<int*>(c)[(size_t)r * n + cc] = acc[i][j];
          continue;
        }
      }
      store_one(c, to_float(acc[i][j]), r, cc, n, e);
    }
  }
}

// Global -> register -> shared staging of one operand element group:
// 16-byte vectors when the rows allow it (VEC, float and bf16 only), single
// elements otherwise, widened to the accumulator type.
template <typename T, bool VEC>
struct TileIO;

template <typename T>
struct TileIO<T, true> {
  static_assert(!std::is_same<T, int8_t>::value, "int8 loads are elementwise");
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
  using Reg = typename AccOf<T>::type;
  __device__ static __forceinline__ Reg load(const T* p, bool in) {
    return in ? widen(*p) : Reg(0);
  }
  __device__ static __forceinline__ void unpack(const Reg& r, Reg* o) { o[0] = r; }
};

// A streamed BM x BK tile of A, stored k-major in shared memory.
template <typename T, bool VEC>
struct ATile {
  using IO = TileIO<T, VEC>;
  using Acc = typename AccOf<T>::type;
  static constexpr int V = IO::V, VPR = BK / V, IT = BM * VPR / THREADS;
  typename IO::Reg r[IT];

  __device__ __forceinline__ void fetch(const T* a, int m, int k, int row0,
                                        int k0) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int gr = row0 + i / VPR, gk = k0 + (i % VPR) * V;
      r[it] = IO::load(a + (size_t)gr * k + gk, gr < m && gk < k);
    }
  }
  __device__ __forceinline__ void stash(Acc* as) const {
    Acc v[V];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = threadIdx.x + it * THREADS;
      IO::unpack(r[it], v);
#pragma unroll
      for (int j = 0; j < V; ++j) as[((i % VPR) * V + j) * TILE_LD + i / VPR] = v[j];
    }
  }
};

// A streamed BK x BN tile of a dense B.
template <typename T, bool VEC>
struct BTile {
  using IO = TileIO<T, VEC>;
  using Acc = typename AccOf<T>::type;
  static constexpr int V = IO::V, VPR = BN / V, IT = BK * VPR / THREADS;
  typename IO::Reg r[IT];

  __device__ __forceinline__ void fetch(const T* b, int k, int n, int k0,
                                        int col0) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int gk = k0 + i / VPR, gc = col0 + (i % VPR) * V;
      r[it] = IO::load(b + (size_t)gk * n + gc, gk < k && gc < n);
    }
  }
  __device__ __forceinline__ void stash(Acc* bs) const {
    Acc v[V];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = threadIdx.x + it * THREADS;
      IO::unpack(r[it], v);
#pragma unroll
      for (int j = 0; j < V; ++j) bs[(i / VPR) * TILE_LD + (i % VPR) * V + j] = v[j];
    }
  }
};

// A streamed bf16 tile kept as bf16 bits for the tensor cores: ROWS x COLS
// elements from (rows r0.., columns c0..) of a row-major source with ld
// columns and (rows, cols) valid, stored row-major at stride LD; 16-byte
// vectors when VEC, single elements otherwise, zeros outside.
template <bool VEC, int ROWS, int COLS, int LD>
struct HTile {
  static constexpr int V = VEC ? 8 : 1, VPR = COLS / V,
                       IT = ROWS * VPR / THREADS;
  using Reg = typename std::conditional<VEC, uint4, uint16_t>::type;
  Reg r[IT];

  __device__ __forceinline__ void fetch(const __nv_bfloat16* p, int ld,
                                        int rows, int cols, int r0, int c0) {
    const uint16_t* src = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int gr = r0 + i / VPR, gc = c0 + (i % VPR) * V;
      const bool in = gr < rows && gc < cols;
      if constexpr (VEC)
        r[it] = in ? *reinterpret_cast<const uint4*>(src + (size_t)gr * ld + gc)
                   : make_uint4(0u, 0u, 0u, 0u);
      else
        r[it] = in ? src[(size_t)gr * ld + gc] : uint16_t(0);
    }
  }
  __device__ __forceinline__ void stash(void* dst) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = threadIdx.x + it * THREADS;
      *reinterpret_cast<Reg*>(static_cast<uint16_t*>(dst) + (i / VPR) * LD +
                              (i % VPR) * V) = r[it];
    }
  }
};

// One BK step of a warp's 16 x 32 block on the tensor cores: afrag(kc, a)
// gives its A fragment at depth kc of the step, bfrag(kc, c0, b) the B
// fragment of the 8 tile columns c0... Each accumulator adds the step's two
// 16-deep chunks in order.
template <class AFrag, class BFrag>
__device__ __forceinline__ void mma_step_tc(float acc[TM][TN], AFrag afrag,
                                            BFrag bfrag) {
#pragma unroll
  for (int kc = 0; kc < BK; kc += 16) {
    uint32_t a[4];
    afrag(kc, a);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      uint32_t b[2];
      bfrag(kc, wcol() + i * 8, b);
      tc::mma_bf16_add(acc[i], a, b);
    }
  }
}

// Fragments of the streamed bf16 tiles of one step.
__device__ __forceinline__ auto streamed_afrag(const void* as) {
  return [as](int kc, uint32_t* a) {
    tc::frag_a_rowmajor(a, static_cast<const __nv_bfloat16*>(as), TA_LD, wrow(), kc);
  };
}
__device__ __forceinline__ auto streamed_bfrag(const void* bs) {
  return [bs](int kc, int c0, uint32_t* b) {
    tc::frag_b_rowmajor(b, static_cast<const __nv_bfloat16*>(bs), TB_LD, kc, c0);
  };
}

// A resident A row stripe: rows row0.. (ra of them) x all kp (>= k) columns,
// stored k-major (ares[kk * ra + r]), zero past m and k.
template <typename T>
__device__ __forceinline__ void load_a_stripe(T* ares, const T* a, int m,
                                              int k, int kp, int row0, int ra) {
  for (int i = threadIdx.x; i < ra * kp; i += THREADS) {
    const int r = i / kp, kk = i % kp;
    ares[kk * ra + r] =
        (row0 + r < m && kk < k) ? a[(size_t)(row0 + r) * k + kk] : tzero<T>();
  }
}

// The B operands. Each gives its accumulator type, its streamed tile
// (fetch/stash), and its resident panel of kp rows x `width` columns: bytes,
// load (zero past k and n) and the value at (row kk, column c).
//
// DenseB: B (k, n) row-major T.
template <typename T, bool VEC>
struct DenseB {
  using Acc = typename AccOf<T>::type;
  const T* p;

  struct Tile {
    BTile<T, VEC> t;
    __device__ __forceinline__ void fetch(const DenseB& b, int k, int n, int k0,
                                          int col0) {
      t.fetch(b.p, k, n, k0, col0);
    }
    __device__ __forceinline__ void stash(Acc* bs) const { t.stash(bs); }
  };

  __host__ __device__ static constexpr size_t panel_bytes(int kp, int width) {
    return (size_t)kp * width * sizeof(T);
  }
  __device__ __forceinline__ void load_panel(void* dst, int k, int n, int kp,
                                             int col0, int width) const {
    T* res = static_cast<T*>(dst);
    for (int i = threadIdx.x; i < kp * width; i += THREADS) {
      const int kk = i / width, c = i % width;
      res[i] = (kk < k && col0 + c < n) ? p[(size_t)kk * n + col0 + c] : tzero<T>();
    }
  }
  __device__ static __forceinline__ Acc at(const void* panel, int kk, int c,
                                           int width, int) {
    return widen(static_cast<const T*>(panel)[(size_t)kk * width + c]);
  }
};

// PackedB: the int4/int5 planes of an int8 B, (kp/8, n) nibble words and
// (kp/32, n) bit-plane words (BITS == 5), kp = round_up(k, BK) rows; decoded
// at each tile load, and kept packed when resident.
template <int BITS>
struct PackedB {
  using Acc = int;
  const uint32_t* codes;
  const uint32_t* hi;

  struct Tile {
    pack::Tile<BITS, BN, THREADS, TILE_LD> t;
    __device__ __forceinline__ void fetch(const PackedB& b, int, int n, int k0,
                                          int col0) {
      t.fetch(b.codes, b.hi, n, n, k0, col0);
    }
    __device__ __forceinline__ void stash(int* bs) const { t.stash(bs); }
  };

  __host__ __device__ static constexpr size_t panel_bytes(int kp, int width) {
    return pack::panel_bytes<BITS>(kp, width);
  }
  __device__ __forceinline__ void load_panel(void* dst, int, int n, int kp,
                                             int col0, int width) const {
    pack::load_panel<BITS, THREADS>(static_cast<uint32_t*>(dst), codes, hi, n,
                                    kp, col0, width, n);
  }
  __device__ static __forceinline__ int at(const void* panel, int kk, int c,
                                           int width, int kp) {
    return pack::panel_at<BITS>(static_cast<const uint32_t*>(panel), kk, c,
                                width, kp);
  }
};

// One BK step of a thread's TM x TN accumulators: a_at(kk, i) and b_at(kk, j)
// give its A row i and B column j at depth kk of the step.
template <typename Acc, class AAt, class BAt>
__device__ __forceinline__ void mma_step(Acc acc[TM][TN], AAt a_at, BAt b_at) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    Acc av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a_at(kk, i);
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b_at(kk, j);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = mac(acc[i][j], av[i], bv[j]);
  }
}

// tile_kloop's f32 and integer path on the CUDA cores.
template <typename T, bool VEC, class B, bool A_RES, bool B_RES>
__device__ __forceinline__ void tile_kloop_cores(
    typename B::Acc acc[TM][TN], const T* a, const B& b, int m, int n, int k,
    int row0, int col0, typename B::Acc* as, typename B::Acc* bs,
    const T* ares, int ra, const void* bres, int ldb, int bcol) {
  using Acc = typename B::Acc;
  ATile<T, VEC> at;
  typename B::Tile bt;
  const int kp = round_up(k, BK);
  const int ar = ty() * TM;
  const bool a_rows = ar < ra;  // ra is a multiple of TM
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);
  if (!A_RES) at.fetch(a, m, k, row0, 0);
  if (!B_RES) bt.fetch(b, k, n, 0, col0);
  if (!A_RES) at.stash(as);
  if (!B_RES) bt.stash(bs);
  __syncthreads();
  for (int k0 = 0; k0 < kp; k0 += BK) {
    const bool more = k0 + BK < kp;
    if (more) {  // in flight while this step is consumed
      if (!A_RES) at.fetch(a, m, k, row0, k0 + BK);
      if (!B_RES) bt.fetch(b, k, n, k0 + BK, col0);
    }
    auto a_at = [&](int kk, int i) -> Acc {
      if (A_RES) return a_rows ? widen(ares[(k0 + kk) * ra + ar + i]) : Acc(0);
      return as[kk * TILE_LD + ar + i];
    };
    auto b_at = [&](int kk, int j) -> Acc {
      if (B_RES) return B::at(bres, k0 + kk, bcol + tx() * TN + j, ldb, kp);
      return bs[kk * TILE_LD + tx() * TN + j];
    };
    mma_step(acc, a_at, b_at);
    __syncthreads();
    if (more && !(A_RES && B_RES)) {
      if (!A_RES) at.stash(as);
      if (!B_RES) bt.stash(bs);
      __syncthreads();
    }
  }
}

// tile_kloop's bf16 path: the tiles hold bf16 bits and each BK step is
// mma_step_tc; resident operands are gathered into fragments.
template <bool VEC, bool A_RES, bool B_RES>
__device__ __forceinline__ void tile_kloop_tc(float acc[TM][TN],
                                              const __nv_bfloat16* a,
                                              const __nv_bfloat16* b, int m,
                                              int n, int k, int row0, int col0,
                                              void* as, void* bs,
                                              const __nv_bfloat16* ares, int ra,
                                              const void* bres, int ldb,
                                              int bcol) {
  HTile<VEC, BM, BK, TA_LD> at;
  HTile<VEC, BK, BN, TB_LD> bt;
  const int kp = round_up(k, BK);
  const uint16_t* ah = reinterpret_cast<const uint16_t*>(ares);
  const uint16_t* bh = static_cast<const uint16_t*>(bres);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  if (!A_RES) at.fetch(a, k, m, k, row0, 0);
  if (!B_RES) bt.fetch(b, n, k, n, 0, col0);
  if (!A_RES) at.stash(as);
  if (!B_RES) bt.stash(bs);
  __syncthreads();
  for (int k0 = 0; k0 < kp; k0 += BK) {
    const bool more = k0 + BK < kp;
    if (more) {  // in flight while this step is consumed
      if (!A_RES) at.fetch(a, k, m, k, row0, k0 + BK);
      if (!B_RES) bt.fetch(b, n, k, n, k0 + BK, col0);
    }
    auto afrag = [&](int kc, uint32_t* f) {
      if constexpr (A_RES)
        tc::frag_a_gather(
            f,
            [&](int kk, int r) -> uint16_t {
              return r < ra ? ah[(size_t)(k0 + kk) * ra + r] : uint16_t(0);
            },
            wrow(), kc);
      else
        tc::frag_a_rowmajor(f, static_cast<const __nv_bfloat16*>(as), TA_LD,
                            wrow(), kc);
    };
    auto bfrag = [&](int kc, int c0, uint32_t* f) {
      if constexpr (B_RES)
        tc::frag_b_gather(
            f,
            [&](int kk, int c) -> uint16_t {
              return bh[(size_t)(k0 + kk) * ldb + bcol + c];
            },
            kc, c0);
      else
        tc::frag_b_rowmajor(f, static_cast<const __nv_bfloat16*>(bs), TB_LD,
                            kc, c0);
    };
    mma_step_tc(acc, afrag, bfrag);
    __syncthreads();
    if (more && !(A_RES && B_RES)) {
      if (!A_RES) at.stash(as);
      if (!B_RES) bt.stash(bs);
      __syncthreads();
    }
  }
}

// The whole k loop of the output tile at (row0, col0), into acc. A comes from
// the streamed tile `as` or, when A_RES, from the resident stripe ares (ra
// rows, k-major); B from the streamed tile `bs` or, when B_RES, from the
// resident panel bres (ldb columns, the tile's columns at bcol). Ends with a
// barrier, so the caller may refill the tiles right after.
template <typename T, bool VEC, class B, bool A_RES, bool B_RES>
__device__ __forceinline__ void tile_kloop(typename B::Acc acc[TM][TN],
                                           const T* a, const B& b, int m, int n,
                                           int k, int row0, int col0,
                                           typename B::Acc* as,
                                           typename B::Acc* bs, const T* ares,
                                           int ra, const void* bres, int ldb,
                                           int bcol) {
  if constexpr (kTC<T>) {
    tile_kloop_tc<VEC, A_RES, B_RES>(acc, a, b.p, m, n, k, row0, col0, as, bs,
                                     ares, ra, bres, ldb, bcol);
  } else {
    tile_kloop_cores<T, VEC, B, A_RES, B_RES>(acc, a, b, m, n, k, row0, col0,
                                              as, bs, ares, ra, bres, ldb, bcol);
  }
}

// Shared memory of a walk kernel, in bytes: the streamed tiles it needs, its
// resident A stripe (ra rows) and its resident B panel. The Python planner
// (matmul_df.plan) computes the same sum.
template <typename T, class B>
__host__ __device__ constexpr size_t walk_smem(bool a_res, int b_res, int kp,
                                               int ra, int np) {
  return (a_res ? 0 : TILE_FLOATS * 4) + (b_res ? 0 : TILE_FLOATS * 4) +
         (a_res ? (size_t)kp * ra * sizeof(T) : 0) +
         (b_res == B_STRIPE ? B::panel_bytes(kp, BN)
                            : b_res == B_WHOLE ? B::panel_bytes(kp, np) : 0);
}

// The walk kernel behind B1 and B4. WALK_NONE: one output tile per CTA,
// nothing resident (basic OS). WALK_M: CTA j holds B's column stripe (K, BN)
// (B_STRIPE) and walks the row tiles i in order, loading A's row stripe per
// i when A_RES (the WS order, grid (gn, gm, gk)). WALK_N: CTA i holds A's row
// stripe when A_RES, and B whole when B_WHOLE, and walks the column tiles j
// (the IS order, grid (gm, gn, gk)). Each output tile's accumulators stay in
// registers across its whole k loop and are written once, after the epilogue.
template <typename T, bool VEC, class B, int WALK, bool A_RES, int B_RES>
__global__ void __launch_bounds__(THREADS)
walk_kernel(const T* __restrict__ a, B b, void* __restrict__ c, int m, int n,
            int k, Epi e) {
  using Acc = typename B::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  // The basic walk's tiles are static shared memory: the same kernel with
  // them in dynamic shared memory measured 3% slower at M = 512 (PERF.md).
  __shared__ __align__(16) Acc basic_as[WALK == WALK_NONE ? TILE_FLOATS : 1];
  __shared__ __align__(16) Acc basic_bs[WALK == WALK_NONE ? TILE_FLOATS : 1];
  Acc* as = WALK == WALK_NONE ? basic_as : reinterpret_cast<Acc*>(smem);
  Acc* bs = WALK == WALK_NONE ? basic_bs : as + (A_RES ? 0 : TILE_FLOATS);
  T* ares = reinterpret_cast<T*>(bs + (B_RES ? 0 : TILE_FLOATS));
  const int kp = round_up(k, BK), gm = cdiv(m, BM), gn = cdiv(n, BN);
  const int ra = min(BM, round_up(m, TM)), np = gn * BN;
  // kp * ra is a multiple of 128, so the panel stays 16-byte aligned.
  void* bres = ares + (A_RES ? kp * ra : 0);
  const int ldb = B_RES == B_WHOLE ? np : BN;
  Acc acc[TM][TN];

  if (B_RES == B_WHOLE) {
    b.load_panel(bres, k, n, kp, 0, np);
    __syncthreads();
  }
  if (WALK == WALK_NONE) {
    const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
    tile_kloop<T, VEC, B, A_RES, B_RES != B_STREAMED>(
        acc, a, b, m, n, k, row0, col0, as, bs, ares, ra, bres, ldb, col0);
    store_tile<kTC<T>>(c, acc, row0, col0, m, n, e);
  } else if (WALK == WALK_M) {
    const int col0 = blockIdx.x * BN;
    if (B_RES == B_STRIPE) {
      b.load_panel(bres, k, n, kp, col0, BN);
      __syncthreads();
    }
    for (int i = 0; i < gm; ++i) {
      if (A_RES) {
        load_a_stripe(ares, a, m, k, kp, i * BM, ra);
        __syncthreads();
      }
      tile_kloop<T, VEC, B, A_RES, B_RES != B_STREAMED>(
          acc, a, b, m, n, k, i * BM, col0, as, bs, ares, ra, bres, ldb,
          B_RES == B_WHOLE ? col0 : 0);
      store_tile<kTC<T>>(c, acc, i * BM, col0, m, n, e);
    }
  } else {
    const int row0 = blockIdx.x * BM;
    if (A_RES) {
      load_a_stripe(ares, a, m, k, kp, row0, ra);
      __syncthreads();
    }
    for (int j = 0; j < gn; ++j) {
      tile_kloop<T, VEC, B, A_RES, B_RES != B_STREAMED>(
          acc, a, b, m, n, k, row0, j * BN, as, bs, ares, ra, bres, ldb, j * BN);
      store_tile<kTC<T>>(c, acc, row0, j * BN, m, n, e);
    }
  }
}

// Whether the streamed loads may take 16-byte vectors (float and bf16).
template <typename T>
bool vec_ok(const void* a, const void* b, int n, int k) {
  if constexpr (std::is_same<T, int8_t>::value) {
    return false;
  } else {
    constexpr int V = Vec16<T>::N;
    return k % V == 0 && n % V == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(b) % 16 == 0;
  }
}

// Calls F::template run<B, VEC>() with the B operand of input type T and
// weight bits WB (0: a dense B of T; 4, 5: packed planes under an int8 A).
template <typename T, int WB, class F>
int with_b(const void* b, const void* b_hi, bool vec, F f) {
  if constexpr (WB != 0) {
    static_assert(std::is_same<T, int8_t>::value, "packed B needs int8 A");
    return f(PackedB<WB>{static_cast<const uint32_t*>(b),
                         static_cast<const uint32_t*>(b_hi)},
             std::false_type());
  } else if constexpr (std::is_same<T, int8_t>::value) {
    return f(DenseB<T, false>{static_cast<const T*>(b)}, std::false_type());
  } else {
    if (vec) return f(DenseB<T, true>{static_cast<const T*>(b)}, std::true_type());
    return f(DenseB<T, false>{static_cast<const T*>(b)}, std::false_type());
  }
}

// Launches `kernel` with `smem` bytes of dynamic shared memory, opting in
// above the 48 KB default; refuses what no Hopper block can hold.
template <typename T, typename K, class B>
int launch_with_smem(K kernel, dim3 grid, size_t smem, cudaStream_t stream,
                     const void* a, const B& b, void* c, int m, int n, int k,
                     const Epi& e) {
  if (smem > MAX_SMEM) return REPRO_BAD_ARGUMENT;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(a), b, c, m, n,
                                          k, e);
  return launch_status();
}

// Launches the walk kernel of one dataflow: grid (gn, gm) of single tiles
// for WALK_NONE, gn column-stripe CTAs for WALK_M, gm row-stripe CTAs for
// WALK_N. Each library compiles its instantiations in several translation
// units at once (-DREPRO_PART, kernels/_build.py): the entry point's unit
// declares them with GEMM_WALK_EXTERN, each part defines some with
// GEMM_WALK_DEFINE.
template <typename T, int WB, int WALK, bool A_RES, int B_RES>
int launch_walk(const void* a, const void* b, const void* b_hi, void* c, int m,
                int n, int k, const Epi& e, cudaStream_t stream) {
  const int kp = round_up(k, BK), gm = cdiv(m, BM), gn = cdiv(n, BN);
  const int ra = min(BM, round_up(m, TM));
  const dim3 grid = WALK == WALK_NONE ? dim3(gn, gm)
                    : WALK == WALK_M  ? dim3(gn)
                                      : dim3(gm);
  return with_b<T, WB>(b, b_hi, vec_ok<T>(a, b, n, k), [&](auto bop, auto vec) {
    using B = decltype(bop);
    const size_t smem =
        WALK == WALK_NONE ? 0 : walk_smem<T, B>(A_RES, B_RES, kp, ra, gn * BN);
    return launch_with_smem<T>(walk_kernel<T, decltype(vec)::value, B, WALK,
                                           A_RES, B_RES>,
                               grid, smem, stream, a, bop, c, m, n, k, e);
  });
}

#define GEMM_WALK_SIGNATURE(T, WB, WALK, A_RES, B_RES)                           \
  int launch_walk<T, WB, WALK, A_RES, B_RES>(const void*, const void*,          \
                                             const void*, void*, int, int, int, \
                                             const Epi&, cudaStream_t)
#define GEMM_WALK_EXTERN(T, WB, WALK, A_RES, B_RES) \
  extern template GEMM_WALK_SIGNATURE(T, WB, WALK, A_RES, B_RES);
#define GEMM_WALK_DEFINE(T, WB, WALK, A_RES, B_RES) \
  template GEMM_WALK_SIGNATURE(T, WB, WALK, A_RES, B_RES);

// The argument checks every GEMM entry point shares. int8 inputs take an
// int8 B or, with weight_bits 4 or 5, packed planes (the bit plane at 5
// bits) and an outlier sidecar; their output is int32 only when no epilogue
// stage is set.
inline bool bad_args(int m, int n, int k, int in_dtype, int out_dtype,
                     int scale_mode, const float* scale, const float* bias,
                     int act, const float* residual, int weight_bits,
                     const void* b_hi, const int* sidx, const int* sdelta,
                     int sr) {
  const bool int_in = in_dtype == REPRO_I8;
  const bool stages = scale_mode != SCALE_NONE || bias || act != ACT_NONE || residual;
  return m <= 0 || n <= 0 || k <= 0 || cdiv(m, BM) > 65535 ||
         cdiv(n, BN) > 65535 ||
         (in_dtype != REPRO_F32 && in_dtype != REPRO_BF16 && !int_in) ||
         !(out_dtype == REPRO_F32 || out_dtype == REPRO_BF16 ||
           (int_in && !stages && out_dtype == REPRO_I32)) ||
         scale_mode < SCALE_NONE || scale_mode > SCALE_ROW || act < ACT_NONE ||
         act > ACT_SILU || (scale_mode != SCALE_NONE && scale == nullptr) ||
         (weight_bits != 0 && weight_bits != 4 && weight_bits != 5) ||
         (weight_bits != 0 && !int_in) || (weight_bits == 5 && !b_hi) ||
         sr < 0 || (sr > 0 && (weight_bits == 0 || !sidx || !sdelta));
}

}  // namespace gemm

// Expands to the body of an entry point that calls LAUNCH<T, WB>(args...)
// for the input element type in_dtype and the weight_bits (checked by
// bad_args).
#define GEMM_DISPATCH_DTYPES(LAUNCH, ...)                                    \
  do {                                                                       \
    if (in_dtype == REPRO_F32) return LAUNCH<float, 0>(__VA_ARGS__);         \
    if (in_dtype == REPRO_BF16) return LAUNCH<__nv_bfloat16, 0>(__VA_ARGS__); \
    if (weight_bits == 4) return LAUNCH<int8_t, 4>(__VA_ARGS__);             \
    if (weight_bits == 5) return LAUNCH<int8_t, 5>(__VA_ARGS__);             \
    return LAUNCH<int8_t, 0>(__VA_ARGS__);                                   \
  } while (0)

// The epilogue and sidecar of a GEMM entry point's arguments.
#define GEMM_EPI(A)                                                          \
  gemm::Epi {                                                                \
    scale, scale_mode, bias, act, residual, out_dtype,                       \
        static_cast<const int8_t*>(A), sidx, sdelta, sr, k                   \
  }
