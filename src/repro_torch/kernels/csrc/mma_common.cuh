// Hopper tensor-core building blocks shared by the bf16 GEMM tiles
// (gemm_common.cuh, gemm_tc.cuh), the int8 GEMM tiles (gemm_tc_i8.cuh), the
// binary GEMM tiles (binary_mm.cu) and the bf16 attention tiles
// (flash_tc.cuh): the warp-level mma.sync m16n8k16 product with f32
// accumulators, m16n8k32 and m16n8k256 (b1) with s32 ones,
// ldmatrix fragment loads from shared memory, and cp.async copies from
// device memory into shared memory.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * g + t):
//   A (16 x 16, row-major): a[0] = (row g, k 2t..2t+1), a[1] = (g + 8, 2t..),
//     a[2] = (g, 2t + 8..), a[3] = (g + 8, 2t + 8..); each register two bf16,
//     the lower k in the low half.
//   B (16 x 8, k x n): b[0] = (k 2t..2t+1, col g), b[1] = (k 2t + 8.., g).
//   C (16 x 8, f32): c[0..1] = (row g, cols 2t, 2t + 1), c[2..3] = (g + 8, ..).
// Each output element of one mma depends only on its A row, its B column and
// its own accumulator, so a kernel that feeds every element the same 16-deep
// k chunks in the same order gets the same bits whatever its tile shape.
//
// The tensor cores sum a chunk's products and the accumulator they are given
// with their own alignment and rounding, less exact than an f32 add. The
// GEMMs therefore take each chunk from a zero accumulator and add it to the
// running f32 sum with one rounded add (mma_bf16_add): on an H100 at
// K = 6144, chaining the running sum through the mma put B1 3.5e-5 from its
// float32 plain version, taking each chunk from zero 3.1e-6.
#pragma once

#include "common.cuh"

namespace tc {

__device__ __forceinline__ int lane() { return threadIdx.x & 31; }

// acc += A(16x16) * B(16x8), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A(16x16) * B(16x8): the chunk summed from zero on the tensor cores,
// then added to acc with one f32 add (round to nearest) per element.
__device__ __forceinline__ void mma_bf16_add(float acc[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, a, b);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = __fadd_rn(acc[j], t[j]);
}

// acc += A(16x32) * B(32x8), s8 operands, s32 accumulators: the int8 GEMM
// tiles (gemm_tc_i8.cuh). Fragment layout of m16n8k32 (lane = 4 * g + t),
// each register four s8 values, the lowest k in the low byte:
//   A (16 x 32, row-major): a[0] = (row g, k 4t..4t+3), a[1] = (g + 8, ..),
//     a[2] = (g, 16 + 4t..), a[3] = (g + 8, 16 + 4t..).
//   B (32 x 8, k x n): b[0] = (k 4t..4t+3, col g), b[1] = (k 16 + 4t.., g).
//   C (16 x 8, s32): as the bf16 product's.
// Integer sums are exact, so any k order gives the same result: the tiles
// feed lane t physical k 8t..8t+7 of each 32-deep chunk (a[0]/a[1]/b[0]
// rows 8t..8t+3, a[2]/a[3]/b[1] rows 8t+4..8t+7), A and B alike.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += popc(A(16x256) AND B(256x8)), b1 operands (32 to a register),
// s32 accumulators: the binary GEMM tiles (binary_mm.cu). Fragment layout of
// m16n8k256 .b1 (lane = 4 * g + t; PTX ISA, "Matrix Fragments for mma.m16n8k256"):
//   A (16 x 256, row-major): a[0] = (row g, k 32t..32t+31), a[1] = (g + 8, ..),
//     a[2] = (g, 128 + 32t..), a[3] = (g + 8, 128 + 32t..): with 8 packed
//     words a row per 256-deep step, a[0] is word t of row g and a[2] word
//     4 + t, which is what ldmatrix.x4 gives from a row-major word tile.
//   B (256 x 8, k x n): b[0] = (k 32t.., col g), b[1] = (k 128 + 32t.., g):
//     words t and 4 + t of column g.
//   C (16 x 8, s32): as the bf16 product's.
// The AND form is the one sm_90a has in hardware (BMMA.168256.AND.POPC;
// ptxas lowers .xor.popc to it, slower: binary_mm.cu). Integer counts are
// exact, so popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b) gives the XOR
// count's bits.
__device__ __forceinline__ void mma_b1_and(int c[4], const uint32_t a[4],
                                           const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row (l % 8) of matrix
// l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// The same from a 32-bit shared memory address: kernels that keep their
// tiles as such addresses compute them once, since turning a generic pointer
// into one reads the cluster's special registers each time in a cluster.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// The A fragment of rows r0..r0+15, k k0..k0+15 of a row-major bf16 tile in
// shared memory (ld elements a row, rows 16-byte aligned).
__device__ __forceinline__ void frag_a_rowmajor(uint32_t a[4],
                                                const __nv_bfloat16* s, int ld,
                                                int r0, int k0) {
  const int l = lane();
  ldmatrix_x4(a, s + (size_t)(r0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + k0 +
                     (l >> 4) * 8);
}

// The B fragments of two 8-column tiles (c0.., c0 + 8..), k k0..k0+15, of a
// row-major (k rows x n columns) bf16 tile in shared memory: b0 for columns
// c0.., b1 for c0 + 8...
__device__ __forceinline__ void frag_b2_rowmajor(uint32_t b0[2], uint32_t b1[2],
                                                 const __nv_bfloat16* s, int ld,
                                                 int k0, int c0) {
  const int l = lane();
  uint32_t r[4];
  ldmatrix_x4_trans(r, s + (size_t)(k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld +
                           c0 + (l >> 4) * 8);
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

// The B fragment of one 8-column tile of a row-major (k x n) tile.
__device__ __forceinline__ void frag_b_rowmajor(uint32_t b[2],
                                                const __nv_bfloat16* s, int ld,
                                                int k0, int c0) {
  const int l = lane();
  ldmatrix_x2_trans(b, s + (size_t)(k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + c0);
}

// Two bf16 bit patterns in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}
__device__ __forceinline__ uint32_t pack2_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// The two bf16 halves of a register, as floats (exact).
__device__ __forceinline__ float lo_half(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float hi_half(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// Fragments gathered element by element through el(k, i) (bf16 bits of A at
// depth k, row i; or of B at depth k, column i): for operands held in shared
// memory in another layout (resident stripes and panels).
template <class El>
__device__ __forceinline__ void frag_a_gather(uint32_t a[4], El el, int r0,
                                              int k0) {
  const int g = lane() >> 2, t = lane() & 3, k = k0 + 2 * t;
  a[0] = pack2(el(k, r0 + g), el(k + 1, r0 + g));
  a[1] = pack2(el(k, r0 + g + 8), el(k + 1, r0 + g + 8));
  a[2] = pack2(el(k + 8, r0 + g), el(k + 9, r0 + g));
  a[3] = pack2(el(k + 8, r0 + g + 8), el(k + 9, r0 + g + 8));
}
template <class El>
__device__ __forceinline__ void frag_b_gather(uint32_t b[2], El el, int k0,
                                              int c0) {
  const int g = lane() >> 2, t = lane() & 3, k = k0 + 2 * t;
  b[0] = pack2(el(k, c0 + g), el(k + 1, c0 + g));
  b[1] = pack2(el(k + 8, c0 + g), el(k + 9, c0 + g));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !in
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tc
