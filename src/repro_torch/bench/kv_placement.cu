// Where the card places B7's bf16 cluster kernel (csrc/kv_stationary.cu
// `kv_cluster_kernel<128>`, qwen3-1.7b's head size): its registers a
// thread, and for cluster sizes C in {2, 4, 8, 16} at the library's shared
// memory (two CTAs an SM) and at twice it (one CTA an SM) how
// many clusters cudaOccupancyMaxActiveClusters places at once, and on how
// many SMs the 128 CTAs of 8 clusters of 16 (prefill at 8 kv heads) land,
// read from %smid by a kernel of the same shape that spins while all are
// resident. One JSON line per (shared memory, C). Build and run from the
// repo root:
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -o kv_placement src/repro_torch/bench/kv_placement.cu && ./kv_placement
#include <cstdio>
#include <set>

#include "../kernels/csrc/kv_stationary.cu"

namespace {

// Records the SM of each CTA, then spins `cycles` so every CTA of the grid
// is resident at once where the card can hold them.
__global__ void __launch_bounds__(KV_THREADS, 2) where(int* sm, long long cycles) {
  extern __shared__ unsigned char unused[];
  if (threadIdx.x == 0) {
    unsigned s;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
    sm[blockIdx.x] = (int)s;
    unused[0] = 1;
  }
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

}  // namespace

int main() {
  constexpr int CTAS = 128;
  auto kv = kv_cluster_kernel<128>;
  for (auto fn : {(const void*)kv, (const void*)where}) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 200000);
    cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, kv);
  int* sm;
  if (cudaMalloc(&sm, CTAS * sizeof(int)) != cudaSuccess) return 1;
  for (int smem : {(int)kv_cluster_smem<128>(), 2 * (int)kv_cluster_smem<128>()}) {
    for (int c : {2, 4, 8, 16}) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(CTAS);
      cfg.blockDim = dim3(KV_THREADS);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute cl[1];
      cl[0].id = cudaLaunchAttributeClusterDimension;
      cl[0].val.clusterDim.x = c;
      cl[0].val.clusterDim.y = 1;
      cl[0].val.clusterDim.z = 1;
      cfg.attrs = cl;
      cfg.numAttrs = 1;
      int placed = -1;
      if (cudaOccupancyMaxActiveClusters(&placed, kv, &cfg) != cudaSuccess) return 1;
      if (cudaLaunchKernelEx(&cfg, where, sm, 2000000LL) != cudaSuccess) return 1;
      int h[CTAS];
      if (cudaMemcpy(h, sm, sizeof h, cudaMemcpyDeviceToHost) != cudaSuccess) return 1;
      const std::set<int> sms(h, h + CTAS);
      printf("{\"bench\": \"kv_placement\", \"registers\": %d, \"smem_bytes\": %d, "
             "\"cluster\": %d, \"clusters_placed\": %d, \"ctas\": %d, \"sms_used\": %zu}\n",
             attr.numRegs, smem, c, placed, CTAS, sms.size());
    }
  }
  return 0;
}
