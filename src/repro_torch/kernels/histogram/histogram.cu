// Fused bin-count for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/histogram/kernel.py
// (_hist_kernel / histogram). The TPU kernel is scatter-free: it compares
// each CHUNK of indices with a bin iota and keeps the (k,) output block
// resident across its sequential grid. Hopper has fast shared-memory
// atomics and no sequential grid, so each block keeps a privatized
// histogram in shared memory (int32 counts, shared atomics), then merges
// its non-zero bins into the global counts with one global atomic each.
// Bin counts above kSmemMaxBins do not fit a block's shared memory
// (2^16 bins x 4 B = 256 KB > 227 KB), and take the global-atomics
// variant. Counts are int32 and converted to float32 once, so the result
// equals the float32 reference exactly while counts stay below 2^24.
//
// Bound: bytes. Each index is read once (4 B) and each bin written once;
// the work is one increment per index.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItemsPerThread = 16;
// 57,344 int32 bins = 229,376 B of the 232,448 B a block may use
constexpr int kSmemMaxBins = 56 * 1024;

__global__ void hist_shared(const int32_t* __restrict__ idx, int64_t n,
                            int nbins, int32_t* __restrict__ counts) {
  extern __shared__ int32_t local[];
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) local[b] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t v = idx[i];
    if ((uint32_t)v < (uint32_t)nbins) atomicAdd(&local[v], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
    const int32_t c = local[b];
    if (c) atomicAdd(&counts[b], c);
  }
}

__global__ void hist_global(const int32_t* __restrict__ idx, int64_t n,
                            int nbins, int32_t* __restrict__ counts) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t v = idx[i];
    if ((uint32_t)v < (uint32_t)nbins) atomicAdd(&counts[v], 1);
  }
}

__global__ void counts_to_float(const int32_t* __restrict__ counts,
                                int nbins, float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < nbins) out[b] = (float)counts[b];
}

}  // namespace

// idx: (n,) int32 device pointer; counts: (nbins,) int32 scratch;
// out: (nbins,) float32. Indices outside [0, nbins) are not counted.
// Returns the CUDA error code (0 on success); launches on `stream`.
extern "C" int repro_histogram(const int32_t* idx, long long n, int nbins,
                               int32_t* counts, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbins <= 0) return 0;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * nbins, s);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (nbins <= kSmemMaxBins) {
      const int64_t per_block = (int64_t)kThreads * kItemsPerThread;
      int64_t blocks = (n + per_block - 1) / per_block;
      if (blocks > 2 * sms) blocks = 2 * sms;
      const size_t smem = sizeof(int32_t) * nbins;
      if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(hist_shared,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)(sizeof(int32_t) * kSmemMaxBins));
        if (err != cudaSuccess) return err;
      }
      hist_shared<<<(int)blocks, kThreads, smem, s>>>(idx, n, nbins, counts);
    } else {
      int64_t blocks = (n + kThreads - 1) / kThreads;
      if (blocks > 8 * sms) blocks = 8 * sms;
      hist_global<<<(int)blocks, kThreads, 0, s>>>(idx, n, nbins, counts);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  counts_to_float<<<(nbins + 255) / 256, 256, 0, s>>>(counts, nbins, out);
  return cudaGetLastError();
}
