// A bin count: a static stage of kChunk indices and k bins in dynamic
// shared memory, k chosen at run time.
#include <cuda_runtime.h>

constexpr int kChunk = 256;

__device__ __forceinline__ void stage_in(int* stage, const int* x) {
  stage[threadIdx.x] = x[blockIdx.x * kChunk + threadIdx.x];
}

__global__ void count(const int* x, float* out, int k) {
  __shared__ int stage[kChunk];
  extern __shared__ int bins[];
  for (int b = threadIdx.x; b < k; b += kChunk) bins[b] = 0;
  stage_in(stage, x);
  __syncthreads();
  if (stage[threadIdx.x] < k) atomicAdd(bins + stage[threadIdx.x], 1);
  __syncthreads();
  for (int b = threadIdx.x; b < k; b += kChunk) atomicAdd(out + b, (float)bins[b]);
}

extern "C" int repro_count(const int* x, long long n, float* out, int k,
                           void* stream) {
  const size_t smem = sizeof(int) * k;
  count<<<(unsigned)(n / kChunk), kChunk, smem,
          static_cast<cudaStream_t>(stream)>>>(x, out, k);
  return cudaGetLastError();
}
