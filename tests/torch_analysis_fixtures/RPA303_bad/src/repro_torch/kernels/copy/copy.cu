// BAD: a static shared tile far over a block's opt-in limit on sm_90.
#include <cuda_runtime.h>

constexpr int kTile = 256;

__global__ void big_copy(const float* x, float* o) {
  __shared__ float tile[kTile * kTile];
  tile[threadIdx.x] = x[threadIdx.x];
  __syncthreads();
  o[threadIdx.x] = tile[kTile - 1 - threadIdx.x];
}

extern "C" int repro_big_copy(const float* x, float* o, void* stream) {
  big_copy<<<1, kTile, 0, static_cast<cudaStream_t>(stream)>>>(x, o);
  return cudaGetLastError();
}
