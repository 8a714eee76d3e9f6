// GF(2) rank of 32x32 bit matrices for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gf2_rank/kernel.py
// (_rank_kernel / gf2_rank). The TPU kernel holds TILE_M matrices in a
// (TILE_M, 32) VMEM tile and runs the 32-step elimination as vector
// mask/XOR work, picking each pivot by argmax over a candidate mask. On
// Hopper a matrix fits one warp exactly: lane r holds row r. At step i,
// __ballot_sync over "column bit set and row not yet a pivot" gives the
// candidate mask, __ffs picks the first candidate (the reference's
// argmax), __shfl_sync broadcasts its row, and every other row holding
// the bit XORs it in. No shared memory, no block-level synchronization.
//
// Bound: bytes. Each matrix is read once (128 B, one coalesced warp
// load) and its rank written once (4 B); the elimination is 32 steps of
// a few integer instructions per lane.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;   // 256 threads: 8 matrices per block

__global__ void gf2_rank32(const uint32_t* __restrict__ mats, int64_t m,
                           int32_t* __restrict__ ranks) {
  const int64_t mat = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (mat >= m) return;               // uniform across the warp
  uint32_t row = mats[mat * 32 + lane];
  bool used = false;
  int rank = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool col = (row >> (31 - i)) & 1u;
    const unsigned cand = __ballot_sync(0xffffffffu, col && !used);
    if (cand) {                       // uniform across the warp
      const int piv = __ffs(cand) - 1;
      const uint32_t pivrow = __shfl_sync(0xffffffffu, row, piv);
      if (col && lane != piv) row ^= pivrow;
      used |= (lane == piv);
      ++rank;
    }
  }
  if (lane == 0) ranks[mat] = rank;
}

}  // namespace

// mats: (m, 32) uint32 rows, device pointer; ranks: (m,) int32.
// Returns the CUDA error code (0 on success); launches on `stream`.
extern "C" int repro_gf2_rank32(const uint32_t* mats, long long m,
                                int32_t* ranks, void* stream) {
  if (m <= 0) return 0;
  const int64_t blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gf2_rank32<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
               static_cast<cudaStream_t>(stream)>>>(mats, m, ranks);
  return cudaGetLastError();
}
