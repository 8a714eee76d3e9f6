// GF(2) rank of 32x32 bit matrices for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gf2_rank/kernel.py
// (_rank_kernel / gf2_rank). The TPU kernel holds TILE_M matrices in a
// (TILE_M, 32) VMEM tile and runs the 32-step elimination as vector
// mask/XOR work, picking each pivot by argmax over a candidate mask. The
// rank does not depend on which pivot is taken, so here each thread
// holds one whole matrix in 32 registers and eliminates row by row: row
// j, already reduced by the pivots of rows 0..j-1, is a pivot if it is
// non-zero, with its lowest set bit as pivot column, and every later row
// holding that bit XORs it in. The non-zero rows left have distinct
// pivot columns, each absent from every later row, so they are
// independent and their count is the rank. That is 496 row pairs, a
// predicated LOP3 and a test each, on the integer ALU, with no vote or
// shuffle and no dependence between the rows of one step.
//
// Bound: bytes. The elimination's own work is 1,120 integer operations
// a matrix (496 row pairs, a bit test and a predicated XOR each; per row
// the lowest set bit, a negate and an AND, and the rank count, a compare
// and an add), 0.070 ms at M = 2^20 at the INT32 rate (132 SMs x 64
// lanes x 1.98 GHz = 16.7e12 ops/s); reading the int64 words and writing
// the ranks (260 B a matrix) takes 0.081 ms at 3.35 TB/s. (The Pallas
// kernel's 2 * 32 * 32 mask operations a matrix count its own algorithm,
// not this one's.) The words are staged through shared memory: coalesced
// 16-byte loads (scalar loads when the rows are not 16-byte aligned),
// keeping the low 32 bits, into a layout of 33 words a matrix, so that
// both the staging stores and each thread's reads of its own 32 rows
// fall in 32 distinct banks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // one matrix per thread
constexpr int kPitch = 33;      // shared words per matrix

__global__ void __launch_bounds__(kThreads)
gf2_rank32(const int64_t* __restrict__ mats, int64_t m,
           int32_t* __restrict__ ranks) {
  __shared__ uint32_t tile[kThreads * kPitch];
  const int64_t first = (int64_t)blockIdx.x * kThreads;
  const int count = m - first < kThreads ? (int)(m - first) : kThreads;
  const int64_t* src = mats + first * 32;
  const int words = count * 32;
  auto put = [&](int i, int64_t w) {   // word i of the block: (matrix, row)
    tile[(i >> 5) * kPitch + (i & 31)] = (uint32_t)w;
  };
  if (((uintptr_t)src & 15) == 0) {
    const longlong2* v2 = reinterpret_cast<const longlong2*>(src);
    for (int c = threadIdx.x; c < words / 2; c += kThreads) {
      const longlong2 v = __ldcs(v2 + c);
      put(2 * c, v.x);
      put(2 * c + 1, v.y);
    }
  } else {
    for (int i = threadIdx.x; i < words; i += kThreads) put(i, src[i]);
  }
  __syncthreads();
  if ((int)threadIdx.x >= count) return;
  uint32_t row[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) row[r] = tile[threadIdx.x * kPitch + r];
  int rank = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t piv = row[j];
    const uint32_t col = piv & (0u - piv);   // lowest set bit, 0 if none
    rank += piv != 0;
#pragma unroll
    for (int r = j + 1; r < 32; ++r)
      if (row[r] & col) row[r] ^= piv;
  }
  ranks[first + threadIdx.x] = rank;
}

}  // namespace

// mats: (m, 32) int64 words in [0, 2^32), device pointer; the low 32
// bits of each word are a row. ranks: (m,) int32. Returns the CUDA error
// code (0 on success); launches on `stream`.
extern "C" int repro_gf2_rank32(const int64_t* mats, long long m,
                                int32_t* ranks, void* stream) {
  if (m <= 0) return 0;
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  gf2_rank32<<<(unsigned)blocks, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(mats, m, ranks);
  return cudaGetLastError();
}
