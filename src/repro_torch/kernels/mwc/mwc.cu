// Lag-1 multiply-with-carry (Marsaglia) words for Hopper (sm_90a).
//
// Port-only kernel: the reference generates mwc with a sequential
// lax.scan (src/repro/rng/generators.py, mwc_block), not with Pallas.
// One step is t = a*x + c; x = t mod 2^32; c = t >> 32, with
// a = 4294957665, and word i is x after step i + 1.
//
// Jump-ahead. Write the state as z = c*2^32 + x. A step gives
// z' = a*x + c, and a*z = a*c*2^32 + a*x = c*(a*2^32 - 1) + z', so with
// the prime p = a*2^32 - 1 (< 2^64), z' = a*z (mod p) and z_k = a^k z_0
// (mod p). Word k is z_{k+1} mod 2^32 where z_{k+1} is the state itself,
// not a residue; the two agree when z_{k+1} < p. Which states reach p:
//   * c < a gives z' = a*x + c <= a*(2^32 - 1) + (a - 1) = p, and then
//     c' = z' >> 32 <= p >> 32 = a - 1: once c < a, every later state is
//     <= p and keeps c < a.
//   * z' = p needs a*z = 0 (mod p), that is z = 0 or z = p. z = 0 is
//     never a state (x0 is odd, and a nonzero residue stays nonzero under
//     multiplication by a). The first state z_0 = c0*2^32 + x0 is not p
//     either: that needs c0 = a - 1, which is even, and c0 is odd.
//   * c0 = (s mod 2^32) | 1 can be >= a (a = 2^32 - 9631). Then
//     z_1 = a*x0 + c0 <= a*(2^32 - 1) + 2^32 - 1 = p + 9631, so
//     c_1 <= a, and c_1 = a only with x_1 <= 9630; then
//     z_2 = a*x_1 + a <= 9631*a < p and c_2 < a.
// So z_k < p for every k >= 2, and for those z_k = a^(k-1) * (z_1 mod p)
// mod p exactly. Only z_0 and z_1 may lie at or above p.
//
// Work split. Thread j writes words [j*C, (j+1)*C) (C = kChunk). Thread 0
// runs the loop's own steps from (x0, c0), so the two states that may
// exceed p never go through a residue. Thread j >= 1 starts at
// z_{jC+1} = A^j * (z_1 mod p) mod p, jC + 1 >= 2, with A = a^C mod p;
// the host passes A^(2^i) mod p for each bit i of j, so a thread spends
// popcount(j) 64x64-bit products mod p (unsigned __int128 and %) on its
// jump, then C - 1 steps of one 32x32->64-bit multiply-add each.
//
// Bound: bytes. The output is the port's word carrier, int64: 8 bytes a
// word written once, 2.5 us per 2^20 words at 3.35 TB/s; the steps are
// one wide multiply-add a word (2 INT32 operations, 0.13 us per 2^20 at
// 16.7e12/s) and a chain of C = 64 dependent ones per thread. A warp's
// threads write words C apart, so the words are staged through shared
// memory (pitch C + 1: a thread's stores and the block's coalesced
// 8-byte stores each hit 32 distinct banks) and written out by the block
// in order.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kA = 4294957665ull;
constexpr uint64_t kP = kA * 4294967296ull - 1ull;   // a*2^32 - 1, prime
constexpr int kThreads = 128;
constexpr int kChunk = 64;          // words per thread
constexpr int kPitch = kChunk + 1;  // shared words per thread
constexpr int kJumpBits = 40;       // chunks below 2^40

struct JumpPowers {
  uint64_t v[kJumpBits];            // A^(2^i) mod p
};

__device__ __forceinline__ uint64_t mulmod(uint64_t x, uint64_t y) {
  return (uint64_t)(((unsigned __int128)x * y) % kP);
}

__global__ void __launch_bounds__(kThreads)
mwc_words(uint32_t x0, uint32_t c0, int64_t n, JumpPowers pows,
          int64_t* __restrict__ out) {
  __shared__ uint32_t tile[kThreads * kPitch];
  const int64_t base = (int64_t)blockIdx.x * kThreads * kChunk;
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t first = j * kChunk;
  if (first < n) {
    const int count = n - first < kChunk ? (int)(n - first) : kChunk;
    uint32_t* mine = tile + threadIdx.x * kPitch;
    uint64_t x, c;
    int k = 0;
    if (j == 0) {
      x = x0;
      c = c0;
    } else {
      uint64_t z1 = kA * x0 + c0;     // <= p + 9631: one subtraction
      if (z1 >= kP) z1 -= kP;
      uint64_t z = z1;
      for (int b = 0; b < kJumpBits; ++b)
        if ((j >> b) & 1) z = mulmod(z, pows.v[b]);
      x = z & 0xffffffffull;          // z = z_{jC+1} < p: word jC
      c = z >> 32;
      mine[k++] = (uint32_t)x;
    }
    for (; k < count; ++k) {
      const uint64_t t = kA * x + c;  // c <= a: t <= a*2^32 < 2^64
      x = t & 0xffffffffull;
      c = t >> 32;
      mine[k] = (uint32_t)x;
    }
  }
  __syncthreads();
  const int64_t left = n - base;
  const int words = left < kThreads * kChunk ? (int)left : kThreads * kChunk;
  for (int i = threadIdx.x; i < words; i += kThreads)
    out[base + i] = (int64_t)tile[(i / kChunk) * kPitch + i % kChunk];
}

}  // namespace

// Words [0, n) of the sequence from (x0, c0), into out (n int64, device
// pointer). pows: host array of kJumpBits values A^(2^i) mod p,
// A = a^kChunk mod p. Returns the CUDA error code (0 on success); launches
// on `stream`.
extern "C" int repro_mwc_words(unsigned int x0, unsigned int c0,
                               long long n, const unsigned long long* pows,
                               int64_t* out, void* stream) {
  if (n <= 0) return 0;
  JumpPowers jp;
  for (int i = 0; i < kJumpBits; ++i) jp.v[i] = pows[i];
  const int64_t per_block = (int64_t)kThreads * kChunk;
  const int64_t blocks = (n + per_block - 1) / per_block;
  mwc_words<<<(unsigned)blocks, kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(x0, c0, n, jp, out);
  return cudaGetLastError();
}
