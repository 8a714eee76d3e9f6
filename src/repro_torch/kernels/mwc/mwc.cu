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
// The product mod p (mont). Because a*2^32 = 1 (mod p), dividing by 2^32
// mod p is multiplying by a, and for any V = h*2^32 + l,
// V*a = h + a*l (mod p): one 32x32->64-bit multiply-add takes 32 bits
// off V (a word-by-word Montgomery step; -1/p = 1 mod 2^32). Three of
// them take the 128-bit product u*v of two residues to
// V3 = u*v*a^3 mod p plus less than p, so one conditional subtraction
// ends it; no 128-bit division (`%` on unsigned __int128 compiles to a
// call to a software division routine, PR 18's kernel's cost). The
// bounds, for u, v < p: V1 < 2^96, V2 < 2p + 1 < 2^65 (the carry out of
// 64 bits is kept), V3 < p + a + 1 < 2^64. Jump factors are kept in the
// product's own form, f~ = f*a^-3 mod p, so mont(f~, g~) = (f*g)~ and
// mont(z, f~) = z*f: the host's table holds (a^(2^i))~ for word-index
// bits i < 40 and the form of 1, a^-3 (kernel.py: jump_table).
//
// Work split (kernel.py: plan). Thread g of the grid writes words
// [g*C, (g+1)*C), C = 2^chunk_log2 (1 to 16 as plan picks it, up to 64),
// in blocks of up to 128 threads. plan sizes a block's words from n so
// that every BigCrush length from 2^14 words puts a block on each SM.
// Thread 0 runs the loop's own steps from (x0, c0), so the two states
// that may exceed p never go through a residue. Every other thread starts
// at z_{s+1} = a^s * (z_1 mod p), s = g*C >= 1, from the table, in a
// fixed number of products whatever s is: the warp's first word s_w has
// one bit per lane (lanes 0-7 also bits 32-39), and a butterfly of
// __shfl_xor products (5 rounds) gives every lane a^(s_w)~; beside it,
// a^(lane*C)~ from the 5 bits of the lane. Two more products apply both
// to z_1 mod p: 8 products on the longest chain, the same for every
// lane, then C - 1 steps of one 32x32->64-bit multiply-add each.
//
// Bound: bytes. The output is the port's word carrier, int64: 8 bytes a
// word written once, 2.5 us per 2^20 words at 3.35 TB/s; the steps are
// one wide multiply-add a word (2 INT32 operations, 0.13 us per 2^20 at
// 16.7e12/s). At BigCrush's lengths (2^10-2^20 words, 2^16 the most
// common) the bytes take under 0.2 us and a call is latency: the launch
// itself (an empty one is about 1.9 us of device time on an H100) and
// each thread's chain, the jump's 8 products and C - 1 steps. plan keeps
// that chain short (C of 1 to 16) while giving every SM a block, and
// longer chunks only where the jump's products would otherwise cost more
// than the steps they save; at 2^23 words it keeps blocks of 2048 words,
// small enough for 16 blocks on an SM (PERF.md, chip_mwc_plans.py). A
// warp's threads write words C apart, so the words are staged through
// shared memory (pitch C | 1: odd, so a thread's stores and the block's
// coalesced 8-byte stores each hit 32 distinct banks) and written out by
// the block in order.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kA = 4294957665ull;
constexpr uint64_t kP = kA * 4294967296ull - 1ull;   // a*2^32 - 1, prime
constexpr uint64_t kLow = 0xffffffffull;
constexpr int kWarp = 32;
constexpr int kMaxThreads = 128;    // threads a block, at most
constexpr int kMaxChunkLog2 = 6;    // 64 words a thread, at most
constexpr int kJumpBits = 40;       // word indices below 2^40

struct JumpTable {
  uint64_t v[kJumpBits];            // (a^(2^i))~ = a^(2^i - 3) mod p
  uint64_t one;                     // 1~ = a^-3 mod p
};

// u*v*a^3 mod p for residues u, v < p (the note above)
__device__ __forceinline__ uint64_t mont(uint64_t u, uint64_t v) {
  const uint64_t lo = u * v, hi = __umul64hi(u, v);
  uint64_t w = (hi << 32) | (lo >> 32);
  uint64_t t = w + kA * (lo & kLow);             // V1 = top:t < 2^96
  const uint64_t top = (hi >> 32) + (t < w);
  w = (top << 32) | (t >> 32);
  t = w + kA * (t & kLow);                       // V2 = carry:t < 2^65
  const uint64_t carry = t < w;
  w = (carry << 32) | (t >> 32);
  t = w + kA * (t & kLow);                       // V3 < p + a + 1
  return t >= kP ? t - kP : t;
}

__global__ void __launch_bounds__(kMaxThreads)
mwc_words(uint32_t x0, uint32_t c0, int64_t n, int chunk_log2,
          const __grid_constant__ JumpTable jt, int64_t* __restrict__ out) {
  extern __shared__ uint32_t tile[];
  const int chunk = 1 << chunk_log2;
  const int pitch = chunk | 1;
  const int lane = threadIdx.x % kWarp;
  const int64_t per_block = (int64_t)blockDim.x << chunk_log2;
  const int64_t base = (int64_t)blockIdx.x * per_block;
  const int64_t first = base + ((int64_t)threadIdx.x << chunk_log2);

  // a^(s_w)~ for the warp's first word s_w: bit `lane` (and lane + 32),
  // then the butterfly; every lane takes part, whatever its words
  const int64_t warp_first = first - ((int64_t)lane << chunk_log2);
  const int high = lane + kWarp;
  uint64_t f = (warp_first >> lane) & 1 ? jt.v[lane] : jt.one;
  f = mont(f, high < kJumpBits && (warp_first >> high) & 1
                  ? jt.v[high % kJumpBits] : jt.one);
#pragma unroll
  for (int m = 1; m < kWarp; m <<= 1)
    f = mont(f, __shfl_xor_sync(0xffffffffu, f, m));
  // a^(lane*C)~ from the lane's 5 bits: word-index bits chunk_log2 + b
  uint64_t g = lane & 1 ? jt.v[chunk_log2] : jt.one;
#pragma unroll
  for (int b = 1; b < 5; ++b)
    g = mont(g, (lane >> b) & 1 ? jt.v[chunk_log2 + b] : jt.one);

  if (first < n) {
    const int count = n - first < chunk ? (int)(n - first) : chunk;
    uint32_t* mine = tile + threadIdx.x * pitch;
    uint64_t x, c;
    int k = 0;
    if (first == 0) {
      x = x0;
      c = c0;
    } else {
      uint64_t z1 = kA * x0 + c0;     // <= p + 9631: one subtraction
      if (z1 >= kP) z1 -= kP;
      const uint64_t z = mont(mont(z1, f), g);   // z_{first+1} < p
      x = z & kLow;                   // word `first`
      c = z >> 32;
      mine[k++] = (uint32_t)x;
    }
    for (; k < count; ++k) {
      const uint64_t t = kA * x + c;  // c <= a: t <= a*2^32 < 2^64
      x = t & kLow;
      c = t >> 32;
      mine[k] = (uint32_t)x;
    }
  }
  __syncthreads();
  const int64_t left = n - base;
  const int words = left < per_block ? (int)left : (int)per_block;
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    out[base + i] = (int64_t)tile[(i >> chunk_log2) * pitch + (i & (chunk - 1))];
}

}  // namespace

// Words [0, n) of the sequence from (x0, c0), into out (n int64, device
// pointer), on `stream`: `blocks` blocks of `threads` threads (a multiple
// of 32, at most 128), each thread 2^chunk_log2 words (kernel.py: plan).
// table: host array of kJumpBits + 1 values, (a^(2^i))~ then 1~
// (kernel.py: jump_table). Returns the CUDA error code (0 on success).
extern "C" int repro_mwc_words(unsigned int x0, unsigned int c0,
                               long long n, int chunk_log2, int threads,
                               long long blocks,
                               const unsigned long long* table,
                               int64_t* out, void* stream) {
  if (n <= 0) return 0;
  if (chunk_log2 < 0 || chunk_log2 > kMaxChunkLog2 || threads < kWarp ||
      threads > kMaxThreads || threads % kWarp || blocks < 1 ||
      blocks >= (1ll << 31) || blocks * ((long long)threads << chunk_log2) < n)
    return cudaErrorInvalidValue;
  JumpTable jt;
  for (int i = 0; i < kJumpBits; ++i) jt.v[i] = table[i];
  jt.one = table[kJumpBits];
  const size_t smem = sizeof(uint32_t) * threads * ((1 << chunk_log2) | 1);
  mwc_words<<<(unsigned)blocks, threads, smem,
              static_cast<cudaStream_t>(stream)>>>(x0, c0, n, chunk_log2, jt,
                                                    out);
  return cudaGetLastError();
}
