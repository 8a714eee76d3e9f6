// Flash attention, forward, bfloat16, on Hopper's tensor cores
// (sm_90a: TMA, mbarriers, wgmma, setmaxnreg). Included by
// flash_attention.cu, whose entry repro_flash_attention_wgmma launches it.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py (_fa_kernel / flash_attention) with the GQA repeat and head
// transposes of its wrapper (ops.py::mha), for bfloat16 at head dims 64
// and 128. It computes, for each batch b, head h and query row i,
//
//   o = softmax(mask(softcap(q . k^T * scale))) . v
//
// with an online softmax (running max m, sum l and accumulator acc, all
// float32), the mask kpos < kv_len (the real keys of a padded T) and, in
// the causal form, qpos >= kpos, softcap tanh(s / cap) * cap when
// cap != 0 (before the mask), and the finalize acc / max(l, 1e-37) cast to
// bfloat16. The non-causal form (causal = 0: the Pallas kernel's
// causal=False; whisper's encoder and cross attention, 1,500 keys padded
// to 1,536) walks ceil(kv_len / 128) tiles from tile 0 and masks only the
// last one, where kv_len % 128 != 0, in the log2 domain after the softcap
// as the causal mask is; producer and consumer walk the same n_kt, so the
// ring's stages and phases stay in step. With window w > 0 (causal form
// only) the mask also drops keys with
// qpos - kpos >= w (the reference's local attention, which the reference
// computes with XLA, not with the Pallas kernel); a window of at least S
// is the causal mask bit for bit. gemma2-27b's 23 local layers run here
// at w = 4096.
//
// What bounds it on this card (PERF.md section 6): at the serving shape
// B2 S2048 H12 K2 dh128 the causal work is 25.8 GFLOP, 0.026 ms at the
// 989 TFLOP/s bf16 tensor-core peak against 0.009 ms for its 29 MB of
// q, k, v and o: operations. At B4 S512 it is 3.2 GFLOP (0.003 ms)
// against 15 MB (0.004 ms): bytes. The CUDA-core route (flash_attention.cu)
// caps the dot products at the 67 TFLOP/s float32 rate and copies tiles
// element by element with no overlap, so in bf16 it ran 68-82x above these
// bounds at the two serving shapes. This design puts both products on the tensor cores and the
// copies on the TMA, overlapped with the math:
//
// * Block: one 128-row q tile of one (b, h): three warpgroups. Warpgroups
//   0 and 1 consume (64 q rows each, the height of one wgmma); warpgroup 2
//   produces (one thread issues every copy). setmaxnreg gives the
//   consumers 240 registers and leaves the producer 24. ptxas still
//   compiles the whole kernel within the launch bound's 168 registers; the
//   consumer fits there without spills (one S accumulator of 64, O of
//   dh/2, P of 32). A variant that also kept the next tile's S in flight
//   during the softmax (a second S accumulator) spilled at that limit,
//   had ptxas serialize its wgmmas and ran slower, so it was dropped: the
//   two consumer warpgroups of a block are what overlaps one's softmax
//   with the other's products.
// * Copies: TMA loads Q once and K, V tiles of 128 keys into a two-stage
//   ring; the producer keeps the next stage in flight while the consumers
//   work on the current one. Full barriers carry the byte count
//   (expect_tx); empty barriers take one arrival per consumer thread. The
//   tensor maps describe the strided 4-d (dh, heads, seq, batch) layout,
//   so the GQA head h / (H / K) and the batch are coordinates, not copies.
//   A 128-byte swizzle row holds 64 bf16 values, so a dh-128 tile is two
//   64-column boxes, each 128 rows x 128 B (16 KB, 1024-byte aligned).
// * S = Q K^T: wgmma m64n128k16, both operands from shared memory,
//   K-major (dh contiguous), 128-byte swizzle: SBO 1024 B (8 rows), the
//   start address advancing 32 B per 16-deep step inside a box.
// * Softmax on the accumulator fragment in registers: the scale folded
//   into log2(e) and exp2f; row max reduced over the four lanes that hold
//   a row (shuffles 1, 2); the row sum kept per thread and reduced once at
//   the end. Only the diagonal tile (and the tile that holds key kv_len,
//   when kv_len < T) is masked; tiles past either are skipped (key 0 is
//   unmasked for every row, so skipping only reorders rounding).
// * Window: the kv loop starts at kt_lo = max(0, q0 - w + 1) / 128, the
//   tile of the block's first query's first key; the tiles before it are
//   masked for every row and skipped. Besides the diagonal tile, the
//   tiles that hold a key some row of the block drops (k0 <= q0 + 127 - w)
//   are masked: at most two, one when w % 128 is 0 or 1 (4096). A later
//   row of the block whose keys all lie past the first walked tile sees
//   only NEG there: its m stays NEG and its P are exp2(0) = 1, until its
//   first kept key, where the rescale exp2(NEG - m) is exactly 0 and
//   clears l and O (its own key, qpos - kpos = 0, is always kept). The
//   ring's stage and the barriers' phase count iterations from kt_lo, not
//   tiles from 0: the first walked tile takes stage 0 and phase 0, as the
//   barriers were initialized, whatever its index. No shared memory
//   changes. The heaviest-first order stays: under a window every q tile
//   from w on walks the same w / 128 + 1 tiles (or one more), and the
//   earlier ones fewer, so the reversed order is still non-increasing.
// * O += P V: P is rounded to bf16 in registers and fed as wgmma's
//   register A operand (the m64nNk16 accumulator layout of S is the A
//   fragment layout, 16 columns per step); V is B from shared memory,
//   MN-major (dh contiguous) with the transpose flag: SBO 1024 B (8 keys),
//   LBO 16 KB (the next 64-column box), 2 KB per 16-key step. This is the
//   one place the numerics differ from the CUDA-core route, which keeps P
//   in float32; l sums the float32 P.
// * Grid (B*H, S/128) with the q tile reversed along y, so every heaviest
//   causal tile is dispatched first. The serving shapes give 192 blocks at
//   B4 S512 H12 (1.45 waves of 132 SMs) and 384 at B2 S2048 (2.9 waves);
//   one block per SM (160 KB of shared memory at dh 128). A 64-row tile
//   would double the blocks but leave each SM one consumer warpgroup
//   (shared memory still allows one block). It is not used: with 128-row
//   tiles the kernel's device time at B4 S512 came within 1.11x of
//   scaled_dot_product_attention's on an H100 at 700 W (chip_smoke.py:
//   0.0196 against 0.0177 ms; B2 S2048: 0.0668 against 0.0639 ms), so
//   short prompts have little left to gain from the tile height.
#pragma once
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fa_hopper {

constexpr int kBQ = 128;                 // q rows per block
constexpr int kBK = 128;                 // keys per kv tile
constexpr int kStages = 2;               // K/V ring depth
constexpr int kBoxCols = 64;             // bf16 values per 128-byte row
constexpr int kBoxBytes = 128 * 128;     // one 128-row x 64-column box
constexpr int kThreads = 384;            // 2 consumer + 1 producer warpgroup
constexpr int kConsumers = 256;
constexpr float kNeg = -2.3819763e38f;   // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory layout in bytes from a 1024-byte aligned base.
template <int DH> struct Layout {
  static constexpr int kTile = DH / kBoxCols * kBoxBytes;  // 128 x DH
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                     // stage s at + s*kTile
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;    // 7 mbarriers
  static constexpr int kBytes = kBar + 7 * 8 + 1024;   // + alignment slack
};

struct Params {
  __nv_bfloat16* o;
  int S, T, H, KH;
  float scale_log2;      // scale * log2(e)
  float cap_inv;         // scale / softcap (softcap != 0)
  float cap_log2;        // softcap * log2(e)
  int softcap;           // 0: no softcap
  int causal;            // 1: keep kpos <= qpos; 0: no diagonal
  int kv_len;            // keep kpos < kv_len, 0 < kv_len <= T
  int window;            // 0: no window; w > 0: keep qpos - kpos < w
  float* lse;            // null, or (B, H, S): rows' log-sum-exp (natural)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// A wait longer than this is a pipeline fault (a block's whole run takes
// well under a millisecond): bar_wait then traps.
constexpr unsigned long long kWatchdogNs = 1000000000ull;  // 1 s

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

// Wait until the phase of parity `parity` has completed. A wait that
// lasts kWatchdogNs on the global timer traps, so the launch fails with
// an error instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!bar_try_wait(bar, parity))
    if (global_ns() - t0 > kWatchdogNs) __trap();
}

// One box of a 4-d tensor map into shared memory; completion on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin an accumulator's registers at this point of the program, so that no
// read is moved above the wgmma wait or write below the wgmma issue.
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FA_D32_REGS                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define FA_D64_REGS                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define FA_D32_OUT(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),              \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),          \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
  "+f"(d[31])
#define FA_D64_OUT(d)                                                        \
  FA_D32_OUT(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),        \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),          \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),          \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),          \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),          \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) . B (16 x 128, smem,
// K-major); d is overwritten when accumulate == 0.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_D64_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_D64_OUT(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, bf16 registers) . B (16 x N, smem,
// MN-major: the transpose flag).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_D64_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_D64_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragment of wgmma m64nNk16 (f32), per thread of a
// warpgroup: register i holds row 16*warp + lane/4 + 8*((i>>1)&1) and
// column 8*(i>>2) + 2*(lane&3) + (i&1).
template <int DH>
__device__ __forceinline__ void consume(uint32_t base, const Params& p,
                                        int b, int h, int q0, int kt_lo,
                                        int n_kt) {
  using L = Layout<DH>;
  constexpr int kChunks = DH / kBoxCols;
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int row = wg * 64 + (tid >> 5) * 16 + (lane >> 2);  // and row + 8
  const int col = 2 * (lane & 3);
  const uint32_t bar = base + L::kBar;   // q_full, k_full[2], v_full[2],
  const uint32_t q_tile = base + L::kQ + wg * 64 * 128;  // kv_empty[2]

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  bar_wait(bar, 0);
  for (int kt = kt_lo; kt < n_kt; ++kt) {
    const int it = kt - kt_lo;           // ring iteration: stage, phase
    const int stage = it & 1;
    const uint32_t parity = (it >> 1) & 1;
    const uint32_t k_tile = base + L::kK + stage * L::kTile;
    const uint32_t v_tile = base + L::kV + stage * L::kTile;

    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    bar_wait(bar + 8 + 8 * stage, parity);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n128(s, sw128_desc(q_tile + c * kBoxBytes + kk * 32, 16, 1024),
                      sw128_desc(k_tile + c * kBoxBytes + kk * 32, 16, 1024),
                      c | kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scores -> log2 domain, softcap, the mask of the diagonal tile, of
    // the window's edge tiles and of the tile that holds key kv_len
    const int k0 = kt * kBK;
    if (p.softcap) {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = tanhf(s[i] * p.cap_inv) * p.cap_log2;
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] *= p.scale_log2;
    }
    if ((p.causal && k0 + kBK - 1 > q0) || k0 + kBK > p.kv_len ||
        (p.window > 0 && q0 + kBQ - 1 - k0 >= p.window)) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int qpos = q0 + row + 8 * ((i >> 1) & 1);
        const int kpos = k0 + 8 * (i >> 2) + col + (i & 1);
        if ((p.causal && qpos < kpos) || kpos >= p.kv_len ||
            (p.window > 0 && qpos - kpos >= p.window))
          s[i] = kNeg;
      }
    }
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      s[i] = exp2f(s[i] - mn0);
      s[i + 1] = exp2f(s[i + 1] - mn0);
      s[i + 2] = exp2f(s[i + 2] - mn1);
      s[i + 3] = exp2f(s[i + 3] - mn1);
      sum0 += s[i] + s[i + 1];
      sum1 += s[i + 2] + s[i + 3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int i = 0; i < DH / 2; i += 4) {
      o[i] *= a0;
      o[i + 1] *= a0;
      o[i + 2] *= a1;
      o[i + 3] *= a1;
    }
    // P in bf16 as the A fragment: 16 keys (8 accumulator registers) per
    // step; rows (r, r + 8) x columns (c, c + 8)
    uint32_t pa[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[4 * j] = pack_bf16(s[8 * j], s[8 * j + 1]);
      pa[4 * j + 1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
      pa[4 * j + 2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
      pa[4 * j + 3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
    }

    bar_wait(bar + 24 + 8 * stage, parity);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wgmma_rs(o, pa + 4 * j,
               sw128_desc(v_tile + j * 16 * 128, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    bar_arrive(bar + 40 + 8 * stage);   // this stage's K and V are read
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // each row's log-sum-exp for the backward, when asked: m is in the log2
  // domain, so lse = (m + log2(l)) ln 2; o is the same either way
  if (p.lse != nullptr && (lane & 3) == 0) {
    float* lp = p.lse + (static_cast<long long>(b) * p.H + h) * p.S + q0 + row;
    lp[0] = (m0 + log2f(l0)) * kLn2;
    lp[8] = (m1 + log2f(l1)) * kLn2;
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-37f), inv1 = 1.f / fmaxf(l1, 1e-37f);
  __nv_bfloat16* out0 = p.o + ((static_cast<long long>(b) * p.S + q0 + row) *
                                   p.H + h) * DH + col;
  __nv_bfloat16* out1 = out0 + 8ll * p.H * DH;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * j) =
        __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * j) =
        __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    fa_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<DH>;
  constexpr int kChunks = DH / kBoxCols;
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t bar = base + L::kBar;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kh = h / (p.H / p.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  // kv tiles from the window's first key (0 without a window) to the last
  // real key, and in the causal form to the diagonal; the producer and
  // the consumers walk this same range
  const int kt_lo =
      p.window > 0 && q0 - p.window + 1 > 0 ? (q0 - p.window + 1) / kBK : 0;
  int n_kt = (p.kv_len + kBK - 1) / kBK;
  if (p.causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);

  if (threadIdx.x == 0) {
    bar_init(bar, 1);                          // q_full
    for (int s = 0; s < kStages; ++s) {
      bar_init(bar + 8 + 8 * s, 1);            // k_full
      bar_init(bar + 24 + 8 * s, 1);           // v_full
      bar_init(bar + 40 + 8 * s, kConsumers);  // kv_empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers) {
      bar_expect_tx(bar, L::kTile);
      for (int c = 0; c < kChunks; ++c)
        tma_load(base + L::kQ + c * kBoxBytes, &tq, bar, c * kBoxCols, h, q0,
                 b);
      for (int kt = kt_lo; kt < n_kt; ++kt) {
        const int it = kt - kt_lo;         // ring iteration: stage, phase
        const int s = it & 1;
        bar_wait(bar + 40 + 8 * s, ((it >> 1) & 1) ^ 1);
        bar_expect_tx(bar + 8 + 8 * s, L::kTile);
        for (int c = 0; c < kChunks; ++c)
          tma_load(base + L::kK + s * L::kTile + c * kBoxBytes, &tk,
                   bar + 8 + 8 * s, c * kBoxCols, kh, kt * kBK, b);
        bar_expect_tx(bar + 24 + 8 * s, L::kTile);
        for (int c = 0; c < kChunks; ++c)
          tma_load(base + L::kV + s * L::kTile + c * kBoxBytes, &tv,
                   bar + 24 + 8 * s, c * kBoxCols, kh, kt * kBK, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<DH>(base, p, b, h, q0, kt_lo, n_kt);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// A bf16 (batch, seq, heads, dh) tensor with element strides sb, ss, sh
// (dh contiguous) as 128-row x 64-column boxes, 128-byte swizzle.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                       int heads, int dh, long long sb, long long ss,
                       long long sh) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  // strides of size-1 dims are never stepped; keep them encodable
  if (heads == 1) sh = dh;
  if (batch == 1) sb = ss * seq;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, 128, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int T, int H, int KH, long long qsb,
                   long long qss, long long qsh, long long ksb, long long kss,
                   long long ksh, long long vsb, long long vss, long long vsh,
                   float scale, float softcap, int causal, int kv_len,
                   int window, float* lse, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, S, H, DH, qsb, qss, qsh) ||
      !tensor_map(&tk, k, B, T, KH, DH, ksb, kss, ksh) ||
      !tensor_map(&tv, v, B, T, KH, DH, vsb, vss, vsh))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  Params p{static_cast<__nv_bfloat16*>(o), S, T, H, KH, scale * kLog2e,
           softcap != 0.f ? scale / softcap : 0.f, softcap * kLog2e,
           softcap != 0.f, causal, kv_len, window, lse};
  dim3 grid(B * H, S / kBQ);
  fa_wgmma<DH><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace fa_hopper
