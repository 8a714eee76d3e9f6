// Flash attention, backward, for Hopper (sm_90a), on the CUDA cores.
// Included by flash_attention.cu, whose entry repro_flash_attention_bwd
// makes its three launches.
//
// Replaces no Pallas kernel: the reference has no backward kernel. Its
// gradients come from XLA's autodiff through its blocked attention
// (src/repro/models/attention.py _attend_blocked, a jax.checkpoint per q
// chunk), the path whose forward the Pallas kernel
// (src/repro/kernels/flash_attention/kernel.py) twins. This is that
// gradient, written out as flash attention's backward from the forward's
// row log-sum-exp (lse, natural log, after the softcap and the mask):
//
//   p  = exp(s - lse)               s = softcap(q . k^T * scale), masked
//   D  = rowsum(dO . O)             (launch a)
//   dV = p^T dO                     (launch b)
//   dS = p (dO . V^T - D), times 1 - (s / cap)^2 with a softcap
//   dK = dS^T Q * scale             (launch b)
//   dQ = dS K * scale               (launch c)
//
// all in float32, for float32 and bfloat16 inputs, dh <= 192 and
// dv <= dh, with the forward's masks: keys at kpos >= kv_len; in the
// causal form kpos > qpos; with a window w also qpos - kpos >= w. A masked
// pair's p is exactly 0 (the mask is applied to p, not by a large negative
// score, so the softcap's factor never meets it), so masked pairs, and
// keys at or past kv_len, add exactly 0.
//
// Launch (b): one block per (batch, kv head, 64-key tile). It keeps its
// K and V tiles in shared memory and walks every q head of the GQA group
// and every 64-row q tile that can see the tile (causal: from the
// diagonal on; a window w: up to the tile of query kpos + w - 1; the
// non-causal form: all), recomputing p from lse and summing dK and dV in
// registers. The GQA sum is made inside the block, so no atomics and no
// second pass: two calls on the same inputs give the same bits.
// Launch (c): one block per (batch, head, 64-row q tile), heaviest causal
// tile first; it walks the kv tiles that the forward walks for the tile
// and sums dQ in registers.
//
// Tiles: 64 x 64 score tiles over 256 threads; thread (ty, tx) = (tid /
// 16, tid % 16) owns rows 4 ty .. 4 ty + 3 and columns tx + 16 j of a
// score tile, and of an accumulator (dK and dV: keys; dQ: query rows)
// rows 4 ty .. 4 ty + 3 and columns tx + 16 j, j < D / 16. q, k, v and dO
// tiles sit in shared memory in the input type with one padding word per
// row (threads reading one column of different rows hit different
// banks); p and dS share one float32 tile. The largest instantiation,
// float32 at (DQK, DV) = (192, 192), takes 4 * 4 * 64 * 193 + 4 * (64 *
// 65 + 2 * 64) = 214,784 bytes of dynamic shared memory, one block per
// SM, both in (b) and (c).
//
// Bound (PERF.md section 6): the five products of flash attention's
// backward, 2 * pairs * (2 dqk + 3 dv) FLOP (10 pairs dh at dh = dv),
// against the bytes of q, k, v, o, dO, dq, dk, dv read or written once:
// operations at training shapes (qwen2's 2 x 2048, 12 heads, dh 128:
// 6.45e10 FLOP, 0.96 ms at the float32 CUDA-core peak of 67 TFLOP/s).
// This design recomputes S and dP in (c) (7 products, not 5) to avoid
// atomics, runs on the CUDA cores in float32 (tensor cores would round
// float32 to TF32), and keeps one 256-thread block per SM; a wgmma/TMA
// design is later work.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fa_bwd {

constexpr int kB = 64;            // q rows of a q tile, keys of a kv tile
constexpr int kThreads = 256;
constexpr int kR = 4;             // tile rows per thread
constexpr int kC = kB / 16;       // score columns per thread
constexpr int kLdP = kB + 1;      // row stride of the float32 p / dS tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;        // contiguous (B, S, H, dv)
  const void* d_o;      // contiguous (B, S, H, dv)
  const float* lse;     // (B, H, S)
  float* dsum;          // D, (B, H, S)
  void* dq;             // contiguous (B, S, H, dh)
  void* dk;             // contiguous (B, T, KH, dh)
  void* dv;             // contiguous (B, T, KH, dv)
  int S, T, H, KH, dh, dv_dim;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale, softcap;
  int causal;  // 1: keep kpos <= qpos; 0: no diagonal
  int kv_len;  // keep kpos < kv_len, 0 < kv_len <= T
  int window;  // 0: no window; w > 0 (causal only): keep qpos - kpos < w
};

// Row stride of a shared tile: D elements plus one 32-bit word.
template <typename T, int D> __host__ __device__ constexpr int ld() {
  return D + 4 / (int)sizeof(T);
}

// Dynamic shared memory of launches (b) and (c): q, dO, k and v tiles,
// the p / dS tile, and a q tile's lse and D.
template <typename T, int DQK, int DV> constexpr size_t smem_bytes() {
  return sizeof(T) * 2 * ((size_t)kB * ld<T, DQK>() + (size_t)kB * ld<T, DV>()) +
         sizeof(float) * ((size_t)kB * kLdP + 2 * kB);
}

// Rows [row0, row0 + kB) of one head into a shared tile D wide, zero past
// the head dim d.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          long long row_stride, int d) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    dst[r * ld<T, D>() + c] =
        c < d ? src[(long long)(row0 + r) * row_stride + c] : T(0.f);
  }
}

__device__ __forceinline__ bool masked(const Args& a, int qpos, int kpos) {
  return (a.causal && qpos < kpos) || kpos >= a.kv_len ||
         (a.window > 0 && qpos - kpos >= a.window);
}

// One 64 x 64 pair of tiles: the thread's p (into s) and dS (into dp)
// from Q K^T (in s) and dO V^T (in dp), the q tile's lse and D.
__device__ __forceinline__ void p_and_ds(const Args& a, float (&s)[kR][kC],
                                         float (&dp)[kR][kC], const float* sL,
                                         const float* sD, int q0, int k0,
                                         int r0, int tx) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qpos = q0 + r0 + i;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      float x = s[i][j] * a.scale;
      if (a.softcap != 0.f) x = tanhf(x / a.softcap) * a.softcap;
      const float p = masked(a, qpos, k0 + tx + 16 * j)
                          ? 0.f
                          : expf(x - sL[r0 + i]);
      float ds = p * (dp[i][j] - sD[r0 + i]);
      if (a.softcap != 0.f) {
        const float t = x / a.softcap;
        ds *= 1.f - t * t;
      }
      s[i][j] = p;
      dp[i][j] = ds;
    }
  }
}

// acc[i][j] (+)= sum_d A[r0 + i][d] . B[tx + 16 j][d]: a 64 x 64 tile of
// products of two shared tiles' rows, D deep.
template <typename T, int D>
__device__ __forceinline__ void rows_dot(float (&acc)[kR][kC], const T* sa,
                                         const T* sb, int r0, int tx) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[kR], bv[kC];
#pragma unroll
    for (int i = 0; i < kR; ++i) av[i] = to_f(sa[(r0 + i) * ld<T, D>() + d]);
#pragma unroll
    for (int j = 0; j < kC; ++j) bv[j] = to_f(sb[(tx + 16 * j) * ld<T, D>() + d]);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_n P[n][r0 + i] . B[n][tx + 16 j] (transposed: P's
// columns are acc's rows) over the kB rows n of the float32 tile sP.
template <typename T, int D>
__device__ __forceinline__ void cols_acc(float (&acc)[kR][D / 16],
                                         const float* sP, const T* sb, int r0,
                                         int tx) {
#pragma unroll 4
  for (int n = 0; n < kB; ++n) {
    float pv[kR], bv[D / 16];
#pragma unroll
    for (int i = 0; i < kR; ++i) pv[i] = sP[n * kLdP + r0 + i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) bv[j] = to_f(sb[n * ld<T, D>() + tx + 16 * j]);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(pv[i], bv[j], acc[i][j]);
  }
}

// Rows r0 + i of an accumulator (times `mul`) into a contiguous output
// whose rows are `stride` elements apart, `d` columns.
template <typename T, int D>
__device__ __forceinline__ void write_rows(T* out, long long stride,
                                           const float (&acc)[kR][D / 16],
                                           float mul, int d, int r0, int tx) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(out + (r0 + i) * stride + c, acc[i][j] * mul);
    }
}

// (a) D = rowsum(dO . O): one warp per (b, s, h) row, written to (B, H, S).
template <typename T>
__global__ void __launch_bounds__(kThreads) fa_bwd_dot(Args a, int rows) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp
  const T* op = static_cast<const T*>(a.o) + (long long)row * a.dv_dim;
  const T* gp = static_cast<const T*>(a.d_o) + (long long)row * a.dv_dim;
  float acc = 0.f;
  for (int d = lane; d < a.dv_dim; d += 32)
    acc = fmaf(to_f(op[d]), to_f(gp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % a.H, bs = row / a.H;
    const int s = bs % a.S, b = bs / a.S;
    a.dsum[((long long)b * a.H + h) * a.S + s] = acc;
  }
}

// (b) dK and dV of one (batch, kv head, kv tile).
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dkdv(Args a) {
  constexpr int LDQ = ld<T, DQK>();
  constexpr int LDV = ld<T, DV>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kB * LDQ;
  T* sQ = sV + kB * LDV;
  T* sO = sQ + kB * LDQ;                      // dO
  float* sP = reinterpret_cast<float*>(sO + kB * LDV);
  float* sL = sP + kB * kLdP;
  float* sD = sL + kB;

  const int k0 = blockIdx.x * kB;
  const int b = blockIdx.y / a.KH, kh = blockIdx.y - b * a.KH;
  const int g = a.H / a.KH;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int r0 = ty * kR;

  float dk[kR][DQK / 16], dv[kR][DV / 16];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
#pragma unroll
    for (int j = 0; j < DQK / 16; ++j) dk[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < DV / 16; ++j) dv[i][j] = 0.f;
  }

  // the q tiles that see a key of this tile: none past the last real
  // key; causal from the diagonal's, and with a window up to the tile of
  // query k0 + kB - 1 + w - 1
  int qt_lo = 0, qt_hi = k0 < a.kv_len ? a.S / kB : 0;
  if (a.causal) {
    qt_lo = k0 / kB;
    if (a.window > 0)
      qt_hi = min(qt_hi, (k0 + kB - 1 + a.window - 1) / kB + 1);
  }
  if (qt_lo < qt_hi) {
    load_tile<T, DQK>(sK, static_cast<const T*>(a.k) + b * a.ksb + kh * a.ksh,
                      k0, a.kss, a.dh);
    load_tile<T, DV>(sV, static_cast<const T*>(a.v) + b * a.vsb + kh * a.vsh,
                     k0, a.vss, a.dv_dim);
  }
  for (int hg = 0; hg < g; ++hg) {
    const int h = kh * g + hg;
    const T* qp = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
    const T* gp = static_cast<const T*>(a.d_o) +
                  ((long long)b * a.S * a.H + h) * a.dv_dim;
    const long long row_lh = ((long long)b * a.H + h) * a.S;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the previous q tile's sQ, sO, sP are consumed
      load_tile<T, DQK>(sQ, qp, q0, a.qss, a.dh);
      load_tile<T, DV>(sO, gp, q0, (long long)a.H * a.dv_dim, a.dv_dim);
      if (tid < kB) {
        sL[tid] = a.lse[row_lh + q0 + tid];
        sD[tid] = a.dsum[row_lh + q0 + tid];
      }
      __syncthreads();
      float s[kR][kC], dp[kR][kC];
      rows_dot<T, DQK>(s, sQ, sK, r0, tx);
      rows_dot<T, DV>(dp, sO, sV, r0, tx);
      p_and_ds(a, s, dp, sL, sD, q0, k0, r0, tx);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) sP[(r0 + i) * kLdP + tx + 16 * j] = s[i][j];
      __syncthreads();
      cols_acc<T, DV>(dv, sP, sO, r0, tx);        // dV += P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) sP[(r0 + i) * kLdP + tx + 16 * j] = dp[i][j];
      __syncthreads();
      cols_acc<T, DQK>(dk, sP, sQ, r0, tx);       // dK += dS^T Q
    }
  }
  const long long row = (long long)b * a.T + k0;
  write_rows<T, DQK>(static_cast<T*>(a.dk) + (row * a.KH + kh) * a.dh,
                     (long long)a.KH * a.dh, dk, a.scale, a.dh, r0, tx);
  write_rows<T, DV>(static_cast<T*>(a.dv) + (row * a.KH + kh) * a.dv_dim,
                    (long long)a.KH * a.dv_dim, dv, 1.f, a.dv_dim, r0, tx);
}

// (c) dQ of one (batch, head, q tile).
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dq(Args a) {
  constexpr int LDQ = ld<T, DQK>();
  constexpr int LDV = ld<T, DV>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kB * LDQ;
  T* sQ = sV + kB * LDV;
  T* sO = sQ + kB * LDQ;                      // dO
  float* sP = reinterpret_cast<float*>(sO + kB * LDV);
  float* sL = sP + kB * kLdP;
  float* sD = sL + kB;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // heaviest first
  const int b = blockIdx.y / a.H, h = blockIdx.y - b * a.H;
  const int kh = h / (a.H / a.KH);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int r0 = ty * kR;
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + kh * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + kh * a.vsh;
  const long long row_lh = ((long long)b * a.H + h) * a.S;

  load_tile<T, DQK>(sQ, static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh,
                    q0, a.qss, a.dh);
  load_tile<T, DV>(sO, static_cast<const T*>(a.d_o) +
                           ((long long)b * a.S * a.H + h) * a.dv_dim,
                   q0, (long long)a.H * a.dv_dim, a.dv_dim);
  if (tid < kB) {
    sL[tid] = a.lse[row_lh + q0 + tid];
    sD[tid] = a.dsum[row_lh + q0 + tid];
  }

  float dq[kR][DQK / 16];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < DQK / 16; ++j) dq[i][j] = 0.f;

  // the forward's kv tiles: from the window's first key, up to the last
  // real key, and in the causal form up to the diagonal
  const int kt_lo =
      a.window > 0 && q0 - a.window + 1 > 0 ? (q0 - a.window + 1) / kB : 0;
  int n_kt = (a.kv_len + kB - 1) / kB;
  if (a.causal) n_kt = min(n_kt, (q0 + kB - 1) / kB + 1);
  for (int kt = kt_lo; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's sK, sV, sP are consumed
    load_tile<T, DQK>(sK, kp, k0, a.kss, a.dh);
    load_tile<T, DV>(sV, vp, k0, a.vss, a.dv_dim);
    __syncthreads();
    float s[kR][kC], dp[kR][kC];
    rows_dot<T, DQK>(s, sQ, sK, r0, tx);
    rows_dot<T, DV>(dp, sO, sV, r0, tx);
    p_and_ds(a, s, dp, sL, sD, q0, k0, r0, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) sP[(r0 + i) * kLdP + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dQ += dS K: rows r0 + i, columns tx + 16 j
#pragma unroll 4
    for (int n = 0; n < kB; ++n) {
      float pv[kR], kv[DQK / 16];
#pragma unroll
      for (int i = 0; i < kR; ++i) pv[i] = sP[(r0 + i) * kLdP + n];
#pragma unroll
      for (int j = 0; j < DQK / 16; ++j) kv[j] = to_f(sK[n * LDQ + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < DQK / 16; ++j) dq[i][j] = fmaf(pv[i], kv[j], dq[i][j]);
    }
  }
  write_rows<T, DQK>(static_cast<T*>(a.dq) +
                         (((long long)b * a.S + q0) * a.H + h) * a.dh,
                     (long long)a.H * a.dh, dq, a.scale, a.dh, r0, tx);
}

template <typename T, int DQK, int DV>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  const size_t smem = smem_bytes<T, DQK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dq<T, DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = B * a.S * a.H;
  fa_bwd_dot<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                  s>>>(a, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv<T, DQK, DV><<<dim3(a.T / kB, B * a.KH), kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dq<T, DQK, DV><<<dim3(a.S / kB, B * a.H), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The instantiation for (dh, dv), dv <= dh, as the forward picks it.
template <typename T>
cudaError_t launch_dh(const Args& a, int B, cudaStream_t s) {
  if (a.dh <= 64) return launch<T, 64, 64>(a, B, s);
  if (a.dh <= 128) return launch<T, 128, 128>(a, B, s);
  if (a.dv_dim <= 128) return launch<T, 192, 128>(a, B, s);
  return launch<T, 192, 192>(a, B, s);
}

}  // namespace fa_bwd
