// Flash attention, forward, for Hopper (sm_90a): the CUDA-core
// route, and the C entries of both forward routes and of the backward
// (fa_bwd.cuh, entry repro_flash_attention_bwd at the end of this file;
// each forward route writes its rows' log-sum-exp for it when given a
// pointer). The launcher (kernel.py) takes this route for float32, for
// bfloat16 at head dims other than 64 and 128, and for any call whose v
// head dim dv differs from q's and k's dh; bfloat16 at dh = dv = 64 or
// 128 takes the tensor-core route of fa_hopper.cuh (entry
// repro_flash_attention_wgmma at the end of this file). Tensor cores
// would compute float32 only in TF32, which cannot hold the float32
// tolerance of 2e-5.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_fa_kernel / flash_attention) together with the GQA repeat and the
// head transposes of its wrapper (ops.py::mha). It computes, for each
// batch b, head h and query row i,
//
//   o = softmax(mask(softcap(q . k^T * scale))) . v
//
// with an online softmax over kv tiles: a running max m, a running sum l
// and an accumulator acc, all float32; the mask keeps kpos < kv_len (the
// real keys of a T padded to a multiple of 128) and, in the causal form,
// qpos >= kpos, with the mask value NEG; softcap is tanh(s / cap) * cap
// when cap != 0, applied before the mask; the row is finalized as
// acc / max(l, 1e-37) and cast to q's type.
//
// Non-causal form (causal = 0; the Pallas kernel's causal=False, the
// reference's mode="bidir": whisper's encoder self-attention and its
// decoder's cross attention): the kv loop walks ceil(kv_len / BK) tiles
// from tile 0, and keys at kpos >= kv_len (in the last tile only) get
// NEG. Every row keeps key 0, so the first tile gives each row a real
// max, and a masked key's p = exp(NEG - m) is exactly 0. No window.
//
// Sliding window (window w > 0; the reference's local attention, which
// it computes with XLA, models/attention.py _mask_bias, and not with the
// Pallas kernel): a key is kept when 0 <= qpos - kpos < w. A window of at
// least S is the causal mask, bit for bit (no tile or mask changes).
//
// The TPU kernel walks a sequential grid (B*H, S/128, T/128) and carries
// (m, l, acc) in VMEM scratch across the innermost kv dimension. Hopper's
// blocks run in parallel and in no order, so here one block owns one
// (b*h, q-tile) and a loop inside it walks the kv tiles. Under the causal
// mask the loop stops at the diagonal: the tiles after it are wholly
// masked, and every query row has an unmasked key (key 0) in the first
// tile, so skipping them changes the result only by rounding order.
// Under a window the loop starts at the tile of the block's first
// query's first key, max(0, q0 - w + 1) / BK: the tiles before it are
// wholly masked for every row of the block. A row whose keys all lie
// past the first walked tile (a later row of the block) then sees only
// NEG there: its m stays NEG and its p are exp(0) = 1, until its first
// unmasked key, where alpha = exp(NEG - m_new) is exactly 0 and clears
// l and acc. Each row's own key (qpos - kpos = 0) is always kept, so
// that key comes.
//
// GQA: the block reads kv head h / (H / KH) directly, where the TPU
// wrapper materialized jnp.repeat. q, k and v come in (B, S, H, d)
// layout with any strides on the first three dims (the head dim must be
// contiguous), so the wrapper's transposes are not copies; o is written
// contiguous (B, S, H, dv).
//
// v's head dim dv may be smaller than q's and k's dh (DeepSeek-V2's MLA:
// dh 128 + 64 = 192, dv 128). The Pallas kernel has dv = dh only; its
// reference (models/attention.py sdpa) takes dv of its own, and so does
// this route: the q and k tiles are DQK wide, the v tile and the output
// columns DV wide.
//
// Tiles: BQ = 64 query rows and BK = 64 keys, 128 threads. q, k and v
// tiles sit in shared memory in the input type (float32 or bfloat16),
// one padding word per row so that threads reading one column
// of different rows hit different banks; scores, probabilities and all
// softmax state are float32. Thread (ty, tx) = (tid / 16, tid % 16) owns
// query rows ty*8 .. ty*8+7; of the scores it computes columns
// tx + 16*j (j < 4) and of the output columns tx + 16*j (j < DV / 16).
// The 16 threads of a row group reduce its max and sum by shuffles.
// Head dims up to 192 are taken: (DQK, DV) = (64, 64), (128, 128),
// (192, 192) and (192, 128), zero-filled past dh and dv (192 is
// nemotron-4-340b's, 18432 / 96; (192, 128) DeepSeek-V2's MLA). At
// DV = 192 a thread holds 8 x 12 float32 accumulators, and
// fa_fwd<float, 192, 192> takes the most shared memory of this route:
// 4 * (64 + 2 * 64) * 193 + 4 * 64 * 65 = 164,864 bytes, one block per
// SM; fa_fwd<float, 192, 128> takes 4 * ((64 + 64) * 193 + 64 * 129) +
// 4 * 64 * 65 = 148,480.
//
// Bound: at prefill shapes the work is operations. Causal attention does
// about B * H * S^2 * (dh + dv) FLOPs (QK^T and PV, halved by the mask)
// against (B*S*H + B*T*KH) * (dh + dv) * bytes-per-element of traffic.
// This route does its dot products on the CUDA cores in float32
// (67 TFLOP/s at most, where bf16 tensor cores give 989); fa_hopper.cuh
// is the bfloat16 route on the tensor cores.
#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fa_bwd.cuh"
#include "fa_hopper.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr int kRows = 8;          // query rows per thread
constexpr int kCols = kBK / 16;   // score columns per thread
constexpr float kNeg = -2.3819763e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ T zero_of() {
  return from_f<T>(0.f);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, KH, dh, dv;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale, softcap;
  int causal;  // 1: keep kpos <= qpos; 0: no diagonal
  int kv_len;  // keep kpos < kv_len, 0 < kv_len <= T
  int window;  // 0: no window; w > 0 (causal only): keep qpos - kpos < w
  float* lse;  // null, or (B, H, S): each row's log-sum-exp (natural log)
};

// Row stride of a shared tile: DH elements plus one 32-bit word.
template <typename T, int DH> __host__ __device__ constexpr int ld() {
  return DH + 4 / (int)sizeof(T);
}

template <typename T, int DQK, int DV> constexpr size_t smem_bytes() {
  return sizeof(T) * ((size_t)(kBQ + kBK) * ld<T, DQK>() +
                      (size_t)kBK * ld<T, DV>()) +
         sizeof(float) * (size_t)kBQ * (kBK + 1);
}

// Copy rows [row0, row0 + n) of one head into a shared tile DH wide,
// zero past the head dim dh.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          long long row_stride, int dh,
                                          int n) {
  for (int e = threadIdx.x; e < n * DH; e += kThreads) {
    const int r = e / DH, d = e - r * DH;
    dst[r * ld<T, DH>() + d] =
        d < dh ? src[(long long)(row0 + r) * row_stride + d] : zero_of<T>();
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads) fa_fwd(Args a) {
  constexpr int LD = ld<T, DQK>();
  constexpr int LDV = ld<T, DV>();
  constexpr int kOut = DV / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBQ * LD;
  T* sV = sK + kBK * LD;
  float* sP = reinterpret_cast<float*>(sV + kBK * LDV);

  // heaviest causal tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int kh = h / (a.H / a.KH);
  const int q0 = qt * kBQ;
  const T* qp = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + kh * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + kh * a.vsh;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int r0 = ty * kRows;

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  load_tile<T, DQK>(sQ, qp, q0, a.qss, a.dh, kBQ);

  // kv tiles from the window's first key (0 without a window) up to the
  // last real key, and in the causal form up to the diagonal
  const int kt_lo = a.window > 0 && q0 - a.window + 1 > 0
                        ? (q0 - a.window + 1) / kBK
                        : 0;
  int n_kt = (a.kv_len + kBK - 1) / kBK;
  if (a.causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = kt_lo; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's sK, sV and sP are consumed
    load_tile<T, DQK>(sK, kp, k0, a.kss, a.dh, kBK);
    load_tile<T, DV>(sV, vp, k0, a.vss, a.dv, kBK);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = to_f(sQ[(r0 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = to_f(sK[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + r0 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = s[i][j] * a.scale;
        if (a.softcap != 0.f) x = tanhf(x / a.softcap) * a.softcap;
        const int kpos = k0 + tx + 16 * j;
        if ((a.causal && qpos < kpos) || kpos >= a.kv_len ||
            (a.window > 0 && qpos - kpos >= a.window))
          x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(r0 + i) * (kBK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sP[(r0 + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) vv[j] = to_f(sV[c * LDV + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // each row's log-sum-exp for the backward, when asked: m + log(l), from
  // the state the output is finalized from, so o is the same either way
  if (a.lse != nullptr && tx == 0) {
    float* lp = a.lse + ((long long)b * a.H + h) * a.S + q0 + r0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) lp[i] = m[i] + logf(l[i]);
  }
  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float inv_l = 1.f / fmaxf(l[i], 1e-37f);
    T* row = op + (((long long)b * a.S + q0 + r0 + i) * a.H + h) * a.dv;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int d = tx + 16 * j;
      if (d < a.dv) row[d] = from_f<T>(acc[i][j] * inv_l);
    }
  }
}

template <typename T, int DQK, int DV>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  const size_t smem = smem_bytes<T, DQK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.S / kBQ, B * a.H);
  fa_fwd<T, DQK, DV><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The instantiation for (dh, dv), dv <= dh: DQK the least of 64, 128, 192
// that holds dh; DV = 192 -> 128 where dv fits in 128 (MLA's split), else
// DV = DQK (v zero-filled past dv).
template <typename T>
cudaError_t launch_dh(const Args& a, int B, cudaStream_t s) {
  if (a.dh <= 64) return launch<T, 64, 64>(a, B, s);
  if (a.dh <= 128) return launch<T, 128, 128>(a, B, s);
  if (a.dv <= 128) return launch<T, 192, 128>(a, B, s);
  return launch<T, 192, 192>(a, B, s);
}

// The mask arguments both entries take: causal 0 or 1, 0 < kv_len <= T,
// window >= 0, and a window only in the causal form over all T keys.
bool valid_mask(int T, int causal, int kv_len, int window) {
  return (causal == 0 || causal == 1) && kv_len > 0 && kv_len <= T &&
         window >= 0 && (window == 0 || (causal && kv_len == T));
}

}  // namespace

// q: (B, S, H, dh), k: (B, T, KH, dh) and v: (B, T, KH, dv), each with
// the given strides (in elements) for its first three dims and a
// contiguous last dim; o: contiguous (B, S, H, dv). dtype: 0 float32,
// 1 bfloat16. The mask keeps kpos < kv_len, 0 < kv_len <= T; with
// causal = 1 also qpos >= kpos, and with window > 0 also qpos - kpos <
// window (window 0 is no window; a window needs causal = 1 and kv_len =
// T). causal = 0 is the non-causal form. S and T are multiples of 128, H
// a multiple of KH, 0 < dv <= dh <= 192, window >= 0. lse: null, or a
// float32 (B, H, S) that takes each row's log-sum-exp (natural log, after
// the softcap and the mask) for the backward; o is the same either way.
// Returns the CUDA error code: 0 on success, cudaErrorInvalidValue on
// arguments it does not take. Launches on `stream`.
extern "C" int repro_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int S, int T, int H, int KH, int dh, int dv, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int kv_len,
    float* lse, float scale, float softcap, int window, void* stream) {
  if (B <= 0 || S % 128 || T % 128 || S <= 0 || T <= 0 || KH <= 0 ||
      H % KH || dh <= 0 || dh > 192 || dv <= 0 || dv > dh ||
      !valid_mask(T, causal, kv_len, window))
    return cudaErrorInvalidValue;
  Args a{q, k, v, o, S, T, H, KH, dh, dv, qsb, qss, qsh, ksb, kss, ksh,
         vsb, vss, vsh, scale, softcap, causal, kv_len, window, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dh<float>(a, B, s);
    case 1: return launch_dh<__nv_bfloat16>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// The tensor-core route: the same arguments and contract as
// repro_flash_attention, for dtype 1 (bfloat16) and dh = dv = 64 or 128
// only, with 16-byte aligned q, k, v and strides that are multiples of 8
// elements (TMA's 16-byte rule). cudaErrorInvalidValue otherwise, and when
// a tensor map cannot be encoded.
extern "C" int repro_flash_attention_wgmma(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int S, int T, int H, int KH, int dh, int dv, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int kv_len,
    float* lse, float scale, float softcap, int window, void* stream) {
  if (dtype != 1 || B <= 0 || S % 128 || T % 128 || S <= 0 || T <= 0 ||
      KH <= 0 || H % KH || (dh != 64 && dh != 128) || dv != dh ||
      !valid_mask(T, causal, kv_len, window))
    return cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  for (long long st : {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh})
    if (st % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dh == 64
             ? fa_hopper::launch<64>(q, k, v, o, B, S, T, H, KH, qsb, qss, qsh,
                                     ksb, kss, ksh, vsb, vss, vsh, scale,
                                     softcap, causal, kv_len, window, lse, s)
             : fa_hopper::launch<128>(q, k, v, o, B, S, T, H, KH, qsb, qss,
                                      qsh, ksb, kss, ksh, vsb, vss, vsh, scale,
                                      softcap, causal, kv_len, window, lse, s);
}

// The backward (fa_bwd.cuh), on the CUDA cores for both dtypes: three
// launches, D = rowsum(dO . O) into the float32 scratch dsum (B, H, S),
// then dK and dV, then dQ. q, k, v as the forward takes them (the same
// strides, dtype, shapes and mask arguments); o and dO contiguous (B, S,
// H, dv) in q's dtype; lse the forward's (B, H, S) float32; dq, dk and dv
// written contiguous (B, S, H, dh), (B, T, KH, dh) and (B, T, KH, dv) in
// q's dtype, every element. No atomics: the same inputs give the same
// bits. Returns the CUDA error code of the first launch that failed (0 on
// success, cudaErrorInvalidValue on arguments it does not take).
extern "C" int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* d_o, const float* lse, float* dsum, void* dq, void* dk,
    void* dv_out, int B, int S, int T, int H, int KH, int dh, int dv,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int kv_len, float scale, float softcap, int window, void* stream) {
  if (B <= 0 || S % 128 || T % 128 || S <= 0 || T <= 0 || KH <= 0 ||
      H % KH || dh <= 0 || dh > 192 || dv <= 0 || dv > dh ||
      !valid_mask(T, causal, kv_len, window))
    return cudaErrorInvalidValue;
  fa_bwd::Args a{q, k, v, o, d_o, lse, dsum, dq, dk, dv_out, S, T, H, KH, dh,
                 dv, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, scale,
                 softcap, causal, kv_len, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return fa_bwd::launch_dh<float>(a, B, s);
    case 1: return fa_bwd::launch_dh<__nv_bfloat16>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}
