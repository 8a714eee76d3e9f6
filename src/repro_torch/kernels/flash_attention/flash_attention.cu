// Causal flash attention, forward, for Hopper (sm_90a): the CUDA-core
// route. The launcher (kernel.py) takes it for float32 and for bfloat16
// at head dims other than 64 and 128; bfloat16 at 64 and 128 takes the
// tensor-core route of fa_hopper.cuh (entry repro_flash_attention_wgmma
// at the end of this file). Tensor cores would compute float32 only in
// TF32, which cannot hold the float32 tolerance of 2e-5.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_fa_kernel / flash_attention) together with the GQA repeat and the
// head transposes of its wrapper (ops.py::mha). It computes, for each
// batch b, head h and query row i,
//
//   o = softmax(mask(softcap(q . k^T * scale))) . v
//
// with an online softmax over kv tiles: a running max m, a running sum l
// and an accumulator acc, all float32; the causal mask is qpos >= kpos
// with the mask value NEG; softcap is tanh(s / cap) * cap when cap != 0;
// the row is finalized as acc / max(l, 1e-37) and cast to q's type.
//
// The TPU kernel walks a sequential grid (B*H, S/128, T/128) and carries
// (m, l, acc) in VMEM scratch across the innermost kv dimension. Hopper's
// blocks run in parallel and in no order, so here one block owns one
// (b*h, q-tile) and a loop inside it walks the kv tiles. Under the causal
// mask the loop stops at the diagonal: the tiles after it are wholly
// masked, and every query row has an unmasked key (key 0) in the first
// tile, so skipping them changes the result only by rounding order.
//
// GQA: the block reads kv head h / (H / KH) directly, where the TPU
// wrapper materialized jnp.repeat. q, k and v come in (B, S, H, dh)
// layout with any strides on the first three dims (the head dim must be
// contiguous), so the wrapper's transposes are not copies; o is written
// contiguous (B, S, H, dh).
//
// Tiles: BQ = 64 query rows and BK = 64 keys, 128 threads. q, k and v
// tiles sit in shared memory in the input type (float32 or bfloat16),
// one padding word per row so that threads reading one column
// of different rows hit different banks; scores, probabilities and all
// softmax state are float32. Thread (ty, tx) = (tid / 16, tid % 16) owns
// query rows ty*8 .. ty*8+7; of the scores it computes columns
// tx + 16*j (j < 4) and of the output columns tx + 16*j (j < DH / 16).
// The 16 threads of a row group reduce its max and sum by shuffles.
// Head dims up to 128 are taken (DH = 64 or 128, zero-filled past dh).
//
// Bound: at prefill shapes the work is operations. Causal attention does
// about 2 * B * H * S^2 * dh FLOPs (QK^T and PV, halved by the mask)
// against 2 * (B*S*H + 2*B*T*KH) * dh * bytes-per-element of traffic.
// This route does its dot products on the CUDA cores in float32
// (67 TFLOP/s at most, where bf16 tensor cores give 989); fa_hopper.cuh
// is the bfloat16 route on the tensor cores.
#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  int S, T, H, KH, dh;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale, softcap;
};

// Row stride of a shared tile: DH elements plus one 32-bit word.
template <typename T, int DH> __host__ __device__ constexpr int ld() {
  return DH + 4 / (int)sizeof(T);
}

template <typename T, int DH> constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)(kBQ + 2 * kBK) * ld<T, DH>() +
         sizeof(float) * (size_t)kBQ * (kBK + 1);
}

// Copy rows [row0, row0 + n) of one head into a shared tile, zero past dh.
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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) fa_fwd(Args a) {
  constexpr int LD = ld<T, DH>();
  constexpr int kOut = DH / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBQ * LD;
  T* sV = sK + kBK * LD;
  float* sP = reinterpret_cast<float*>(sV + kBK * LD);

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

  load_tile<T, DH>(sQ, qp, q0, a.qss, a.dh, kBQ);

  // kv tiles up to the causal diagonal
  const int n_kt = min(a.T / kBK, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's sK, sV and sP are consumed
    load_tile<T, DH>(sK, kp, k0, a.kss, a.dh, kBK);
    load_tile<T, DH>(sV, vp, k0, a.vss, a.dh, kBK);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
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
        if (qpos < k0 + tx + 16 * j) x = kNeg;
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
      for (int j = 0; j < kOut; ++j) vv[j] = to_f(sV[c * LD + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float inv_l = 1.f / fmaxf(l[i], 1e-37f);
    T* row = op + (((long long)b * a.S + q0 + r0 + i) * a.H + h) * a.dh;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int d = tx + 16 * j;
      if (d < a.dh) row[d] = from_f<T>(acc[i][j] * inv_l);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  const size_t smem = smem_bytes<T, DH>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.S / kBQ, B * a.H);
  fa_fwd<T, DH><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Args& a, int B, cudaStream_t s) {
  return a.dh <= 64 ? launch<T, 64>(a, B, s) : launch<T, 128>(a, B, s);
}

}  // namespace

// q: (B, S, H, dh), k and v: (B, T, KH, dh), each with the given strides
// (in elements) for its first three dims and a contiguous last dim;
// o: contiguous (B, S, H, dh). dtype: 0 float32, 1 bfloat16. The mask is
// causal (qpos >= kpos): the only form a caller of the port needs.
// S and T are multiples of 128, H a multiple of KH, 0 < dh <= 128.
// Returns the CUDA error code: 0 on success, cudaErrorInvalidValue on
// arguments it does not take. Launches on `stream`.
extern "C" int repro_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int S, int T, int H, int KH, int dh, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, float scale, float softcap, void* stream) {
  if (B <= 0 || S % 128 || T % 128 || S <= 0 || T <= 0 || KH <= 0 ||
      H % KH || dh <= 0 || dh > 128)
    return cudaErrorInvalidValue;
  Args a{q, k, v, o, S, T, H, KH, dh, qsb, qss, qsh, ksb, kss, ksh,
         vsb, vss, vsh, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dh<float>(a, B, s);
    case 1: return launch_dh<__nv_bfloat16>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// The tensor-core route: the same arguments and contract as
// repro_flash_attention, for dtype 1 (bfloat16) and dh 64 or 128 only,
// with 16-byte aligned q, k, v and strides that are multiples of 8
// elements (TMA's 16-byte rule). cudaErrorInvalidValue otherwise, and when
// a tensor map cannot be encoded.
extern "C" int repro_flash_attention_wgmma(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int S, int T, int H, int KH, int dh, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, float scale, float softcap, void* stream) {
  if (dtype != 1 || B <= 0 || S % 128 || T % 128 || S <= 0 || T <= 0 ||
      KH <= 0 || H % KH || (dh != 64 && dh != 128))
    return cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  for (long long st : {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh})
    if (st % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dh == 64
             ? fa_hopper::launch<64>(q, k, v, o, B, S, T, H, KH, qsb, qss, qsh,
                                     ksb, kss, ksh, vsb, vss, vsh, scale,
                                     softcap, s)
             : fa_hopper::launch<128>(q, k, v, o, B, S, T, H, KH, qsb, qss,
                                      qsh, ksb, kss, ksh, vsb, vss, vsh, scale,
                                      softcap, s);
}
