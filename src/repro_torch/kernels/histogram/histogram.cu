// Fused bin-count for Hopper (sm_90a): one launch per call.
//
// Replaces the Pallas TPU kernel src/repro/kernels/histogram/kernel.py
// (_hist_kernel / histogram). The TPU kernel is scatter-free: it compares
// each CHUNK of indices with a bin iota and keeps the (k,) output block
// resident across its sequential grid. Hopper has fast shared-memory
// atomics and no sequential grid; it has thread-block clusters, whose
// blocks reach each other's shared memory (distributed shared memory,
// DSMEM). Indices outside [0, nbins) are not counted, as in the TPU
// kernel. Counts stay int32 until the single conversion to float32, so
// they are exact beyond 2^24 in a bin.
//
// Bound: bytes. Each index is read once (4 B) and each bin written once;
// the work is one increment per index. The design meets it so:
// - One launch per call, and no memset: the kernel zeroes its shared
//   bins, counts, merges and writes the float32 counts itself.
// - Reading: 16-byte streaming loads, four in flight per thread, with a
//   scalar head (to 16-byte alignment) and tail; 2 blocks of 512 threads
//   per SM on every SM for large N.
// - Contention: the launcher's plan (kernel.py::plan) picks the layout.
//   "copies" (nbins <= 57,344): each block holds `warp_copies` copies of
//   the bins, and for nbins <= 32 each of them holds one copy per lane,
//   bin-major with the lane innermost, so a warp's 32 increments fall in
//   32 banks on 32 addresses whatever the data. A block first sums its
//   own copies; after cluster.sync() each block of the cluster owns a
//   slice of the bins and sums it over the cluster's blocks through
//   DSMEM (map_shared_rank).
//   "split" (up to 4 x 2^15 bins, HIST_MAX_BINS included): the bins are
//   spread over the cluster's blocks, 2^15 in each. Every block reads
//   the cluster's share of the indices and counts those of its own
//   slice with local shared atomics; a cluster's blocks run at the same
//   time, so the repeated reads hit L2. (Counting with remote DSMEM
//   atomics in the owner block instead ran several times slower.)
//   "global": nbins beyond that; reductions on the global scratch (at
//   2^18 bins they beat a split cluster of 8, which reads 8 times).
// - Output: when one cluster covers N, each block writes its slice
//   straight to `out`. Otherwise each cluster adds its non-zero int32
//   counts to a global scratch, and a ticket (atomicAdd after
//   __threadfence) elects the last cluster to finish. That cluster
//   converts the scratch into `out` and zeroes it and the ticket, so
//   the scratch is zero at the start of every launch. The launcher
//   keeps one scratch per (device, stream), so two launches that may
//   overlap never share one.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // 16-byte loads in flight per thread
constexpr int kCountsOffset = 32;   // scratch: ticket at [0], counts here

enum Route { kCopies = 0, kSplit = 1, kGlobal = 2 };

struct Params {
  const int32_t* idx;
  int64_t n;
  int nbins;
  int lanes;         // copies: 1, or 32 (one copy per lane)
  int warp_copies;   // copies: warp w counts into copy w % warp_copies
  int slice_log2;    // split: each block owns 2^slice_log2 bins
  int32_t* scratch;  // multi-cluster and global routes; zero on entry
  float* out;
};

// A global add whose result is not read, as a reduction (REDG): for
// atomicAdd the compiler emits a returning ATOMG here, which is slower.
__device__ __forceinline__ void red_add(int32_t* p, int32_t v) {
  asm volatile("red.relaxed.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v));
}

// Calls add(v) on every index of one share of idx: thread `gtid` of
// `stride` threads strides over its 16-byte vectors.
template <typename Add>
__device__ __forceinline__ void for_each_index(const Params& p, int64_t gtid,
                                               int64_t stride, Add add) {
  const int32_t* idx = p.idx;
  const int64_t n = p.n;
  int64_t head = ((16 - ((uintptr_t)idx & 15)) & 15) >> 2;
  if (head > n) head = n;
  if (gtid < head) add(idx[gtid]);
  const int4* vec = reinterpret_cast<const int4*>(idx + head);
  const int64_t nvec = (n - head) >> 2;
  int64_t i = gtid;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(vec + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add(v[u].x); add(v[u].y); add(v[u].z); add(v[u].w);
    }
  }
  for (; i < nvec; i += stride) {
    const int4 v = __ldcs(vec + i);
    add(v.x); add(v.y); add(v.z); add(v.w);
  }
  const int64_t tail = head + (nvec << 2);
  if (gtid < n - tail) add(idx[tail + gtid]);
}

// Called by every thread once its block has added this cluster's counts
// of bins [lo, hi) to the scratch (and made its last DSMEM access). The
// last cluster to arrive converts the scratch's bins [lo, hi) of each of
// its blocks into `out` and zeroes them and the ticket; the slices of a
// cluster's blocks cover [0, nbins).
__device__ __forceinline__ void finish(const Params& p, int lo, int hi) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int last;
  int32_t* counts = p.scratch + kCountsOffset;
  __threadfence();              // this thread's adds before the ticket
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    unsigned* ticket = reinterpret_cast<unsigned*>(p.scratch);
    last = atomicAdd(ticket, 1u) == gridDim.x / cluster.num_blocks() - 1;
  }
  cluster.sync();
  const bool is_last = *cluster.map_shared_rank(&last, 0);
  cluster.sync();               // rank 0's flag is read before it may exit
  if (!is_last) return;
  __threadfence();              // every cluster's adds are visible
  for (int b0 = lo + threadIdx.x; b0 < hi; b0 += kUnroll * kThreads) {
    int32_t c[kUnroll];         // loads in flight before the stores
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = b0 + u * kThreads;
      c[u] = b < hi ? __ldcg(counts + b) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = b0 + u * kThreads;
      if (b < hi) {
        p.out[b] = (float)c[u];
        __stcg(counts + b, 0);
      }
    }
  }
  if (cluster.block_rank() == 0 && threadIdx.x == 0) __stcg(p.scratch, 0);
}

// This cluster's counts of bins [lo, hi), c(b), from one block of it: to
// `out` when one cluster covers N, else added to the scratch for finish.
template <typename Count>
__device__ __forceinline__ void emit(const Params& p, int lo, int hi,
                                     Count c) {
  cg::cluster_group cluster = cg::this_cluster();
  if (gridDim.x == cluster.num_blocks()) {
    for (int b = lo + threadIdx.x; b < hi; b += kThreads) p.out[b] = (float)c(b);
    cluster.sync();             // no block exits while others read its bins
    return;
  }
  int32_t* counts = p.scratch + kCountsOffset;
  for (int b = lo + threadIdx.x; b < hi; b += kThreads) {
    const int32_t v = c(b);
    if (v) red_add(counts + b, v);
  }
  finish(p, lo, hi);
}

template <Route kRoute>
__global__ void __launch_bounds__(kThreads, 2) hist_onchip(Params p) {
  extern __shared__ int32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nbins = p.nbins;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int copies = p.lanes * p.warp_copies;
  const int area = kRoute == kSplit ? 1 << p.slice_log2 : nbins * copies;
  for (int i = threadIdx.x; i < area; i += kThreads) smem[i] = 0;
  __syncthreads();

  if constexpr (kRoute == kSplit) {
    // every block of a cluster reads the cluster's share of the indices
    // (the others' reads of it hit L2) and counts its own slice
    const int csize = (int)cluster.num_blocks();
    const int lo = (int)cluster.block_rank() << p.slice_log2;
    const int hi = min(nbins, lo + (1 << p.slice_log2));
    const uint32_t width = hi > lo ? hi - lo : 0;
    for_each_index(p, (int64_t)(blockIdx.x / csize) * kThreads + threadIdx.x,
                   (int64_t)(gridDim.x / csize) * kThreads, [&](int32_t v) {
      const uint32_t b = (uint32_t)v - (uint32_t)lo;
      if (b < width) atomicAdd(smem + b, 1);
    });
    __syncthreads();
    emit(p, lo, hi, [&](int b) { return smem[b - lo]; });
    return;
  }

  int32_t* mine = smem + (warp % p.warp_copies) * nbins * p.lanes
                  + (lane & (p.lanes - 1));
  for_each_index(p, (int64_t)blockIdx.x * kThreads + threadIdx.x,
                 (int64_t)gridDim.x * kThreads, [&](int32_t v) {
    if ((uint32_t)v < (uint32_t)nbins) atomicAdd(mine + v * p.lanes, 1);
  });
  __syncthreads();
  // this block's copies summed into red[0, nbins)
  int32_t* red = smem;
  if (copies > 1) {
    red = smem + area;
    if (p.lanes == 32) {
      for (int b = warp; b < nbins; b += kWarps) {
        int32_t s = 0;
        for (int w = 0; w < p.warp_copies; ++w)
          s += smem[(w * nbins + b) * 32 + lane];
        s = __reduce_add_sync(0xffffffffu, s);
        if (lane == 0) red[b] = s;
      }
    } else {
      for (int b = threadIdx.x; b < nbins; b += kThreads) {
        int32_t s = 0;
        for (int w = 0; w < p.warp_copies; ++w) s += smem[w * nbins + b];
        red[b] = s;
      }
    }
  }
  cluster.sync();
  const int csize = (int)cluster.num_blocks();
  const int per = (nbins + csize - 1) / csize;
  const int lo = min(nbins, (int)cluster.block_rank() * per);
  const int hi = min(nbins, lo + per);
  emit(p, lo, hi, [&](int b) {
    int32_t s = 0;
    for (int q = 0; q < csize; ++q) s += cluster.map_shared_rank(red, q)[b];
    return s;
  });
}

__global__ void __launch_bounds__(kThreads, 4) hist_global(Params p) {
  int32_t* counts = p.scratch + kCountsOffset;
  const int nbins = p.nbins;
  // bound by the global reductions: one index per thread per step
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < p.n;
       i += stride) {
    const int32_t v = p.idx[i];
    if ((uint32_t)v < (uint32_t)nbins) red_add(counts + v, 1);
  }
  // the last cluster converts the bins, a slice per block
  cg::cluster_group cluster = cg::this_cluster();
  const int per = (nbins + cluster.num_blocks() - 1) / cluster.num_blocks();
  const int lo = min(nbins, (int)cluster.block_rank() * per);
  finish(p, lo, min(nbins, lo + per));
}

}  // namespace

// Once per device, on the current device: the SM count and the largest
// dynamic shared memory every histogram kernel may take, after raising
// each kernel's limit to it. Returns the CUDA error code (0 on success).
extern "C" int repro_histogram_init(int* sms, int* max_dynamic_smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const void* kernels[] = {(const void*)hist_onchip<kCopies>,
                           (const void*)hist_onchip<kSplit>,
                           (const void*)hist_global};
  int limit = optin;
  for (const void* k : kernels) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, k);
    if (err != cudaSuccess) return err;
    limit = min(limit, optin - (int)attr.sharedSizeBytes);
  }
  for (const void* k : kernels) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    if (err != cudaSuccess) return err;
  }
  *max_dynamic_smem = limit;
  return 0;
}

// idx: (n,) int32 device pointer; out: (nbins,) float32; scratch: int32,
// kCountsOffset + nbins words, zero, for routes that use it (the kernel
// leaves it zero). The launch plan comes from kernel.py::plan. Returns
// the CUDA error code (0 on success); launches on `stream`.
extern "C" int repro_histogram(const int32_t* idx, long long n, int nbins,
                               int route, int lanes, int warp_copies,
                               int slice_log2, int cluster, int blocks,
                               int smem_bytes, int32_t* scratch, float* out,
                               void* stream) {
  const Params p{idx, n, nbins, lanes, warp_copies, slice_log2, scratch, out};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  switch (route) {
    case kCopies: err = cudaLaunchKernelEx(&cfg, hist_onchip<kCopies>, p); break;
    case kSplit: err = cudaLaunchKernelEx(&cfg, hist_onchip<kSplit>, p); break;
    case kGlobal: err = cudaLaunchKernelEx(&cfg, hist_global, p); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
