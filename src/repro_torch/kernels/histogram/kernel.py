"""ctypes launcher of the CUDA bin-count (``histogram.cu``).

Replaces the Pallas kernel ``src/repro/kernels/histogram/kernel.py``
(``histogram``). Each call is one device launch, laid out by ``plan``, a
pure function of the shape and the card that the CPU tests reach.
``histogram.launches`` counts launches and ``histogram.calls`` counts
them by ``(N, nbins)``; nothing else touches either.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

# the reference's chunk: bincount pads N to a multiple of it
CHUNK = 2048

THREADS = 512            # histogram.cu kThreads
WARPS = THREADS // 32
BLOCKS_PER_SM = 2        # __launch_bounds__(kThreads, 2)
GLOBAL_BLOCKS_PER_SM = 8  # hist_global: two waves of __launch_bounds__ 4
ITEMS_PER_THREAD = 16    # N per block before another block is worth it
SM_SHARED_BYTES = 228 * 1024
BLOCK_RESERVED_BYTES = 1024   # shared memory the card keeps per block
# a block keeps a copy of all bins up to this count (the first port's limit,
# 229,376 B of the 232,448 B a block may use) ...
COPY_MAX_BINS = 56 * 1024
# ... and its copies take at most this many words, so that small N
# does not pay for zeroing and merging many large copies
COPY_WORDS = 16 * 1024
LANE_COPY_MAX_BINS = 32  # up to this count every lane has its own copy
# copies: a grid of up to CLUSTER_MAX * CLUSTER_WAVE blocks is one wave
# of clusters of up to CLUSTER_MAX (one per GPC), which cut the scratch
# atomics; a larger grid takes clusters of COPY_CLUSTER blocks, as
# clusters of CLUSTER_MAX at 2 blocks per SM leave the last ones to a
# second wave (PERF.md, from chip_histogram_plans.py)
CLUSTER_MAX = 8
CLUSTER_WAVE = 8
COPY_CLUSTER = 2
# split: 2^SLICE_MAX_LOG2 bins in each block of a cluster of up to
# SPLIT_CLUSTER_MAX; every block reads the cluster's indices, so the
# fewest blocks that hold the bins (at 2^18 bins, 8 blocks lost to the
# global route: PERF.md, from chip_histogram_plans.py)
SLICE_MAX_LOG2 = 15
SPLIT_CLUSTER_MAX = 4
CLUSTER_MAX_BINS = SPLIT_CLUSTER_MAX << SLICE_MAX_LOG2
COUNTS_OFFSET = 32       # histogram.cu kCountsOffset
ROUTES = {"copies": 0, "split": 1, "global": 2}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: ``route`` is ``copies`` or ``split`` (bins in the
    shared memory of a cluster's blocks) or ``global`` (bins beyond the
    cluster's capacity, atomics on the global scratch). ``scratch_words``
    is 0 when one cluster covers N and nothing global is touched."""
    route: str
    lanes: int
    warp_copies: int
    slice_log2: int
    cluster: int
    blocks: int
    smem_bytes: int
    scratch_words: int


def _pow2_floor(x: int) -> int:
    return 1 << (max(x, 1).bit_length() - 1)


@functools.lru_cache(maxsize=None)
def plan(n: int, nbins: int, sms: int, smem_limit: int, *, route=None,
         warp_copies=None, slice_log2=None, cluster=None,
         blocks=None) -> Plan:
    """The launch for ``n`` indices into ``nbins`` bins on a card with
    ``sms`` SMs whose blocks may take ``smem_limit`` bytes of dynamic
    shared memory. The keywords override the route, the copies per warp,
    the split's slice, the cluster size or the grid, to time other
    layouts (``chip_histogram_plans.py``); the rest follows from them."""
    if route is None:
        route = ("copies" if nbins <= COPY_MAX_BINS else
                 "split" if nbins <= CLUSTER_MAX_BINS else "global")
    lanes = 1
    if route == "copies":
        if nbins <= LANE_COPY_MAX_BINS:
            lanes = 32
        if warp_copies is None:
            warp_copies = min(WARPS,
                              _pow2_floor(COPY_WORDS // (lanes * nbins)))
        slice_log2 = 0
        copies = lanes * warp_copies
        words = nbins * copies + (nbins if copies > 1 else 0)
    elif route == "split":
        warp_copies = 1
        if slice_log2 is None:
            slice_log2 = SLICE_MAX_LOG2
        words = 1 << slice_log2
    elif route == "global":
        warp_copies, slice_log2, words = 1, 0, 0
    else:
        raise ValueError(f"no histogram route {route!r}")
    smem = 4 * words
    if smem > smem_limit:
        raise ValueError(f"histogram plan for {nbins} bins needs {smem} B of "
                         f"shared memory, the card allows {smem_limit}")
    if blocks is None:
        per_sm = (GLOBAL_BLOCKS_PER_SM if route == "global" else
                  min(BLOCKS_PER_SM,
                      SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES)))
        want = -(-n // (THREADS * ITEMS_PER_THREAD))
        grid = max(1, min(want, per_sm * sms))
    else:
        grid = blocks
    if route == "split":
        need = -(-nbins >> slice_log2)
        if cluster is not None and cluster != need:
            raise ValueError(f"the split route's cluster is {need} blocks "
                             f"of 2^{slice_log2} bins, not {cluster}")
        cluster = need
    elif cluster is None:
        cluster = ((min(grid, CLUSTER_MAX)
                    if grid <= CLUSTER_MAX * CLUSTER_WAVE else COPY_CLUSTER)
                   if route == "copies" else CLUSTER_MAX)
    if blocks is None:
        grid = max(cluster, grid // cluster * cluster)
    elif blocks % cluster:
        raise ValueError(f"a grid of {blocks} blocks is not a whole number "
                         f"of clusters of {cluster}")
    one_cluster = route != "global" and grid == cluster
    return Plan(route, lanes, warp_copies, slice_log2, cluster, grid, smem,
                0 if one_cluster else COUNTS_OFFSET + nbins)


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build.load("histogram")
    lib.repro_histogram_init.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.repro_histogram_init.restype = ctypes.c_int
    fn = lib.repro_histogram
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def device_limits(index: int):
    """``(sms, smem_limit)`` of CUDA device ``index``, read once; raises
    each histogram kernel's dynamic shared-memory limit on it, once."""
    sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        rc = _entry().repro_histogram_init(ctypes.byref(sms),
                                           ctypes.byref(smem))
    if rc:
        raise RuntimeError(f"histogram kernel init failed: CUDA error {rc}")
    return sms.value, smem.value


# one zeroed scratch per (device, stream): the kernel leaves it zero, and
# launches on one stream run in order, so it is zero at every launch;
# launches on two streams may overlap and never share one
_SCRATCH = {}


def _scratch(device: torch.device, stream: int, words: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        size = max(words, 2 * buf.numel() if buf is not None else 0)
        buf = _SCRATCH[key] = torch.zeros(size, dtype=torch.int32,  # repro: noqa RPA103 -- keyed by stream
                                          device=device)
    return buf


def _launch(idx: torch.Tensor, nbins: int, pl: Plan) -> torch.Tensor:
    """One launch of plan ``pl`` (uncounted). Returns the counts."""
    dev = idx.device
    out = torch.empty(nbins, dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch = (_scratch(dev, stream, pl.scratch_words).data_ptr()
               if pl.scratch_words else None)
    # shared memory: plan's largest is the copies route's COPY_MAX_BINS words
    # repro: vmem-bound repro_torch.kernels.histogram.kernel.COPY_MAX_BINS
    args = (idx.data_ptr(), idx.shape[0], nbins, ROUTES[pl.route], pl.lanes,
            pl.warp_copies, pl.slice_log2, pl.cluster, pl.blocks,
            pl.smem_bytes, scratch, out.data_ptr(), stream)
    rc = build.call_on(dev, _entry().repro_histogram, *args)
    if rc:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error {rc}")
    return out


def histogram(idx: torch.Tensor, nbins: int) -> torch.Tensor:
    """(N,) int32 CUDA tensor, N % CHUNK == 0 -> (nbins,) float32 counts
    of the indices in ``[0, nbins)``."""
    if not idx.is_cuda:
        raise ValueError(f"histogram kernel needs a CUDA tensor, got "
                         f"{idx.device}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"histogram kernel needs (N,) int32, got "
                        f"{tuple(idx.shape)} {idx.dtype}")
    if not idx.is_contiguous():
        raise ValueError("histogram kernel needs a contiguous tensor")
    n = idx.shape[0]
    if n % CHUNK:
        raise ValueError(f"N={n} is not a multiple of CHUNK={CHUNK}")
    if not 0 < nbins < 1 << 31:
        raise ValueError(f"nbins={nbins} out of range")
    out = _launch(idx, nbins, plan(n, nbins, *device_limits(idx.device.index)))
    histogram.launches += 1  # repro: noqa RPA103 -- launch counter (chip_smoke.py)
    histogram.calls[(n, nbins)] += 1  # repro: noqa RPA103 -- launch counter (chip_smoke.py)
    return out


histogram.launches = 0
histogram.calls = collections.Counter()
