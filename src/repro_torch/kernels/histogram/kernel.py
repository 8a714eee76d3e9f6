"""ctypes launcher of the CUDA bin-count (``histogram.cu``).

Replaces the Pallas kernel ``src/repro/kernels/histogram/kernel.py``
(``histogram``). ``histogram.launches`` counts launches and
``histogram.calls`` counts them by ``(N, nbins)``; nothing else touches
either.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build

# the reference's chunk: bincount pads N to a multiple of it
CHUNK = 2048


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("histogram").repro_histogram
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    counts = torch.empty(nbins, dtype=torch.int32, device=idx.device)
    out = torch.empty(nbins, dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        rc = _entry()(idx.data_ptr(), n, nbins, counts.data_ptr(),
                      out.data_ptr(),
                      torch.cuda.current_stream(idx.device).cuda_stream)
    if rc:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error {rc}")
    histogram.launches += 1
    histogram.calls[(n, nbins)] += 1
    return out


histogram.launches = 0
histogram.calls = collections.Counter()
