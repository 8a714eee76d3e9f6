"""ctypes launcher of the CUDA GF(2) rank (``gf2_rank.cu``).

Replaces the Pallas kernel ``src/repro/kernels/gf2_rank/kernel.py``
(``gf2_rank``). ``gf2_rank.launches`` counts launches and
``gf2_rank.calls`` counts them by ``M``; nothing else touches either.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build

# the reference's tile: rank32 pads M to a multiple of it
TILE_M = 256


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("gf2_rank").repro_gf2_rank32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gf2_rank(mats: torch.Tensor) -> torch.Tensor:
    """(M, 32) int32 CUDA tensor of uint32 row bit patterns,
    M % TILE_M == 0 -> (M,) int32 ranks."""
    if not mats.is_cuda:
        raise ValueError(f"gf2_rank kernel needs a CUDA tensor, got "
                         f"{mats.device}")
    if mats.dtype != torch.int32 or mats.dim() != 2 or mats.shape[1] != 32:
        raise TypeError(f"gf2_rank kernel needs (M, 32) int32, got "
                        f"{tuple(mats.shape)} {mats.dtype}")
    if not mats.is_contiguous():
        raise ValueError("gf2_rank kernel needs a contiguous tensor")
    m = mats.shape[0]
    if m % TILE_M:
        raise ValueError(f"M={m} is not a multiple of TILE_M={TILE_M}")
    ranks = torch.empty(m, dtype=torch.int32, device=mats.device)
    with torch.cuda.device(mats.device):
        rc = _entry()(mats.data_ptr(), m, ranks.data_ptr(),
                      torch.cuda.current_stream(mats.device).cuda_stream)
    if rc:
        raise RuntimeError(f"gf2_rank kernel launch failed: CUDA error {rc}")
    gf2_rank.launches += 1
    gf2_rank.calls[m] += 1
    return ranks


gf2_rank.launches = 0
gf2_rank.calls = collections.Counter()
