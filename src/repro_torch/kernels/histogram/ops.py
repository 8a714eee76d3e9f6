"""Public bin-count wrapper with the reference's padding rule
(``repro/kernels/histogram/ops.py``): N is padded to a multiple of
CHUNK with the index ``k``, which lands in an extra bin that is sliced
off. A CUDA tensor goes to the kernel; a CPU tensor to the plain
version."""
from __future__ import annotations

import torch

from repro_torch.kernels.histogram.kernel import CHUNK, histogram
from repro_torch.kernels.histogram.ref import histogram_ref


def bincount(idx: torch.Tensor, k: int) -> torch.Tensor:
    """(N,) int32 bin indices in ``[0, k)`` -> (k,) float32 counts."""
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"bincount needs (N,) int32, got "
                        f"{tuple(idx.shape)} {idx.dtype}")
    pad = (-idx.shape[0]) % CHUNK
    if pad:
        idx = torch.cat([idx, idx.new_full((pad,), k)])
    nbins = k + (1 if pad else 0)
    if idx.is_cuda:
        out = histogram(idx.contiguous(), nbins)
    elif idx.device.type == "cpu":
        out = histogram_ref(idx, nbins)
    else:
        raise ValueError(f"no histogram kernel for device {idx.device}")
    return out[:k]
