"""Public GF(2) rank wrapper with the reference's padding rule
(``repro/kernels/gf2_rank/ops.py``): M is padded to a multiple of
TILE_M with zero matrices. A CUDA tensor goes to the kernel, which reads
the int64 words as they are; a CPU tensor to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.gf2_rank.kernel import TILE_M, gf2_rank
from repro_torch.kernels.gf2_rank.ref import gf2_rank_ref


def rank32(mats: torch.Tensor) -> torch.Tensor:
    """(M, 32) words (int64 in [0, 2^32)) -> (M,) int32 ranks."""
    if mats.dim() != 2 or mats.shape[1] != 32:
        raise TypeError(f"rank32 needs (M, 32) words, got "
                        f"{tuple(mats.shape)}")
    m = mats.shape[0]
    pad = (-m) % TILE_M
    if pad:
        mats = torch.cat([mats, mats.new_zeros((pad, 32))])
    if mats.is_cuda:
        out = gf2_rank(mats.contiguous())
    elif mats.device.type == "cpu":
        out = gf2_rank_ref(mats)
    else:
        raise ValueError(f"no gf2_rank kernel for device {mats.device}")
    return out[:m] if pad else out
