"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless the caller names another
device. Asking for ``cuda`` on a machine without a card raises: a run
that silently fell back to the CPU would report CPU work as the card's.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on cuda by default and no CUDA device is "
            "available; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch versions on the CPU")
    return dev
