"""Public mwc wrapper: the kernel for a CUDA device, the plain loop for
the CPU (``rng/generators.py::mwc_block`` calls it)."""
from __future__ import annotations

import torch

from repro_torch.common.device import resolve_device
from repro_torch.kernels.mwc.kernel import mwc_words
from repro_torch.kernels.mwc.ref import mwc_ref


def mwc(x0: int, c0: int, n: int, device=None) -> torch.Tensor:
    """Words ``[0, n)`` of the multiply-with-carry sequence from the state
    ``(x0, c0)``, int64 on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return mwc_words(x0, c0, n, dev)
    if dev.type == "cpu":
        return mwc_ref(x0, c0, n, dev)
    raise ValueError(f"no mwc kernel for device {dev}")
