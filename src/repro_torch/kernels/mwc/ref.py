"""Plain version of the mwc kernel: the sequential loop over Python
ints that the port's ``mwc_block`` ran before the kernel, unchanged."""
import torch

from repro_torch.common.device import resolve_device

MASK32 = 0xFFFFFFFF
MWC_A = 4294957665


def mwc_ref(x0: int, c0: int, n: int, device=None) -> torch.Tensor:
    """Words ``[0, n)`` from the state ``(x0, c0)``: ``t = a*x + c``,
    ``x = t mod 2^32``, ``c = t >> 32``, word i the x after step i + 1;
    an int64 tensor on ``device``."""
    x, c = x0, c0
    out = [0] * n
    for i in range(n):
        t = MWC_A * x + c
        x, c = t & MASK32, t >> 32
        out[i] = x
    return torch.tensor(out, dtype=torch.int64).to(resolve_device(device))  # repro: noqa RPA102 -- CPU plain loop
