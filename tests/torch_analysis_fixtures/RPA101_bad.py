"""BAD: Python `if` on a tensor inside a compiled function."""
import torch


@torch.compile
def clipped_mean(x):
    m = torch.mean(x)
    if m > 0.0:
        return m
    return -m
