"""GOOD: locals may accumulate freely inside a hot-path function."""
import torch


@torch.compile
def stacked(x):
    parts = []
    for i in range(3):  # a host loop over local state
        parts.append(x + i)
    return torch.stack(parts)
