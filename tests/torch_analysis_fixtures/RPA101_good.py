"""GOOD: branching on tensor metadata (host-side) and via torch.where."""
import torch


@torch.compile
def folded(x):
    y = torch.abs(x)
    if y.shape[0] > 4 and y.numel() and y.is_cuda:  # metadata: no sync
        y = y[:4]
    m = torch.mean(y)
    return torch.where(m > 0.0, m, -m)
