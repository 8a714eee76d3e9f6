"""BAD: `.item()` on a tensor inside the hot path."""
import torch


@torch.compile
def count_of(x):
    hits = torch.sum(x > 0.5)
    return hits.item()
