"""BAD: torch.bincount: its result's size is data, so it waits for the
card."""
import torch


@torch.compile
def counts(idx, k):
    return torch.bincount(idx, minlength=k)[:k]
