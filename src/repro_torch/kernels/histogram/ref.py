"""Plain PyTorch version of the histogram kernel."""
import torch


def histogram_ref(idx: torch.Tensor, k: int) -> torch.Tensor:
    """(N,) int32 bins -> (k,) float32 counts; values >= k are dropped."""
    return torch.bincount(idx, minlength=k)[:k].to(torch.float32)  # repro: noqa RPA102 -- plain version (PERF.md §7)
