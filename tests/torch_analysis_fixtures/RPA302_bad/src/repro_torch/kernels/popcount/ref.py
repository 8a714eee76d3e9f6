"""BAD: an unpinned integer reduction in a kernel's plain version: torch
widens it to int64, so its dtype differs from the kernel's int32."""
import torch


def popcount_ref(rows):
    return torch.sum(rows & 1, dim=1)
