"""GOOD: integer reductions pinned, float reductions tracked."""
import torch


def popcount_ref(rows):
    ones = torch.sum(rows & 1, dim=1, dtype=torch.int32)
    hits = (rows > 0).to(torch.float32)
    return ones, hits.sum(dim=1), torch.cumsum(hits, 0)
