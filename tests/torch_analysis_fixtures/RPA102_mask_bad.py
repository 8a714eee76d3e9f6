"""BAD: boolean-mask indexing: the result's size is the mask's count,
so it waits for the card."""
import torch


@torch.compile
def hits_of(x):
    u = torch.sqrt(x)
    keep = u > 0.5
    return u[keep]
