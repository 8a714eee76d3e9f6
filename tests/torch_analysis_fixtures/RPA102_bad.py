"""BAD: float() brings a tensor's value to the host (a sync)."""
import torch


@torch.compile
def scale_of(x):
    s = torch.std(x)
    return x / float(s)
