"""BAD: a device-to-host copy (`.cpu()`) inside the hot path."""
import torch


@torch.compile
def pulled(x):
    y = torch.sort(x).values
    return y.cpu()
