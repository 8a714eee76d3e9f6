"""BAD: host numpy called on a tensor inside the hot path."""
import numpy as np
import torch


@torch.compile
def host_round_trip(x):
    y = torch.cumsum(x, 0)
    return np.asarray(y)
