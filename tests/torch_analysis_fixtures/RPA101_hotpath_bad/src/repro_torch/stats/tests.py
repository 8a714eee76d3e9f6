"""BAD: a plain function in a hot-path module (no decorator needed)
branches on a tensor."""
import torch


def hamcorr(bits, n=65536):
    w = torch.sum(bits[:n])
    if w > n:
        return w - n
    return w
