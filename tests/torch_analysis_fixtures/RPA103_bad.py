"""BAD: a compiled function appends to module state: shared with every
thread that runs rounds."""
import torch

_TRACE_LOG = []


@torch.compile
def logged_sum(x):
    _TRACE_LOG.append(x.shape)
    return torch.sum(x.to(torch.float32))
