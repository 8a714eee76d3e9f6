"""BAD: `assert` on a tensor inside a compiled function."""
import torch


@torch.compile
def checked_total(x):
    total = torch.sum(x.to(torch.float32))
    assert total >= 0.0, "negative mass"
    return total
