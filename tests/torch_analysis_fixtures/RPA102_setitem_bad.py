"""BAD: a host value written into a tensor by indexing: torch builds the
value on the host and copies it to the card."""
import torch


@torch.compile
def chain_start(n, device):
    on_chain = torch.zeros(n + 1, dtype=torch.int32, device=device)
    on_chain[0] = 1
    return on_chain
