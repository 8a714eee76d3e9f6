"""BAD: host probabilities copied to the card inside the hot path (a
pageable host-to-device copy waits for the stream)."""
import numpy as np
import torch


@torch.compile
def chi2(counts):
    probs = np.full(4, 0.25, np.float32)
    expected = torch.as_tensor(probs, device=counts.device)
    return torch.sum((counts - expected) ** 2 / expected)
