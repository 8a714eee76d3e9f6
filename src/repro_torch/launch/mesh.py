"""The pool's worker slots (``repro/launch/mesh.py``, pool half).

The reference spreads W workers over a 1-D device mesh. Here W is a
number of logical slots; placement is metadata (DESIGN.md §6): every
slot's jobs run on the pool's device, and job identity, sub-streams and
results never depend on W.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.common.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PoolMesh:
    """W logical worker slots on one device."""
    n_workers: int
    device: torch.device


def make_pool_mesh(n_workers: Optional[int] = None,
                   device=None) -> PoolMesh:
    """A pool of ``n_workers`` slots on ``device`` (default ``cuda``).
    ``None``/0 means one slot per visible device of that type."""
    dev = resolve_device(device)
    n = n_workers or (torch.cuda.device_count() if dev.type == "cuda" else 1)
    if n < 1:
        raise ValueError(f"pool width must be >= 1, got {n}")
    return PoolMesh(int(n), dev)
