# repro: quarantine -- growth-seed LM serving path (qwen2-1.5b); nothing in the battery system imports it
"""Parameter-spec machinery (port of ``repro/models/params.py``).

Every module declares its parameters once as a spec tree (nested dicts)
of ``P`` entries: shape, logical axes and initializer. ``init_from_spec``
materializes it; ``count_spec_params`` counts it from shapes alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"           # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


Spec = Dict[str, Any]  # nested dict of P


def stack_spec(spec: Spec, n: int, axis_name: Optional[str] = "layers") -> Spec:
    """Prepend a stacking dim (the layer loop's weights)."""
    out = {}
    for k, v in spec.items():
        if isinstance(v, dict):
            out[k] = stack_spec(v, n, axis_name)
        else:
            out[k] = P((n,) + v.shape, (axis_name,) + v.axes, v.init, v.scale)
    return out


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts, in sorted key order (the
    order ``jax.tree_util`` walks a dict)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def leaves(tree: Any) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def init_from_spec(spec: Spec, generator: torch.Generator,
                   dtype=torch.float32, device=None):
    """Materialize ``spec``: normal x ``scale``, zeros or ones, drawn leaf
    by leaf in sorted key order from ``generator`` (which lives on
    ``device``). The scheme is the reference's; the numbers are not
    (``torch.Generator`` is not ``jax.random``)."""
    def make(p: P):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=device)
        return torch.randn(p.shape, generator=generator, dtype=dtype,
                           device=device).mul_(p.scale)
    return tree_map(make, spec)


def count_spec_params(spec: Spec) -> int:
    return int(sum(math.prod(p.shape) for p in leaves(spec)))
