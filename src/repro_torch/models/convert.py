# repro: quarantine -- growth-seed LM serving path (qwen2-1.5b); nothing in the battery system imports it
"""Carry the reference's parameters across: ``params_from_jax``.

The JAX package's ``init_params`` draws from ``jax.random``, which no
``torch.Generator`` reproduces, so tests that hold the port to the
reference hand it the reference's own weights, as numpy arrays
(``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.models.lm import _pdtype, model_spec
from repro_torch.models.params import P


def params_from_jax(tree, cfg, device=None):
    """The reference's parameter tree (nested dicts of numpy arrays) ->
    the port's, on ``device`` (default ``cuda``). Every key and shape is
    checked against the port's own ``model_spec``; a missing or extra
    leaf, or a shape that differs, raises ``ValueError``."""
    dev = resolve_device(device)
    dtype = _pdtype(cfg)

    def walk(spec, node, path):
        if isinstance(spec, P):
            arr = np.asarray(node)
            if tuple(arr.shape) != spec.shape:
                raise ValueError(f"{path}: shape {arr.shape}, the port's "
                                 f"spec has {spec.shape}")
            return torch.from_numpy(np.array(arr, np.float32)).to(dev, dtype)
        if not isinstance(node, dict):
            raise ValueError(f"{path}: expected a dict, got {type(node)}")
        missing = sorted(set(spec) - set(node))
        extra = sorted(set(node) - set(spec))
        if missing or extra:
            raise ValueError(f"{path or '<root>'}: missing leaves {missing}, "
                             f"extra leaves {extra}")
        return {k: walk(spec[k], node[k], f"{path}/{k}") for k in spec}

    return walk(model_spec(cfg), tree, "")
