# repro: quarantine -- growth-seed LM training path; nothing in the battery system imports it
"""AdamW and its schedule (port of ``repro/train/optim.py``).

Optimizer state is a tree parallel to the parameters: first and second
moments in ``adam_dtype`` (bfloat16 for the 340B preset, an 8-bit-Adam-
class footprint) and an int32 step. The update is the reference's,
computed in float32 per leaf: global-norm clipping, bias-corrected
moments, decoupled weight decay on every leaf, a warmup-then-cosine
learning rate. Where the reference returns new arrays, ``adamw_update``
writes the new parameters and moments into the tensors it is given (in
place, under ``no_grad``), so a step holds no second copy of either; the
schedule and the metrics stay tensors on the parameters' device (no host
sync).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.models.params import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 200
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def lr_at(step, oc: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), float32: a
    linear warmup over ``warmup_steps``, then a cosine from ``lr`` down to
    ``min_lr_frac * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max((step + 1) / max(oc.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = oc.min_lr_frac + (1 - oc.min_lr_frac) * cos
    return oc.lr * warm * frac


def init_opt_state(params, adam_dtype=torch.float32) -> Dict[str, Any]:
    """Zero moments ``m`` and ``v`` in ``adam_dtype`` beside each
    parameter (on its device), and step 0 (int32)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=adam_dtype, device=p.device)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(params, grads, opt_state, oc: OptConfig):
    """One AdamW step: (params, opt_state, {"grad_norm", "lr"}) with the
    new parameters and moments written into ``params`` and
    ``opt_state`` in place (the same dicts come back) and the step
    advanced. ``grads`` is a tree like ``params`` (any float dtype)."""
    step = opt_state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp_max(oc.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_at(step, oc)
    b1, b2 = oc.b1, oc.b2
    t = step.to(torch.float32) + 1
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(opt_state["m"]), leaves(opt_state["v"])):
        g32 = g.float() * scale
        m32 = m.float() * b1 + (1 - b1) * g32
        v32 = v.float() * b2 + (1 - b2) * g32.square()
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + oc.eps)
        delta += oc.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    opt_state["step"] = step + 1
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
