# repro: quarantine -- growth-seed LM training path; nothing in the battery system imports it
"""The train step: gradient accumulation + AdamW (port of
``repro/train/step.py``).

``make_train_step(cfg, oc)`` returns ``train_step(state, batch)`` where
``state = {"params", "opt"}`` and ``batch = {"tokens", "labels"[,
"frames"]}`` with the global batch leading. Accumulation
(``cfg.train_accum``) runs microbatches one after another, as the
reference's ``lax.scan``: ``eff = min(accum, batch)``, lowered until it
divides the batch; each microbatch's gradients are summed in float32 and
the sum divided by ``eff``, the loss likewise. Only one microbatch's
activations are live at a time.
"""
from __future__ import annotations

import torch

from repro_torch.models.lm import loss_fn
from repro_torch.models.params import leaves, tree_map
from repro_torch.train.optim import OptConfig, adamw_update


def microbatches(b: int, accum: int) -> int:
    """The reference's microbatch count for a batch of ``b``:
    ``min(accum, b)``, lowered until it divides ``b``."""
    eff = min(max(accum, 1), b)
    while b % eff:
        eff -= 1
    return eff


def _tree_like(tree, flat):
    """``flat`` (in ``leaves(tree)``'s order) in ``tree``'s structure."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def value_and_grad(params, batch, cfg):
    """(loss, grads) of ``loss_fn`` at ``params``; grads a tree like
    ``params`` in their dtypes (zeros where a leaf takes no part)."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), _tree_like(params, grads)


def make_train_step(cfg, oc: OptConfig):
    accum = max(cfg.train_accum, 1)

    def compute_grads(params, batch):
        b = batch["tokens"].shape[0]
        eff = microbatches(b, accum)
        if eff == 1:
            return value_and_grad(params, batch, cfg)
        mb = b // eff
        flat = leaves(params)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in flat]
        loss_sum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        for i in range(eff):
            micro = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
            loss, grads = value_and_grad(params, micro, cfg)
            for acc, g in zip(gsum, leaves(grads)):
                acc.add_(g.float())
            loss_sum = loss_sum + loss
            del grads
        return loss_sum / eff, _tree_like(params, [g.div_(eff) for g in gsum])

    def train_step(state, batch):
        params = state["params"]
        loss, grads = compute_grads(params, batch)
        params, opt, metrics = adamw_update(params, grads, state["opt"], oc)
        metrics = dict(metrics, loss=loss)
        return {"params": params, "opt": opt}, metrics

    return train_step
