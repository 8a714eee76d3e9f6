# repro: quarantine -- growth-seed LM serving path (the moe family); nothing in the battery system imports it
"""Mixture-of-Experts layer: capacity-based top-k routing within groups of
tokens, scatter dispatch and gather combine by slot, DeepSeek-style
shared experts and the router's aux loss (port of
``repro/models/moe.py``).

The arithmetic is the reference's, step for step: groups of
``MOE_GROUP`` tokens (halved while they do not divide the token count),
a capacity ``max(int(capacity_factor * G * top_k / n_experts), 4)`` per
(group, expert), the softmax in float32 over router logits computed in
the input's dtype, top-k gates renormalized (floored at 1e-9), each
assignment's place in its (group, expert) buffer by an exclusive count
in token-major, then k, order, and assignments past the capacity
dropped (gate 0).

Top-k takes the lower expert index first among equal probabilities, as
``jax.lax.top_k`` does (``torch.topk`` does not promise an order among
ties; a stable descending sort does): bfloat16 router logits tie often.

Dispatch copies each kept token into its slot ``expert * C + pos`` of
its group's buffer; dropped assignments go to one extra row that is
thrown away. The reference scatter-adds instead (``add(mode="drop")``)
with dropped tokens multiplied by 0 and sent to slot ``C - 1``; kept
slots are unique within a group, so both give each kept slot its token
and every other slot zeros. Combine gathers each assignment's slot and
sums with the gates, where a dropped one's gate is 0.

Nothing here reads a tensor back to the host. The experts and the
shared experts are ``mlp.mlp`` (gated or not by the weights present,
``cfg.act``): ``torch.matmul`` batches the expert products
``(E, n*C, d) x (E, d, f)`` over experts, as the reference leaves them to
XLA outside any kernel.
"""
from __future__ import annotations

import torch

from repro_torch.models.mlp import mlp
from repro_torch.models.params import P

MOE_GROUP = 2048   # tokens per routing group (bounds capacity)


def spec_moe(cfg):
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    spec = {
        "router": P((d, e), ("embed", "experts"), scale=0.006),
        "w_in": P((e, d, f), ("experts", "embed", "mlp")),
        "w_out": P((e, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.gated_mlp:
        spec["w_gate"] = P((e, d, f), ("experts", "embed", "mlp"))
    if m.n_shared:
        fs = m.d_ff_shared * m.n_shared
        spec["shared"] = {
            "w_in": P((d, fs), ("embed", "mlp")),
            "w_out": P((fs, d), ("mlp", "embed")),
        }
        if cfg.gated_mlp:
            spec["shared"]["w_gate"] = P((d, fs), ("embed", "mlp"))
    return spec


def groups(t: int, m):
    """(group size, number of groups, capacity) for ``t`` tokens."""
    g_sz = min(MOE_GROUP, t)
    while t % g_sz:
        g_sz //= 2
    capacity = max(int(m.capacity_factor * g_sz * m.top_k / m.n_experts), 4)
    return g_sz, t // g_sz, capacity


def route(p, xt, m):
    """Router of tokens ``xt`` (T, d) -> (probs (T, E) float32, top-k gates
    (T, k) float32 renormalized, expert ids (T, k) int64), the lower id
    first among equal probabilities."""
    logits = xt @ p["router"].to(xt.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :m.top_k], idx[:, :m.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, experts


def moe(p, x, cfg):
    """x: (B, S, D) -> (y (B, S, D), aux loss: a float32 scalar times
    ``router_aux_coef``)."""
    m = cfg.moe
    b, s, d = x.shape
    t, e, k = b * s, m.n_experts, m.top_k
    g_sz, n_g, cap = groups(t, m)
    xt = x.reshape(t, d)
    probs, gates, experts = route(p, xt, m)
    flat = experts.reshape(n_g, g_sz * k)          # token-major, then k
    counts = torch.zeros((n_g, e), dtype=flat.dtype, device=x.device) \
        .scatter_add_(1, flat, torch.ones_like(flat))
    # aux load-balance loss (Switch/GShard form)
    ce = counts.sum(dim=0).float() / (t * k)
    aux = e * torch.sum(probs.mean(dim=0) * ce)

    # each assignment's place in its (group, expert) buffer: the count of
    # earlier assignments to that expert in the group, token-major then k
    # (the reference's exclusive cumsum of one-hots). A stable sort by
    # expert keeps that order within each expert's run, so the count is
    # the rank in the run: sorted index minus where the run starts
    order = torch.argsort(flat, dim=1, stable=True)
    start = counts.cumsum(dim=1) - counts
    rank = (torch.arange(g_sz * k, device=x.device)
            - start.gather(1, flat.gather(1, order)))
    pos = torch.empty_like(flat).scatter_(1, order, rank).reshape(t, k)
    keep = pos < cap
    gates = gates * keep
    grp = torch.arange(t, device=x.device) // g_sz
    slot = (grp[:, None] * (e * cap) + experts * cap
            + pos.clamp_max(cap - 1))                           # (T, k)
    n_slots = n_g * e * cap
    dest = torch.where(keep, slot, n_slots).reshape(-1)
    buf = x.new_zeros((n_slots + 1, d))
    buf[dest] = xt.repeat_interleave(k, dim=0)
    expert_in = buf[:n_slots].reshape(n_g, e, cap, d).transpose(0, 1) \
        .reshape(e, n_g * cap, d)

    expert_out = mlp(p, expert_in, cfg)        # batched over experts
    out_flat = expert_out.reshape(e, n_g, cap, d).transpose(0, 1) \
        .reshape(n_slots, d)
    gathered = out_flat[slot.reshape(-1)].reshape(t, k, d)
    y = torch.einsum("tkd,tk->td", gathered, gates.to(x.dtype))
    if m.n_shared:
        y = y + mlp(p["shared"], xt, cfg)
    return y.reshape(b, s, d), aux * m.router_aux_coef
