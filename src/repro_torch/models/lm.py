# repro: quarantine -- growth-seed LM serving path (the dense and vlm families); nothing in the battery system imports it
"""Model assembly, dense and vlm families (port of ``repro/models/lm.py``).

Public surface:
  model_spec(cfg)                           -> param Spec tree
  init_params(cfg, seed, device=None)       -> materialized params
  forward(params, tokens, cfg)              -> (logits (B, S, V_padded), aux)
  init_cache(cfg, batch, max_seq, ...)      -> decode cache
  count_params(cfg)                         -> int (shape-only)

Weights carry a leading unit dim (the reference's scan-over-layers
layout); the layer scan is a Python loop over it. A unit holds one block
per kind of ``cfg.attn_pattern``: one ``blk`` (global) for a
one-kind pattern, as qwen2's, and ``local`` and ``global`` blocks for
gemma2's ``("local", "global")``, so ``n_layers / len(pattern)`` units.
gemma2 (``arch_id`` starting with ``gemma2``) also scales the embedding
by ``sqrt(d_model)``, cast to the compute dtype first as the reference
does, adds post-norms on each block's attention and MLP outputs
(``post_block_norm``) and softcaps the final logits. The vlm family
(chameleon) runs as dense, as in the reference: its ``fused`` frontend
takes token ids over the fused text and image vocabulary, so there is
no frontend code. Other families and frontends raise
``NotImplementedError`` (ROADMAP.md, queue 1 item 4).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import act_fn, apply_norm, norm_spec, softcap
from repro_torch.models.mlp import mlp, spec_mlp
from repro_torch.models.params import (P, count_spec_params, init_from_spec,
                                       stack_spec, tree_map)


FAMILIES = ("dense", "vlm")
FRONTENDS = ("tokens", "fused")


def _check_ported(cfg):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.arch_id}) is not ported yet: "
            f"only {FAMILIES} are (see ROADMAP.md, queue 1 item 4)")
    if cfg.frontend not in FRONTENDS:
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} ({cfg.arch_id}) is not ported yet: "
            f"only {FRONTENDS} are (see ROADMAP.md, queue 1 item 4)")
    act_fn(cfg.act)


def _spec_attn_block(cfg):
    spec = {
        "pre_attn": norm_spec(cfg.d_model),
        "attn": attn_mod.spec_attention(cfg),
        "pre_mlp": norm_spec(cfg.d_model),
        "mlp": spec_mlp(cfg),
    }
    if cfg.post_block_norm:
        spec["post_attn"] = norm_spec(cfg.d_model)
        spec["post_mlp"] = norm_spec(cfg.d_model)
    return spec


def _unit_structure(cfg):
    """(n_units, [(key, kind), ...]) for the loop over units: each unit's
    blocks in order, by their key in the unit's parameters and cache
    (``blk`` for a one-kind pattern, the kind itself otherwise) and their
    attention kind (a one-kind pattern runs global, as in the reference)."""
    pat = cfg.attn_pattern
    if cfg.n_layers % len(pat):
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of the "
                         f"attention pattern {pat}")
    n_units = cfg.n_layers // len(pat)
    if len(pat) > 1:
        return n_units, [(kind, kind) for kind in pat]
    return n_units, [("blk", "global")]


def model_spec(cfg) -> Dict[str, Any]:
    _check_ported(cfg)
    d = cfg.d_model
    spec: Dict[str, Any] = {
        "embed": P((cfg.padded_vocab, d), ("vocab", "embed"), scale=0.02),
        "final_norm": norm_spec(d),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = P((d, cfg.padded_vocab), ("embed", "vocab"))
    n_units, blocks = _unit_structure(cfg)
    spec["units"] = stack_spec({key: _spec_attn_block(cfg)
                                for key, _ in blocks}, n_units)
    return spec


def _pdtype(cfg):
    return getattr(torch, cfg.param_dtype)


def _cdtype(cfg):
    return getattr(torch, cfg.compute_dtype)


def init_params(cfg, seed: int = 0, device=None):
    """Parameters of ``cfg`` from a ``torch.Generator`` seeded with
    ``seed``, on ``device`` (default ``cuda``; raises without a card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_from_spec(model_spec(cfg), gen, _pdtype(cfg), dev)


def count_params(cfg) -> int:
    return count_spec_params(model_spec(cfg))


def unit(stacked, i):
    """Unit ``i``'s slice of a stacked tree (views, no copy)."""
    return tree_map(lambda a: a[i], stacked)


def embed(params, tokens, cfg):
    cdt = _cdtype(cfg)
    x = params["embed"][tokens].to(cdt)
    if cfg.arch_id.startswith("gemma2"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt)
    return x


def apply_attn_block(p, x, cfg, kind="global"):
    """One pre-norm block on the full sequence, with post-norms where the
    block has them; returns (x, (k, v))."""
    h, kv = attn_mod.attention(p["attn"], apply_norm(p["pre_attn"], x, cfg),
                               cfg, kind=kind, return_kv=True)
    if "post_attn" in p:
        h = apply_norm(p["post_attn"], h, cfg)
    x = x + h
    h = mlp(p["mlp"], apply_norm(p["pre_mlp"], x, cfg), cfg)
    if "post_mlp" in p:
        h = apply_norm(p["post_mlp"], h, cfg)
    return x + h, kv


def forward_hidden(params, tokens, cfg):
    """tokens: (B, S) int -> (final-normed hidden (B, S, D), aux loss)."""
    _check_ported(cfg)
    n_units, blocks = _unit_structure(cfg)
    x = embed(params, tokens, cfg)
    for i in range(n_units):
        up = unit(params["units"], i)
        for key, kind in blocks:
            x, _ = apply_attn_block(up[key], x, cfg, kind)
    x = apply_norm(params["final_norm"], x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params, tokens, cfg):
    """tokens -> (logits (B, S, V_padded), aux). Materializes full
    logits: for small configs and tests."""
    x, aux = forward_hidden(params, tokens, cfg)
    return _lm_logits(params, x, cfg), aux


def _lm_logits(params, x, cfg):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    return softcap(logits, cfg.final_softcap)


def init_cache(cfg, batch: int, max_seq: int, dtype=None, device=None):
    """The decode cache (zeros; prefill fills it): ``pos`` (an int) and,
    per block key of a unit, k/v of shape (n_units, B, max_seq, K, dh) in
    the compute dtype, on ``device`` (default ``cuda``)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    cdt = dtype or _cdtype(cfg)
    n_units, blocks = _unit_structure(cfg)
    shape = (n_units, batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    return {"pos": 0,
            "units": {key: {"k": torch.zeros(shape, dtype=cdt, device=dev),
                            "v": torch.zeros(shape, dtype=cdt, device=dev)}
                      for key, _ in blocks}}
