# repro: quarantine -- growth-seed LM serving path (qwen2-1.5b); nothing in the battery system imports it
"""Model assembly, dense family (port of ``repro/models/lm.py``).

Public surface:
  model_spec(cfg)                           -> param Spec tree
  init_params(cfg, seed, device=None)       -> materialized params
  forward(params, tokens, cfg)              -> (logits (B, S, V_padded), aux)
  init_cache(cfg, batch, max_seq, ...)      -> decode cache
  count_params(cfg)                         -> int (shape-only)

Weights carry a leading unit dim (the reference's scan-over-layers
layout); the layer scan is a Python loop over it. Other families raise
``NotImplementedError`` (ROADMAP.md, queue 1 item 17).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import act_fn, apply_norm, norm_spec
from repro_torch.models.mlp import mlp, spec_mlp
from repro_torch.models.params import (P, count_spec_params, init_from_spec,
                                       stack_spec, tree_map)


def _check_ported(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.arch_id}) is not ported yet: "
            f"only the dense family is (see ROADMAP.md, queue 1 item 17)")
    act_fn(cfg.act)


def _spec_attn_block(cfg):
    return {
        "pre_attn": norm_spec(cfg.d_model),
        "attn": attn_mod.spec_attention(cfg),
        "pre_mlp": norm_spec(cfg.d_model),
        "mlp": spec_mlp(cfg),
    }


def model_spec(cfg) -> Dict[str, Any]:
    _check_ported(cfg)
    d = cfg.d_model
    spec: Dict[str, Any] = {
        "embed": P((cfg.padded_vocab, d), ("vocab", "embed"), scale=0.02),
        "final_norm": norm_spec(d),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = P((d, cfg.padded_vocab), ("embed", "vocab"))
    spec["units"] = stack_spec({"blk": _spec_attn_block(cfg)}, cfg.n_layers)
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
    """Layer ``i``'s slice of a stacked tree (views, no copy)."""
    return tree_map(lambda a: a[i], stacked)


def embed(params, tokens, cfg):
    return params["embed"][tokens].to(_cdtype(cfg))


def apply_attn_block(p, x, cfg):
    """One pre-norm block on the full sequence; returns (x, (k, v))."""
    h, kv = attn_mod.attention(p["attn"], apply_norm(p["pre_attn"], x, cfg),
                               cfg, return_kv=True)
    x = x + h
    return x + mlp(p["mlp"], apply_norm(p["pre_mlp"], x, cfg), cfg), kv


def forward_hidden(params, tokens, cfg):
    """tokens: (B, S) int -> (final-normed hidden (B, S, D), aux loss)."""
    _check_ported(cfg)
    x = embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        x, _ = apply_attn_block(unit(params["units"], i)["blk"], x, cfg)
    x = apply_norm(params["final_norm"], x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params, tokens, cfg):
    """tokens -> (logits (B, S, V_padded), aux). Materializes full
    logits: for small configs and tests."""
    x, aux = forward_hidden(params, tokens, cfg)
    return _lm_logits(params, x, cfg), aux


def _lm_logits(params, x, cfg):
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return x @ params["lm_head"].to(x.dtype)


def init_cache(cfg, batch: int, max_seq: int, dtype=None, device=None):
    """The decode cache (zeros; prefill fills it): ``pos`` (an int) and
    per-layer k/v of shape (n_layers, B, max_seq, K, dh) in the compute
    dtype, on ``device`` (default ``cuda``)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    cdt = dtype or _cdtype(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    return {"pos": 0,
            "units": {"blk": {"k": torch.zeros(shape, dtype=cdt, device=dev),
                              "v": torch.zeros(shape, dtype=cdt,
                                               device=dev)}}}
