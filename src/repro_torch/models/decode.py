# repro: quarantine -- growth-seed LM serving path (the dense and vlm families); nothing in the battery system imports it
"""Prefill and single-token decode, dense and vlm families (port of
``repro/models/decode.py``; vlm runs as dense there too).

``prefill(params, tokens, cfg, max_seq)`` runs the full-sequence forward
while filling the decode cache. ``decode_step(params, cache, token, cfg)``
writes one token's k/v into the cache in place (the reference returns a
new cache) and returns the cache with ``pos`` advanced. A greedy request
is ``prefill``, then ``argmax`` -> ``decode_step`` per generated token.
Both walk the units and, in each, its blocks by kind
(``lm._unit_structure``: gemma2's local then global block), with the
post-norms where a block has them.
"""
from __future__ import annotations

from repro_torch.models import attention as attn_mod
from repro_torch.models.common import apply_norm
from repro_torch.models.lm import (_lm_logits, _unit_structure,
                                   apply_attn_block, embed, init_cache, unit)
from repro_torch.models.mlp import mlp


def prefill(params, tokens, cfg, max_seq=None):
    """tokens: (B, S) int -> (last-position logits (B, V_padded), cache
    with k/v for positions 0..S-1, zeros after, ``pos`` = S)."""
    b, s = tokens.shape
    max_seq = max_seq or s
    cache = init_cache(cfg, b, max_seq, device=tokens.device)
    n_units, blocks = _unit_structure(cfg)
    x = embed(params, tokens, cfg)
    for i in range(n_units):
        up = unit(params["units"], i)
        for key, kind in blocks:
            x, (k, v) = apply_attn_block(up[key], x, cfg, kind)
            cache["units"][key]["k"][i, :, :s] = k
            cache["units"][key]["v"][i, :, :s] = v
    cache["pos"] = s
    xl = apply_norm(params["final_norm"], x[:, -1:], cfg)
    return _lm_logits(params, xl, cfg)[:, 0], cache


def _block_decode(p, x, ck, cv, pos, cfg, kind):
    h, _, _ = attn_mod.attention_decode(
        p["attn"], apply_norm(p["pre_attn"], x, cfg), ck, cv, pos, cfg,
        kind=kind)
    if "post_attn" in p:
        h = apply_norm(p["post_attn"], h, cfg)
    x = x + h
    h = mlp(p["mlp"], apply_norm(p["pre_mlp"], x, cfg), cfg)
    if "post_mlp" in p:
        h = apply_norm(p["post_mlp"], h, cfg)
    return x + h


def decode_step(params, cache, token, cfg):
    """token: (B, 1) int. Returns (logits (B, V_padded), cache): the same
    cache, written in place at ``pos``, with ``pos`` advanced by one."""
    pos = cache["pos"]
    n_units, blocks = _unit_structure(cfg)
    x = embed(params, token, cfg)
    for i in range(n_units):
        up = unit(params["units"], i)
        for key, kind in blocks:
            kv = cache["units"][key]
            x = _block_decode(up[key], x, kv["k"][i], kv["v"][i], pos, cfg,
                              kind)
    cache["pos"] = pos + 1
    xl = apply_norm(params["final_norm"], x, cfg)
    return _lm_logits(params, xl, cfg)[:, 0], cache
