# repro: quarantine -- growth-seed LM serving path (every family of the reference); nothing in the battery system imports it
"""Prefill and single-token decode, dense, vlm, moe, audio, ssm and
hybrid families (port of ``repro/models/decode.py``; vlm runs as dense
there too).

``prefill(params, tokens, cfg, max_seq, frames=None)`` runs the
full-sequence forward while filling the decode cache. ``decode_step(params, cache, token, cfg)``
writes one token's cache entries in place (the reference returns a new
cache) and returns the cache with ``pos`` advanced. A greedy request is
``prefill``, then ``argmax`` -> ``decode_step`` per generated token.
Both walk the stacks of ``lm.stacks`` (moe: the leading dense layers,
then the MoE units) and, in each unit, its blocks by kind (gemma2's
local then global block), with the post-norms where a block has them.
A GQA block caches k/v; an MLA block (deepseek-v2) caches its latent
``ckv`` and rope key ``kr`` and decodes in the absorbed form. The MoE
layer routes the B tokens of a decode step as their own group, as in
the reference.

The recurrent families keep states, not a history. xlstm's prefill runs
each block's chunked (mLSTM) or looped (sLSTM) form and stores its final
state; its decode advances each state one step in the recurrent form.
zamba2's prefill stores each application of the shared block's k/v in
its own slot and each Mamba-2 layer's conv tail and SSD state; its
decode attends over the slot and advances the states. Decode writes the
new states into the cache in place, as it writes k/v.

whisper (the audio family) prefills from its ``frames``: the encoder
runs once, each decoder block caches its self-attention's k/v (padded
to ``max_seq``) and its cross attention's k/v over the encoder output
(``cross``, ``encoder_seq`` rows). Its decode adds ``pos_embed[pos]``,
attends over the self-attention cache, then over the fixed cross cache,
which it leaves as it is.
"""
from __future__ import annotations

from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import apply_norm
from repro_torch.models.lm import (SHARED, _lm_logits, apply_attn_block,
                                   apply_mlp, block_cache, block_params,
                                   check_frames, decoder_block, embed, encode,
                                   group_cache, group_params, hybrid_groups,
                                   init_cache, n_superblocks, stacks, unit)
from repro_torch.models.mlp import mlp


def _store(leaves, index, state):
    """Write ``state``'s tensors into the cache ``leaves`` at ``index``."""
    for name, val in state.items():
        leaves[name][index] = val


def _prefill_recurrent(params, x, cache, cfg, s):
    """The ssm and hybrid families' layers over the prompt ``x``, filling
    ``cache`` (``s`` prompt positions of zamba2's k/v)."""
    if cfg.family == "ssm":
        n_super, n_m = n_superblocks(cfg)
        for i in range(n_super):
            up = unit(params["units"], i)
            for j in range(n_m):
                y, st = xlstm_mod.mlstm(unit(up["mlstm"], j), x, cfg,
                                        return_state=True)
                x = x + y
                _store(cache["mlstm"], (i, j), st)
            y, st = xlstm_mod.slstm(up["slstm"], x, cfg, return_state=True)
            x = x + y
            _store(cache["slstm"], i, st)
        return x
    for slot, i, n in hybrid_groups(cfg):
        x, kv, _ = apply_attn_block(params["shared_block"], x, cfg, SHARED)
        for name, val in kv.items():
            cache["attn"][name][slot, :, :s] = val
        layers, states = group_params(params, i), group_cache(cache, i)
        for j in range(n):
            # from the cache's zero states, as the reference's prefill
            y, conv, ssm = ssm_mod.mamba2(unit(layers, j), x, cfg,
                                          states["conv"][j],
                                          states["ssm"][j])
            x = x + y
            _store(states, j, {"conv": conv, "ssm": ssm})
    return x


def _decode_recurrent(params, x, cache, pos, cfg):
    """One token through the ssm and hybrid families' layers, advancing
    ``cache``'s states (and zamba2's k/v at ``pos``) in place."""
    if cfg.family == "ssm":
        n_super, n_m = n_superblocks(cfg)
        for i in range(n_super):
            up = unit(params["units"], i)
            for j in range(n_m):
                y, st = xlstm_mod.mlstm_decode(
                    unit(up["mlstm"], j), x,
                    unit(cache["mlstm"], (i, j)), cfg)
                x = x + y
                _store(cache["mlstm"], (i, j), st)
            y, st = xlstm_mod.slstm_decode(up["slstm"], x,
                                           unit(cache["slstm"], i), cfg)
            x = x + y
            _store(cache["slstm"], i, st)
        return x
    for slot, i, n in hybrid_groups(cfg):
        x = _block_decode(params["shared_block"], x, cache["attn"], slot,
                          pos, cfg, SHARED)
        layers, states = group_params(params, i), group_cache(cache, i)
        for j in range(n):
            y, conv, ssm = ssm_mod.mamba2_decode(
                unit(layers, j), x, states["conv"][j], states["ssm"][j], cfg)
            x = x + y
            _store(states, j, {"conv": conv, "ssm": ssm})
    return x


def _prefill_whisper(params, x, frames, cache, cfg, s):
    """whisper's encoder over ``frames``, then its decoder over the
    prompt ``x``, filling the self-attention k/v (``s`` positions) and
    the cross k/v of the cache."""
    enc = encode(params, frames, cfg)
    x = x + params["pos_embed"][:s].to(x.dtype)[None]
    for i in range(cfg.n_layers):
        x, kv, cross = decoder_block(unit(params["units"], i), x, enc, cfg)
        for name, val in kv.items():
            cache["units"][name][i, :, :s] = val
        _store(cache["cross"], i, cross)
    return x


def _decode_whisper(params, x, cache, pos, cfg):
    """One token through whisper's decoder: its learned position, then
    per block self-attention over the cache (written at ``pos`` in place),
    cross attention over the fixed cross cache and the MLP."""
    x = x + params["pos_embed"][pos].to(x.dtype)
    for i in range(cfg.n_layers):
        p = unit(params["units"], i)
        h, _, _ = attn_mod.attention_decode(
            p["attn"], apply_norm(p["pre_attn"], x, cfg),
            cache["units"]["k"][i], cache["units"]["v"][i], pos, cfg)
        x = x + h
        x = x + attn_mod.cross_attention_decode(
            p["cross"], apply_norm(p["pre_cross"], x, cfg),
            cache["cross"]["k"][i], cache["cross"]["v"][i], cfg)
        x = x + mlp(p["mlp"], apply_norm(p["pre_mlp"], x, cfg), cfg)
    return x


def prefill(params, tokens, cfg, max_seq=None, frames=None):
    """tokens: (B, S) int (and, for the audio family, ``frames`` (B,
    encoder_seq, D)) -> (last-position logits (B, V_padded), cache with
    entries for positions 0..S-1, zeros after, ``pos`` = S)."""
    b, s = tokens.shape
    max_seq = max_seq or s
    check_frames(cfg, tokens, frames)
    if frames is not None and frames.shape[1] != cfg.encoder_seq:
        raise ValueError(f"{cfg.arch_id}: the cross cache holds "
                         f"encoder_seq={cfg.encoder_seq} frames, got "
                         f"{frames.shape[1]}")
    cache = init_cache(cfg, b, max_seq, device=tokens.device)
    x = embed(params, tokens, cfg)
    if cfg.family in ("ssm", "hybrid"):
        x = _prefill_recurrent(params, x, cache, cfg, s)
    elif cfg.family == "audio":
        x = _prefill_whisper(params, x, frames, cache, cfg, s)
    for pkey, ckey, n, blocks in stacks(cfg):
        for i in range(n):
            up = unit(params[pkey], i)
            for blk in blocks:
                x, kv, _ = apply_attn_block(block_params(up, blk), x, cfg,
                                            blk)
                leaves = block_cache(cache, ckey, blk)
                for name, val in kv.items():
                    leaves[name][i, :, :s] = val
    cache["pos"] = s
    xl = apply_norm(params["final_norm"], x[:, -1:], cfg)
    return _lm_logits(params, xl, cfg)[:, 0], cache


def _block_decode(p, x, leaves, i, pos, cfg, blk):
    """One block on one token: attention over unit ``i``'s cache
    ``leaves`` (written at ``pos`` in place), then the MLP."""
    h = apply_norm(p["pre_attn"], x, cfg)
    if blk.mla:
        h, _, _ = attn_mod.mla_decode(p["attn"], h, leaves["ckv"][i],
                                      leaves["kr"][i], pos, cfg)
    else:
        h, _, _ = attn_mod.attention_decode(p["attn"], h, leaves["k"][i],
                                            leaves["v"][i], pos, cfg,
                                            kind=blk.kind)
    if "post_attn" in p:
        h = apply_norm(p["post_attn"], h, cfg)
    x = x + h
    h, _ = apply_mlp(p["mlp"], apply_norm(p["pre_mlp"], x, cfg), cfg,
                     blk.moe)
    if "post_mlp" in p:
        h = apply_norm(p["post_mlp"], h, cfg)
    return x + h


def decode_step(params, cache, token, cfg):
    """token: (B, 1) int. Returns (logits (B, V_padded), cache): the same
    cache, written in place at ``pos``, with ``pos`` advanced by one."""
    pos = cache["pos"]
    x = embed(params, token, cfg)
    if cfg.family in ("ssm", "hybrid"):
        x = _decode_recurrent(params, x, cache, pos, cfg)
    elif cfg.family == "audio":
        x = _decode_whisper(params, x, cache, pos, cfg)
    for pkey, ckey, n, blocks in stacks(cfg):
        for i in range(n):
            up = unit(params[pkey], i)
            for blk in blocks:
                x = _block_decode(block_params(up, blk), x,
                                  block_cache(cache, ckey, blk), i, pos, cfg,
                                  blk)
    cache["pos"] = pos + 1
    xl = apply_norm(params["final_norm"], x, cfg)
    return _lm_logits(params, xl, cfg)[:, 0], cache
