# repro: quarantine -- growth-seed LM serving path (every family of the reference); nothing in the battery system imports it
"""Model assembly, dense, vlm, moe, audio, ssm and hybrid families (port
of ``repro/models/lm.py``).

Public surface:
  model_spec(cfg)                           -> param Spec tree
  init_params(cfg, seed, device=None)       -> materialized params
  forward(params, tokens, cfg, frames=None) -> (logits (B, S, V_padded), aux)
  loss_fn(params, batch, cfg)               -> scalar loss (CE + MoE aux)
  init_cache(cfg, batch, max_seq, ...)      -> decode cache
  count_params(cfg, active_only=False)      -> int (shape-only)

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
no frontend code. The moe family (granite-moe, deepseek-v2) stacks
``moe.first_dense_layers`` dense blocks (``head_blocks``, their MLP
``moe.d_ff_dense`` wide) before ``units`` of one ``blk`` whose MLP is the
MoE layer; its attention is MLA where ``cfg.mla`` is set, GQA otherwise,
and its forward returns the sum of the MoE layers' aux losses.

The ssm family (xlstm) has no attention: ``n_layers / slstm_every``
superblocks (``units``), each ``slstm_every - 1`` mLSTM blocks (a nested
``mlstm`` stack over ``inner_layers``) and then one sLSTM block with its
own gated FFN; every block adds its own residual. The hybrid family
(zamba2) runs one ``shared_block`` (attention + MLP, one set of weights)
before each group of ``shared_attn_every`` Mamba-2 layers (``units``,
a nested ``mamba`` stack) and once more before the ``tail`` of
``n_layers % shared_attn_every`` layers: each application has its own
k/v slot in the cache. Their caches are recurrent states in float32
(SSD's (H, P, N) state; mLSTM's c/n/m; sLSTM's c/n/h/m) and conv tails
in the compute dtype.

The audio family (whisper) is an encoder-decoder with LayerNorms
(``scale`` and ``bias``) and no rope. Its ``frames`` frontend takes
decoder token ids and, beside them, precomputed encoder frame
embeddings (B, T, D) (the reference's stub for the conv frontend). The
``encoder`` stack adds sinusoidal positions and runs pre-norm blocks of
non-causal self-attention and the MLP, then ``enc_final_norm``; the
decoder adds learned positions (``pos_embed``, ``WHISPER_MAX_POS``
rows) and runs ``units`` of causal self-attention, cross attention over
the encoder output (``cross``) and the MLP, each pre-normed. Its cache
holds the decoder's k/v (``units``) and the cross attention's k/v of
the ``encoder_seq`` frames (``cross``), which decode reads unchanged.
Training (``forward_hidden``, ``loss_fn``): the reference's remat
(``_remat``) is ``torch.utils.checkpoint`` (non-reentrant) under
``cfg.remat_policy`` while autograd records: ``full`` recomputes every
activation in the backward, ``dots`` saves the matrix products without
batch dims (``aten.mm``/``addmm``, the reference's
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest,
``none`` saves everything. It wraps what the reference's scans wrap:
each unit (``_scan_units``; ``scan_group`` g > 0 also checkpoints
groups of g units around the checkpointed units), moe's leading dense
blocks, whisper's encoder and decoder layers, xlstm's mLSTM and
zamba2's Mamba-2 inner layers, the tail's too. ``loss_fn`` is the
reference's chunked cross-entropy: ``LOSS_CHUNK`` positions at a time,
each chunk checkpointed, the padded vocabulary masked with ``NEG_INF``,
summed in float32, then ``ce + aux``.
"""
from __future__ import annotations

import collections
import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (act_fn, apply_norm, norm_spec,
                                       sinusoid_pos, softcap)
from repro_torch.models.mlp import mlp, spec_mlp
from repro_torch.models.params import (P, count_spec_params, init_from_spec,
                                       leaves, stack_spec, tree_map)


FAMILIES = ("dense", "vlm", "moe", "audio", "ssm", "hybrid")
FRONTENDS = ("tokens", "fused", "frames")
REMAT_POLICIES = ("full", "dots", "none")
# rows of whisper's learned decoder positions (the reference's)
WHISPER_MAX_POS = 32768
# positions per chunk of the fused cross-entropy (the reference's)
LOSS_CHUNK = 512


def _check_ported(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} "
                         f"({cfg.arch_id}): the reference has {FAMILIES}")
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"unknown frontend {cfg.frontend!r} "
                         f"({cfg.arch_id}): the reference has {FRONTENDS}")
    if (cfg.family == "audio") != (cfg.frontend == "frames"):
        raise ValueError(f"{cfg.arch_id}: the audio family and the frames "
                         f"frontend go together, got family {cfg.family!r} "
                         f"with frontend {cfg.frontend!r}")
    if cfg.family == "audio" and not (cfg.is_encoder_decoder
                                      and cfg.n_encoder_layers >= 1
                                      and cfg.encoder_seq >= 1):
        raise ValueError(f"{cfg.arch_id}: the audio family needs "
                         f"is_encoder_decoder, n_encoder_layers >= 1 and "
                         f"encoder_seq >= 1")
    if cfg.family == "moe" and cfg.moe is None:
        raise ValueError(f"{cfg.arch_id}: the moe family needs cfg.moe")
    if cfg.family == "ssm" and cfg.xlstm is None:
        raise ValueError(f"{cfg.arch_id}: the ssm family needs cfg.xlstm")
    if cfg.family == "hybrid" and (cfg.ssm is None
                                   or cfg.shared_attn_every < 1):
        raise ValueError(f"{cfg.arch_id}: the hybrid family needs cfg.ssm "
                         f"and shared_attn_every >= 1")
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         f"({cfg.arch_id}): the reference has "
                         f"{REMAT_POLICIES}")
    act_fn(cfg.act)


def _spec_attn_block(cfg, use_moe=False, d_ff=None, use_mla=False):
    spec = {
        "pre_attn": norm_spec(cfg.d_model),
        "attn": (attn_mod.spec_mla(cfg) if use_mla
                 else attn_mod.spec_attention(cfg)),
        "pre_mlp": norm_spec(cfg.d_model),
        "mlp": moe_mod.spec_moe(cfg) if use_moe else spec_mlp(cfg, d_ff),
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


# one block of a stack: its key in a unit's parameters and in the stack's
# cache (None: the unit's tree, the stack's cache dict itself), its
# attention kind, and whether it runs MLA and the MoE layer
Block = collections.namedtuple("Block", "param cache kind mla moe")


def stacks(cfg):
    """The stacked layer groups in the order they run: (params key,
    cache key, number of units, [Block, ...] of a unit). Dense and vlm:
    ``units`` of ``_unit_structure``'s blocks. moe: ``head_blocks`` (the
    leading dense layers, cache ``head``), then ``units`` of one MoE
    ``blk``; the reference's caches of both hold the block's leaves
    directly. The audio, ssm and hybrid families have none (their layers
    are not such blocks: ``encode`` and ``decoder_block``,
    ``n_superblocks``, ``hybrid_groups``)."""
    if cfg.family in ("audio", "ssm", "hybrid"):
        return []
    if cfg.family == "moe":
        m, mla = cfg.moe, cfg.mla is not None
        out = []
        if m.first_dense_layers:
            out.append(("head_blocks", "head", m.first_dense_layers,
                        [Block(None, None, "global", mla, False)]))
        out.append(("units", "units", cfg.n_layers - m.first_dense_layers,
                    [Block("blk", None, "global", mla, True)]))
        return out
    n_units, blocks = _unit_structure(cfg)
    return [("units", "units", n_units,
             [Block(key, key, kind, False, False) for key, kind in blocks])]


# zamba2's shared block: plain attention and MLP, global
SHARED = Block(None, None, "global", False, False)


def n_superblocks(cfg):
    """xlstm: (superblocks, mLSTM blocks in each)."""
    k = cfg.xlstm.slstm_every
    return cfg.n_layers // k, k - 1


def hybrid_groups(cfg):
    """zamba2's groups in the order they run, each after its own
    application of the shared block: (k/v slot, unit index (None: the
    tail), Mamba-2 layers). ``n_layers // shared_attn_every`` full groups
    (``units``), then the ``tail`` of the rest, if any."""
    k = cfg.shared_attn_every
    n_full, tail = divmod(cfg.n_layers, k)
    out = [(i, i, k) for i in range(n_full)]
    if tail:
        out.append((n_full, None, tail))
    return out


def group_params(params, i):
    """Group ``i``'s stacked Mamba-2 layers (``i`` None: the tail's)."""
    return params["tail"] if i is None else unit(params["units"], i)["mamba"]


def group_cache(cache, i):
    """Group ``i``'s stacked Mamba-2 states ``{"conv", "ssm"}`` (views
    into the cache; ``i`` None: the tail's)."""
    return cache["tail"] if i is None else unit(cache["mamba"], i)


def model_spec(cfg) -> Dict[str, Any]:
    _check_ported(cfg)
    d = cfg.d_model
    spec: Dict[str, Any] = {
        "embed": P((cfg.padded_vocab, d), ("vocab", "embed"), scale=0.02),
        "final_norm": norm_spec(d),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = P((d, cfg.padded_vocab), ("embed", "vocab"))
    if cfg.family == "ssm":
        n_super, n_m = n_superblocks(cfg)
        spec["units"] = stack_spec({
            "mlstm": stack_spec(xlstm_mod.spec_mlstm(cfg), n_m,
                                "inner_layers"),
            "slstm": xlstm_mod.spec_slstm(cfg)}, n_super)
        return spec
    if cfg.family == "audio":
        ln = norm_spec(d, "ln")
        attn = attn_mod.spec_attention(cfg)
        spec["final_norm"] = ln
        spec["encoder"] = stack_spec({"pre_attn": ln, "attn": attn,
                                      "pre_mlp": ln, "mlp": spec_mlp(cfg)},
                                     cfg.n_encoder_layers)
        spec["units"] = stack_spec({"pre_attn": ln, "attn": attn,
                                    "pre_cross": ln, "cross": attn,
                                    "pre_mlp": ln, "mlp": spec_mlp(cfg)},
                                   cfg.n_layers)
        spec["enc_final_norm"] = ln
        spec["pos_embed"] = P((WHISPER_MAX_POS, d), (None, "embed"),
                              scale=0.01)
        return spec
    if cfg.family == "hybrid":
        n_full, tail = divmod(cfg.n_layers, cfg.shared_attn_every)
        spec["shared_block"] = _spec_attn_block(cfg)
        spec["units"] = stack_spec(
            {"mamba": stack_spec(ssm_mod.spec_mamba2(cfg),
                                 cfg.shared_attn_every, "inner_layers")},
            n_full)
        if tail:
            spec["tail"] = stack_spec(ssm_mod.spec_mamba2(cfg), tail)
        return spec
    for pkey, _, n, blocks in stacks(cfg):
        d_ff = cfg.moe.d_ff_dense if pkey == "head_blocks" else None
        specs = {b.param: _spec_attn_block(cfg, b.moe, d_ff, b.mla)
                 for b in blocks}
        spec[pkey] = stack_spec(specs.get(None, specs), n)
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


def count_params(cfg, active_only: bool = False) -> int:
    """Parameters of ``cfg`` from its spec's shapes. ``active_only``
    counts a routed expert's leaves (axis ``experts``) at
    ``top_k / n_experts``, truncated per leaf, as the reference does."""
    spec = model_spec(cfg)
    if not active_only or cfg.moe is None:
        return count_spec_params(spec)
    m = cfg.moe
    frac = m.top_k / m.n_experts if m.n_experts else 1.0
    total = 0
    for p in leaves(spec):
        n = math.prod(p.shape)
        total += int(n * frac) if "experts" in p.axes else n
    return total


def unit(stacked, i):
    """Unit ``i``'s slice of a stacked tree (views, no copy)."""
    return tree_map(lambda a: a[i], stacked)


def unstack(stacked):
    """Every unit's slice of a stacked tree, a list (views, no copy): one
    ``unbind`` a leaf, whose backward stacks the units' gradients once.
    Training slices through it: a slice per unit (``unit``) would have
    autograd add one full-size gradient of the stack per unit."""
    parts = tree_map(lambda a: a.unbind(0), stacked)
    n = len(leaves(parts)[0])
    return [tree_map(lambda p: p[i], parts) for i in range(n)]


def embed(params, tokens, cfg):
    cdt = _cdtype(cfg)
    x = params["embed"][tokens].to(cdt)
    if cfg.arch_id.startswith("gemma2"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt)
    return x


def block_params(up, blk):
    """A block's parameters within its unit ``up``."""
    return up if blk.param is None else up[blk.param]


def block_cache(cache, ckey, blk):
    """A block's cache leaves: the stack's cache dict or its entry."""
    return cache[ckey] if blk.cache is None else cache[ckey][blk.cache]


def apply_mlp(p, h, cfg, use_moe):
    """The block's MLP on normed ``h`` -> (out, aux): the MoE layer and
    its aux loss, or the dense MLP and None."""
    if use_moe:
        return moe_mod.moe(p, h, cfg)
    return mlp(p, h, cfg), None


def apply_attn_block(p, x, cfg, blk):
    """One pre-norm block of kind ``blk`` on the full sequence, with
    post-norms where the block has them; returns (x, cache leaves, aux):
    ``{"k", "v"}`` after rope (GQA) or ``{"ckv", "kr"}`` (MLA), and the
    MoE layer's aux loss (None for a dense MLP)."""
    h = apply_norm(p["pre_attn"], x, cfg)
    if blk.mla:
        h, (ckv, kr) = attn_mod.mla_attention(p["attn"], h, cfg,
                                              return_cache=True)
        kv = {"ckv": ckv, "kr": kr}
    else:
        h, (k, v) = attn_mod.attention(p["attn"], h, cfg, kind=blk.kind,
                                       return_kv=True)
        kv = {"k": k, "v": v}
    if "post_attn" in p:
        h = apply_norm(p["post_attn"], h, cfg)
    x = x + h
    h, aux = apply_mlp(p["mlp"], apply_norm(p["pre_mlp"], x, cfg), cfg,
                       blk.moe)
    if "post_mlp" in p:
        h = apply_norm(p["post_mlp"], h, cfg)
    return x + h, kv, aux


def check_frames(cfg, tokens, frames):
    """The audio family needs ``frames`` (B, T, d_model) beside its
    (B, S) decoder tokens; every other family takes none."""
    if cfg.family != "audio":
        if frames is not None:
            raise ValueError(f"{cfg.arch_id}: frames are the audio "
                             f"family's input only")
        return
    if (frames is None or frames.dim() != 3
            or frames.shape[0] != tokens.shape[0]
            or frames.shape[2] != cfg.d_model):
        raise ValueError(f"{cfg.arch_id} needs frames (B={tokens.shape[0]}, "
                         f"T, {cfg.d_model}) beside its decoder tokens, got "
                         f"{None if frames is None else tuple(frames.shape)}")


def encode(params, frames, cfg, remat=False):
    """whisper's encoder: frames (B, T, D), cast to the compute dtype,
    plus sinusoidal positions (in that dtype), through the ``encoder``
    stack of pre-norm blocks (non-causal self-attention, then the MLP),
    then ``enc_final_norm`` -> (B, T, D). ``remat``: each layer under
    ``_remat`` (training)."""
    cdt = _cdtype(cfg)
    t, d = frames.shape[1], frames.shape[2]
    x = frames.to(cdt) + sinusoid_pos(t, d, cdt, frames.device)[None]
    layers = unstack(params["encoder"])

    def layer(x, i):
        p = layers[i]
        x = x + attn_mod.attention(p["attn"],
                                   apply_norm(p["pre_attn"], x, cfg), cfg,
                                   mode="bidir")
        return x + mlp(p["mlp"], apply_norm(p["pre_mlp"], x, cfg), cfg)
    if remat:
        layer = _remat(layer, cfg)
    for i in range(cfg.n_encoder_layers):
        x = layer(x, i)
    return apply_norm(params["enc_final_norm"], x, cfg)


def decoder_block(p, x, enc, cfg):
    """One whisper decoder block on the full sequence: causal
    self-attention, cross attention over the encoder output ``enc``
    (B, T, D), the MLP, each pre-normed. Returns (x, the self-attention's
    ``{"k", "v"}``, the cross attention's ``{"k", "v"}``: the decode
    cache's leaves)."""
    h, (k, v) = attn_mod.attention(p["attn"],
                                   apply_norm(p["pre_attn"], x, cfg), cfg,
                                   return_kv=True)
    x = x + h
    h, (xk, xv) = attn_mod.attention(p["cross"],
                                     apply_norm(p["pre_cross"], x, cfg), cfg,
                                     mode="bidir", kv_x=enc, return_kv=True)
    x = x + h
    x = x + mlp(p["mlp"], apply_norm(p["pre_mlp"], x, cfg), cfg)
    return x, {"k": k, "v": v}, {"k": xk, "v": xv}


# ---------------------------------------------------------------------------
# remat and the unit loop (the reference's ``_remat`` and ``_scan_units``)

# the matrix products without batch dims: what ``dots`` saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_contexts():
    """Selective checkpoint: save ``_DOTS``' outputs, recompute the rest
    (the reference's ``checkpoint_dots_with_no_batch_dims``)."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in _DOTS
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _remat(fn, cfg):
    """``fn`` under ``cfg.remat_policy`` while autograd records: ``full``
    checkpoints it (non-reentrant; its activations recomputed in the
    backward), ``dots`` checkpoints it saving the matrix products, and
    ``none`` (or no grad) runs it as it is."""
    if cfg.remat_policy == "none":
        return fn
    kw = {"context_fn": _dots_contexts} if cfg.remat_policy == "dots" else {}

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def _scan_units(body, carry, n, cfg):
    """``carry = body(carry, i)`` over units ``i < n``, each unit under
    ``_remat``; with ``cfg.scan_group`` g > 0 dividing n (and n > g), in
    groups of g units, each group under ``_remat`` too (the reference's
    nested scan-of-scan)."""
    body_r = _remat(body, cfg)
    g = cfg.scan_group
    if g and n % g == 0 and n > g:
        def group(c, i0):
            for i in range(i0, i0 + g):
                c = body_r(c, i)
            return c
        group_r = _remat(group, cfg)
        for i0 in range(0, n, g):
            carry = group_r(carry, i0)
        return carry
    for i in range(n):
        carry = body_r(carry, i)
    return carry


def _block(p, x, cfg, blk):
    """One block on the full sequence -> (x, aux (0 for a dense MLP))."""
    x, _, a = apply_attn_block(p, x, cfg, blk)
    return x, (torch.zeros((), dtype=torch.float32, device=x.device)
               if a is None else a)


def forward_hidden(params, tokens, cfg, frames=None):
    """tokens: (B, S) int (and, for the audio family, ``frames`` (B, T,
    D)) -> (final-normed hidden (B, S, D), aux loss: the sum of the MoE
    layers' aux losses, 0 without any). Under autograd the layers run
    under ``_remat`` at the reference's granularity."""
    _check_ported(cfg)
    check_frames(cfg, tokens, frames)
    x = embed(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "audio":
        enc = encode(params, frames, cfg, remat=True)
        x = x + params["pos_embed"][:tokens.shape[1]].to(x.dtype)[None]

        dec = unstack(params["units"])

        def dec_layer(x, i):
            return decoder_block(dec[i], x, enc, cfg)[0]
        dec_layer = _remat(dec_layer, cfg)
        for i in range(cfg.n_layers):
            x = dec_layer(x, i)
    elif cfg.family == "ssm":
        n_super, n_m = n_superblocks(cfg)

        def mlstm_layer(x, mp):
            return x + xlstm_mod.mlstm(mp, x, cfg)
        mlstm_layer = _remat(mlstm_layer, cfg)
        units = unstack(params["units"])

        def superblock(carry, i):
            x, a = carry
            up = units[i]
            for mp in unstack(up["mlstm"]):
                x = mlstm_layer(x, mp)
            return x + xlstm_mod.slstm(up["slstm"], x, cfg), a
        x, aux = _scan_units(superblock, (x, aux), n_super, cfg)
    elif cfg.family == "hybrid":
        def mamba_layer(x, mp):
            return x + ssm_mod.mamba2(mp, x, cfg)
        mamba_layer = _remat(mamba_layer, cfg)
        units = unstack(params["units"])

        def group(carry, i):
            x, a = carry
            x, b = _block(params["shared_block"], x, cfg, SHARED)
            stack = params["tail"] if i is None else units[i]["mamba"]
            for mp in unstack(stack):
                x = mamba_layer(x, mp)
            return x, a + b
        n_full = cfg.n_layers // cfg.shared_attn_every
        x, aux = _scan_units(group, (x, aux), n_full, cfg)
        if cfg.n_layers % cfg.shared_attn_every:
            x, aux = group((x, aux), None)
    for pkey, _, n, blocks in stacks(cfg):
        ups = unstack(params[pkey])

        def body(carry, i, ups=ups, blocks=blocks):
            x, a = carry
            up = ups[i]
            for blk in blocks:
                x, b = _block(block_params(up, blk), x, cfg, blk)
                a = a + b
            return x, a
        if pkey == "head_blocks":
            # moe's leading dense layers: each under _remat, no groups
            body_r = _remat(body, cfg)
            for i in range(n):
                x, aux = body_r((x, aux), i)
        else:
            x, aux = _scan_units(body, (x, aux), n, cfg)
    x = apply_norm(params["final_norm"], x, cfg)
    return x, aux


def forward(params, tokens, cfg, frames=None):
    """tokens (and the audio family's ``frames``) -> (logits (B, S,
    V_padded), aux). Materializes full logits: for small configs and
    tests."""
    x, aux = forward_hidden(params, tokens, cfg, frames)
    return _lm_logits(params, x, cfg), aux


def _lm_logits(params, x, cfg):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    return softcap(logits, cfg.final_softcap)


# ---------------------------------------------------------------------------
# loss

def _ce_chunk(params, x_c, labels_c, cfg):
    """Summed cross-entropy of one sequence chunk, fused with the vocab
    projection: float32 logits (the padded vocabulary masked with
    ``NEG_INF``), their log-sum-exp less the gold logit."""
    logits = _lm_logits(params, x_c, cfg).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab,
                           device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.tensor(attn_mod.NEG_INF,
                                               device=logits.device), logits)
    gold = logits.gather(-1, labels_c[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy plus the MoE aux loss. ``batch``:
    ``tokens`` and ``labels`` (B, S) (and the audio family's ``frames``).
    The cross-entropy runs over chunks of ``LOSS_CHUNK`` positions (the
    whole sequence when that does not divide S), each checkpointed so the
    backward recomputes its logits; never (B, S, V) at once."""
    x, aux = forward_hidden(params, batch["tokens"], cfg,
                            frames=batch.get("frames"))
    labels = batch["labels"]
    b, s, _ = x.shape
    ck = min(LOSS_CHUNK, s)
    if s % ck:
        ck = s

    def chunk(xc, lc):
        return _ce_chunk(params, xc, lc, cfg)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, ck):
        xc, lc = x[:, i:i + ck], labels[:, i:i + ck]
        total = total + (checkpoint(chunk, xc, lc, use_reentrant=False)
                         if torch.is_grad_enabled() else chunk(xc, lc))
    return total / (b * s) + aux


def init_cache(cfg, batch: int, max_seq: int, dtype=None, device=None):
    """The decode cache (zeros; prefill fills it) in the compute dtype, on
    ``device`` (default ``cuda``): ``pos`` (an int) and, per stack
    (``units``; moe also ``head`` for its leading dense layers), its
    blocks' leaves with a leading unit dim: GQA k/v (n, B, max_seq, K, dh)
    (under each block key for dense and vlm, directly for moe, as in the
    reference), MLA's latent ``ckv`` (n, B, max_seq, kv_lora_rank) and
    rope key ``kr`` (n, B, max_seq, qk_rope_head_dim). The audio family
    holds its decoder's k/v directly, ``units`` {k, v (n_layers, B,
    max_seq, K, dh)}, and the cross attention's, ``cross`` {k, v
    (n_layers, B, encoder_seq, K, dh)}. The ssm and hybrid families'
    recurrent states are float32, whatever ``dtype`` (the reference's
    layout, below)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    cdt = dtype or _cdtype(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return _recurrent_cache(cfg, batch, max_seq, cdt, dev)
    if cfg.family == "audio":
        head = (cfg.n_kv_heads, cfg.head_dim_)
        return {"pos": 0, **{
            key: {name: torch.zeros((cfg.n_layers, batch, rows) + head,
                                    dtype=cdt, device=dev) for name in "kv"}
            for key, rows in (("units", max_seq),
                              ("cross", cfg.encoder_seq))}}

    def leaves_of(n, blk):
        if blk.mla:
            dims = {"ckv": (cfg.mla.kv_lora_rank,),
                    "kr": (cfg.mla.qk_rope_head_dim,)}
        else:
            dims = dict.fromkeys("kv", (cfg.n_kv_heads, cfg.head_dim_))
        return {name: torch.zeros((n, batch, max_seq) + dim, dtype=cdt,
                                  device=dev) for name, dim in dims.items()}

    cache = {"pos": 0}
    for _, ckey, n, blocks in stacks(cfg):
        per = {blk.cache: leaves_of(n, blk) for blk in blocks}
        cache[ckey] = per.get(None, per)
    return cache


def _recurrent_cache(cfg, batch, max_seq, cdt, dev):
    """The reference's caches of the two recurrent families. xlstm:
    ``mlstm`` {c (n_super, n_m, B, H, dh, dh), n (.., H, dh), m (.., H)
    at -1e30, conv (.., K - 1, inner)} and ``slstm`` {c, n at 1e-6, h, m
    at -1e30 (n_super, B, D), conv (n_super, B, K - 1, D)}. zamba2: one
    k/v slot per application of the shared block, ``attn`` {k, v
    (n_attn, B, max_seq, K, dh)}, and per Mamba-2 layer ``mamba`` {conv
    (n_full, k, B, d_conv - 1, conv_dim), ssm (n_full, k, B, H, P, N)},
    ``tail`` the same with one leading dim. Conv tails and k/v in
    ``cdt``, states in float32."""
    f32 = torch.float32

    def full(shape, value, dtype=f32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    cache = {"pos": 0}
    if cfg.family == "ssm":
        xc = cfg.xlstm
        n_super, n_m = n_superblocks(cfg)
        inner, heads, mdh = xlstm_mod._mdims(cfg)
        d, kc = cfg.d_model, xc.conv_width - 1
        lead = (n_super, n_m, batch, heads)
        cache["mlstm"] = {"c": full(lead + (mdh, mdh), 0.0),
                          "n": full(lead + (mdh,), 0.0),
                          "m": full(lead, xlstm_mod.M_INIT),
                          "conv": full((n_super, n_m, batch, kc, inner), 0.0,
                                       cdt)}
        lead = (n_super, batch, d)
        cache["slstm"] = {"c": full(lead, 0.0),
                          "n": full(lead, xlstm_mod.N_FLOOR),
                          "h": full(lead, 0.0),
                          "m": full(lead, xlstm_mod.M_INIT),
                          "conv": full((n_super, batch, kc, d), 0.0, cdt)}
        return cache
    s = cfg.ssm
    _, n_heads, conv_dim = ssm_mod._dims(cfg)
    groups = hybrid_groups(cfg)
    kv = (len(groups), batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    cache["attn"] = {"k": full(kv, 0.0, cdt), "v": full(kv, 0.0, cdt)}

    def states(lead):
        return {"conv": full(lead + (batch, s.d_conv - 1, conv_dim), 0.0,
                             cdt),
                "ssm": full(lead + (batch, n_heads, s.head_dim, s.d_state),
                            0.0)}
    n_full, tail = divmod(cfg.n_layers, cfg.shared_attn_every)
    cache["mamba"] = states((n_full, cfg.shared_attn_every))
    if tail:
        cache["tail"] = states((tail,))
    return cache
