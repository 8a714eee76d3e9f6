# repro: quarantine -- growth-seed LM serving path (every family with attention); nothing in the battery system imports it
"""Attention: GQA (projections with biases and qk-norm where the config
has them, full-sequence causal attention, global or local over a sliding
window, whisper's non-causal encoder and cross attention, one-token
decode and cross-attention decode) and DeepSeek-V2's multi-head latent
attention (port of ``repro/models/attention.py``).

Full-sequence attention goes through ``kernels.flash_attention.ops.mha``
on every device: the hand-written CUDA kernel for CUDA tensors, its
plain version on the CPU. ``kind="local"`` passes ``cfg.local_window``
as the kernel's sliding window (``0 <= qpos - kpos < window``), and
``cfg.attn_softcap`` goes into the kernel call. The reference computes
the same function with its dense or blocked XLA path (``sdpa``), whose
TPU-hardware twin is the Pallas kernel that the CUDA kernel ports (the
Pallas kernel has no window; the reference's local layers never reach
it). MLA's prefill builds every head's k (``[k_nope, k_rope]``, 192
wide at full size) and v (128) from the shared latent and calls the
same ``mha`` with a v head dim of its own. ``mode="bidir"`` (whisper's
encoder, and its cross attention, whose k and v come from the encoder
output ``kv_x`` and get no rope) is the kernel's non-causal form,
``mha(causal=False)``, which masks the keys of a ragged T by their
count. Custom positions have no configuration in the port and raise.

Decode attention is plain torch over the cache, as the reference
computes it outside any kernel: GQA over the k/v cache, MLA in the
reference's absorbed form over the latent cache (``ckv`` and the shared
rope key ``kr``). Both write the new token's entries into the cache in
place, where the reference returns new arrays, and score positions
``0..pos`` only (the reference scores every cached position and masks
the rest to weights of exactly 0). Whisper's cross-attention decode
scores the fixed encoder cache, every row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.common import (apply_rope, rmsnorm, rope_angles,
                                       softcap)
from repro_torch.models.params import P

# the reference's mask value (~ the lowest bfloat16), used by the loss's
# padded-vocabulary mask
NEG_INF = -2.3819763e38
KINDS = ("global", "local")
MODES = ("causal", "bidir")
# qk-norm's eps: the reference's ``_rmsnorm_vec`` default, not cfg.norm_eps
QK_NORM_EPS = 1e-6


def spec_attention(cfg):
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    spec = {
        "wq": P((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": P((d, k, dh), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, k, dh), ("embed", "kv_heads", "head_dim")),
        "wo": P((h, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = P((h, dh), ("heads", "head_dim"), init="zeros")
        spec["bk"] = P((k, dh), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = P((k, dh), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        spec["q_norm"] = P((dh,), ("head_dim",), init="zeros")
        spec["k_norm"] = P((dh,), ("head_dim",), init="zeros")
    return spec


def spec_mla(cfg):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dq, dkv = m.q_lora_rank, m.kv_lora_rank
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    return {
        "w_dq": P((d, dq), ("embed", "q_lora")),
        "q_norm": P((dq,), ("q_lora",), init="zeros"),
        "w_uq": P((dq, h, dn + dr), ("q_lora", "heads", "head_dim")),
        "w_dkv": P((d, dkv), ("embed", "kv_lora")),
        "kv_norm": P((dkv,), ("kv_lora",), init="zeros"),
        "w_uk": P((dkv, h, dn), ("kv_lora", "heads", "head_dim")),
        "w_uv": P((dkv, h, dv), ("kv_lora", "heads", "head_dim")),
        "w_kr": P((d, dr), ("embed", "head_dim")),
        "wo": P((h, dv, d), ("heads", "head_dim", "embed")),
    }


def _project_qkv(p, x, cfg, kv_x=None):
    """x: (B, S, D) -> q (B, S, H, dh), k and v (B, T, K, dh) from
    ``kv_x`` (B, T, D) (default x), biased and then, with qk-norm, each
    head vector of q and k RMS-normed (float32 inside, ``1 + w``), before
    rope as in the reference."""
    src = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dke->bske", src, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dke->bske", src, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], QK_NORM_EPS)
        k = rmsnorm(k, p["k_norm"], QK_NORM_EPS)
    return q, k, v


def _scale(cfg):
    return cfg.query_scale or cfg.head_dim_ ** -0.5


def _window(cfg, kind):
    """The kernel's window for a layer of ``kind``: 0 (causal) for
    global, ``cfg.local_window`` for local."""
    if kind not in KINDS:
        raise NotImplementedError(f"attention kind={kind!r} is not ported "
                                  f"yet (see ROADMAP.md, queue 1)")
    if kind == "global":
        return 0
    if cfg.local_window < 1:
        raise ValueError(f"local attention needs local_window >= 1, got "
                         f"{cfg.local_window}")
    return cfg.local_window


def attention(p, x, cfg, *, kind="global", mode="causal", positions=None,
              kv_x=None, kv_positions=None, return_kv=False):
    """Full-sequence attention (prefill / forward / encoder / cross). x:
    (B, S, D). ``mode="causal"``: global or local by ``kind``;
    ``mode="bidir"``: every key, the local window ignored, as in the
    reference. ``kv_x`` (B, T, D): k and v from it (cross attention), with
    no rope. Returns y (B, S, D), and (k, v) after rope when
    ``return_kv``."""
    if mode not in MODES:
        raise ValueError(f"attention mode {mode!r} is not one of {MODES}")
    if positions is not None or kv_positions is not None:
        raise NotImplementedError(
            "attention with custom positions is not ported: no "
            "configuration passes them (see ROADMAP.md, queue 1)")
    causal = mode == "causal"
    window = _window(cfg, kind) if causal else 0
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, kv_x)
    if cfg.rope and kv_x is None:
        cos, sin = rope_angles(torch.arange(s, device=x.device),
                               cfg.head_dim_, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = mha(q, k, v, scale=_scale(cfg), softcap=cfg.attn_softcap,
              window=window, causal=causal)
    y = torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype))
    if return_kv:
        return y, (k, v)
    return y


def attention_decode(p, x, cache_k, cache_v, pos, cfg, *, kind="global"):
    """One-token decode. x: (B, 1, D); cache: (B, S_max, K, dh); pos: the
    int position of the new token. Writes its k/v into the cache at
    ``pos`` in place and attends over positions ``0..pos`` (global) or
    ``pos - local_window + 1..pos`` (local). Returns (y, cache_k,
    cache_v)."""
    window = _window(cfg, kind)
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope:
        cos, sin = rope_angles(torch.full((1,), pos, device=x.device),
                               cfg.head_dim_, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    # the reference scores all S_max positions and masks those outside
    # the window with a value whose weights are exactly 0; scoring the
    # window alone is the same sum
    lo = max(0, pos - window + 1) if window else 0
    ck, cv = cache_k[:, lo:pos + 1], cache_v[:, lo:pos + 1]
    kh = cache_k.shape[2]
    g = cfg.n_heads // kh
    qg = q.reshape(b, 1, kh, g, cfg.head_dim_)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          ck.to(q.dtype).float()) * _scale(cfg)
    scores = softcap(scores, cfg.attn_softcap)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, cv.to(q.dtype))
    out = out.reshape(b, 1, cfg.n_heads, cfg.head_dim_)
    y = torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype))
    return y, cache_k, cache_v


def cross_attention_decode(p, x, cross_k, cross_v, cfg):
    """One-token cross attention over the fixed encoder cache. x: (B, 1,
    D); cross_k, cross_v: (B, T, K, dh). Every cached row is attended;
    the scale is ``head_dim ** -0.5`` and there is no softcap, as in the
    reference (which ignores ``query_scale`` here). Returns y (B, 1, D)."""
    b = x.shape[0]
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    kh = cross_k.shape[2]
    qg = q.reshape(b, 1, kh, cfg.n_heads // kh, cfg.head_dim_)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          cross_k.to(q.dtype).float()) * cfg.head_dim_ ** -0.5
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, cross_v.to(q.dtype))
    out = out.reshape(b, 1, cfg.n_heads, cfg.head_dim_)
    return torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)

def _mla_scale(cfg):
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def _mla_q(p, x, cfg, positions):
    """x: (B, S, D) -> q_nope (B, S, H, dn), q_rope (B, S, H, dr) after
    rope: the query's low-rank path, RMS-normed (eps fixed as for
    qk-norm) between its two projections."""
    m = cfg.mla
    cq = rmsnorm(x @ p["w_dq"].to(x.dtype), p["q_norm"], QK_NORM_EPS)
    q = torch.einsum("bsr,rhe->bshe", cq, p["w_uq"].to(x.dtype))
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_latent(p, x, cfg, positions):
    """x: (B, S, D) -> the cached latent c_kv (B, S, r), RMS-normed, and
    the rope key k_rope (B, S, dr) that every head shares."""
    m = cfg.mla
    c_kv = rmsnorm(x @ p["w_dkv"].to(x.dtype), p["kv_norm"], QK_NORM_EPS)
    k_rope = x @ p["w_kr"].to(x.dtype)
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return c_kv, apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]


def mla_attention(p, x, cfg, *, return_cache=False):
    """Full-sequence causal MLA (prefill / forward). x: (B, S, D) -> y
    (B, S, D), and (c_kv, k_rope) for the cache when ``return_cache``.
    Every head's k is ``[k_nope, k_rope]`` (dn + dr wide) and its v is
    dv wide, both materialized from the latent, through ``mha``."""
    m = cfg.mla
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, pos)
    c_kv, k_rope = _mla_latent(p, x, cfg, pos)
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uk"].to(x.dtype))
    v = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uv"].to(x.dtype))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, cfg.n_heads, m.qk_rope_head_dim)], dim=-1)
    out = mha(q, k, v.contiguous(), scale=_mla_scale(cfg))
    y = torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype))
    if return_cache:
        return y, (c_kv, k_rope)
    return y


def mla_decode(p, x, cache_ckv, cache_kr, pos, cfg):
    """Absorbed MLA decode: scores and values in the latent space. x:
    (B, 1, D); cache_ckv (B, S_max, r), cache_kr (B, S_max, dr); pos: the
    int position of the new token. Writes its latent and rope key into
    the cache at ``pos`` in place and attends over ``0..pos``. Returns
    (y, cache_ckv, cache_kr)."""
    posv = torch.full((1,), pos, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, posv)                    # (B,1,H,*)
    c_kv, k_rope = _mla_latent(p, x, cfg, posv)
    cache_ckv[:, pos] = c_kv[:, 0].to(cache_ckv.dtype)
    cache_kr[:, pos] = k_rope[:, 0].to(cache_kr.dtype)
    ckv = cache_ckv[:, :pos + 1].to(x.dtype)
    kr = cache_kr[:, :pos + 1].to(x.dtype)
    # absorb W_uk into q: (B,1,H,dn) x (r,H,dn) -> (B,1,H,r)
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, p["w_uk"].to(x.dtype))
    scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv.float())
              + torch.einsum("bshe,bte->bhst", q_rope.float(), kr.float())
              ) * _mla_scale(cfg)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhst,btr->bshr", w, ckv)
    out = torch.einsum("bshr,rhe->bshe", o_lat, p["w_uv"].to(x.dtype))
    y = torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype))
    return y, cache_ckv, cache_kr
