# repro: quarantine -- growth-seed LM serving path (the dense and vlm families); nothing in the battery system imports it
"""GQA attention: projections (with biases and qk-norm where the config
has them), full-sequence causal attention (global, or local over a
sliding window) and one-token decode (port of the GQA half of
``repro/models/attention.py``).

Full-sequence attention goes through ``kernels.flash_attention.ops.mha``
on every device: the hand-written CUDA kernel for CUDA tensors, its
plain version on the CPU. ``kind="local"`` passes ``cfg.local_window``
as the kernel's sliding window (``0 <= qpos - kpos < window``), and
``cfg.attn_softcap`` goes into the kernel call. The reference computes
the same function with its dense or blocked XLA path (``sdpa``), whose
TPU-hardware twin is the Pallas kernel that the CUDA kernel ports (the
Pallas kernel has no window; the reference's local layers never reach
it). Bidirectional and cross attention, custom positions and MLA have
no configuration in the port yet and raise (ROADMAP.md, queue 1).

Decode attention is plain torch over the cache, as the reference
computes it outside any kernel. It writes the new k/v into the cache in
place, where the reference returns new arrays.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.common import (apply_rope, rmsnorm, rope_angles,
                                       softcap)
from repro_torch.models.params import P

KINDS = ("global", "local")
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


def _project_qkv(p, x, cfg):
    """x: (B, S, D) -> q (B, S, H, dh), k and v (B, S, K, dh), biased and
    then, with qk-norm, each head vector of q and k RMS-normed (float32
    inside, ``1 + w``), before rope as in the reference."""
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dke->bske", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dke->bske", x, p["wv"].to(x.dtype))
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
    """Full-sequence causal attention (prefill / forward), global or local.
    x: (B, S, D). Returns y (B, S, D), and (k, v) after rope when
    ``return_kv``."""
    if (mode != "causal" or kv_x is not None or positions is not None
            or kv_positions is not None):
        raise NotImplementedError(
            f"attention mode={mode!r} (cross, custom positions) is not "
            f"ported yet: only causal attention is (see ROADMAP.md, "
            f"queue 1)")
    window = _window(cfg, kind)
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope:
        cos, sin = rope_angles(torch.arange(s, device=x.device),
                               cfg.head_dim_, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = mha(q, k, v, scale=_scale(cfg), softcap=cfg.attn_softcap,
              window=window)
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
