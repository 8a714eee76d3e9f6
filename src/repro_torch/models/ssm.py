# repro: quarantine -- growth-seed LM serving path (the hybrid family, zamba2); nothing in the battery system imports it
"""Mamba-2 (SSD) block: chunkwise-parallel prefill and one-step decode
(port of ``repro/models/ssm.py``).

The SSD formulation [arXiv:2405.21060]: a scalar decay per head
``a_t = exp(dt_t * A_h)``, state ``h_t = a_t h_{t-1} + dt_t * B_t x_t^T``,
output ``y_t = C_t . h_t + D_h x_t``. The full sequence runs in chunks of
``q`` tokens: a masked attention-like product inside each chunk, plus the
(H, P, N) state carried across chunks. ``q`` is ``min(cfg.ssm.chunk, L)``
halved until it divides L, as in the reference (no padding): a 1000-token
prompt runs in chunks of 8. Decode (``mamba2_decode``) is the recurrence
itself, one token at a time.

Precision follows the reference: the input projection and the conv in
the compute dtype; ``dt``, the decay, the in-chunk products and the state
in float32 (bfloat16 operands are upcast before they meet, as the
reference's ``preferred_element_type=float32`` products keep every
product exact); ``y`` back in the compute dtype before the gate. The
masked ``exp`` is zeroed by ``where`` before any product, so an ``inf``
in the upper triangle never meets a multiply. Plain PyTorch: the
reference computes this with XLA, not with a Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (causal_conv, chunk_len, rmsnorm,
                                       softplus)
from repro_torch.models.params import P


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, n_heads, conv_dim


def spec_mamba2(cfg):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = _dims(cfg)
    return {
        "pre_norm": P((d,), ("embed",), init="zeros"),
        # order: [z (gate), x, B, C, dt]
        "w_in": P((d, 2 * d_inner + 2 * s.d_state + n_heads),
                  ("embed", "inner")),
        "conv_w": P((s.d_conv, conv_dim), (None, "inner"), scale=0.1),
        "conv_b": P((conv_dim,), ("inner",), init="zeros"),
        "a_log": P((n_heads,), ("ssm_heads",), init="ones"),
        "d_skip": P((n_heads,), ("ssm_heads",), init="ones"),
        "dt_bias": P((n_heads,), ("ssm_heads",), init="zeros"),
        "norm": P((d_inner,), ("inner",), init="zeros"),
        "w_out": P((d_inner, d), ("inner", "embed")),
    }


def _split_proj(p, u, cfg):
    """Pre-norm and the input projection, in u's dtype -> z (B, L,
    d_inner), the conv's input xBC (B, L, conv_dim), dt (B, L, H)."""
    d_inner, n_heads, conv_dim = _dims(cfg)
    u = rmsnorm(u, p["pre_norm"], cfg.norm_eps)
    zxbcdt = u @ p["w_in"].to(u.dtype)
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:d_inner + conv_dim],
            zxbcdt[..., -n_heads:])


def _dt_decay(dt, p):
    """dt in float32 after softplus, and the per-head log decay A_h
    (negative), from the compute-dtype projection."""
    dt = softplus(dt.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["a_log"].float())


def _gate_out(p, y, z, cfg):
    y = y * F.silu(z)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"].to(y.dtype)


def mamba2(p, u, cfg, conv_state=None, ssm_state=None):
    """Full-sequence SSD. u: (B, L, D) -> (B, L, D).

    Given conv_state (B, K - 1, conv_dim) and ssm_state (B, H, P, N), u
    continues from them (the prefill of a cache) and the final states
    come back too: (out, conv_state, ssm_state)."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    b, l, _ = u.shape
    q = chunk_len(s.chunk, l)
    nc = l // q

    z, xbc, dt = _split_proj(p, u, cfg)
    xbc, final_conv = causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    x = xbc[..., :d_inner]
    bmat = xbc[..., d_inner:d_inner + s.d_state]                 # (B,L,N)
    cmat = xbc[..., d_inner + s.d_state:]                        # (B,L,N)
    dt, a = _dt_decay(dt, p)                                     # (B,L,H)
    log_decay = dt * a                                           # <= 0

    xh = x.reshape(b, nc, q, n_heads, s.head_dim).float()
    bc = bmat.reshape(b, nc, q, s.d_state).float()
    cc = cmat.reshape(b, nc, q, s.d_state).float()
    dtc = dt.reshape(b, nc, q, n_heads)
    cums = torch.cumsum(log_decay.reshape(b, nc, q, n_heads), dim=2)

    # intra-chunk: M[t,s] = (C_t . B_s) exp(cum_t - cum_s) dt_s, causal
    cb = cc @ bc.transpose(-1, -2)                               # (B,nc,t,s)
    delta = cums[:, :, :, None, :] - cums[:, :, None, :, :]      # (B,nc,t,s,H)
    causal = torch.ones((q, q), dtype=torch.bool,
                        device=u.device).tril()[None, None, :, :, None]
    m = (torch.where(causal, torch.exp(delta), 0.0) * cb[..., None]
         * dtc[:, :, None, :, :])
    del delta
    # sum over s for each head: (B,nc,H,t,s) @ (B,nc,H,s,P)
    y_intra = (m.permute(0, 1, 4, 2, 3) @ xh.permute(0, 1, 3, 2, 4)
               ).permute(0, 1, 3, 2, 4)                          # (B,nc,t,H,P)
    del m

    # chunk-final states: S_k = sum_s exp(cum_Q - cum_s) dt_s x_s B_s^T
    w_state = torch.exp(cums[:, :, -1:, :] - cums) * dtc         # (B,nc,Q,H)
    xw = xh * w_state[..., None]                                 # (B,nc,Q,H,P)
    s_chunk = torch.einsum("bnqhp,bnqs->bnhps", xw, bc)          # (B,nc,H,P,N)

    # inter-chunk scan: h_prevs[k] is the state before chunk k
    chunk_decay = torch.exp(cums[:, :, -1, :])                   # (B,nc,H)
    h = (u.new_zeros((b, n_heads, s.head_dim, s.d_state), dtype=torch.float32)
         if ssm_state is None else ssm_state.float())
    h_prevs = []
    for k in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, k, :, None, None] + s_chunk[:, k]
    h_prevs = torch.stack(h_prevs, dim=1)                        # (B,nc,H,P,N)

    y_inter = (torch.einsum("bnqs,bnhps->bnqhp", cc, h_prevs)
               * torch.exp(cums)[..., None])
    y = (y_intra + y_inter).reshape(b, l, n_heads, s.head_dim)
    y = y + xh.reshape(b, l, n_heads, s.head_dim) \
        * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, l, d_inner).to(u.dtype)
    out = _gate_out(p, y, z, cfg)
    if conv_state is not None or ssm_state is not None:
        return out, final_conv, h
    return out


def mamba2_decode(p, u, conv_state, ssm_state, cfg):
    """One-step decode. u: (B, 1, D); conv_state: (B, K - 1, conv_dim);
    ssm_state: (B, H, P, N) float32. Returns (out, conv_state,
    ssm_state), the states new tensors."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    b = u.shape[0]
    z, xbc, dt = _split_proj(p, u, cfg)
    xbc, conv_state = causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    x = xbc[:, 0, :d_inner]
    bvec = xbc[:, 0, d_inner:d_inner + s.d_state].float()
    cvec = xbc[:, 0, d_inner + s.d_state:].float()
    dt, a = _dt_decay(dt[:, 0], p)                               # (B,H)
    dec = torch.exp(dt * a)
    xh = x.reshape(b, n_heads, s.head_dim).float()
    upd = (dt[:, :, None] * xh)[..., None] * bvec[:, None, None, :]
    ssm_state = ssm_state * dec[:, :, None, None] + upd          # (B,H,P,N)
    y = (ssm_state @ cvec[:, None, :, None])[..., 0]             # (B,H,P)
    y = y + xh * p["d_skip"].float()[None, :, None]
    y = y.reshape(b, 1, d_inner).to(u.dtype)
    return _gate_out(p, y, z, cfg), conv_state, ssm_state
