# repro: quarantine -- growth-seed LM serving path (the ssm family, xlstm); nothing in the battery system imports it
"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, a true recurrence over time) (port of
``repro/models/xlstm.py``).

mLSTM cell:  C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
             h_t = (C_t q_t) / max(|n_t . q_t|, 1)
with an exponential input gate and a sigmoid forget gate, in log space.
The full sequence runs in chunks as the Mamba-2 block does (``ssm.py``;
the same chunk length rule): a masked attention-like product inside each
chunk, and the (dh, dh) memory carried across chunks with the paper's
running-max stabilizer (C_true = c_hat * exp(M)). Decode is the
recurrence with the same stabilizer, so the two forms agree to float32.

sLSTM: a 4-gate scalar cell with per-head block-diagonal recurrent
matrices and an exponential-gate stabilizer m_t, looped over time (the
reference's ``lax.scan``): one step's ~20 small kernels per token, with
no host sync inside the loop; what can be built once (the input
contribution of every step, the float32 recurrent weights) is built
before it.

Precision follows the reference: projections in the compute dtype, the
gates and states in float32 (the gates upcast after the projection), the
in-chunk products on float32 operands, ``h`` back in the compute dtype
before the output norm. The masked ``exp`` is zeroed by ``where`` before
any product. The stabilizers are kept as they are: ``max(|den|,
exp(-d_t))`` and decode's ``exp(-m)`` may be ``inf`` on purpose (``h``
is then 0), and sLSTM's normalizer is ``max(n, 1e-6)``. Plain PyTorch:
the reference computes both blocks with XLA, not with a Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (causal_conv, chunk_len, log_sigmoid,
                                       rmsnorm)
from repro_torch.models.params import P

# the stabilizer's start (the reference's -1e30: exp(m0 + x) is 0 for any
# finite x) and sLSTM's normalizer floor
M_INIT = -1e30
N_FLOOR = 1e-6


# ---------------------------------------------------------------------------
# mLSTM

def _mdims(cfg):
    x = cfg.xlstm
    inner = int(x.proj_factor_m * cfg.d_model)
    heads = cfg.n_heads
    dh = inner // heads
    return inner, heads, dh


def spec_mlstm(cfg):
    x = cfg.xlstm
    d = cfg.d_model
    inner, heads, dh = _mdims(cfg)
    return {
        "norm": P((d,), ("embed",), init="zeros"),
        "w_up": P((d, inner), ("embed", "inner")),
        "w_gate": P((d, inner), ("embed", "inner")),
        "conv_w": P((x.conv_width, inner), (None, "inner"), scale=0.1),
        "conv_b": P((inner,), ("inner",), init="zeros"),
        # block-diagonal per-head projections (xLSTM paper's BlockDiagonal)
        "wq": P((heads, dh, dh), ("heads", None, "head_dim")),
        "wk": P((heads, dh, dh), ("heads", None, "head_dim")),
        "wv": P((heads, dh, dh), ("heads", None, "head_dim")),
        "w_if": P((inner, 2 * heads), ("inner", None), scale=0.01),
        "b_if": P((2 * heads,), (None,), init="zeros"),
        "out_norm": P((inner,), ("inner",), init="zeros"),
        "w_down": P((inner, d), ("inner", "embed")),
    }


def _mlstm_in(p, u, cfg, conv_state=None):
    """Norm, up and gate projections, conv, per-head q/k/v and the gates:
    (q, k, v (B, L, H, dh), log input gate i and log forget gate f (B, L,
    H) float32, the output gate's input, the conv's new state)."""
    inner, heads, dh = _mdims(cfg)
    b, l, _ = u.shape
    xn = rmsnorm(u, p["norm"], cfg.norm_eps)
    up = xn @ p["w_up"].to(u.dtype)
    gate = xn @ p["w_gate"].to(u.dtype)
    conv_out, conv_tail = causal_conv(up, p["conv_w"], p["conv_b"],
                                      conv_state)
    conv_h = conv_out.reshape(b, l, heads, dh)
    up_h = up.reshape(b, l, heads, dh)
    qm = torch.einsum("blhd,hde->blhe", conv_h, p["wq"].to(u.dtype))
    km = torch.einsum("blhd,hde->blhe", conv_h,
                      p["wk"].to(u.dtype)) * dh ** -0.5
    vm = torch.einsum("blhd,hde->blhe", up_h, p["wv"].to(u.dtype))
    # the gates read the conv branch, not ``up``
    gates = conv_out @ p["w_if"].to(u.dtype) + p["b_if"].to(u.dtype)
    i_gate = gates[..., :heads].float()
    f_gate = log_sigmoid(gates[..., heads:].float())
    return qm, km, vm, i_gate, f_gate, gate, conv_tail


def _mlstm_out(p, h, gate, u, cfg):
    h = rmsnorm(h, p["out_norm"], cfg.norm_eps)
    return (h * F.silu(gate)) @ p["w_down"].to(u.dtype)


def mlstm(p, u, cfg, return_state: bool = False):
    """u: (B, L, D). Chunkwise-parallel mLSTM block (pre-norm; the caller
    adds the residual) from a zero state, with the exact carried
    running-max stabilizer: the chunk carry is (c_hat, n_hat, M) with
    C_true = c_hat * exp(M). With ``return_state`` also the final state
    ``{"c", "n", "m", "conv"}``."""
    inner, heads, dh = _mdims(cfg)
    b, l, _ = u.shape
    q_len = chunk_len(cfg.xlstm.chunk, l)
    nc = l // q_len

    qm, km, vm, i_gate, f_gate, gate, conv_tail = _mlstm_in(p, u, cfg)
    qh = qm.reshape(b, nc, q_len, heads, dh).float()
    kh = km.reshape(b, nc, q_len, heads, dh).float()
    vh = vm.reshape(b, nc, q_len, heads, dh).float()
    del qm, km, vm
    ic = i_gate.reshape(b, nc, q_len, heads)
    g = torch.cumsum(f_gate.reshape(b, nc, q_len, heads), dim=2)  # <= 0
    # running intra-chunk stabilizer: max_{s<=t} (g_t - g_s + i_s)
    intra_max = g + torch.cummax(ic - g, dim=2).values          # (B,nc,Q,H)

    causal = torch.ones((q_len, q_len), dtype=torch.bool,
                        device=u.device).tril()[None, :, :, None]
    c_hat = u.new_zeros((b, heads, dh, dh), dtype=torch.float32)
    n_hat = u.new_zeros((b, heads, dh), dtype=torch.float32)
    m_run = u.new_full((b, heads), M_INIT, dtype=torch.float32)
    hs = []
    for k in range(nc):
        qk_, kk_, vk_ = qh[:, k], kh[:, k], vh[:, k]              # (B,Q,H,dh)
        gk, ick, imaxk = g[:, k], ic[:, k], intra_max[:, k]       # (B,Q,H)
        g_q = gk[:, -1]                                           # (B,H)
        d_t = torch.maximum(imaxk, m_run[:, None, :] + gk)       # (B,Q,H)
        # intra-chunk
        logw = (gk[:, :, None, :] - gk[:, None, :, :]
                + ick[:, None, :, :] - d_t[:, :, None, :])        # (B,t,s,H)
        w = torch.where(causal, torch.exp(logw), 0.0)
        q_t = qk_.transpose(1, 2)                                 # (B,H,Q,dh)
        k_t = kk_.transpose(1, 2)
        v_t = vk_.transpose(1, 2)
        sw = (q_t @ k_t.transpose(-1, -2)) * w.permute(0, 3, 1, 2)  # (B,H,t,s)
        num = sw @ v_t                                            # (B,H,t,dh)
        den = sw.sum(-1)                                          # (B,H,t)
        # inter-chunk (the carried state)
        w_int = torch.exp(m_run[:, None, :] + gk - d_t).transpose(1, 2)
        num = num + (q_t @ c_hat) * w_int[..., None]
        den = den + (q_t @ n_hat[..., None])[..., 0] * w_int
        lim = torch.exp(-d_t).transpose(1, 2)
        hs.append((num / torch.maximum(den.abs(), lim)[..., None])
                  .transpose(1, 2))                               # (B,Q,H,dh)
        # carry update (the state's stabilizer: intra_max at chunk end)
        sstab = imaxk[:, -1]                                      # (B,H)
        m_new = torch.maximum(m_run + g_q, sstab)
        w_state = torch.exp(g_q[:, None, :] - gk + ick - sstab[:, None, :])
        kw = (k_t * w_state.transpose(1, 2)[..., None])          # (B,H,Q,dh)
        c_rel = kw.transpose(-1, -2) @ v_t                        # (B,H,dh,dh)
        n_rel = kw.sum(2)                                         # (B,H,dh)
        scale_old = torch.exp(m_run + g_q - m_new)
        scale_new = torch.exp(sstab - m_new)
        c_hat = (c_hat * scale_old[:, :, None, None]
                 + c_rel * scale_new[:, :, None, None])
        n_hat = n_hat * scale_old[:, :, None] + n_rel * scale_new[:, :, None]
        m_run = m_new
    h = torch.cat(hs, dim=1).reshape(b, l, inner).to(u.dtype)
    y = _mlstm_out(p, h, gate, u, cfg)
    if return_state:
        return y, {"c": c_hat, "n": n_hat, "m": m_run, "conv": conv_tail}
    return y


def mlstm_init_state(cfg, batch, dtype=torch.float32, device=None):
    xc = cfg.xlstm
    inner, heads, dh = _mdims(cfg)
    return {
        "c": torch.zeros((batch, heads, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((batch, heads, dh), dtype=dtype, device=device),
        "m": torch.full((batch, heads), M_INIT, dtype=dtype, device=device),
        "conv": torch.zeros((batch, xc.conv_width - 1, inner), dtype=dtype,
                            device=device),
    }


def mlstm_decode(p, u, state, cfg):
    """One exact recurrent mLSTM step (running-max stabilizer). u: (B, 1,
    D); state ``{"c", "n", "m", "conv"}``. Returns (y, the new state, new
    tensors)."""
    inner, heads, dh = _mdims(cfg)
    b = u.shape[0]
    qm, km, vm, i_t, f_t, gate, new_conv = _mlstm_in(p, u, cfg,
                                                     state["conv"])
    i_t, f_t = i_t[:, 0], f_t[:, 0]                               # (B,H)
    m_new = torch.maximum(f_t + state["m"], i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + state["m"] - m_new)
    qh = qm[:, 0].float()                                         # (B,H,dh)
    kh = km[:, 0].float()
    vh = vm[:, 0].float()
    c = (state["c"] * f_p[:, :, None, None]
         + i_p[:, :, None, None] * kh[:, :, :, None] * vh[:, :, None, :])
    n = state["n"] * f_p[:, :, None] + i_p[:, :, None] * kh
    num = (qh[:, :, None, :] @ c)[:, :, 0]                        # (B,H,dh)
    # stabilized normalizer: h_true = num / max(|den|, 1) in true scale,
    # i.e. max(|den_hat|, exp(-m)) in the carried scale (c, n * exp(-m))
    den = torch.maximum((n * qh).sum(-1).abs(), torch.exp(-m_new))
    h = (num / den[:, :, None]).reshape(b, 1, inner).to(u.dtype)
    y = _mlstm_out(p, h, gate, u, cfg)
    return y, {"c": c, "n": n, "m": m_new, "conv": new_conv}


# ---------------------------------------------------------------------------
# sLSTM

def spec_slstm(cfg):
    x = cfg.xlstm
    d = cfg.d_model
    heads = cfg.n_heads
    dh = d // heads
    ffn = int(x.proj_factor_s * d)
    return {
        "norm": P((d,), ("embed",), init="zeros"),
        "conv_w": P((x.conv_width, d), (None, "embed"), scale=0.1),
        "conv_b": P((d,), ("embed",), init="zeros"),
        "w_gates": P((d, 4 * d), ("embed", "inner")),            # i,f,z,o
        "r_gates": P((heads, dh, 4 * dh), ("heads", None, None), scale=0.01),
        "b_gates": P((4 * d,), ("inner",), init="zeros"),
        "out_norm": P((d,), ("embed",), init="zeros"),
        "ffn": {
            "w_in": P((d, ffn), ("embed", "mlp")),
            "w_gate": P((d, ffn), ("embed", "mlp")),
            "w_out": P((ffn, d), ("mlp", "embed")),
        },
    }


def slstm_init_state(cfg, batch, dtype=torch.float32, device=None):
    d = cfg.d_model
    x = cfg.xlstm
    return {
        "c": torch.zeros((batch, d), dtype=dtype, device=device),
        "n": torch.full((batch, d), N_FLOOR, dtype=dtype, device=device),
        "h": torch.zeros((batch, d), dtype=dtype, device=device),
        "m": torch.full((batch, d), M_INIT, dtype=dtype, device=device),
        "conv": torch.zeros((batch, x.conv_width - 1, d), dtype=dtype,
                            device=device),
    }


def _slstm_cell(r32, b32, wx, h_prev, c, n, m):
    """One step. r32: the recurrent weights (H, dh, 4 dh) and b32 the
    gate bias (4 d), both float32; wx: (B, 4 d) the step's precomputed
    input contribution."""
    heads, dh, _ = r32.shape
    b = wx.shape[0]
    rec = torch.bmm(h_prev.reshape(b, heads, dh).transpose(0, 1), r32)
    # (H, B, 4 dh) -> the reference's (B, H, 4, dh) -> (B, 4, H, dh) layout
    rec = rec.reshape(heads, b, 4, dh).permute(1, 2, 0, 3).reshape(b, -1)
    gates = wx + rec + b32
    it, ft, zt, ot = gates.chunk(4, dim=-1)
    fm = ft + m                    # the reference's ft + m, summed once
    m_new = torch.maximum(fm, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(fm - m_new)
    c_new = f_p * c + i_p * torch.tanh(zt)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(ot) * c_new / torch.clamp_min(n_new, N_FLOOR)
    return h_new, c_new, n_new, m_new


def _slstm_in(p, u, cfg, conv_state=None):
    """Norm, conv and the input half of the gates: (wx (B, L, 4 d)
    float32, the conv's new state). i and f read the conv branch, z and o
    the raw one (xLSTM paper)."""
    d = u.shape[-1]
    xn = rmsnorm(u, p["norm"], cfg.norm_eps)
    conv_out, conv_tail = causal_conv(xn, p["conv_w"], p["conv_b"],
                                      conv_state)
    w = p["w_gates"].to(u.dtype)
    wx = torch.cat([conv_out @ w[:, :2 * d], xn @ w[:, 2 * d:]], dim=-1)
    return wx.float(), conv_tail


def _slstm_out(p, h_seq, cfg):
    h_seq = rmsnorm(h_seq, p["out_norm"], cfg.norm_eps)
    f = p["ffn"]
    hf = h_seq @ f["w_in"].to(h_seq.dtype)
    gf = h_seq @ f["w_gate"].to(h_seq.dtype)
    return (F.silu(gf) * hf) @ f["w_out"].to(h_seq.dtype)


def slstm(p, u, cfg, state=None, return_state: bool = False):
    """u: (B, L, D) -> (B, L, D): the cell looped over time from ``state``
    (zeros, n at 1e-6, m at -1e30 when None), then the block's own gated
    FFN. With ``return_state`` also the final ``{"c", "n", "h", "m",
    "conv"}``; the conv starts from zeros, as in the reference."""
    b, l, _ = u.shape
    wx, conv_tail = _slstm_in(p, u, cfg)
    st = state or slstm_init_state(cfg, b, device=u.device)
    r32, b32 = p["r_gates"].float(), p["b_gates"].float()
    h, c, n, m = (st[k].float() for k in ("h", "c", "n", "m"))
    hs = []
    for t in range(l):
        h, c, n, m = _slstm_cell(r32, b32, wx[:, t], h, c, n, m)
        hs.append(h)
    y = _slstm_out(p, torch.stack(hs, dim=1).to(u.dtype), cfg)
    if return_state:
        return y, {"c": c, "n": n, "h": h, "m": m, "conv": conv_tail}
    return y


def slstm_decode(p, u, state, cfg):
    """One sLSTM step. u: (B, 1, D); state as ``slstm_init_state``'s.
    Returns (y, the new state, new tensors)."""
    wx, new_conv = _slstm_in(p, u, cfg, state["conv"])
    h, c, n, m = _slstm_cell(p["r_gates"].float(), p["b_gates"].float(),
                             wx[:, 0], *(state[k].float()
                                         for k in ("h", "c", "n", "m")))
    y = _slstm_out(p, h[:, None, :].to(u.dtype), cfg)
    return y, {"c": c, "n": n, "h": h, "m": m, "conv": new_conv}
