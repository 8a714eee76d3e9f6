# repro: quarantine -- growth-seed LM serving path (every ported family); nothing in the battery system imports it
"""Shared model primitives: norms, activations, softcap, rope, whisper's
sinusoidal positions (port of ``repro/models/common.py``), and what the Mamba-2 and xLSTM blocks share:
softplus, log-sigmoid, the chunk length, and the depthwise causal conv
(the reference's ``ssm._causal_conv`` and ``xlstm._conv_causal``, one
function)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import P


# ---------------------------------------------------------------------------
# norms

def rmsnorm(x, weight, eps=1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + weight)``, in float32 inside."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def layernorm(x, weight, bias, eps=1e-5):
    """``(x - mean) * rsqrt(var + eps) * weight + bias`` over the last
    dim (population variance), in float32 inside."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def norm_spec(d: int, kind: str = "rms"):
    """RMSNorm's weight (zeros: ``1 + w``), or with ``kind="ln"`` (whisper)
    LayerNorm's ``scale`` (ones) and ``bias`` (zeros)."""
    if kind == "rms":
        return {"scale": P((d,), ("embed",), init="zeros")}
    return {"scale": P((d,), ("embed",), init="ones"),
            "bias": P((d,), ("embed",), init="zeros")}


def apply_norm(p, x, cfg):
    """LayerNorm where the norm's parameters hold a ``bias``, else
    RMSNorm; eps ``cfg.norm_eps``."""
    if "bias" in p:
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# activations

def act_fn(name: str):
    """The MLP's activation: SiLU (SwiGLU), GELU in its tanh form (GeGLU;
    the reference's ``jax.nn.gelu(approximate=True)``), the exact GELU
    (whisper's ungated MLP) or squared ReLU (nemotron's ungated MLP),
    each in its input's dtype."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "gelu_plain":
        return gelu_plain
    if name == "relu2":
        return relu2
    raise ValueError(f"unknown activation {name!r}: the reference has silu, "
                     f"gelu, gelu_plain and relu2")


def gelu_plain(x):
    """The exact GELU, ``x * (1 + erf(x / sqrt(2))) / 2``: the reference's
    ``jax.nn.gelu(approximate=False)``."""
    return F.gelu(x, approximate="none")


def relu2(x):
    """Squared ReLU, ``jnp.square(jax.nn.relu(x))`` in the reference."""
    return F.relu(x).square()


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))``, the reference's formula. ``F.softplus`` returns
    ``x`` itself above its threshold 20, where the dropped
    ``log1p(exp(-x))`` is under 2.1e-9: below float32's resolution at 20
    (1.9e-6), so the two round alike there too."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x) = min(x, 0) -
    log1p(exp(-|x|))``, the formula ``F.logsigmoid`` also computes."""
    return x.clamp_max(0) - torch.log1p(torch.exp(-x.abs()))


def chunk_len(chunk: int, length: int) -> int:
    """The chunk length of the Mamba-2 and mLSTM blocks' chunked forms,
    as the reference's: ``min(chunk, length)``, halved until it
    divides ``length``."""
    q = min(chunk, length)
    while length % q:
        q //= 2
    return q


def causal_conv(x, w, b, state=None):
    """Depthwise causal conv of width K, then SiLU. x: (B, L, C); w: (K, C);
    state: the previous K - 1 inputs (B, K - 1, C), zeros when None.
    Returns (out (B, L, C), the last K - 1 inputs (B, K - 1, C)).

    A shifted sum in the reference's order, in x's dtype:
    ``((x_0 w_0 + x_1 w_1) + ...) + b``; not ``F.conv1d``, which on the
    card goes to cuDNN and may run float32 on TF32."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    full = torch.cat([pad, x], dim=1)
    n = x.shape[1]
    out = full[:, 0:n] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + full[:, i:i + n] * w[i].to(x.dtype)
    return F.silu(out + b.to(x.dtype)), full[:, n:]


def softcap(x, cap: float):
    """``tanh(x / cap) * cap``; ``cap`` 0 leaves ``x`` as it is."""
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# rotary embeddings

def rope_angles(positions, head_dim: int, theta: float):
    """positions: (..., S) int -> cos/sin (..., S, head_dim//2) fp32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D). cos/sin: (B, S, D//2) or (S, D//2). Half-split
    rotation in float32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# sinusoidal absolute positions (whisper's encoder)

def sinusoid_pos(seq: int, d: int, dtype=torch.float32, device=None):
    """(seq, d): ``[sin(pos / 10000^(2i/d)), cos(...)]`` over i < d/2,
    computed in float32 and cast to ``dtype``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
