# repro: quarantine -- growth-seed LM serving path (the dense and vlm families); nothing in the battery system imports it
"""Shared model primitives: norms, activations, softcap, rope (port of
``repro/models/common.py``)."""
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


def norm_spec(d: int):
    """RMSNorm's weight (the reference's layernorm kind serves whisper,
    which is not ported yet)."""
    return {"scale": P((d,), ("embed",), init="zeros")}


def apply_norm(p, x, cfg):
    return rmsnorm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# activations

def act_fn(name: str):
    """The MLP's activation: SiLU (SwiGLU), GELU in its tanh form (GeGLU;
    the reference's ``jax.nn.gelu(approximate=True)``) or squared ReLU
    (nemotron's ungated MLP), each in its input's dtype. The reference's
    plain GELU serves whisper, which is not ported yet."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return relu2
    raise NotImplementedError(
        f"activation {name!r} is not ported yet: only silu, gelu and relu2 "
        f"are (see ROADMAP.md, queue 1 item 4)")


def relu2(x):
    """Squared ReLU, ``jnp.square(jax.nn.relu(x))`` in the reference."""
    return F.relu(x).square()


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
