# repro: quarantine -- growth-seed LM serving path (qwen2-1.5b, gemma2-27b); nothing in the battery system imports it
"""Dense gated MLP, SwiGLU or GeGLU by ``cfg.act`` (``models.common.act_fn``;
port of the gated half of ``repro/models/mlp.py``). The matrix products
are ``torch.matmul``: the reference leaves them to XLA outside any
kernel."""
from __future__ import annotations

from repro_torch.models.common import act_fn
from repro_torch.models.params import P


def spec_mlp(cfg, d_ff=None):
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    return {
        "w_in": P((d, f), ("embed", "mlp")),
        "w_gate": P((d, f), ("embed", "mlp")),
        "w_out": P((f, d), ("mlp", "embed")),
    }


def mlp(p, x, cfg):
    """x: (B, S, D) -> (B, S, D): ``act(x w_gate) * (x w_in)``, then
    ``w_out``."""
    gate = act_fn(cfg.act)(x @ p["w_gate"].to(x.dtype))
    h = gate * (x @ p["w_in"].to(x.dtype))
    return h @ p["w_out"].to(x.dtype)
