# repro: quarantine -- growth-seed LM serving path (the dense, vlm and moe families); nothing in the battery system imports it
"""Dense MLP: gated (SwiGLU or GeGLU by ``cfg.act``) or, with
``cfg.gated_mlp`` off, plain ``act(x w_in) w_out`` (nemotron's squared
ReLU) (port of ``repro/models/mlp.py``). The matrix products are
``torch.matmul``: the reference leaves them to XLA outside any kernel."""
from __future__ import annotations

from repro_torch.models.common import act_fn
from repro_torch.models.params import P


def spec_mlp(cfg, d_ff=None):
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    spec = {
        "w_in": P((d, f), ("embed", "mlp")),
        "w_out": P((f, d), ("mlp", "embed")),
    }
    if cfg.gated_mlp:
        spec["w_gate"] = P((d, f), ("embed", "mlp"))
    return spec


def mlp(p, x, cfg):
    """x: (..., D) -> (..., D): ``act(x w_gate) * (x w_in)`` where the
    block has a gate, else ``act(x w_in)``; then ``w_out``. Weights with
    a leading dim (the MoE layer's experts) batch over it."""
    act = act_fn(cfg.act)
    if "w_gate" in p:
        h = act(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_in"].to(x.dtype))
    else:
        h = act(x @ p["w_in"].to(x.dtype))
    return h @ p["w_out"].to(x.dtype)
