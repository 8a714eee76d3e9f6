# repro: quarantine -- growth-seed LM serving path (every family of the reference); nothing in the battery system imports it
"""Model configuration of the LM serving and training paths (from the
reference's ``repro/common/config.py``: ``pad_to``, ``MoEConfig``,
``MLAConfig``, ``SSMConfig``, ``XLSTMConfig`` and all 38 of
``ModelConfig``'s fields, the four training knobs with the reference's
defaults: Adam's moment dtype, the remat policy, scan groups and
gradient accumulation).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_to(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0                 # routed experts
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared: int = 0                  # always-on shared experts (DeepSeek)
    d_ff_shared: int = 0
    first_dense_layers: int = 0        # leading dense layers (DeepSeek-V2: 1)
    d_ff_dense: int = 0                # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block config."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8               # 1 sLSTM per `slstm_every` blocks (7:1)
    proj_factor_m: float = 2.0         # mLSTM up-projection factor
    proj_factor_s: float = 4.0 / 3.0   # sLSTM FFN factor
    conv_width: int = 4
    chunk: int = 128                   # mLSTM chunkwise-parallel length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    # dense | vlm (run as dense) | moe | audio (whisper) | ssm (xlstm) |
    # hybrid (zamba2)
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None     # default d_model // n_heads
    act: str = "silu"                  # silu (SwiGLU) | gelu (GeGLU) | gelu_plain | relu2
    gated_mlp: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False              # Chameleon
    rope: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # gemma2
    attn_pattern: Tuple[str, ...] = ("global",)   # e.g. ("local","global")
    local_window: int = 4096
    attn_softcap: float = 0.0          # 0 disables
    final_softcap: float = 0.0
    query_scale: Optional[float] = None  # override 1/sqrt(head_dim)
    post_block_norm: bool = False      # gemma2 post-norms

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # hybrid (zamba2): one shared attn+MLP block applied every k ssm layers
    shared_attn_every: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0               # fixed encoder frame count (stub frontend)

    # inputs: token ids; (fused, vlm) ids over the fused text and image
    # vocabulary; or (frames, audio) decoder token ids beside precomputed
    # encoder frame embeddings (the reference's stub frontend)
    frontend: str = "tokens"           # tokens | fused | frames

    # numerics / memory knobs (per-arch presets)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    adam_dtype: str = "float32"        # bf16 for the 340B preset (8-bit-Adam-style)
    remat_policy: str = "full"         # full | dots | none
    scan_group: int = 0                # 0 = no groups; else groups of g units, each checkpointed
    train_accum: int = 1               # gradient-accumulation microbatches

    # ----- derived -----
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding for clean TP sharding."""
        return pad_to(self.vocab_size, 128)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic-history archs run the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Parameter count from the port's own spec (shapes only)."""
        from repro_torch.models.lm import count_params
        return count_params(self)

    def n_active_params(self) -> int:
        """Parameters one token meets: routed experts' at top_k / n_experts."""
        from repro_torch.models.lm import count_params
        return count_params(self, active_only=True)
