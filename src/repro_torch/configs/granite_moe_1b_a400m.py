# repro: quarantine -- growth-seed LM model configs; nothing in the battery system reads them
"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) vocab=49155, MoE 32 experts top-8,
expert d_ff=512 (SwiGLU experts); tied embeddings. Head dim 64.
"""
import dataclasses

from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,                      # per-expert d_ff
    vocab_size=49155,
    act="silu",
    gated_mlp=True,
    rope=True,
    rope_theta=10000.0,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
)


def reduced():
    """Smoke-test scale config of the same family."""
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
        vocab_size=256, moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32),
    )
