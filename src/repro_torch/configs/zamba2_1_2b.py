# repro: quarantine -- growth-seed LM model configs; nothing in the battery system reads them
"""zamba2-1.2b [arXiv:2411.15242].

38 Mamba-2 layers d_model=2048 (ssm_state=64) + ONE shared attention(+MLP)
block (32H MHA, d_ff=8192) applied every 6 ssm layers with shared weights,
vocab=32000.
"""
import dataclasses

from repro_torch.common.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,                     # shared block MLP
    vocab_size=32000,
    act="gelu",
    gated_mlp=True,
    rope=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    shared_attn_every=6,
    train_accum=4,
)


def reduced():
    """Smoke-test scale config of the same family."""
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, shared_attn_every=2,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
    )
