# repro: quarantine -- growth-seed LM model configs; nothing in the battery system reads them
"""glm4-9b [hf:THUDM/glm-4-9b]. 40L d4096 32H (GQA kv=2) d_ff=13696 vocab=151552."""
import dataclasses

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    act="silu",
    gated_mlp=True,
    qkv_bias=True,                 # GLM-4 uses QKV bias
    rope=True,
    rope_theta=10000.0,
    train_accum=8,
)


def reduced():
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=128, vocab_size=256)
