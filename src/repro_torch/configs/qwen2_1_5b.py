# repro: quarantine -- growth-seed LM model configs; nothing in the battery system reads them
"""qwen2-1.5b [arXiv:2407.10671]. 28L d1536 12H (GQA kv=2) d_ff=8960 vocab=151936, QKV bias."""
import dataclasses

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    act="silu",
    qkv_bias=True,
    rope=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    train_accum=4,                 # 12 heads unshardable on TP=16 -> shrink
)


def reduced():
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=128, vocab_size=256)
