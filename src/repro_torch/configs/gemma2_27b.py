# repro: quarantine -- growth-seed LM model configs; nothing in the battery system reads them
"""gemma2-27b [arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16, head_dim=128) d_ff=36864 (GeGLU)
vocab=256000; alternating local(4096)/global attention; attn softcap 50,
final logit softcap 30; query scale 1/sqrt(d_model/n_heads)=1/sqrt(144).
"""
import dataclasses

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    act="gelu",
    rope=True,
    rope_theta=10000.0,
    tie_embeddings=True,
    attn_pattern=("local", "global"),
    local_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,
    post_block_norm=True,
    train_accum=4,
)


def reduced():
    return dataclasses.replace(CONFIG, n_layers=4, d_model=64, n_heads=4,
                               n_kv_heads=2, head_dim=16, d_ff=128,
                               vocab_size=256, local_window=16,
                               query_scale=(64 / 4) ** -0.5)
