# repro: quarantine -- growth-seed LM model configs; nothing in the battery system reads them
"""deepseek-v2-236b [arXiv:2405.04434].

60L d_model=5120 128H, MLA (kv_lora=512, q_lora=1536, rope dim 64; query
and key head dim 128 + 64 = 192, value head dim 128), 2 shared + 160
routed experts top-6, expert d_ff=1536, first layer dense (d_ff=12288),
vocab=102400. ``n_kv_heads`` is 128 (MLA derives every head's k and v
from the shared latent) and ``head_dim_`` (5120 / 128 = 40) sizes
nothing: MLA's dims come from ``mla``.
"""
import dataclasses

from repro_torch.common.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,                # MLA: per-head KV derived from shared latent
    d_ff=1536,                     # per-expert d_ff
    vocab_size=102400,
    act="silu",
    gated_mlp=True,
    rope=True,
    rope_theta=10000.0,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                  n_shared=2, d_ff_shared=1536,
                  first_dense_layers=1, d_ff_dense=12288),
    remat_policy="full",
    train_accum=16,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        vocab_size=256,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                      d_ff_shared=32, first_dense_layers=1, d_ff_dense=64),
    )
