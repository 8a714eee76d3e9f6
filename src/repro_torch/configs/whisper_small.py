# repro: quarantine -- growth-seed LM model configs; nothing in the battery system reads them
"""whisper-small [arXiv:2212.04356].

Enc-dec, 12+12L d_model=768 12H (MHA kv=12) d_ff=3072 (plain GELU)
vocab=51865. The conv frontend is a stub, as in the reference: the
caller supplies precomputed frame embeddings (B, 1500, 768).
"""
import dataclasses

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    n_layers=12,                   # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    act="gelu_plain",
    gated_mlp=False,
    rope=False,                    # whisper: learned/sinusoidal absolute pos
    is_encoder_decoder=True,
    n_encoder_layers=12,
    encoder_seq=1500,
    frontend="frames",
    norm_eps=1e-5,
)


def reduced():
    return dataclasses.replace(CONFIG, n_layers=2, n_encoder_layers=2,
                               d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                               vocab_size=256, encoder_seq=32)
