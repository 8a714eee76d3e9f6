# repro: quarantine -- growth-seed LM model configs; nothing in the battery system reads them
"""chameleon-34b [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536; early-fusion VQ image
tokens share the text vocab (frontend stub: inputs are token ids over the
fused vocab). QK-norm for stability (per the paper).
"""
import dataclasses

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    act="silu",
    gated_mlp=True,
    qk_norm=True,
    rope=True,
    rope_theta=10000.0,
    frontend="fused",
    scan_group=8,
    train_accum=8,
)


def reduced():
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=128, vocab_size=256,
                               scan_group=0)
