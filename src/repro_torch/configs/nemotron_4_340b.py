# repro: quarantine -- growth-seed LM model configs; nothing in the battery system reads them
"""nemotron-4-340b [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000; squared-ReLU
(non-gated) MLP. Head dim 18432 / 96 = 192. Memory preset: bf16 params +
bf16 Adam moments (8-bit-Adam-class footprint), full remat in nested
groups of 8 layers, 16 accumulation microbatches; the reduced form trains
in float32 without groups.
"""
import dataclasses

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    act="relu2",
    gated_mlp=False,
    rope=True,
    rope_theta=10000.0,
    param_dtype="bfloat16",
    adam_dtype="bfloat16",
    remat_policy="full",
    scan_group=8,                  # nested remat: 12 groups of 8 layers
    train_accum=16,
)


def reduced():
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=256, vocab_size=256,
                               scan_group=0, param_dtype="float32",
                               adam_dtype="float32")
