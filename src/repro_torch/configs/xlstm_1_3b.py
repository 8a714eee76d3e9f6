# repro: quarantine -- growth-seed LM model configs; nothing in the battery system reads them
"""xlstm-1.3b [arXiv:2405.04517].

48 blocks d_model=2048, 4 heads, mLSTM:sLSTM = 7:1 (xLSTM[7:1]), no separate
FFN (d_ff=0; blocks carry their own projections), vocab=50304.
"""
import dataclasses

from repro_torch.common.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    rope=False,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor_m=2.0,
                      proj_factor_s=4.0 / 3.0, conv_width=4, chunk=128),
    train_accum=4,
)


def reduced():
    """Smoke-test scale config of the same family."""
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
        vocab_size=256,
        xlstm=XLSTMConfig(slstm_every=2, conv_width=4, chunk=16),
    )
