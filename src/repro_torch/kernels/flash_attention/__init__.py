# repro: quarantine -- growth-seed attention kernel; unrelated to the TestU01 battery kernels
"""Causal flash attention, forward (port of
``repro/kernels/flash_attention``)."""
