# repro: quarantine -- growth-seed attention kernel; unrelated to the TestU01 battery kernels
"""Flash attention, forward, causal or not (port of
``repro/kernels/flash_attention``)."""
