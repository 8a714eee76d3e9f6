# repro: quarantine -- growth-seed LM serving path (qwen2-1.5b); nothing in the battery system imports it
"""The LM stack's dense serving path (port of ``repro/models``): plain
functions on tensors over a parameter dict that keeps the reference's
keys, shapes and stacked ``units`` layout."""
