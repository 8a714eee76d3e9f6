# repro: quarantine -- growth-seed LM training path; nothing in the battery system imports it
"""The LM stack's training (port of ``repro/train``): AdamW and its
schedule (``optim``), the accumulating train step (``step``)."""
