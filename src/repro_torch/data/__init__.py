# repro: quarantine -- growth-seed LM training path; nothing in the battery system imports it
"""The LM stack's training data (port of ``repro/data``)."""
