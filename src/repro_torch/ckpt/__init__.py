"""Checkpoint IO of the port (``repro/ckpt``)."""
