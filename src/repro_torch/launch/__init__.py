"""Entry points: the battery CLI and the pool's slot layout."""
