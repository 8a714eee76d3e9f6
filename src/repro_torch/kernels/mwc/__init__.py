"""Multiply-with-carry words on the card (port-only kernel; the
reference's ``mwc_block`` is a sequential ``lax.scan``)."""
