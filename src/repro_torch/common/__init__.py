"""Shared helpers: 32/64-bit unsigned arithmetic on int64 tensors and
device resolution."""
