"""Shared helpers: 32/64-bit unsigned arithmetic on int64 tensors, device
resolution and the LM stack's model configuration."""
