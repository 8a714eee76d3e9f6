"""Unsigned 32/64-bit arithmetic carried in ``int64`` tensors.

The port's answer to ``repro/common/compat.py`` and
``repro/rng/generators.x64``: PyTorch on the CPU has no ``>>`` on
``uint32``/``uint64`` and no popcount, so every word lives in an
``int64`` tensor. A 64-bit state is its two's-complement bit pattern:
``+``, ``*`` and ``<<`` on int64 wrap modulo 2^64 exactly like the
unsigned ops, so the wrapping multiply is plain ``*``; only ``>>``
needs masking (``lsr``). A 32-bit word is a non-negative value below
2^32.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_TWO64 = 1 << 64


def s64(c: int) -> int:
    """A Python int taken modulo 2^64, as the int64 with the same bits."""
    c %= _TWO64
    return c - _TWO64 if c >= 1 << 63 else c


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of a 64-bit pattern by a constant ``s``."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def hi32(x: torch.Tensor) -> torch.Tensor:
    """Top 32 bits of a 64-bit pattern, as a word in ``[0, 2^32)``."""
    return lsr(x, 32)


def lo32(x: torch.Tensor) -> torch.Tensor:
    """Bottom 32 bits of a 64-bit pattern."""
    return x & MASK32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of words in ``[0, 2^32)``."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1) (``rng/generators.py:431``)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
