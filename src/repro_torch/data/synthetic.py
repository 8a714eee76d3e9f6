# repro: quarantine -- growth-seed LM training path; nothing in the battery system imports it
"""Deterministic synthetic token pipeline (port of
``repro/data/synthetic.py``).

The stream is keyed by (seed, step) through threefry, restart-exact:
resuming from a step checkpoint replays the identical batch sequence
with no data-loader state to save. A light Markov structure (half the
positions copy the token 7 places back) makes the loss fall, not sit at
noise.

The draws are ``jax.random``'s, reproduced on the port's threefry
(``rng/generators.py``) as configured with ``jax_threefry_partitionable``
(the default since JAX 0.5): ``PRNGKey``, ``fold_in``, ``split``, and
the ``randint``, ``bernoulli`` and ``normal`` samplers over word ``i``
of a shape's row-major order, so tokens and labels are the reference's
bit for bit (int32). ``normal`` in bfloat16 (whisper's frames) takes
the reference's 7-bit uniform and ``sqrt(2) erfinv(u)``; ``torch.erfinv``
is not XLA's polynomial, so a frame may sit one bfloat16 step from the
reference's. Everything is built on ``device`` (default ``cuda``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.ints import MASK32
from repro_torch.rng.generators import _fold_in, _threefry2x32


def prng_key(seed: int, device) -> tuple:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^64): its two
    32-bit words, as int64 scalars on ``device``."""
    seed = int(seed) % (1 << 64)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return zero + (seed >> 32), zero + (seed & MASK32)


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in(key, data)``: hash the count pair (0, data)."""
    return _fold_in(key[0], key[1], key[0] * 0 + (int(data) & MASK32))


def split(key: tuple, num: int = 2) -> list:
    """``jax.random.split(key, num)`` (partitionable): key i is the hash
    of the count pair (0, i)."""
    k0, k1 = key
    idx = torch.arange(num, dtype=torch.int64, device=k0.device)
    b0, b1 = _threefry2x32(k0, k1, torch.zeros_like(idx), idx)
    return [(b0[i], b1[i]) for i in range(num)]


def _bits(key: tuple, shape) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)): word ``i`` of the
    row-major order hashes the count pair (hi32(i), lo32(i)), the two
    halves XORed (``random_bits(key, 32, shape)``)."""
    k0, k1 = key
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=k0.device)
    b0, b1 = _threefry2x32(k0, k1, idx >> 32, idx & MASK32)
    return (b0 ^ b1).reshape(shape)


def randint(key: tuple, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` to int32: two 32-bit draws from the split
    key, combined modulo the span in uint32 arithmetic."""
    k1, k2 = split(key)
    hi, lo = _bits(k1, shape), _bits(k2, shape)
    span = max(int(maxval) - int(minval), 1)
    mult = (1 << 16) % span
    mult = (mult * mult & MASK32) % span
    off = (((hi % span) * mult & MASK32) + lo % span & MASK32) % span
    return (off + int(minval)).to(torch.int32)


def bernoulli(key: tuple, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli`` with a float32 ``p``: a float32 uniform
    from the top 23 bits, ``u < p``."""
    u = (_bits(key, shape) >> 9).to(torch.float32) * 2.0 ** -23
    return u < torch.tensor(p, dtype=torch.float32)


def normal_bf16(key: tuple, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, bfloat16)``: a uniform u on the
    bfloat16 grid of (-1, 1) from 7 random bits (the low byte of each
    word, shifted once), then ``sqrt(2) erfinv(u)``, rounded to bfloat16
    after the erfinv and after the product."""
    m = (_bits(key, shape) & 0xFF) >> 1
    # lo + (1 + m/128 - 1) (hi - lo), hi - lo = 2 in bfloat16: exact
    u = torch.clamp_min(m.to(torch.float32) / 64 - 255 / 256, -255 / 256)
    sqrt2 = torch.tensor(math.sqrt(2), dtype=torch.bfloat16)
    return torch.erfinv(u).to(torch.bfloat16) * sqrt2


def batch_at(seed: int, step: int, global_batch: int, seq_len: int,
             vocab: int, frames_spec=None, device=None) -> dict:
    """Step ``step``'s batch of the stream keyed by ``seed``: ``tokens``
    and ``labels`` (the tokens shifted one left) int32 (global_batch,
    seq_len), and with ``frames_spec`` (b, s, d) also bfloat16 ``frames``
    from a normal draw, on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    key = fold_in(prng_key(seed, dev), step)
    k1, k2 = split(key)
    # narrow effective vocab -> the unigram head is learnable in tens of
    # steps (loss floor ~ln(vocab/8) instead of ln(vocab))
    v_eff = max(vocab // 8, 2)
    base = randint(k1, (global_batch, seq_len), 0, v_eff)
    copy = bernoulli(k2, 0.5, (global_batch, seq_len))
    tokens = torch.where(copy, torch.roll(base, 7, dims=1), base)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if frames_spec is not None:
        batch["frames"] = normal_bf16(k2, tuple(frames_spec))
    return batch
