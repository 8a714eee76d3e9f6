"""Generators under test, in PyTorch — bitwise twins of
``repro/rng/generators.py``.

Every generator exposes ``block(seed, stream, n, offset=0, *, device)``:
``n`` words of the (seed, stream) sequence starting at word ``offset``,
as an int64 tensor of values in ``[0, 2^32)`` (``common/ints.py``).

Counter-based generators (splitmix64, msweyl, threefry, pcg32/lcg64 by
LCG jump-ahead) evaluate every word in parallel. xorshift64*, RANDU and
MINSTD use the reference's jump-ahead cycle splitting: a square-and-
multiply ladder per lane, so their words equal the sequential
recurrence. MWC is a Lehmer generator modulo the prime ``a*2^32 - 1``
in disguise, so its kernel jumps each thread to its own chunk
(``kernels/mwc``); the registry still declares it not counter-based and
gives it no offset, as the reference does. RANDU is the known-bad
canary.

Threefry reproduces ``jax.random`` as configured with
``jax_threefry_partitionable=True`` (the default since JAX 0.5):
``PRNGKey``, ``fold_in`` and a scalar ``bits`` draw, hashed per word.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.ints import MASK32, hi32, lo32, lsr, s64
from repro_torch.kernels.mwc.ops import mwc as mwc_words
from repro_torch.rng.sources import register_generator

GOLDEN = 0x9E3779B97F4A7C15
LCG_A = 6364136223846793005
LCG_C = 1442695040888963407


def _mix_seed(seed: int, stream: int) -> int:
    """The reference's (seed, stream) -> 64-bit start state, exactly."""
    return s64(int(seed) * LCG_A + int(stream) * GOLDEN + LCG_C)


def _counter(n: int, offset: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int64,
                        device=device) + int(offset)


def _jump_bits(n: int, offset: int) -> int:
    """Ladder length covering every lane index ``1..n+offset``."""
    return max(int(int(n) + int(offset)).bit_length(), 1)


# ---------------------------------------------------------------------------
# counter-based

def _splitmix_hash(z):
    z = z + s64(GOLDEN)
    z = (z ^ lsr(z, 30)) * s64(0xBF58476D1CE4E5B9)
    z = (z ^ lsr(z, 27)) * s64(0x94D049BB133111EB)
    return z ^ lsr(z, 31)


def splitmix64_block(seed, stream, n, offset=0, *, device=None):
    """SplitMix64 in counter mode."""
    dev = resolve_device(device)
    ctr = _counter(n, offset, dev) * s64(GOLDEN) + _mix_seed(seed, stream)
    return hi32(_splitmix_hash(ctr))


def msweyl_block(seed, stream, n, offset=0, *, device=None):
    """Middle-Square Weyl sequence (Widynski), counter form."""
    dev = resolve_device(device)
    s = _mix_seed(seed, stream) | 1
    w = _counter(n, offset, dev, start=1) * s
    x = w
    for _ in range(3):
        x = x * x + w
        x = lsr(x, 32) | (x << 32)
    return hi32(x)


_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(v, r):
    return ((v << r) | (v >> (32 - r))) & MASK32


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on 32-bit words carried in int64
    (JAX's ``_threefry2x32_lowering``). Keys and counts broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def _fold_in(k0, k1, data):
    """``jax.random.fold_in``: hash the count pair (0, data)."""
    return _threefry2x32(k0, k1, torch.zeros_like(data), data)


def threefry_block(seed, stream, n, offset=0, *, device=None):
    """Word i is ``bits(fold_in(fold_in(key, hi32(c)), lo32(c)))`` for
    the 64-bit counter ``c = offset + i`` and
    ``key = fold_in(PRNGKey(seed), stream)`` (reference docstring)."""
    dev = resolve_device(device)
    seed = int(seed) % (1 << 64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    key = _fold_in(zero + (seed >> 32), zero + (seed & MASK32),
                   zero + (int(stream) & MASK32))
    ctr = _counter(n, offset, dev)
    k0, k1 = _fold_in(key[0], key[1], lsr(ctr, 32))
    k0, k1 = _fold_in(k0, k1, lo32(ctr))
    b0, b1 = _threefry2x32(k0, k1, torch.zeros_like(k0),
                           torch.zeros_like(k0))
    return b0 ^ b1


def _lcg_jump(s0: int, idx: torch.Tensor, nbits: int) -> torch.Tensor:
    """state_i = A^i s0 + C (A^i - 1)/(A - 1) per lane: the reference's
    64-step ladder, cut to the bits ``idx`` can have (the skipped steps
    only square powers no lane uses)."""
    a_acc = torch.ones_like(idx)
    c_acc = torch.zeros_like(idx)
    a_pow, c_pow = s64(LCG_A), s64(LCG_C)
    for bit in range(nbits):
        take = ((idx >> bit) & 1) == 1
        c_acc = torch.where(take, c_acc * a_pow + c_pow, c_acc)
        a_acc = torch.where(take, a_acc * a_pow, a_acc)
        c_pow = s64(c_pow * (a_pow + 1))
        a_pow = s64(a_pow * a_pow)
    return a_acc * s0 + c_acc


def pcg32_block(seed, stream, n, offset=0, *, device=None):
    """PCG-XSH-RR 64/32 with per-lane LCG jump-ahead."""
    dev = resolve_device(device)
    st = _lcg_jump(_mix_seed(seed, stream), _counter(n, offset, dev),
                   _jump_bits(n, offset))
    xorshifted = lo32(lsr(lsr(st, 18) ^ st, 27))
    rot = lsr(st, 59)
    return ((xorshifted >> rot)
            | ((xorshifted << ((-rot) & 31)) & MASK32))


def lcg64_block(seed, stream, n, offset=0, *, device=None):
    """64-bit LCG, top 32 bits, by jump-ahead."""
    dev = resolve_device(device)
    st = _lcg_jump(_mix_seed(seed, stream), _counter(n, offset, dev),
                   _jump_bits(n, offset))
    return hi32(st)


# ---------------------------------------------------------------------------
# jump-ahead cycle splitting

def _pow_jump(idx, mult: int, nbits: int, mulmod: Callable):
    """``mult^idx`` per lane by square-and-multiply."""
    acc = torch.ones_like(idx)
    apow = torch.full_like(idx, mult)
    for bit in range(nbits):
        take = ((idx >> bit) & 1) == 1
        acc = torch.where(take, mulmod(acc, apow), acc)
        apow = mulmod(apow, apow)
    return acc


def _xs_step(s: int) -> int:
    mask = (1 << 64) - 1
    s ^= s >> 12
    s ^= (s << 25) & mask
    s ^= s >> 27
    return s


@functools.lru_cache(maxsize=1)
def _xs_jump_cols() -> np.ndarray:
    """Columns of M^(2^k), k = 0..63, for the xorshift64 step matrix M
    over GF(2)^64, as int64 bit patterns (host-side precompute)."""
    cols = [_xs_step(1 << b) for b in range(64)]
    powers = np.empty((64, 64), np.int64)
    for k in range(64):
        powers[k] = [s64(c) for c in cols]
        nxt = []
        for c in cols:               # column b of M^2 = M (column b of M)
            y = 0
            for j in range(64):
                if (c >> j) & 1:
                    y ^= cols[j]
            nxt.append(y)
        cols = nxt
    return powers


def _xor_fold(sel: torch.Tensor) -> torch.Tensor:
    """XOR-reduce the last axis (length 64) by halving."""
    while sel.shape[-1] > 1:
        h = sel.shape[-1] // 2
        sel = sel[..., :h] ^ sel[..., h:]
    return sel[..., 0]


def _xs_jump(s0: int, idx: torch.Tensor, nbits: int) -> torch.Tensor:
    """``M^idx s0`` per lane: GF(2) square-and-multiply over the
    precomputed matrix powers; each matvec XOR-reduces the columns the
    state selects (an unrolled reduce: torch has no XOR reduction)."""
    pows = torch.as_tensor(_xs_jump_cols(), device=idx.device)
    bitpos = torch.arange(64, dtype=torch.int64, device=idx.device)
    s = torch.full_like(idx, s0)
    for k in range(nbits):
        take = ((idx >> k) & 1) == 1
        bits = ((s[:, None] >> bitpos[None, :]) & 1) == 1
        y = _xor_fold(torch.where(bits, pows[k][None, :],
                                  torch.zeros((), dtype=torch.int64,
                                              device=idx.device)))
        s = torch.where(take, y, s)
    return s


# lane length of the xorshift cycle split (``repro`` XS_CHUNK)
XS_CHUNK = 64


def _xs_next(s):
    s = s ^ lsr(s, 12)
    s = s ^ (s << 25)
    return s ^ lsr(s, 27)


def xorshift64s_block(seed, stream, n, offset=0, *, device=None):
    """xorshift64* by cycle splitting: lane l jumps to state
    ``M^(l*XS_CHUNK + offset) s0``, then steps XS_CHUNK times."""
    dev = resolve_device(device)
    s0 = _mix_seed(seed, stream) | 1
    lanes = -(-n // XS_CHUNK)
    starts = (torch.arange(lanes, dtype=torch.int64, device=dev) * XS_CHUNK
              + int(offset))
    s = _xs_jump(s0, starts, _jump_bits(n, offset))
    out = torch.empty((lanes, XS_CHUNK), dtype=torch.int64, device=dev)
    for t in range(XS_CHUNK):
        s = _xs_next(s)
        out[:, t] = s
    return hi32(out.reshape(-1)[:n] * s64(0x2545F4914F6CDD1D))


def _mm31(a, b):
    return (a * b) & 0x7FFFFFFF


def _mm_minstd(a, b):
    return (a * b) % 2147483647


def randu_block(seed, stream, n, offset=0, *, device=None):
    """RANDU: x <- 65539 x mod 2^31, by multiplicative jump-ahead."""
    dev = resolve_device(device)
    s0 = (_mix_seed(seed, stream) & 0x7FFFFFFF) | 1
    idx = _counter(n, offset, dev, start=1)
    st = _mm31(_pow_jump(idx, 65539, _jump_bits(n, offset), _mm31), s0)
    return (st << 1) & MASK32


def minstd_block(seed, stream, n, offset=0, *, device=None):
    """MINSTD: x <- 16807 x mod (2^31 - 1), by jump-ahead."""
    dev = resolve_device(device)
    s0 = _mix_seed(seed, stream) % (1 << 64) % 2147483646 + 1
    idx = _counter(n, offset, dev, start=1)
    st = _mm_minstd(_pow_jump(idx, 16807, _jump_bits(n, offset),
                              _mm_minstd), s0)
    return (st << 1) & MASK32


# ---------------------------------------------------------------------------
# multiply-with-carry (the kernels/mwc kernel on cuda)

def mwc_block(seed, stream, n, *, device=None):
    """Multiply-with-carry (Marsaglia), 32-bit lag-1, from the state
    ``_mix_seed`` gives. On cuda the ``kernels/mwc`` kernel jumps each
    thread to its chunk through the prime ``a*2^32 - 1``; on the CPU its
    plain version, the sequential loop. It takes no offset
    (``counter_based=False``, as in the reference's registry)."""
    s = _mix_seed(seed, stream) % (1 << 64)
    return mwc_words((s >> 32) | 1, (s & MASK32) | 1, n, device)


# ---------------------------------------------------------------------------
# sequential twins (host loops over Python ints)

def _host_words(words, device) -> torch.Tensor:
    return torch.tensor(words, dtype=torch.int64).to(resolve_device(device))


def _scan_words(step, state, n, out_fn, device):
    out = [0] * n
    for i in range(n):
        state = step(state)
        out[i] = out_fn(state)
    return _host_words(out, device)


def xorshift64s_block_scan(seed, stream, n, *, device=None):
    """The O(n) sequential twin of ``xorshift64s_block``."""
    mult = 0x2545F4914F6CDD1D
    return _scan_words(_xs_step, (_mix_seed(seed, stream) | 1) % (1 << 64),
                       n, lambda s: ((s * mult) % (1 << 64)) >> 32, device)


def randu_block_scan(seed, stream, n, *, device=None):
    """Sequential twin of ``randu_block``."""
    s0 = (_mix_seed(seed, stream) & 0x7FFFFFFF) | 1
    return _scan_words(lambda s: (s * 65539) & 0x7FFFFFFF, s0, n,
                       lambda s: (s << 1) & MASK32, device)


def minstd_block_scan(seed, stream, n, *, device=None):
    """Sequential twin of ``minstd_block``."""
    s0 = _mix_seed(seed, stream) % (1 << 64) % 2147483646 + 1
    return _scan_words(lambda s: (s * 16807) % 2147483647, s0, n,
                       lambda s: (s << 1) & MASK32, device)


SCAN_REFERENCE: Dict[str, Callable] = {
    "xorshift64s": xorshift64s_block_scan,
    "randu": randu_block_scan,
    "minstd": minstd_block_scan,
}

# ---------------------------------------------------------------------------
# the registry, in the reference's order (stable gen ids)

GENERATORS: Dict[str, Callable] = {
    "splitmix64": splitmix64_block, "msweyl": msweyl_block,
    "threefry": threefry_block, "pcg32": pcg32_block,
    "lcg64": lcg64_block, "xorshift64s": xorshift64s_block,
    "mwc": mwc_block, "randu": randu_block, "minstd": minstd_block,
}

for _name, _fn in GENERATORS.items():
    register_generator(_name, _fn, counter_based=_name != "mwc")



# ---------------------------------------------------------------------------
# campaign stream grids (``repro/rng/generators.py:380,401``)

def stream_offsets(n_streams: int, span: int) -> np.ndarray:
    """Word offsets of ``n_streams`` disjoint sub-streams ``span`` words
    apart: stream s owns ``[s * span, (s + 1) * span)`` of every (seed,
    stream-id) sequence."""
    if n_streams < 1:
        raise ValueError(f"n_streams must be >= 1, got {n_streams}")
    if span < 1:
        raise ValueError(
            f"span must be >= 1, got {span}: a zero or negative span "
            f"would hand every stream overlapping (or wrapped) words")
    last = (n_streams - 1) * span            # exact Python-int arithmetic
    if last > np.iinfo(np.int64).max:
        raise ValueError(
            f"stream {n_streams - 1} offset {last} overflows int64 "
            f"words; shrink span ({span}) or n_streams ({n_streams})")
    return np.arange(n_streams, dtype=np.int64) * np.int64(span)


def seam_offsets(n_streams: int, span: int, n_words: int) -> np.ndarray:
    """Block offsets straddling each adjacent-stream seam: pair s reads
    ``[(s+1)*span - n_words, (s+1)*span + n_words)``, the last
    ``n_words`` words of stream s and the first ``n_words`` of stream
    s+1, which the ``pairstream`` family splits in half and compares."""
    if n_streams < 2:
        return np.zeros((0,), np.int64)
    if span < 1:
        raise ValueError(
            f"span must be >= 1, got {span}: a zero or negative span "
            f"would place stream 1's seam at or before word 0 and wrap")
    if n_words < 1:
        raise ValueError(f"n_words must be >= 1, got {n_words}")
    if n_words > span:
        raise ValueError(
            f"seam block of {n_words} words needs span >= n_words, "
            f"got span={span}")
    hi = (n_streams - 1) * span + n_words    # exact Python-int arithmetic
    if hi > np.iinfo(np.int64).max:
        raise ValueError(
            f"seam {n_streams - 2} (streams {n_streams - 2}|"
            f"{n_streams - 1}) reads up to word {hi}, which overflows "
            f"int64; shrink span ({span}) or n_streams ({n_streams})")
    seams = np.arange(1, n_streams, dtype=np.int64) * np.int64(span)
    return seams - np.int64(n_words)
