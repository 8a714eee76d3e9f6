"""ctypes launcher of the CUDA multiply-with-carry kernel (``mwc.cu``).

Port-only: the reference generates mwc with a ``lax.scan``
(``src/repro/rng/generators.py``, ``mwc_block``), not a Pallas kernel.
Each call is one launch laid out by ``plan``, a pure function of ``n``
and the card's SM count that the CPU tests reach. Every thread jumps to
its first word through the prime ``P = a*2^32 - 1`` (``mwc.cu`` shows
why the words are exact) with ``jump_table``: ``jump_powers(1)``, the
powers ``a^(2^i) mod P`` for the word-index bits ``i < JUMP_BITS``, in
the form of ``mwc.cu``'s product. ``mwc_words.launches`` counts launches
and ``mwc_words.calls`` counts them by ``n``; nothing else touches
either.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mwc.ref import MASK32, MWC_A

MWC_P = MWC_A * (1 << 32) - 1       # prime
CHUNK = 64                          # the most words a thread writes
JUMP_BITS = 40                      # mwc.cu kJumpBits: word indices < 2^40
MAX_WORDS = 1 << 40                 # keeps the grid below 2^31 blocks
WARP = 32
MAX_THREADS = 128                   # mwc.cu kMaxThreads
# plan: a block takes the largest power of two of words, from one warp's
# 32 up to BLOCK_WORDS, that still gives each SM a block; they go to
# SPLIT_THREADS threads, up to SPLIT_CHUNK words each, then to more
# threads. Longer chunks lengthen each thread's chain of steps, shorter
# ones add jumps, and at 2^23 words smaller blocks keep more warps on an
# SM (PERF.md, from chip_mwc_plans.py)
BLOCK_WORDS = 2048
SPLIT_THREADS = 64
SPLIT_CHUNK = 16
# 1 in the form of mwc.cu's product mont(u, v) = u*v*a^3 mod P
MONT_ONE = pow(MWC_A, -3, MWC_P)


class Plan(NamedTuple):
    """One launch: ``blocks`` blocks of ``threads`` threads, each thread
    ``chunk`` consecutive words (a power of two)."""
    chunk: int
    threads: int
    blocks: int


@functools.lru_cache(maxsize=None)
def jump_powers(chunk: int = CHUNK, bits: int = JUMP_BITS) -> tuple:
    """``A^(2^i) mod P`` for ``i < bits``, ``A = a^chunk mod P``."""
    pows = [pow(MWC_A, chunk, MWC_P)]
    for _ in range(bits - 1):
        pows.append(pows[-1] * pows[-1] % MWC_P)
    return tuple(pows)


@functools.lru_cache(maxsize=None)
def jump_table() -> tuple:
    """The kernel's table: ``jump_powers(1)`` times ``a^-3`` mod P (the
    product's form, ``mwc.cu``), then that form of 1, ``MONT_ONE``."""
    return tuple(p * MONT_ONE % MWC_P for p in jump_powers(1)) + (MONT_ONE,)


@functools.lru_cache(maxsize=None)
def plan(n: int, sms: int, *, chunk=None, threads=None) -> Plan:
    """The launch for ``n`` words on a card with ``sms`` SMs: a block's
    words are the largest power of two that still gives every SM a block
    (at least one warp of one word each, at most ``BLOCK_WORDS``), over
    ``SPLIT_THREADS`` threads up to ``SPLIT_CHUNK`` words each, then over
    more threads. ``chunk`` and ``threads`` override the split, up to
    ``CHUNK`` words and ``MAX_THREADS`` threads, to time other layouts
    (``chip_mwc_plans.py``)."""
    if not 0 < n < MAX_WORDS:
        raise ValueError(f"mwc plan takes 0 < n < 2^40 words, got {n}")
    per_sm = 1 << (max(n // sms, 1).bit_length() - 1)   # a power of two
    per_block = min(BLOCK_WORDS, max(WARP, per_sm))
    c = max(1, min(SPLIT_CHUNK, per_block // SPLIT_THREADS))
    chunk = c if chunk is None else chunk
    threads = per_block // c if threads is None else threads
    if not (0 < chunk <= CHUNK and chunk & (chunk - 1) == 0):
        raise ValueError(f"mwc chunk {chunk} is not a power of two <= "
                         f"{CHUNK}")
    if not (0 < threads <= MAX_THREADS and threads % WARP == 0):
        raise ValueError(f"mwc block of {threads} threads is not a multiple "
                         f"of {WARP} up to {MAX_THREADS}")
    return Plan(chunk, threads, -(-n // (chunk * threads)))


def boundaries(limit: int, sms: int, every_block: bool = True) -> list:
    """The lengths up to ``limit`` at which ``plan(n, sms)`` changes its
    layout (chunk and threads; the length before it too) or its block
    count (k blocks' words and one more), with 1, 2 and ``limit``: where
    the tests and ``chip_smoke.py`` hold the kernel to the loop. Without
    ``every_block``, only the first two and the last block counts of
    each layout."""
    def layout(m):
        return plan(m, sms)[:2]
    out = {1, 2, limit}
    n = 1
    while n <= limit:
        lo, hi = n, limit + 1          # the last length of n's layout
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if layout(mid) == layout(n) else (lo, mid)
        chunk, threads = layout(n)
        per_block = chunk * threads
        if n > 1:
            out |= {n - 1, n}
        ks = range(-(-n // per_block), lo // per_block + 1)
        for k in (ks if every_block else [*ks[:2], *ks[-1:]]):
            out |= {m for m in (k * per_block, k * per_block + 1)
                    if n <= m <= lo}
        n = lo + 1
    return sorted(out)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("mwc").repro_mwc_words
    fn.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    table = (ctypes.c_ulonglong * (JUMP_BITS + 1))(*jump_table())
    return fn, table, ctypes.addressof(table)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x0: int, c0: int, n: int, pl: Plan, device: torch.device,
            index: int) -> torch.Tensor:
    """One launch of plan ``pl`` on the CUDA ``device``, whose index is
    ``index`` (``device.index`` None: the current device); uncounted."""
    out = torch.empty(n, dtype=torch.int64, device=device)
    fn, _, table = _entry()
    # shared memory: threads * (chunk | 1) words (mwc.cu's launch), at most
    # MAX_THREADS * (CHUNK + 1) = 128 * 65
    # repro: vmem-bound 8320
    args = (x0, c0, n, pl.chunk.bit_length() - 1, pl.threads, pl.blocks,
            table, out.data_ptr(), torch._C._cuda_getCurrentRawStream(index))
    rc = fn(*args) if device.index is None else build.call_on(device, fn,
                                                              *args)
    if rc:
        raise RuntimeError(f"mwc kernel launch failed: CUDA error {rc}")
    return out


def mwc_words(x0: int, c0: int, n: int, device) -> torch.Tensor:
    """Words ``[0, n)`` from the state ``(x0, c0)`` (32-bit each) as an
    (n,) int64 tensor on the CUDA ``device``."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"mwc kernel needs a CUDA device, got {device}")
    if not (0 <= x0 <= MASK32 and 0 <= c0 <= MASK32):
        raise ValueError(f"mwc state ({x0}, {c0}) is not two 32-bit words")
    if not 0 <= n < MAX_WORDS:
        raise ValueError(f"mwc kernel takes 0 <= n < 2^40 words, got {n}")
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=device)
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    out = _launch(x0, c0, n, plan(n, sm_count(index)), device, index)
    mwc_words.launches += 1  # repro: noqa RPA103 -- launch counter (chip_smoke.py)
    mwc_words.calls[n] += 1  # repro: noqa RPA103 -- launch counter (chip_smoke.py)
    return out


mwc_words.launches = 0
mwc_words.calls = collections.Counter()
