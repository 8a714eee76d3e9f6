"""ctypes launcher of the CUDA multiply-with-carry kernel (``mwc.cu``).

Port-only: the reference generates mwc with a ``lax.scan``
(``src/repro/rng/generators.py``, ``mwc_block``), not a Pallas kernel.
The kernel jumps each thread to its chunk of the sequence through the
prime ``P = a*2^32 - 1`` (``mwc.cu`` shows why the words are exact);
``jump_powers`` is the table of ``A^(2^i) mod P``, ``A = a^CHUNK mod P``,
that the host hands it. ``mwc_words.launches`` counts launches and
``mwc_words.calls`` counts them by ``n``; nothing else touches either.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mwc.ref import MASK32, MWC_A

MWC_P = MWC_A * (1 << 32) - 1       # prime
CHUNK = 64                          # mwc.cu kChunk: words per thread
JUMP_BITS = 40                      # mwc.cu kJumpBits: chunks below 2^40
MAX_WORDS = 1 << 40                 # keeps the grid below 2^31 blocks


@functools.lru_cache(maxsize=None)
def jump_powers(chunk: int = CHUNK, bits: int = JUMP_BITS) -> tuple:
    """``A^(2^i) mod P`` for ``i < bits``, ``A = a^chunk mod P``."""
    pows = [pow(MWC_A, chunk, MWC_P)]
    for _ in range(bits - 1):
        pows.append(pows[-1] * pows[-1] % MWC_P)
    return tuple(pows)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("mwc").repro_mwc_words
    fn.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, (ctypes.c_ulonglong * JUMP_BITS)(*jump_powers())


def mwc_words(x0: int, c0: int, n: int, device) -> torch.Tensor:
    """Words ``[0, n)`` from the state ``(x0, c0)`` (32-bit each) as an
    (n,) int64 tensor on the CUDA ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"mwc kernel needs a CUDA device, got {device}")
    if not (0 <= x0 <= MASK32 and 0 <= c0 <= MASK32):
        raise ValueError(f"mwc state ({x0}, {c0}) is not two 32-bit words")
    if not 0 <= n < MAX_WORDS:
        raise ValueError(f"mwc kernel takes 0 <= n < 2^40 words, got {n}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out
    fn, pows = _entry()
    rc = build.call_on(device, fn, x0, c0, n, ctypes.addressof(pows),
                       out.data_ptr(),
                       torch._C._cuda_getCurrentRawStream(device.index))
    if rc:
        raise RuntimeError(f"mwc kernel launch failed: CUDA error {rc}")
    mwc_words.launches += 1
    mwc_words.calls[n] += 1
    return out


mwc_words.launches = 0
mwc_words.calls = collections.Counter()
