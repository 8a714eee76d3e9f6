"""The bit-source layer (``repro/rng/sources.py``): the generator
registry and captured bitstreams.

Every layer above (pool, api, campaign, launch) takes a ``BitSource``:

  ``GeneratorSource``  a registered generator; its words are computed on
                       the pool's device by the registry's block function
                       (``switch_block``).
  ``CapturedSource``   bits this package did not generate: a
                       memory-mapped ``.npy`` or raw little-endian u32
                       file, sharded by stream, read on the host and
                       copied to the device once per round
                       (``pool.gather_captured_bits``).

``register_generator`` appends a block function under the next stable
``gen_id``; built-ins register in the reference's order
(``repro/rng/generators.py:355-363``), so a gen id means the same
generator in both packages, and a process that registers the same
external generators in the same order (the ``--register`` CLI hook)
resumes any checkpoint or ledger that named them.

Offset convention: ``offset=None`` means "no offset"; an integer reads
words ``[offset, offset + n)``. Sources that cannot seek raise
``OffsetNotSupportedError`` from the single ``require_offsetable`` gate.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.ints import MASK32


class OffsetNotSupportedError(ValueError):
    """A non-zero stream offset was asked of a source that cannot seek
    (``counter_based=False``: ``mwc``, as the reference declares it)."""


class CapturedBitsError(ValueError):
    """A ``CapturedSource`` read ran past the captured material: a stream
    shard index or a word range out of bounds."""


def require_offsetable(source, offset, where: str = "stream offset") -> None:
    """Raise ``OffsetNotSupportedError`` when ``offset`` is non-zero and
    ``source`` is not counter-based. ``None`` and 0 always pass."""
    if offset is None or not int(offset):
        return
    if not source.counter_based:
        raise OffsetNotSupportedError(
            f"source {source.name!r} is not offset-continuable "
            f"(counter_based=False); it cannot take a non-zero {where}")


# ---------------------------------------------------------------------------
# the generator registry


@dataclasses.dataclass(frozen=True)
class RegisteredGenerator:
    """One registry row: block function, stable lane id, capability."""
    name: str
    gen_id: int
    block_fn: Callable
    counter_based: bool


_REGISTRY: Dict[str, RegisteredGenerator] = {}


def _ensure_builtins() -> None:
    """Register the built-in generators on first use of the registry."""
    if not _REGISTRY:
        import repro_torch.rng.generators  # noqa: F401 (registers built-ins)


def register_generator(name: str, block_fn: Callable, *,
                       counter_based: bool) -> RegisteredGenerator:
    """Add a generator under the next stable id. ``block_fn(seed, stream,
    n[, offset], device=...)`` returns ``n`` words as int64 in
    ``[0, 2^32)``. ``counter_based=True`` promises exact continuation:
    ``block(n=2k) == block(n=k) ++ block(n=k, offset=k)``. A duplicate
    name is an error (it would re-key every gen id after it)."""
    _ensure_builtins()
    if name in _REGISTRY:
        raise ValueError(f"generator {name!r} is already registered "
                         f"(gen_id={_REGISTRY[name].gen_id}); "
                         f"unregister_generator it first to replace it")
    row = RegisteredGenerator(name, len(_REGISTRY), block_fn,
                              bool(counter_based))
    _REGISTRY[name] = row
    return row


def unregister_generator(name: str) -> None:
    """Remove the most recently registered generator. Only the last id
    may go: removing one from the middle would renumber every later
    lane and re-key the checkpoints that name them."""
    if name not in _REGISTRY:
        raise KeyError(f"generator {name!r} is not registered")
    if _REGISTRY[name].gen_id != len(_REGISTRY) - 1:
        raise ValueError(
            f"generator {name!r} (gen_id={_REGISTRY[name].gen_id}) is "
            f"not the most recently registered; ids are stable, only "
            f"the last lane may be retired")
    del _REGISTRY[name]


def registry_size() -> int:
    """Number of registered generators."""
    _ensure_builtins()
    return len(_REGISTRY)


def counter_based_names() -> Tuple[str, ...]:
    """Names of the offset-continuable generators, in id order."""
    _ensure_builtins()
    return tuple(r.name for r in _REGISTRY.values() if r.counter_based)


def get_generator(name: str) -> RegisteredGenerator:
    """The registry row for ``name`` (KeyError naming the known set and
    the re-registration an external generator needs)."""
    _ensure_builtins()
    row = _REGISTRY.get(name)
    if row is None:
        raise KeyError(
            f"unknown generator {name!r}; known: {sorted(_REGISTRY)} "
            f"(an external generator must be re-registered via "
            f"register_generator before resuming work that names it)")
    return row


def switch_block(gen_id: int, seed: int, stream: int, n: int,
                 offset=None, *, device=None):
    """``n`` words from registered lane ``gen_id`` (the reference's
    ``lax.switch`` over the registry, as a host-side index). An offset
    of 0 reads what no offset reads, so a non-counter-based lane serves
    it without one."""
    _ensure_builtins()
    row = list(_REGISTRY.values())[gen_id]
    if offset is None or not int(offset):
        return row.block_fn(seed, stream, n, device=device)
    require_offsetable(GeneratorSource(row.name), offset)
    return row.block_fn(seed, stream, n, int(offset), device=device)


# ---------------------------------------------------------------------------
# sources


class BitSource:
    """What every upper layer consumes: ``block(seed, stream, n,
    offset=None, *, device)`` (words ``[offset, offset + n)`` of the
    (seed, stream) sequence, int64 on ``device``), ``name`` (the
    reporting key), ``uid()`` (the identity checkpoints and ledgers pin),
    ``digest()`` (the content identity), ``counter_based`` (takes
    offsets) and ``captured`` (dispatched from host buffers instead of a
    registry lane)."""

    name: str = ""
    counter_based: bool = False
    captured: bool = False

    def block(self, seed, stream, n, offset=None, *, device=None):
        """``n`` words of the (seed, stream) sequence from ``offset``."""
        raise NotImplementedError

    def uid(self) -> str:
        """Stable identity across processes (resume cross-check)."""
        raise NotImplementedError

    def digest(self) -> str:
        """Content identity."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GeneratorSource(BitSource):
    """A registered generator as a bit source, hashable on its name."""
    name: str

    def __post_init__(self):
        get_generator(self.name)            # validate early, KeyError

    @property
    def gen_id(self) -> int:
        """The stable lane id (registry order)."""
        return get_generator(self.name).gen_id

    @property
    def counter_based(self) -> bool:
        """The registry's declared offset capability."""
        return get_generator(self.name).counter_based

    @property
    def captured(self) -> bool:
        """Generator words are computed on the device."""
        return False

    def block(self, seed, stream, n, offset=None, *, device=None):
        """``n`` words of the (seed, stream) sequence from ``offset``."""
        return switch_block(self.gen_id, seed, stream, n, offset,
                            device=device)

    def uid(self) -> str:
        """``gen:<name>``: the same string in both packages."""
        return f"gen:{self.name}"

    def digest(self) -> str:
        """The bare name."""
        return self.name


def words_to_device(words: np.ndarray, device=None) -> torch.Tensor:
    """uint32 words from the host as the port's int64 words on
    ``device``: copied as 4 bytes a word (an int32 view) and widened on
    the device, where ``& 0xFFFFFFFF`` undoes the sign extension of
    words at or above 2^31."""
    dev = resolve_device(device)
    raw = torch.from_numpy(np.array(words, np.uint32).view(np.int32))
    return raw.to(dev, non_blocking=True).to(torch.int64) & MASK32


class CapturedSource(BitSource):
    """External bits from a memory-mapped file, sharded by stream.

    Formats: ``.npy`` (uint32; 1-D is one stream, 2-D is (streams,
    words per stream)) or raw little-endian u32 (``fmt="u32"``, one
    stream). The file is mapped, never loaded. ``seed`` is accepted and
    ignored; ``counter_based`` is True (an offset is a read position), so
    captured cells take campaign sub-stream offsets. A read past the
    captured words raises ``CapturedBitsError`` naming the shard.

    ``digest()`` is the sha256 of the file's bytes, cached per (size,
    mtime_ns), and ``uid()`` is ``cap:<stem>:<digest16>``: a checkpoint
    or ledger written against one capture refuses a re-captured or
    byte-modified file."""

    counter_based = True
    captured = True

    def __init__(self, path: str, fmt: Optional[str] = None):
        self.path = os.path.abspath(path)
        if fmt is None:
            fmt = "npy" if self.path.endswith(".npy") else "u32"
        if fmt not in ("npy", "u32"):
            raise ValueError(f"unknown captured format {fmt!r}; "
                             f"known: ('npy', 'u32')")
        self.fmt = fmt
        if fmt == "npy":
            arr = np.load(self.path, mmap_mode="r")
        else:
            arr = np.memmap(self.path, dtype="<u4", mode="r")
        if arr.dtype != np.uint32:
            raise ValueError(
                f"captured file {path} holds {arr.dtype}, expected "
                f"uint32 words")
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        if arr.ndim != 2:
            raise ValueError(
                f"captured file {path} has shape {arr.shape}; expected "
                f"1-D words or 2-D (streams, words)")
        self._arr = arr
        self.n_streams, self.stride = map(int, arr.shape)
        self.name = f"cap:{os.path.splitext(os.path.basename(path))[0]}"
        self._digest: Optional[str] = None
        self._digest_tag = None

    def __eq__(self, other):
        return (isinstance(other, CapturedSource)
                and (self.path, self.fmt) == (other.path, other.fmt))

    def __hash__(self):
        return hash((self.path, self.fmt))

    def __repr__(self):
        return (f"CapturedSource({self.path!r}, fmt={self.fmt!r}, "
                f"streams={self.n_streams}, stride={self.stride})")

    def words(self, stream, n, offset=None) -> np.ndarray:
        """Words ``[offset, offset + n)`` of shard ``stream``: a view of
        the mapped file (uint32, on the host)."""
        s, off, n = int(stream), int(offset or 0), int(n)
        if not 0 <= s < self.n_streams:
            raise CapturedBitsError(
                f"{self.name}: stream {s} out of range — the capture "
                f"holds {self.n_streams} stream shard(s)")
        if off < 0 or off + n > self.stride:
            raise CapturedBitsError(
                f"{self.name}: stream {s} read [{off}, {off + n}) "
                f"exceeds the captured {self.stride} word(s) per "
                f"stream — capture more bits or shrink the battery")
        return self._arr[s, off:off + n]

    def block(self, seed, stream, n, offset=None, *, device=None):
        """The words of ``words()`` as int64 on ``device``."""
        del seed                        # captured bits have no seed
        return words_to_device(self.words(stream, n, offset), device)

    def uid(self) -> str:
        """``cap:<stem>:<digest16>``."""
        return f"{self.name}:{self.digest()[:16]}"

    def digest(self) -> str:
        """sha256 of the raw file bytes (cached per (size, mtime))."""
        stat = os.stat(self.path)
        tag = (stat.st_size, stat.st_mtime_ns)
        if self._digest is None or self._digest_tag != tag:
            h = hashlib.sha256()
            with open(self.path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            self._digest = h.hexdigest()
            self._digest_tag = tag
        return self._digest


def resolve_source(spec: Union[BitSource, str]) -> BitSource:
    """One source from its spelling: a ``BitSource`` passes through;
    ``"name"`` is a ``GeneratorSource``; ``"file:path[:fmt]"`` a
    ``CapturedSource`` (the CLI's ``--source`` grammar; a suffix that is
    not a known format is part of the path)."""
    if isinstance(spec, BitSource):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"source spec must be a BitSource or str, "
                        f"got {type(spec).__name__}")
    if spec.startswith("file:"):
        rest = spec[len("file:"):]
        path, sep, fmt = rest.rpartition(":")
        if not sep or os.sep in fmt or fmt not in ("npy", "u32"):
            path, fmt = rest, None
        return CapturedSource(path, fmt)
    return GeneratorSource(spec)


# ---------------------------------------------------------------------------
# capture helper

def _u32_host(words: torch.Tensor) -> np.ndarray:
    """int64 words in ``[0, 2^32)`` as host uint32, copied 4 bytes a
    word (narrowed to int32 on their device first)."""
    narrow = words - ((words >> 31) & 1) * (1 << 32)
    return narrow.to(torch.int32).cpu().numpy().view(np.uint32)


def capture_generator(name: str, path: str, seed: int, n_streams: int,
                      stride: int, fmt: str = "npy", *,
                      device=None) -> str:
    """Write a registered generator's words as a captured file: shard s
    holds words ``[0, stride)`` of the (seed, s) sequence, computed on
    ``device`` (default ``cuda``) by the port's own block function. A
    battery over the capture is bitwise the battery over the generator.
    The file's bytes are the reference's for the same arguments.
    Returns ``path``."""
    row = get_generator(name)
    if n_streams < 1 or stride < 1:
        raise ValueError(f"need n_streams >= 1 and stride >= 1, got "
                         f"{n_streams}, {stride}")
    if fmt not in ("npy", "u32"):
        raise ValueError(f"unknown capture format {fmt!r}")
    if fmt == "u32" and n_streams != 1:
        raise ValueError("raw u32 captures are single-stream; use "
                         "fmt='npy' for sharded captures")
    dev = resolve_device(device)
    words = np.empty((n_streams, stride), np.uint32)
    for s in range(n_streams):
        words[s] = _u32_host(row.block_fn(seed, s, stride, device=dev))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if fmt == "npy":
        np.save(path, words)
    else:
        words.astype("<u4").tofile(path)
    return path
