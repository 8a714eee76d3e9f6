"""The generator registry half of ``repro/rng/sources.py``.

``register_generator`` appends a block function under the next stable
``gen_id``; built-ins register in the reference's order
(``repro/rng/generators.py:355-363``), so a gen id means the same
generator in both packages. ``switch_block`` is the registry-backed
dispatch the pool's job function calls. Captured bitstreams
(``CapturedSource``) are not ported yet.

Offset convention: ``offset=None`` means "no offset"; an integer reads
words ``[offset, offset + n)``. Sources that cannot seek raise
``OffsetNotSupportedError`` from the single ``require_offsetable`` gate.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict


class OffsetNotSupportedError(ValueError):
    """A non-zero stream offset was asked of a source that cannot seek
    (``counter_based=False``: ``mwc``, as the reference declares it)."""


def require_offsetable(source, offset, where: str = "stream offset") -> None:
    """Raise ``OffsetNotSupportedError`` when ``offset`` is non-zero and
    ``source`` is not counter-based. ``None`` and 0 always pass."""
    if offset is None or not int(offset):
        return
    if not source.counter_based:
        raise OffsetNotSupportedError(
            f"source {source.name!r} is not offset-continuable "
            f"(counter_based=False); it cannot take a non-zero {where}")


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
                         f"(gen_id={_REGISTRY[name].gen_id})")
    row = RegisteredGenerator(name, len(_REGISTRY), block_fn,
                              bool(counter_based))
    _REGISTRY[name] = row
    return row


def registry_size() -> int:
    """Number of registered generators."""
    _ensure_builtins()
    return len(_REGISTRY)


def get_generator(name: str) -> RegisteredGenerator:
    """The registry row for ``name`` (KeyError naming the known set)."""
    _ensure_builtins()
    row = _REGISTRY.get(name)
    if row is None:
        raise KeyError(f"unknown generator {name!r}; "
                       f"known: {sorted(_REGISTRY)}")
    return row


def switch_block(gen_id: int, seed: int, stream: int, n: int,
                 offset=None, *, device=None):
    """``n`` words from registered lane ``gen_id`` (the reference's
    ``lax.switch`` over the registry, as a host-side index)."""
    _ensure_builtins()
    row = list(_REGISTRY.values())[gen_id]
    if offset is None:
        return row.block_fn(seed, stream, n, device=device)
    require_offsetable(GeneratorSource(row.name), offset)
    return row.block_fn(seed, stream, n, offset, device=device)


@dataclasses.dataclass(frozen=True)
class GeneratorSource:
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

    def block(self, seed, stream, n, offset=None, *, device=None):
        """``n`` words of the (seed, stream) sequence from ``offset``."""
        return switch_block(self.gen_id, seed, stream, n, offset,
                            device=device)

    def uid(self) -> str:
        """``gen:<name>``: the identity checkpoints pin per position
        (``repro/rng/sources.py``), the same string in both packages."""
        return f"gen:{self.name}"

    def digest(self) -> str:
        """The bare name: the content identity cache keys use."""
        return self.name
