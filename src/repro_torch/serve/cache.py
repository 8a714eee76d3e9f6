"""Content-addressed result cache of the screening service
(``repro/serve/cache.py``, DESIGN.md §10).

A CELL is one source at one (seed, stream offset), screened by one
(battery, scale) under one (alpha, backend). ``cell_digest`` names a
cell by the sha256 of exactly that tuple, built as the reference builds
it, so both packages give one cell the same address and share a cache
directory: a repeat submission resolves to the stored verdict without a
dispatch.

``CacheEntry`` is one file per digest in the reference's v2 layout,
written through ``ckpt/io.py`` (the same bytes as the reference's
msgpack; either package loads the other's entries, and v1 entries load
as Bonferroni). An entry records whether its results are COMPLETE: a
partial entry (an adaptive run cancelled at its verdict) serves only
stop-on-verdict resubmissions with a decided verdict, never a classic
one that expects the full report.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, Optional

import numpy as np

from repro_torch.ckpt import io as ckpt_io
from repro_torch.core import stitch

CACHE_VERSION = 2

# decision codes on the wire: the checkpoint's verdict codes
_DECISION_CODE = {stitch.UNDECIDED: 0, stitch.PASS: 1, stitch.FAIL: 2}
_CODE_DECISION = {v: k for k, v in _DECISION_CODE.items()}


def cell_digest(battery: str, scale: float, generator: str, seed: int,
                offset: int, alpha: float, backend: str,
                source_digest: str = "",
                engine: str = "bonferroni") -> str:
    """The cell's address: a 32-hex-character sha256 prefix of the
    ``repr`` of (battery, scale, generator, seed, offset, alpha,
    backend). ``backend`` is the RESOLVED backend
    (``stats.backends.resolve`` on the pool's device), so ``auto`` and
    the backend it resolves to share cells. ``source_digest`` (a
    captured file's content digest, ``BitSource.digest()``) and a
    verdict ``engine`` other than ``bonferroni`` are folded in only when
    given, as the reference folds them, so generator cells under the
    default engine keep the reference's digests."""
    key = repr((str(battery), float(scale), str(generator), int(seed),
                int(offset), float(alpha), str(backend)))
    if source_digest:
        key = repr((key, str(source_digest)))
    if engine != "bonferroni":
        key = repr((key, "engine", str(engine)))
    return hashlib.sha256(key.encode()).hexdigest()[:32]


@dataclasses.dataclass
class CacheEntry:
    """One cell's stored outcome: its combined test-space results (test
    index -> (stat, p)), the decision they give under ``engine`` at
    ``alpha``, the battery size and whether every test has a result.
    Decisions are a pure function of (results, alpha, engine).

    Wire layout (``ckpt/io`` leaves, v2)::

      [version, idx (K,) int32, stats (K,) float64, ps (K,) float64,
       decision int8, alpha float64, n_total int64, complete int8,
       engine bytes]

    v1 files (8 leaves, no engine) load as ``engine="bonferroni"``.
    """
    results: Dict[int, tuple]
    decision: str
    alpha: float
    n_total: int
    complete: bool
    engine: str = "bonferroni"
    version: int = CACHE_VERSION

    @classmethod
    def from_results(cls, results: Dict[int, tuple], n_total: int,
                     alpha: float,
                     engine: str = "bonferroni") -> "CacheEntry":
        """An entry for a finished (or decided) cell; the decision and
        completeness are computed from the results."""
        verdict = stitch.verdict_for(engine)(results, n_total, alpha)
        complete = not stitch.missing(results, n_total)
        return cls(dict(results), verdict.decision, float(alpha),
                   int(n_total), complete, str(engine))

    def verdict(self):
        """The verdict recomputed from the stored results under the
        entry's engine (the one the original run reported)."""
        return stitch.verdict_for(self.engine)(self.results, self.n_total,
                                               self.alpha)

    def serves(self, stop_on_verdict: bool) -> bool:
        """Whether the entry can answer a resubmission: a complete entry
        serves everyone, a partial one only a ``stop_on_verdict`` client
        and only once its decision is PASS or FAIL."""
        if self.complete:
            return True
        return bool(stop_on_verdict
                    and self.decision != stitch.UNDECIDED)

    @classmethod
    def load(cls, path: str) -> "CacheEntry":
        """Read and version-check one entry file: v2 (9 leaves) or v1
        (8 leaves, Bonferroni only)."""
        leaves = ckpt_io.load_flat(path)
        if len(leaves) == 9:
            ver, idx, st, pv, dec, alpha, n_total, complete, eng = leaves
            if int(ver) != CACHE_VERSION:
                raise ValueError(
                    f"cache entry {path} declares version {int(ver)}; "
                    f"this build reads v{CACHE_VERSION}")
            engine = (bytes(eng.reshape(-1)[0]).decode()
                      if eng.size else "bonferroni")
            version = CACHE_VERSION
        elif len(leaves) == 8:
            ver, idx, st, pv, dec, alpha, n_total, complete = leaves
            if int(ver) != 1:
                raise ValueError(
                    f"cache entry {path} declares version {int(ver)} "
                    "in an 8-leaf (v1) layout")
            engine = "bonferroni"
            version = 1
        else:
            raise ValueError(f"cache entry {path} has {len(leaves)} "
                             "leaves; expected 8 (v1) or 9 (v2)")
        results = {int(i): (float(s), float(p))
                   for i, s, p in zip(np.asarray(idx, np.int32),
                                      np.asarray(st, np.float64),
                                      np.asarray(pv, np.float64))}
        return cls(results, _CODE_DECISION[int(dec)], float(alpha),
                   int(n_total), bool(int(complete)), engine, version)

    def save(self, path: str) -> None:
        """Write the 9-leaf v2 layout, atomically (``ckpt_io.save``)."""
        idx = np.asarray(sorted(self.results), np.int32)
        ckpt_io.save(path, [
            np.int64(CACHE_VERSION), idx,
            np.asarray([self.results[int(i)][0] for i in idx], np.float64),
            np.asarray([self.results[int(i)][1] for i in idx], np.float64),
            np.int8(_DECISION_CODE[self.decision]),
            np.float64(self.alpha), np.int64(self.n_total),
            np.int8(1 if self.complete else 0),
            np.asarray([self.engine.encode()])])


class ResultCache:
    """Digest-keyed store of ``CacheEntry``s, in memory and, with a
    ``root`` directory, on disk as ``<root>/<digest>.ck``: a ``put``
    writes the file and a ``get`` missing in memory reads it, so a
    restarted daemon, or another daemon of either package on the same
    directory, serves the history. ``hits``/``misses`` count lookups (a
    read from disk is a hit)."""

    def __init__(self, root: Optional[str] = None):
        self.root = root
        if root:
            os.makedirs(root, exist_ok=True)
        self._mem: Dict[str, CacheEntry] = {}
        self.hits = 0
        self.misses = 0

    def _path(self, digest: str) -> Optional[str]:
        return os.path.join(self.root, f"{digest}.ck") if self.root else None

    def _lookup(self, digest: str) -> Optional[CacheEntry]:
        entry = self._mem.get(digest)
        if entry is None:
            path = self._path(digest)
            if path and os.path.exists(path):
                entry = CacheEntry.load(path)
        return entry

    def get(self, digest: str,
            stop_on_verdict: bool = False) -> Optional[CacheEntry]:
        """The entry for ``digest`` when there is one that serves this
        client (``CacheEntry.serves``); otherwise ``None``, a miss."""
        entry = self._lookup(digest)
        if entry is not None:
            self._mem[digest] = entry
            if entry.serves(stop_on_verdict):
                self.hits += 1
                return entry
        self.misses += 1
        return None

    def put(self, digest: str, entry: CacheEntry) -> None:
        """Store (and persist) one cell's outcome. A complete entry is
        never replaced by a partial one: an adaptive resubmission of a
        fully screened cell must not erase its full report."""
        old = self._lookup(digest)
        if old is not None and old.complete and not entry.complete:
            return
        self._mem[digest] = entry
        path = self._path(digest)
        if path:
            entry.save(path)

    def __len__(self) -> int:
        """Entries held in memory."""
        return len(self._mem)
