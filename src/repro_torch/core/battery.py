"""Battery definitions: SmallCrush (10), Crush (96), BigCrush (106), and
the pairstream seam battery (``repro/core/battery.py``).

A battery is an ordered list of entries, each a fixed parameterization
of one test family; ``scale`` sizes the same battery from CI to paper
size. ``build_battery`` returns job tables equal to the reference's in
name, ``n_words``, params, cost, group and part.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, List, Sequence

from repro_torch.stats import backends as B

# relative per-word cost weights (scan-heavy kernels cost more per word)
KERNEL_WEIGHT = {
    "birthday": 1.0, "collision": 1.0, "gap": 1.2, "poker": 1.0,
    "coupon": 6.0, "maxoft": 1.0, "weight": 0.6, "rank": 8.0,
    "hamcorr": 0.6, "serial2d": 0.8, "pairstream": 0.6,
}

# Historical discriminating power per family, seeded from the known-bad
# generators; the adaptive policy ranks jobs by DISCRIMINATION / cost.
DISCRIMINATION = {
    "weight": 1.0, "rank": 1.0, "hamcorr": 0.8,
    "birthday": 0.3, "serial2d": 0.3, "collision": 0.2,
    "gap": 0.15, "maxoft": 0.15, "poker": 0.1, "coupon": 0.05,
    "pairstream": 1.0,
}


def discrimination(entry: "TestEntry") -> float:
    """Discriminating power of an entry (0 for an unknown family)."""
    return DISCRIMINATION.get(entry.kname, 0.0)


@dataclasses.dataclass(frozen=True)
class TestEntry:
    """One job of the pool's table: a bound test kernel and its sizing."""
    index: int                  # position in the pool's job table
    name: str
    kernel: Callable            # bits -> (stat, p)
    n_words: int                # uint32 words consumed
    cost: float                 # scheduler cost estimate
    kname: str = ""             # kernel family
    params: tuple = ()          # sorted (key, value) kernel kwargs
    group: int = -1             # original battery test index
    part: int = 0               # sub-job position within its group
    n_parts: int = 1            # group size (1 = not decomposed)
    backend: str = "reference"  # backend the kernel is bound to

    def __post_init__(self):
        if self.group < 0:
            object.__setattr__(self, "group", self.index)


_WORDS = {
    "birthday": lambda k: k.get("n", 4096),
    "collision": lambda k: k.get("n", 65536),
    "gap": lambda k: k.get("n", 65536),
    "poker": lambda k: k.get("n", 32768) * 5,
    "coupon": lambda k: k.get("n", 65536),
    "maxoft": lambda k: k.get("n", 16384) * k.get("t", 8),
    "weight": lambda k: k.get("n", 65536),
    "rank": lambda k: k.get("n_mats", 1024) * 32,
    "hamcorr": lambda k: k.get("n", 65536),
    "serial2d": lambda k: k.get("n", 65536) * 2,
    "pairstream": lambda k: k.get("n", 32768) * 2,
}


def _mk(index, kname, scale, backend="reference", **kw):
    fn = B.get_kernel(kname, backend)
    words = _WORDS[kname](kw)
    name = kname + ("" if not kw else "_" + "_".join(
        f"{a}{v}" for a, v in sorted(kw.items())))
    return TestEntry(index, name, functools.partial(fn, **kw), words,
                     words * KERNEL_WEIGHT[kname] * scale,
                     kname=kname, params=tuple(sorted(kw.items())),
                     backend=backend)


_BASE = [
    ("birthday", dict(n=4096, tbits=30)), ("collision", dict(n=65536, kbits=26)),
    ("gap", dict(n=65536, beta=0.125)), ("poker", dict(n=32768)),
    ("coupon", dict(n=65536, d=8)), ("maxoft", dict(n=16384, t=8)),
    ("weight", dict(n=65536)), ("rank", dict(n_mats=1024)),
    ("hamcorr", dict(n=65536)), ("serial2d", dict(n=65536, d=64)),
]

_VARIANTS = {
    "birthday": [dict(n=1024, tbits=26), dict(n=2048, tbits=28),
                 dict(n=2048, tbits=30), dict(n=4096, tbits=30),
                 dict(n=8192, tbits=30), dict(n=4096, tbits=28),
                 dict(n=1024, tbits=24), dict(n=2048, tbits=26),
                 dict(n=2048, tbits=24)],
    "collision": [dict(n=n, kbits=k) for n in (32768, 65536, 131072)
                  for k in (24, 26, 28)],
    "gap": [dict(n=n, beta=b) for n in (32768, 65536, 131072)
            for b in (0.0625, 0.125, 0.25)],
    "poker": [dict(n=n) for n in (16384, 32768, 65536, 131072)],
    "coupon": [dict(n=n, d=d) for n in (32768, 65536) for d in (4, 8, 16)],
    "maxoft": [dict(n=n, t=t) for n in (8192, 16384, 32768)
               for t in (4, 8, 16)],
    "weight": [dict(n=n) for n in (32768, 65536, 131072, 262144)],
    "rank": [dict(n_mats=m) for m in (512, 1024, 2048, 4096)],
    "hamcorr": [dict(n=n) for n in (32768, 65536, 131072, 262144)],
    "serial2d": [dict(n=n, d=d) for n in (32768, 65536, 131072)
                 for d in (16, 64, 128)],
}


def _scaled(kw, kname, scale):
    """The reference's lambda-invariant rescaling, with its parameter
    floors (n >= 256; birthday n >= 128 with tbits in [16, 30];
    collision kbits in [14, 30])."""
    kw = dict(kw)
    orig_n = kw.get("n", 0)
    for key in ("n", "n_mats"):
        if key in kw:
            kw[key] = max(int(kw[key] * scale), 256)
    if kname == "birthday" and "n" in kw:
        lam0 = orig_n ** 3 / (4.0 * (1 << kw.get("tbits", 30)))
        tb = kw.get("tbits", 30) + round(3 * math.log2(max(scale, 1e-9)))
        kw["tbits"] = min(max(tb, 16), 30)
        n = int(round((lam0 * 4 * (1 << kw["tbits"])) ** (1 / 3)))
        n = min(n, int(math.sqrt(1 << kw["tbits"]) / 2))
        kw["n"] = max(n, 128)
    if kname == "collision" and "n" in kw:
        kb = kw.get("kbits", 26) + round(2 * math.log2(max(scale, 1e-9)))
        kw["kbits"] = min(max(kb, 14), 30)
    return kw


_PAIRSTREAM = [
    ("pairstream", dict(n=32768, mode="corr")),
    ("pairstream", dict(n=32768, mode="hamcorr")),
    ("pairstream", dict(n=32768, mode="match")),
    ("pairstream", dict(n=32768, mode="shift")),
]


def build_battery(name: str, scale: float = 1.0,
                  backend: str = "reference",
                  device="cuda") -> List[TestEntry]:
    """Battery job table; ``backend`` is resolved here (``auto`` by
    ``device``), so the table records a concrete backend."""
    backend = B.resolve(backend, device)
    if name == "smallcrush":
        combos = [(k, _scaled(kw, k, scale)) for k, kw in _BASE]
    elif name == "pairstream":
        combos = [(k, _scaled(kw, k, scale)) for k, kw in _PAIRSTREAM]
    elif name in ("crush", "bigcrush"):
        target = 96 if name == "crush" else 106
        combos = []
        pools = {k: list(v) for k, v in _VARIANTS.items()}
        order = list(_VARIANTS)
        i = 0
        while len(combos) < target:
            k = order[i % len(order)]
            if pools[k]:
                combos.append((k, _scaled(pools[k].pop(0), k, scale)))
            i += 1
            if i > 10 * target:                  # pools exhausted -> rescale
                for k2 in order:
                    pools[k2] = [dict(kw, n=int(kw.get("n", 65536) * 2))
                                 if "n" in kw else kw
                                 for kw in _VARIANTS[k2]]
        combos = combos[:target]
    else:
        raise KeyError(name)
    return [_mk(i, k, scale, backend=backend, **kw)
            for i, (k, kw) in enumerate(combos)]


def max_words(entries: List[TestEntry]) -> int:
    """Widest block any entry consumes; 0 for an empty table."""
    return max((e.n_words for e in entries), default=0)


def split_entry(entry: TestEntry, n_parts: int,
                start_index: int = 0) -> List[TestEntry]:
    """Over-decomposition: split one test into ``n_parts`` sub-jobs, each
    re-parameterized lambda-invariantly at 1/n_parts of the sample size
    on its own sub-stream. Returned unsplit when the parameter floors
    keep a sub-job from being smaller than the entry."""
    if n_parts <= 1 or not entry.kname:
        return [dataclasses.replace(entry, index=start_index)]
    sub_kw = _scaled(dict(entry.params), entry.kname, 1.0 / n_parts)
    sub_words = _WORDS[entry.kname](sub_kw)
    if sub_words >= entry.n_words:                  # floors won: no shrink
        return [dataclasses.replace(entry, index=start_index)]
    fn = B.get_kernel(entry.kname, entry.backend or "reference")
    sub_cost = entry.cost * (sub_words / max(entry.n_words, 1))
    return [
        TestEntry(start_index + p,
                  f"{entry.name}[{p + 1}/{n_parts}]",
                  functools.partial(fn, **sub_kw), sub_words, sub_cost,
                  kname=entry.kname, params=tuple(sorted(sub_kw.items())),
                  group=entry.group, part=p, n_parts=n_parts,
                  backend=entry.backend)
        for p in range(n_parts)
    ]


def entries_from_reference(rows: Sequence,
                           backend: str = "reference") -> List[TestEntry]:
    """Rebuild the port's job table from the reference's, given as rows
    ``(index, name, kname, params, n_words, cost, group, part, n_parts)``
    of plain Python values or numpy scalars; ``params`` is a sequence of
    ``(key, value)`` pairs. Each entry's kernel is the port's
    ``backend`` implementation of ``kname`` bound to ``params``."""
    backend = B.resolve(backend)
    out = []
    for (index, name, kname, params, n_words, cost, group, part,
         n_parts) in rows:
        kw = {str(k): (v.item() if hasattr(v, "item") else v)
              for k, v in params}
        fn = B.get_kernel(str(kname), backend)
        out.append(TestEntry(int(index), str(name),
                             functools.partial(fn, **kw), int(n_words),
                             float(cost), kname=str(kname),
                             params=tuple(sorted(kw.items())),
                             group=int(group), part=int(part),
                             n_parts=int(n_parts), backend=backend))
    return out
