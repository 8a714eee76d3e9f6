"""Findings model: stable codes, JSON shape, suppressions, baseline
(``repro/analysis/model.py``, unchanged in shape and grammar).

A ``Finding`` is one rule violation anchored to (path, line, col). Its
identity for baselining is ``(code, path, message)`` — deliberately
line-free, so unrelated edits above a grandfathered finding don't churn
the baseline file (same discipline as the job-id-keyed checkpoints:
identity never depends on position).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

# one inline-comment grammar for every control the analyzer understands
NOQA_RE = re.compile(r"#\s*repro:\s*noqa\s+((?:RPA\d{3}[,\s]*)+)")
QUARANTINE_RE = re.compile(r"#\s*repro:\s*quarantine\b")
VMEM_BOUND_RE = re.compile(r"#\s*repro:\s*vmem-bound\s+([\w.]+)")
RUNTIME_ARG_RE = re.compile(r"#\s*repro:\s*runtime-arg\b")
FAULT_BOUNDARY_RE = re.compile(r"#\s*repro:\s*fault-boundary\b")

# a quarantine marker must sit near the top of the module — it describes
# the whole file, not one line
QUARANTINE_HEAD_LINES = 15


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation: stable ``code`` (RPAxxx), the registered rule
    name, the repo-relative ``path`` and 1-based ``line``/``col`` anchor,
    and a human message. Sorts by (path, line, code) for stable output."""
    code: str
    rule: str
    path: str
    line: int
    col: int
    message: str

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: line-free, so edits don't churn it."""
        return (self.code, self.path, self.message)

    def to_json(self) -> dict:
        """The ``--json`` wire shape (tests/test_torch_analysis_cli.py
        pins it)."""
        return {"code": self.code, "rule": self.rule, "path": self.path,
                "line": self.line, "col": self.col, "message": self.message}

    def sort_key(self) -> tuple:
        """Stable report order."""
        return (self.path, self.line, self.col, self.code, self.message)

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.code} [{self.rule}] {self.message}")


def noqa_codes(source_line: str) -> Set[str]:
    """Codes suppressed by a ``# repro: noqa RPA101, RPA102`` comment."""
    m = NOQA_RE.search(source_line)
    if not m:
        return set()
    return set(re.findall(r"RPA\d{3}", m.group(1)))


def is_quarantined(source: str) -> bool:
    """True when the module's head carries a ``# repro: quarantine``
    comment LINE (a docstring merely mentioning the marker — e.g. the
    analyzer's own docs — does not quarantine the module)."""
    head = source.splitlines()[:QUARANTINE_HEAD_LINES]
    return any(line.lstrip().startswith("#")
               and QUARANTINE_RE.search(line) for line in head)


def split_suppressed(findings: Iterable[Finding],
                     lines_of) -> Tuple[List[Finding], List[Finding]]:
    """Partition findings into (kept, suppressed) by per-line noqa.
    ``lines_of(path)`` returns the file's source lines."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        lines = lines_of(f.path)
        line = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        (suppressed if f.code in noqa_codes(line) else kept).append(f)
    return kept, suppressed


class Baseline:
    """Grandfathered findings (``.repro-torch-analysis-baseline.json``).

    The file is a sorted list of ``{code, path, message}`` entries. Policy
    (DESIGN.md §9): the baseline exists so the gate can be adopted on a
    tree with known findings — it ships EMPTY and should stay empty; new
    findings are fixed or ``noqa``-suppressed with a justification, not
    baselined. ``--strict`` additionally fails on STALE entries (baselined
    findings that no longer occur), so the file can only shrink."""

    def __init__(self, entries: Optional[Set[Tuple[str, str, str]]] = None,
                 path: Optional[str] = None):
        self.entries = entries or set()
        self.path = path

    @classmethod
    def load(cls, path: str) -> "Baseline":
        """Read the baseline file (a missing file is an empty baseline)."""
        if not os.path.exists(path):
            return cls(set(), path)
        with open(path) as f:
            data = json.load(f)
        entries = {(e["code"], e["path"], e["message"])
                   for e in data.get("findings", [])}
        return cls(entries, path)

    def save(self, path: Optional[str] = None) -> None:
        """Write the sorted baseline (``--write-baseline``)."""
        path = path or self.path
        data = {"version": 1,
                "findings": [{"code": c, "path": p, "message": m}
                             for c, p, m in sorted(self.entries)]}
        with open(path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")

    def split(self, findings: Iterable[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[dict]]:
        """(new, baselined, stale): findings not in the baseline, findings
        it grandfathers, and entries it holds that no longer occur."""
        new: List[Finding] = []
        baselined: List[Finding] = []
        seen: Set[Tuple[str, str, str]] = set()
        for f in findings:
            if f.key() in self.entries:
                baselined.append(f)
                seen.add(f.key())
            else:
                new.append(f)
        stale = [{"code": c, "path": p, "message": m}
                 for c, p, m in sorted(self.entries - seen)]
        return new, baselined, stale


def counts_by_code(findings: Iterable[Finding]) -> Dict[str, int]:
    """``{code: n}`` histogram for the JSON report."""
    out: Dict[str, int] = {}
    for f in findings:
        out[f.code] = out.get(f.code, 0) + 1
    return dict(sorted(out.items()))
