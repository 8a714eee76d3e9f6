"""Analysis driver: rules -> suppressions -> baseline -> report
(``repro/analysis/driver.py``).

``run_analysis`` is the one entry point both the CLI and the test suite
call, so fixture projects and the real tree flow through identical
logic: run the registered rules, drop per-line ``noqa`` suppressions,
split what remains against the baseline, and wrap it all in an
``AnalysisResult`` whose ``to_json()`` is the ``--json`` wire shape
(golden-keyed by tests/test_torch_analysis_cli.py, as the
reference's by tests/test_analysis_cli.py).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

from repro_torch.analysis.model import (Baseline, Finding, counts_by_code,
                                  split_suppressed)
from repro_torch.analysis.project import Project
from repro_torch.analysis.registry import rules, run_rules

JSON_VERSION = 1


@dataclasses.dataclass
class AnalysisResult:
    """Everything one analyzer pass produced, pre-partitioned."""
    findings: List[Finding]          # new, actionable
    baselined: List[Finding]         # grandfathered by the baseline
    suppressed: List[Finding]        # per-line noqa'd
    stale_baseline: List[dict]       # baseline entries that no longer fire
    files_scanned: int
    syntax_errors: List[Finding]     # RPA000 — unparseable files

    def clean(self, strict: bool = False) -> bool:
        """No actionable findings (strict also rejects stale baseline
        entries — the baseline may only shrink)."""
        if self.findings or self.syntax_errors:
            return False
        return not (strict and self.stale_baseline)

    def exit_code(self, strict: bool = False) -> int:
        return 0 if self.clean(strict) else 1

    def to_json(self, strict: bool = False) -> dict:
        """The ``--json`` report shape. Keys are append-only."""
        return {
            "version": JSON_VERSION,
            "strict": strict,
            "clean": self.clean(strict),
            "files_scanned": self.files_scanned,
            "rules": [{"code": r.code, "name": r.name,
                       "summary": r.summary} for r in rules()],
            "findings": [f.to_json() for f in
                         self.syntax_errors + self.findings],
            "baselined": [f.to_json() for f in self.baselined],
            "suppressed": [f.to_json() for f in self.suppressed],
            "stale_baseline": list(self.stale_baseline),
            "counts": {
                "findings": len(self.findings) + len(self.syntax_errors),
                "baselined": len(self.baselined),
                "suppressed": len(self.suppressed),
                "stale_baseline": len(self.stale_baseline),
                "by_code": counts_by_code(
                    self.syntax_errors + self.findings),
            },
        }


def _syntax_errors(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for path in project.paths():
        if project.tree(path) is None:
            out.append(Finding("RPA000", "syntax-error", path, 1, 1,
                               "file does not parse"))
    return out


def run_analysis(project: Project,
                 baseline: Optional[Baseline] = None,
                 codes: Iterable[str] = ()) -> AnalysisResult:
    """Run the selected rules (default: all) over ``project`` and
    partition the findings against ``baseline`` (default: empty)."""
    baseline = baseline or Baseline()
    raw = run_rules(project, codes)
    kept, suppressed = split_suppressed(raw, project.lines)
    new, baselined, stale = baseline.split(kept)
    return AnalysisResult(
        findings=new,
        baselined=baselined,
        suppressed=suppressed,
        stale_baseline=stale,
        files_scanned=len(project.paths()),
        syntax_errors=_syntax_errors(project),
    )
