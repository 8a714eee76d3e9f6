"""``python -m repro_torch.analysis`` — the static-analysis CLI / gate
(``repro/analysis/cli.py``: the same flags, exit codes and reports).

Exit codes: 0 clean, 1 findings (or, under ``--strict``, stale baseline
entries), 2 usage/internal error. The human report goes to stdout; the
machine report goes wherever ``--json`` points (``-`` for stdout).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.analysis.driver import run_analysis
from repro_torch.analysis.model import Baseline
from repro_torch.analysis.project import DEFAULT_SUBTREE, Project
from repro_torch.analysis.registry import rules

# the port's own baseline; the reference's file is never read or written
BASELINE_NAME = ".repro-torch-analysis-baseline.json"


def _find_root(start: str) -> Optional[str]:
    """Walk up from ``start`` to the first directory holding the
    analyzed subtree (``src/repro_torch``)."""
    cur = os.path.abspath(start)
    while True:
        if os.path.isdir(os.path.join(cur, DEFAULT_SUBTREE)):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Repo-aware static analysis for the PyTorch port of "
                    "the battery system (DESIGN.md §9).")
    p.add_argument("--root", default=None,
                   help="repo root (default: walk up from cwd to the "
                        "first directory containing src/repro_torch)")
    p.add_argument("--strict", action="store_true",
                   help="CI gate mode: also fail on stale baseline "
                        "entries")
    p.add_argument("--json", dest="json_path", default=None,
                   metavar="PATH",
                   help="write the JSON report to PATH ('-' = stdout)")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help=f"baseline file (default: <root>/{BASELINE_NAME})")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite the baseline to grandfather the "
                        "current findings, then exit 0")
    p.add_argument("--rules", default=None, metavar="CODES",
                   help="comma-separated rule codes to run "
                        "(default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for r in rules():
            print(f"{r.code}  {r.name:28s} {r.summary}")
        return 0

    root = args.root or _find_root(os.getcwd())
    if root is None or not os.path.isdir(
            os.path.join(root, DEFAULT_SUBTREE)):
        print(f"error: no {DEFAULT_SUBTREE}/ under "
              f"{args.root or os.getcwd()!r} (pass --root)",
              file=sys.stderr)
        return 2

    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)
    baseline = Baseline.load(baseline_path)
    project = Project.from_tree(root)
    codes = [c.strip() for c in args.rules.split(",")] if args.rules \
        else []
    result = run_analysis(project, baseline, codes)

    if args.write_baseline:
        new_baseline = Baseline(
            {f.key() for f in result.findings + result.baselined},
            baseline_path)
        new_baseline.save()
        print(f"wrote {len(new_baseline.entries)} entr"
              f"{'y' if len(new_baseline.entries) == 1 else 'ies'} "
              f"to {baseline_path}")
        return 0

    for f in result.syntax_errors + result.findings:
        print(f)
    for entry in result.stale_baseline:
        print(f"{entry['path']}: stale baseline entry "
              f"{entry['code']}: {entry['message']}")

    n = len(result.findings) + len(result.syntax_errors)
    print(f"{result.files_scanned} files scanned: {n} finding(s), "
          f"{len(result.suppressed)} suppressed, "
          f"{len(result.baselined)} baselined, "
          f"{len(result.stale_baseline)} stale baseline entr"
          f"{'y' if len(result.stale_baseline) == 1 else 'ies'}")

    if args.json_path:
        report = json.dumps(result.to_json(args.strict), indent=2,
                            sort_keys=True)
        if args.json_path == "-":
            print(report)
        else:
            os.makedirs(os.path.dirname(args.json_path) or ".",
                        exist_ok=True)
            with open(args.json_path, "w") as f:
                f.write(report + "\n")

    return result.exit_code(args.strict)


if __name__ == "__main__":
    sys.exit(main())
