"""Rule registry — the ``stats.backends.register`` idiom for analyzers
(``repro/analysis/registry.py``).

Every rule is a function ``fn(project) -> Iterable[Finding]`` registered
under a stable code (``RPA101``, ...). Codes are permanent: a retired
rule's code is never reused (suppressions and baselines reference them).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Iterable, List

_CODE_RE = re.compile(r"^RPA\d{3}$")

_REGISTRY: Dict[str, "Rule"] = {}


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered analyzer: stable ``code``, short kebab ``name``,
    one-line ``summary``, and the checking function."""
    code: str
    name: str
    summary: str
    fn: Callable

    @property
    def family(self) -> str:
        """``RPA101`` -> ``RPA1xx`` (rules ship one module per family)."""
        return self.code[:4] + "xx"


def register(code: str, name: str, summary: str) -> Callable:
    """Decorator: ``@register("RPA101", "traced-python-branch", ...)``.
    Re-registering a code is an error — codes are append-only."""
    if not _CODE_RE.match(code):
        raise ValueError(f"rule code must match RPAnnn, got {code!r}")

    def deco(fn: Callable) -> Callable:
        if code in _REGISTRY:
            raise ValueError(f"rule code {code} already registered "
                             f"({_REGISTRY[code].name})")
        _REGISTRY[code] = Rule(code, name, summary, fn)
        return fn
    return deco


def rules() -> List[Rule]:
    """Every registered rule, sorted by code (loads the rule modules)."""
    import repro_torch.analysis.rules  # noqa: F401  (registration side effect)
    return [_REGISTRY[c] for c in sorted(_REGISTRY)]


def get_rule(code: str) -> Rule:
    """Lookup by code (after ensuring rule modules are loaded)."""
    import repro_torch.analysis.rules  # noqa: F401
    if code not in _REGISTRY:
        raise KeyError(f"unknown rule code {code!r}; "
                       f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[code]


def RULES() -> Dict[str, Rule]:
    """The live registry mapping (code -> Rule), post-load."""
    import repro_torch.analysis.rules  # noqa: F401
    return dict(_REGISTRY)


def run_rules(project, codes: Iterable[str] = ()) -> List:
    """Run the selected rules (default: all) and return sorted findings."""
    selected = rules()
    if codes:
        want = set(codes)
        selected = [r for r in selected if r.code in want]
    findings = []
    for rule in selected:
        findings.extend(rule.fn(project))
    return sorted(findings, key=lambda f: f.sort_key())
