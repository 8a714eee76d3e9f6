"""RPA5xx — import-graph reachability and the quarantine discipline
(``repro/analysis/rules/reach.py``).

The port carries the growth seed's LM stack as far as its dense serving
path (``models/``, ``configs/``, ``common/config.py``,
``kernels/flash_attention``), which nothing in the battery system
imports. Each of those modules carries a ``# repro: quarantine --
reason`` annotation in its module head, as the reference's do, and this
family keeps that classification honest in both directions:

  RPA501  a module unreachable from the battery-system roots has no
          quarantine annotation — either wire it in or annotate it.
  RPA502  a quarantined module IS reachable from the roots — the
          annotation is stale (or live code grew an import into
          quarantined territory); the import edge is named.

Roots: ``repro_torch.core`` (the session/battery engine), the
``repro_torch.launch.battery`` CLI, the serve layer
(``repro_torch.serve`` and its ``repro_torch.launch.serve`` daemon CLI),
and ``repro_torch.analysis`` itself —
the serve daemon is an entry point like the battery CLI, so its
subtree must stay honestly classified too. Reaching a
module also reaches its ancestor package ``__init__``s (importing
``repro_torch.a.b`` executes ``repro_torch/a/__init__``). The family no-ops on
projects that contain no root module, so single-file fixture trees
stay silent.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.model import Finding
from repro_torch.analysis.project import Project
from repro_torch.analysis.registry import register

# a module is a root when its dotted name equals one of these or sits
# under one of them
ROOT_PREFIXES = ("repro_torch.core", "repro_torch.launch.battery",
                 "repro_torch.serve", "repro_torch.launch.serve",
                 "repro_torch.analysis")


def _is_root(module: str) -> bool:
    return any(module == p or module.startswith(p + ".")
               for p in ROOT_PREFIXES)


def _ancestor_packages(module: str) -> List[str]:
    parts = module.split(".")
    return [".".join(parts[:i]) for i in range(1, len(parts))]


def reachable_modules(project: Project
                      ) -> Optional[Tuple[Set[str], Dict[str, str]]]:
    """(reachable dotted names, module -> one importing module) via BFS
    from the roots; ``None`` when the project has no root modules."""
    modules: Dict[str, str] = {}
    for path in project.paths():
        name = project.module_name(path)
        if name is not None:
            modules[name] = path
    roots = sorted(m for m in modules if _is_root(m))
    if not roots:
        return None
    via: Dict[str, str] = {}
    seen: Set[str] = set()
    queue = list(roots)
    while queue:
        mod = queue.pop(0)
        if mod in seen or mod not in modules:
            continue
        seen.add(mod)
        # importing a module executes its ancestor package __init__s
        for pkg in _ancestor_packages(mod):
            if pkg in modules and pkg not in seen:
                via.setdefault(pkg, mod)
                queue.append(pkg)
        for imp in sorted(project.imports_of(modules[mod])):
            for target in [imp] + _ancestor_packages(imp):
                if target in modules and target not in seen:
                    via.setdefault(target, mod)
                    queue.append(target)
    return seen, via


@register("RPA501", "unreachable-module",
          "module unreachable from the battery-system roots lacks a "
          "quarantine annotation")
def rpa501(project: Project) -> List[Finding]:
    result = reachable_modules(project)
    if result is None:
        return []
    reachable, _via = result
    out: List[Finding] = []
    for path in project.paths():
        module = project.module_name(path)
        if module is None or module in reachable:
            continue
        if project.quarantined(path):
            continue
        out.append(Finding(
            "RPA501", "unreachable-module", path, 1, 1,
            f"module `{module}` is unreachable from the battery "
            f"system roots {list(ROOT_PREFIXES)} — wire it in or "
            f"annotate it `# repro: quarantine -- <reason>`"))
    return out


@register("RPA502", "stale-quarantine",
          "quarantined module is reachable from the battery-system "
          "roots")
def rpa502(project: Project) -> List[Finding]:
    result = reachable_modules(project)
    if result is None:
        return []
    reachable, via = result
    out: List[Finding] = []
    for path in project.paths():
        module = project.module_name(path)
        if module is None or module not in reachable:
            continue
        if not project.quarantined(path):
            continue
        importer = via.get(module)
        edge = f" (imported via `{importer}`)" if importer else ""
        out.append(Finding(
            "RPA502", "stale-quarantine", path, 1, 1,
            f"module `{module}` carries a quarantine annotation but "
            f"is reachable from the battery system{edge} — drop the "
            f"annotation or cut the import"))
    return out
