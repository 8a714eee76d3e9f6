"""RPA4xx — registry and wire-format closure
(``repro/analysis/rules/registry_closure.py``).

In the port the generator registry is ``rng/sources.py``
(``register_generator``, ``counter_based_names``; ``rng/generators.py``
registers the built-ins), and the wire layouts are those of
``Checkpoint`` (v5) and ``CampaignLedger`` (v3) in ``core/api.py`` and
``CacheEntry`` (v2) in ``serve/cache.py``, written through
``ckpt/io.py``'s ``save`` and read through its ``load_flat``.

  RPA401  offset/COUNTER_BASED closure — jump-ahead stream offsets are
          only sound for counter-based generators. In any module that
          defines both a ``GENERATORS`` dict literal and a
          ``COUNTER_BASED`` tuple: every counter-based entry's block
          function must take an ``offset`` parameter, every generator
          whose block function takes ``offset`` must be listed in
          ``COUNTER_BASED`` (else the capability is silently dropped
          at the ``gen_block_by_id`` switch), and ``COUNTER_BASED``
          must be a subset of the registry.
  RPA403  dynamic-registry declaration — the BitSource plugin registry
          (``rng.sources.register_generator``) took over RPA401's
          static closure: every ``register_generator(...)`` call must
          declare ``counter_based=`` explicitly (the offset capability
          cannot be inferred from an out-of-repo block function), and a
          module that registers generators must not ALSO define a
          static ``COUNTER_BASED`` tuple literal — the live registry
          (``counter_based_names()``) is the single source of truth,
          and a parallel static tuple would drift the moment a plugin
          registers.
  RPA402  version upgrade path — a class whose ``save`` writes a flat
          leaf list (the msgpack wire format) and whose ``load`` reads
          it back via ``load_flat`` must (a) accept the layout it
          writes: the writer's leaf count appears among the reader's
          ``len(leaves) ==/!=`` constants, and (b) actually check any
          ``*VERSION*`` constant it serializes. This is the invariant
          the Checkpoint v1/v2/v3 upgrade chain and the CampaignLedger
          maintain by hand (the port's: Checkpoint v1..v5, CampaignLedger
          v1..v3, CacheEntry v1/v2).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.model import Finding
from repro_torch.analysis.project import Project, dotted_name
from repro_torch.analysis.registry import register


# -- RPA401 ----------------------------------------------------------------

def _module_assign(tree: ast.Module, name: str) -> Optional[ast.AST]:
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name:
            return node
        if isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.target.id == name and node.value is not None:
            return node
    return None


def _str_elements(node: ast.expr) -> Optional[Set[str]]:
    if not isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return None
    out = set()
    for elt in node.elts:
        if not (isinstance(elt, ast.Constant)
                and isinstance(elt.value, str)):
            return None
        out.add(elt.value)
    return out


@register("RPA401", "offset-registry-closure",
          "COUNTER_BASED generators must take offset=, and only they "
          "may")
def rpa401(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for path, tree in project.walk():
        gens_node = _module_assign(tree, "GENERATORS")
        cb_node = _module_assign(tree, "COUNTER_BASED")
        if gens_node is None or cb_node is None:
            continue
        gens_value = gens_node.value
        counter_based = _str_elements(cb_node.value)
        if not isinstance(gens_value, ast.Dict) or counter_based is None:
            continue
        fns = {n.name: n for n in tree.body
               if isinstance(n, ast.FunctionDef)}
        registry: Dict[str, Optional[ast.FunctionDef]] = {}
        for key, val in zip(gens_value.keys, gens_value.values):
            if isinstance(key, ast.Constant) \
                    and isinstance(key.value, str):
                fn = fns.get(val.id) if isinstance(val, ast.Name) \
                    else None
                registry[key.value] = fn
        for name in sorted(counter_based - set(registry)):
            out.append(Finding(
                "RPA401", "offset-registry-closure", path,
                cb_node.lineno, 1,
                f"COUNTER_BASED lists '{name}' which is not in the "
                f"GENERATORS registry"))
        for name, fn in sorted(registry.items()):
            if fn is None:
                continue
            params = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                                      + fn.args.kwonlyargs)}
            takes_offset = "offset" in params
            if name in counter_based and not takes_offset:
                out.append(Finding(
                    "RPA401", "offset-registry-closure", path,
                    fn.lineno, 1,
                    f"generator '{name}' is declared COUNTER_BASED "
                    f"but `{fn.name}` takes no offset= parameter — "
                    f"jump-ahead would silently restart the stream"))
            elif name not in counter_based and takes_offset:
                out.append(Finding(
                    "RPA401", "offset-registry-closure", path,
                    fn.lineno, 1,
                    f"generator '{name}' takes offset= but is not in "
                    f"COUNTER_BASED — its jump-ahead capability is "
                    f"dropped at the offset dispatch"))
    return out


# -- RPA403 ----------------------------------------------------------------

@register("RPA403", "dynamic-registry-declaration",
          "register_generator calls must declare counter_based=; "
          "registering modules must not keep a static COUNTER_BASED "
          "tuple")
def rpa403(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for path, tree in project.walk():
        calls = [node for node in ast.walk(tree)
                 if isinstance(node, ast.Call)
                 and (dotted_name(node.func) or "").split(".")[-1]
                 == "register_generator"]
        if not calls:
            continue
        for call in calls:
            if any(kw.arg == "counter_based" for kw in call.keywords):
                continue
            out.append(Finding(
                "RPA403", "dynamic-registry-declaration", path,
                call.lineno, call.col_offset + 1,
                "register_generator(...) without an explicit "
                "counter_based= keyword — the offset capability of a "
                "registered source must be DECLARED; stream offsets, "
                "over-decomposition and campaign grids all dispatch "
                "on it"))
        cb_node = _module_assign(tree, "COUNTER_BASED")
        if cb_node is not None \
                and _str_elements(cb_node.value) is not None:
            out.append(Finding(
                "RPA403", "dynamic-registry-declaration", path,
                cb_node.lineno, 1,
                "module registers generators dynamically but also "
                "defines a static COUNTER_BASED tuple — derive it from "
                "the live registry (rng.sources.counter_based_names) "
                "so plugins cannot drift it"))
    return out


# -- RPA402 ----------------------------------------------------------------

def _writer_layout(fn: ast.FunctionDef) -> Optional[ast.List]:
    """The leaf-list literal handed to ``io.save(path, [leaves...])``."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and len(node.args) >= 2 \
                and isinstance(node.args[1], ast.List):
            fname = dotted_name(node.func) or ""
            if fname.split(".")[-1] == "save":
                return node.args[1]
    return None


def _uses_load_flat(fn: ast.FunctionDef) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func) or ""
            if fname.split(".")[-1] == "load_flat":
                return True
    return False


def _accepted_lengths(fn: ast.FunctionDef) -> Set[int]:
    """Constants N from ``len(x) == N`` / ``len(x) != N`` comparisons."""
    out: Set[int] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1:
            continue
        if not isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
            continue
        sides = (node.left, node.comparators[0])
        has_len = any(isinstance(s, ast.Call)
                      and (dotted_name(s.func) or "") == "len"
                      for s in sides)
        if not has_len:
            continue
        for s in sides:
            if isinstance(s, ast.Constant) and isinstance(s.value, int):
                out.add(s.value)
    return out


def _version_names(leaves: ast.List) -> Set[str]:
    """``*VERSION*`` constants serialized in the leaf list (e.g.
    ``np.int64(CKPT_VERSION)``)."""
    return {n.id for n in ast.walk(leaves)
            if isinstance(n, ast.Name) and "VERSION" in n.id}


@register("RPA402", "version-upgrade-path",
          "wire-format writers must have a matching reader upgrade "
          "path (leaf count + version check)")
def rpa402(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for path, tree in project.walk():
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = {n.name: n for n in cls.body
                       if isinstance(n, ast.FunctionDef)}
            save, load = methods.get("save"), methods.get("load")
            if save is None or load is None:
                continue
            leaves = _writer_layout(save)
            if leaves is None or not _uses_load_flat(load):
                continue
            accepted = _accepted_lengths(load)
            n = len(leaves.elts)
            if accepted and n not in accepted:
                out.append(Finding(
                    "RPA402", "version-upgrade-path", path,
                    save.lineno, save.col_offset + 1,
                    f"{cls.name}.save writes {n} leaves but "
                    f"{cls.name}.load only accepts layouts of "
                    f"{sorted(accepted)} — the reader cannot load "
                    f"what the writer produces"))
            load_names = {node.id for node in ast.walk(load)
                          if isinstance(node, ast.Name)}
            for vname in sorted(_version_names(leaves)):
                if vname not in load_names:
                    out.append(Finding(
                        "RPA402", "version-upgrade-path", path,
                        save.lineno, save.col_offset + 1,
                        f"{cls.name}.save serializes `{vname}` but "
                        f"{cls.name}.load never checks it — version "
                        f"drift would pass silently"))
    return out
