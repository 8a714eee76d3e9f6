"""RPA2xx — the RunSpec -> runner/job-table key audit
(``repro/analysis/rules/cachekey.py``).

The reference's PR 4 bug class: ``PoolSession`` caches job tables and
round runners under key tuples, and any ``spec`` field that shapes them
but is missing from the key silently serves a stale table when only that
field changes (the original instance: ``backend`` consumed by
``_compiled`` but keyed only as the raw string, so ``"auto"`` and
``"accelerated"`` aliased after resolution). The port's session resolves
the backend through a helper, ``self._backend(spec)`` (``auto`` depends
on the session's device), on both sides: the rule follows every
``self.<method>(spec)`` call into that method's own ``spec.X`` reads, in
the key methods and in the consumers alike, so a key that drops the
helper call is seen to drop ``backend``. These rules re-derive the
key/consumption sets from the AST on every run:

  RPA201  a session-class method that builds or fetches cached state
          (``_compiled``/``_runner``) reads a ``spec`` field that the key
          tuples (``cache_key``/``_table_key``, plus per-runner key
          tuples assigned inside ``_runner``) do not cover; also fired
          when ``cache_key`` is not a superset of ``_table_key``.
  RPA202  a ``RunSpec`` dataclass field is neither covered by the key
          tuples nor annotated ``# repro: runtime-arg`` (the explicit
          classification: "this field reaches the runner as an argument
          or a host-side policy knob, never the table or the runner").

A "session class" is any ClassDef with at least one key method
(``cache_key``/``_table_key``) and at least one consumer method
(``_compiled``/``_runner``) — structural, so the fixtures and any future
session types get the same audit as ``PoolSession``.
"""
from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterator, List, Optional, Set

from repro_torch.analysis.model import RUNTIME_ARG_RE, Finding
from repro_torch.analysis.project import Project
from repro_torch.analysis.registry import register

KEY_METHODS = ("cache_key", "_table_key")
CONSUMER_METHODS = ("_compiled", "_runner")


def _methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body
            if isinstance(n, ast.FunctionDef)}


def session_classes(tree: ast.Module) -> Iterator[ast.ClassDef]:
    """ClassDefs that look like compile-once sessions."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        methods = _methods(node)
        if any(m in methods for m in KEY_METHODS) \
                and any(m in methods for m in CONSUMER_METHODS):
            yield node


def _spec_param(fn: ast.FunctionDef) -> Optional[str]:
    """The spec parameter: second positional arg (after ``self``)."""
    args = fn.args.posonlyargs + fn.args.args
    return args[1].arg if len(args) >= 2 else None


Methods = Dict[str, ast.FunctionDef]


def _helper_fields(call: ast.Call, spec: str, methods: Methods,
                   seen: FrozenSet[str]) -> Set[str]:
    """The spec fields read by ``self.<method>(..., spec, ...)``: the
    called method's own ``spec.X`` reads (and its helpers', once each)."""
    func = call.func
    if not (isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name) and func.value.id == "self"
            and func.attr in methods and func.attr not in seen):
        return set()
    if not any(isinstance(a, ast.Name) and a.id == spec for a in call.args):
        return set()
    return _reads(methods[func.attr], methods, seen | {func.attr})


def _reads(fn: ast.FunctionDef, methods: Methods,
           seen: FrozenSet[str] = frozenset()) -> Set[str]:
    """Every spec field ``fn`` reads, through its ``self.<method>(spec)``
    helpers."""
    spec = _spec_param(fn)
    if spec is None:
        return set()
    return spec_fields(fn, spec, None, methods, seen | {fn.name})


def spec_fields(node: ast.AST, spec: str,
                env: Optional[Dict[str, Set[str]]] = None,
                methods: Optional[Methods] = None,
                seen: FrozenSet[str] = frozenset()) -> Set[str]:
    """``spec.X`` field names referenced in an expression, following the
    local dataflow ``env`` (name -> set of originating spec fields) and
    the class's ``methods`` called as ``self.<method>(spec)``."""
    env = env or {}
    methods = methods or {}
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and \
                isinstance(n.value, ast.Name) and n.value.id == spec:
            out.add(n.attr)
        elif isinstance(n, ast.Name) and n.id in env:
            out |= env[n.id]
        elif isinstance(n, ast.Call):
            out |= _helper_fields(n, spec, methods, seen)
    return out


def _local_env(fn: ast.FunctionDef, spec: str,
               methods: Methods) -> Dict[str, Set[str]]:
    """Map each local name to the spec fields its value derives from
    (single forward pass; good enough for the straight-line key/compile
    methods this rule audits)."""
    env: Dict[str, Set[str]] = {}
    for stmt in ast.walk(fn):
        if not isinstance(stmt, ast.Assign):
            continue
        fields = spec_fields(stmt.value, spec, env, methods,
                             frozenset({fn.name}))
        if not fields:
            continue
        for t in stmt.targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    env.setdefault(n.id, set()).update(fields)
    return env


def _key_tuple_fields(fn: ast.FunctionDef, methods: Methods) -> Set[str]:
    """Spec fields appearing in the tuple a key method returns."""
    spec = _spec_param(fn)
    if spec is None:
        return set()
    env = _local_env(fn, spec, methods)
    out: Set[str] = set()
    for stmt in ast.walk(fn):
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            out |= spec_fields(stmt.value, spec, env, methods,
                               frozenset({fn.name}))
    return out


def _key_tuples(fn: ast.FunctionDef) -> Iterator[ast.Tuple]:
    """Tuple literals ``fn`` keys a cache with: assigned to a local
    (``rk = (w, g, grid)``), used as a subscript index
    (``cache[(w, g)] = r``) or handed to a dict lookup
    (``cache.get((w, g))``)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Tuple):
            yield node.value
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.slice, ast.Tuple):
            yield node.slice
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in {"get", "setdefault", "pop"} \
                and node.args and isinstance(node.args[0], ast.Tuple):
            yield node.args[0]


def _runner_key_fields(fn: ast.FunctionDef, methods: Methods) -> Set[str]:
    """Spec fields folded into per-runner key tuples inside ``_runner``
    (e.g. ``runners.get((w, g, grid))`` where ``g``/``grid`` derive from
    spec fields)."""
    spec = _spec_param(fn)
    if spec is None:
        return set()
    env = _local_env(fn, spec, methods)
    out: Set[str] = set()
    for key in _key_tuples(fn):
        out |= spec_fields(key, spec, env, methods, frozenset({fn.name}))
    return out


def _runspec_class(tree: ast.Module) -> Optional[ast.ClassDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "RunSpec":
            return node
    return None


def _property_fields(cls: ast.ClassDef) -> Dict[str, Set[str]]:
    """Property name -> the ``self.X`` fields it reads (so a key that
    consumes ``spec.n_generators`` covers the ``generators`` field)."""
    out: Dict[str, Set[str]] = {}
    for node in cls.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        if not any(isinstance(d, ast.Name) and d.id == "property"
                   for d in node.decorator_list):
            continue
        out[node.name] = {n.attr for n in ast.walk(node)
                          if isinstance(n, ast.Attribute)
                          and isinstance(n.value, ast.Name)
                          and n.value.id == "self"}
    return out


@register("RPA201", "cache-key-missing-field",
          "runner/job-table construction reads a spec field the "
          "session's keys do not cover")
def rpa201(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for path, tree in project.walk():
        for cls in session_classes(tree):
            methods = _methods(cls)
            cache_key = methods.get("cache_key")
            table_key = methods.get("_table_key")
            ck_fields = _key_tuple_fields(cache_key, methods) \
                if cache_key else set()
            tk_fields = _key_tuple_fields(table_key, methods) \
                if table_key else set()
            # the session key must subsume the table key: a field that
            # distinguishes compiled tables must distinguish sessions
            if cache_key is not None and table_key is not None:
                missing = sorted(tk_fields - ck_fields)
                if missing:
                    out.append(Finding(
                        "RPA201", "cache-key-missing-field", path,
                        cache_key.lineno, cache_key.col_offset + 1,
                        f"{cls.name}.cache_key drops spec field(s) "
                        f"{missing} that _table_key depends on — "
                        f"sessions with different compiled tables "
                        f"would alias"))
            compiled = methods.get("_compiled")
            if compiled is not None:
                key = tk_fields or ck_fields
                missing = sorted(_reads(compiled, methods)
                                 - key)
                if missing:
                    out.append(Finding(
                        "RPA201", "cache-key-missing-field", path,
                        compiled.lineno, compiled.col_offset + 1,
                        f"{cls.name}._compiled reads spec field(s) "
                        f"{missing} missing from the job-table "
                        f"key — a stale table would be served when "
                        f"only those fields change"))
            runner = methods.get("_runner")
            if runner is not None:
                covered = (ck_fields | tk_fields
                           | _runner_key_fields(runner, methods))
                missing = sorted(_reads(runner, methods)
                                 - covered)
                if missing:
                    out.append(Finding(
                        "RPA201", "cache-key-missing-field", path,
                        runner.lineno, runner.col_offset + 1,
                        f"{cls.name}._runner reads spec field(s) "
                        f"{missing} not covered by the session or "
                        f"per-runner keys — a cached runner would be "
                        f"reused across those values"))
    return out


@register("RPA202", "unclassified-spec-field",
          "RunSpec field neither in a session key nor annotated "
          "# repro: runtime-arg")
def rpa202(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for path, tree in project.walk():
        runspec = _runspec_class(tree)
        sessions = list(session_classes(tree))
        if runspec is None or not sessions:
            continue
        props = _property_fields(runspec)
        covered: Set[str] = set()
        for cls in sessions:
            methods = _methods(cls)
            for name in KEY_METHODS:
                if name in methods:
                    covered |= _key_tuple_fields(methods[name], methods)
            if "_runner" in methods:
                covered |= _runner_key_fields(methods["_runner"], methods)
        # resolve property reads down to the dataclass fields they touch
        for prop in list(covered):
            covered |= props.get(prop, set())
        for node in runspec.body:
            if not isinstance(node, ast.AnnAssign) \
                    or not isinstance(node.target, ast.Name):
                continue
            field = node.target.id
            if field in covered:
                continue
            if RUNTIME_ARG_RE.search(project.line(path, node.lineno)):
                continue
            out.append(Finding(
                "RPA202", "unclassified-spec-field", path,
                node.lineno, node.col_offset + 1,
                f"RunSpec.{field} is neither part of a session key "
                f"nor annotated `# repro: runtime-arg` — classify "
                f"it so key drift is detectable"))
    return out
