"""The analyzed file set: sources, parsed ASTs, module-name mapping
(``repro/analysis/project.py``).

A ``Project`` is a pure mapping ``relpath -> source`` (plus lazy AST and
line caches), so rules are testable on virtual trees: the fixture corpus
(tests/analysis_fixtures) and the mutation tests feed hand-built file
dicts through exactly the code path the CLI runs on the real repo.

Also home to the small shared resolvers every rule family leans on:
module-level integer constants (with cross-module dotted lookup for
``# repro: vmem-bound`` annotations), literal-arithmetic evaluation, and
``repro_torch.*`` import-edge extraction for the reachability family.

Beside the Python modules a project holds the kernels' CUDA sources
(``*.cu``, ``*.cuh``): the shared-memory rule (RPA303) reads them as
text. ``paths()`` and ``walk()`` are the Python modules only, so every
other rule and the ``files_scanned`` count see what the reference's see.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.model import is_quarantined

# the subtree the CLI analyzes by default, relative to the repo root
DEFAULT_SUBTREE = os.path.join("src", "repro_torch")

# the import prefix of the analyzed package
PACKAGE = "repro_torch"

# CUDA sources a project carries beside its Python modules
CUDA_SUFFIXES = (".cu", ".cuh")


class Project:
    """An immutable set of Python sources keyed by repo-relative path
    (always ``/``-separated, e.g. ``src/repro_torch/core/api.py``)."""

    def __init__(self, files: Dict[str, str]):
        self.files = dict(files)
        self._asts: Dict[str, Optional[ast.Module]] = {}
        self._lines: Dict[str, List[str]] = {}

    @classmethod
    def from_tree(cls, root: str,
                  subtree: str = DEFAULT_SUBTREE) -> "Project":
        """Scan ``root/subtree`` for ``.py`` files and CUDA sources
        (sorted, recursive)."""
        files: Dict[str, str] = {}
        base = os.path.join(root, subtree)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for fname in sorted(filenames):
                if not fname.endswith((".py",) + CUDA_SUFFIXES):
                    continue
                full = os.path.join(dirpath, fname)
                rel = os.path.relpath(full, root).replace(os.sep, "/")
                with open(full, encoding="utf-8") as f:
                    files[rel] = f.read()
        return cls(files)

    # -- per-file access ---------------------------------------------------

    def paths(self) -> List[str]:
        """All Python module paths, sorted."""
        return sorted(p for p in self.files if p.endswith(".py"))

    def cuda_paths(self) -> List[str]:
        """All CUDA source paths (``*.cu``, ``*.cuh``), sorted."""
        return sorted(p for p in self.files if p.endswith(CUDA_SUFFIXES))

    def source(self, path: str) -> str:
        return self.files[path]

    def lines(self, path: str) -> List[str]:
        """Source lines (for comment scanning; cached)."""
        if path not in self._lines:
            self._lines[path] = self.files[path].splitlines()
        return self._lines[path]

    def line(self, path: str, lineno: int) -> str:
        """1-based source line ("" when out of range)."""
        lines = self.lines(path)
        return lines[lineno - 1] if 0 < lineno <= len(lines) else ""

    def tree(self, path: str) -> Optional[ast.Module]:
        """Parsed AST (``None`` for files that fail to parse — the CLI
        reports those as RPA000 internal findings, rules just skip)."""
        if path not in self._asts:
            try:
                self._asts[path] = ast.parse(self.files[path], path)
            except SyntaxError:
                self._asts[path] = None
        return self._asts[path]

    def quarantined(self, path: str) -> bool:
        """Module opted out of analysis via ``# repro: quarantine``."""
        return is_quarantined(self.files[path])

    def walk(self, skip_quarantined: bool = True
             ) -> Iterator[Tuple[str, ast.Module]]:
        """(path, tree) for every parseable module, quarantine-filtered."""
        for path in self.paths():
            if skip_quarantined and self.quarantined(path):
                continue
            tree = self.tree(path)
            if tree is not None:
                yield path, tree

    # -- module-name mapping (src layout) ----------------------------------

    def module_name(self, path: str) -> Optional[str]:
        """``src/repro_torch/core/api.py`` -> ``repro_torch.core.api``
        (packages map
        to their ``__init__``'s dotted name); non-src files -> None."""
        if not path.startswith("src/") or not path.endswith(".py"):
            return None
        parts = path[len("src/"):-len(".py")].split("/")
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    def module_path(self, module: str) -> Optional[str]:
        """Dotted name -> project path (module file or package init)."""
        base = "src/" + module.replace(".", "/")
        for cand in (base + ".py", base + "/__init__.py"):
            if cand in self.files:
                return cand
        return None

    # -- shared resolvers --------------------------------------------------

    def module_constants(self, path: str) -> Dict[str, int]:
        """Module-level ``NAME = <int literal arithmetic>`` bindings."""
        tree = self.tree(path)
        out: Dict[str, int] = {}
        if tree is None:
            return out
        for node in tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                val = literal_int(node.value, out)
                if val is not None:
                    out[node.targets[0].id] = val
        return out

    def dotted_constant(self, dotted: str) -> Optional[int]:
        """Resolve ``repro_torch.stats.backends.HIST_MAX_BINS`` (or a bare
        integer string) across the project's module constants."""
        try:
            return int(dotted)
        except ValueError:
            pass
        if "." not in dotted:
            return None
        module, name = dotted.rsplit(".", 1)
        path = self.module_path(module)
        if path is None:
            return None
        return self.module_constants(path).get(name)

    def imports_of(self, path: str) -> Set[str]:
        """Dotted ``repro_torch.*`` module names imported anywhere in the
        file (top-level and function-local; ``from repro_torch.a import
        b`` yields both ``repro_torch.a`` and — when it names a module —
        ``repro_torch.a.b``; ``from repro_torch import b`` yields
        ``repro_torch`` and ``repro_torch.b``)."""
        tree = self.tree(path)
        out: Set[str] = set()
        if tree is None:
            return out
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if _in_package(alias.name):
                        out.add(alias.name)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if not _in_package(mod):
                    continue
                out.add(mod)
                for alias in node.names:
                    if self.module_path(f"{mod}.{alias.name}"):
                        out.add(f"{mod}.{alias.name}")
        return out


def _in_package(module: str) -> bool:
    return module == PACKAGE or module.startswith(PACKAGE + ".")


def literal_int(node: ast.AST,
                env: Optional[Dict[str, int]] = None) -> Optional[int]:
    """Evaluate constant integer arithmetic (``1 << 16``, ``4 * KB``)
    over literals and ``env`` names; ``None`` when not statically known."""
    env = env or {}
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = literal_int(node.operand, env)
        return None if v is None else -v
    if isinstance(node, ast.BinOp):
        lhs = literal_int(node.left, env)
        rhs = literal_int(node.right, env)
        if lhs is None or rhs is None:
            return None
        ops = {ast.Add: lambda a, b: a + b,
               ast.Sub: lambda a, b: a - b,
               ast.Mult: lambda a, b: a * b,
               ast.FloorDiv: lambda a, b: a // b if b else None,
               ast.Mod: lambda a, b: a % b if b else None,
               ast.LShift: lambda a, b: a << b,
               ast.RShift: lambda a, b: a >> b,
               ast.Pow: lambda a, b: a ** b if b >= 0 else None}
        fn = ops.get(type(node.op))
        return fn(lhs, rhs) if fn else None
    return None


def dotted_name(node: ast.AST) -> Optional[str]:
    """``jnp.sum`` / ``jax.lax.switch`` attribute chain as a string."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
