"""RPA3xx — kernel contracts: registry closure, dtype pins, shared-memory
budget (``repro/analysis/rules/kernels.py``, on the port's CUDA kernels).

  RPA301  backend registry closure — every kernel family registered with
          an ``accelerated`` backend must also have a ``reference``
          entry (``resolve()`` falls back to reference; an accelerated-
          only family would fail exactly when the fallback matters).
          Registration sites are collected from direct
          ``register(name, backend, fn)`` calls AND loops over dict
          literals (``for k, f in T.KERNELS.items(): register(k, ...)``),
          resolving the dict across module imports.
  RPA302  unpinned integer reduction in a kernel's modules
          (``kernels/*/{ref,ops,kernel}.py``) — ``torch.sum``/``prod``/
          ``cumsum``/``cumprod`` (or the tensor method) without
          ``dtype=``: torch widens an integer reduction to int64, so a
          plain version's dtype (and any wrapped 32-bit arithmetic after
          it) would differ from its kernel's. Float operands (tracked
          through ``.to(torch.float32)``/``.float()`` locals) are exempt.
  RPA303  shared-memory working set of each hand-written CUDA kernel
          (the reference's VMEM budget, on the card's own on-chip
          memory): every static ``__shared__`` array in the kernel's
          sources (its own and those of the ``__device__`` functions it
          calls) must have a size in literal arithmetic over the
          sources' ``constexpr`` constants (the kernel's static bytes
          are their sum in 16-byte units, as ptxas counts them); a
          kernel that takes dynamic shared memory (``extern
          __shared__``) must get a launch size in literal arithmetic,
          or a ``# repro: vmem-bound <int | dotted.CONST>`` annotation
          (4-byte words) on its Python launcher in the kernel's
          directory. Static plus dynamic must not pass
          ``SMEM_BUDGET_BYTES``, the per-block opt-in limit of sm_90.
          The CUDA sources are checked whether or not their Python
          modules are quarantined: a kernel's shared memory is a limit
          of the card, not of the battery path.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.model import VMEM_BOUND_RE, Finding
from repro_torch.analysis.project import (Project, dotted_name, literal_int)
from repro_torch.analysis.registry import register

# shared memory one block may take on sm_90 once it opts in
# (cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100: 227 KiB)
SMEM_BUDGET_BYTES = 232448
ELEMENT_BYTES = 4  # a vmem-bound counts 4-byte words, as the reference's
# a kernel's static shared memory comes in 16-byte units (ptxas reports
# one int of it as 16 bytes, and the runtime's sharedSizeBytes agrees)
SMEM_GRANULE = 16

BACKEND_NAMES = {"reference", "accelerated"}
INT_REDUCTIONS = {"sum", "prod", "cumsum", "cumprod"}
FLOAT_PREFIXES = ("float", "bfloat", "half", "double")

# the kernels' Python modules RPA302 reads, and their directories
KERNEL_MODULE_RE = re.compile(
    r"^src/repro_torch/kernels/([^/]+)/(ref|ops|kernel)\.py$")
KERNEL_DIR_RE = re.compile(r"^(src/repro_torch/kernels/[^/]+)/[^/]+$")


# -- RPA301 ----------------------------------------------------------------

def _module_dicts(tree: ast.Module) -> Dict[str, ast.Dict]:
    """Module-level ``NAME = {...}`` / ``NAME: T = {...}`` dict literals."""
    out: Dict[str, ast.Dict] = {}
    for node in tree.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target = node.targets[0].id
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            target = node.target.id
        value = getattr(node, "value", None)
        if target is not None and isinstance(value, ast.Dict):
            out[target] = value
    return out


def _dict_str_keys(d: ast.Dict) -> Set[str]:
    return {k.value for k in d.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}


def _import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Local alias -> dotted module (``from repro_torch.stats import tests
    as T`` makes ``T`` -> ``repro_torch.stats.tests``)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    return out


def _resolve_dict_keys(project: Project, path: str, tree: ast.Module,
                       node: ast.expr) -> Optional[Set[str]]:
    """String keys of the dict literal ``node`` refers to — a local
    module-level dict or an imported one (``T.KERNELS``)."""
    local = _module_dicts(tree)
    if isinstance(node, ast.Name):
        if node.id in local:
            return _dict_str_keys(local[node.id])
        return None
    dotted = dotted_name(node)
    if dotted is None or "." not in dotted:
        return None
    alias, attr = dotted.rsplit(".", 1)
    module = _import_aliases(tree).get(alias)
    if module is None:
        return None
    mpath = project.module_path(module)
    if mpath is None:
        return None
    mtree = project.tree(mpath)
    if mtree is None:
        return None
    remote = _module_dicts(mtree)
    if attr in remote:
        return _dict_str_keys(remote[attr])
    return None


def _enclosing_for(tree: ast.Module, call: ast.Call
                   ) -> Optional[ast.For]:
    """The For loop whose body contains ``call`` (module level only)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and any(
                call is c for c in ast.walk(node)):
            return node
    return None


def _registrations(project: Project, path: str, tree: ast.Module
                   ) -> Dict[str, Set[Tuple[str, int]]]:
    """backend -> {(family, lineno)} from every ``register(...)`` site."""
    out: Dict[str, Set[Tuple[str, int]]] = {b: set()
                                            for b in BACKEND_NAMES}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or len(node.args) < 3:
            continue
        fname = dotted_name(node.func) or ""
        if fname.split(".")[-1] != "register":
            continue
        backend_arg = node.args[1]
        if not (isinstance(backend_arg, ast.Constant)
                and backend_arg.value in BACKEND_NAMES):
            continue
        backend = backend_arg.value
        name_arg = node.args[0]
        if isinstance(name_arg, ast.Constant) \
                and isinstance(name_arg.value, str):
            out[backend].add((name_arg.value, node.lineno))
            continue
        # loop-registration: resolve the iterated dict's keys
        loop = _enclosing_for(tree, node)
        if loop is None:
            continue
        it = loop.iter
        if isinstance(it, ast.Call) \
                and isinstance(it.func, ast.Attribute) \
                and it.func.attr == "items":
            keys = _resolve_dict_keys(project, path, tree, it.func.value)
            if keys is not None:
                out[backend] |= {(k, loop.lineno) for k in keys}
    return out


@register("RPA301", "backend-registry-closure",
          "accelerated kernel family registered without a reference "
          "fallback entry")
def rpa301(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for path, tree in project.walk():
        regs = _registrations(project, path, tree)
        if not regs["accelerated"]:
            continue
        reference = {name for name, _ in regs["reference"]}
        for name, lineno in sorted(regs["accelerated"]):
            if name not in reference:
                out.append(Finding(
                    "RPA301", "backend-registry-closure", path,
                    lineno, 1,
                    f"kernel family '{name}' has an accelerated "
                    f"backend but no reference entry — resolve() "
                    f"has nothing to fall back to"))
    return out


# -- RPA302 ----------------------------------------------------------------

def _is_float_dtype(node: ast.AST) -> bool:
    """``torch.float32`` / ``torch.bfloat16`` / ``"float32"``-ish."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith(FLOAT_PREFIXES)
    dotted = dotted_name(node) or ""
    return dotted.split(".")[-1].startswith(FLOAT_PREFIXES)


def _float_known(node: ast.AST, env: Set[str]) -> bool:
    """Statically known to be floating point (so torch's widening of
    integer reductions cannot change its dtype)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, float)
    if isinstance(node, ast.Name):
        return node.id in env
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in {"float", "double", "half", "bfloat16"}:
                return True
            if attr == "to":
                dtypes = list(node.args) + [kw.value for kw in node.keywords
                                            if kw.arg == "dtype"]
                return any(_is_float_dtype(d) for d in dtypes)
        fname = dotted_name(node.func) or ""
        last = fname.split(".")[-1]
        if last in {"zeros", "ones", "empty", "rand", "randn"}:
            for kw in node.keywords:
                if kw.arg == "dtype":
                    return _is_float_dtype(kw.value)
            # torch's default dtype is float32
            return True
        if last in {"where", "maximum", "minimum", "clamp"}:
            return any(_float_known(a, env) for a in node.args)
        return False
    if isinstance(node, ast.BinOp):
        return _float_known(node.left, env) \
            or _float_known(node.right, env)
    return False


def _reduction(node: ast.Call) -> Optional[Tuple[str, Optional[ast.AST]]]:
    """``(name, operand)`` of an integer-widening reduction call:
    ``torch.sum(x, ...)`` or ``x.sum(...)``; ``None`` otherwise."""
    fname = dotted_name(node.func) or ""
    parts = fname.split(".")
    if parts[0] == "torch" and len(parts) == 2 \
            and parts[-1] in INT_REDUCTIONS:
        return fname, (node.args[0] if node.args else None)
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in INT_REDUCTIONS \
            and parts[0] not in {"torch", "np", "numpy", "math"}:
        return f".{node.func.attr}()", node.func.value
    return None


@register("RPA302", "unpinned-integer-reduction",
          "integer torch reduction in a kernel's modules without a dtype= "
          "pin (torch widens it to int64)")
def rpa302(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for path, tree in project.walk():
        if not KERNEL_MODULE_RE.match(path):
            continue
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            env: Set[str] = set()
            for stmt in ast.walk(fn):
                if isinstance(stmt, ast.Assign) \
                        and _float_known(stmt.value, env):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            env.add(t.id)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                red = _reduction(node)
                if red is None:
                    continue
                name, operand = red
                if any(kw.arg == "dtype" for kw in node.keywords):
                    continue
                if operand is not None and _float_known(operand, env):
                    continue
                out.append(Finding(
                    "RPA302", "unpinned-integer-reduction", path,
                    node.lineno, node.col_offset + 1,
                    f"`{name}` in `{fn.name}` has no dtype= pin — torch "
                    f"widens an integer reduction to int64, so the plain "
                    f"version's dtype and wrapped 32-bit arithmetic would "
                    f"differ from the kernel's (the gf2_rank bug class)"))
    return out


# -- RPA303 ----------------------------------------------------------------

# bytes of the element types a kernel's shared arrays use
C_TYPE_BYTES = {
    "char": 1, "signed char": 1, "unsigned char": 1, "int8_t": 1,
    "uint8_t": 1, "bool": 1, "short": 2, "unsigned short": 2, "int16_t": 2,
    "uint16_t": 2, "half": 2, "__half": 2, "__nv_bfloat16": 2, "int": 4,
    "unsigned": 4, "unsigned int": 4, "int32_t": 4, "uint32_t": 4,
    "float": 4, "long long": 8, "unsigned long long": 8, "int64_t": 8,
    "uint64_t": 8, "double": 8, "size_t": 8, "int2": 8, "float2": 8,
    "int4": 16, "uint4": 16, "float4": 16, "longlong2": 16,
}

_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_CONSTEXPR_RE = re.compile(
    r"\bconstexpr\s+(?:static\s+)?(?:const\s+)?[\w:]+(?:\s+[\w:]+)*?\s+"
    r"([A-Za-z_]\w*)\s*=\s*([^;{}]+);")
_GLOBAL_RE = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
    r"([A-Za-z_]\w*)\s*\(")
_DEVICE_RE = re.compile(r"__device__\b")
_SHARED_RE = re.compile(
    r"(extern\s+)?__shared__\s+(?:__align__\s*\(\s*\d+\s*\)\s*)?"
    r"((?:(?:const|volatile|unsigned|signed|long|short)\s+)*[\w:]+)\s+"
    r"([A-Za-z_]\w*)\s*((?:\[[^\]]*\]\s*)*);")
_CHEVRON_RE = re.compile(r"<<<(.*?)>>>", re.S)
_DYNAMIC_RE = re.compile(r"\.dynamicSmemBytes\s*=\s*([^;]+);")
_SUFFIX_RE = re.compile(
    r"\b(0[xX][0-9a-fA-F]+|\d+)(?:[uU]?[lL]{0,2}|[lL]{1,2}[uU])\b")
_CAST_RE = re.compile(
    r"\(\s*(?:const\s+)?(?:unsigned\s+|signed\s+)?"
    r"(?:int|long long|long|size_t|u?int(?:8|16|32|64)_t|unsigned)\s*\)")
_SIZEOF_RE = re.compile(r"sizeof\s*\(\s*([\w\s]+?)\s*\)")


def _strip_comments(text: str) -> str:
    """C/C++ comments blanked, newlines kept (offsets map to lines)."""
    return _COMMENT_RE.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)),
                           text)


def c_int(expr: str, env: Dict[str, int]) -> Optional[int]:
    """Evaluate C integer arithmetic (literals with suffixes, casts to
    integer types, ``sizeof`` of a known type, ``env`` names); ``None``
    when it is not statically known."""
    expr = _SIZEOF_RE.sub(
        lambda m: str(C_TYPE_BYTES.get(" ".join(m.group(1).split()), "?")),
        expr)
    expr = _CAST_RE.sub(" ", expr)
    expr = _SUFFIX_RE.sub(r"\1", expr).replace("/", "//")
    try:
        node = ast.parse(expr.strip(), mode="eval").body
    except SyntaxError:
        return None
    return literal_int(node, env)


def _matching(text: str, start: int, open_: str, close: str) -> int:
    """Offset just past the bracket that closes the one at ``start``."""
    depth = 0
    for i in range(start, len(text)):
        if text[i] == open_:
            depth += 1
        elif text[i] == close:
            depth -= 1
            if depth == 0:
                return i + 1
    return len(text)


def _body(text: str, paren: int) -> Optional[Tuple[int, int]]:
    """``(start, end)`` of the function body after the parameter list
    opened at ``paren``; ``None`` for a declaration."""
    after = _matching(text, paren, "(", ")")
    m = re.compile(r"\s*(?:const\s*)?\{").match(text, after)
    if m is None:
        return None
    brace = m.end() - 1
    return brace, _matching(text, brace, "{", "}")


def _split_top(args: str) -> List[str]:
    """Split a launch configuration at its top-level commas."""
    out, depth, cur = [], 0, ""
    for ch in args:
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    return out + [cur]


@dataclasses.dataclass
class CudaKernel:
    """One ``__global__`` kernel's shared memory, as the sources say."""
    name: str
    path: str
    line: int
    static_bytes: Optional[int]      # None: not statically bounded
    dynamic: bool                    # takes extern __shared__
    dynamic_bytes: Optional[int] = None   # bound of its launches
    unbounded: List[Tuple[str, int, str]] = dataclasses.field(
        default_factory=list)        # (path, line, what) not bounded

    @property
    def total_bytes(self) -> Optional[int]:
        """Static plus dynamic bound (``None`` when either is unknown)."""
        if self.static_bytes is None:
            return None
        if not self.dynamic:
            return self.static_bytes
        if self.dynamic_bytes is None:
            return None
        return self.static_bytes + self.dynamic_bytes


def _line(text: str, offset: int) -> int:
    return text.count("\n", 0, offset) + 1


def _parse_dir(project: Project, cuda_paths: List[str]):
    """Functions, shared arrays and launch sizes of one kernel
    directory's CUDA sources."""
    env: Dict[str, int] = {}
    texts = {p: _strip_comments(project.source(p)) for p in cuda_paths}
    for text in texts.values():
        for m in _CONSTEXPR_RE.finditer(text):
            val = c_int(m.group(2), env)
            if val is not None:
                env.setdefault(m.group(1), val)
    funcs = []       # (name, is_kernel, path, line, start, end)
    for path, text in texts.items():
        for m in _GLOBAL_RE.finditer(text):
            span = _body(text, m.end() - 1)
            if span:
                funcs.append((m.group(1), True, path,
                              _line(text, m.start(1)), *span))
        for m in _DEVICE_RE.finditer(text):
            head = re.compile(r"[^;{}]*?([A-Za-z_]\w*)\s*\(").match(
                text, m.end())
            if head is None or head.group(1) == "__launch_bounds__":
                continue
            span = _body(text, head.end() - 1)
            if span:
                funcs.append((head.group(1), False, path,
                              _line(text, head.start(1)), *span))
    shared = {}      # function -> [(bytes or None, path, line, extern)]
    for path, text in texts.items():
        for m in _SHARED_RE.finditer(text):
            owner = [f for f in funcs if f[2] == path
                     and f[4] <= m.start() < f[5]]
            if not owner:
                continue
            name = min(owner, key=lambda f: f[5] - f[4])[0]
            size = C_TYPE_BYTES.get(" ".join(m.group(2).split()))
            for dim in re.findall(r"\[([^\]]*)\]", m.group(4)):
                val = c_int(dim, env) if dim.strip() else None
                size = None if size is None or val is None else size * val
            shared.setdefault(name, []).append(
                (size, path, _line(text, m.start()), bool(m.group(1))))
    launches = []    # (bytes or None, path, line, kernel or None)
    for path, text in texts.items():
        sizes = [(m.group(1), m.start(1), None)
                 for m in _DYNAMIC_RE.finditer(text)]
        for m in _CHEVRON_RE.finditer(text):
            cfg = _split_top(m.group(1))
            named = re.search(r"([A-Za-z_]\w*)\s*(?:<[^;{}()]*>)?\s*$",
                              text[max(0, m.start() - 200):m.start()])
            if len(cfg) >= 3:
                sizes.append((cfg[2], m.start(1),
                              named.group(1) if named else None))
        for expr, offset, kernel in sizes:
            expr = expr.strip()
            if re.fullmatch(r"[A-Za-z_]\w*", expr):
                # a local: its last definition before the launch
                defs = list(re.finditer(
                    r"\b" + expr + r"\s*=\s*([^;]+);", text[:offset]))
                expr = defs[-1].group(1) if defs else expr
            launches.append((c_int(expr, env), path, _line(text, offset),
                             kernel))
    return funcs, shared, launches


def _calls(project: Project, fn, names: Set[str]) -> Set[str]:
    """Names of ``names`` called in ``fn``'s body."""
    body = _strip_comments(project.source(fn[2]))[fn[4]:fn[5]]
    return {n for n in names
            if re.search(r"\b" + n + r"\s*(?:<[^;{}()]*>)?\s*\(", body)}


def _annotated_words(project: Project, directory: str
                     ) -> Tuple[Optional[int], List[Tuple[str, int]]]:
    """The largest ``# repro: vmem-bound`` of the directory's Python
    launchers (4-byte words; quarantined modules included), and the
    annotations whose constant does not resolve."""
    best, bad = None, []
    for path in sorted(project.files):
        if not (path.startswith(directory + "/") and path.endswith(".py")):
            continue
        for lineno, line in enumerate(project.lines(path), 1):
            m = VMEM_BOUND_RE.search(line)
            if m is None:
                continue
            val = project.dotted_constant(m.group(1))
            if val is None:
                bad.append((path, lineno))
            else:
                best = val if best is None else max(best, val)
    return best, bad


def shared_memory(project: Project) -> List[CudaKernel]:
    """Every hand-written CUDA kernel under ``src/repro_torch/kernels``
    with its static shared bytes and its bound on dynamic shared memory
    (``chip_smoke.py`` holds the static bytes to ptxas's report)."""
    by_dir: Dict[str, List[str]] = {}
    for path in project.cuda_paths():
        m = KERNEL_DIR_RE.match(path)
        if m:
            by_dir.setdefault(m.group(1), []).append(path)
    out: List[CudaKernel] = []
    for directory, paths in sorted(by_dir.items()):
        funcs, shared, launches = _parse_dir(project, paths)
        names = {f[0] for f in funcs}
        calls = {f[0]: set() for f in funcs}
        for f in funcs:
            calls[f[0]] |= _calls(project, f, names - {f[0]})
        annotated, bad = _annotated_words(project, directory)
        for f in funcs:
            if not f[1]:
                continue
            reach, todo = {f[0]}, [f[0]]
            while todo:
                for callee in calls.get(todo.pop(), ()):
                    if callee not in reach:
                        reach.add(callee)
                        todo.append(callee)
            decls = [d for n in sorted(reach) for d in shared.get(n, [])]
            static = [d for d in decls if not d[3]]
            size = None if any(d[0] is None for d in static) \
                else sum(d[0] for d in static)
            k = CudaKernel(f[0], f[2], f[3],
                           None if size is None
                           else -(-size // SMEM_GRANULE) * SMEM_GRANULE,
                           any(d[3] for d in decls))
            k.unbounded = [(p, ln, "static __shared__ array")
                           for b, p, ln, _ in static if b is None]
            if k.dynamic:
                # the launches that name this kernel, and those that
                # name none (a cudaLaunchConfig_t's dynamicSmemBytes)
                mine = [(b, p, ln) for b, p, ln, name in launches
                        if name in (None, f[0])]
                known = [b for b, _, _ in mine if b is not None]
                open_ = [(p, ln) for b, p, ln in mine if b is None]
                if open_ and annotated is not None:
                    known.append(ELEMENT_BYTES * annotated)
                    open_ = []
                k.dynamic_bytes = max(known) if known and not open_ \
                    else None
                k.unbounded += [(p, ln, "dynamic shared memory of this "
                                        "launch") for p, ln in open_]
                if open_:
                    k.unbounded += [(p, ln, "vmem-bound annotation")
                                    for p, ln in bad]
            out.append(k)
    return out


@register("RPA303", "vmem-budget",
          "CUDA kernel shared memory must be statically bounded and fit "
          "a block's opt-in limit on sm_90")
def rpa303(project: Project) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for k in shared_memory(project):
        for path, line, what in k.unbounded:
            if (path, line) in seen:
                continue
            seen.add((path, line))
            out.append(Finding(
                "RPA303", "vmem-budget", path, line, 1,
                f"{what} of kernel `{k.name}` is not statically bounded — "
                f"give it literal arithmetic over constexpr constants or "
                f"annotate its Python launcher with `# repro: vmem-bound "
                f"<int | dotted.CONST>` (4-byte words)"))
        total = k.total_bytes
        if total is not None and total > SMEM_BUDGET_BYTES:
            out.append(Finding(
                "RPA303", "vmem-budget", k.path, k.line, 1,
                f"kernel `{k.name}` takes up to {total} bytes of shared "
                f"memory ({k.static_bytes} static + "
                f"{k.dynamic_bytes or 0} dynamic) — over the "
                f"{SMEM_BUDGET_BYTES}-byte per-block opt-in limit of "
                f"sm_90; shrink its tiles or its bins"))
    return out
