"""RPA1xx — host-sync hazards in the round hot path
(``repro/analysis/rules/trace.py``).

The reference's round functions stay fast while they compile once and
never sync. The port runs eagerly: its warm round loop stays fast while
it queues kernels on the card and waits for nothing but the round's one
device-to-host copy of results (the card sits idle for most of a warm
BigCrush, ``PERF.md`` §5, so every extra wait is wall time). The
classic ways to lose that silently:

  RPA101  Python ``if``/``while``/``assert`` (or a conditional
          expression) on a tensor — ``bool()`` of a CUDA tensor waits
          for the card.
  RPA102  a host sync on a tensor: ``.item()``/``.tolist()``/``.cpu()``/
          ``.numpy()``/``.to("cpu")``, ``float()``/``int()``/``bool()``
          or a ``np.*`` call on it, boolean-mask indexing (its result's
          size is data), the data-dependent-size ops (``torch.nonzero``/
          ``unique``/``masked_select``/``bincount``/``argwhere``/
          ``repeat_interleave``/``equal``/``allclose``, one-argument
          ``torch.where``), ``torch.cuda.synchronize``, and host data
          copied to the card: ``torch.tensor``/``as_tensor``/``asarray``
          of a host value with ``device=``, ``.to(device)``/``.cuda()``
          of a tensor just made on the host (without
          ``non_blocking=True``), and a host value written into a tensor
          by indexing (``x[0] = 1``: torch builds the value on the host
          and copies it); a pageable copy waits for the stream.
  RPA103  hot-path code mutating module-level state (a cache, a launch
          counter, a ``global``): the screening daemon runs rounds on a
          thread beside its caller's, so such state is shared between
          threads.
  RPA106  fault-injection API (``FaultInjector`` / ``apply_round`` /
          ``inject_round_faults``) called inside the hot path — faults
          are injected at the host-side boundary, after a round's results
          reached the host (DESIGN.md §12), or a run stops replaying
          from ``(plan, seed)``. A genuine boundary function in a
          hot-path *module* (never a structurally hot function) opts out
          with a ``# repro: fault-boundary`` comment on its ``def`` line.

What counts as hot-path code:

  * every function in the round hot path's modules, the reference's
    traced modules mapped onto the port (``core/pool.py``,
    ``rng/generators.py``, ``stats/tests.py``, ``stats/backends.py``,
    ``stats/special.py``, everything under ``kernels/``),
  * any function decorated with ``torch.compile`` / ``torch.jit.script``
    (or ``functools.partial(torch.compile, ...)``), and any function
    passed by name to ``torch.compile``, ``torch.jit.*``, ``torch.func.*``
    or ``torch.vmap``.

Taint is deliberately conservative: a value is a device value when it
is (derived from) the result of a ``torch.*`` call or a tensor method.
Function parameters are NOT assumed to be tensors — the battery
families take static parameters (``n``, ``kbits``, ``maxlen``) beside
their words, and flagging ``float(1 << kbits)`` would drown the signal.
Tensor metadata (``.shape``/``.dtype``/``.device``/``.numel()``/
``.data_ptr()`` ...) is always host-side. The static view over-reports
(a ``torch.as_tensor`` of a value that is already on the card copies
nothing): a deliberate or harmless site carries a ``noqa`` with its
reason; ``chip_smoke.py`` checks on the card that every sync the card
reports in these modules is a line this family reports.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.model import FAULT_BOUNDARY_RE, Finding
from repro_torch.analysis.project import Project, dotted_name
from repro_torch.analysis.registry import register

# modules whose every function is on the round hot path (prefix match)
TRACED_MODULE_PATHS = (
    "src/repro_torch/core/pool.py",
    "src/repro_torch/rng/generators.py",
    "src/repro_torch/stats/tests.py",
    "src/repro_torch/stats/backends.py",
    "src/repro_torch/stats/special.py",
    "src/repro_torch/kernels/",
)

# attribute reads and methods that are host-side even on a tensor
STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
                "requires_grad", "itemsize", "nbytes", "is_leaf"}
STATIC_METHODS = {"size", "dim", "numel", "nelement", "ndimension",
                  "is_contiguous", "data_ptr", "element_size", "stride",
                  "storage_offset", "get_device", "is_pinned",
                  "is_floating_point", "is_complex"}

# call roots whose results are device values, and the torch namespaces
# that return host values
TRACED_ROOTS = {"torch"}
HOST_TORCH = ("torch.cuda.", "torch._C.", "torch.backends.",
              "torch.device", "torch.Size", "torch.finfo", "torch.iinfo",
              "torch.is_tensor", "torch.get_default_dtype", "torch.dtype")

# builtins / namespaces that bring a tensor's value to the host
CONCRETIZERS = {"float", "int", "bool", "complex"}
HOST_ROOTS = {"np", "numpy"}
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}

# ops whose result size is data: they wait for the card to know it
SIZE_SYNC_OPS = {"nonzero", "unique", "unique_consecutive", "masked_select",
                 "bincount", "argwhere", "repeat_interleave", "equal",
                 "allclose"}
# torch calls that build a tensor from host data, and those that make a
# boolean mask
HOST_CONSTRUCTORS = {"tensor", "as_tensor", "asarray", "from_numpy"}
# torch factories that make a host tensor unless given a device
FACTORIES = HOST_CONSTRUCTORS | {"empty", "zeros", "ones", "full", "arange",
                                 "linspace", "eye", "rand", "randn",
                                 "randint", "randperm"}
MASK_CALLS = {"isnan", "isinf", "isfinite", "isneginf", "isposinf", "isin",
              "logical_and", "logical_or", "logical_not", "logical_xor",
              "eq", "ne", "lt", "le", "gt", "ge", "bool"}

# mutating method names on closed-over containers
MUTATORS = {"append", "add", "update", "extend", "insert", "pop",
            "setdefault", "clear", "remove", "discard"}

# fault-injection API call names (last dotted component) — host-side only
FAULT_API = {"FaultInjector", "inject_round_faults", "round_faults",
             "apply_round"}

# transforms whose function argument or decorated body is compiled
COMPILERS = {"torch.compile", "torch.jit.script", "torch.jit.trace"}
TRANSFORM_PREFIXES = ("torch.compile", "torch.jit.", "torch.func.",
                      "torch.vmap")


def _decorator_traced(dec: ast.AST) -> bool:
    """``@torch.compile`` / ``@torch.compile(...)`` /
    ``@torch.jit.script`` / ``@functools.partial(torch.compile, ...)``."""
    name = dotted_name(dec)
    if name is not None:
        return name in COMPILERS
    if isinstance(dec, ast.Call):
        fname = dotted_name(dec.func) or ""
        if fname in COMPILERS:
            return True
        if fname.split(".")[-1] == "partial" and dec.args:
            return (dotted_name(dec.args[0]) or "") in COMPILERS
    return False


def _names_passed_to_transforms(tree: ast.Module) -> Set[str]:
    """Function names handed to a torch compiler or functional transform
    anywhere in the module."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = dotted_name(node.func) or ""
        if not fname.startswith(TRANSFORM_PREFIXES):
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Name):
                out.add(arg.id)
            elif isinstance(arg, (ast.List, ast.Tuple)):
                for elt in arg.elts:
                    if isinstance(elt, ast.Name):
                        out.add(elt.id)
    return out


def _functions(tree: ast.Module) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _structural(fn: ast.FunctionDef, by_call: Set[str]) -> bool:
    return fn.name in by_call or any(_decorator_traced(d)
                                     for d in fn.decorator_list)


def traced_functions(path: str, tree: ast.Module
                     ) -> List[ast.FunctionDef]:
    """The functions in ``path`` on the round hot path."""
    module_traced = any(path.startswith(p) for p in TRACED_MODULE_PATHS)
    by_call = _names_passed_to_transforms(tree)
    return [fn for fn in _functions(tree)
            if module_traced or _structural(fn, by_call)]


def _host_torch(fname: str) -> bool:
    return fname.startswith(HOST_TORCH)


def _host_factory(node: ast.AST) -> bool:
    """``torch.zeros(n)``, ``torch.tensor(data)`` and the like without
    ``device=``: a tensor on the host."""
    if not isinstance(node, ast.Call):
        return False
    parts = (dotted_name(node.func) or "").split(".")
    return (len(parts) == 2 and parts[0] == "torch"
            and parts[1] in FACTORIES and _device_kw(node) is None)


def _tainted(node: ast.AST, env: Set[str]) -> bool:
    """Is this expression (derived from) a device value?"""
    if isinstance(node, ast.Attribute):
        if node.attr in STATIC_ATTRS:
            return False
        return _tainted(node.value, env)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in STATIC_METHODS:
            return False
        fname = dotted_name(node.func) or ""
        if fname.split(".")[0] in TRACED_ROOTS:
            return not (_host_torch(fname) or _host_factory(node))
        return (any(_tainted(a, env) for a in node.args)
                or any(_tainted(k.value, env) for k in node.keywords)
                or _tainted(node.func, env))
    if isinstance(node, ast.Name):
        return node.id in env
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.Lambda)):
        return False
    return any(_tainted(child, env)
               for child in ast.iter_child_nodes(node))


def _is_mask(node: ast.AST, env: Set[str], masks: Set[str]) -> bool:
    """A boolean tensor: a comparison of device values, a logical
    combination of masks, a mask-making torch call, or a mask local."""
    if isinstance(node, ast.Name):
        return node.id in masks
    if isinstance(node, ast.Compare):
        return any(_tainted(s, env) for s in [node.left] + node.comparators)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _is_mask(node.operand, env, masks)
    if isinstance(node, ast.BinOp) \
            and isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return (_is_mask(node.left, env, masks)
                or _is_mask(node.right, env, masks))
    if isinstance(node, ast.Call):
        fname = dotted_name(node.func) or ""
        last = fname.split(".")[-1]
        if fname.startswith("torch.") and last in MASK_CALLS:
            return True
        return (isinstance(node.func, ast.Attribute) and last in MASK_CALLS
                and _tainted(node.func.value, env))
    return False


def _subscript_mask(node: ast.Subscript, env: Set[str],
                    masks: Set[str]) -> bool:
    index = node.slice
    parts = index.elts if isinstance(index, ast.Tuple) else [index]
    return any(_is_mask(p, env, masks) for p in parts)


def _own_statements(fn: ast.FunctionDef) -> Iterator[ast.stmt]:
    """Statements of ``fn`` excluding nested def bodies (nested functions
    are analyzed on their own; attributing their hazards to the
    enclosing function would double-report)."""
    stack: List[ast.stmt] = list(fn.body)
    while stack:
        stmt = stack.pop(0)
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for field in ("body", "orelse", "finalbody", "handlers"):
            for child in getattr(stmt, field, []):
                if isinstance(child, ast.ExceptHandler):
                    stack.extend(child.body)
                elif isinstance(child, ast.stmt):
                    stack.append(child)


def _globals(fn: ast.FunctionDef) -> Set[str]:
    return {n for stmt in _own_statements(fn)
            if isinstance(stmt, ast.Global) for n in stmt.names}


def _local_names(fn: ast.FunctionDef) -> Set[str]:
    """Parameters plus every name the function binds. Only a bare name
    is bound: ``x[k] = v`` and ``x.a += 1`` write into ``x``, they do not
    make it local (and a ``global`` name is never local)."""
    names = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                             + fn.args.kwonlyargs)}
    for a in (fn.args.vararg, fn.args.kwarg):
        if a is not None:
            names.add(a.arg)
    for stmt in _own_statements(fn):
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign, ast.For)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.With):
            targets = [i.optional_vars for i in stmt.items
                       if i.optional_vars is not None]
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(stmt.name)
        for t in targets:
            for node in ast.walk(t):
                if isinstance(node, ast.Name) \
                        and isinstance(node.ctx, ast.Store):
                    names.add(node.id)
        for node in ast.walk(stmt):
            if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                 ast.GeneratorExp)):
                for gen in node.generators:
                    for n in ast.walk(gen.target):
                        if isinstance(n, ast.Name):
                            names.add(n.id)
            elif isinstance(node, ast.NamedExpr):
                names.add(node.target.id)
    return names - _globals(fn)


def _root_name(node: ast.AST) -> Optional[str]:
    """Peel ``x[i].y`` chains down to the root ``Name``."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _stmt_exprs(stmt: ast.stmt) -> Iterator[ast.expr]:
    """The statement's OWN expression children (child statements are
    visited separately by ``_own_statements`` — walking them here would
    double-report)."""
    for _field, value in ast.iter_fields(stmt):
        if isinstance(value, ast.expr):
            yield value
        elif isinstance(value, list):
            for item in value:
                if isinstance(item, ast.expr):
                    yield item


def _device_kw(node: ast.Call) -> Optional[ast.AST]:
    """The ``device=`` a torch constructor is given (``as_tensor``'s and
    ``asarray``'s third positional argument too), unless it is the CPU."""
    dev = next((kw.value for kw in node.keywords if kw.arg == "device"),
               None)
    fname = (dotted_name(node.func) or "").split(".")[-1]
    if dev is None and fname in {"as_tensor", "asarray"} \
            and len(node.args) >= 3:
        dev = node.args[2]
    if dev is None or _is_cpu(dev):
        return None
    return dev


def _is_cpu(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) \
            and (dotted_name(node.func) or "") == "torch.device":
        return bool(node.args) and _is_cpu(node.args[0])
    return False


def _on_host(node: ast.AST) -> bool:
    """A value a host copy just made (``x.cpu()``, ``x.numpy()``)."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and (node.func.attr in {"cpu", "numpy", "tolist"}
                 or (node.func.attr == "to"
                     and any(_is_cpu(a) for a in node.args))))


def _sync(node: ast.Call, env: Set[str], fn_name: str) -> Optional[str]:
    """RPA102's message when the call ``node`` syncs with the card."""
    fname = dotted_name(node.func) or ""
    parts = fname.split(".")
    args_tainted = any(_tainted(a, env) for a in node.args)
    method = node.func.attr if isinstance(node.func, ast.Attribute) else ""
    recv = node.func.value if method else None
    if parts[0] in CONCRETIZERS and len(parts) == 1 and args_tainted:
        return (f"`{fname}()` of a tensor in `{fn_name}` — brings its "
                f"value to the host, a sync with the card")
    if parts[0] in HOST_ROOTS and args_tainted:
        return (f"host `{fname}()` call on a tensor in `{fn_name}` — a "
                f"device-to-host copy; keep it in torch")
    if fname == "torch.cuda.synchronize":
        return (f"`torch.cuda.synchronize()` in `{fn_name}` — waits for "
                f"the card")
    if parts[0] == "torch" and len(parts) == 2:
        op = parts[1]
        if (op in SIZE_SYNC_OPS and not (
                op == "repeat_interleave"
                and any(kw.arg == "output_size" for kw in node.keywords))) \
                or (op == "where" and len(node.args) == 1):
            return (f"`{fname}` in `{fn_name}` — its result's size is "
                    f"data, so it waits for the card")
        if op in HOST_CONSTRUCTORS and _device_kw(node) is not None \
                and not (node.args and _tainted(node.args[0], env)):
            return (f"`{fname}` of host data onto a device in "
                    f"`{fn_name}` — a pageable host-to-device copy waits "
                    f"for the stream")
    if recv is None:
        return None
    if method in HOST_METHODS and _tainted(recv, env) \
            and not _on_host(recv):
        return (f"`.{method}()` on a tensor in `{fn_name}` — a "
                f"device-to-host copy, a sync with the card")
    if method == "to" and _tainted(recv, env) and any(
            _is_cpu(a) for a in list(node.args)
            + [kw.value for kw in node.keywords if kw.arg == "device"]):
        return (f"`.to(\"cpu\")` of a tensor in `{fn_name}` — a "
                f"device-to-host copy, a sync with the card")
    if method in SIZE_SYNC_OPS and _tainted(recv, env):
        return (f"`.{method}()` in `{fn_name}` — its result's size is "
                f"data, so it waits for the card")
    if method in {"to", "cuda"} and _host_factory(recv) and not any(
            kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
            and kw.value.value is True for kw in node.keywords) \
            and not any(_is_cpu(a) for a in node.args):
        return (f"`.{method}()` of a host tensor in `{fn_name}` — a "
                f"pageable host-to-device copy waits for the stream")
    return None


def _analyze_fn(path: str, fn: ast.FunctionDef
                ) -> Iterator[Tuple[str, ast.AST, str]]:
    """Yield (code, node, message) hazards for one hot-path function."""
    env: Set[str] = set()
    masks: Set[str] = set()
    locals_ = _local_names(fn)
    globals_ = _globals(fn)

    def note_assign(stmt: ast.stmt) -> None:
        value = getattr(stmt, "value", None)
        if value is None:
            return
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        names = [n.id for t in targets for n in ast.walk(t)
                 if isinstance(n, ast.Name)]
        if _tainted(value, env):
            env.update(names)
        if _is_mask(value, env, masks) and all(
                isinstance(t, ast.Name) for t in targets):
            masks.update(names)

    for stmt in _own_statements(fn):
        # RPA101 — Python control flow on a tensor
        if isinstance(stmt, (ast.If, ast.While)) \
                and _tainted(stmt.test, env):
            kind = "if" if isinstance(stmt, ast.If) else "while"
            yield ("RPA101", stmt.test,
                   f"Python `{kind}` on a tensor in `{fn.name}` — "
                   f"bool() of a CUDA tensor waits for the card; use "
                   f"torch.where or keep the condition on the host")
        elif isinstance(stmt, ast.Assert) and _tainted(stmt.test, env):
            yield ("RPA101", stmt.test,
                   f"`assert` on a tensor in `{fn.name}` — waits for the "
                   f"card; check a host-side precondition instead")

        # RPA102 — a host value written into a tensor by indexing: the
        # value is made on the host and copied to the card
        if isinstance(stmt, ast.Assign) and not _tainted(stmt.value, env):
            for t in stmt.targets:
                if isinstance(t, ast.Subscript) and _tainted(t.value, env):
                    yield ("RPA102", t,
                           f"host value written into a tensor by indexing "
                           f"in `{fn.name}` — copied from the host, a "
                           f"sync with the card; use fill_/index_fill_ "
                           f"or build it on the device")

        # RPA103 — assignment into module state (the statement itself;
        # mutator-method calls are caught in the expression walk)
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                root = _root_name(t)
                if isinstance(t, ast.Name):
                    root = t.id if t.id in globals_ else None
                elif root is not None and root in locals_:
                    root = None
                if root is not None:
                    yield ("RPA103", t,
                           f"hot-path `{fn.name}` writes into "
                           f"module-level `{root}` — state shared with "
                           f"every thread that runs rounds")

        exprs = [] if isinstance(stmt, (ast.FunctionDef,
                                        ast.AsyncFunctionDef,
                                        ast.ClassDef)) else \
            [n for e in _stmt_exprs(stmt) for n in ast.walk(e)]
        for node in exprs:
            if isinstance(node, ast.IfExp) and _tainted(node.test, env):
                yield ("RPA101", node.test,
                       f"conditional expression on a tensor in "
                       f"`{fn.name}` — bool() of a CUDA tensor waits for "
                       f"the card")
            # RPA102 — host sync
            if isinstance(node, ast.Call):
                msg = _sync(node, env, fn.name)
                if msg is not None:
                    yield ("RPA102", node, msg)
            elif isinstance(node, ast.Subscript) \
                    and _subscript_mask(node, env, masks):
                yield ("RPA102", node,
                       f"boolean-mask indexing in `{fn.name}` — the "
                       f"result's size is the mask's count, so it waits "
                       f"for the card; use torch.where")
            # RPA103 — mutator-method call on module state
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in MUTATORS:
                root = _root_name(node.func.value)
                if root is not None and root not in locals_:
                    yield ("RPA103", node,
                           f"hot-path `{fn.name}` calls "
                           f"`.{node.func.attr}()` on module-level "
                           f"`{root}` — state shared with every thread "
                           f"that runs rounds")

        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            note_assign(stmt)


def _run_family(project: Project, want: str) -> List[Finding]:
    from repro_torch.analysis.registry import get_rule
    rule = get_rule(want)
    out: List[Finding] = []
    for path, tree in project.walk():
        for fn in traced_functions(path, tree):
            for code, node, msg in _analyze_fn(path, fn):
                if code != want:
                    continue
                out.append(Finding(code, rule.name, path,
                                   getattr(node, "lineno", fn.lineno),
                                   getattr(node, "col_offset", 0) + 1,
                                   msg))
    return out


@register("RPA101", "traced-python-branch",
          "Python if/while/assert on a tensor in the round hot path")
def rpa101(project: Project) -> List[Finding]:
    return _run_family(project, "RPA101")


@register("RPA102", "traced-host-sync",
          ".item()/.cpu()/float()/np.*/masks/H2D copies syncing the round "
          "hot path with the card")
def rpa102(project: Project) -> List[Finding]:
    return _run_family(project, "RPA102")


@register("RPA103", "traced-closure-mutation",
          "hot-path function mutates module-level state")
def rpa103(project: Project) -> List[Finding]:
    return _run_family(project, "RPA103")


def _has_fault_boundary(project: Project, path: str,
                        fn: ast.FunctionDef) -> bool:
    """True when the def region (``def`` line through the first body
    line — where a multi-line signature's comment can sit) carries a
    ``# repro: fault-boundary`` annotation."""
    end = fn.body[0].lineno if fn.body else fn.lineno
    return any(FAULT_BOUNDARY_RE.search(project.line(path, ln))
               for ln in range(fn.lineno, end + 1))


@register("RPA106", "fault-injection-in-trace",
          "fault-injection API called inside the round hot path")
def rpa106(project: Project) -> List[Finding]:
    """Fault injection is a host-side concern: a ``FaultInjector`` /
    ``apply_round`` / ``inject_round_faults`` call inside the hot path
    would perturb a round before its results reach the host, where the
    replay from ``(plan, seed)`` cannot see it. Only functions in the
    hot-path module list may opt out (the boundary shim in
    ``core/pool.py`` is host-side code that merely *lives* in a hot-path
    module); structurally hot functions (compiled or transformed) never
    can."""
    from repro_torch.analysis.registry import get_rule
    rule = get_rule("RPA106")
    out: List[Finding] = []
    for path, tree in project.walk():
        module_traced = any(path.startswith(p)
                            for p in TRACED_MODULE_PATHS)
        by_call = _names_passed_to_transforms(tree)
        for fn in _functions(tree):
            structural = _structural(fn, by_call)
            if not (module_traced or structural):
                continue
            if not structural and _has_fault_boundary(project, path, fn):
                continue
            for stmt in _own_statements(fn):
                for expr in _stmt_exprs(stmt):
                    for node in ast.walk(expr):
                        if not isinstance(node, ast.Call):
                            continue
                        fname = dotted_name(node.func) or ""
                        if fname.split(".")[-1] not in FAULT_API:
                            continue
                        out.append(Finding(
                            "RPA106", rule.name, path, node.lineno,
                            node.col_offset + 1,
                            f"hot-path `{fn.name}` calls fault-injection "
                            f"API `{fname}` — inject at the host-side "
                            f"runner boundary (DESIGN.md §12), or mark "
                            f"a genuine boundary in a hot-path module "
                            f"with `# repro: fault-boundary`"))
    return out
