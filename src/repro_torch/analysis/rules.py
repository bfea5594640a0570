"""Repo-specific AST lint rules for the port (``python -m
repro_torch.analysis``): the JAX package's ``analysis/rules.py`` retargeted
to what a PyTorch step is.

A **step body** is code that runs once per step or tick and whose
structure a cache or a capture keeps:

* a def decorated with, or passed to, ``torch.compile``,
  ``torch.jit.script`` / ``trace``, ``torch.func.vmap`` / ``grad`` /
  ``functional_call`` (and the other ``torch.func`` transforms),
  ``torch.utils.checkpoint.checkpoint`` or
  ``torch.cuda.make_graphed_callables``, and the block of a
  ``with torch.cuda.graph(...)`` capture;
* ``forward`` / ``backward`` of a ``torch.autograd.Function``;
* the per-tick executor methods of :data:`TICK_BODIES` (the host
  executor's step, run and sync, the mesh executor's syncs, the LM
  step);
* anything those call in the same file, by bare name or as a method of
  ``self`` (the closure is taken to a fixed point, as in the reference).

Names are resolved through the file's imports (``from torch.utils.
checkpoint import checkpoint`` makes a bare ``checkpoint(f, ...)`` the
transform).

Rule catalog:

``wall-clock-in-trace``
    No ``time.time()`` / ``time.perf_counter()`` / ``datetime.now()``
    inside a step body: a compiled or captured body bakes the value in,
    and an eager tick that reads the clock mid-step times work it has
    not synchronized (time around the call instead).  The reference's
    name, so one waiver set serves both lints.
``python-random-in-trace``
    No Python-level ``random.*`` / ``np.random.*`` inside a step body:
    it breaks the replayable threefry key discipline that makes the port
    bit-comparable with the reference (and a capture bakes the draw in).
``static-operand-capture``
    Runtime operands (``lam``/``lr``/``local_h``/``periods``/
    ``participation``/``acceleration``) must reach a step body as
    ARGUMENTS, never as closure captures: a body kept by the executor
    cache (``core/engine/host.py::get_host_executor``, LRU 32) bakes in
    the first sweep point's value, and ``torch.compile`` guards on it.
``compile-outside-engine``
    ``torch.compile``, ``torch.jit.*`` and CUDA-graph capture belong in
    ``core/engine`` and ``kernels`` (plus waived call sites): a stray
    compile or capture dodges the executor caches and their accounting.
``host-sync-in-tick``
    No ``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` /
    ``torch.cuda.synchronize()`` inside a tick body (:data:`TICK_BODIES`
    and what they call): each stalls the host on the card once a tick.
    ``torch.cuda.set_sync_debug_mode("error")`` (strict mode's guard)
    does not see every synchronizing operation; this rule is the static
    half.
``mutable-default-in-frozen-dataclass``
    No mutable literal defaults in frozen dataclasses; plans and configs
    are hashed/compared, and a shared mutable default aliases state
    across instances.

The reference's ``undonated-carry`` has no counterpart: eager PyTorch has
no buffer donation (the executors update their carries in place).

Waivers: append ``# analysis: allow(<rule-name>)`` and a reason on the
offending line (or the ``def``/``class`` line that owns the body).
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

PORT_PREFIX = "src/repro_torch/"
# directories whose files may compile and capture freely (the engine owns
# the executor caches; kernels wrap their own dispatch)
COMPILE_ALLOWED_PREFIXES = ("src/repro_torch/core/engine/",
                            "src/repro_torch/kernels/")

WALLCLOCK_CALLS = {
    ("time", "time"), ("time", "perf_counter"), ("time", "monotonic"),
    ("time", "process_time"), ("datetime", "now"), ("datetime", "utcnow"),
}
PYRANDOM_MODULES = {"random"}
NUMPY_RANDOM_ATTR = "random"   # np.random.* inside a step body
RUNTIME_OPERANDS = {"lam", "lr", "local_h", "periods", "participation",
                    "acceleration"}
HOST_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
HOST_SYNC_CALLS = {"torch.cuda.synchronize"}

# transforms whose function argument becomes a step body
STEP_TRANSFORMS = {
    "torch.compile",
    "torch.jit.script", "torch.jit.trace", "torch.jit.script_method",
    "torch.func.vmap", "torch.vmap", "torch.func.grad",
    "torch.func.grad_and_value", "torch.func.vjp", "torch.func.jvp",
    "torch.func.jacrev", "torch.func.jacfwd", "torch.func.hessian",
    "torch.func.functional_call", "torch.func.functionalize",
    "torch.utils.checkpoint.checkpoint",
    "torch.cuda.make_graphed_callables",
}
# compile / capture entry points (the compile-outside-engine rule)
COMPILE_CALLS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.jit.script_method", "torch.jit.trace_module",
    "torch.cuda.graph", "torch.cuda.CUDAGraph",
    "torch.cuda.make_graphed_callables",
}
GRAPH_CONTEXTS = {"torch.cuda.graph"}
AUTOGRAD_FUNCTION_BASES = {"torch.autograd.Function"}

# the per-tick executor methods: file (under src/repro_torch/) -> Class.method
TICK_BODIES: Dict[str, Set[str]] = {
    "core/engine/host.py": {"HostExecutor.step", "HostExecutor._run",
                            "HostExecutor._sync"},
    "core/engine/mesh.py": {"MeshExecutor._sync", "MeshExecutor._sync_rs",
                            "MeshExecutor._group_sum"},
    "core/engine/lm.py": {"LMStep.__call__", "LMStep.local_step",
                          "LMStep.sync_level", "BatchedLMStep.__call__"},
}

_ALLOW_PREFIX = "# analysis: allow("
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _waivers(source: str) -> dict:
    """line number -> set of waived rule names."""
    out: dict = {}
    for i, line in enumerate(source.splitlines(), start=1):
        idx = line.find(_ALLOW_PREFIX)
        if idx < 0:
            continue
        inner = line[idx + len(_ALLOW_PREFIX):]
        inner = inner.split(")", 1)[0]
        out[i] = {r.strip() for r in inner.split(",") if r.strip()}
    return out


def _call_name(node: ast.AST) -> Optional[str]:
    """Dotted name of an expression, e.g. ``torch.compile``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _imports(tree: ast.Module) -> Dict[str, str]:
    """Local name -> the dotted name it was imported as."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _rel(path: str) -> str:
    """``path`` from ``src/repro_torch/`` on (or as it is)."""
    norm = path.replace("\\", "/")
    anchor = norm.find(PORT_PREFIX)
    return norm[anchor:] if anchor >= 0 else norm


class _Analyzer(ast.NodeVisitor):
    """Single-pass file analyzer: step-body discovery (module docstring),
    then the rules."""

    def __init__(self, path: str, tree: ast.Module, source: str):
        self.path = path
        self.rel = _rel(path)
        self.tree = tree
        self.waivers = _waivers(source)
        self.aliases = _imports(tree)
        self.findings: List[LintFinding] = []
        self.step_defs: Set[ast.AST] = set()
        self.tick_defs: Set[ast.AST] = set()
        self.graph_blocks: List[ast.With] = []
        self._parents: dict = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    def _resolve(self, node: ast.AST) -> Optional[str]:
        """The dotted name of an expression through the file's imports."""
        name = _call_name(node)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        full = self.aliases.get(head)
        if full is None:
            return name
        return f"{full}.{rest}" if rest else full

    def _is_transform(self, node: ast.AST) -> bool:
        """Is ``node`` (a decorator or a call's function) a step
        transform, bare or called (``@torch.compile(mode=...)``) or
        through ``functools.partial``?"""
        if self._resolve(node) in STEP_TRANSFORMS:
            return True
        if isinstance(node, ast.Call):
            fn = self._resolve(node.func)
            if fn in STEP_TRANSFORMS:
                return True
            if fn in ("functools.partial", "partial") and node.args:
                return self._is_transform(node.args[0])
        return False

    # -- helpers ---------------------------------------------------------
    def _emit(self, rule: str, node: ast.AST, message: str,
              owner: Optional[ast.AST] = None):
        lines = {getattr(node, "lineno", 0)}
        if owner is not None:
            lines.add(getattr(owner, "lineno", 0))
        for ln in lines:
            if rule in self.waivers.get(ln, ()):
                return
        self.findings.append(
            LintFinding(rule, self.path, getattr(node, "lineno", 0),
                        message))

    def _class_of(self, node: ast.AST) -> Optional[ast.ClassDef]:
        p = self._parents.get(node)
        return p if isinstance(p, ast.ClassDef) else None

    # -- step-body discovery ---------------------------------------------
    def collect(self):
        named_defs: Dict[str, ast.AST] = {}
        methods: Dict[str, List[ast.AST]] = {}
        tick_names = TICK_BODIES.get(self.rel[len(PORT_PREFIX):], set()) \
            if self.rel.startswith(PORT_PREFIX) else set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.With) and any(
                    isinstance(it.context_expr, ast.Call)
                    and self._resolve(it.context_expr.func)
                    in GRAPH_CONTEXTS for it in node.items):
                self.graph_blocks.append(node)
            if not isinstance(node, _DEFS):
                continue
            cls = self._class_of(node)
            if cls is None:
                named_defs.setdefault(node.name, node)
            else:
                methods.setdefault(node.name, []).append(node)
                if f"{cls.name}.{node.name}" in tick_names:
                    self.tick_defs.add(node)
                if node.name in ("forward", "backward") and any(
                        self._resolve(b) in AUTOGRAD_FUNCTION_BASES
                        for b in cls.bases):
                    self.step_defs.add(node)
            if any(self._is_transform(d) for d in node.decorator_list):
                self.step_defs.add(node)
        # names passed into step transforms
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Call)
                    and self._resolve(node.func) in STEP_TRANSFORMS):
                continue
            for arg in node.args[:1]:
                if isinstance(arg, ast.Name):
                    self.step_defs.update(
                        d for d in ast.walk(self.tree)
                        if isinstance(d, _DEFS) and d.name == arg.id
                        and self._class_of(d) is None)
                elif isinstance(arg, ast.Lambda):
                    self.step_defs.add(arg)
        calls_in: Dict[ast.AST, Set[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, _DEFS + (ast.Lambda,)):
                body = node.body if not isinstance(node, ast.Lambda) \
                    else [node.body]
                calls_in[node] = self._callees(body, named_defs, methods)
        graph_callees: Set[ast.AST] = set()
        for blk in self.graph_blocks:
            graph_callees |= self._callees(blk.body, named_defs, methods)
        self.step_defs |= graph_callees
        self.step_defs |= self.tick_defs
        self._close(self.step_defs, calls_in)
        self._close(self.tick_defs, calls_in)

    def _callees(self, body, named_defs, methods) -> Set[ast.AST]:
        """Same-file defs called in ``body``: by bare name, or as
        ``self.<method>``."""
        out: Set[ast.AST] = set()
        for stmt in body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                f = sub.func
                if isinstance(f, ast.Name) and f.id in named_defs:
                    out.add(named_defs[f.id])
                elif isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id == "self":
                    out.update(methods.get(f.attr, ()))
        return out

    def _close(self, defs: Set[ast.AST], calls_in) -> None:
        """Close ``defs`` over nesting and same-file calls."""
        changed = True
        while changed:
            changed = False
            for node in ast.walk(self.tree):
                if isinstance(node, _DEFS + (ast.Lambda,)) and \
                        node not in defs and self._enclosed(node, defs):
                    defs.add(node)
                    changed = True
            for caller in list(defs):
                for callee in calls_in.get(caller, ()):
                    if callee not in defs:
                        defs.add(callee)
                        changed = True

    def _enclosed(self, node: ast.AST, defs: Set[ast.AST]) -> bool:
        p = self._parents.get(node)
        while p is not None:
            if p in defs:
                return True
            p = self._parents.get(p)
        return False

    def _owning_def(self, node: ast.AST) -> Optional[ast.AST]:
        p = self._parents.get(node)
        while p is not None:
            if isinstance(p, _DEFS + (ast.Lambda,)):
                return p
            p = self._parents.get(p)
        return None

    def _in(self, node: ast.AST, defs: Set[ast.AST],
            blocks=()) -> Optional[ast.AST]:
        """The body of ``defs`` (or a capture block) ``node`` runs in."""
        p = self._parents.get(node)
        while p is not None:
            if p in defs or p in blocks:
                return p
            p = self._parents.get(p)
        return None

    def _in_step(self, node: ast.AST) -> Optional[ast.AST]:
        return self._in(node, self.step_defs, self.graph_blocks)

    # -- rules -----------------------------------------------------------
    def run(self) -> List[LintFinding]:
        self.collect()
        self._rule_step_bodies()
        self._rule_static_capture()
        self._rule_host_sync()
        self._rule_compile_location()
        self._rule_frozen_defaults()
        return self.findings

    def _rule_step_bodies(self):
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            owner = self._in_step(node)
            if owner is None:
                continue
            fn = self._resolve(node.func)
            if fn is None:
                continue
            parts = tuple(fn.split("."))
            if len(parts) >= 2 and parts[-2:] in WALLCLOCK_CALLS:
                self._emit(
                    "wall-clock-in-trace", node,
                    f"{fn}() inside a step body: a compiled or captured "
                    "body bakes the value in, and a tick reading the clock "
                    "mid-step times unsynchronized work; time around the "
                    "call instead", owner)
            if parts[0] in PYRANDOM_MODULES or \
                    (len(parts) >= 2 and parts[0] in ("np", "numpy")
                     and parts[1] == NUMPY_RANDOM_ATTR):
                self._emit(
                    "python-random-in-trace", node,
                    f"{fn}() inside a step body breaks the replayable "
                    "threefry key discipline (core/prng.py); thread a key "
                    "in as an operand", owner)

    def _rule_static_capture(self):
        """A load of a runtime operand inside a step body is fine when the
        nearest enclosing def BINDING the name is itself a step body (the
        value is an operand there); it is the bug when the binder is a
        function that builds the body, or the module scope."""
        for sub in ast.walk(self.tree):
            if not (isinstance(sub, ast.Name)
                    and isinstance(sub.ctx, ast.Load)
                    and sub.id in RUNTIME_OPERANDS):
                continue
            owner = self._in_step(sub)
            if owner is None:
                continue
            binder = None
            d = self._owning_def(sub)
            while d is not None:
                if sub.id in _bound_names(d):
                    binder = d
                    break
                d = self._owning_def(d)
            if binder is not None and binder in self.step_defs:
                continue
            self._emit(
                "static-operand-capture", sub,
                f"step body closes over runtime operand {sub.id!r} from "
                "outside it: a body kept by the executor cache (or "
                "compiled) holds the first value, so every later sweep "
                "point runs with it (pass it as an argument)", owner)

    def _rule_host_sync(self):
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            owner = self._in(node, self.tick_defs)
            if owner is None:
                continue
            f = node.func
            name = self._resolve(f)
            if name in HOST_SYNC_CALLS or (
                    isinstance(f, ast.Attribute)
                    and f.attr in HOST_SYNC_METHODS and not node.args):
                what = name if name in HOST_SYNC_CALLS else f".{f.attr}()"
                self._emit(
                    "host-sync-in-tick", node,
                    f"{what} inside a tick body stalls the host on the "
                    "card every tick; keep values on the device, or move "
                    "the read out of the loop", owner)

    def _rule_compile_location(self):
        if not self.rel.startswith(PORT_PREFIX):
            return
        if any(self.rel.startswith(p) for p in COMPILE_ALLOWED_PREFIXES):
            return
        decorators = set()
        for node in ast.walk(self.tree):
            if isinstance(node, _DEFS):
                for dec in node.decorator_list:
                    decorators.add(id(dec))
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    if self._resolve(target) in COMPILE_CALLS:
                        self._emit("compile-outside-engine", dec,
                                   _COMPILE_MSG, node)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and id(node) not in decorators \
                    and self._resolve(node.func) in COMPILE_CALLS:
                self._emit("compile-outside-engine", node, _COMPILE_MSG)

    def _rule_frozen_defaults(self):
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            frozen = False
            for dec in node.decorator_list:
                name = _call_name(dec.func if isinstance(dec, ast.Call)
                                  else dec)
                if name in ("dataclasses.dataclass", "dataclass") and \
                        isinstance(dec, ast.Call):
                    for kw in dec.keywords:
                        if kw.arg == "frozen" and \
                                isinstance(kw.value, ast.Constant) and \
                                kw.value.value is True:
                            frozen = True
            if not frozen:
                continue
            for stmt in node.body:
                if not isinstance(stmt, ast.AnnAssign) or stmt.value is None:
                    continue
                if isinstance(stmt.value, (ast.List, ast.Dict, ast.Set)) or \
                        (isinstance(stmt.value, ast.Call)
                         and _call_name(stmt.value.func) in
                         ("list", "dict", "set", "bytearray")):
                    self._emit(
                        "mutable-default-in-frozen-dataclass", stmt,
                        "mutable literal default in a frozen dataclass: "
                        "the object is shared across every instance (and "
                        "frozen classes are hashed/compared as values); "
                        "use dataclasses.field(default_factory=...) or a "
                        "tuple", node)


_COMPILE_MSG = (
    "torch.compile / torch.jit / CUDA-graph capture outside core/engine + "
    "kernels: a stray compile or capture dodges the executor caches and "
    "their accounting.  Route through the engine executors, or waive with "
    "'# analysis: allow(compile-outside-engine)' and a reason")


def _bound_names(fn) -> Set[str]:
    """Names bound in ``fn``'s OWN scope: parameters plus assignments
    directly in its body (nested defs contribute their name, not their
    locals)."""
    out: Set[str] = set()
    args = fn.args
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)):
        out.add(a.arg)
    if args.vararg:
        out.add(args.vararg.arg)
    if args.kwarg:
        out.add(args.kwarg.arg)
    if isinstance(fn, ast.Lambda):
        return out
    stack = list(fn.body)
    while stack:
        sub = stack.pop()
        if isinstance(sub, _DEFS):
            out.add(sub.name)
            continue  # its locals are its own scope
        if isinstance(sub, ast.Lambda):
            continue
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
            out.add(sub.id)
        stack.extend(ast.iter_child_nodes(sub))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def lint_file(path: str) -> List[LintFinding]:
    """All rule findings for one Python source file."""
    source = Path(path).read_text()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [LintFinding("syntax-error", path, e.lineno or 0, str(e))]
    return _Analyzer(path, tree, source).run()


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        pp = Path(p)
        if pp.is_file() and pp.suffix == ".py":
            yield str(pp)
        elif pp.is_dir():
            for f in sorted(pp.rglob("*.py")):
                if "__pycache__" in f.parts:
                    continue
                yield str(f)


def lint_paths(paths: Sequence[str]) -> List[LintFinding]:
    """Run every rule over all ``.py`` files under ``paths``."""
    out: List[LintFinding] = []
    for f in iter_python_files(paths):
        out.extend(lint_file(f))
    return out
