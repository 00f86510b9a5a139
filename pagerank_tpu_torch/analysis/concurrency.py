"""Concurrency-plane static analysis — thread/signal-context race rules
(PTR).

Copy of ``pagerank_tpu/analysis/concurrency.py`` over the port's
package (pure ``ast`` there too; this copy imports nothing of the JAX
package). The rules are unchanged; the host-side names they know gain
torch's (``torch.cuda.synchronize`` blocks, a handler may not call
into ``torch.``), and the package prefix is ``pagerank_tpu_torch.``.

The repo runs six host-side thread roots around the solve (rank-writer,
stall watchdog, metrics HTTP server, deadline dispatch, liveness
probes) plus a SIGTERM drain handler, and the staged async-iteration
work (arXiv:cs/0606047) deliberately adds relaxed-consistency
concurrency on top. Every cross-thread invariant was defended only by
hand-written tests; this pass makes concurrency discipline a GATED
artifact like lane geometry (PTL) and collective budgets (PTC/PTH).

The pass is whole-program and imports nothing but the standard library
(pure ``ast``):

1. parse every package module and build an approximate CALL GRAPH
   (name/import/annotation-based resolution — ``self`` methods, typed
   attributes, package imports, constructor return types; unresolvable
   calls stay unresolved, so the graph UNDER-approximates reach);
2. infer EXECUTION CONTEXTS: the main thread (implicit), one context
   per ``threading.Thread(target=...)`` root (labelled by the
   ``name=`` literal), one per signal-handler installation
   (:mod:`pagerank_tpu_torch.analysis.roots` — the SAME source of truth
   PTL008 scopes by), and the ``BaseHTTPRequestHandler`` heuristic for
   server threads whose target is an external ``serve_forever``;
3. track per-context state accesses — ``self._x`` attributes keyed
   ``(Class, attr)`` and module-global rebindings — together with
   lexical LOCK SCOPES (``with self._lock:`` over
   ``threading.Lock/RLock/Condition``, instance or module-global);
4. enforce the six PTR rules (README.md's rule catalogue; the JAX
   package's docs/ANALYSIS.md has their provenance).

Precision notes (documented, deliberate): a function reachable from no
thread/signal root is attributed to ``main``; construction-phase
accesses (``__init__``) are exempt from PTR001 — writes that complete
before ``Thread.start()`` are published by the start's happens-before;
attributes bound to threading primitives (locks, events, queues,
``threading.local``) are exempt as state — they ARE the
synchronization. Findings flow through the same
``findings.py``/``allowlist.txt`` machinery as PTL/PTC: benign races
get waivers WITH REASONS, never rule carve-outs.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from pagerank_tpu_torch.analysis import roots as roots_mod
from pagerank_tpu_torch.analysis.findings import Finding
from pagerank_tpu_torch.analysis.lint import iter_python_files, package_root

MAIN = "main"

# attr kinds recognized from construction-time assignments. "lock"
# participates in guard analysis; every non-"plain" kind is exempt
# from PTR001 (the binding IS the synchronization primitive).
_LOCK_CTORS = ("threading.Lock", "threading.RLock", "threading.Condition")
_SYNC_CTORS = ("threading.Event", "threading.Semaphore",
               "threading.BoundedSemaphore", "threading.Barrier",
               "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
               "queue.PriorityQueue")
_LOCAL_CTORS = ("threading.local",)

# Dotted spellings (import-canonicalized) that BLOCK the calling
# thread: the PTR004 set, shared with PTR003's handler scan.
_BLOCKING_EXACT = {
    "time.sleep", "jax.device_get", "jax.block_until_ready",
    "torch.cuda.synchronize",
    "subprocess.run", "subprocess.check_output", "subprocess.check_call",
    "os.waitpid", "select.select",
}
_BLOCKING_SUFFIX = (".deadline_device_get", ".run_with_deadline")

# Filesystem / network I/O (blocking under a lock; forbidden outright
# in a signal-handler closure).
_IO_EXACT = {"open", "print", "os.write", "json.dump", "warnings.warn"}
_IO_SUFFIX = (".fopen", ".atomic_write", ".makedirs", ".listdir",
              ".savez", ".savez_compressed", ".urlopen")
_IO_SYS_WRITE = ("sys.stdout.write", "sys.stderr.write")

# Raw-clock spellings PTR006 bans in context-reachable code (the
# injectable clock/sleep idiom — utils/retry.py — is the fix; a
# DEFAULT-argument reference is not a call and never flags).
_RAW_CLOCK = {"time.time", "time.monotonic", "time.sleep",
              "time.perf_counter", "time.process_time"}

StateKey = Tuple[str, str, str]  # ("attr", Class, name) | ("global", mod, name)
LockKey = Tuple[str, str, str]

# Container methods that mutate their receiver — a call through one is
# a WRITE of the container binding (PTR001).
_MUTATORS = frozenset((
    "append", "extend", "insert", "clear", "update", "setdefault",
    "pop", "popitem", "add", "discard", "remove",
))


# The shared dotted-name resolver (analysis/roots.py): root discovery
# and this call graph must spell names identically.
_dotted = roots_mod.dotted_name


def _snippet(lines: List[str], lineno: int) -> str:
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1].strip()
    return ""


def _const_str(node: Optional[ast.expr]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


@dataclass
class Access:
    key: StateKey
    write: bool
    line: int
    col: int
    locks: FrozenSet[LockKey]
    func: "FuncInfo"
    in_init: bool


@dataclass
class CallSite:
    name: str                    # import-canonicalized dotted spelling
    raw: str                     # as written
    node: ast.Call
    line: int
    col: int
    locks: FrozenSet[LockKey]
    func: "FuncInfo"


@dataclass
class Acquire:
    lock: LockKey
    line: int
    col: int
    held: FrozenSet[LockKey]     # locks already held at this acquire
    func: "FuncInfo"
    is_with: bool                # with-statement scope vs bare .acquire()


@dataclass
class FuncInfo:
    qual: str
    rel: str
    cls: Optional[str]
    name: str
    node: ast.AST
    lineno: int
    calls: List[CallSite] = field(default_factory=list)
    accesses: List[Access] = field(default_factory=list)
    acquires: List[Acquire] = field(default_factory=list)
    nested: List[str] = field(default_factory=list)  # nested def quals


@dataclass
class ThreadSite:
    label: str
    roots: List[str]             # root function quals (may be empty)
    daemon: Optional[bool]       # literal daemon kwarg; None = absent
    func: "FuncInfo"             # creating function
    line: int
    col: int
    target_spelling: str
    stored_attr: Optional[str]   # self.X the Thread is stored under
    stored_local: Optional[str]  # local var it is stored under


@dataclass
class ClassInfo:
    name: str
    rel: str
    node: ast.ClassDef
    bases: List[str]
    methods: Dict[str, FuncInfo] = field(default_factory=dict)
    attr_kinds: Dict[str, str] = field(default_factory=dict)  # lock/sync/local/thread
    attr_types: Dict[str, str] = field(default_factory=dict)  # attr -> ClassName


@dataclass
class ModuleInfo:
    rel: str
    report_as: str
    tree: ast.Module
    lines: List[str]
    imports: Dict[str, str] = field(default_factory=dict)   # alias -> dotted/rel
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    functions: Dict[str, FuncInfo] = field(default_factory=dict)
    global_names: Set[str] = field(default_factory=set)
    global_kinds: Dict[str, str] = field(default_factory=dict)
    global_types: Dict[str, str] = field(default_factory=dict)  # name -> Class


class Program:
    """The parsed whole-program view the PTR rules run over."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, List[ClassInfo]] = {}  # name -> defs
        self.thread_sites: List[ThreadSite] = []
        self.signal_roots: List[Tuple[str, str]] = []  # (label, root qual)
        self.contexts: Dict[str, Set[str]] = {}        # qual -> root labels
        self._resolve_memo: Dict[Tuple[str, str], Tuple[str, ...]] = {}


# -- module scanning --------------------------------------------------------


_PKG_PREFIX = "pagerank_tpu_torch."


def _module_rel_of(dotted: str) -> Optional[str]:
    """'pagerank_tpu_torch.obs.metrics' -> 'obs/metrics.py' (None for
    external modules)."""
    if dotted == "pagerank_tpu_torch":
        return "__init__.py"
    if not dotted.startswith(_PKG_PREFIX):
        return None
    return dotted[len(_PKG_PREFIX):].replace(".", "/") + ".py"


def _scan_imports(tree: ast.AST, imports: Dict[str, str]) -> None:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                alias = a.asname or a.name.split(".")[0]
                imports[alias] = a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                alias = a.asname or a.name
                imports[alias] = node.module + "." + a.name


def _ctor_kind(value: ast.expr, imports: Dict[str, str]) -> Optional[str]:
    """lock/sync/local/thread when ``value`` constructs a threading
    primitive (import-alias aware), else None."""
    if not isinstance(value, ast.Call):
        # `a if cond else b` — either branch constructing a primitive
        # makes the attribute that primitive's binding.
        if isinstance(value, ast.IfExp):
            return (_ctor_kind(value.body, imports)
                    or _ctor_kind(value.orelse, imports))
        return None
    name = _canonical_name(_dotted(value.func), imports)
    if name in _LOCK_CTORS:
        return "lock"
    if name in _SYNC_CTORS:
        return "sync"
    if name in _LOCAL_CTORS:
        return "local"
    if name == "threading.Thread":
        return "thread"
    return None


def _canonical_name(dotted: str, imports: Dict[str, str]) -> str:
    """Rewrite the leading alias through the import map:
    ``_time.monotonic`` -> ``time.monotonic``, ``obs_metrics.counter``
    -> ``pagerank_tpu_torch.obs.metrics.counter``."""
    if not dotted:
        return dotted
    head, _, rest = dotted.partition(".")
    target = imports.get(head)
    if target is None:
        return dotted
    return target + ("." + rest if rest else "")


class _FuncVisitor(ast.NodeVisitor):
    """One function body -> calls, state accesses, lock scopes. Nested
    defs are recorded (and scanned as their own FuncInfo by the module
    scan), not walked here."""

    def __init__(self, prog: Program, mod: ModuleInfo, fi: FuncInfo,
                 cls: Optional[ClassInfo], local_names: Set[str],
                 imports: Dict[str, str]):
        self.prog = prog
        self.mod = mod
        self.fi = fi
        self.cls = cls
        self.local_names = local_names
        self.imports = imports
        self.held: Tuple[LockKey, ...] = ()
        # Construction-phase exemption (PTR001): __init__ runs before
        # Thread.start() publishes, and module BODIES run at import
        # time before any thread exists.
        self.in_init = fi.name in ("__init__", "<module>")

    # -- helpers ----------------------------------------------------------

    def _lock_key(self, expr: ast.expr) -> Optional[LockKey]:
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and self.cls is not None):
            if self.cls.attr_kinds.get(expr.attr) == "lock":
                return ("attr", self.cls.name, expr.attr)
        elif isinstance(expr, ast.Name):
            if self.mod.global_kinds.get(expr.id) == "lock":
                return ("global", self.mod.rel, expr.id)
        return None

    def _record_access(self, key: StateKey, write: bool,
                       node: ast.AST) -> None:
        self.fi.accesses.append(Access(
            key=key, write=write, line=node.lineno, col=node.col_offset,
            locks=frozenset(self.held), func=self.fi,
            in_init=self.in_init,
        ))

    # -- structure --------------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass  # nested defs are scanned separately (encloser edge added)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        pass  # nested classes are scanned by the module pass

    def visit_With(self, node: ast.With) -> None:
        keys = []
        for item in node.items:
            k = self._lock_key(item.context_expr)
            if k is not None:
                keys.append(k)
                self.fi.acquires.append(Acquire(
                    lock=k, line=node.lineno, col=node.col_offset,
                    held=frozenset(self.held), func=self.fi, is_with=True,
                ))
            # The context expression itself (e.g. a call) still scans.
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        prev = self.held
        self.held = prev + tuple(keys)
        for stmt in node.body:
            self.visit(stmt)
        self.held = prev

    def visit_Call(self, node: ast.Call) -> None:
        raw = _dotted(node.func)
        if not raw and isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Call):
            # Chained call — `counter(...).inc()`: record it so the
            # resolver can chase the inner call's return annotation.
            inner = _dotted(node.func.value.func)
            if inner:
                raw = f"{inner}().{node.func.attr}"
        name = _canonical_name(raw, self.imports)
        if raw:
            self.fi.calls.append(CallSite(
                name=name, raw=raw, node=node, line=node.lineno,
                col=node.col_offset, locks=frozenset(self.held),
                func=self.fi,
            ))
            if raw.endswith(".acquire") and isinstance(node.func,
                                                       ast.Attribute):
                k = self._lock_key(node.func.value)
                if k is not None:
                    self.fi.acquires.append(Acquire(
                        lock=k, line=node.lineno, col=node.col_offset,
                        held=frozenset(self.held), func=self.fi,
                        is_with=False,
                    ))
            # Container mutation through a method — `self.dropped
            # .append(...)`, `self._metrics.clear()` — is a WRITE of
            # the container binding for PTR001 purposes.
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS:
                base = node.func.value
                if (isinstance(base, ast.Attribute)
                        and isinstance(base.value, ast.Name)
                        and base.value.id == "self"
                        and self.cls is not None):
                    self._record_access(
                        ("attr", self.cls.name, base.attr), True, node)
                elif isinstance(base, ast.Name):
                    self._name_access_mutation(base)
        self.generic_visit(node)

    def _name_access_mutation(self, node: ast.Name) -> None:
        if node.id in self.mod.global_names and (
                node.id not in self.local_names
                or node.id in self._declared_global()):
            self._record_access(("global", self.mod.rel, node.id),
                                True, node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # `self.buckets[key] = n` / `GLOBAL[k] = v`: a subscript store
        # mutates the CONTAINER — record a write of its binding.
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            base = node.value
            if (isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self" and self.cls is not None):
                self._record_access(("attr", self.cls.name, base.attr),
                                    True, node)
            elif isinstance(base, ast.Name):
                self._name_access_mutation(base)
        self.generic_visit(node)

    # -- state accesses ---------------------------------------------------

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.value, ast.Name) and node.value.id == "self"
                and self.cls is not None):
            write = isinstance(node.ctx, (ast.Store, ast.Del))
            self._record_access(("attr", self.cls.name, node.attr),
                                write, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        # `self.x += 1` parses the target as Store; it is BOTH a read
        # and a write — record the read too.
        t = node.target
        if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "self" and self.cls is not None):
            self._record_access(("attr", self.cls.name, t.attr), False, t)
        elif isinstance(t, ast.Name):
            self._name_access(t, write=False)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        self._name_access(node, write=isinstance(node.ctx,
                                                 (ast.Store, ast.Del)))
        self.generic_visit(node)

    def _name_access(self, node: ast.Name, write: bool) -> None:
        name = node.id
        if name not in self.mod.global_names:
            return
        if name in self.local_names and name not in self._declared_global():
            return
        if write and name not in self._declared_global():
            return  # a local shadowing assignment, not a global write
        self._record_access(("global", self.mod.rel, name), write, node)

    def _declared_global(self) -> Set[str]:
        decl = getattr(self.fi, "_globals_decl", None)
        if decl is None:
            decl = set()
            for n in ast.walk(self.fi.node):
                if isinstance(n, ast.Global):
                    decl.update(n.names)
            self.fi._globals_decl = decl  # type: ignore[attr-defined]
        return decl


def _fn_prelude(fn: ast.AST) -> Tuple[Set[str], Dict[str, str]]:
    """ONE walk over ``fn``: (locally bound names, function-level
    import overlay). Local names (params, assignments, for targets,
    with-as, imports, comprehension targets, nested defs) are never
    module-global accesses; function-level imports overlay the module
    map for canonicalization."""
    out: Set[str] = set()
    overlay: Dict[str, str] = {}
    args = fn.args  # type: ignore[attr-defined]
    for a in (args.posonlyargs + args.args + args.kwonlyargs):
        out.add(a.arg)
    if args.vararg:
        out.add(args.vararg.arg)
    if args.kwarg:
        out.add(args.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Store):
                out.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            if node is not fn:
                out.add(node.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                alias = a.asname or a.name.split(".")[0]
                out.add(alias)
                overlay[alias] = (a.name if a.asname
                                  else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                alias = a.asname or a.name
                out.add(alias.split(".")[0])
                if node.module and not node.level:
                    overlay[alias] = node.module + "." + a.name
    return out, overlay


def _ann_class(ann: Optional[ast.expr]) -> Optional[str]:
    """'Snapshotter' from ``x: Snapshotter`` / ``x:
    Optional[Snapshotter]`` — the parameter-annotation typing the attr
    tracker uses."""
    if ann is None:
        return None
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Subscript):  # Optional[X] / "Optional[X]"
        inner = ann.slice
        if isinstance(inner, ast.Name):
            return inner.id
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        name = ann.value.strip()
        if name.startswith("Optional[") and name.endswith("]"):
            name = name[len("Optional["):-1]
        return name if name.isidentifier() else None
    return None


def _scan_class(prog: Program, mod: ModuleInfo, cls: ast.ClassDef,
                qual_prefix: str) -> ClassInfo:
    ci = ClassInfo(name=cls.name, rel=mod.rel, node=cls,
                   bases=[_canonical_name(_dotted(b), mod.imports)
                          for b in cls.bases])
    # attr kinds/types from class-body and every method's
    # `self.X = ...` assignments (Tracer builds its lock in __init__;
    # dataclass fields ride the class body).
    for item in cls.body:
        if isinstance(item, ast.Assign) and len(item.targets) == 1 and \
                isinstance(item.targets[0], ast.Name):
            kind = _ctor_kind(item.value, mod.imports)
            if kind:
                ci.attr_kinds[item.targets[0].id] = kind
        elif isinstance(item, ast.AnnAssign) and isinstance(
                item.target, ast.Name) and item.value is not None:
            kind = _ctor_kind(item.value, mod.imports)
            if kind:
                ci.attr_kinds[item.target.id] = kind
    init_ann: Dict[str, str] = {}
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if item.name == "__init__":
                a = item.args
                for p in (a.posonlyargs + a.args + a.kwonlyargs):
                    t = _ann_class(p.annotation)
                    if t:
                        init_ann[p.arg] = t
            for node in ast.walk(item):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    kind = _ctor_kind(node.value, mod.imports)
                    if kind:
                        ci.attr_kinds.setdefault(t.attr, kind)
                        continue
                    typ = _value_class(node.value, mod, init_ann)
                    if typ:
                        ci.attr_types.setdefault(t.attr, typ)
    return ci


def _value_class(value: ast.expr, mod: ModuleInfo,
                 param_ann: Dict[str, str]) -> Optional[str]:
    """The package class an assigned value constructs or carries:
    ``self._g = SinkGuard()`` / ``self._g = g if g else SinkGuard()``
    / ``self._p = policy`` (annotated param)."""
    if isinstance(value, ast.IfExp):
        return (_value_class(value.body, mod, param_ann)
                or _value_class(value.orelse, mod, param_ann))
    if isinstance(value, ast.Call):
        name = _dotted(value.func)
        tail = name.rsplit(".", 1)[-1]
        if tail and tail[:1].isupper():
            return tail
        return None
    if isinstance(value, ast.Name):
        return param_ann.get(value.id)
    return None


def _scan_module(prog: Program, path: str, rel: str,
                 report_as: str) -> Optional[ModuleInfo]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return None  # PTL000 already reports this; PTR skips the file
    mod = ModuleInfo(rel=rel, report_as=report_as, tree=tree,
                     lines=source.splitlines())
    _scan_imports(tree, mod.imports)
    # Module globals: top-level assigned names (+ their primitive kind).
    for node in tree.body:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name):
                mod.global_names.add(t.id)
                if value is not None:
                    kind = _ctor_kind(value, mod.imports)
                    if kind:
                        mod.global_kinds[t.id] = kind
                    elif isinstance(value, ast.Call):
                        tail = _dotted(value.func).rsplit(".", 1)[-1]
                        if tail[:1].isupper():
                            mod.global_types[t.id] = tail
    # Classes (anywhere, including nested) and functions.
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            ci = _scan_class(prog, mod, node, rel)
            mod.classes[node.name] = ci
            prog.classes.setdefault(node.name, []).append(ci)

    def scan_fn(fn: ast.AST, cls: Optional[ClassInfo],
                prefix: str) -> FuncInfo:
        qual = f"{rel}::{prefix}{fn.name}"  # type: ignore[attr-defined]
        fi = FuncInfo(qual=qual, rel=rel, cls=cls.name if cls else None,
                      name=fn.name,  # type: ignore[attr-defined]
                      node=fn, lineno=fn.lineno)
        prog.functions[qual] = fi
        if cls is not None:
            cls.methods[fn.name] = fi  # type: ignore[attr-defined]
        elif prefix == "":
            mod.functions[fn.name] = fi  # type: ignore[attr-defined]
        # Function-level imports overlay the module map.
        local_names, overlay = _fn_prelude(fn)
        imports = {**mod.imports, **overlay} if overlay else mod.imports
        fi._imports = imports  # type: ignore[attr-defined]
        visitor = _FuncVisitor(prog, mod, fi, cls, local_names, imports)
        for stmt in fn.body:  # type: ignore[attr-defined]
            visitor.visit(stmt)
        # Nested defs: scanned as their own FuncInfo, linked by an
        # encloser edge (a closure runs in whatever context its
        # encloser runs in — SinkGuard.__call__'s on_retry, _run's
        # work()).
        for child in _direct_nested_defs(fn):
            sub = scan_fn(
                child, cls,
                f"{prefix}{fn.name}.<locals>.",  # type: ignore[attr-defined]
            )
            fi.nested.append(sub.qual)
        return fi

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_fn(node, None, "")
        elif isinstance(node, ast.ClassDef):
            _scan_class_methods(node, mod, scan_fn)
    # The module BODY as a synthetic function: top-level
    # ``threading.Thread(...)`` / ``signal.signal(...)`` sites (the
    # natural shape of a standalone fixture — and of a script-style
    # module) must be visible to thread/signal discovery. Accesses it
    # records are import-time initialization (in_init above), so
    # module constants never read as cross-context writes.
    mod_fi = FuncInfo(qual=f"{rel}::<module>", rel=rel, cls=None,
                      name="<module>", node=tree, lineno=0)
    prog.functions[mod_fi.qual] = mod_fi
    mod_fi._imports = mod.imports  # type: ignore[attr-defined]
    visitor = _FuncVisitor(prog, mod, mod_fi, None, set(), mod.imports)
    for stmt in tree.body:
        visitor.visit(stmt)
    prog.modules[rel] = mod
    return mod


def _direct_nested_defs(fn: ast.AST) -> List[ast.AST]:
    """Function defs DIRECTLY nested in ``fn`` (not inside a deeper
    def/class) — one linear scan, no per-child re-walk."""
    out: List[ast.AST] = []

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(child)
            elif not isinstance(child, ast.ClassDef):
                walk(child)

    for stmt in fn.body:  # type: ignore[attr-defined]
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(stmt)
        elif not isinstance(stmt, ast.ClassDef):
            walk(stmt)
    return out


def _scan_class_methods(cls: ast.ClassDef, mod: ModuleInfo,
                        scan_fn) -> None:
    ci = mod.classes[cls.name]
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_fn(item, ci, f"{cls.name}.")
        elif isinstance(item, ast.ClassDef):
            _scan_class_methods(item, mod, scan_fn)


# Nested classes defined inside functions (live.py's HTTP Handler) are
# not in tree.body; scan them off the walk.
def _scan_function_nested_classes(prog: Program, mod: ModuleInfo) -> None:
    if not any(not ci.methods for ci in mod.classes.values()):
        return  # no function-nested classes here — skip the re-walk
    seen = {id(fi.node) for fi in prog.functions.values()}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        ci = mod.classes.get(node.name)
        if ci is None or ci.methods:
            continue
        # The class is defined inside a function: its methods close
        # over that function's locals (`exporter = self`), so they
        # inherit its alias map for resolution.
        encl = _func_containing(prog, mod, node)
        closure_aliases = _local_alias_type(encl) if encl else {}
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and id(item) not in seen:
                qual = f"{mod.rel}::{node.name}.{item.name}"
                fi = FuncInfo(qual=qual, rel=mod.rel, cls=node.name,
                              name=item.name, node=item, lineno=item.lineno)
                prog.functions[qual] = fi
                ci.methods[item.name] = fi
                local_names, overlay = _fn_prelude(item)
                imports = ({**mod.imports, **overlay} if overlay
                           else mod.imports)
                fi._imports = imports  # type: ignore[attr-defined]
                fi._closure_aliases = closure_aliases  # type: ignore[attr-defined]
                visitor = _FuncVisitor(prog, mod, fi, ci, local_names,
                                       imports)
                for stmt in item.body:
                    visitor.visit(stmt)


# -- call resolution --------------------------------------------------------


def _class_infos(prog: Program, mod: ModuleInfo,
                 name: str) -> List[ClassInfo]:
    if name in mod.classes:
        return [mod.classes[name]]
    # imported package class?
    target = mod.imports.get(name)
    if target:
        dotted_mod, _, cls_name = target.rpartition(".")
        rel = _module_rel_of(dotted_mod)
        if rel and rel in prog.modules and \
                cls_name in prog.modules[rel].classes:
            return [prog.modules[rel].classes[cls_name]]
    return prog.classes.get(name, [])


def _method_lookup(prog: Program, mod: ModuleInfo, cls_name: str,
                   method: str) -> List[str]:
    out = []
    for ci in _class_infos(prog, mod, cls_name):
        fi = ci.methods.get(method)
        if fi is not None:
            out.append(fi.qual)
            continue
        for base in ci.bases:
            base_name = base.rsplit(".", 1)[-1]
            if base_name != cls_name:
                out.extend(_method_lookup(prog, mod, base_name, method))
    return out


def _return_class(fi: FuncInfo) -> Optional[str]:
    ret = getattr(fi.node, "returns", None)
    return _ann_class(ret)


def _resolve_call(prog: Program, site: CallSite) -> List[str]:
    """Callee quals for one call site (possibly empty — unresolved).
    Handles: self methods (incl. base classes), typed self-attributes
    (instance ``__call__`` and ``self._policy.call``), local
    ``v = self`` / ``v = Class()`` aliases, plain/module-level names,
    nested defs, package imports (module functions + constructors),
    and one level of return-annotation chaining
    (``obs_metrics.counter(...).inc``)."""
    memo_key = (site.func.qual, f"{site.line}:{site.col}:{site.raw}")
    hit = prog._resolve_memo.get(memo_key)
    if hit is not None:
        return list(hit)
    out = _resolve_uncached(prog, site)
    prog._resolve_memo[memo_key] = tuple(out)
    return out


def _resolve_uncached(prog: Program, site: CallSite) -> List[str]:
    fi = site.func
    mod = prog.modules[fi.rel]
    imports = getattr(fi, "_imports", mod.imports)
    raw = site.raw

    # method on a call result: obs_metrics.counter(...).inc(...)
    fnode = site.node.func
    if isinstance(fnode, ast.Attribute) and isinstance(fnode.value,
                                                       ast.Call):
        inner_name = _dotted(fnode.value.func)
        if inner_name:
            inner = CallSite(name=_canonical_name(inner_name, imports),
                             raw=inner_name, node=fnode.value,
                             line=site.line, col=site.col,
                             locks=site.locks, func=fi)
            for q in _resolve_uncached(prog, inner):
                ret = _return_class(prog.functions[q])
                if ret:
                    m = _method_lookup(prog, mod, ret, fnode.attr)
                    if m:
                        return m
        return []

    if raw.startswith("self.") and fi.cls is not None:
        rest = raw[len("self."):]
        ci = mod.classes.get(fi.cls)
        if "." not in rest:
            m = _method_lookup(prog, mod, fi.cls, rest)
            if m:
                return m
            # calling a typed attribute -> its __call__
            if ci is not None and rest in ci.attr_types:
                return _method_lookup(prog, mod, ci.attr_types[rest],
                                      "__call__")
            return []
        attr, _, meth = rest.partition(".")
        if "." in meth or ci is None:
            return []
        typ = ci.attr_types.get(attr)
        if typ:
            return _method_lookup(prog, mod, typ, meth)
        return []

    if "." not in raw:
        # nested def in this function?
        for q in fi.nested:
            if prog.functions[q].name == raw:
                return [q]
        # enclosing function's nested sibling (closure call)
        if ".<locals>." in fi.qual:
            parent_qual = fi.qual.rsplit(".<locals>.", 1)[0]
            parent = prog.functions.get(parent_qual)
            if parent is not None:
                for q in parent.nested:
                    f2 = prog.functions[q]
                    if f2.name == raw and q != fi.qual:
                        return [q]
        if raw in mod.functions:
            return [mod.functions[raw].qual]
        if raw in mod.classes or raw in imports:
            ctor = _method_lookup(prog, mod, raw, "__init__")
            if ctor:
                return ctor
            target = imports.get(raw)
            if target:
                dotted_mod, _, name = target.rpartition(".")
                rel = _module_rel_of(dotted_mod)
                if rel and rel in prog.modules:
                    m2 = prog.modules[rel]
                    if name in m2.functions:
                        return [m2.functions[name].qual]
        return []

    head, _, rest = raw.partition(".")
    target = imports.get(head)
    if target is not None:
        rel = _module_rel_of(target)
        if rel and rel in prog.modules:
            m2 = prog.modules[rel]
            if "." not in rest:
                if rest in m2.functions:
                    return [m2.functions[rest].qual]
                if rest in m2.classes:
                    return [q for ci in [m2.classes[rest]]
                            for q in ([ci.methods["__init__"].qual]
                                      if "__init__" in ci.methods else [])]
            else:
                cls_name, _, meth = rest.partition(".")
                if "." not in meth and cls_name in m2.classes:
                    fi2 = m2.classes[cls_name].methods.get(meth)
                    return [fi2.qual] if fi2 else []
        return []
    # ClassName.method in this module / module-global instance
    # (`_REGISTRY.counter`) / local alias `v = self` / closure alias
    # from the enclosing function (live.py's HTTP Handler sees
    # `exporter = self` from _start_http).
    if head in mod.classes and "." not in rest:
        fi2 = mod.classes[head].methods.get(rest)
        return [fi2.qual] if fi2 else []
    if head in mod.global_types and "." not in rest:
        return _method_lookup(prog, mod, mod.global_types[head], rest)
    alias_t = dict(getattr(fi, "_closure_aliases", {}))
    alias_t.update(_local_alias_type(fi))
    typ = alias_t.get(head)
    if typ and "." not in rest:
        return _method_lookup(prog, mod, typ, rest)
    return []


def _local_alias_type(fi: FuncInfo) -> Dict[str, str]:
    """Minimal local type inference: ``v = self`` (enclosing class) and
    ``v = ClassName(...)`` — enough to see through live.py's
    ``exporter = self`` HTTP-handler closure."""
    memo = getattr(fi, "_alias_types", None)
    if memo is not None:
        return memo
    out: Dict[str, str] = {}
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            v = node.value
            if isinstance(v, ast.Name) and v.id == "self" and fi.cls:
                out[node.targets[0].id] = fi.cls
            elif isinstance(v, ast.Call):
                name = _dotted(v.func)
                tail = name.rsplit(".", 1)[-1]
                if tail[:1].isupper():
                    out[node.targets[0].id] = tail
    fi._alias_types = out  # type: ignore[attr-defined]
    return out


# -- context inference ------------------------------------------------------


def _resolve_callable_expr(prog: Program, fi: FuncInfo,
                           expr: ast.expr) -> List[str]:
    """A callable EXPRESSION (a Thread target / signal handler) ->
    function quals."""
    mod = prog.modules[fi.rel]
    name = _dotted(expr)
    if not name:
        return []
    if name.startswith("self.") and fi.cls is not None and \
            "." not in name[len("self."):]:
        return _method_lookup(prog, mod, fi.cls, name[len("self."):])
    if "." not in name:
        for q in fi.nested:
            if prog.functions[q].name == name:
                return [q]
        if name in mod.functions:
            return [mod.functions[name].qual]
    return []


def _discover_threads(prog: Program) -> None:
    for fi in list(prog.functions.values()):
        for site in fi.calls:
            if site.name != "threading.Thread":
                continue
            target_expr = None
            label = None
            daemon: Optional[bool] = None
            for kw in site.node.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
                elif kw.arg == "name":
                    label = _const_str(kw.value)
                elif kw.arg == "daemon" and isinstance(kw.value,
                                                       ast.Constant):
                    daemon = bool(kw.value.value)
            spelling = _dotted(target_expr) if target_expr is not None \
                else ""
            roots = (_resolve_callable_expr(prog, fi, target_expr)
                     if target_expr is not None else [])
            stored_attr = stored_local = None
            # `self.X = threading.Thread(...)` / `t = threading.Thread(...)`
            assign = _enclosing_assign(fi.node, site.node)
            if assign is not None:
                t = assign.targets[0] if isinstance(assign, ast.Assign) \
                    else None
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self":
                    stored_attr = t.attr
                elif isinstance(t, ast.Name):
                    stored_local = t.id
            prog.thread_sites.append(ThreadSite(
                label=label or f"thread:{spelling or '?'}",
                roots=roots, daemon=daemon, func=fi, line=site.line,
                col=site.col, target_spelling=spelling,
                stored_attr=stored_attr, stored_local=stored_local,
            ))
        # HTTP server threads: the target is an external
        # serve_forever; the code that RUNS on that thread is the
        # module's BaseHTTPRequestHandler subclass.
    for rel, mod in prog.modules.items():
        handler_classes = [
            ci for ci in mod.classes.values()
            if any(b.rsplit(".", 1)[-1] == "BaseHTTPRequestHandler"
                   for b in ci.bases)
        ]
        if not handler_classes:
            continue
        server_sites = [
            ts for ts in prog.thread_sites
            if ts.func.rel == rel and "serve_forever" in ts.target_spelling
        ]
        label = (server_sites[0].label if server_sites
                 else f"http:{rel}")
        for ci in handler_classes:
            for m in ci.methods.values():
                site = server_sites[0] if server_sites else None
                prog.thread_sites.append(ThreadSite(
                    label=label, roots=[m.qual],
                    daemon=site.daemon if site else True,
                    func=site.func if site else m, line=m.lineno, col=0,
                    target_spelling=f"{ci.name}.{m.name}",
                    stored_attr=site.stored_attr if site else None,
                    stored_local=None,
                ))


def _enclosing_assign(root: ast.AST,
                      call: ast.Call) -> Optional[ast.Assign]:
    for node in ast.walk(root):
        if isinstance(node, ast.Assign) and node.value is call:
            return node
    return None


def _discover_signal_roots(prog: Program) -> None:
    for rel, mod in prog.modules.items():
        # Both installation idioms require the signal module — skip
        # the per-module re-walk everywhere it isn't even imported.
        if not any(t == "signal" or t.startswith("signal.")
                   for t in mod.imports.values()):
            continue
        for call, handler_expr, cls_name in roots_mod.iter_handler_installs(
                mod.tree):
            # find the enclosing FuncInfo for resolution context
            fi = _func_containing(prog, mod, call)
            if fi is None:
                continue
            quals = _resolve_callable_expr(prog, fi, handler_expr)
            for q in quals:
                prog.signal_roots.append((f"signal:{q.split('::')[-1]}", q))


def _func_containing(prog: Program, mod: ModuleInfo,
                     node: ast.AST) -> Optional[FuncInfo]:
    best = None
    for fi in prog.functions.values():
        if fi.rel != mod.rel:
            continue
        for sub in ast.walk(fi.node):
            if sub is node:
                if best is None or fi.lineno >= best.lineno:
                    best = fi
    return best


def _compute_contexts(prog: Program) -> None:
    """BFS every root through the call graph (plus encloser->nested
    edges). ``prog.contexts[qual]`` = the set of non-main context
    labels reaching it; a function reached by none runs in MAIN."""
    edges: Dict[str, Set[str]] = {q: set() for q in prog.functions}
    for fi in prog.functions.values():
        for site in fi.calls:
            for q in _resolve_call(prog, site):
                edges[fi.qual].add(q)
        for q in fi.nested:
            edges[fi.qual].add(q)
    roots: List[Tuple[str, str]] = []
    for ts in prog.thread_sites:
        for q in ts.roots:
            roots.append((ts.label, q))
    roots.extend(prog.signal_roots)
    prog.contexts = {q: set() for q in prog.functions}
    for label, root in roots:
        seen = set()
        frontier = [root]
        while frontier:
            q = frontier.pop()
            if q in seen or q not in prog.contexts:
                continue
            seen.add(q)
            prog.contexts[q].add(label)
            frontier.extend(edges.get(q, ()))


def _ctxs_of(prog: Program, fi: FuncInfo) -> FrozenSet[str]:
    labels = prog.contexts.get(fi.qual, set())
    return frozenset(labels) if labels else frozenset((MAIN,))


# -- the rules --------------------------------------------------------------


def _state_label(key: StateKey) -> str:
    kind, owner, name = key
    if kind == "attr":
        return f"{owner}.{name}"
    return f"{owner}:{name}"


def _lock_label(key: LockKey) -> str:
    return _state_label(key)


def rule_ptr001(prog: Program) -> Iterable[Finding]:
    """PTR001: mutable state (``self._x`` / module global) written in
    one context and touched in another without a common guarding lock.
    Construction-phase (``__init__``) accesses and threading-primitive
    bindings are exempt; one finding per state key."""
    by_key: Dict[StateKey, List[Access]] = {}
    for fi in prog.functions.values():
        for acc in fi.accesses:
            by_key.setdefault(acc.key, []).append(acc)
    for key in sorted(by_key):
        kind, owner, name = key
        if kind == "attr":
            owner_infos = prog.classes.get(owner, [])
            if any(ci.attr_kinds.get(name) in ("lock", "sync", "local",
                                               "thread")
                   for ci in owner_infos):
                continue
        else:
            mod = prog.modules.get(owner)
            if mod is not None and mod.global_kinds.get(name) in (
                    "lock", "sync", "local", "thread"):
                continue
        accs = [a for a in by_key[key] if not a.in_init]
        writes = [a for a in accs if a.write]
        if not writes:
            continue
        ctxs = set()
        for a in accs:
            ctxs |= _ctxs_of(prog, a.func)
        if len(ctxs) < 2 or ctxs == {MAIN}:
            continue
        common = frozenset.intersection(*(a.locks for a in accs)) \
            if accs else frozenset()
        if common:
            continue  # every access shares a guarding lock
        rep = next((w for w in writes
                    if _ctxs_of(prog, w.func) != frozenset((MAIN,))),
                   writes[0])
        mod = prog.modules[rep.func.rel]
        yield Finding(
            "PTR001", mod.report_as, rep.line,
            f"shared state {_state_label(key)} is written in context "
            f"{'/'.join(sorted(_ctxs_of(prog, rep.func)))} and accessed "
            f"from {'/'.join(sorted(ctxs))} with no common guarding "
            f"lock: guard every access with one lock, make it a "
            f"documented GIL-atomic handoff (allowlist with the "
            f"reason), or confine it to one context",
            _state_label(key), rep.col,
        )


def rule_ptr002(prog: Program) -> Iterable[Finding]:
    """PTR002: lock-order inversion — a cycle in the lock-acquisition
    graph (lock A held while acquiring B, elsewhere B held while
    acquiring A) deadlocks the first unlucky interleaving."""
    # transitive lock set a function may acquire
    acq_memo: Dict[str, FrozenSet[LockKey]] = {}

    def acq_trans(qual: str, stack: FrozenSet[str]) -> FrozenSet[LockKey]:
        hit = acq_memo.get(qual)
        if hit is not None:
            return hit
        if qual in stack:
            return frozenset()
        fi = prog.functions[qual]
        out = {a.lock for a in fi.acquires}
        for site in fi.calls:
            for q in _resolve_call(prog, site):
                out |= acq_trans(q, stack | {qual})
        memo = frozenset(out)
        acq_memo[qual] = memo
        return memo

    edges: Dict[LockKey, Dict[LockKey, Tuple[str, int, str]]] = {}
    for fi in prog.functions.values():
        for a in fi.acquires:
            for held in a.held:
                if held != a.lock:
                    edges.setdefault(held, {}).setdefault(
                        a.lock, (fi.rel, a.line, fi.qual))
        for site in fi.calls:
            if not site.locks:
                continue
            for q in _resolve_call(prog, site):
                for inner in acq_trans(q, frozenset()):
                    for held in site.locks:
                        if held != inner:
                            edges.setdefault(held, {}).setdefault(
                                inner, (fi.rel, site.line, fi.qual))
    # cycle detection (DFS)
    seen_cycles: Set[Tuple[LockKey, ...]] = set()

    def dfs(start: LockKey, node: LockKey, path: List[LockKey]):
        for nxt in sorted(edges.get(node, {})):
            if nxt == start:
                cyc = tuple(sorted(path))
                if cyc not in seen_cycles:
                    seen_cycles.add(cyc)
                    yield path + [start]
            elif nxt not in path:
                yield from dfs(start, nxt, path + [nxt])

    for start in sorted(edges):
        for cycle in dfs(start, start, [start]):
            rel, line, qual = edges[cycle[0]][cycle[1]]
            order = " -> ".join(_lock_label(k) for k in cycle)
            mod = prog.modules[rel]
            yield Finding(
                "PTR002", mod.report_as, line,
                f"lock-order inversion: {order} — two contexts taking "
                f"these locks in opposite orders deadlock; impose one "
                f"global acquisition order",
                "lockcycle:" + "<>".join(sorted(
                    _lock_label(k) for k in set(cycle))),
            )


# forbidden-operation classification for the PTR003 handler scan
def _handler_violation(prog: Program, fi: FuncInfo,
                       site: CallSite) -> Optional[str]:
    name = site.name
    if name in _IO_EXACT or name in _IO_SYS_WRITE or \
            name.endswith(_IO_SUFFIX):
        return f"performs I/O ({site.raw})"
    if _is_blocking(prog, site):
        return f"blocks ({site.raw})"
    if name.startswith(("jax.", "jnp.", "numpy.", "np.", "torch.")) or \
            name.startswith(_PKG_PREFIX) and ".ops." in name:
        return f"calls into torch/numpy ({site.raw})"
    if name in ("list", "dict", "set", "bytearray"):
        return f"allocates a container ({site.raw})"
    for q in _resolve_call(prog, site):
        tgt = prog.functions[q]
        if tgt.rel == "obs/metrics.py" and tgt.name in (
                "counter", "gauge", "histogram", "_get"):
            return (f"get-or-creates a registry metric ({site.raw}) — "
                    f"allocation plus the registry lock; pre-allocate "
                    f"the instrument and set/inc it instead")
        if tgt.name == "__init__" and tgt.cls is not None:
            return f"allocates ({site.raw}(...) constructs {tgt.cls})"
    return None


def rule_ptr003(prog: Program) -> Iterable[Finding]:
    """PTR003: signal-handler purity. The closure reachable from an
    installed handler may only set pre-allocated flags/simple scalars:
    no lock acquisition (a handler interrupting the lock's holder ON
    THE SAME THREAD self-deadlocks — CPython runs handlers between
    bytecodes of whatever the main thread is doing), no I/O, no
    allocation, no blocking calls, no torch."""
    emitted = set()
    for label, root in sorted(set(prog.signal_roots)):
        closure = _closure(prog, root)
        for qual in sorted(closure):
            fi = prog.functions[qual]
            mod = prog.modules[fi.rel]
            for a in fi.acquires:
                key = (qual, a.line, "lock")
                if key in emitted:
                    continue
                emitted.add(key)
                yield Finding(
                    "PTR003", mod.report_as, a.line,
                    f"signal-handler closure (root {root.split('::')[-1]}"
                    f") acquires lock {_lock_label(a.lock)} in "
                    f"{fi.name}: a signal delivered while the main "
                    f"thread holds it self-deadlocks — handlers may "
                    f"only set pre-allocated flags",
                    _snippet(mod.lines, a.line), a.col,
                )
            for site in fi.calls:
                why = _handler_violation(prog, fi, site)
                if why is None:
                    continue
                key = (qual, site.line, site.raw)
                if key in emitted:
                    continue
                emitted.add(key)
                yield Finding(
                    "PTR003", mod.report_as, site.line,
                    f"signal-handler closure (root "
                    f"{root.split('::')[-1]}) {why} in {fi.name}: "
                    f"handlers may only set pre-allocated flags/simple "
                    f"scalars — defer the work to the next safe point",
                    _snippet(mod.lines, site.line), site.col,
                )


def _closure(prog: Program, root: str) -> Set[str]:
    seen: Set[str] = set()
    frontier = [root]
    while frontier:
        q = frontier.pop()
        if q in seen or q not in prog.functions:
            continue
        seen.add(q)
        fi = prog.functions[q]
        for site in fi.calls:
            frontier.extend(_resolve_call(prog, site))
        frontier.extend(fi.nested)
    return seen


def _is_blocking(prog: Program, site: CallSite) -> bool:
    name = site.name
    if name in _BLOCKING_EXACT or name.endswith(_BLOCKING_SUFFIX):
        return True
    # .get/.put/.join/.wait on a sync-primitive or thread attribute
    if name.startswith("self.") and site.func.cls is not None:
        rest = name[len("self."):]
        if "." in rest:
            attr, _, meth = rest.partition(".")
            mod = prog.modules[site.func.rel]
            ci = mod.classes.get(site.func.cls)
            kind = ci.attr_kinds.get(attr) if ci is not None else None
            if kind in ("sync", "thread") and meth in (
                    "get", "put", "join", "wait", "acquire"):
                return True
    return False


_IO_DURABLE = ("fopen", "atomic_write", "savez", "savez_compressed")


def rule_ptr004(prog: Program) -> Iterable[Finding]:
    """PTR004: blocking call while holding a lock — queue get/join,
    thread join, sleep, device_get, filesystem/network I/O inside a
    lock scope serializes every other context on an unbounded wait."""
    block_memo: Dict[str, Tuple[Tuple[str, str], ...]] = {}

    def blocks_in(qual: str, stack: FrozenSet[str]):
        hit = block_memo.get(qual)
        if hit is not None:
            return hit
        if qual in stack:
            return ()
        fi = prog.functions[qual]
        out = []
        for site in fi.calls:
            if site.locks:
                continue  # reported at ITS lock scope, not ours
            if _is_blocking(prog, site) or site.name in _IO_EXACT or \
                    site.name.endswith(_IO_SUFFIX):
                out.append((site.raw, fi.qual))
            else:
                for q in _resolve_call(prog, site):
                    out.extend(blocks_in(q, stack | {qual}))
        memo = tuple(out[:4])
        block_memo[qual] = memo
        return memo

    for fi in prog.functions.values():
        mod = prog.modules[fi.rel]
        for site in fi.calls:
            if not site.locks:
                continue
            label = None
            if _is_blocking(prog, site):
                label = site.raw
            elif site.name in _IO_EXACT or site.name.endswith(_IO_SUFFIX):
                label = site.raw
            else:
                for q in _resolve_call(prog, site):
                    inner = blocks_in(q, frozenset())
                    if inner:
                        label = (f"{site.raw} -> {inner[0][0]} "
                                 f"(via {inner[0][1].split('::')[-1]})")
                        break
            if label is None:
                continue
            locks = "/".join(sorted(_lock_label(k) for k in site.locks))
            yield Finding(
                "PTR004", mod.report_as, site.line,
                f"blocking call {label} while holding lock {locks}: "
                f"move the wait outside the lock scope (snapshot state "
                f"under the lock, block after releasing)",
                _snippet(mod.lines, site.line), site.col,
            )


def rule_ptr005(prog: Program) -> Iterable[Finding]:
    """PTR005: thread-lifecycle hygiene — a non-daemon thread nobody
    joins outlives every exit path (the interpreter waits on it
    forever); a daemon thread that performs DURABLE writes with no
    join anywhere can be torn mid-write by process exit."""
    for ts in prog.thread_sites:
        fi = ts.func
        mod = prog.modules[fi.rel]
        joined = _has_join(prog, ts)
        if ts.daemon is not True:
            if not joined:
                yield Finding(
                    "PTR005", mod.report_as, ts.line,
                    f"non-daemon thread '{ts.label}' "
                    f"(target {ts.target_spelling}) is never joined: "
                    f"the process cannot exit while it runs — join it "
                    f"on every exit path or make it a daemon with a "
                    f"bounded join",
                    _snippet(mod.lines, ts.line), ts.col,
                )
            continue
        if joined:
            continue
        durable = _durable_write_in_closure(prog, ts)
        if durable:
            yield Finding(
                "PTR005", mod.report_as, ts.line,
                f"daemon thread '{ts.label}' performs durable writes "
                f"({durable}) and is never joined: a process exit can "
                f"tear the write mid-file — join it (bounded) on the "
                f"shutdown path",
                _snippet(mod.lines, ts.line), ts.col,
            )


def _has_join(prog: Program, ts: ThreadSite) -> bool:
    if ts.stored_attr is not None and ts.func.cls is not None:
        needle = f"self.{ts.stored_attr}.join"
        for fi in prog.functions.values():
            if fi.cls != ts.func.cls or fi.rel != ts.func.rel:
                continue
            if any(s.raw == needle for s in fi.calls):
                return True
        return False
    if ts.stored_local is not None:
        needle = f"{ts.stored_local}.join"
        scope = [ts.func] + [prog.functions[q] for q in ts.func.nested]
        return any(s.raw == needle for fi in scope for s in fi.calls)
    return False


def _durable_write_in_closure(prog: Program, ts: ThreadSite
                              ) -> Optional[str]:
    for root in ts.roots:
        for qual in _closure(prog, root):
            fi = prog.functions[qual]
            for site in fi.calls:
                tail = site.name.rsplit(".", 1)[-1]
                if tail in _IO_DURABLE or site.name == "json.dump":
                    return f"{site.raw} in {fi.name}"
    return None


def rule_ptr006(prog: Program) -> Iterable[Finding]:
    """PTR006: raw ``time.time/monotonic/sleep/perf_counter`` CALLS in
    context-reachable code (reachable from a thread/signal root).
    Virtual-time tests cannot drive them, and the repo's injectable
    clock idiom (``clock=time.monotonic`` DEFAULT arguments —
    utils/retry.py) exists precisely so they can; the default-argument
    REFERENCE never flags, only direct calls do."""
    for fi in prog.functions.values():
        ctxs = _ctxs_of(prog, fi)
        if ctxs == frozenset((MAIN,)):
            continue
        mod = prog.modules[fi.rel]
        for site in fi.calls:
            if site.name in _RAW_CLOCK:
                yield Finding(
                    "PTR006", mod.report_as, site.line,
                    f"raw {site.name}() in code reachable from context "
                    f"{'/'.join(sorted(ctxs))}: take an injectable "
                    f"clock/sleep (the utils/retry.py idiom) so "
                    f"virtual-time tests can drive this path",
                    _snippet(mod.lines, site.line), site.col,
                )


RULES: Dict[str, Tuple] = {
    "PTR001": (rule_ptr001,
               "cross-context state without a common guarding lock"),
    "PTR002": (rule_ptr002, "lock-order inversion cycles"),
    "PTR003": (rule_ptr003,
               "signal-handler purity (pre-allocated flags only)"),
    "PTR004": (rule_ptr004, "blocking call while holding a lock"),
    "PTR005": (rule_ptr005, "thread-lifecycle hygiene (join discipline)"),
    "PTR006": (rule_ptr006,
               "raw time.* in context-reachable code (injectable clock)"),
}


# -- drivers ----------------------------------------------------------------


def _build_program(files: List[Tuple[str, str, str]]) -> Program:
    """files: (abs path, rel module path, report-as path)."""
    prog = Program()
    for path, rel, report_as in files:
        _scan_module(prog, path, rel, report_as)
    for mod in prog.modules.values():
        _scan_function_nested_classes(prog, mod)
    _discover_threads(prog)
    _discover_signal_roots(prog)
    _compute_contexts(prog)
    return prog


def _run_rules(prog: Program) -> List[Finding]:
    findings: List[Finding] = []
    for rule_id in sorted(RULES):
        findings.extend(RULES[rule_id][0](prog))
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def build_package_program(root: Optional[str] = None) -> Program:
    """The parsed whole-program view for the package tree (or an
    explicit directory treated as its own program). Tests and the
    acceptance smoke introspect discovered thread/signal roots and
    per-function contexts through this."""
    root = os.path.abspath(root or package_root())
    pkg = package_root()
    inside = root == pkg or root.startswith(pkg + os.sep)
    base = pkg if inside else root
    files = []
    for path in iter_python_files(root):
        rel = os.path.relpath(path, base).replace(os.sep, "/")
        files.append((path, rel, rel if inside else path))
    return _build_program(files)


def analyze_program(prog: Program) -> List[Finding]:
    """Run the PTR rules over an already-built Program (the acceptance
    smoke builds once and both introspects roots and gates findings)."""
    return _run_rules(prog)


def analyze_package(root: Optional[str] = None) -> List[Finding]:
    """The PTR pass over the installed package (or an explicit
    directory treated as its own whole program — fixture space)."""
    return _run_rules(build_package_program(root))


def analyze_file(path: str) -> List[Finding]:
    """One file as a standalone program (seeded-defect fixtures).
    Thread/signal roots and state are discovered within the file; the
    report path is the path as given."""
    ap = os.path.abspath(path)
    rel = os.path.basename(ap)
    return _run_rules(_build_program([(ap, rel, path)]))
