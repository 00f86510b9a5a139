"""Repo-specific AST lint of the port (the PTL rules).

Port of ``pagerank_tpu/analysis/lint.py`` (pure ``ast`` there too; this
copy imports nothing of the JAX package). Every rule keeps its id and
its defect class, restated for torch where the JAX rule named a jax
spelling:

- PTL001: literal 128/127 and shifts by 7 in ``ops/`` outside the one
  ``LANES = 128`` assignment (as in JAX: the packed layout is the same);
- PTL002: ``torch.zeros``/``ones``/``empty``/``full``/``arange``/
  ``tensor`` without ``dtype=`` in ``ops/`` and the engines. Where a jnp
  constructor's dtype followed the x64 flag, a torch one follows
  ``torch.get_default_dtype()`` (or the data's type), which any library
  an embedding application imports may change;
- PTL003: host syncs (``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``float()``/``int()``/``bool()``/``print()``,
  ``torch.cuda.synchronize``, ``np.*``) in the bodies that queue device
  work with no host sync. JAX finds them by their ``@jax.jit``
  decorator; the port has no tracer, so the rule reads them by name:
  :data:`QUEUED_BODIES`, the step the fused forms queue
  (``TorchEngine._device_step``, its update tail ``_update`` and the
  fused forms' loop ``_queue_steps``; PERF.md says these forms queue
  with no host sync);
- PTL004 (mutable defaults), PTL006 (exception swallows), PTL007
  (library prints) and PTL008 (process-global handlers outside
  ``jobs.py``/``cli.py``, :mod:`~pagerank_tpu_torch.analysis.roots`)
  apply as they are;
- PTL005: ``np.float64``/``torch.float64``/``"float64"`` literals in
  ``ops/`` and the engines. Hopper runs f64 natively, at half the f32
  rate and twice the bytes, so a literal widening still doubles the hot
  path's traffic: wide accumulation comes from ``config.accum_dtype``.

Scopes: ``ops`` is the port's ``ops/``; ``kernel`` is ``ops/`` plus
``engines/`` (the modules that launch device work). Files OUTSIDE the
package tree (test fixtures) get every rule, so seeded violations
exercise each id. Deliberate exceptions live in
``analysis/allowlist.txt`` with a reason, never as rule carve-outs.
"""

from __future__ import annotations

import ast
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from pagerank_tpu_torch.analysis import roots as roots_mod
from pagerank_tpu_torch.analysis.findings import Finding

# The lane-geometry constants whose literal spelling is banned in ops/:
# 128 (the lane count), 127 (its mask), and shifts by 7 (its log2). The
# one allowed spelling is the `LANES = 128` assignment in ops/__init__.
_LANE_LITERALS = (127, 128)
_LANE_SHIFT = 7

# torch constructors whose result dtype follows the process default
# (or the data) unless pinned; their dtype is keyword-only.
_DTYPE_CTORS = ("zeros", "ones", "empty", "full", "arange", "tensor")

#: The functions (by name) whose body queues device work with no host
#: sync: PTL003's scope within ``ops/`` and the engines.
QUEUED_BODIES = ("_device_step", "_update", "_queue_steps")

# Calls that force a device->host sync inside a queued body.
_HOST_SYNC_NAMES = {"print", "float", "int", "bool"}
_HOST_SYNC_ATTRS = {"item", "cpu", "tolist", "numpy"}
_HOST_SYNC_DOTTED = {"torch.cuda.synchronize"}


def _snippet(lines: List[str], lineno: int) -> str:
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1].strip()
    return ""


def _int_const(node: ast.expr) -> Optional[int]:
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    return None


_dotted = roots_mod.dotted_name


# -- rules -----------------------------------------------------------------


def rule_ptl001(tree: ast.AST, path: str, lines: List[str]) -> Iterable[Finding]:
    """PTL001: magic lane-geometry constants in kernel modules. Bans
    literal 128/127 and ``>> 7``/``<< 7`` outside the canonical
    ``LANES = 128`` assignment — hardcoded geometry diverges silently
    when the layout changes."""
    allowed_lines = set()
    for node in ast.walk(tree):
        # The one allowed spelling: `LANES = <int>` at module level.
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == "LANES":
                for sub in ast.walk(node):
                    allowed_lines.add(getattr(sub, "lineno", node.lineno))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and node.lineno not in allowed_lines:
            if type(node.value) is int and node.value in _LANE_LITERALS:
                yield Finding(
                    "PTL001", path, node.lineno,
                    f"magic lane constant {node.value}: derive from LANES "
                    f"(pagerank_tpu_torch.ops.LANES) instead",
                    _snippet(lines, node.lineno), node.col_offset,
                )
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.LShift, ast.RShift)
        ):
            if _int_const(node.right) == _LANE_SHIFT:
                yield Finding(
                    "PTL001", path, node.lineno,
                    "magic lane shift by 7: use LANES-derived arithmetic "
                    "(// LANES, % LANES, or LANES.bit_length() - 1)",
                    _snippet(lines, node.lineno), node.col_offset,
                )


def rule_ptl002(tree: ast.AST, path: str, lines: List[str]) -> Iterable[Finding]:
    """PTL002: torch constructors without an explicit dtype in kernel
    modules. The result dtype then follows ``torch.get_default_dtype()``
    or the data's type — an accidental widening doubles the hot path's
    traffic, an accidental narrowing changes its answers."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if not name.startswith("torch."):
            continue
        ctor = name[len("torch."):]
        if ctor not in _DTYPE_CTORS:
            continue
        if any(kw.arg == "dtype" for kw in node.keywords):
            continue
        yield Finding(
            "PTL002", path, node.lineno,
            f"torch.{ctor} without an explicit dtype: the result follows "
            f"the process default dtype or the data — pin it",
            _snippet(lines, node.lineno), node.col_offset,
        )


def rule_ptl003(tree: ast.AST, path: str, lines: List[str]) -> Iterable[Finding]:
    """PTL003: host-sync calls inside the bodies that queue device work
    (:data:`QUEUED_BODIES`). A ``.item()``/``.cpu()``/``float()``/
    ``torch.cuda.synchronize`` there stalls the host until the stream
    drains, once a step — the overhead the fused forms exist to
    remove."""
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name not in QUEUED_BODIES:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            bad = None
            if name in _HOST_SYNC_NAMES:
                bad = f"{name}()"
            elif name.startswith("np.") or name.startswith("numpy."):
                bad = name
            elif name in _HOST_SYNC_DOTTED:
                bad = name
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_SYNC_ATTRS
            ):
                bad = f".{node.func.attr}()"
            if bad:
                yield Finding(
                    "PTL003", path, node.lineno,
                    f"host-sync call {bad} inside the queued body "
                    f"'{fn.name}': hoist it out of the step",
                    _snippet(lines, node.lineno), node.col_offset,
                )


def rule_ptl004(tree: ast.AST, path: str, lines: List[str]) -> Iterable[Finding]:
    """PTL004: mutable default arguments — shared across calls, a
    classic aliasing bug; engine builders cache per-instance state and
    a shared default list/dict corrupts it silently."""
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(fn.args.defaults) + [
            d for d in fn.args.kw_defaults if d is not None
        ]
        for d in defaults:
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call)
                and _dotted(d.func) in ("list", "dict", "set")
            )
            if mutable:
                yield Finding(
                    "PTL004", path, d.lineno,
                    f"mutable default argument in '{fn.name}': use None "
                    f"and construct inside",
                    _snippet(lines, d.lineno), d.col_offset,
                )


def rule_ptl005(tree: ast.AST, path: str, lines: List[str]) -> Iterable[Finding]:
    """PTL005: float64 literals in kernel modules. A stray float64
    constant or dtype string moves a step onto twice the bytes (and,
    on Hopper, half the f32 rate); wide accumulation must come from
    config.accum_dtype, never a literal."""
    for node in ast.walk(tree):
        name = _dotted(node) if isinstance(node, ast.Attribute) else ""
        if name in ("np.float64", "torch.float64", "numpy.float64",
                    "torch.double"):
            yield Finding(
                "PTL005", path, node.lineno,
                f"{name} literal: route wide precision through "
                f"config.accum_dtype instead",
                _snippet(lines, node.lineno), node.col_offset,
            )
        elif isinstance(node, ast.Constant) and node.value == "float64":
            yield Finding(
                "PTL005", path, node.lineno,
                "'float64' dtype string: route wide precision through "
                "config.accum_dtype instead",
                _snippet(lines, node.lineno), node.col_offset,
            )


def rule_ptl006(tree: ast.AST, path: str, lines: List[str]) -> Iterable[Finding]:
    """PTL006: exception swallows: a bare ``except:`` that never
    re-raises, or a broad ``except Exception``/``except BaseException``
    whose body is only ``pass``/constants, silently discards an error
    that retry/rollback/dead-letter machinery should have seen.
    Deliberate best-effort sites carry an allowlist entry with the
    reason, never a rule carve-out."""

    def broad(t: Optional[ast.expr]) -> bool:
        if t is None:
            return True
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        for el in elts:
            name = (
                el.id if isinstance(el, ast.Name)
                else el.attr if isinstance(el, ast.Attribute) else ""
            )
            if name in ("Exception", "BaseException"):
                return True
        return False

    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        reraises = any(
            isinstance(sub, ast.Raise)
            for stmt in node.body for sub in ast.walk(stmt)
        )
        swallow = all(
            isinstance(s, ast.Pass)
            or (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant))
            for s in node.body
        )
        if node.type is None and not reraises:
            yield Finding(
                "PTL006", path, node.lineno,
                "bare 'except:' without re-raise swallows every error "
                "(including KeyboardInterrupt/SystemExit): name the "
                "exceptions or re-raise",
                _snippet(lines, node.lineno), node.col_offset,
            )
        elif node.type is not None and broad(node.type) and swallow:
            yield Finding(
                "PTL006", path, node.lineno,
                "broad exception swallow ('except Exception: pass'): "
                "handle, log, or narrow it — silent drops hide the "
                "faults the robustness layer must surface",
                _snippet(lines, node.lineno), node.col_offset,
            )


def rule_ptl007(tree: ast.AST, path: str, lines: List[str]) -> Iterable[Finding]:
    """PTL007: bare ``print(...)`` / direct ``sys.stderr.write`` /
    ``sys.stdout.write`` in LIBRARY modules (scope excludes CLI entry
    points: ``cli.py`` and ``*/__main__.py``). Ad-hoc prints bypass the
    observability layer; telemetry flows through
    ``pagerank_tpu_torch.obs`` (spans, metrics, ``obs.log``) instead."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name == "print":
            yield Finding(
                "PTL007", path, node.lineno,
                "bare print() in a library module: route diagnostics "
                "through pagerank_tpu_torch.obs (obs.log / spans / "
                "metrics)",
                _snippet(lines, node.lineno), node.col_offset,
            )
        elif name in ("sys.stderr.write", "sys.stdout.write"):
            yield Finding(
                "PTL007", path, node.lineno,
                f"direct {name} in a library module: route diagnostics "
                "through pagerank_tpu_torch.obs (obs.log / spans / "
                "metrics)",
                _snippet(lines, node.lineno), node.col_offset,
            )


def rule_ptl008(tree: ast.AST, path: str, lines: List[str]) -> Iterable[Finding]:
    """PTL008: process-global handler installation (``signal.signal``,
    ``atexit.register``) outside the supervisor modules (scope excludes
    ``jobs.py`` and ``cli.py``). Signal handlers and exit hooks are
    PROCESS-wide state: a library module that installs one hijacks the
    embedding application's preemption story. Library code takes an
    injectable callback instead; only the entry-point supervisor wires
    it to real signals."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name in ("signal.signal", "atexit.register"):
            yield Finding(
                "PTL008", path, node.lineno,
                f"{name}() in a library module installs process-global "
                "handler state: only the job supervisor (jobs.py) and "
                "the CLI entry point own signal/exit hooks — accept an "
                "injectable callback instead",
                _snippet(lines, node.lineno), node.col_offset,
            )


RuleFn = Callable[[ast.AST, str, List[str]], Iterable[Finding]]

# rule id -> (fn, scope, one-line description). Scopes:
#   ops     — files under ops/
#   kernel  — ops/ plus engines/ (the modules that launch device work)
#   all     — every package file
#   library — every package file EXCEPT CLI entry points (cli.py,
#             */__main__.py), which legitimately print to the terminal
#   handler_free — every package file EXCEPT roots.HANDLER_OWNER_MODULES
RULES: Dict[str, Tuple[RuleFn, str, str]] = {
    "PTL001": (rule_ptl001, "ops",
               "magic lane-geometry constants outside LANES"),
    "PTL002": (rule_ptl002, "kernel",
               "torch constructors without an explicit dtype"),
    "PTL003": (rule_ptl003, "kernel",
               "host-sync calls inside the queued step bodies"),
    "PTL004": (rule_ptl004, "all", "mutable default arguments"),
    "PTL005": (rule_ptl005, "kernel",
               "float64 literals outside config-gated paths"),
    "PTL006": (rule_ptl006, "all",
               "bare/broad exception swallows"),
    "PTL007": (rule_ptl007, "library",
               "bare print()/sys.std*.write outside CLI entry points"),
    "PTL008": (rule_ptl008, "handler_free",
               "signal.signal/atexit.register outside jobs.py/cli.py"),
}


def _scope_match(scope: str, rel: str) -> bool:
    if scope == "all":
        return True
    if scope == "ops":
        return rel.startswith("ops/")
    if scope == "kernel":
        return rel.startswith(("ops/", "engines/"))
    if scope == "library":
        return rel != "cli.py" and not rel.endswith("__main__.py")
    if scope == "handler_free":
        # Read from the SHARED source of truth PTR003's signal-root
        # discovery also uses (analysis/roots.py).
        return rel not in roots_mod.HANDLER_OWNER_MODULES
    raise ValueError(f"unknown rule scope {scope!r}")


def package_root() -> str:
    """The pagerank_tpu_torch package directory — the default lint
    target."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iter_python_files(root: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if not d.startswith((".", "__pycache__"))
        )
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def lint_file(path: str, rel: Optional[str] = None) -> List[Finding]:
    """Run every in-scope rule over one file. ``rel`` is the
    package-relative posix path used for scoping and reporting; files
    outside the package pass every scope (fixture mode)."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    lines = source.splitlines()
    report_as = rel if rel is not None else path
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("PTL000", report_as, e.lineno or 0,
                        f"syntax error: {e.msg}")]
    findings: List[Finding] = []
    for rule_id, (fn, scope, _desc) in RULES.items():
        if rel is not None and not _scope_match(scope, rel):
            continue
        findings.extend(fn(tree, report_as, lines))
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def lint_tree(root: Optional[str] = None) -> List[Finding]:
    """Lint the package tree (default) or an explicit directory. Inside
    the package, rules apply by scope; an external directory is treated
    as fixture space (every rule, paths reported relative to it)."""
    root = os.path.abspath(root or package_root())
    pkg = package_root()
    inside = root == pkg or root.startswith(pkg + os.sep)
    findings: List[Finding] = []
    for path in iter_python_files(root):
        rel = os.path.relpath(path, pkg if inside else root).replace(
            os.sep, "/"
        )
        findings.extend(lint_file(path, rel if inside else None))
    return findings
