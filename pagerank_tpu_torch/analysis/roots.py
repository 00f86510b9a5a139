"""Shared source of truth for process-global handler ownership.

Copy of ``pagerank_tpu/analysis/roots.py`` (pure ``ast`` there too),
kept here so the port imports nothing of the JAX package. The port
installs its handlers where the JAX package does: ``jobs.py``
(``GracefulDrain``) and ``cli.py``.

Two rules look at signal handlers from different angles and MUST agree
on where handlers live, or moving :class:`pagerank_tpu_torch.jobs.
GracefulDrain` would silently split their views:

- lint **PTL008** (``analysis/lint.py``) bans ``signal.signal`` /
  ``atexit.register`` OUTSIDE the supervisor modules — its
  ``handler_free`` scope reads :data:`HANDLER_OWNER_MODULES`;
- concurrency **PTR003** (``analysis/concurrency.py``) analyzes the
  PURITY of whatever handlers those modules install — its
  signal-context root discovery uses :func:`iter_handler_installs`,
  which recognizes both installation idioms this repo sanctions: the
  direct ``signal.signal(sig, handler)`` call and the injectable-
  install attribute (``self._install(sig, self._handler)`` where the
  class's ``__init__`` defaults ``install=signal.signal`` — the
  GracefulDrain idiom PTL008's scope note documents).

Keep this module dependency-free (pure ``ast``): the lint pass imports
it without torch.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Tuple

#: Package-relative modules allowed to install process-global
#: signal/exit handlers: the job supervisor (GracefulDrain) and the CLI
#: entry point that installs it around ``main``. PTL008's scope and
#: PTR003's in-package root discovery both read THIS tuple.
HANDLER_OWNER_MODULES = ("jobs.py", "cli.py")

#: The canonical installer spelling both discovery idioms anchor on.
INSTALLER = "signal.signal"


def dotted_name(node: ast.expr) -> str:
    """'a.b.c' for a plain dotted expression, '' otherwise — THE one
    dotted-name resolver the analysis package shares (roots discovery
    and the concurrency call graph must spell names identically)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


_dotted = dotted_name


def install_param_attrs(cls: ast.ClassDef) -> Tuple[str, ...]:
    """The ``self.<attr>`` names an injectable installer is stored
    under: ``__init__`` parameters whose DEFAULT is ``signal.signal``,
    followed to their ``self.X = param`` assignment (the GracefulDrain
    ``install=signal.signal`` idiom). Empty when the class doesn't use
    the idiom."""
    for item in cls.body:
        if not (isinstance(item, ast.FunctionDef)
                and item.name == "__init__"):
            continue
        args = item.args
        params = args.posonlyargs + args.args
        defaults = args.defaults
        injectable = set()
        # Positional defaults align to the TAIL of the parameter list.
        for param, default in zip(params[len(params) - len(defaults):],
                                  defaults):
            if _dotted(default) == INSTALLER:
                injectable.add(param.arg)
        for param, default in zip(args.kwonlyargs, args.kw_defaults):
            if default is not None and _dotted(default) == INSTALLER:
                injectable.add(param.arg)
        if not injectable:
            return ()
        attrs = []
        for node in ast.walk(item):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in injectable):
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        attrs.append(t.attr)
        return tuple(attrs)
    return ()


def iter_handler_installs(
    tree: ast.AST,
) -> Iterator[Tuple[ast.Call, ast.expr, Optional[str]]]:
    """Yield ``(call, handler_expr, owning_class)`` for every
    signal-handler installation a module performs:

    - direct ``signal.signal(sig, handler)`` calls anywhere
      (``owning_class`` is None outside a class);
    - injectable-install calls ``self.<attr>(sig, handler)`` inside a
      class whose ``__init__`` takes ``install=signal.signal``.

    The handler expression is the SECOND argument — resolve it to a
    function/method in the caller's context to get the signal-context
    root (PTR003)."""
    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
    install_attrs = {id(c): install_param_attrs(c) for c in classes}
    # Nearest enclosing class per node: ast.walk is breadth-first, so
    # an inner class's own sweep overwrites the outer's entries.
    owner = {}
    for cls in classes:
        for sub in ast.walk(cls):
            owner[id(sub)] = cls
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and len(node.args) >= 2):
            continue
        name = _dotted(node.func)
        cls = owner.get(id(node))
        if name == INSTALLER or (
            cls is not None
            and name.startswith("self.")
            and name[len("self."):] in install_attrs[id(cls)]
        ):
            yield (node, node.args[1], cls.name if cls is not None else None)
