"""The ONE sanctioned diagnostic channel for library modules.

Copy of ``pagerank_tpu/obs/log.py``.

Lint rule PTL007 bans bare ``print(...)`` / direct ``sys.stderr.write``
in library modules (CLI entry points are exempt): ad-hoc prints are
invisible to the observability layer — they don't land in traces or run
reports, and they can't be silenced or redirected as a unit. Library
diagnostics route through :func:`info` / :func:`warn` instead, which

  - write one line to stderr (prefixed ``pagerank_tpu_torch:``; the
    JAX package's prefix is ``pagerank_tpu:``), and
  - record an instant event on the active tracer, so one-off
    diagnostics ("enabling x64", "pallas unavailable, falling back")
    show up IN the trace next to the spans they explain.

This module's own ``sys.stderr.write`` carries the single PTL007
allowlist entry (analysis/allowlist.txt).
"""

from __future__ import annotations

import sys

from pagerank_tpu_torch.obs import trace as _trace


def _emit(level: str, msg: str) -> None:
    tr = _trace.get_tracer()
    if tr.enabled:
        tr.add_event("log/" + level, message=msg)
    sys.stderr.write(f"pagerank_tpu_torch: {msg}\n")


def info(msg: str) -> None:
    """One-off informational diagnostic (configuration notices,
    fallbacks taken)."""
    _emit("info", msg)


def warn(msg: str) -> None:
    """Diagnostic for a degraded-but-continuing condition (an
    out-of-regime layout, an unavailable optimization)."""
    _emit("warn", msg)
