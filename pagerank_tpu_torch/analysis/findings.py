"""Finding/allowlist plumbing of the port's analysis.

A copy of ``pagerank_tpu/analysis/findings.py`` (jax-free there too),
kept here so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Finding:
    """One analysis finding with a stable, documented rule id."""

    rule: str  # PTLnnn (lint) / PTCnnn (contracts)
    path: str  # repo-relative posix path ("" for whole-run findings)
    line: int  # 1-based; 0 when the finding has no source anchor
    message: str
    snippet: str = ""  # stripped source line / contract case label
    col: int = 0  # 0-based column offset

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "snippet": self.snippet,
        }

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.path else "<run>"
        tail = f"  [{self.snippet}]" if self.snippet else ""
        return f"{self.rule} {loc}: {self.message}{tail}"


@dataclass(frozen=True)
class Waiver:
    """One allowlist entry: ``rule | path-glob | anchor | reason``.

    ``anchor`` is a substring of the finding's snippet (the source line
    for lint findings, the case label for contract findings) — matching
    on content, not line numbers, so waivers survive unrelated edits.
    ``*`` matches any snippet.
    """

    rule: str
    path_glob: str
    anchor: str
    reason: str

    def matches(self, f: Finding) -> bool:
        if self.rule != f.rule:
            return False
        if not fnmatch.fnmatch(f.path, self.path_glob):
            return False
        return self.anchor == "*" or self.anchor in f.snippet


def load_allowlist(path: str) -> List[Waiver]:
    """Parse an allowlist file. Lines are ``rule | path-glob | anchor |
    reason``; ``#`` comments and blank lines are skipped. A malformed
    line raises — a silently dropped waiver would flip the exit code of
    every clean run."""
    waivers: List[Waiver] = []
    with open(path, encoding="utf-8") as f:
        for ln, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split("|")]
            if len(parts) < 4 or not all(parts[:3]) or not parts[3]:
                raise ValueError(
                    f"{path}:{ln}: allowlist lines are "
                    f"'rule | path-glob | anchor | reason' — got {raw!r}"
                )
            waivers.append(Waiver(parts[0], parts[1], parts[2],
                                  "|".join(parts[3:])))
    return waivers


def split_allowlisted(
    findings: List[Finding], waivers: List[Waiver]
) -> Tuple[List[Finding], List[Tuple[Finding, Waiver]]]:
    """(active, waived) — each finding is waived by the FIRST matching
    allowlist entry."""
    active: List[Finding] = []
    waived: List[Tuple[Finding, Waiver]] = []
    for f in findings:
        for w in waivers:
            if w.matches(f):
                waived.append((f, w))
                break
        else:
            active.append(f)
    return active, waived
