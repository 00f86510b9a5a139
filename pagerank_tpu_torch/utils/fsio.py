"""Local file I/O for the loaders and sinks.

Copy of the local subset of ``pagerank_tpu/utils/fsio.py`` that the
snapshot and ingest modules use. URI schemes (``s3://``, ``mock://``)
and their backends come with ROADMAP slice 7; a scheme path raises here.
"""

from __future__ import annotations

import contextlib
import os
import re
from typing import List, Optional

# Two+ characters: a single letter before :// is Windows drive syntax.
_SCHEME_RE = re.compile(r"^([A-Za-z][A-Za-z0-9+.-]+)://")


def scheme_of(path: str) -> Optional[str]:
    """URI scheme of ``path``, or None for a plain local path."""
    m = _SCHEME_RE.match(path)
    return m.group(1).lower() if m else None


def _local(path: str) -> str:
    scheme = scheme_of(path)
    if scheme is not None:
        raise ValueError(
            f"{path!r}: URI scheme {scheme!r} is not supported by the port "
            f"yet (remote filesystems: ROADMAP slice 7); use a local path"
        )
    return path


def fopen(path: str, mode: str = "r", **kwargs):
    return open(_local(path), mode, **kwargs)


def exists(path: str) -> bool:
    return os.path.exists(_local(path))


def listdir(path: str) -> List[str]:
    return os.listdir(_local(path))


def makedirs(path: str, exist_ok: bool = True) -> None:
    os.makedirs(_local(path), exist_ok=exist_ok)


def join(base: str, *parts: str) -> str:
    return os.path.join(_local(base), *parts)


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "wb", suffix: str = ".tmp", **kwargs):
    """Write-then-rename: bytes land at ``path`` only when the writer
    body completes. A kill or exception mid-write leaves at worst a
    ``path + suffix`` temp that the readers' name patterns never match."""
    if any(c in mode for c in "ra+"):
        raise ValueError(f"atomic_write is write-only, got mode {mode!r}")
    tmp = _local(path) + suffix
    with open(tmp, mode, **kwargs) as f:
        yield f
    os.replace(tmp, path)
