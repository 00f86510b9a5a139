"""Edge-list ingestion for integer-id graphs.

Copy of ``pagerank_tpu/ingest/edgelist.py:23-90`` for local paths,
without its tracer span: a text list goes through the native mmap
parser (``native/fast_ingest.cpp`` via ``ingest/native.py``) when its
library builds, else the numpy parser.

Formats:
  - SNAP-style text: one ``src dst`` pair per line, ``#`` comments;
  - binary ``.npz`` with int arrays ``src``/``dst`` (+ optional ``n``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from pagerank_tpu_torch.utils import fsio


def load_edgelist(path: str, comments: str = "#") -> Tuple[np.ndarray, np.ndarray]:
    """Parse a whitespace-separated text edge list into (src, dst):
    through the native multithreaded parser when ``comments`` is "#"
    and its library is available, else with numpy."""
    return load_edgelist_routed(path, comments)[0]


def load_edgelist_routed(path: str, comments: str = "#"):
    """``((src, dst), route)``: :func:`load_edgelist`'s result and the
    parser that produced it, "native" or "python"."""
    if comments == "#" and fsio.scheme_of(path) is None:
        from pagerank_tpu_torch.ingest import native

        out = native.parse_edgelist_native(path)
        if out is not None:
            return out, "native"
    with fsio.fopen(path, "rb") as f:
        data = f.read()
    if comments:
        lines = [
            ln for ln in data.splitlines()
            if ln and not ln.lstrip().startswith(comments.encode())
        ]
        data = b"\n".join(lines)
    flat = np.array(data.split(), dtype=np.int64)
    if flat.size % 2 != 0:
        raise ValueError(f"{path}: odd token count {flat.size}; not a src/dst list")
    pairs = flat.reshape(-1, 2)
    return (pairs[:, 0].copy(), pairs[:, 1].copy()), "python"


def save_binary_edges(
    path: str, src: np.ndarray, dst: np.ndarray, n: Optional[int] = None
) -> None:
    """Write ``src``/``dst`` (int64, + ``n`` when given) as an ``.npz``."""
    arrays = {"src": np.asarray(src, np.int64), "dst": np.asarray(dst, np.int64)}
    if n is not None:
        arrays["n"] = np.int64(n)
    if not path.endswith(".npz"):
        path += ".npz"
    with fsio.fopen(path, "wb") as f:
        np.savez(f, **arrays)


def load_binary_edges(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[int]]:
    """Load ``src``/``dst`` (and ``n`` when present) from an ``.npz``."""
    with fsio.fopen(path, "rb") as f, np.load(f) as z:
        n = int(z["n"]) if "n" in z.files else None
        return z["src"], z["dst"], n


def load_edges_any(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[int]]:
    """Dispatch on extension: .npz binary, else text edge list."""
    if os.path.splitext(path)[1] == ".npz":
        return load_binary_edges(path)
    src, dst = load_edgelist(path)
    return src, dst, None
