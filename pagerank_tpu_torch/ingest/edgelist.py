"""Edge-list ingestion for integer-id graphs.

Copy of ``pagerank_tpu/ingest/edgelist.py:23-90`` for local paths and
the numpy parser (the native mmap parser comes with ROADMAP slice 3).

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
    """Parse a whitespace-separated text edge list into (src, dst)."""
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
    return pairs[:, 0].copy(), pairs[:, 1].copy()


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
