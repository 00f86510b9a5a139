"""Host-side graph construction (L2).

Copy of ``pagerank_tpu/graph.py:37-253`` without its tracer span and
without the native radix sorter (that comes with ROADMAP slice 3): the
dedup + sort always takes the ``np.unique`` path here, which is also
the path the JAX package takes below 2^22 edges.

Reference semantics (``Sparky.java:78-184``):
  - duplicate edges collapse before out-degree is counted (``.distinct()``);
  - the vertex universe is sources ∪ targets ∪ extra vertices;
  - the post-repair dangling set is the uncrawled targets, which for
    edge-list inputs is exactly out_degree == 0;
  - z = (in_degree == 0) marks the ``subtractByKey`` retention.

The graph is a deduplicated COO edge list sorted by (dst, src), plus
per-edge weights w[e] = 1/out_degree[src[e]].
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


@dataclass
class Graph:
    """A directed graph in destination-sorted COO form.

    Attributes:
      n: number of vertices.
      src, dst: int32 [num_edges] deduplicated edges, sorted by (dst, src).
      out_degree: int32 [n] — number of unique targets per source.
      in_degree: int32 [n].
      dangling_mask: bool [n] — the post-repair ``dangUrls``.
      zero_in_mask: bool [n] — in_degree == 0.
      edge_weight: float64 [num_edges] — 1 / out_degree[src[e]].
      vertex_names: optional id->name table.
    """

    n: int
    src: np.ndarray
    dst: np.ndarray
    out_degree: np.ndarray
    in_degree: np.ndarray
    dangling_mask: np.ndarray
    zero_in_mask: np.ndarray
    edge_weight: np.ndarray
    vertex_names: Optional[Sequence[str]] = field(default=None, repr=False)

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def fingerprint(self) -> str:
        """Stable hash of the graph structure — the snapshot identity
        (utils/snapshot.py). Equal to the JAX package's for the same
        graph, so snapshots cross between the packages. The dangling
        mask is hashed only when it differs from out_degree == 0."""
        h = hashlib.sha256()
        h.update(np.int64(self.n).tobytes())
        h.update(self.src.tobytes())
        h.update(self.dst.tobytes())
        if not np.array_equal(self.dangling_mask, self.out_degree == 0):
            h.update(np.packbits(self.dangling_mask).tobytes())
        return h.hexdigest()[:16]


def build_graph(
    src: np.ndarray,
    dst: np.ndarray,
    n: Optional[int] = None,
    extra_vertices: Optional[np.ndarray] = None,
    dedup: bool = True,
    dangling_mask: Optional[np.ndarray] = None,
    vertex_names: Optional[Sequence[str]] = None,
) -> Graph:
    """Build a :class:`Graph` from raw (src, dst) edge arrays.

    Args:
      src, dst: integer edge arrays of equal length.
      n: vertex count; inferred as max id + 1 when omitted.
      extra_vertices: ids of vertices with no edges that must still exist.
      dedup: collapse duplicate edges (reference behavior).
      dangling_mask: explicit dangling-mass membership; default
        out_degree == 0.
      vertex_names: optional id->name table carried on the graph.
    """
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst length mismatch: {src.shape} vs {dst.shape}")

    if n is None:
        n = 0
        for arr in (src, dst, extra_vertices):
            if arr is not None and len(arr) > 0:
                n = max(n, int(np.max(arr)) + 1)
    n = int(n)
    if n == 0:
        raise ValueError("empty graph: no vertices")

    if len(src) > 0 and (src.min() < 0 or src.max() >= n or dst.min() < 0
                         or dst.max() >= n):
        raise ValueError("edge endpoint out of range [0, n)")

    # Dedup + sort by (dst, src) in one pass via a packed 64-bit key.
    if len(src) > 0:
        key = dst * np.int64(n) + src
        if dedup:
            key = np.unique(key)  # unique() also sorts
        else:
            key = np.sort(key, kind="stable")
        dst_s = (key // n).astype(np.int32)
        src_s = (key % n).astype(np.int32)
    else:
        src_s = np.zeros(0, dtype=np.int32)
        dst_s = np.zeros(0, dtype=np.int32)

    out_degree = np.bincount(src_s, minlength=n).astype(np.int32)
    in_degree = np.bincount(dst_s, minlength=n).astype(np.int32)

    if dangling_mask is None:
        dangling_mask = out_degree == 0
    else:
        dangling_mask = np.ascontiguousarray(dangling_mask, dtype=bool)
        if dangling_mask.shape != (n,):
            raise ValueError(f"dangling_mask shape {dangling_mask.shape} != ({n},)")
        if np.any(dangling_mask & (out_degree > 0)):
            raise ValueError("dangling_mask marks a vertex that has out-edges")
    zero_in_mask = in_degree == 0

    edge_weight = inv_out_degree(out_degree)[src_s]
    return Graph(
        n=n,
        src=src_s,
        dst=dst_s,
        out_degree=out_degree,
        in_degree=in_degree,
        dangling_mask=dangling_mask,
        zero_in_mask=zero_in_mask,
        edge_weight=edge_weight,
        vertex_names=vertex_names,
    )


def inv_out_degree(out_degree: np.ndarray, dtype=np.float64) -> np.ndarray:
    """``1/out_degree`` with 0 where out_degree == 0 — the row
    normalization of Aᵀ (Sparky.java:207)."""
    deg = out_degree.astype(dtype)
    with np.errstate(divide="ignore"):
        return np.where(out_degree > 0, 1.0 / deg, 0.0).astype(dtype)


def to_csr_transpose(graph: Graph):
    """The row-normalized adjacency, transposed, as ``scipy.sparse.csr_matrix``:
    ``A_T[d, s] = 1/out_degree[s]`` for each edge s->d, so the reference's
    contribution scatter (Sparky.java:192-229) is ``A_T @ r``."""
    from scipy import sparse

    return sparse.csr_matrix(
        (graph.edge_weight, (graph.dst, graph.src)),
        shape=(graph.n, graph.n),
    )
