"""Carry state from the JAX package into the port.

Both packages hold graphs as the same numpy arrays and write the same
snapshot format (utils/snapshot.py), so crossing over needs no JAX
import: :func:`graph_from_arrays` takes the fields of a JAX ``Graph``
as plain arrays, and :func:`ranks_from_jax` seeds a port engine with a
rank vector in original id order (what ``JaxTpuEngine.ranks()``
returns). A JAX snapshot directory resumes in the port directly
(``resume_engine`` or ``cli --resume``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from pagerank_tpu_torch.graph import Graph


def graph_from_arrays(n, src, dst, out_degree, in_degree, dangling_mask,
                      zero_in_mask, edge_weight,
                      vertex_names: Optional[Sequence[str]] = None) -> Graph:
    """The port's :class:`Graph` from a JAX ``Graph``'s fields (numpy)."""
    n = int(n)
    g = Graph(
        n=n,
        src=np.ascontiguousarray(src, dtype=np.int32),
        dst=np.ascontiguousarray(dst, dtype=np.int32),
        out_degree=np.ascontiguousarray(out_degree, dtype=np.int32),
        in_degree=np.ascontiguousarray(in_degree, dtype=np.int32),
        dangling_mask=np.ascontiguousarray(dangling_mask, dtype=bool),
        zero_in_mask=np.ascontiguousarray(zero_in_mask, dtype=bool),
        edge_weight=np.ascontiguousarray(edge_weight, dtype=np.float64),
        vertex_names=vertex_names,
    )
    if g.src.shape != g.dst.shape or g.edge_weight.shape != g.src.shape:
        raise ValueError("src, dst and edge_weight must have one length")
    for name in ("out_degree", "in_degree", "dangling_mask", "zero_in_mask"):
        if getattr(g, name).shape != (n,):
            raise ValueError(f"{name} must have shape ({n},)")
    return g


def ranks_from_jax(ranks_np, engine, iteration: int) -> None:
    """Seed a built port ``engine`` with a JAX rank vector (original id
    order) as the state after ``iteration`` steps."""
    r = np.asarray(ranks_np)
    if r.dtype.kind != "f":
        raise TypeError(f"ranks must be floating point, got {r.dtype}")
    engine.set_ranks(r, iteration=int(iteration))
