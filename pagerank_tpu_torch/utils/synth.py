"""Synthetic graph generators.

Copy of ``pagerank_tpu/utils/synth.py``. Both generators draw from a
numpy generator seeded by ``seed``, so the port and the JAX package get
identical edges from the same seed.

R-MAT (Graph500 parameters) reproduces the heavy power-law degree tails
of the web graphs the reference runs on (Sparky.java:44-58).
"""

from __future__ import annotations

import numpy as np


def rmat_edges(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    dtype=np.int32,
):
    """Generate ``edge_factor * 2**scale`` R-MAT edges over ``2**scale``
    vertices (Graph500 defaults a=0.57, b=0.19, c=0.19, d=0.05).

    Vectorized: one pass per scale level over all edges at once.
    Returns (src, dst); duplicates and self-loops are left in
    (``build_graph`` dedups, matching reference semantics).
    """
    n_edges = edge_factor << scale
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    ab = a + b
    a_frac = a / ab
    c_frac = c / (1.0 - ab)
    for _ in range(scale):
        src <<= 1
        dst <<= 1
        r_bit = rng.random(n_edges, dtype=np.float32)
        c_bit = rng.random(n_edges, dtype=np.float32)
        src_bit = r_bit >= np.float32(ab)
        threshold = np.where(src_bit, np.float32(c_frac), np.float32(a_frac))
        dst_bit = c_bit >= threshold
        src |= src_bit
        dst |= dst_bit
    # Permute vertex labels so high-degree vertices aren't clustered at 0.
    perm = rng.permutation(1 << scale)
    return perm[src].astype(dtype), perm[dst].astype(dtype)


def uniform_edges(n: int, e: int, seed: int = 0, dtype=np.int32):
    """Uniform random edges — the no-skew control case."""
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, n, e).astype(dtype),
        rng.integers(0, n, e).astype(dtype),
    )
