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


def crawl_segment(directory: str, files: int = 301, per_file: int = 10_000,
                  seed: int = 23, compression: str = "block") -> dict:
    """Write a synthetic Common-Crawl-style metadata segment: ``files``
    SequenceFiles named ``metadata-%05d`` (the reference's segment
    naming, Sparky.java:47-56) of ``per_file`` (url, json-metadata) Text
    records each, in ``compression`` ("none", "record" or "block").

    The statistical shape of the JAX package's ``scripts/acceptance.py
    _gen_segment``: page ``i`` is ``http://site{i % 997}.test/p{i}``;
    8% of pages have no links; the others have 3-12 anchor links to
    pages drawn uniformly from the segment, 15% of which point at a
    never-crawled ``http://uncrawled{t}.test/`` instead. Each file's
    numbers are drawn at once from ``default_rng([seed, file])`` and
    the JSON is built by string formatting (records need not match
    ``_gen_segment`` record for record). Returns ``{"files", "records",
    "links", "bytes"}``."""
    import os

    from pagerank_tpu_torch.ingest.seqfile import write_sequence_file

    os.makedirs(directory, exist_ok=True)
    n_crawled = files * per_file
    links_total = size = 0
    for fi in range(files):
        rng = np.random.default_rng([seed, fi])
        counts = rng.integers(3, 13, per_file)
        counts[rng.random(per_file) < 0.08] = 0
        targets = rng.integers(0, n_crawled, int(counts.sum()))
        uncrawled = rng.random(len(targets)) < 0.15
        links = [
            f'{{"type": "a", "href": "http://uncrawled{t}.test/"}}' if u
            else f'{{"type": "a", "href": "http://site{h}.test/p{t}"}}'
            for t, h, u in zip(targets.tolist(), (targets % 997).tolist(),
                               uncrawled.tolist())
        ]
        ends = np.cumsum(counts).tolist()
        starts = [0] + ends[:-1]
        base = fi * per_file

        def pairs():
            for ri in range(per_file):
                i = base + ri
                u = f"http://site{i % 997}.test/p{i}"
                yield u, (f'{{"url": "{u}", "content": {{"links": ['
                          + ", ".join(links[starts[ri]:ends[ri]]) + "]}}")

        path = os.path.join(directory, f"metadata-{fi:05d}")
        write_sequence_file(path, pairs(), compression=compression)
        links_total += len(links)
        size += os.path.getsize(path)
    return {"files": files, "records": n_crawled, "links": links_total,
            "bytes": size}
