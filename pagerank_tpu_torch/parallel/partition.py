"""Static edge partitioning (replaces the reference's per-iteration
shuffles, SURVEY.md §2 P2).

Copy of ``pagerank_tpu/parallel/partition.py:1-60`` (``EdgeShards``,
``partition_edges``) over the port's :class:`~pagerank_tpu_torch.graph.
Graph`. The halo plan of that module (``HaloRound``, ``HaloPlan``,
``build_halo_plan``) comes with the sparse boundary exchange (ROADMAP
slice 6b).

Spark re-keys O(E) records across executors three times per iteration
(join/subtractByKey/reduceByKey, Sparky.java:192,224,229). Here the graph
is partitioned exactly once on the host: the destination-sorted edge list
is cut into equal-count contiguous chunks, one per device. Equal *edge*
count (not vertex count) is what balances work under power-law degree
skew — a heavy row simply spans several chunks and its partial sums meet
in the psum (the "Sparse Allreduce" pattern, PAPERS.md:5).

Padding edges carry weight 0 and dst = n-1, preserving both the
zero-contribution invariant and per-chunk dst-sortedness.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pagerank_tpu_torch.graph import Graph


@dataclass
class EdgeShards:
    """Flat padded edge arrays, length divisible by num_shards; chunk i
    (contiguous) belongs to device i."""

    src: np.ndarray  # int32 [E_pad]
    dst: np.ndarray  # int32 [E_pad]
    weight: np.ndarray  # [E_pad] float, 0 on padding
    num_shards: int
    num_real_edges: int

    @property
    def edges_per_shard(self) -> int:
        return self.src.shape[0] // self.num_shards


def partition_edges(graph: Graph, num_shards: int,
                    weight_dtype=np.float32) -> EdgeShards:
    """Cut the dst-sorted edge list into ``num_shards`` equal contiguous
    chunks, padding the tail with inert edges (w=0, dst=n-1)."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    e = graph.num_edges
    per = max(1, -(-e // num_shards))  # ceil; at least 1 so empty graphs still shard
    e_pad = per * num_shards
    pad = e_pad - e

    src = np.concatenate([graph.src, np.zeros(pad, np.int32)])
    dst = np.concatenate([graph.dst, np.full(pad, graph.n - 1, np.int32)])
    w = np.concatenate(
        [graph.edge_weight.astype(weight_dtype), np.zeros(pad, weight_dtype)]
    )
    return EdgeShards(
        src=src, dst=dst, weight=w, num_shards=num_shards, num_real_edges=e
    )
