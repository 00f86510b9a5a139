"""Static edge partitioning (replaces the reference's per-iteration
shuffles, SURVEY.md §2 P2).

Copy of ``pagerank_tpu/parallel/partition.py`` over the port's
:class:`~pagerank_tpu_torch.graph.Graph`: ``EdgeShards`` and
``partition_edges`` (:1-60), and the halo plan of the sparse boundary
exchange (:62-414: ``HaloRound``, ``HaloPlan``, ``slot_read_ids``,
``device_read_sets``, ``_round_widths``, ``auto_head_k``,
``device_write_bands``, ``build_halo_plan``). The port calls the plan
``build_halo_plan`` with its flat pack: one stripe, lane group 1, ``sz`` =
``n_padded`` and the sentinel ``n_padded`` in inert slots, so the slot
decode ``w >> log2(group) < sz`` reads the port's slot words as they
are. "Device" below is a rank of the port's mesh, and "chip" a rank's
card; the ppermute rounds are ``parallel/mesh.ppermute``.

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

from dataclasses import dataclass, field
from typing import List, Tuple

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


# -- sparse boundary exchange (Zhao & Canny, arXiv:1312.3020) ---------------
#
# The vertex-sharded step's dense exchange moves the WHOLE rank vector
# every iteration (all_gather of z + full-width reduce-scatter of the
# contribution merge), but on power-law graphs most of a chip's rank
# entries are irrelevant to most peers. The halo plan below derives,
# ONCE at build time from the packed slot tables, exactly which remote
# vertices each chip's edges actually gather (its per-owner READ SETS)
# and which destination ranges each chip's partials actually write (its
# WRITE BAND) — compacted into static int32 tables the step consumes as
# runtime arguments, so there is zero per-iteration host work and the
# per-iteration exchanged bytes scale with the BOUNDARY size instead of
# n. The high in-degree HEAD (read by nearly every shard on an
# RMAT/crawl graph) is replicated via one small psum instead of being
# repeated in every point-to-point pair set.

#: Minimum per-round payload width: degenerate 1-element rounds would
#: trace as scalar collectives (muddying the PTC001 bulk-vs-scalar
#: tally) and tiny payloads round up to a wire packet anyway.
_HALO_MIN_WIDTH = 8


@dataclass
class HaloRound:
    """One static point-to-point exchange round: a partial permutation
    over the mesh axis (``perm``: (source, target) device pairs — a
    ``parallel/mesh.ppermute`` argument) carrying a fixed-width payload per
    device. Read rounds move z values owner -> reader at ring offset
    ``offset``; write rounds move contribution windows writer -> owner
    at signed block offset ``offset``."""

    offset: int
    width: int
    perm: Tuple[Tuple[int, int], ...]


@dataclass
class HaloPlan:
    """Build-time sparse-exchange plan for the vertex-sharded step.

    Tables are numpy, one row per device, ready for a sharded
    ``device_put``; pads are inert by construction (send pads index the
    owner's zero slot ``blk``, receive pads land on the trash slot
    ``n_vs`` / the trash band at local index ``blk``).

    Byte model convention: bytes SENT per chip per iteration under the standard
    ring lowering — all_gather/reduce_scatter of an n-vector cost
    ``(ndev-1) * n/ndev`` sends per chip, an all-reduce twice that, a
    ppermute exactly its payload.
    """

    ndev: int
    n_vs: int  # padded sharded state length (multiple of 128 * ndev)
    blk: int  # vertices per device block (n_vs // ndev)
    head_k: int  # replicated head prefix [0, head_k), multiple of 128
    z_item: int  # bytes per exchanged z element
    accum_item: int  # bytes per exchanged contribution element
    rs_merge: bool  # dense comparator merges via reduce-scatter (vs psum)
    read_rounds: List[HaloRound] = field(default_factory=list)
    write_rounds: List[HaloRound] = field(default_factory=list)
    #: per read round: int32 [ndev, width] owner-LOCAL send indices
    #: (pad = blk, the owner's appended zero slot)
    send_idx: List[np.ndarray] = field(default_factory=list)
    #: per read round: int32 [ndev, width] GLOBAL ids of the entries
    #: each device receives (pad = n_vs, the trash slot)
    recv_ids: List[np.ndarray] = field(default_factory=list)
    #: per write round: int32 [ndev] flat global window start per
    #: sending device (inactive = n_vs, a zero region)
    wsend_start: List[np.ndarray] = field(default_factory=list)
    #: per write round: int32 [ndev] owner-local landing start per
    #: receiving device (inactive = blk, the trash band)
    wrecv_start: List[np.ndarray] = field(default_factory=list)
    #: total UNPADDED tail read-set entries over all (owner, reader)
    #: pairs — the boundary the exchange actually moves
    boundary_entries: int = 0
    #: [owner, reader] tail read-set sizes (diagnostics + oracle tests)
    reads_per_pair: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.int64)
    )

    @property
    def halo_fraction(self) -> float:
        """Fraction of the dense all_gather's remotely received entries
        that are actually read remotely (tail boundary over
        ``(ndev-1) * n_vs``) — the sparsity the exchange exploits."""
        denom = (self.ndev - 1) * self.n_vs
        return self.boundary_entries / denom if denom else 0.0

    def sparse_bytes_per_iter(self) -> int:
        """Modeled bytes sent per chip per iteration by the SPARSE
        exchange: head all-reduce + read-round payloads (z dtype) +
        write-round windows (accumulation dtype)."""
        if self.ndev <= 1:
            return 0
        head = 2 * (self.ndev - 1) * self.head_k * self.z_item // self.ndev
        reads = sum(r.width for r in self.read_rounds) * self.z_item
        writes = sum(r.width for r in self.write_rounds) * self.accum_item
        return int(head + reads + writes)

    def overlappable_bytes_per_iter(self) -> int:
        """The OVERLAPPABLE share of the sparse exchange
        (config.halo_async): head all-reduce + read-round payloads — the
        z-side traffic the stale-boundary double buffer moves off
        the critical path (the reads consume LAST iteration's buffer
        while this iteration's ships). The write-band merge stays
        synchronous: contribution windows are consumed by the rank
        update of the same iteration that produced them."""
        if self.ndev <= 1:
            return 0
        head = 2 * (self.ndev - 1) * self.head_k * self.z_item // self.ndev
        reads = sum(r.width for r in self.read_rounds) * self.z_item
        return int(head + reads)

    def dense_bytes_per_iter(self) -> int:
        """Modeled bytes sent per chip per iteration by the DENSE
        exchange this plan replaces — THE one spelling lives in
        parallel/comms.py:dense_exchange_bytes (the dense-mode runs
        publish the same formula), so the comparator every
        sparse-vs-dense gate measures against cannot desynchronize."""
        from pagerank_tpu_torch.parallel.comms import dense_exchange_bytes

        return dense_exchange_bytes(self.ndev, self.blk, self.z_item,
                                    self.accum_item, self.rs_merge)

    def summary(self) -> dict:
        """JSON-safe record for layout_info / bench artifacts."""
        return {
            "head_k": int(self.head_k),
            "read_rounds": len(self.read_rounds),
            "write_rounds": len(self.write_rounds),
            "read_width_total": int(sum(r.width for r in self.read_rounds)),
            "write_width_total": int(
                sum(r.width for r in self.write_rounds)
            ),
            "boundary_entries": int(self.boundary_entries),
            "halo_fraction": float(self.halo_fraction),
            "sparse_bytes_per_iter": self.sparse_bytes_per_iter(),
            "dense_bytes_per_iter": self.dense_bytes_per_iter(),
        }


def slot_read_ids(src_slots: np.ndarray, *, stripe: int, sz: int,
                  group: int) -> np.ndarray:
    """Decode one stripe's packed slot words into the sorted unique
    GLOBAL source ids they gather (sentinel slots excluded) — the read
    set of whatever row range ``src_slots`` covers. Slot words are
    ``(stripe_local_src << log2(group)) | lane_sub`` with sentinel
    local id ``sz`` (ops/ell.py)."""
    log2g = group.bit_length() - 1
    local = np.asarray(src_slots).reshape(-1) >> log2g
    local = local[local < sz]
    if local.size == 0:
        return np.zeros(0, np.int64)
    return np.unique(local.astype(np.int64)) + stripe * sz


def device_read_sets(src_slots: List[np.ndarray], *, ndev: int, sz: int,
                     group: int) -> List[np.ndarray]:
    """Per-device sorted unique global read ids over all stripes.
    ``src_slots[s]`` is the stripe's FULL padded [rows, 128] slot array;
    device d owns rows [d*rows/ndev, (d+1)*rows/ndev) — the engine's
    row sharding (``parallel/mesh.edge_sharding``)."""
    per_dev: List[List[np.ndarray]] = [[] for _ in range(ndev)]
    for s, ss in enumerate(src_slots):
        ss = np.asarray(ss)
        rows = ss.shape[0]
        assert rows % ndev == 0, (rows, ndev)
        rpd = rows // ndev
        for d in range(ndev):
            per_dev[d].append(
                slot_read_ids(ss[d * rpd:(d + 1) * rpd], stripe=s, sz=sz,
                              group=group)
            )
    return [
        np.unique(np.concatenate(chunks)) if chunks else
        np.zeros(0, np.int64)
        for chunks in per_dev
    ]


def _round_widths(pair_sizes: np.ndarray) -> int:
    """Total padded read-round width for a [ndev, ndev] matrix of
    (owner, reader) tail set sizes: one round per ring offset, each
    padded to its max pair (min ``_HALO_MIN_WIDTH``); all-empty
    offsets cost nothing (the round is skipped)."""
    ndev = pair_sizes.shape[0]
    total = 0
    for k in range(1, ndev):
        m = max(int(pair_sizes[d, (d + k) % ndev]) for d in range(ndev))
        if m:
            total += max(m, _HALO_MIN_WIDTH)
    return total


def auto_head_k(pair_sets, *, ndev: int, n_vs: int,
                z_item: int = 4) -> int:
    """The head-replication K rule: choose the RELABELED prefix
    [0, K) whose replication MINIMIZES the modeled per-chip exchange
    bytes — ``2*(ndev-1)/ndev * K`` elements of all-reduce traffic
    bought against the tail rounds' padded-width shrink, evaluated on
    the exact build-time pair sets (``pair_sets[p][d]``: sorted global
    ids owner p sends reader d at K=0). The relabel is descending
    in-degree (ops/ell.py), so the widely read vertices concentrate at
    the front and a prefix captures them compactly; candidates are
    power-of-two multiples of 128 (plus 0), capped at half the state —
    beyond that 'replication' stops being a head. A reader-count
    threshold over-replicates on dense R-MAT tails."""
    if ndev <= 1:
        return 0
    cap = min((n_vs // 256) * 128, 1 << 20)
    cands = [0]
    k = 128
    while k <= cap:
        cands.append(k)
        k *= 2
    best_k, best_cost = 0, None
    sizes = np.zeros((ndev, ndev), np.int64)
    for K in cands:
        for p in range(ndev):
            for d in range(ndev):
                s = pair_sets[p][d]
                sizes[p, d] = s.size - np.searchsorted(s, K)
        cost = (2 * (ndev - 1) * K // ndev + _round_widths(sizes)) \
            * z_item
        if best_cost is None or cost < best_cost:
            best_k, best_cost = K, cost
    return best_k


def device_write_bands(row_ranks: List[np.ndarray],
                       present_ids: List[np.ndarray], *, ndev: int,
                       n_vs: int) -> List[Tuple[int, int]]:
    """Per-device [lo, hi) hull of flat contribution positions the
    device's slot rows can write: rows are block-sorted and evenly
    row-sharded, so each device's blocks per stripe are one contiguous
    run — the hull over stripes is the union. ``row_ranks[s]`` are the
    stripe's dense block RANKS (ops/ell.dense_block_ranks),
    ``present_ids[s]`` maps rank -> global block id."""
    lo = [n_vs] * ndev
    hi = [0] * ndev
    for rk, ids in zip(row_ranks, present_ids):
        rk = np.asarray(rk)
        ids = np.asarray(ids)
        rows = rk.shape[0]
        assert rows % ndev == 0, (rows, ndev)
        rpd = rows // ndev
        for d in range(ndev):
            sl = rk[d * rpd:(d + 1) * rpd]
            if sl.size == 0:
                continue
            lo[d] = min(lo[d], int(ids[int(sl[0])]) * 128)
            hi[d] = max(hi[d], int(ids[int(sl[-1])]) * 128 + 128)
    return [(min(lo[d], n_vs), min(max(hi[d], lo[d]), n_vs))
            for d in range(ndev)]


def build_halo_plan(src_slots: List[np.ndarray],
                    row_ranks: List[np.ndarray],
                    present_ids: List[np.ndarray], *, ndev: int,
                    n_vs: int, sz: int, group: int, head_k: int = -1,
                    z_item: int = 4, accum_item: int = 4,
                    rs_merge: bool = True) -> HaloPlan:
    """Derive the full sparse-exchange plan from the packed slot
    tables (see module comment). ``head_k``: -1 = the auto rule
    (:func:`auto_head_k`), 0 = no replication, > 0 = explicit K
    (rounded up to a 128 multiple, clamped to ``n_vs``)."""
    if n_vs % (128 * max(1, ndev)):
        raise ValueError(f"n_vs {n_vs} not a multiple of 128*{ndev}")
    blk = n_vs // ndev
    reads = device_read_sets(src_slots, ndev=ndev, sz=sz, group=group)

    # Full (owner, reader) remote read sets BEFORE head removal — the
    # K rule evaluates its byte model on exactly these.
    pair_sets = [[np.zeros(0, np.int64)] * ndev for _ in range(ndev)]
    for d, ids in enumerate(reads):
        remote = ids[ids // blk != d]
        owners = remote // blk
        cuts = np.searchsorted(owners, np.arange(ndev + 1))
        for p in range(ndev):
            pair_sets[p][d] = remote[cuts[p]:cuts[p + 1]]

    if head_k < 0:
        K = auto_head_k(pair_sets, ndev=ndev, n_vs=n_vs, z_item=z_item)
    else:
        K = min(-(-int(head_k) // 128) * 128, n_vs)
    plan = HaloPlan(ndev=ndev, n_vs=n_vs, blk=blk, head_k=K,
                    z_item=z_item, accum_item=accum_item,
                    rs_merge=rs_merge)
    if ndev <= 1:
        plan.reads_per_pair = np.zeros((ndev, ndev), np.int64)
        return plan

    # -- tail read rounds: owner d -> reader (d+k) % ndev ------------------
    sizes = np.zeros((ndev, ndev), np.int64)
    for p in range(ndev):
        for d in range(ndev):
            s = pair_sets[p][d]
            s = s[np.searchsorted(s, K):]  # drop the replicated head
            pair_sets[p][d] = s
            sizes[p, d] = s.size
    plan.reads_per_pair = sizes
    plan.boundary_entries = int(sizes.sum())
    for k in range(1, ndev):
        widths = [sizes[d, (d + k) % ndev] for d in range(ndev)]
        m_k = int(max(widths))
        if m_k == 0:
            continue
        m_k = max(m_k, _HALO_MIN_WIDTH)
        send = np.full((ndev, m_k), blk, np.int32)
        recv = np.full((ndev, m_k), n_vs, np.int32)
        perm = []
        for d in range(ndev):
            r = (d + k) % ndev
            s = pair_sets[d][r]
            if s.size == 0:
                continue
            perm.append((d, r))
            send[d, :s.size] = (s - d * blk).astype(np.int32)
            recv[r, :s.size] = s.astype(np.int32)
        plan.read_rounds.append(HaloRound(k, m_k, tuple(perm)))
        plan.send_idx.append(send)
        plan.recv_ids.append(recv)

    # -- write rounds: writer d -> owner d+k (signed, no wrap) -------------
    bands = device_write_bands(row_ranks, present_ids, ndev=ndev,
                               n_vs=n_vs)
    seg = {}
    for d, (lo, hi) in enumerate(bands):
        for p in range(ndev):
            if p == d:
                continue  # own overlap rides the local slice, not the wire
            s_lo = max(lo, p * blk)
            s_hi = min(hi, (p + 1) * blk)
            if s_lo < s_hi:
                seg.setdefault(p - d, {})[d] = (s_lo, s_hi - s_lo)
    for k in sorted(seg):
        segs = seg[k]
        w_k = max(_HALO_MIN_WIDTH, max(w for _lo, w in segs.values()))
        ws = np.full(ndev, n_vs, np.int32)
        wr = np.full(ndev, blk, np.int32)
        perm = []
        for d, (s_lo, _w) in sorted(segs.items()):
            perm.append((d, d + k))
            ws[d] = s_lo
            wr[d + k] = s_lo - (d + k) * blk
        plan.write_rounds.append(HaloRound(k, int(w_k), tuple(perm)))
        plan.wsend_start.append(ws)
        plan.wrecv_start.append(wr)
    return plan
