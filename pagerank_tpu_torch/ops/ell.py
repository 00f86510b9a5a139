"""Blocked-ELL edge packing, and the segment plan the CUDA kernels read.

Port of ``pagerank_tpu/ops/ell.py:65-153, 238-397`` at lane group 1
with no block deal (grouped lanes are an XLA-path packing; the deal
belongs to the multi-GPU forms): ``ell_pack`` and ``ell_pack_striped``
here give the same arrays, bit for bit, as the JAX package's
``ell_pack(graph)`` and ``ell_pack_striped(graph, stripe_size=s)``.

Layout:
  - vertices are RELABELED by descending in-degree (stable), so the 128
    dsts sharing a block have similar in-degree and the per-block depth
    max(in_degree) wastes little padding on power-law graphs;
  - dst block b owns lanes 0..127 = relabeled dsts b*128..b*128+127;
  - slot (r, l) of block b holds one in-edge of dst b*128+l; a block's
    rows are its in-degree depth; blocks are concatenated into a tall
    (rows, 128) array with a per-row block id (ascending);
  - padding slots have weight 0 and src 0; blocks whose 128 dsts all
    have in-degree 0 have no rows.

All ids inside the packed arrays are RELABELED; ``perm`` maps relabeled
-> original id, ``inv_perm`` the reverse.

**Partition-centric layout.** Packing with ``stripe_size`` set to a
partition span makes the stripes SOURCE partitions: slots are
sub-binned by source partition within each dst block by the same one
sort, with partition-local source ids. The engine concatenates the
partitions partition-major, numbers each partition's (dst block,
partition) pairs densely (:func:`dense_block_ranks`), sums slot rows
into pairs with kernel K2 and expands the pairs into blocks.

**Segment plan (new in the port).** The relabel makes block 0 the
deepest: on an R-MAT scale-22 graph a hub block has ~10^5 rows. On the
card CTAs run in parallel and in no order, so one worker per dst block
would leave the whole sweep waiting on block 0. :func:`segment_plan`
cuts every block's row range into segments of at most ``SEG_ROWS`` rows
and lists the blocks that have none; the kernel's lane groups take the
segments in plan order (hubs first), and each block's partials are
summed in segment order — a fixed order, so results are bit-identical
from run to run. K2 reads the same plan cut over the global dense pair
ranks of the partitioned layout (pairs in place of blocks): pairs are
contiguous and ascending in its partition-major row order, so a
segment never straddles a pair or a partition. :func:`pair_plan` adds
what K2 needs to write dst blocks itself: each pair's block, each
block's pairs in partition order, and the blocks no pair feeds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pagerank_tpu_torch.graph import Graph
from pagerank_tpu_torch.ops import LANES

#: Rows per segment of the kernels' work table: a lane group sums at most
#: this many slot rows before its partial is added to its group's.
SEG_ROWS = 64
#: A dst block of at most WHOLE x seg_rows slot rows is summed whole by
#: one lane group of K1 or K2 (``kWhole`` of csrc/ell_contrib*.cu); a
#: longer block's segments go to lane groups one by one and meet by
#: tickets. Counting rows, not segments, keeps a K2 block of many short
#: pairs whole: it hands no pair sums on.
WHOLE = 4


@dataclass
class EllPack:
    """Destination-blocked ELL representation of a graph (relabeled)."""

    n: int  # vertex count (unpadded)
    n_padded: int  # next multiple of 128
    num_blocks: int  # n_padded // 128
    src: np.ndarray  # int32 [rows, 128] — relabeled source id per slot
    weight: np.ndarray  # float64 [rows, 128] — 1/out_degree, 0 for padding
    row_block: np.ndarray  # int32 [rows] — dst block id per row, ascending
    perm: np.ndarray  # int32 [n] — relabeled id -> original id
    inv_perm: np.ndarray  # int32 [n] — original id -> relabeled id
    num_real_edges: int

    @property
    def num_rows(self) -> int:
        return int(self.src.shape[0])

    @property
    def padding_ratio(self) -> float:
        return self.num_rows * LANES / max(1, self.num_real_edges)


def ell_pack(graph: Graph) -> EllPack:
    """Pack a dst-sorted COO graph into blocked-ELL form (lane group 1,
    one stripe over the whole padded vertex range, so stripe-local
    source ids equal relabeled ids)."""
    n_padded = -(-graph.n // LANES) * LANES
    sp = ell_pack_striped(graph, stripe_size=max(LANES, n_padded))
    return EllPack(
        n=sp.n, n_padded=sp.n_padded, num_blocks=sp.num_blocks,
        src=sp.src[0], weight=sp.weight[0], row_block=sp.row_block[0],
        perm=sp.perm, inv_perm=sp.inv_perm, num_real_edges=sp.num_real_edges,
    )


@dataclass
class StripedEllPack:
    """ELL packing split into contiguous SOURCE-range stripes: stripe s
    packs only the edges whose relabeled source lies in
    [s*stripe_size, (s+1)*stripe_size), with stripe-LOCAL source ids.
    A dst block has rows in every stripe that feeds it."""

    n: int
    n_padded: int
    num_blocks: int
    stripe_size: int  # vertices per stripe (multiple of 128)
    src: list  # [stripes] int32 [rows_s, 128] — stripe-local source per slot
    weight: list  # [stripes] float64 [rows_s, 128]; 0 marks padding
    row_block: list  # [stripes] int32 [rows_s], ascending per stripe
    perm: np.ndarray
    inv_perm: np.ndarray
    num_real_edges: int

    @property
    def n_stripes(self) -> int:
        return len(self.src)

    @property
    def num_rows(self) -> int:
        return int(sum(s.shape[0] for s in self.src))

    @property
    def padding_ratio(self) -> float:
        return self.num_rows * LANES / max(1, self.num_real_edges)


def ell_pack_striped(graph: Graph, stripe_size: int) -> StripedEllPack:
    """Pack a graph into source-striped blocked-ELL form at lane group 1.

    ``stripe_size`` must be a positive multiple of 128. Slots are in
    (stripe, relabeled dst, relabeled src) order — the JAX packer's
    ``lexsort``, done here as one stable argsort of a composite int64
    key when the key fits (the same order: a stable sort over the same
    total order, ties kept in input order)."""
    if stripe_size <= 0 or stripe_size % LANES:
        raise ValueError(f"stripe_size must be a positive multiple of {LANES}")
    n = graph.n
    n_padded = -(-n // LANES) * LANES
    num_blocks = n_padded // LANES
    n_stripes = -(-n_padded // stripe_size)

    order = np.argsort(-graph.in_degree.astype(np.int64), kind="stable")
    perm = order.astype(np.int32)
    inv_perm = np.empty(n, dtype=np.int32)
    inv_perm[perm] = np.arange(n, dtype=np.int32)

    new_dst = inv_perm[graph.dst].astype(np.int64)
    new_src = inv_perm[graph.src].astype(np.int64)
    stripe_of = new_src // stripe_size
    if n_stripes * n_padded * n_padded < 1 << 62:
        key = (stripe_of * n_padded + new_dst) * n_padded + new_src
        sort = np.argsort(key, kind="stable")
        del key
    else:
        sort = np.lexsort((new_src, new_dst, stripe_of))
    new_dst = new_dst[sort]
    new_src = new_src[sort]
    weight = graph.edge_weight[sort]
    stripe_of = stripe_of[sort]

    srcs, weights, row_blocks = [], [], []
    bounds = np.searchsorted(stripe_of, np.arange(n_stripes + 1))
    for s in range(n_stripes):
        lo, hi = bounds[s], bounds[s + 1]
        d_s = new_dst[lo:hi]
        e = d_s.shape[0]
        if e == 0:
            srcs.append(np.zeros((0, LANES), np.int32))
            weights.append(np.zeros((0, LANES), np.float64))
            row_blocks.append(np.zeros(0, np.int32))
            continue
        # Depth of each slot within its dst's run of in-edges = its row;
        # rows per block (in this stripe) = max over the block's lanes.
        starts = np.flatnonzero(np.r_[True, d_s[1:] != d_s[:-1]])
        cnt = np.diff(np.r_[starts, e])
        row = np.arange(e, dtype=np.int64) - np.repeat(starts, cnt)
        run_block = d_s[starts] // LANES
        bstarts = np.flatnonzero(np.r_[True, run_block[1:] != run_block[:-1]])
        block_rows = np.zeros(num_blocks, np.int64)
        block_rows[run_block[bstarts]] = np.maximum.reduceat(cnt, bstarts)
        row_offset = np.concatenate([[0], np.cumsum(block_rows)])
        rows_total = int(row_offset[-1])
        src_slots = np.zeros((rows_total, LANES), np.int32)
        w_slots = np.zeros((rows_total, LANES), np.float64)
        flat = (row_offset[d_s // LANES] + row) * LANES + d_s % LANES
        src_slots.reshape(-1)[flat] = (new_src[lo:hi]
                                       - s * stripe_size).astype(np.int32)
        w_slots.reshape(-1)[flat] = weight[lo:hi]
        srcs.append(src_slots)
        weights.append(w_slots)
        row_blocks.append(
            np.repeat(np.arange(num_blocks, dtype=np.int32), block_rows))

    return StripedEllPack(
        n=n, n_padded=n_padded, num_blocks=num_blocks,
        stripe_size=stripe_size, src=srcs, weight=weights,
        row_block=row_blocks, perm=perm, inv_perm=inv_perm,
        num_real_edges=int(new_dst.shape[0]),
    )


def dense_block_ranks(row_block: np.ndarray, num_blocks: int):
    """(ranks, present_ids, num_present, is_prefix) for a SORTED block-id
    array: ``ranks`` renumbers each distinct block to its 0-based run
    index, ``present_ids`` maps rank -> block id, ``is_prefix`` says the
    present blocks are exactly 0..num_present-1 (the expansion is then a
    slice add). Empty input gets one sentinel id (``num_blocks - 1``) so
    shapes stay non-empty; its pair has no rows and sums to zero."""
    rb = row_block
    starts = (
        np.concatenate([[True], rb[1:] != rb[:-1]])
        if len(rb) else np.zeros(0, bool)
    )
    ids = rb[starts].astype(np.int32)
    ranks = (np.cumsum(starts) - 1).astype(np.int32)
    pcount = max(1, len(ids))
    prefix = bool(len(ids) == ids[-1] + 1 if len(ids) else True)
    if len(ids) == 0:
        ids = np.array([num_blocks - 1], np.int32)
    return ranks, ids, pcount, prefix


def sentinel_slots(pack: EllPack) -> np.ndarray:
    """Slot table with every inert slot (weight 0: ELL padding) pointed
    at the zero sentinel ``n_padded`` — the form the engine and the
    kernel consume (``jax_engine.py:1117-1121``). The rank vector is
    prescaled by 1/out-degree instead of weighting each slot."""
    return np.where(pack.weight != 0, pack.src, np.int32(pack.n_padded))


@dataclass
class SegmentPlan:
    """The kernel's work table (see the module docstring).

    seg_row_start: int32 [S+1] — segment s covers rows
        [seg_row_start[s], seg_row_start[s+1]).
    seg_block: int32 [S] — the dst block of each segment (ascending).
    block_seg_start: int32 [num_blocks+1] — block b owns segments
        [block_seg_start[b], block_seg_start[b+1]); empty blocks none.
    num_rows: the slot rows the plan covers (seg_row_start[-1]), kept
        on the host so a caller can check a plan against its slots.
    empty_groups: int32 [E] — the blocks with no segment, ascending
        (K1 writes them 0).
    item_start, item_segs: int32 [I+1], [S] — the kernels' work items:
        item i is the segments item_segs[item_start[i]:item_start[i+1]].
        The first ``num_split`` items are one segment each, of the
        blocks of more than ``WHOLE`` x ``seg_rows`` slot rows; each
        later item is a whole block (:func:`work_items`).
    num_split: the items that are segments of split blocks.
    """

    seg_row_start: np.ndarray
    seg_block: np.ndarray
    block_seg_start: np.ndarray
    num_rows: int
    empty_groups: np.ndarray
    item_start: np.ndarray
    item_segs: np.ndarray
    num_split: int

    @property
    def num_items(self) -> int:
        return int(self.item_start.shape[0]) - 1

    @property
    def num_segments(self) -> int:
        return int(self.seg_block.shape[0])


def segment_plan(row_block: np.ndarray, num_blocks: int,
                 seg_rows: int = SEG_ROWS) -> SegmentPlan:
    """Cut every dst block's row range into segments of at most
    ``seg_rows`` rows. ``row_block`` must be ascending (ell_pack's)."""
    if seg_rows < 1:
        raise ValueError(f"seg_rows must be >= 1, got {seg_rows}")
    rb = np.asarray(row_block, dtype=np.int64)
    if rb.size and (np.any(np.diff(rb) < 0) or rb[0] < 0
                    or rb[-1] >= num_blocks):
        raise ValueError("row_block must be ascending block ids in "
                         "[0, num_blocks)")
    counts = np.bincount(rb, minlength=num_blocks)
    block_row_start = np.concatenate([[0], np.cumsum(counts)])
    nseg = -(-counts // seg_rows)
    block_seg_start = np.concatenate([[0], np.cumsum(nseg)])
    num_segs = int(block_seg_start[-1])
    seg_block = np.repeat(np.arange(num_blocks, dtype=np.int64), nseg)
    k = np.arange(num_segs, dtype=np.int64) - block_seg_start[seg_block]
    seg_row_start = np.concatenate([
        block_row_start[seg_block] + k * seg_rows, [rb.size]
    ])
    items = work_items([np.arange(block_seg_start[b], block_seg_start[b + 1])
                        for b in np.flatnonzero(nseg)], seg_row_start,
                       WHOLE * seg_rows)
    return SegmentPlan(
        seg_row_start=seg_row_start.astype(np.int32),
        seg_block=seg_block.astype(np.int32),
        block_seg_start=block_seg_start.astype(np.int32),
        num_rows=int(rb.size),
        empty_groups=np.flatnonzero(nseg == 0).astype(np.int32),
        **items,
    )


def work_items(block_segs, seg_row_start, whole_rows: int):
    """The kernels' work items from each non-empty block's segments (a
    list, in block order, of the segment ids each block sums, in its sum
    order; segment s is rows [seg_row_start[s], seg_row_start[s+1])):
    every segment of a block of more than ``whole_rows`` rows as an item
    of its own, in segment order, then each other block as one item.
    Returns the ``item_start``, ``item_segs`` and ``num_split`` fields
    of a plan."""
    seg_rows = np.diff(np.asarray(seg_row_start, np.int64))
    deep = [int(seg_rows[np.asarray(segs, np.int64)].sum()) > whole_rows
            for segs in block_segs]
    split = [s for segs, d in zip(block_segs, deep) if d for s in segs]
    kept = [segs for segs, d in zip(block_segs, deep) if not d]
    sizes = [1] * len(split) + [len(segs) for segs in kept]
    segs = np.concatenate([np.asarray(split, np.int64)]
                          + [np.asarray(x, np.int64) for x in kept]) \
        if sizes else np.zeros(0, np.int64)
    return {"item_start": np.concatenate([[0], np.cumsum(sizes)])
            .astype(np.int32),
            "item_segs": np.asarray(segs, np.int32),
            "num_split": len(split)}


@dataclass
class PairPlan(SegmentPlan):
    """K2's work table: the segment plan over the dense pair ranks
    (groups are pairs; ``empty_groups`` the pairs with no row, as an
    empty partition's sentinel pair; the work items cut by dst block:
    a whole block's item holds the segments of all its pairs, in
    partition order), plus the pair -> block tables:

    pair_block: int32 [P] — the dst block of each pair.
    block_pair_start: int32 [num_blocks+1] — block b is fed by the pairs
        block_pairs[block_pair_start[b]:block_pair_start[b+1]].
    block_pairs: int32 [L] — the pairs that have rows, by block, each
        block's in partition order (pair order).
    empty_blocks: int32 [E] — the blocks no pair with rows feeds.
    sentinel: the local sentinel of the slot words (the span), which
        reads a zero of every window.
    """

    pair_block: np.ndarray
    block_pair_start: np.ndarray
    block_pairs: np.ndarray
    empty_blocks: np.ndarray
    sentinel: int

    @property
    def num_blocks(self) -> int:
        return int(self.block_pair_start.shape[0]) - 1


def pair_plan(row_pair: np.ndarray, num_pairs: int, pair_block: np.ndarray,
              num_blocks: int, sentinel: int,
              seg_rows: int = SEG_ROWS) -> PairPlan:
    """The segment plan of ``row_pair`` over ``num_pairs`` pairs and
    the tables by which K2 sums pairs into their ``num_blocks`` dst
    blocks in partition order. A pair with no row (it sums to zero) is
    left out of its block's list: adding +0.0 to a sum that starts at
    +0.0 changes no bit."""
    seg = segment_plan(row_pair, num_pairs, seg_rows)
    pb = np.asarray(pair_block, dtype=np.int64)
    if pb.shape != (num_pairs,) or (pb.size and (
            pb.min() < 0 or pb.max() >= num_blocks)):
        raise ValueError(f"pair_block must be {num_pairs} block ids in "
                         f"[0, {num_blocks})")
    pss = seg.block_seg_start
    live = np.diff(pss) > 0
    pairs = np.flatnonzero(live)
    order = np.argsort(pb[pairs], kind="stable")  # pair order within a block
    block_pairs = pairs[order]
    counts = np.bincount(pb[pairs], minlength=num_blocks)
    bps = np.concatenate([[0], np.cumsum(counts)])
    fields = vars(seg)
    fields.update(work_items([
        np.concatenate([np.arange(pss[p], pss[p + 1])
                        for p in block_pairs[bps[b]:bps[b + 1]]])
        for b in np.flatnonzero(counts)], seg.seg_row_start,
        WHOLE * seg_rows))
    return PairPlan(
        **fields,
        pair_block=pb.astype(np.int32),
        block_pair_start=bps.astype(np.int32),
        block_pairs=block_pairs.astype(np.int32),
        empty_blocks=np.flatnonzero(counts == 0).astype(np.int32),
        sentinel=int(sentinel),
    )


def ell_spmv_reference(pack: EllPack, z: np.ndarray) -> np.ndarray:
    """Numpy oracle for the packed SpMV: y[d] = sum over in-edges of
    z[src]*w, in RELABELED space. z and result are length n."""
    y2 = np.zeros((pack.num_blocks, LANES), dtype=z.dtype)
    v = z[pack.src] * pack.weight
    np.add.at(y2, pack.row_block, v)
    return y2.reshape(-1)[: pack.n]
