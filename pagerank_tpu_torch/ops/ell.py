"""Blocked-ELL edge packing, and the segment plan the CUDA kernel reads.

Port of ``pagerank_tpu/ops/ell.py:65-110, 238-397`` at lane group 1 and
one stripe (the only form this slice runs): ``ell_pack`` here gives the
same arrays, bit for bit, as the JAX package's ``ell_pack(graph)``.

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

**Segment plan (new in the port).** The relabel makes block 0 the
deepest: on an R-MAT scale-22 graph a hub block has ~10^5 rows. On the
card blocks of a grid run in parallel and in no order, so one CTA per
dst block would leave the whole sweep waiting on block 0.
:func:`segment_plan` cuts every block's row range into segments of at
most ``SEG_ROWS`` rows; the kernel gives each segment a CTA and then
sums each block's segment partials in segment order — a fixed order,
so results are bit-identical from run to run without atomics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pagerank_tpu_torch.graph import Graph
from pagerank_tpu_torch.ops import LANES

#: Rows per segment of the kernel's work table: one CTA sums at most
#: this many slot rows before its partial goes to the second pass.
SEG_ROWS = 64


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
    one stripe over the whole padded vertex range)."""
    n = graph.n
    n_padded = -(-n // LANES) * LANES
    num_blocks = n_padded // LANES

    order = np.argsort(-graph.in_degree.astype(np.int64), kind="stable")
    perm = order.astype(np.int32)
    inv_perm = np.empty(n, dtype=np.int32)
    inv_perm[perm] = np.arange(n, dtype=np.int32)

    new_dst = inv_perm[graph.dst].astype(np.int64)
    new_src = inv_perm[graph.src].astype(np.int64)
    # dst-major slot order, relabeled-src-ascending within a dst: the
    # JAX packer's (stripe, dst, src) order with one stripe.
    sort = np.lexsort((new_src, new_dst))
    new_dst = new_dst[sort]
    new_src = new_src[sort]
    weight = graph.edge_weight[sort]

    e = new_dst.shape[0]
    if e == 0:
        return EllPack(
            n=n, n_padded=n_padded, num_blocks=num_blocks,
            src=np.zeros((0, LANES), np.int32),
            weight=np.zeros((0, LANES), np.float64),
            row_block=np.zeros(0, np.int32), perm=perm, inv_perm=inv_perm,
            num_real_edges=0,
        )
    # Depth of each slot within its dst's run of in-edges = its row.
    starts = np.flatnonzero(np.r_[True, new_dst[1:] != new_dst[:-1]])
    cnt = np.diff(np.r_[starts, e])
    row = np.arange(e, dtype=np.int64) - np.repeat(starts, cnt)
    # Rows per block = max in-degree over the block's lanes.
    run_block = new_dst[starts] // LANES
    bstarts = np.flatnonzero(np.r_[True, run_block[1:] != run_block[:-1]])
    block_rows = np.zeros(num_blocks, np.int64)
    block_rows[run_block[bstarts]] = np.maximum.reduceat(cnt, bstarts)
    row_offset = np.concatenate([[0], np.cumsum(block_rows)])
    rows_total = int(row_offset[-1])

    src_slots = np.zeros((rows_total, LANES), np.int32)
    w_slots = np.zeros((rows_total, LANES), np.float64)
    flat = (row_offset[new_dst // LANES] + row) * LANES + new_dst % LANES
    src_slots.reshape(-1)[flat] = new_src.astype(np.int32)
    w_slots.reshape(-1)[flat] = weight
    row_block = np.repeat(np.arange(num_blocks, dtype=np.int32), block_rows)
    return EllPack(
        n=n, n_padded=n_padded, num_blocks=num_blocks,
        src=src_slots, weight=w_slots, row_block=row_block,
        perm=perm, inv_perm=inv_perm, num_real_edges=int(e),
    )


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
    """

    seg_row_start: np.ndarray
    seg_block: np.ndarray
    block_seg_start: np.ndarray
    num_rows: int

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
    return SegmentPlan(
        seg_row_start=seg_row_start.astype(np.int32),
        seg_block=seg_block.astype(np.int32),
        block_seg_start=block_seg_start.astype(np.int32),
        num_rows=int(rb.size),
    )


def ell_spmv_reference(pack: EllPack, z: np.ndarray) -> np.ndarray:
    """Numpy oracle for the packed SpMV: y[d] = sum over in-edges of
    z[src]*w, in RELABELED space. z and result are length n."""
    y2 = np.zeros((pack.num_blocks, LANES), dtype=z.dtype)
    v = z[pack.src] * pack.weight
    np.add.at(y2, pack.row_block, v)
    return y2.reshape(-1)[: pack.n]
