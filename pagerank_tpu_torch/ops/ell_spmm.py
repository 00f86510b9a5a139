"""K1w: the blocked-ELL contribution SpMM, k rank columns in one launch.

Replaces ``pagerank_tpu/ops/spmv.py:380 ell_contrib_spmm`` (called from
``pagerank_tpu/engines/ppr.py:197-216``), which gathers one k-wide row
of a [sz + 1, k] matrix per slot. The kernel is
``pagerank_tpu_torch/csrc/ell_contrib_spmm.cu``, built for ``sm_90a`` at
first use (kernels/build.py) and called through ctypes. On the PPR path
it takes the place of K1 launched once a column
(``ops/ell_spmv.py:bind_columns``), which stays as the yardstick.

Layout: ``z2`` is row-major, [n_state + 8, kp]: row v holds vertex v's
prescaled value in each column, the last 8 rows zero (inert slots read
the sentinel row n_state). ``kp`` is the bound width rounded up to whole
16-byte rows (:func:`row_width`). The output is [num_blocks * 128, kp]
in z2's dtype. A call runs its first ``kc`` columns (the live ones)
and leaves the others unread and unwritten. Besides, the kernel folds
block 0's 128 lane sums pairwise (``ops/spmv.py:fold_rows``'s order),
in the sum's dtype, into ``SpmmLauncher.mass`` [kp]: the PPR engine
puts its dangling vertices in block 0, so that is each column's
dangling mass, with no further launch.

What bounds it on the H100: device-memory bytes — the slot table once,
each column of z and of the output once, the plan
(``analysis/kernels.py:k1_cost(columns=k)``). What the design does
about it (the source note has the detail): a slot's gather is a
contiguous piece of one z2 row, ``kt`` columns of 16-byte vectors (one
32-byte sector at kt = 8 f32), so no gather wastes a sector; the columns
run in tiles of ``kt``, tile-major, so a tile of z2 stays in L2 while
the slot words are read once a tile; the rest is K1's (persistent CTAs,
the host plan's work items, ticket finishers). The sums keep K1's order
in every column, so column c equals K1 run on column c alone, bit for
bit, at every tile width, and a column's answer does not depend on its
batch-mates.

The tile of a call is the bound ``kt`` or, when fewer columns are live,
the narrowest built tile that holds them (:func:`tile_width`): a lone
PPR query runs a 4-column tile, a daemon batch of 8 an 8-column one.
On the H100 the widest tile won the sweep: one pass over the slot
words with 256-byte row gathers beat tiles of z2 kept in L2 (PERF.md),
so a 64-column chunk is one tile. No head of z2 is staged in shared
memory: a staged head measured slower at every tile width (PERF.md).

The wrapper launches the kernel for a CUDA tensor, or raises; it takes
the plain version, :func:`ell_contrib_spmm_rows_reference`, only for
tensors on the CPU. :func:`bind_spmm` checks the inputs once and returns
a launcher that a step calls with its live column count. ``launches``
counts the kernel launches, one a call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pagerank_tpu_torch.obs import costs
from pagerank_tpu_torch.ops import LANES
from pagerank_tpu_torch.ops import ell_spmv, spmv
from pagerank_tpu_torch.ops.ell import SegmentPlan

#: Kernel launches made through this module in this process.
launches = 0

# The kernel's geometry: the constants of csrc/ell_contrib_spmm.cu (a
# test holds them equal).
#: Threads of a CTA.
THREADS = 1024
#: Bytes of one vector load.
VECTOR_BYTES = 16
#: 16-byte gathers a thread keeps in flight.
IN_FLIGHT = 4
#: The tile widths (columns) the source builds an entry point for.
TILES = (4, 8, 16, 32, 64)
#: The tile the PPR engine binds over f32 sums: the best of the
#: 64-column sweep in chip_smoke.py phase 12(b) on the H100 (PERF.md),
#: one tile a chunk.
KT = 64
#: The tile over f64 sums: twice the sum registers, so tiles of 32 and
#: 64 spill at 64 registers a thread, and 16 ran the f64 64-column
#: SpMM fastest in the same sweep (PERF.md).
KT_F64 = 16

_TAGS = {torch.float32: "f32", torch.float64: "f64"}
_PAIRS = {(torch.float32, torch.float32), (torch.float32, torch.float64),
          (torch.float64, torch.float64)}


def entry(z_dtype, accum_dtype, kt: int) -> str:
    """The C entry point of a (z dtype, sum dtype, tile) triple."""
    return f"ell_contrib_spmm_{_TAGS[z_dtype]}_{_TAGS[accum_dtype]}_kt{kt}"


def default_tile(accum_dtype) -> int:
    """The tile a binding takes unless told: :data:`KT` over f32 sums,
    :data:`KT_F64` over f64 sums."""
    return KT_F64 if accum_dtype == torch.float64 else KT


def row_width(width: int, item: int) -> int:
    """``kp``: ``width`` columns rounded up to whole 16-byte rows."""
    vec = VECTOR_BYTES // item
    return -(-int(width) // vec) * vec


def tile_width(kc: int, kt: int) -> int:
    """The tile a call of ``kc`` live columns runs: ``kt``, or the
    narrowest built tile that holds all ``kc`` columns when that is
    narrower."""
    if kt not in TILES:
        raise ValueError(f"tile {kt} is not built (built: {TILES})")
    return min(kt, next((t for t in TILES if t >= kc), kt))


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How a tile of ``kt`` columns of an ``item``-byte type maps onto
    threads (the source's ``Tile``)."""

    vec: int  # elements of a 16-byte vector
    threads_per_lane: int
    vectors_per_thread: int
    group_threads: int  # threads of a lane group
    groups: int  # lane groups of a CTA
    loads: int  # vectors of a row a thread loads before their adds
    batch: int  # slot rows a thread keeps in flight


def geometry(kt: int, item: int) -> Geometry:
    vec = VECTOR_BYTES // item
    vecs = kt // vec
    tpl = min(vecs, THREADS // LANES)
    vpt = vecs // tpl
    loads = min(vpt, IN_FLIGHT)
    return Geometry(vec=vec, threads_per_lane=tpl, vectors_per_thread=vpt,
                    group_threads=LANES * tpl,
                    groups=THREADS // (LANES * tpl), loads=loads,
                    batch=IN_FLIGHT // loads)


def persistent_grid(items: int, tiles: int, kt: int, item: int,
                    device_kind: Optional[str] = None) -> int:
    """CTAs of a launch over ``items`` work items (the plan's items and
    its empty blocks) in each of ``tiles`` tiles: one per SM, fewer when
    the work fills fewer lane groups."""
    sms = costs.device_spec(device_kind).sms
    work = int(items) * int(tiles)
    return max(1, min(sms, -(-work // geometry(kt, item).groups)))


def split_extent(plan: SegmentPlan) -> int:
    """The segments a tile's workspace holds: one more than the largest
    segment of a split (deep) block, 0 where no block is split. The
    in-degree relabel puts the deep blocks first, so that is a prefix of
    the segments."""
    if plan.num_split == 0:
        return 0
    return int(plan.item_segs[: plan.num_split].max()) + 1


def z2_buffer(n_state: int, width: int, dtype, device) -> torch.Tensor:
    """A zeroed z2 of ``width`` columns: [n_state + 8, row_width]."""
    item = torch.empty((), dtype=dtype).element_size()
    return torch.zeros((n_state + 8, row_width(width, item)), dtype=dtype,
                       device=device)


@dataclasses.dataclass
class Workspace:
    """K1w's scratch for ``tiles`` tiles: ``partial`` and ``chunk_sum``
    [tiles, seg_stride, 128, kt] flat in the sum's dtype, and
    ``counter`` int32 [tiles * blocks + tiles * seg_stride], zero (the
    blocks' tickets, then the chunks', per tile; each launch leaves it
    zero)."""

    partial: torch.Tensor
    chunk_sum: torch.Tensor
    counter: torch.Tensor
    seg_stride: int
    tiles: int
    columns: int  # tiles x kt: the widest call it serves


def workspace(plan: SegmentPlan, accum_dtype, width: int, kt: int,
              device) -> Workspace:
    """A zeroed workspace for calls of up to ``width`` columns at tiles
    of at most ``kt``: only the split blocks' segments write partials."""
    seg_stride = split_extent(plan)
    tiles = -(-int(width) // kt)
    nb = len(plan.block_seg_start) - 1
    n = seg_stride * LANES * tiles * kt
    return Workspace(
        partial=torch.empty(n, dtype=accum_dtype, device=device),
        chunk_sum=torch.empty(n, dtype=accum_dtype, device=device),
        counter=torch.zeros(tiles * (nb + seg_stride), dtype=torch.int32,
                            device=device),
        seg_stride=seg_stride, tiles=tiles, columns=tiles * kt)


def check_workspace(work: Workspace, plan: SegmentPlan, width: int, kt: int,
                    accum_dtype, device) -> None:
    """Raise unless ``work`` serves calls of up to ``width`` columns at
    tiles of at most ``kt`` on ``plan``: the split blocks' segments, and
    each tile's partials and counters."""
    tiles = -(-int(width) // kt)
    if (work.seg_stride != split_extent(plan) or work.tiles < tiles
            or work.columns < tiles * kt
            or work.partial.dtype != accum_dtype
            or work.chunk_sum.dtype != accum_dtype
            or work.counter.dtype != torch.int32
            or any(t.device != torch.device(device)
                   for t in (work.partial, work.chunk_sum, work.counter))):
        raise ValueError("the workspace does not fit the plan and width")


def _count():
    global launches
    launches += 1


# Slots of the packed arguments that a call sets.
_GRID, _KC = 18, 20


class SpmmLauncher(ell_spmv.Launcher):
    """K1w bound to its inputs at ``width`` columns, checked once: each
    call ``launcher(kc)`` launches it once on the current stream over the
    first ``kc`` columns (default all) and returns ``out`` [num_blocks *
    128, kp], of which the first ``kc`` columns are written, and
    ``mass`` [kp] (block 0's lanes folded, the sum's dtype) likewise.
    The call picks its tile (:func:`tile_width`) and the grid of that
    tile."""

    def __call__(self, kc: Optional[int] = None) -> torch.Tensor:
        kc = self.width if kc is None else int(kc)
        if not 1 <= kc <= self.width:
            raise ValueError(f"kc {kc} outside [1, {self.width}]")
        t = tile_width(kc, self.kt)
        self._packed[_KC] = kc
        self._packed[_GRID] = persistent_grid(self.items, -(-kc // t), t,
                                              self.item, self.kind)
        self._fn = self._fns[t]
        self.last_tile = t
        return super().__call__()


def _check(z2, src_slots, num_blocks, accum_dtype, plan):
    if (z2.dtype, accum_dtype) not in _PAIRS:
        raise TypeError(f"no K1w entry for z {z2.dtype}, sums {accum_dtype} "
                        f"(accum_dtype must be float32 or float64, and no "
                        f"narrower than z2)")
    if src_slots.dtype != torch.int32:
        raise TypeError(f"src_slots must be int32, got {src_slots.dtype}")
    if z2.dim() != 2 or src_slots.dim() != 2 or src_slots.shape[1] != LANES:
        raise ValueError(f"want z2 [n+8, kp] and src_slots [rows, {LANES}], "
                         f"got {tuple(z2.shape)} and "
                         f"{tuple(src_slots.shape)}")
    if z2.shape[1] != row_width(z2.shape[1], z2.element_size()):
        raise ValueError(f"z2 rows of {z2.shape[1]} columns are not whole "
                         f"16-byte vectors")
    if not z2.is_contiguous() or not src_slots.is_contiguous():
        raise ValueError("z2 and src_slots must be contiguous")
    if src_slots.device != z2.device:
        raise ValueError(f"src_slots is on {src_slots.device}, z2 on "
                         f"{z2.device}")
    if num_blocks + 1 != len(plan.block_seg_start):
        raise ValueError("the plan does not fit num_blocks")


def bind_spmm(z2, src_slots, num_blocks, *, accum_dtype, plan,
              width: Optional[int] = None, kt: Optional[int] = None,
              work: Optional[Workspace] = None,
              out: Optional[torch.Tensor] = None,
              fold: Optional[torch.Tensor] = None) -> SpmmLauncher:
    """Check K1w's inputs on the card once and return its launcher,
    bound at ``width`` columns (default z2's) and tiles of at most
    ``kt`` (default :func:`default_tile`; the tile sweep sets others).

    ``z2``, ``src_slots`` and the plan are read by address at every
    call: refill them in place, never reallocate them. ``work``: default
    a fresh workspace. ``out``: the contiguous [num_blocks * 128, kp]
    buffer the launches write; default a fresh one. ``fold``: the
    contiguous [128, kp] buffer (the sum's dtype) that block 0's lanes
    are folded in, row 0 ending as ``mass``; default a fresh one (a
    sharded PPR engine lays it right after ``out``, so that one
    reduction covers both)."""
    dev = z2.device
    if dev.type != "cuda":
        raise ValueError(f"bind_spmm launches on cuda, not {dev}")
    _check(z2, src_slots, num_blocks, accum_dtype, plan)
    kp = z2.shape[1]
    width = kp if width is None else int(width)
    if not 1 <= width <= kp:
        raise ValueError(f"width {width} outside [1, {kp}] (z2's columns)")
    num_segs = ell_spmv.check_plan(plan, dev, num_blocks, src_slots.shape[0])
    if not isinstance(plan.empty_groups, torch.Tensor):
        raise ValueError("the plan has no empty-block list")
    if plan.item_segs.shape != (num_segs,):
        raise ValueError("the plan's work items do not cover its segments")
    if z2.data_ptr() % VECTOR_BYTES:
        raise ValueError("z2 must be 16-byte aligned (rows are read in "
                         "16-byte vectors)")
    item = z2.element_size()
    sentinel = z2.shape[0] - 8
    kt = default_tile(accum_dtype) if kt is None else kt
    kind = ell_spmv.device_kind(dev)
    tiles = sorted({tile_width(c, kt) for c in range(1, width + 1)})
    if work is None:
        work = workspace(plan, accum_dtype, width, kt, dev)
    check_workspace(work, plan, width, kt, accum_dtype, dev)
    seg_stride = work.seg_stride
    if out is None:
        out = torch.empty((num_blocks * LANES, kp), dtype=z2.dtype,
                          device=dev)
    elif (out.shape != (num_blocks * LANES, kp) or out.dtype != z2.dtype
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous [{num_blocks * LANES}, "
                         f"{kp}] {z2.dtype} tensor on {dev}")
    # Block 0's lanes, folded in place: row 0 ends as the mass.
    if fold is None:
        fold = torch.empty((LANES, kp), dtype=accum_dtype, device=dev)
    elif (fold.shape != (LANES, kp) or fold.dtype != accum_dtype
          or fold.device != dev or not fold.is_contiguous()):
        raise ValueError(f"fold must be a contiguous [{LANES}, {kp}] "
                         f"{accum_dtype} tensor on {dev}")
    num_empty = plan.empty_groups.shape[0]
    items = plan.num_items + num_empty
    args = (z2.data_ptr(), src_slots.data_ptr(),
            plan.seg_row_start.data_ptr(), plan.seg_block.data_ptr(),
            plan.block_seg_start.data_ptr(), plan.item_start.data_ptr(),
            plan.item_segs.data_ptr(), plan.empty_groups.data_ptr(),
            work.partial.data_ptr(), work.chunk_sum.data_ptr(),
            work.counter.data_ptr(),
            work.counter.data_ptr() + 4 * work.tiles * num_blocks,
            out.data_ptr(), fold.data_ptr(), plan.num_items,
            plan.num_split, num_empty, sentinel, 1, kp, width, seg_stride,
            num_blocks)
    launcher = SpmmLauncher(
        library="ell_contrib_spmm", entry=entry(z2.dtype, accum_dtype, kt),
        error="ell_contrib_spmm_error_string", args=args, out=out,
        device=dev, count=_count, keep=(z2, src_slots, plan, work, fold),
        width=width, kt=kt, kp=kp, items=items, item=item, kind=kind,
        work=work, mass=fold[0], last_tile=None,
        _fns={t: ell_spmv.function("ell_contrib_spmm",
                                   entry(z2.dtype, accum_dtype, t))
              for t in tiles})
    launcher.grid = persistent_grid(items, -(-width // tiles[-1]), tiles[-1],
                                    item, kind)
    return launcher


def ell_contrib_spmm_rows(z2, src_slots, row_block, num_blocks, *,
                          accum_dtype, plan, k: int,
                          kt: Optional[int] = None,
                          work: Optional[Workspace] = None) -> torch.Tensor:
    """The batched contribution of the first ``k`` columns of ``z2``
    ([n_state + 8, kp], row-major, prescaled, its last 8 rows zero):
    [num_blocks * 128, k] sums in z2's dtype, the JAX op's layout
    (``pagerank_tpu/ops/spmv.py:380``). On cuda one K1w launch
    (:func:`bind_spmm`); on the CPU the plain version
    (:func:`ell_contrib_spmm_rows_reference`)."""
    _check(z2, src_slots, num_blocks, accum_dtype, plan)
    if row_block.shape != (src_slots.shape[0],):
        raise ValueError(f"row_block shape {tuple(row_block.shape)} != "
                         f"({src_slots.shape[0]},)")
    if not 0 <= k <= z2.shape[1]:
        raise ValueError(f"k {k} outside [0, {z2.shape[1]}]")
    if z2.device.type == "cpu":
        return ell_contrib_spmm_rows_reference(
            z2, src_slots, accum_dtype=accum_dtype, plan=plan, k=k)
    if z2.device.type != "cuda":
        raise ValueError(f"ell_contrib_spmm_rows runs on cuda or cpu, not "
                         f"{z2.device}")
    if k == 0:
        return z2.new_empty((num_blocks * LANES, 0))
    return bind_spmm(z2, src_slots, num_blocks, accum_dtype=accum_dtype,
                     plan=plan, width=k, kt=kt, work=work)(k)[:, :k]


def _tile_sums(z2, src_slots, *, accum_dtype, plan, k: int, kt: int):
    """The plain version's [num_blocks * 128, k] sums in the sum's dtype,
    tile by tile."""
    nb = len(plan.block_seg_start) - 1
    if k == 0:
        return z2.new_empty((nb * LANES, 0), dtype=accum_dtype)
    t = tile_width(k, kt)
    idx = src_slots.long()
    tiles = []
    for c0 in range(0, k, t):
        v = z2[:, c0: min(c0 + t, k)][idx].to(accum_dtype)  # [rows, 128, w]
        sums = ell_spmv.group_sums(ell_spmv.row_partials(v, plan),
                                   plan.block_seg_start)
        tiles.append(sums.reshape(nb * LANES, -1))
    return torch.cat(tiles, 1)


def ell_contrib_spmm_rows_reference(z2, src_slots, *, accum_dtype, plan,
                                    k: int, kt: int = KT) -> torch.Tensor:
    """K1w's function in the kernel's order, in plain PyTorch, tile by
    tile (:func:`tile_width` columns): each tile's [rows, 128, t]
    gather summed as :func:`~pagerank_tpu_torch.ops.ell_spmv.
    ell_contrib_plan_reference` sums one column (segments in row order
    from 0, blocks in segment order, a deep block chunk by chunk), every
    column on its own. [num_blocks * 128, k] in z2's dtype. On the CPU
    (``index_add_`` adds in index order) this equals
    ``ell_spmv.ell_contrib_spmm_reference`` of ``z2[:, :k].T`` bit for
    bit, whatever the tile."""
    return _tile_sums(z2, src_slots, accum_dtype=accum_dtype, plan=plan,
                      k=k, kt=kt).to(z2.dtype)


def mass_reference(z2, src_slots, *, accum_dtype, plan, k: int,
                   kt: int = KT) -> torch.Tensor:
    """What K1w leaves in ``SpmmLauncher.mass``, in plain PyTorch: block
    0's 128 lane sums in the sum's dtype, folded by
    ``ops/spmv.py:fold_rows``. [k] in ``accum_dtype``."""
    sums = _tile_sums(z2, src_slots, accum_dtype=accum_dtype, plan=plan,
                      k=k, kt=kt)
    return spmv.fold_rows(sums[:LANES])
