"""K2: the block sums of the partition-centric layout.

Replaces ``pagerank_tpu/ops/pallas_spmv.py:ell_contrib_pallas_partitioned``
and the pair -> block expansion after it (``jax_engine.py:1855-1865``):
the kernel is ``pagerank_tpu_torch/csrc/ell_contrib_partitioned.cu``,
built for ``sm_90a`` at first use (kernels/build.py) and called through
ctypes.

The layout (engines/torch_engine.py builds it): K source partitions of
``psz`` vertices each; the prescaled rank vector split into K windows
``z_windows`` [K, W] (psz lanes, then zeros; f32, or bf16 for the bf16
stream); slot rows concatenated partition-major with partition-LOCAL
source words, as 3-byte planar int8 [rows, 384] (``ops/spmv.py:
pack_words24``) or int32 [rows, 128]; ``row_pair`` the ascending global
dense (dst block, partition) pair rank of each row, ``pair_part`` the
partition of each pair. Inert slots hold the local sentinel (the plan's
``sentinel``, psz), which reads a zero of the window's tail. The TPU
form's chunk-local ranks, chunk bases and chunk padding exist for its
ordered grid and are not carried over.

What bounds it on the H100: device-memory bytes — the slot words once
(3 bytes a slot with words24), the windows, the plan, and the f32 block
output. What the design does about it: K1's persistent shape
(ops/ell_spmv.py, the source note), over the pairs of a
:class:`~pagerank_tpu_torch.ops.ell.PairPlan`; each CTA stages the head
of partition 0's window, and the kernel sums pairs into their dst
blocks itself, in partition order, so a step runs K2 alone. The order
is the plan's: the kernel equals
:func:`ell_contrib_partitioned_plan_reference` bit for bit.

The wrapper launches the kernel for a CUDA tensor, or raises; it takes
the plain version, :func:`ell_contrib_partitioned_plan_reference`, only
for tensors on the CPU. :func:`bind` checks
a call's inputs once and returns a launcher. ``launches`` counts the
kernel launches, one a call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pagerank_tpu_torch.ops import LANES
from pagerank_tpu_torch.ops import ell_spmv
from pagerank_tpu_torch.ops.ell import PairPlan
from pagerank_tpu_torch.ops.spmv import scatter_block_sums, unpack_words24

#: Kernel launches made through this module in this process.
launches = 0

_ENTRY = {
    (torch.float32, torch.int8): "ell_contrib_part_f32_w24",
    (torch.float32, torch.int32): "ell_contrib_part_f32_w32",
    (torch.bfloat16, torch.int8): "ell_contrib_part_bf16_w24",
    (torch.bfloat16, torch.int32): "ell_contrib_part_bf16_w32",
}


@dataclasses.dataclass
class Workspace:
    """K2's scratch: ``partial`` and ``chunk_sum`` [segments, 128] and
    ``pair_sum`` [pairs, 128] float32; ``counter`` int32 [pairs + blocks
    + segments], zero (the pairs' tickets, the blocks', then the
    chunks'; each launch leaves it zero)."""

    partial: torch.Tensor
    chunk_sum: torch.Tensor
    pair_sum: torch.Tensor
    counter: torch.Tensor


def workspace(plan: PairPlan, device) -> Workspace:
    """A zeroed workspace for ``plan``."""
    num_pairs = len(plan.block_seg_start) - 1
    f32 = torch.float32
    return Workspace(
        partial=torch.empty((plan.num_segments, LANES), dtype=f32,
                            device=device),
        chunk_sum=torch.empty((plan.num_segments, LANES), dtype=f32,
                              device=device),
        pair_sum=torch.empty((num_pairs, LANES), dtype=f32, device=device),
        counter=torch.zeros(num_pairs + plan.num_blocks + plan.num_segments,
                            dtype=torch.int32, device=device))


def _check(z_windows, src_slots, row_pair, pair_part, num_pairs):
    if z_windows.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"z_windows must be float32 or bfloat16, got {z_windows.dtype}")
    if z_windows.dim() != 2:
        raise ValueError(
            f"want z_windows [K, W], got {tuple(z_windows.shape)}")
    want_lanes = {torch.int8: 3 * LANES, torch.int32: LANES}
    if src_slots.dtype not in want_lanes:
        raise TypeError(
            f"src_slots must be int8 (words24) or int32, got {src_slots.dtype}")
    if src_slots.dim() != 2 or src_slots.shape[1] != want_lanes[src_slots.dtype]:
        raise ValueError(
            f"src_slots {tuple(src_slots.shape)} / {src_slots.dtype}: want "
            f"[rows, {want_lanes[src_slots.dtype]}]")
    if row_pair.dtype != torch.int32 or pair_part.dtype != torch.int32:
        raise TypeError(
            f"row_pair and pair_part must be int32, got {row_pair.dtype} "
            f"and {pair_part.dtype}")
    if row_pair.shape != (src_slots.shape[0],):
        raise ValueError(
            f"row_pair shape {tuple(row_pair.shape)} != ({src_slots.shape[0]},)")
    if num_pairs < 0 or pair_part.shape != (num_pairs,):
        raise ValueError(
            f"pair_part shape {tuple(pair_part.shape)} != ({num_pairs},)")
    for name, t in (("z_windows", z_windows), ("src_slots", src_slots),
                    ("row_pair", row_pair), ("pair_part", pair_part)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != z_windows.device:
            raise ValueError(
                f"{name} is on {t.device}, z_windows on {z_windows.device}")


def ell_contrib_partitioned(z_windows, src_slots, row_pair, pair_part,
                            num_pairs, *, plan,
                            work: Optional[Workspace] = None,
                            head: Optional[int] = None):
    """Per-dst-block sums over the partitioned slots.

    Args:
      z_windows: [K, W] prescaled rank windows, float32 or bfloat16; the
        lanes from psz on are zero (the sentinel reads one).
      src_slots: partition-local words, int8 [rows, 384] (planar 3-byte)
        or int32 [rows, 128].
      row_pair: int32 [rows] ascending global pair rank per row.
      pair_part: int32 [num_pairs] partition of each pair.
      num_pairs: number of (dst block, partition) pairs.
      plan: the :class:`~pagerank_tpu_torch.ops.ell.PairPlan` of
        ``row_pair`` (``ell_spmv.plan_to(pair_plan(...), device)``).
      work: the kernel's workspace (:func:`workspace`); a fresh one
        when None.
      head: the staged head of partition 0's window; see :func:`bind`.

    Returns:
      [num_blocks * 128] float32 block sums (f32 whatever the table):
      each block's pair sums added in partition order.
    """
    _check(z_windows, src_slots, row_pair, pair_part, num_pairs)
    if z_windows.device.type == "cpu":
        return ell_contrib_partitioned_plan_reference(z_windows, src_slots,
                                                      pair_part, plan=plan)
    if z_windows.device.type != "cuda":
        raise ValueError(
            f"ell_contrib_partitioned runs on cuda or cpu, not "
            f"{z_windows.device}")
    return bind(z_windows, src_slots, pair_part, num_pairs, plan=plan,
                work=work, head=head)()


def _count():
    global launches
    launches += 1


def bind(z_windows, src_slots, pair_part, num_pairs, *, plan,
         work: Optional[Workspace] = None,
         head: Optional[int] = None) -> ell_spmv.Launcher:
    """Check K2's inputs on the card once and return its launcher.

    The tensors are read by address at every call: refill the windows
    in place, never reallocate them. ``head``: the elements of partition
    0's window staged in shared memory (0 stages none; default the most
    that fits, at most the sentinel). ``work``: default a fresh
    workspace."""
    dev = z_windows.device
    if dev.type != "cuda":
        raise ValueError(f"bind launches on cuda, not {dev}")
    num_segs = ell_spmv.check_plan(plan, dev, num_pairs, src_slots.shape[0])
    if not isinstance(plan, PairPlan):
        raise ValueError("K2 needs a PairPlan (ops/ell.py:pair_plan)")
    num_blocks = plan.num_blocks
    if plan.pair_block.shape != (num_pairs,):
        raise ValueError("the plan's pair_block does not fit num_pairs")
    if plan.item_segs.shape != (num_segs,):
        raise ValueError("the plan's work items do not cover its segments")
    if not 0 < plan.sentinel < z_windows.shape[1]:
        raise ValueError(f"sentinel {plan.sentinel} outside the window of "
                         f"{z_windows.shape[1]}")
    if z_windows.data_ptr() % 16 or src_slots.data_ptr() % 16:
        raise ValueError("z_windows and src_slots must be 16-byte aligned")
    kind = ell_spmv.device_kind(dev)
    head = ell_spmv.check_head(head, z_windows.element_size(), plan.sentinel,
                               kind)
    work = workspace(plan, dev) if work is None else work
    if (work.partial.shape != (num_segs, LANES)
            or work.chunk_sum.shape != (num_segs, LANES)
            or work.pair_sum.shape != (num_pairs, LANES)
            or work.counter.shape != (num_pairs + num_blocks + num_segs,)
            or work.counter.dtype != torch.int32
            or any(t.device != dev for t in (work.partial, work.chunk_sum,
                                             work.pair_sum, work.counter))):
        raise ValueError("the workspace does not fit the plan")
    out = torch.empty(num_blocks * LANES, dtype=torch.float32, device=dev)
    num_empty = plan.empty_blocks.shape[0]
    grid = ell_spmv.persistent_grid(plan.num_items + num_empty, kind)
    counter = work.counter.data_ptr()  # pairs', blocks', chunks' tickets
    args = (z_windows.data_ptr(), src_slots.data_ptr(),
            plan.seg_row_start.data_ptr(), plan.seg_block.data_ptr(),
            plan.block_seg_start.data_ptr(), pair_part.data_ptr(),
            plan.pair_block.data_ptr(), plan.block_pair_start.data_ptr(),
            plan.block_pairs.data_ptr(), plan.item_start.data_ptr(),
            plan.item_segs.data_ptr(), plan.empty_blocks.data_ptr(),
            work.partial.data_ptr(), work.chunk_sum.data_ptr(),
            work.pair_sum.data_ptr(), counter, counter + 4 * num_pairs,
            counter + 4 * (num_pairs + num_blocks), out.data_ptr(),
            z_windows.shape[1], plan.num_items, plan.num_split, num_empty,
            plan.sentinel, head, grid)
    return ell_spmv.Launcher(
        library="ell_contrib_partitioned",
        entry=_ENTRY[(z_windows.dtype, src_slots.dtype)],
        error="ell_contrib_part_error_string", args=args, out=out,
        device=dev, count=_count,
        keep=(z_windows, src_slots, pair_part, plan, work), head=head,
        grid=grid, smem=ell_spmv.dynamic_smem(head, z_windows.element_size()))


def _gathered(z_windows, src_slots, row_pair, pair_part):
    """Each slot's window value, widened: f64 for an f64 table (the
    exact-sum comparisons), else f32 (the kernel's sum type)."""
    words = (unpack_words24(src_slots) if src_slots.dtype == torch.int8
             else src_slots).long()
    base = pair_part.long()[row_pair.long()] * z_windows.shape[1]
    acc = torch.float64 if z_windows.dtype == torch.float64 else torch.float32
    return z_windows.reshape(-1)[base[:, None] + words].to(acc)


def ell_contrib_partitioned_reference(z_windows, src_slots, row_pair,
                                      pair_part, num_pairs):
    """A plain PyTorch twin of the pair sums, in another order: unpack
    the words, gather from each row's partition window, widen, and add
    each slot row into its pair (:func:`expand_pairs` then gives the
    block sums). Also takes an f64 table, summed in f64. On a CUDA
    tensor ``index_add_`` uses atomics, so its sum order (and last bits)
    vary from run to run: it is a comparison twin, never the main path."""
    v = _gathered(z_windows, src_slots, row_pair, pair_part)
    out = torch.zeros((num_pairs, LANES), dtype=v.dtype,
                      device=z_windows.device)
    out.index_add_(0, row_pair.long(), v)
    return out.reshape(-1)


def expand_pairs(pairs, pair_part, pair_block, num_blocks):
    """Pair sums [num_pairs*128] -> block sums [num_blocks*128]: a zero
    block array, then each partition's pairs added into their blocks,
    one partition after another (``jax_engine.py:1855-1865``; the pairs
    of a partition are contiguous and feed distinct blocks)."""
    pairs = pairs.reshape(-1, LANES)
    dev = pairs.device
    part = torch.as_tensor(pair_part, dtype=torch.long, device=dev)
    blk = torch.as_tensor(pair_block, dtype=torch.long, device=dev)
    total = torch.zeros((num_blocks, LANES), dtype=pairs.dtype, device=dev)
    bounds = torch.searchsorted(
        part, torch.arange(int(part.max()) + 2 if part.numel() else 1,
                           device=dev)).tolist()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        scatter_block_sums(total, pairs[lo:hi], blk[lo:hi], False)
    return total.reshape(-1)


def _pair_sums(z_windows, src_slots, pair_part, plan):
    """Each pair's sum in the kernel's order: its segments' rows in row
    order from 0, then its partials as ``ell_spmv.group_sums`` orders
    them (a pair of more than ``CHUNK`` segments chunk by chunk).
    [pairs, 128]."""
    dev = z_windows.device
    rs = torch.as_tensor(plan.seg_row_start, dtype=torch.long, device=dev)
    sp = torch.as_tensor(plan.seg_block, dtype=torch.long, device=dev)
    seg_of_row = torch.repeat_interleave(
        torch.arange(sp.shape[0], device=dev), rs[1:] - rs[:-1])
    v = _gathered(z_windows, src_slots, sp[seg_of_row].to(torch.int32),
                  pair_part)
    return ell_spmv.group_sums(ell_spmv.row_partials(v, plan),
                               plan.block_seg_start)


def ell_contrib_partitioned_plan_reference(z_windows, src_slots, pair_part,
                                           *, plan):
    """K2's function in the kernel's order, in plain PyTorch: the pair
    sums (:func:`_pair_sums`), then each block's pairs that have rows
    summed in partition order from 0, in one run however many there are
    (the kernel's block finisher, and the order of :func:`expand_pairs`)
    — a block of one such pair taking its sum, a block of none 0. On the
    CPU (``index_add_`` adds in index order) this is the kernel's output
    bit for bit. Also takes an f64 table, summed in f64."""
    pairs = _pair_sums(z_windows, src_slots, pair_part, plan)
    dev = pairs.device
    bp = torch.as_tensor(plan.block_pairs, dtype=torch.long, device=dev)
    return ell_spmv.group_sums(pairs[bp], plan.block_pair_start,
                               chunk=None).reshape(-1)


def ell_contrib_partitioned_segmented_reference(z_windows, src_slots,
                                                pair_part, num_pairs, *,
                                                plan):
    """The first kernel's two-pass order in plain PyTorch (pair sums):
    rows summed into their segment's partial, then each pair's partials
    added into a zero pair in segment order."""
    dev = z_windows.device
    rs = torch.as_tensor(plan.seg_row_start, dtype=torch.long, device=dev)
    sp = torch.as_tensor(plan.seg_block, dtype=torch.long, device=dev)
    seg_of_row = torch.repeat_interleave(
        torch.arange(sp.shape[0], device=dev), rs[1:] - rs[:-1])
    v = _gathered(z_windows, src_slots, sp[seg_of_row].to(torch.int32),
                  pair_part)
    partial = ell_spmv.row_partials(v, plan)
    out = torch.zeros((num_pairs, LANES), dtype=v.dtype, device=dev)
    out.index_add_(0, sp, partial)
    return out.reshape(-1)
