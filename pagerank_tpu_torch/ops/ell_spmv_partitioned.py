"""K2: the pair sums of the partition-centric layout.

Replaces ``pagerank_tpu/ops/pallas_spmv.py:ell_contrib_pallas_partitioned``:
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
partition of each pair. Inert slots hold the local sentinel psz (< W),
which reads a zero of the window's tail. The TPU form's chunk-local
ranks, chunk bases and chunk padding exist for its ordered grid and are
not carried over.

What bounds it on the H100: device-memory bytes — the slot words once
(3 bytes a slot with words24), the windows, the plan, and the f32 pair
output. What the design does about it: K1's two-pass segmented
reduction with no atomics, over pairs (see the source note); a pair
with one segment is written by pass 1 directly. The sum order is fixed
by the plan, so results are bit-identical from run to run.

The wrapper launches the kernel for a CUDA tensor, or raises; it takes
the plain version, :func:`ell_contrib_partitioned_reference`, only for
tensors on the CPU. ``launches`` counts the kernel launches (one per
call that ran both passes).
"""

from __future__ import annotations

import ctypes

import torch

from pagerank_tpu_torch.ops import LANES
from pagerank_tpu_torch.ops.ell_spmv import check_plan
from pagerank_tpu_torch.ops.spmv import unpack_words24

#: Kernel launches made by :func:`ell_contrib_partitioned` in this
#: process (a call that runs both passes counts one).
launches = 0

_ENTRY = {
    (torch.float32, torch.int8): "ell_contrib_part_f32_w24",
    (torch.float32, torch.int32): "ell_contrib_part_f32_w32",
    (torch.bfloat16, torch.int8): "ell_contrib_part_bf16_w24",
    (torch.bfloat16, torch.int32): "ell_contrib_part_bf16_w32",
}


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
                            num_pairs, *, plan):
    """Per-(dst block, partition) pair sums over the partitioned slots.

    Args:
      z_windows: [K, W] prescaled rank windows, float32 or bfloat16; the
        lanes from psz on are zero (the sentinel reads one).
      src_slots: partition-local words, int8 [rows, 384] (planar 3-byte)
        or int32 [rows, 128].
      row_pair: int32 [rows] ascending global pair rank per row.
      pair_part: int32 [num_pairs] partition of each pair.
      num_pairs: number of (dst block, partition) pairs.
      plan: the segment plan of ``row_pair`` over ``num_pairs``
        (``ell_spmv.plan_to(segment_plan(...), device)``); read by the
        kernel.

    Returns:
      [num_pairs * 128] float32 pair sums (f32 whatever the table).
    """
    _check(z_windows, src_slots, row_pair, pair_part, num_pairs)
    if z_windows.device.type == "cpu":
        return ell_contrib_partitioned_reference(
            z_windows, src_slots, row_pair, pair_part, num_pairs)
    if z_windows.device.type != "cuda":
        raise ValueError(
            f"ell_contrib_partitioned runs on cuda or cpu, not "
            f"{z_windows.device}")
    return _launch(z_windows, src_slots, pair_part, num_pairs, plan)


def _launch(z_windows, src_slots, pair_part, num_pairs, plan):
    global launches
    num_segs = check_plan(plan, z_windows.device, num_pairs,
                          src_slots.shape[0])
    rs, sp, ps = plan.seg_row_start, plan.seg_block, plan.block_seg_start
    from pagerank_tpu_torch.kernels import build

    lib = build.load("ell_contrib_partitioned")
    fn = getattr(lib, _ENTRY[(z_windows.dtype, src_slots.dtype)])
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = z_windows.device
    partial = torch.empty((num_segs, LANES), dtype=torch.float32, device=dev)
    out = torch.empty(num_pairs * LANES, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(z_windows.data_ptr(), src_slots.data_ptr(), rs.data_ptr(),
                sp.data_ptr(), ps.data_ptr(), pair_part.data_ptr(),
                partial.data_ptr(), out.data_ptr(), z_windows.shape[1],
                num_segs, num_pairs, stream)
    if rc != 0:
        lib.ell_contrib_part_error_string.restype = ctypes.c_char_p
        lib.ell_contrib_part_error_string.argtypes = [ctypes.c_int]
        msg = lib.ell_contrib_part_error_string(rc).decode()
        raise RuntimeError(f"ell_contrib_partitioned kernel launch failed: "
                           f"CUDA error {rc} ({msg})")
    launches += 1
    return out


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
    """The plain PyTorch version: unpack the words, gather from each
    row's partition window, widen, and add each slot row into its pair.
    Also takes an f64 table, summed in f64. On a CUDA tensor
    ``index_add_`` uses atomics, so its sum order (and last bits) vary
    from run to run: it is a comparison twin, never the main path."""
    v = _gathered(z_windows, src_slots, row_pair, pair_part)
    out = torch.zeros((num_pairs, LANES), dtype=v.dtype,
                      device=z_windows.device)
    out.index_add_(0, row_pair.long(), v)
    return out.reshape(-1)


def ell_contrib_partitioned_segmented_reference(z_windows, src_slots,
                                                pair_part, num_pairs, *,
                                                plan):
    """The kernel's two-pass order in plain PyTorch, for the CPU tests of
    the host plan: rows summed into their segment's partial, then each
    pair's partials summed in segment order."""
    dev = z_windows.device
    rs = torch.as_tensor(plan.seg_row_start, dtype=torch.long, device=dev)
    sp = torch.as_tensor(plan.seg_block, dtype=torch.long, device=dev)
    num_segs = sp.shape[0]
    seg_of_row = torch.repeat_interleave(
        torch.arange(num_segs, device=dev), rs[1:] - rs[:-1])
    row_pair = sp[seg_of_row].to(torch.int32)
    v = _gathered(z_windows, src_slots, row_pair, pair_part)
    partial = torch.zeros((num_segs, LANES), dtype=v.dtype, device=dev)
    partial.index_add_(0, seg_of_row, v)
    out = torch.zeros((num_pairs, LANES), dtype=v.dtype, device=dev)
    out.index_add_(0, sp, partial)
    return out.reshape(-1)
