"""K1: the blocked-ELL contribution SpMV, contrib = Aᵀ_norm·r.

Replaces ``pagerank_tpu/ops/pallas_spmv.py:ell_contrib_pallas``: the
kernel is ``pagerank_tpu_torch/csrc/ell_contrib.cu``, built for
``sm_90a`` at first use (kernels/build.py) and called through ctypes.

What bounds it on the H100: device-memory bytes. A step must stream the
whole slot table once (rows·128·4 bytes), read z and write the output
(n_pad·itemsize each), and read the segment plan; the gathers of z are
random but z (16.8 MB in f32 at R-MAT scale 22) sits in the 50 MB L2.

What the design does about it: a two-pass segmented reduction with no
atomics. Pass 1 gives each segment of at most ``SEG_ROWS`` slot rows
(ops/ell.py:segment_plan) one CTA of 128 threads, one per lane, reading
each slot row as one coalesced 512-byte line and summing in a register;
pass 2 sums each dst block's segment partials in segment order. The
hub blocks the in-degree relabel puts first (~10^5 rows) are spread
over many CTAs instead of one, and the fixed summation order keeps the
result bit-identical from run to run.

The wrapper launches the kernel for a CUDA tensor, or raises; it takes
the plain version, :func:`ell_contrib_reference`, only for tensors on
the CPU. ``launches`` counts the kernel launches (one per call that ran
both passes).
"""

from __future__ import annotations

import ctypes

import torch

from pagerank_tpu_torch.ops import LANES
from pagerank_tpu_torch.ops.ell import SegmentPlan

#: Kernel launches made by :func:`ell_contrib` in this process (a call
#: that runs both passes counts one).
launches = 0

_ENTRY = {
    (torch.float32, torch.float32): "ell_contrib_f32_f32",
    (torch.float32, torch.float64): "ell_contrib_f32_f64",
    (torch.float64, torch.float64): "ell_contrib_f64_f64",
}


def plan_to(plan: SegmentPlan, device) -> SegmentPlan:
    """The segment plan as int32 torch tensors on ``device``."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.int32).to(device).contiguous()

    return SegmentPlan(
        seg_row_start=t(plan.seg_row_start),
        seg_block=t(plan.seg_block),
        block_seg_start=t(plan.block_seg_start),
        num_rows=plan.num_rows,
    )


def _check(z_ext, src_slots, row_block, num_blocks, accum_dtype):
    if z_ext.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"z_ext must be float32 or float64, got {z_ext.dtype}")
    if accum_dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"accum_dtype must be float32 or float64, got {accum_dtype}")
    if accum_dtype.itemsize < z_ext.dtype.itemsize:
        raise TypeError(
            f"accum_dtype {accum_dtype} is narrower than z_ext {z_ext.dtype}")
    if src_slots.dtype != torch.int32 or row_block.dtype != torch.int32:
        raise TypeError(
            f"src_slots and row_block must be int32, got {src_slots.dtype} "
            f"and {row_block.dtype}")
    if z_ext.dim() != 1 or src_slots.dim() != 2 or src_slots.shape[1] != LANES:
        raise ValueError(
            f"want z_ext [n+8] and src_slots [rows, {LANES}], got "
            f"{tuple(z_ext.shape)} and {tuple(src_slots.shape)}")
    if row_block.shape != (src_slots.shape[0],):
        raise ValueError(
            f"row_block shape {tuple(row_block.shape)} != "
            f"({src_slots.shape[0]},)")
    if num_blocks < 0:
        raise ValueError(f"num_blocks must be >= 0, got {num_blocks}")
    for name, t in (("z_ext", z_ext), ("src_slots", src_slots),
                    ("row_block", row_block)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != z_ext.device:
            raise ValueError(
                f"{name} is on {t.device}, z_ext on {z_ext.device}")


def ell_contrib(z_ext, src_slots, row_block, num_blocks, *, accum_dtype,
                plan):
    """contrib = Aᵀ_norm r over sentinel-form ELL slots.

    Args:
      z_ext: [n_state + 8] rank vector prescaled by 1/out-degree, its
        trailing 8 entries zero (inert slots hold the sentinel n_state).
      src_slots: int32 [rows, 128] relabeled source id per slot.
      row_block: int32 [rows] ascending dst block id per row.
      num_blocks: number of 128-lane dst blocks.
      accum_dtype: torch.float32 or torch.float64 — the sum's dtype.
      plan: the segment plan of ``row_block``
        (``plan_to(segment_plan(...), device)``); read by the kernel.

    Returns:
      [num_blocks * 128] contribution sums in z_ext's dtype (relabeled).
    """
    _check(z_ext, src_slots, row_block, num_blocks, accum_dtype)
    if z_ext.device.type == "cpu":
        return ell_contrib_reference(z_ext, src_slots, row_block, num_blocks,
                                     accum_dtype=accum_dtype)
    if z_ext.device.type != "cuda":
        raise ValueError(f"ell_contrib runs on cuda or cpu, not {z_ext.device}")
    return _launch(z_ext, src_slots, num_blocks, accum_dtype, plan)


def check_plan(plan, device, num_groups: int, num_rows: int) -> int:
    """Raise unless ``plan`` is a device segment plan that fits
    ``num_groups`` groups (dst blocks for K1, pairs for K2) and
    ``num_rows`` slot rows; return its segment count."""
    if plan is None:
        raise ValueError("the CUDA kernel needs the segment plan")
    rs, sb, bs = plan.seg_row_start, plan.seg_block, plan.block_seg_start
    num_segs = sb.shape[0]
    for name, t in (("seg_row_start", rs), ("seg_block", sb),
                    ("block_seg_start", bs)):
        if (t.dtype != torch.int32 or t.device != device
                or not t.is_contiguous() or t.dim() != 1):
            raise ValueError(
                f"plan.{name} must be a contiguous int32 vector on {device}")
    if (rs.shape[0] != num_segs + 1 or bs.shape[0] != num_groups + 1
            or plan.num_rows != num_rows):
        raise ValueError(
            f"the plan (seg_row_start {tuple(rs.shape)}, block_seg_start "
            f"{tuple(bs.shape)}, {plan.num_rows} rows) does not fit "
            f"{num_segs} segments, {num_groups} groups and {num_rows} slot "
            f"rows")
    return num_segs


def _launch(z_ext, src_slots, num_blocks, accum_dtype, plan):
    global launches
    num_segs = check_plan(plan, z_ext.device, num_blocks, src_slots.shape[0])
    rs, bs = plan.seg_row_start, plan.block_seg_start
    from pagerank_tpu_torch.kernels import build

    lib = build.load("ell_contrib")
    fn = getattr(lib, _ENTRY[(z_ext.dtype, accum_dtype)])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = z_ext.device
    partial = torch.empty((num_segs, LANES), dtype=accum_dtype, device=dev)
    out = torch.empty(num_blocks * LANES, dtype=z_ext.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(z_ext.data_ptr(), src_slots.data_ptr(), rs.data_ptr(),
                bs.data_ptr(), partial.data_ptr(), out.data_ptr(),
                num_segs, num_blocks, stream)
    if rc != 0:
        lib.ell_contrib_error_string.restype = ctypes.c_char_p
        lib.ell_contrib_error_string.argtypes = [ctypes.c_int]
        msg = lib.ell_contrib_error_string(rc).decode()
        raise RuntimeError(f"ell_contrib kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    launches += 1
    return out


def ell_contrib_reference(z_ext, src_slots, row_block, num_blocks, *,
                          accum_dtype):
    """The plain PyTorch version: gather, widen to accum_dtype, add each
    slot row into its dst block, cast back to z_ext's dtype. On a CUDA
    tensor ``index_add_`` uses atomics, so its sum order (and last bits)
    vary from run to run: it is a comparison twin, never the main path."""
    v = z_ext[src_slots.long()].to(accum_dtype)
    buf = torch.zeros((num_blocks, LANES), dtype=accum_dtype,
                      device=z_ext.device)
    buf.index_add_(0, row_block.long(), v)
    return buf.reshape(-1).to(z_ext.dtype)


def ell_contrib_segmented_reference(z_ext, src_slots, num_blocks, *,
                                    accum_dtype, plan):
    """The kernel's two-pass order in plain PyTorch, for the CPU tests of
    the host plan: rows summed into their segment's partial, then each
    block's partials summed in segment order."""
    dev = z_ext.device
    rs = torch.as_tensor(plan.seg_row_start, dtype=torch.long, device=dev)
    sb = torch.as_tensor(plan.seg_block, dtype=torch.long, device=dev)
    num_segs = sb.shape[0]
    seg_of_row = torch.repeat_interleave(
        torch.arange(num_segs, device=dev), rs[1:] - rs[:-1])
    v = z_ext[src_slots.long()].to(accum_dtype)
    partial = torch.zeros((num_segs, LANES), dtype=accum_dtype, device=dev)
    partial.index_add_(0, seg_of_row, v)
    out = torch.zeros((num_blocks, LANES), dtype=accum_dtype, device=dev)
    out.index_add_(0, sb, partial)
    return out.reshape(-1).to(z_ext.dtype)
