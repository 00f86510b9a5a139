"""K1: the blocked-ELL contribution SpMV, contrib = Aᵀ_norm·r.

Replaces ``pagerank_tpu/ops/pallas_spmv.py:ell_contrib_pallas``: the
kernel is ``pagerank_tpu_torch/csrc/ell_contrib.cu``, built for
``sm_90a`` at first use (kernels/build.py) and called through ctypes.

What bounds it on the H100: device-memory bytes. A step must stream the
whole slot table once (rows·128·4 bytes), read z and write the output
(n_pad·itemsize each), and read the segment plan; z (16.8 MB in f32 at
R-MAT scale 22) sits in the 50 MB L2, but its random gathers, not the
bytes, held the first form back.

What the design does about it (the source note has the detail): one
launch a call of persistent CTAs, about one per SM
(:func:`persistent_grid`), in lane groups of 128 threads that take the
work items of the host plan (ops/ell.py:segment_plan: each segment of a
deep block, then each other block whole) round-robin, hubs first; the
hot head ``z[0:head]`` staged in each CTA's shared memory
(:func:`head_capacity`: as much as is left of the 227 KB); the slot
words kept out of L1; a deep block finished by the lane group that
draws its last ticket, in segment order. The sums keep the plan's
order, so the kernel equals :func:`ell_contrib_plan_reference` bit for
bit and repeats itself bit for bit.

The wrapper launches the kernel for a CUDA tensor, or raises; it takes
the plain version, :func:`ell_contrib_plan_reference`, only for tensors
on the CPU. :func:`bind` checks a call's inputs once and returns a
launcher that a step calls with no further checks (``TorchEngine``
keeps one). ``launches`` counts the kernel launches, one a call.

**The batched form, column by column.** ``pagerank_tpu/ops/spmv.py:380
ell_contrib_spmm`` sums k prescaled rank columns at once; K1 computes
exactly one column of it. :func:`ell_contrib_spmm` runs K1 once per
column over a column-major ``z_cols`` buffer (k, n_state + 8), each row
a ``z_ext``; :func:`bind_columns` binds the k launches once, sharing
one workspace (launched one at a time on one stream, as K1 leaves it
zero). ``launches`` counts every column launch. The PPR path runs K1w
instead, one launch for all k columns (``ops/ell_spmm.py``); these
stay as its yardstick and its per-column plain version
(:func:`ell_contrib_spmm_reference`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from pagerank_tpu_torch.obs import costs
from pagerank_tpu_torch.ops import LANES
from pagerank_tpu_torch.ops.ell import SegmentPlan

#: Kernel launches made through this module in this process.
launches = 0

# The kernels' geometry: the constants of csrc/ell_contrib.cu and
# csrc/ell_contrib_partitioned.cu (a test holds them equal).
#: Threads of a CTA, and lane groups of 128 threads in it.
THREADS = 1024
GROUPS = THREADS // LANES
#: Slot rows a thread keeps in flight.
BATCH = 8
#: Static shared memory of a CTA: one ticket slot per lane group.
STATIC_SMEM = 4 * GROUPS
#: Segments of a chunk of a deep group: a group of more than this many
#: segments is summed chunk by chunk, then the chunk sums in order.
CHUNK = 32

_ENTRY = {
    (torch.float32, torch.float32): "ell_contrib_f32_f32",
    (torch.float32, torch.float64): "ell_contrib_f32_f64",
    (torch.float64, torch.float64): "ell_contrib_f64_f64",
}
_FUNCTIONS: Dict[str, ctypes._CFuncPtr] = {}
_KINDS: Dict[int, str] = {}


def device_kind(device) -> str:
    """The card's name (the device table's key), looked up once a
    device: a wrapper call binds its launch anew and should not pay for
    the device query each time."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _KINDS:
        _KINDS[index] = torch.cuda.get_device_name(index)
    return _KINDS[index]


def head_capacity(item: int, device_kind: Optional[str] = None) -> int:
    """The largest head (table elements of ``item`` bytes) that fits a
    block's shared memory after the tickets: a multiple of 16 bytes, so
    the staging copies whole vectors."""
    free = costs.device_spec(device_kind).smem_per_block - STATIC_SMEM
    return free // 16 * 16 // item


def dynamic_smem(head: int, item: int) -> int:
    """The dynamic shared bytes of a launch: the head rounded up to 16
    bytes (what the C launcher asks for)."""
    return -(-head * item // 16) * 16


def persistent_grid(items: int, device_kind: Optional[str] = None) -> int:
    """CTAs of a launch over ``items`` work items (the plan's items, then
    the empty groups): one per SM, fewer when the items fill fewer lane
    groups."""
    sms = costs.device_spec(device_kind).sms
    return max(1, min(sms, -(-int(items) // GROUPS)))


def plan_to(plan: SegmentPlan, device) -> SegmentPlan:
    """A plan (:class:`~pagerank_tpu_torch.ops.ell.SegmentPlan` or
    :class:`~pagerank_tpu_torch.ops.ell.PairPlan`) with every table as
    a contiguous int32 torch tensor on ``device``."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.int32).to(device).contiguous()

    return dataclasses.replace(plan, **{
        f.name: t(getattr(plan, f.name)) for f in dataclasses.fields(plan)
        if isinstance(getattr(plan, f.name), (np.ndarray, torch.Tensor))})


@dataclasses.dataclass
class Workspace:
    """K1's scratch: ``partial`` and ``chunk_sum`` [segments, 128] in the
    sum's dtype, and ``counter`` int32 [blocks + segments], zero (the
    blocks' tickets, then the chunks', by first segment; each launch
    leaves it zero)."""

    partial: torch.Tensor
    chunk_sum: torch.Tensor
    counter: torch.Tensor


def workspace(plan: SegmentPlan, accum_dtype, device) -> Workspace:
    """A zeroed workspace for ``plan`` (a launch leaves it zero, so one
    workspace serves every launch on that plan, one at a time)."""
    shape = (plan.num_segments, LANES)
    return Workspace(
        partial=torch.empty(shape, dtype=accum_dtype, device=device),
        chunk_sum=torch.empty(shape, dtype=accum_dtype, device=device),
        counter=torch.zeros(len(plan.block_seg_start) - 1 + shape[0],
                            dtype=torch.int32, device=device))


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
                plan, work: Optional[Workspace] = None,
                head: Optional[int] = None):
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
      work: the kernel's workspace (:func:`workspace`); a fresh one
        when None.
      head: the staged head of z (elements; default the most that
        fits); see :func:`bind`.

    Returns:
      [num_blocks * 128] contribution sums in z_ext's dtype (relabeled).
    """
    _check(z_ext, src_slots, row_block, num_blocks, accum_dtype)
    if z_ext.device.type == "cpu":
        return ell_contrib_plan_reference(z_ext, src_slots,
                                          accum_dtype=accum_dtype, plan=plan)
    if z_ext.device.type != "cuda":
        raise ValueError(f"ell_contrib runs on cuda or cpu, not {z_ext.device}")
    return bind(z_ext, src_slots, num_blocks, accum_dtype=accum_dtype,
                plan=plan, work=work, head=head)()


def check_plan(plan, device, num_groups: int, num_rows: int) -> int:
    """Raise unless ``plan`` is a device segment plan that fits
    ``num_groups`` groups (dst blocks for K1, pairs for K2) and
    ``num_rows`` slot rows; return its segment count."""
    if plan is None:
        raise ValueError("the CUDA kernel needs the segment plan")
    index = torch.device(device).index
    index = -1 if device.type == "cpu" else index
    for name, t in vars(plan).items():
        if type(t) is torch.Tensor and (
                t.dtype is not torch.int32 or t.get_device() != index
                or t.ndim != 1 or not t.is_contiguous()):
            raise ValueError(
                f"plan.{name} must be a contiguous int32 vector on {device}")
    rs, bs = plan.seg_row_start, plan.block_seg_start
    num_segs = plan.seg_block.shape[0]
    if (rs.shape[0] != num_segs + 1 or bs.shape[0] != num_groups + 1
            or plan.num_rows != num_rows):
        raise ValueError(
            f"the plan (seg_row_start {tuple(rs.shape)}, block_seg_start "
            f"{tuple(bs.shape)}, {plan.num_rows} rows) does not fit "
            f"{num_segs} segments, {num_groups} groups and {num_rows} slot "
            f"rows")
    return num_segs


def function(library: str, entry: str) -> ctypes._CFuncPtr:
    """The C entry point ``entry`` of ``library``, its ctypes signature
    set once: the packed int64 arguments, then the stream; returns
    int."""
    fn = _FUNCTIONS.get(entry)
    if fn is None:
        from pagerank_tpu_torch.kernels import build

        fn = getattr(build.load(library), entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FUNCTIONS[entry] = fn
    return fn


class Launcher:
    """A kernel bound to its inputs, checked once: each call launches it
    once on the current stream and returns ``out``. The arguments are
    packed once into the int64 array the C entry point reads. What the
    launch was bound with is kept as attributes (``head``, ``grid``,
    ``smem``)."""

    def __init__(self, *, library: str, entry: str, error: str, args, out,
                 device, count: Callable[[], None], keep, **info):
        self._fn = function(library, entry)
        self._library, self._error = library, error
        self._packed = (ctypes.c_int64 * len(args))(*args)
        self._args = ctypes.addressof(self._packed)
        self._device = device
        self._count = count
        self._keep = keep  # the tensors whose addresses args holds
        self.out = out
        self.__dict__.update(info)

    def __call__(self) -> torch.Tensor:
        stream = torch.cuda.current_stream(self._device).cuda_stream
        rc = self._fn(self._args, stream)
        if rc != 0:
            from pagerank_tpu_torch.kernels import build

            err = getattr(build.load(self._library), self._error)
            err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
            raise RuntimeError(f"{self._library} kernel launch failed: CUDA "
                               f"error {rc} ({err(rc).decode()})")
        self._count()
        return self.out


def _count():
    global launches
    launches += 1


def check_head(head, item, sentinel,
               device_kind: Optional[str] = None) -> int:
    """The head a launch stages: ``head`` checked against what fits
    shared memory and the sentinel, or the most that fits."""
    cap = min(head_capacity(item, device_kind), int(sentinel))
    if head is None:
        return cap
    if not 0 <= int(head) <= cap:
        raise ValueError(f"head {head} outside [0, {cap}] (shared memory "
                         f"after the tickets, and the sentinel "
                         f"{sentinel})")
    return int(head)


def bind(z_ext, src_slots, num_blocks, *, accum_dtype, plan,
         work: Optional[Workspace] = None,
         head: Optional[int] = None,
         out: Optional[torch.Tensor] = None) -> Launcher:
    """Check K1's inputs on the card once and return its launcher.

    ``z_ext``, ``src_slots`` and the plan are read by address at every
    call: refill them in place, never reallocate them. ``head``: the
    elements of z staged in shared memory (0 stages none; default the
    most that fits). ``work``: default a fresh workspace. ``out``: the
    contiguous [num_blocks * 128] buffer in z_ext's dtype the launch
    writes; default a fresh one."""
    dev = z_ext.device
    if dev.type != "cuda":
        raise ValueError(f"bind launches on cuda, not {dev}")
    if (z_ext.dtype, accum_dtype) not in _ENTRY:
        raise TypeError(f"no K1 entry for z {z_ext.dtype}, sums "
                        f"{accum_dtype}")
    num_segs = check_plan(plan, dev, num_blocks, src_slots.shape[0])
    if not isinstance(plan.empty_groups, torch.Tensor):
        raise ValueError("the plan has no empty-block list")
    if plan.item_segs.shape != (num_segs,):
        raise ValueError("the plan's work items do not cover its segments")
    if z_ext.data_ptr() % 16:
        raise ValueError("z_ext must be 16-byte aligned (the head is staged "
                         "in 16-byte vectors)")
    sentinel = z_ext.shape[0] - 8
    kind = device_kind(dev)
    head = check_head(head, z_ext.element_size(), sentinel, kind)
    work = workspace(plan, accum_dtype, dev) if work is None else work
    if (work.partial.shape != (num_segs, LANES)
            or work.chunk_sum.shape != (num_segs, LANES)
            or work.partial.dtype != accum_dtype
            or work.chunk_sum.dtype != accum_dtype
            or work.counter.shape != (num_blocks + num_segs,)
            or work.counter.dtype != torch.int32
            or any(t.device != dev for t in (work.partial, work.chunk_sum,
                                             work.counter))):
        raise ValueError("the workspace does not fit the plan")
    if out is None:
        out = torch.empty(num_blocks * LANES, dtype=z_ext.dtype, device=dev)
    elif (out.shape != (num_blocks * LANES,) or out.dtype != z_ext.dtype
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous [{num_blocks * LANES}] "
                         f"{z_ext.dtype} tensor on {dev}")
    num_empty = plan.empty_groups.shape[0]
    grid = persistent_grid(plan.num_items + num_empty, kind)
    args = (z_ext.data_ptr(), src_slots.data_ptr(),
            plan.seg_row_start.data_ptr(), plan.seg_block.data_ptr(),
            plan.block_seg_start.data_ptr(), plan.item_start.data_ptr(),
            plan.item_segs.data_ptr(), plan.empty_groups.data_ptr(),
            work.partial.data_ptr(), work.chunk_sum.data_ptr(),
            work.counter.data_ptr(), work.counter.data_ptr() + 4 * num_blocks,
            out.data_ptr(), plan.num_items, plan.num_split, num_empty,
            sentinel, head, grid)
    return Launcher(
        library="ell_contrib", entry=_ENTRY[(z_ext.dtype, accum_dtype)],
        error="ell_contrib_error_string", args=args, out=out, device=dev,
        count=_count,
        keep=(z_ext, src_slots, plan, work), head=head, grid=grid,
        smem=dynamic_smem(head, z_ext.element_size()))


def _check_columns(z_cols, src_slots, row_block, num_blocks, accum_dtype):
    if z_cols.dim() != 2 or z_cols.stride(1) != 1:
        raise ValueError(f"want z_cols [k, n+8] with contiguous rows, got "
                         f"{tuple(z_cols.shape)} strides {z_cols.stride()}")
    for j in range(z_cols.shape[0]):
        _check(z_cols[j], src_slots, row_block, num_blocks, accum_dtype)


def bind_columns(z_cols, src_slots, num_blocks, *, accum_dtype, plan,
                 work: Optional[Workspace] = None,
                 head: Optional[int] = None) -> List[Launcher]:
    """K1 bound once per column of a batch, on the card: launcher ``j``
    reads row ``j`` of ``z_cols`` (k, n_state + 8) as its ``z_ext`` and
    writes row ``j`` of one (k, num_blocks * 128) output, which every
    launcher's ``out_cols`` attribute holds (``out`` is its own row).
    All share one workspace, so they run one at a time on one stream.
    Each row must be 16-byte aligned: rows of (n_state + 8) x itemsize
    bytes, n_state a multiple of 128, are."""
    dev = z_cols.device
    if dev.type != "cuda":
        raise ValueError(f"bind_columns launches on cuda, not {dev}")
    if z_cols.dim() != 2 or z_cols.stride(1) != 1:
        raise ValueError(f"want z_cols [k, n+8] with contiguous rows, got "
                         f"{tuple(z_cols.shape)} strides {z_cols.stride()}")
    work = workspace(plan, accum_dtype, dev) if work is None else work
    out_cols = torch.empty((z_cols.shape[0], num_blocks * LANES),
                           dtype=z_cols.dtype, device=dev)
    launchers = [bind(z_cols[j], src_slots, num_blocks,
                      accum_dtype=accum_dtype, plan=plan, work=work,
                      head=head, out=out_cols[j])
                 for j in range(z_cols.shape[0])]
    for ln in launchers:
        ln.out_cols = out_cols
        ln._keep = (*ln._keep, z_cols, out_cols)
    return launchers


def ell_contrib_spmm(z_cols, src_slots, row_block, num_blocks, *,
                     accum_dtype, plan, work: Optional[Workspace] = None):
    """The batched contribution (``pagerank_tpu/ops/spmv.py:380``), one
    column a row: [k, num_blocks * 128] sums in z_cols's dtype from the
    prescaled columns ``z_cols`` [k, n_state + 8] (each row's trailing
    8 entries zero). On cuda, K1 once per column (:func:`bind_columns`;
    k launches); on the CPU, the plain plan-order version
    (:func:`ell_contrib_spmm_reference`). Where the JAX op returns
    [num_blocks * 128, k], this returns the transpose: the port keeps
    PPR state column-major, so that each column is a ``z_ext``."""
    _check_columns(z_cols, src_slots, row_block, num_blocks, accum_dtype)
    if z_cols.device.type == "cpu":
        return ell_contrib_spmm_reference(z_cols, src_slots,
                                          accum_dtype=accum_dtype, plan=plan)
    if z_cols.device.type != "cuda":
        raise ValueError(
            f"ell_contrib_spmm runs on cuda or cpu, not {z_cols.device}")
    launchers = bind_columns(z_cols, src_slots, num_blocks,
                             accum_dtype=accum_dtype, plan=plan, work=work)
    for ln in launchers:
        ln()
    return launchers[0].out_cols if launchers else torch.empty(
        (0, num_blocks * LANES), dtype=z_cols.dtype, device=z_cols.device)


def ell_contrib_spmm_reference(z_cols, src_slots, *, accum_dtype, plan):
    """:func:`ell_contrib_spmm` in plain PyTorch: each column through
    :func:`ell_contrib_plan_reference` (K1's own order), stacked
    [k, num_blocks * 128]. On the CPU this is the kernel's output bit
    for bit, column by column."""
    nb = len(plan.block_seg_start) - 1
    if z_cols.shape[0] == 0:
        return torch.empty((0, nb * LANES), dtype=z_cols.dtype,
                           device=z_cols.device)
    return torch.stack([
        ell_contrib_plan_reference(z, src_slots, accum_dtype=accum_dtype,
                                   plan=plan) for z in z_cols])


def ell_contrib_reference(z_ext, src_slots, row_block, num_blocks, *,
                          accum_dtype):
    """A plain PyTorch twin in another order: gather, widen to
    accum_dtype, add each slot row into its dst block, cast back to
    z_ext's dtype. On a CUDA tensor ``index_add_`` uses atomics, so its
    sum order (and last bits) vary from run to run: it is a comparison
    twin, never the main path."""
    v = z_ext[src_slots.long()].to(accum_dtype)
    buf = torch.zeros((num_blocks, LANES), dtype=accum_dtype,
                      device=z_ext.device)
    buf.index_add_(0, row_block.long(), v)
    return buf.reshape(-1).to(z_ext.dtype)


def row_partials(v, plan):
    """Each segment's rows summed in row order from 0 (``index_add_`` on
    the CPU adds in index order): [segments, 128], or [segments, 128,
    k] for rows of k columns (each column on its own)."""
    dev = v.device
    rs = torch.as_tensor(plan.seg_row_start, dtype=torch.long, device=dev)
    num_segs = rs.shape[0] - 1
    seg_of_row = torch.repeat_interleave(
        torch.arange(num_segs, device=dev), rs[1:] - rs[:-1])
    partial = torch.zeros((num_segs,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=dev)
    return partial.index_add_(0, seg_of_row, v)


def _runs(start, count):
    """The concatenated index ranges [start[i], start[i] + count[i])."""
    dev = start.device
    return torch.repeat_interleave(start, count) + (
        torch.arange(int(count.sum()), device=dev)
        - torch.repeat_interleave(torch.cumsum(count, 0) - count, count))


def group_sums(partial, group_seg_start, chunk: Optional[int] = CHUNK):
    """Each group's partials summed in the kernels' order: a group of
    one segment takes its partial as it is, a group of none is 0, a
    group of up to ``chunk`` segments sums them in segment order from 0,
    and a deeper group sums each run of ``chunk`` consecutive segments
    from 0, then those chunk sums in order from 0. ``chunk=None`` sums
    every group in one run from 0. [groups, 128] (or [groups, 128, k]
    for partials of k columns)."""
    dev = partial.device
    gss = torch.as_tensor(group_seg_start, dtype=torch.long, device=dev)
    nseg = gss[1:] - gss[:-1]
    if chunk is None:
        chunk = max(int(nseg.max()) if nseg.numel() else 0, 1)
    tail = tuple(partial.shape[1:])
    out = torch.zeros((nseg.shape[0],) + tail, dtype=partial.dtype,
                      device=dev)
    one = torch.nonzero(nseg == 1).reshape(-1)
    out[one] = partial[gss[one]]
    many = torch.nonzero((nseg > 1) & (nseg <= chunk)).reshape(-1)
    out.index_add_(0, torch.repeat_interleave(many, nseg[many]),
                   partial[_runs(gss[many], nseg[many])])
    deep = torch.nonzero(nseg > chunk).reshape(-1)
    if deep.numel():
        segs = _runs(gss[deep], nseg[deep])
        nchunks = -(-nseg[deep] // chunk)
        # each segment's chunk, numbered densely over the deep groups
        first = torch.cumsum(nchunks, 0) - nchunks
        chunk_of = (torch.repeat_interleave(first, nseg[deep])
                    + (segs - torch.repeat_interleave(gss[deep], nseg[deep]))
                    // chunk)
        sums = torch.zeros((int(nchunks.sum()),) + tail, dtype=partial.dtype,
                           device=dev)
        sums.index_add_(0, chunk_of, partial[segs])
        out.index_add_(0, torch.repeat_interleave(deep, nchunks), sums)
    return out


def ell_contrib_plan_reference(z_ext, src_slots, *, accum_dtype, plan):
    """K1's function in the kernel's order, in plain PyTorch: each
    segment's rows summed in row order from 0, then each block's
    partials as :func:`group_sums` orders them (a block of more than
    ``CHUNK`` segments chunk by chunk), an empty block 0. On the CPU
    (``index_add_`` adds in index order) this is the kernel's output
    bit for bit."""
    v = z_ext[src_slots.long()].to(accum_dtype)
    sums = group_sums(row_partials(v, plan), plan.block_seg_start)
    return sums.reshape(-1).to(z_ext.dtype)


def ell_contrib_segmented_reference(z_ext, src_slots, num_blocks, *,
                                    accum_dtype, plan):
    """The first kernel's two-pass order in plain PyTorch: rows summed
    into their segment's partial, then each block's partials added into
    a zero block in segment order."""
    dev = z_ext.device
    sb = torch.as_tensor(plan.seg_block, dtype=torch.long, device=dev)
    partial = row_partials(z_ext[src_slots.long()].to(accum_dtype),
                                plan)
    out = torch.zeros((num_blocks, LANES), dtype=accum_dtype, device=dev)
    out.index_add_(0, sb, partial)
    return out.reshape(-1).to(z_ext.dtype)
