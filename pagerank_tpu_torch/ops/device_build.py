"""On-device graph construction: the graph build in torch ops on the card.

Port of ``pagerank_tpu/ops/device_build.py``: ``DeviceEllGraph``
(:126-205) with the same ``"dev-…"`` fingerprint, the generators
``rmat_edges_device`` (:450) and ``uniform_edges_device`` (:436), the
stages ``_raw_in_degree``, ``_relabel_perm``, ``_relabel_sort``,
``_slot_coords``, ``_unrelabel_degree`` and ``_scatter_slots``
(:473-651), ``build_ell_device`` (:654-914), ``checkpoint_arrays`` /
``restore_device_graph`` (:208-301) and the partition part of
``plan_build`` (:344-368) as ``plan_partition_span``.

Edges are generated on the device from a seed, or uploaded as raw
(src, dst) int32 arrays (8 B an edge), and every later stage — degree
counts, the in-degree relabel, the one composite-key sort, dedup flags,
unique out-degrees, slot coordinates and the slot scatter — runs in
torch ops on that device. Semantics are those of ``graph.py`` +
``ops/ell.py`` (dedup before out-degree, self-loops kept, dangling =
out-degree 0 unless a crawl mask overrides it, relabel by descending
in-degree, stable). As in the JAX pipeline the relabel orders by RAW
in-degree and duplicate edges keep a slot each, inert; on deduplicated
edges the planes equal the host pack's bit for bit.

What differs from the JAX module, and why:

- torch has no multi-key sort: the one full-edge sort sorts the int64
  key ``(sb_dst << 32) | new_src``, exact because both halves are
  non-negative int32, and decodes it after;
- torch has no ``mode="drop"`` scatter: the duplicate slots a build
  without weights drops are masked to an add of 0 (integer adds
  commute, so the result is deterministic on CUDA), never written past
  the end;
- the fingerprint's wrapping-uint32 sums are computed in int64 masked
  to 32 bits, the multiply split into 16-bit halves and the sum taken
  in chunks;
- grouped lanes (``group`` > 1) are an XLA-path packing: the CUDA
  kernels read plain source ids, so ``group`` must be 1;
- the TPU's ``fast_cap`` striping is not planned: K1 reads one stripe,
  and only the partition-centric form stripes (by its span);
- no ``compile_cache.stage_call`` (no XLA executables to cache).

The data-plane profile (``obs/graph_profile.py``) runs only when armed
(CLI ``--graph-profile``): one pass of reductions over the sorted key
between the sort and the slot stages (:783-913), which reads the sort's
products and never writes them, and one transfer at the end of the
build; a disarmed build makes zero profile computations. The build
publishes the ``build.num_edges`` and ``build.slot_rows`` gauges.

Every tensor of a build lives on one device: cuda unless the caller
asks for another (the tests ask for the CPU). Host syncs: one for the
per-stripe row bounds and the unique-edge count, and one for the
dangling-mask check when a mask is given, as in JAX.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from pagerank_tpu_torch.engines.torch_engine import TorchEngine, resolve_device
from pagerank_tpu_torch.obs import graph_profile
from pagerank_tpu_torch.obs import log as obs_log
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.ops import LANES

_I32_MAX = np.iinfo(np.int32).max
_MASK32 = 0xFFFFFFFF
_GOLDEN = 2654435761
#: Elements per chunk of the fingerprint's reductions (32 MiB of int64).
_SUM_CHUNK = 1 << 22


def _fence(timings, key, t0, device):
    """Timing-mode stage fence: wait for the device and charge the wall
    since ``t0`` to ``timings[key]``. No-op when ``timings`` is None."""
    if timings is None:
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


def _mul32(x, c):
    """``x * c mod 2**32`` for int64 ``x`` and ``c`` in [0, 2**32): the
    multiply split into 16-bit halves of ``c``, so no product passes
    2**48 and none relies on int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def _chunks(a):
    flat = a.reshape(-1)
    for lo in range(0, flat.shape[0], _SUM_CHUNK):
        yield lo, flat[lo: lo + _SUM_CHUNK].to(torch.int64) & _MASK32


def _mixsum(a) -> int:
    """Position-weighted wrapping-uint32 checksum: JAX's ``_mixsum``
    (``sum(a * (i * 2654435761))`` in uint32 over the flattened array)."""
    total = torch.zeros((), dtype=torch.int64, device=a.device)
    for lo, x in _chunks(a):
        ix = torch.arange(lo, lo + x.shape[0], dtype=torch.int64,
                          device=a.device) & _MASK32
        total = (total + _mul32(x, _mul32(ix, _GOLDEN)).sum()) & _MASK32
    return int(total)


def _u32sum(a) -> int:
    """Wrapping-uint32 sum: JAX's ``_u32sum``."""
    total = torch.zeros((), dtype=torch.int64, device=a.device)
    for _, x in _chunks(a):
        total = (total + x.sum()) & _MASK32
    return int(total)


def _upload(a, dev):
    """An int32 tensor on ``dev`` (host arrays are cast on the host
    first, so 4 B an element cross)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    return a.to(device=dev, dtype=torch.int32)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


@dataclass
class DeviceEllGraph:
    """Blocked-ELL graph resident on one device (relabeled vertex
    space): the JAX class's fields as torch tensors.

    Striped form (``stripe_size`` set): ``src``/``weight``/``row_block``
    are LISTS of per-stripe tensors with STRIPE-LOCAL source ids, each a
    view into one buffer in which the stripes lie back to back.
    Single stripe: bare tensors, ids span n_padded. ``perm`` maps
    relabeled id -> original id.
    """

    n: int
    n_padded: int
    num_blocks: int
    src: object  # int32 [rows, 128] (or list): source per slot
    # f32 [rows, 128] (or list), 0 for padding/duplicate slots; None
    # when presentinel
    weight: object
    row_block: object  # int32 [rows] (or list), ascending dst-block id
    perm: torch.Tensor  # int32 [n] relabeled -> original
    dangling_mask: torch.Tensor  # bool [n] ORIGINAL id space
    zero_in_mask: torch.Tensor  # bool [n] ORIGINAL id space
    out_degree: torch.Tensor  # int32 [n] ORIGINAL id space (unique targets)
    num_edges: int  # unique edge count
    group: int = 1
    stripe_size: int = 0  # 0 = single stripe spanning n_padded
    # True: weight is None and inert slots (padding, duplicate edges)
    # already hold the sentinel word (the stripe span).
    presentinel: bool = False
    # Stage seconds of the build that made this graph, when it was
    # asked for them (build_ell_device's ``timings``).
    timings: Optional[dict] = None
    # Cached fingerprint (one reduction pass over every plane).
    _fp: Optional[str] = None

    @property
    def num_rows(self) -> int:
        return int(sum(s.shape[0] for s in _as_list(self.src)))

    @property
    def device(self) -> torch.device:
        return self.perm.device

    def fingerprint(self) -> str:
        """Stable structural hash for snapshot validation — the same
        string as the JAX package's ``DeviceEllGraph.fingerprint`` for
        the same build: layout statics plus wrapping-uint32 checksums of
        the degrees, the permutation, the slot words and row blocks (and
        of the dangling mask where it differs from out_degree == 0),
        without fetching a plane to the host. Cached on first call."""
        if self._fp is not None:
            return self._fp
        sums = [_u32sum(self.out_degree), _mixsum(self.out_degree),
                _mixsum(self.perm)]
        if bool(torch.any(self.dangling_mask != (self.out_degree == 0))):
            sums.append(_mixsum(self.dangling_mask.to(torch.int32)))
        sums += [_mixsum(s) for s in _as_list(self.src)]
        sums += [_mixsum(r) for r in _as_list(self.row_block)]
        h = hashlib.sha256()
        for v in (self.n, self.num_edges, self.group, self.stripe_size,
                  int(self.presentinel), *sums):
            h.update(np.int64(v).tobytes())
        self._fp = "dev-" + h.hexdigest()[:12]
        return self._fp


def checkpoint_arrays(dg: DeviceEllGraph) -> Tuple[dict, dict]:
    """Host-side (arrays, meta) snapshot of a built device graph, with
    the JAX package's array names and meta: per-stripe planes as
    ``src_<i>``/``row_block_<i>``/``weight_<i>``, the layout geometry
    and the structural fingerprint."""
    srcs, rbs, ws = (_as_list(dg.src), _as_list(dg.row_block),
                     _as_list(dg.weight))
    arrays = {"perm": dg.perm, "dangling_mask": dg.dangling_mask,
              "zero_in_mask": dg.zero_in_mask, "out_degree": dg.out_degree}
    for i, s in enumerate(srcs):
        arrays[f"src_{i}"] = s
    for i, r in enumerate(rbs):
        arrays[f"row_block_{i}"] = r
    weighted = any(w is not None for w in ws)
    if weighted:
        for i, w in enumerate(ws):
            arrays[f"weight_{i}"] = w
    arrays = {k: v.cpu().numpy() for k, v in arrays.items()}
    meta = {
        "kind": "device_ell_graph",
        "n": dg.n, "n_padded": dg.n_padded, "num_blocks": dg.num_blocks,
        "num_edges": dg.num_edges, "group": dg.group,
        "stripe_size": dg.stripe_size, "presentinel": bool(dg.presentinel),
        "n_stripes": len(srcs),
        "listed": isinstance(dg.src, (list, tuple)),
        "weighted": weighted,
        "fingerprint": dg.fingerprint(),
    }
    return arrays, meta


def restore_device_graph(arrays: dict, meta: dict,
                         device=None) -> DeviceEllGraph:
    """Inverse of :func:`checkpoint_arrays` (of either package): the
    persisted planes back on ``device`` (default cuda) as a
    :class:`DeviceEllGraph`. The fingerprint is recomputed on the
    device and must equal the recorded one."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(
            dev)

    k = int(meta["n_stripes"])
    listed = bool(meta.get("listed", k > 1))
    srcs = [put(arrays[f"src_{i}"]) for i in range(k)]
    rbs = [put(arrays[f"row_block_{i}"]) for i in range(k)]
    ws = ([put(arrays[f"weight_{i}"]) for i in range(k)]
          if meta.get("weighted") else [None] * k)
    dg = DeviceEllGraph(
        n=int(meta["n"]), n_padded=int(meta["n_padded"]),
        num_blocks=int(meta["num_blocks"]),
        src=srcs if listed else srcs[0],
        weight=ws if listed else ws[0],
        row_block=rbs if listed else rbs[0],
        perm=put(arrays["perm"]),
        dangling_mask=put(arrays["dangling_mask"]).to(torch.bool),
        zero_in_mask=put(arrays["zero_in_mask"]).to(torch.bool),
        out_degree=put(arrays["out_degree"]),
        num_edges=int(meta["num_edges"]), group=int(meta["group"]),
        stripe_size=int(meta["stripe_size"]),
        presentinel=bool(meta["presentinel"]),
    )
    fp = dg.fingerprint()
    if fp != meta.get("fingerprint"):
        raise ValueError(
            f"restored device graph fingerprint {fp} != recorded "
            f"{meta.get('fingerprint')}"
        )
    return dg


def plan_partition_span(cfg, n: int, num_edges: Optional[int],
                        partition_span: int) -> int:
    """The partition span a build should use for ``cfg`` on a graph of
    ``n`` vertices (the partition part of ``plan_build``, :344-368): 0
    (off) under 64-bit accumulation, vertex sharding or a non-ELL
    kernel; the engine's auto rule for -1 (``TorchEngine.
    partition_span`` over ``num_edges``, 0 when the graph is too small
    or sparse to win; a device build passes the raw count, as the JAX
    CLI does); then at most the padded vertex count, rounded down to a
    multiple of 128. A device build packs its stripes at this span (0:
    one stripe, the flat form K1 reads) with lane group 1."""
    from pagerank_tpu_torch.utils.config import torch_dtype

    n_padded = -(-n // LANES) * LANES
    z_item = max(torch_dtype(cfg.dtype).itemsize,
                 torch_dtype(cfg.accum_dtype).itemsize)
    part = partition_span
    if part and (z_item > 4 or cfg.vertex_sharded
                 or cfg.kernel not in ("auto", "ell", "pallas")):
        if part > 0:
            _log("partition_span requires an ELL kernel with 32-bit "
                 "accumulation, replicated mode; planning the default "
                 "layout")
        part = 0
    if part == -1:
        part = TorchEngine.partition_span(n_padded, num_edges, z_item)
    part = min(int(part or 0), n_padded)
    if part:
        rounded = max(LANES, part & ~(LANES - 1))
        if rounded != part:
            _log(f"partition_span rounded {part} -> {rounded} (must be a "
                 f"multiple of {LANES})")
            part = rounded
    return part


def _log(msg: str) -> None:
    obs_log.info(msg)


def _generator(device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def uniform_edges_device(n: int, num_edges: int, seed: int = 0,
                         device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform random int32 edges generated on ``device`` (default
    cuda): only the seed crosses to the device. The stream is a
    ``torch.Generator`` on that device seeded by ``seed``: deterministic
    per seed on one device type, but the CPU and CUDA streams differ,
    and neither is JAX's ``rbg`` stream nor the host generator's."""
    dev = resolve_device(device)
    g = _generator(dev, seed)
    src = torch.randint(0, n, (num_edges,), generator=g, device=dev,
                        dtype=torch.int32)
    dst = torch.randint(0, n, (num_edges,), generator=g, device=dev,
                        dtype=torch.int32)
    return src, dst


def rmat_edges_device(scale: int, edge_factor: int = 16, a: float = 0.57,
                      b: float = 0.19, c: float = 0.19, seed: int = 0,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``edge_factor * 2**scale`` R-MAT edges generated on ``device``
    (default cuda): the recursive-quadrant scheme of
    ``utils/synth.rmat_edges`` and the JAX ``_rmat_gen`` (f32 draws, the
    same thresholds), then the int32 label scramble. The stream is a
    ``torch.Generator`` on that device seeded by ``seed``: deterministic
    per seed on one device type, but the CPU and CUDA streams differ,
    and neither is JAX's ``rbg`` stream nor numpy's."""
    dev = resolve_device(device)
    g = _generator(dev, seed)
    n_edges = edge_factor << scale
    ab = a + b
    f32 = torch.float32
    a_frac = torch.tensor(a / ab, dtype=f32, device=dev)
    c_frac = torch.tensor(c / (1.0 - ab), dtype=f32, device=dev)
    ab = torch.tensor(ab, dtype=f32, device=dev)
    src = torch.zeros(n_edges, dtype=torch.int32, device=dev)
    dst = torch.zeros(n_edges, dtype=torch.int32, device=dev)
    for _ in range(scale):
        src_bit = torch.rand(n_edges, generator=g, device=dev, dtype=f32) >= ab
        c_bit = torch.rand(n_edges, generator=g, device=dev, dtype=f32)
        dst_bit = c_bit >= torch.where(src_bit, c_frac, a_frac)
        del c_bit
        src <<= 1
        src |= src_bit
        dst <<= 1
        dst |= dst_bit
        del src_bit, dst_bit
    # Scramble the labels so hubs are not clustered at id 0 (an int32
    # permutation, like the JAX generator's iota shuffle).
    perm = torch.randperm(1 << scale, generator=g, device=dev,
                          dtype=torch.int32)
    return perm[src], perm[dst]


def _raw_in_degree(dst, *, n):
    """Raw (pre-dedup) in-degree by an unsorted integer scatter-add."""
    ones = torch.ones(1, dtype=torch.int32, device=dst.device)
    return torch.zeros(n, dtype=torch.int32, device=dst.device).index_add_(
        0, dst, ones.expand(dst.shape[0]))


def _relabel_perm(in_degree):
    """Stable in-degree-descending permutation (the stability is part of
    the result: ties keep id order). Returns (perm, inv_perm), int32;
    perm maps relabeled -> original."""
    n = in_degree.shape[0]
    perm = torch.sort(-in_degree, stable=True).indices.to(torch.int32)
    inv_perm = torch.empty(n, dtype=torch.int32, device=perm.device)
    inv_perm[perm] = torch.arange(n, dtype=torch.int32, device=perm.device)
    return perm, inv_perm


def _relabel_sort(edges, inv_perm, *, n_padded, stripe_size):
    """Relabel the raw edges and run THE one full-edge sort, by (stripe,
    new dst) with new src as the tiebreak: one sort of the int64 key
    ``(sb_dst << 32) | new_src``. Returns the decoded int32 (sb_dst,
    new_src), where ``sb_dst = stripe * n_padded + new_dst``
    (build_ell_device guards its int32 range). Duplicates land adjacent
    under this total order. ``edges`` = [src, dst] is emptied, so the
    raw edges are freed (where nothing else holds them) before the
    sort's peak."""
    src, dst = edges
    edges.clear()
    new_src = inv_perm[src]
    sb_dst = inv_perm[dst]
    del src, dst
    sz = stripe_size or n_padded
    if -(-n_padded // sz) > 1:
        sb_dst = (new_src // sz) * n_padded + sb_dst
    key = (sb_dst.to(torch.int64) << 32) | new_src.to(torch.int64)
    del new_src, sb_dst
    key = torch.sort(key).values
    return (key >> 32).to(torch.int32), (key & _MASK32).to(torch.int32)


def _slot_coords(sb_dst, new_src, *, n, n_padded, weight_dtype, group,
                 stripe_size, with_weights=True):
    """Per-edge ELL slot coordinates from the (stripe, dst, src)-sorted
    key, plus the dedup-corrected degrees: first-occurrence flags from
    key adjacency, the UNIQUE out-degree by a scatter-add of those flags
    (``.distinct()`` before degree, Sparky.java:124). A slot's row is
    its rank in its (stripe, dst) run, found by a binary search for the
    run's first index (the runs are contiguous in the sorted key). With
    striping, stripe s owns the contiguous row range
    [row_offset[s*num_blocks], row_offset[(s+1)*num_blocks]) and slot
    words hold stripe-local source ids. Without weights, duplicate
    slots get the row index ``rows_total + 1`` (dropped by the
    scatter)."""
    if group != 1:
        raise ValueError(_GROUP_MSG)
    dev = sb_dst.device
    sz = stripe_size or n_padded
    n_stripes = -(-n_padded // sz)
    i32 = torch.int32

    unique2 = torch.ones(sb_dst.shape[0], dtype=torch.bool, device=dev)
    unique2[1:] = (sb_dst[1:] != sb_dst[:-1]) | (new_src[1:] != new_src[:-1])
    out_degree_rel = torch.zeros(n, dtype=i32, device=dev).index_add_(
        0, new_src, unique2.to(i32))
    num_edges = unique2.sum()
    if with_weights:
        inv_out = torch.where(out_degree_rel > 0,
                              1.0 / out_degree_rel.to(weight_dtype), 0.0)
        w = torch.where(unique2, inv_out[new_src], 0.0).to(weight_dtype)
        del inv_out
    else:
        w = None

    e = sb_dst.shape[0]
    row = torch.arange(e, dtype=i32, device=dev)
    row -= torch.searchsorted(sb_dst, sb_dst, out_int32=True)
    if n_stripes > 1:
        stripe_of = sb_dst // n_padded
        new_dst = sb_dst - stripe_of * n_padded
        word = new_src - stripe_of * sz
        sb = stripe_of * (n_padded // LANES) + new_dst // LANES
        del stripe_of
    else:
        new_dst, word, sb = sb_dst, new_src, sb_dst // LANES
    pos = (new_dst % LANES).to(torch.int8)
    del new_dst

    # Rows per (stripe, 128-dst block) = the deepest lane's run length.
    num_sb = n_stripes * (n_padded // LANES)
    sb_rows = torch.zeros(num_sb, dtype=i32, device=dev).scatter_reduce_(
        0, sb.to(torch.int64), row + 1, "amax")
    row_offset = torch.zeros(num_sb + 1, dtype=i32, device=dev)
    torch.cumsum(sb_rows, 0, dtype=i32, out=row_offset[1:])
    row_idx = row_offset[sb] + row
    del sb, row
    if not with_weights:
        row_idx = torch.where(unique2, row_idx, row_offset[-1] + 1)
    return (word, w, row_idx, pos, sb_rows, row_offset, out_degree_rel,
            num_edges)


def _unrelabel_degree(out_degree_rel, perm):
    """Unique out-degree back in ORIGINAL id space."""
    out = torch.zeros(perm.shape[0], dtype=torch.int32, device=perm.device)
    out[perm] = out_degree_rel
    return out


def _scatter_slots(word, row_idx, pos, sb_rows, w=None, *, rows_total,
                   num_blocks, n_stripes=1, fill=0):
    """Place the slot planes: ``src`` [rows_total, 128] filled with
    ``fill`` and each edge's word at (row_idx, pos), the weight plane
    likewise (0 fill), and the per-row block ids. The flat slot index
    is int64 (rows x 128 passes 2**31 at rmat:26). Slots whose row is
    out of range (the duplicates a build without weights drops) are
    masked to an add of 0 at slot 0: every kept slot gets exactly one
    integer add, so the plane is deterministic on CUDA."""
    dev = word.device
    keep = row_idx < rows_total
    flat = torch.where(keep, row_idx.to(torch.int64) * LANES
                       + pos.to(torch.int64), 0)
    delta = torch.where(keep, word - fill, 0)
    src_slots = torch.zeros(rows_total * LANES, dtype=torch.int32,
                            device=dev).index_add_(0, flat, delta)
    del delta
    src_slots += fill
    src_slots = src_slots.view(rows_total, LANES)
    if w is not None:
        w_slots = torch.zeros(rows_total * LANES, dtype=w.dtype, device=dev)
        w_slots[flat] = w  # a build with weights drops no slot
        w_slots = w_slots.view(rows_total, LANES)
    else:
        w_slots = None
    blocks = torch.arange(num_blocks, dtype=torch.int32,
                          device=dev).repeat(n_stripes)
    row_block = torch.repeat_interleave(blocks, sb_rows,
                                        output_size=rows_total)
    return src_slots, w_slots, row_block


_GROUP_MSG = (
    "group must be 1: grouped lanes are an XLA-path packing and the CUDA "
    "kernels read plain source ids (not applicable in the port)"
)


def build_ell_device(
    src, dst, n: int, weight_dtype=torch.float32, group: int = 1,
    stripe_size: int = 0, with_weights: bool = True, dangling_mask=None,
    timings: Optional[dict] = None, device=None,
) -> DeviceEllGraph:
    """Full graph build on one device from raw (possibly duplicated)
    edges.

    ``src``/``dst`` are int32 tensors already on the device (a device
    generator's output) or host arrays, uploaded once (8 B an edge).
    ``device`` defaults to the device of a tensor ``src``, else cuda.
    ``stripe_size`` (a multiple of 128) packs the source-striped layout
    the partition-centric form reads (0 = one stripe). ``with_weights``
    False skips the weight plane: inert slots hold the sentinel word
    (the stripe span) directly (``presentinel``), the form the engine
    consumes. ``dangling_mask`` (bool [n], original ids) overrides the
    default out_degree == 0 mass mask (crawl inputs: the uncrawled
    targets). ``timings`` (a dict) fences each stage and records its
    wall under ``relabel_s``/``sort_s``/``slots_s``/``scatter_s``; the
    graph keeps it as ``timings``.

    The build drops its references to the raw edges before its sort;
    the caller's keep them alive, so drop them to free 8 B an edge
    before the sort's peak.
    """
    if group != 1:
        raise ValueError(_GROUP_MSG)
    if device is None and isinstance(src, torch.Tensor):
        device = src.device
    dev = resolve_device(device)
    n_padded = -(-n // LANES) * LANES
    if stripe_size and (stripe_size <= 0 or stripe_size % LANES):
        raise ValueError("stripe_size must be a positive multiple of 128")
    sz = min(stripe_size, n_padded) if stripe_size and n_padded else n_padded
    if stripe_size and sz < stripe_size:
        stripe_size = sz  # single short stripe; keep ids consistent
    n_stripes = -(-n_padded // sz) if n_padded else 0
    if n_stripes > 1 and n_stripes * n_padded > _I32_MAX:
        raise ValueError(
            f"striped sort key overflows int32: {n_stripes} stripes * "
            f"n_padded {n_padded} (graphs this large exceed single-chip "
            "HBM anyway; use the host build)"
        )
    edges = [_upload(a, dev) for a in (src, dst)]
    del src, dst
    num_blocks = n_padded // LANES
    listed = bool(stripe_size)
    if edges[0].shape[0] == 0 or n == 0:  # edge-free graph (comment-only input)
        def empty(shape, dtype):
            t = torch.zeros(shape, dtype=dtype, device=dev)
            return [t] * n_stripes if listed else t

        return DeviceEllGraph(
            n=n, n_padded=n_padded, num_blocks=num_blocks,
            src=empty((0, LANES), torch.int32),
            weight=(empty((0, LANES), weight_dtype) if with_weights
                    else ([None] * n_stripes if listed else None)),
            row_block=empty(0, torch.int32),
            perm=torch.arange(n, dtype=torch.int32, device=dev),
            dangling_mask=(torch.ones(n, dtype=torch.bool, device=dev)
                           if dangling_mask is None else
                           torch.as_tensor(dangling_mask).to(dev, torch.bool)),
            zero_in_mask=torch.ones(n, dtype=torch.bool, device=dev),
            out_degree=torch.zeros(n, dtype=torch.int32, device=dev),
            num_edges=0, group=1, stripe_size=stripe_size,
            presentinel=not with_weights, timings=timings,
        )

    # Stage 1 (relabel): raw in-degrees, then the stable permutation.
    # Raw degree == 0 iff unique degree == 0 (a duplicate needs an edge).
    t0 = time.perf_counter()
    in_raw = _raw_in_degree(edges[1], n=n)
    perm, inv_perm = _relabel_perm(in_raw)
    zero_in = in_raw == 0
    del in_raw
    _fence(timings, "relabel_s", t0, dev)

    # Stage 2 (sort): relabel the raw edges and run the one sort.
    stripe_arg = sz if n_stripes > 1 else 0
    t0 = time.perf_counter()
    sb_dst, new_src = _relabel_sort(edges, inv_perm, n_padded=n_padded,
                                    stripe_size=stripe_arg)
    del inv_perm
    _fence(timings, "sort_s", t0, dev)

    # Data-plane profile: reductions over the sorted key BEFORE the slot
    # stage consumes it; read-only and armed-only.
    prof_stats = None
    if graph_profile.armed():
        prof_stats = graph_profile.device_stats(
            sb_dst, new_src, perm, n=n, n_padded=n_padded,
            stripe_size=stripe_arg, num_blocks=num_blocks)

    # Stage 3 (slots): coordinates, dedup flags, unique out-degrees.
    t0 = time.perf_counter()
    (word, w, row_idx, pos, sb_rows, row_offset, out_rel,
     num_edges_dev) = _slot_coords(
        sb_dst, new_src, n=n, n_padded=n_padded, weight_dtype=weight_dtype,
        group=1, stripe_size=stripe_arg, with_weights=with_weights)
    del sb_dst, new_src
    out_degree = _unrelabel_degree(out_rel, perm)
    del out_rel
    # The per-stripe row bounds + the unique-edge count: ONE host sync.
    host = torch.cat([row_offset[::num_blocks].to(torch.int64),
                      num_edges_dev.reshape(1)]).cpu().tolist()
    stripe_bounds, num_edges = host[:-1], int(host[-1])
    rows_total = stripe_bounds[-1]
    _fence(timings, "slots_s", t0, dev)
    obs_metrics.gauge(
        "build.num_edges", "unique edges of the latest device build"
    ).set(num_edges)
    obs_metrics.gauge(
        "build.slot_rows", "packed 128-lane slot rows of the latest "
        "device build"
    ).set(rows_total)

    if dangling_mask is None:
        mass_mask = out_degree == 0
    else:
        mass_mask = torch.as_tensor(dangling_mask).to(dev, torch.bool)
        if bool(torch.any(mass_mask & (out_degree > 0))):
            raise ValueError("dangling_mask marks a vertex that has out-edges")

    # Stage 4 (scatter): place the slot planes.
    fill = 0 if with_weights else sz  # the engine's sentinel word
    t0 = time.perf_counter()
    src_slots, w_slots, row_block = _scatter_slots(
        word, row_idx, pos, sb_rows, w, rows_total=rows_total,
        num_blocks=num_blocks, n_stripes=n_stripes, fill=fill)
    del word, w, row_idx, pos
    if listed:
        # Per-stripe views of the one buffer (no copy).
        cuts = list(zip(stripe_bounds[:-1], stripe_bounds[1:]))
        src_slots = [src_slots[lo:hi] for lo, hi in cuts]
        w_slots = ([w_slots[lo:hi] for lo, hi in cuts] if w_slots is not None
                   else [None] * n_stripes)
        row_block = [row_block[lo:hi] for lo, hi in cuts]
    _fence(timings, "scatter_s", t0, dev)
    dg = DeviceEllGraph(
        n=n, n_padded=n_padded, num_blocks=num_blocks,
        src=src_slots, weight=w_slots, row_block=row_block,
        perm=perm, dangling_mask=mass_mask, zero_in_mask=zero_in,
        out_degree=out_degree, num_edges=num_edges, group=1,
        stripe_size=stripe_size, presentinel=not with_weights,
        timings=timings,
    )
    if prof_stats is not None:
        # The build's own per-(stripe, block) rows and, for a crawl's
        # explicit mask, its dangling count; one transfer.
        profile = graph_profile.finish_device_profile(
            prof_stats, stripe_size=stripe_size, group=1, n=n,
            n_padded=n_padded, block_rows=sb_rows,
            dangling_count_override=(mass_mask.sum()
                                     if dangling_mask is not None else None),
            fingerprint=dg.fingerprint())
        graph_profile.publish(profile)
    return dg


def joined(parts):
    """Per-stripe planes as one tensor along dim 0: a view when they lie
    back to back in one buffer (as :func:`build_ell_device` leaves
    them), else a copy."""
    parts = _as_list(parts)
    first = parts[0]
    rows = sum(p.shape[0] for p in parts)
    step = int(np.prod(first.shape[1:]))
    off = first.storage_offset()
    for p in parts:
        if not (p.is_contiguous() and p.storage_offset() == off
                and p.untyped_storage().data_ptr()
                == first.untyped_storage().data_ptr()):
            return torch.cat(parts)
        off += p.shape[0] * step
    return first.as_strided((rows, *first.shape[1:]), first.stride())
