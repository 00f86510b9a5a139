"""TorchEngine — the single-device ELL PageRank solve in PyTorch.

Port of the single-device ELL forms of ``JaxTpuEngine``
(``pagerank_tpu/engines/jax_engine.py``) that run a hand kernel:

- the flat form: the flat branch of the build (:578-665), the pallas
  branch of ``_setup_ell`` (:1066-1433 — sentinel repoint :1117-1121,
  prescale :1356-1358), run by K1;
- the partition-centric form (``partition_span`` > 0): the routing
  (:530-576), the layout of ``_setup_ell_partitioned`` (:1442-1626) and
  the pallas-partitioned setup (:1720-1916), run by K2 — without the
  XLA chunk autotune, the grouped lanes, the TPU's per-partition chunk
  padding (:1523-1537, :1557), the probe and the
  ``PallasUnavailableError`` downgrade;

- the coo form (``kernel="coo"``, :666-694): the dst-sorted edge list
  of one shard (``parallel/partition.py:42 partition_edges`` at one
  shard needs no padding: the graph's own arrays), weights 1/out-degree
  of the source in the rank dtype, a state of n with no padding, and
  ``ops/spmv.edge_contrib_segment_sum`` (torch ops in a fixed order; no
  hand kernel);

and ``_finalize`` with its ``update_tail`` (:3331-3426),
``rank_mass``/``ranks``/``decode_ranks``/``set_ranks``/``layout_info``/
``snapshot_meta`` (:4560-4650), the async writer's payload
(``device_ranks``, ``cli.py:1856-1861``) and the SDC-checked step
(:3826-4075: ``sdc_supported``, ``retain_state``, ``restore_state``,
``sdc_state_values``, ``step_sdc``; the ledger sums of ``_ledger_sums``
:103). The checked step runs the same contribution launch and update as
``step()`` (so a checked run is bit-identical to a plain one), then a
check tail of torch reductions in the accumulation dtype (w·r in and
out, the masses, the source mass over out-degree > 0, the contribution
and retained totals), fetched to the host in one transfer; and the
probed step (:3633-3662, the ledger sums :3764-3810: ``step_probed``,
``probe_values``, ``ledger_values``): ``step()``'s launch and update,
then the probe tail (rank mass, the top-k of the valid lanes with
``lax.top_k``'s lowest-index tie rule, the entered count, the top-k
mass) and the ledger sums ``step_sdc`` shares, with every scalar and
the k ids fetched in one transfer. Every build resets the per-graph
state (``_finalize``'s caches, :3420): the payload stream, the device
``perm``, the pinned pool, the SDC vector, the ledger sums and the
step's cost model.

Every device, the CPU included, runs the same host pack as the JAX
engine's pallas forms: lane group 1, inert slots pointing at a zero
sentinel, and (flat form) z kept in ``accum_dtype`` when that is wider
than the rank dtype. Per step:

    coo:          contrib = Σ_{dst-sorted edges} r[src]·w (ops/spmv)
    flat:         z_ext = [r·inv_out, 0×8]              (prescale)
                  contrib = K1(z_ext, slots)            (ops/ell_spmv)
    partitioned:  z_windows[k] = [(r·inv_out)[k·psz:(k+1)·psz], 0…]
                  contrib = K2(z_windows, slots)        (ops/ell_spmv_partitioned:
                            the pair sums, added into their dst blocks
                            in partition order, in the one launch)
    then          m = Σ_dangling r, r' = apply_update(contrib, r, ...),
                  delta = Σ |r' - r|                    (accum_dtype)

On ``cuda`` the kernels are the hand-written ones, bound once at build
(``ell_spmv.bind``: inputs, plan and workspace checked once, so a step
pays one ctypes call); on ``cpu`` the wrappers run their plain
versions. There is no fallback between the two: a CUDA engine launches
the kernel or raises. The kernels, z and the windows stay in device
memory (the TPU forms' VMEM limits have no counterpart here).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional

import numpy as np
import torch

from pagerank_tpu_torch import graph as graph_mod
from pagerank_tpu_torch.engine import PageRankEngine, register_engine
from pagerank_tpu_torch.graph import Graph
from pagerank_tpu_torch.models import pagerank as pr_model
from pagerank_tpu_torch.ops import LANES
from pagerank_tpu_torch.ops import ell as ell_lib
from pagerank_tpu_torch.ops import ell_spmv, ell_spmv_partitioned
from pagerank_tpu_torch.ops import spmv
from pagerank_tpu_torch.utils.config import torch_dtype

#: Zero lanes appended to z: the sentinel index n_state reads one.
Z_PAD = 8


def resolve_device(device=None) -> torch.device:
    """The engine's device: cuda unless the caller asks for something
    else. Asking for cuda on a host with no card raises — the port
    never runs on the CPU unless told to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run the port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev


@register_engine("torch")
class TorchEngine(PageRankEngine):
    """Flat or partition-centric blocked-ELL power iteration on one
    device."""

    # Partition-centric layout rule, with the JAX engine's constants
    # (jax_engine.py:289-305) so that -1 resolves to the same span in
    # both packages: a (partition, 128-dst block) cell must hold about
    # PART_MIN_CELL_EDGES edges on average or its ELL padding floor eats
    # the stream savings, and the window is held to
    # PART_MAX_WINDOW_BYTES. A rule of the H100's own comes with its
    # measurements.
    PART_MIN_CELL_EDGES = 512
    PART_MAX_WINDOW_BYTES = 12 << 20
    # Hard cap on the partition count: an undersized explicit span
    # would multiply the per-partition expansion steps.
    MAX_PARTITIONS = 256

    @classmethod
    def partition_span(cls, n_padded: int, num_edges, z_item: int = 4) -> int:
        """Auto partition span (``jax_engine.py:307-341``): the SMALLEST
        power-of-two span (>= 2^15) whose expected (partition, dst-block)
        cell edges ``num_edges * span * 128 / n_padded^2`` reach
        ``PART_MIN_CELL_EDGES``, with at least two partitions, at most
        ``MAX_PARTITIONS`` and a window of at most
        ``PART_MAX_WINDOW_BYTES``. 0 = not worth engaging."""
        if not num_edges or n_padded < (2 << 15):
            return 0
        span = 1 << 15
        while span * cls.MAX_PARTITIONS < n_padded:
            span *= 2
        while span * 2 <= n_padded:
            cells = num_edges * span * 128.0 / float(n_padded) ** 2
            if cells >= cls.PART_MIN_CELL_EDGES:
                break
            span *= 2
        else:
            return 0
        if span * 2 > n_padded or span * z_item > cls.PART_MAX_WINDOW_BYTES:
            return 0
        return span

    @staticmethod
    def partition_words24(span: int) -> bool:
        """Whether partition-local slot words (sentinel = span) fit 24
        bits — the 3-byte planar slot stream (``ops/spmv.py:
        pack_words24``); int32 words otherwise (``jax_engine.py:
        343-351`` at lane group 1)."""
        return span < (1 << 24)

    def __init__(self, config=None, device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self._dtype = torch_dtype(self.config.dtype)
        self._accum = torch_dtype(self.config.accum_dtype)
        # z rides in accum when that is wider than the rank dtype, so
        # the per-edge products carry accum precision into the sum.
        self._z_dtype = (self._accum if self._accum.itemsize
                         > self._dtype.itemsize else self._dtype)
        self._layout: Dict[str, object] = {}
        self._perm: Optional[np.ndarray] = None
        self._launch: Optional[ell_spmv.Launcher] = None
        self._reset_graph_state()

    def _reset_graph_state(self) -> None:
        """Drop everything made for the previous graph (every build
        calls this): the async writer's side stream, the relabel on the
        device and the free pinned buffers (device_ranks, made at the
        first payload), the SDC projection vector (made at the first
        checked step), the last step's ledger sums and the step's cost
        model."""
        self._copy_stream = None
        self._perm_dev: Optional[torch.Tensor] = None
        self._pinned = collections.deque()
        self._sdc_w_vec: Optional[torch.Tensor] = None
        self._last_ledger = None
        self._step_cost = None

    def _check_span(self, psz: int, n_padded: int) -> int:
        """The partition count of span ``psz``; raises past
        ``MAX_PARTITIONS``."""
        parts = -(-n_padded // psz)
        if parts > self.MAX_PARTITIONS:
            raise ValueError(
                f"partition_span {psz} gives {parts} partitions "
                f"(> {self.MAX_PARTITIONS}): span too small for this "
                f"graph — raise partition_span (auto rule: "
                f"TorchEngine.partition_span)"
            )
        return parts

    def build(self, graph: Graph) -> "TorchEngine":
        """Build from a host :class:`Graph`: the ELL pack, planes and
        plans on the host, then placement on the engine's device."""
        cfg = self.config
        self.graph = graph
        n = graph.n
        t0 = time.perf_counter()
        if cfg.kernel == "coo":
            return self._build_coo(graph, t0)
        if cfg.partition_span:
            n_padded = -(-n // LANES) * LANES
            psz = min(cfg.partition_span, max(LANES, n_padded))
            self._check_span(psz, n_padded)
            pack = ell_lib.ell_pack_striped(graph, stripe_size=psz)
        else:
            pack = ell_lib.ell_pack(graph)
        t1 = time.perf_counter()
        self._perm = pack.perm
        pad = pack.n_padded - n

        mass_mask = (graph.dangling_mask if cfg.semantics == "reference"
                     else graph.out_degree == 0)

        def relabel(a):  # per-vertex plane -> relabeled, zero-padded
            return torch.from_numpy(
                np.concatenate([a[pack.perm], np.zeros(pad, a.dtype)]))

        planes = {"dangling": relabel(mass_mask),
                  "zero_in": relabel(graph.zero_in_mask),
                  "valid": relabel(np.ones(n, bool)),
                  "inv_out": relabel(graph_mod.inv_out_degree(
                      graph.out_degree))}
        if cfg.partition_span:
            srcs = [np.where(pack.weight[p] != 0, pack.src[p], np.int32(psz))
                    for p in range(pack.n_stripes)]
            src = np.concatenate(srcs)
            del srcs
            arrays, plan, layout = self._plan_partitioned(
                src, pack.row_block, pack.num_blocks, psz, pack.padding_ratio)
        else:
            arrays, plan, layout = self._plan_flat(
                ell_lib.sentinel_slots(pack), pack.row_block, pack.num_blocks,
                pack.padding_ratio)
        t2 = time.perf_counter()
        return self._place(pack.n_padded, pack.num_blocks, planes, arrays,
                           plan, {**layout, "build": "host"},
                           {"pack": t1 - t0, "plan": t2 - t1}, t2)

    def build_device(self, dg) -> "TorchEngine":
        """Build from a :class:`~pagerank_tpu_torch.ops.device_build.
        DeviceEllGraph` (``jax_engine.py:369-470``) on the engine's
        device: the masks and 1/out-degree are relabeled there, only
        ``perm`` (n x 4 B) and the row blocks (for the plans) cross to
        the host, and the slot plane never does. The flat form takes the
        graph's sentinel-ized plane as K1's ``src`` as it is (no copy);
        the partitioned form takes the stripes' one buffer whole and
        packs the 3-byte words on the device. The graph is left whole:
        its int32 plane of the partitioned form is freed once the caller
        drops the graph."""
        from pagerank_tpu_torch.ops.device_build import (DeviceEllGraph,
                                                         joined)

        if not isinstance(dg, DeviceEllGraph):
            raise TypeError(f"build_device needs a DeviceEllGraph, got "
                            f"{type(dg).__name__}")
        cfg, dev = self.config, self.device
        if cfg.kernel == "coo":
            raise ValueError("build_device supports the ell/pallas kernels "
                             "only")
        if dg.device.type != dev.type:
            raise ValueError(f"device graph on {dg.device}, engine on {dev}: "
                             f"build the graph on the engine's device")
        if dg.group != 1:
            raise ValueError("the port's kernels need a group=1 device graph; "
                             "pass group=1 to build_ell_device")
        stripe = dg.stripe_size or dg.n_padded
        part = int(cfg.partition_span)
        if part:
            part = min(part, dg.n_padded) if dg.n_padded else part
            # The partitioned layout consumes a device graph whose
            # STRIPES are the partitions (plan_partition_span sizes
            # the build so).
            if stripe != part:
                raise ValueError(
                    f"partition_span {part} needs a device graph built "
                    f"with stripe_size={part} (got {stripe}); plan the "
                    f"build via ops/device_build.plan_partition_span")
            self._check_span(part, dg.n_padded)
        elif stripe < dg.n_padded:
            raise ValueError(
                "a flat engine (no partition_span) needs a single-stripe "
                "device graph; pass stripe_size=0 to build_ell_device (or "
                "set partition_span to run the partitioned kernel)")
        fp = dg.fingerprint()
        self.graph = dg
        n, n_padded = dg.n, dg.n_padded
        t1 = time.perf_counter()
        perm = dg.perm
        self._perm = perm.cpu().numpy()
        mass = (dg.dangling_mask if cfg.semantics == "reference"
                else dg.out_degree == 0)
        inv = torch.where(dg.out_degree > 0,
                          1.0 / dg.out_degree.to(torch.float64), 0.0)

        def relabel(a):  # per-vertex plane -> relabeled, zero-padded
            out = torch.zeros(n_padded, dtype=a.dtype, device=a.device)
            out[:n] = a[perm]
            return out

        planes = {"dangling": relabel(mass), "zero_in": relabel(
            dg.zero_in_mask), "valid": relabel(torch.ones(
                n, dtype=torch.bool, device=dev)), "inv_out": relabel(inv)}
        del inv
        rows = dg.num_rows
        ratio = rows * LANES / max(1, dg.num_edges)
        src, rbs = joined(dg.src), dg.row_block
        if not dg.presentinel:  # point the inert (weight 0) slots at it
            src = torch.where(joined(dg.weight) != 0, src, stripe)
        if part:
            rbs = rbs if isinstance(rbs, (list, tuple)) else [rbs]
            cuts = np.cumsum([r.shape[0] for r in rbs])[:-1]
            arrays, plan, layout = self._plan_partitioned(
                src, np.split(joined(rbs).cpu().numpy(), cuts),
                dg.num_blocks, part, ratio)
        else:
            arrays, plan, layout = self._plan_flat(src, joined(rbs),
                                                   dg.num_blocks, ratio)
        del src, rbs
        t2 = time.perf_counter()
        stages = {k.removesuffix("_s"): v
                  for k, v in (dg.timings or {}).items()}
        return self._place(n_padded, dg.num_blocks, planes, arrays, plan,
                           {**layout, "build": "device", "fingerprint": fp},
                           {**stages, "plan": t2 - t1}, t2)

    def _build_coo(self, graph: Graph, t0: float) -> "TorchEngine":
        """The coo form (``jax_engine.py:666-694``): the graph's
        dst-sorted edges as they are, w = 1/out-degree[src] in the rank
        dtype (``partition_edges``' ``weight_dtype``), the per-dst edge
        counts that ``edge_contrib_segment_sum`` segments by, and a
        state of n with no padding (nothing relabeled: ``perm`` is the
        identity)."""
        cfg, dev = self.config, self.device
        n = graph.n
        dt = np.float32 if self._dtype == torch.float32 else np.float64
        lengths = np.bincount(graph.dst, minlength=n).astype(np.int64)
        mass_mask = (graph.dangling_mask if cfg.semantics == "reference"
                     else graph.out_degree == 0)
        t1 = time.perf_counter()
        self._reset_graph_state()
        self._launch = None
        self._perm = np.arange(n, dtype=np.int32)
        self._n_state = n
        self._arrays = {
            "src": torch.from_numpy(graph.src.astype(np.int64)).to(dev),
            "lengths": torch.from_numpy(lengths).to(dev),
            "w": torch.from_numpy(graph.edge_weight.astype(dt)).to(dev),
        }
        self._dangling = torch.from_numpy(np.asarray(mass_mask, bool)).to(dev)
        self._zero_in = torch.from_numpy(
            np.asarray(graph.zero_in_mask, bool)).to(dev)
        self._valid = torch.ones(n, dtype=torch.bool, device=dev)
        self._r = pr_model.initial_rank(n, cfg.semantics, self._dtype, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        self.iteration = 0
        self._layout = {
            "form": "coo", "partition_span": 0, "build": "host",
            "kernel": "segment_reduce", "kernel_requested": cfg.kernel,
            "device": str(dev), "num_edges": graph.num_edges,
            "num_rows": None, "dtype": cfg.dtype,
            "accum_dtype": cfg.accum_dtype,
            "build_seconds": {"pack": t1 - t0, "place": t2 - t1},
        }
        return self

    def _place(self, n_state, num_blocks, planes, arrays, plan, layout,
               build_seconds, t2) -> "TorchEngine":
        """The shared tail of both builds: per-vertex planes, slot arrays
        and plan on the device, the z buffer, the kernel bound (cuda),
        r0, and the layout record. ``planes`` and ``arrays`` hold torch
        tensors or numpy arrays; ``t2`` is when placement began."""
        cfg, dev = self.config, self.device
        n = self.graph.n
        self._reset_graph_state()

        def put(a):
            return (a if isinstance(a, torch.Tensor)
                    else torch.from_numpy(a)).to(dev)

        self._n_state = n_state
        self._num_blocks = num_blocks
        self._dangling = put(planes["dangling"])
        self._zero_in = put(planes["zero_in"])
        self._valid = put(planes["valid"])
        self._inv_out = put(planes["inv_out"]).to(self._z_dtype)
        self._arrays = {k: put(v) for k, v in arrays.items()}
        self._plan = ell_spmv.plan_to(plan, dev)
        if cfg.partition_span:
            table = torch.bfloat16 if cfg.stream_dtype else self._z_dtype
            self._z_buf = torch.zeros((self._parts, self._window),
                                      dtype=table, device=dev)
        else:
            self._z_buf = torch.zeros(n_state + Z_PAD, dtype=self._z_dtype,
                                      device=dev)
        kernel = ("ell_contrib_partitioned" if cfg.partition_span
                  else "ell_contrib")
        launch_info = {}
        if dev.type == "cuda":
            # Bind the kernel now (building it if need be), so nvcc and
            # the input checks never land in a timed step.
            a = self._arrays
            if cfg.partition_span:
                self._launch = ell_spmv_partitioned.bind(
                    self._z_buf, a["src"], a["pair_part"], self._num_pairs,
                    plan=self._plan)
            else:
                self._launch = ell_spmv.bind(
                    self._z_buf, a["src"], num_blocks,
                    accum_dtype=self._accum, plan=self._plan)
            launch_info = {"head": self._launch.head,
                           "grid": self._launch.grid}
        self._step_cost = self._kernel_cost(plan, layout)
        # r0 over the TRUE n (1/n in textbook mode), zero in padding.
        self._r = torch.zeros(n_state, dtype=self._dtype, device=dev)
        self._r[:n] = pr_model.initial_rank(n, cfg.semantics, self._dtype,
                                            dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        self.iteration = 0
        self._layout = {
            **layout,
            "kernel": (f"{kernel}:cuda" if dev.type == "cuda"
                       else f"{kernel}:reference"),
            "kernel_requested": cfg.kernel,
            "device": str(dev),
            "group": 1,
            "num_segments": plan.num_segments,
            "seg_rows": ell_lib.SEG_ROWS,
            **launch_info,
            "dtype": cfg.dtype,
            "accum_dtype": cfg.accum_dtype,
            "z_dtype": str(self._z_buf.dtype).replace("torch.", ""),
            # Wall of the build's stages: the host build's ELL pack, or
            # the device build's relabel/sort/slots/scatter (when it was
            # timed); the per-vertex planes, sentinel repoint, pair
            # ranks, word packing and plans; and device placement (with
            # the kernel build or load on cuda).
            "build_seconds": {**build_seconds, "place": t3 - t2},
        }
        return self

    def _plan_flat(self, src, row_block, num_blocks, padding_ratio):
        """Slot arrays, segment plan and layout keys of the flat form;
        ``src`` holds the sentinel n_padded in its inert slots."""
        plan = ell_lib.segment_plan(
            row_block.cpu().numpy() if isinstance(row_block, torch.Tensor)
            else row_block, num_blocks)
        return {"src": src, "row_block": row_block}, plan, {
            "form": "flat_ell", "partition_span": 0,
            "num_rows": int(src.shape[0]), "padding_ratio": padding_ratio,
        }

    def _plan_partitioned(self, src, row_blocks, num_blocks, psz,
                          padding_ratio):
        """Slot arrays, pair plan and layout keys of the
        partition-centric form (``jax_engine.py:1486-1575, 1807-1845``):
        ``src`` is the partitions' slot rows concatenated partition-major
        with inert slots at the local sentinel ``psz`` (numpy, or a
        tensor: the 3-byte words are packed where it lies);
        ``row_blocks`` each partition's host row blocks. Each
        partition's (dst block, partition) pairs are numbered densely
        after the ones before it, with each pair's dst block (the
        expansion ids)."""
        K = len(row_blocks)
        ranks, ids, counts = [], [], []
        pair_off = 0
        for rb in row_blocks:
            rk, ids_p, pc, _ = ell_lib.dense_block_ranks(rb, num_blocks)
            ranks.append(rk + np.int32(pair_off))
            ids.append(ids_p)
            counts.append(pc)
            pair_off += pc
        words24 = self.partition_words24(psz)
        rows = int(src.shape[0])
        if words24:
            src = spmv.pack_words24(src)
        row_pair = np.concatenate(ranks)
        self._parts = K
        self._psz = psz
        # One zero row of 128 lanes after each window: the sentinel psz
        # reads it, and every window starts 128-lane aligned.
        self._window = psz + LANES
        self._num_pairs = pair_off
        arrays = {
            "src": src, "row_pair": row_pair,
            "pair_part": np.repeat(np.arange(K, dtype=np.int32), counts),
        }
        plan = ell_lib.pair_plan(row_pair, pair_off, np.concatenate(ids),
                                 num_blocks, psz)
        return arrays, plan, {
            "form": "pallas_partitioned",
            "partition_span": psz, "partitions": K,
            "window_rows": self._window // LANES, "words24": words24,
            "stream_dtype": self.config.stream_dtype or None,
            "pairs": pair_off, "slot_rows": rows, "num_rows": rows,
            "padding_ratio": padding_ratio, "n_stripes": 1,
            "stripe_span": num_blocks * LANES, "pair": False,
        }

    def _kernel_cost(self, plan, layout) -> Dict[str, float]:
        """What the form's kernel moves and computes a step (K1's or
        K2's analytic model, ``analysis/kernels.py`` ``k1_cost`` /
        ``k2_cost``, on this build's host plan): the same count whichever
        implementation runs the kernel."""
        from pagerank_tpu_torch.analysis import kernels

        rows = int(layout["num_rows"])
        num_segs = len(plan.seg_row_start) - 1
        if self.config.partition_span:
            word_bytes = LANES * (3 if layout["words24"] else 4)
            table_item = 2 if self.config.stream_dtype else \
                self._z_dtype.itemsize
            return kernels.k2_cost(
                rows, word_bytes, self._parts * self._window, table_item,
                self._num_pairs, num_segs, plan.num_blocks,
                len(plan.block_pairs), len(plan.empty_blocks))
        return kernels.k1_cost(rows, self._n_state, self._num_blocks,
                               num_segs, len(plan.empty_groups),
                               self._z_dtype.itemsize)

    def cost_reports(self) -> Dict[str, object]:
        """``{"step": CostReport}`` of the form's kernel (the run
        report's ``costs`` section, ``obs/costs.py``), or ``{}`` for the
        coo form, which runs no hand kernel."""
        from pagerank_tpu_torch.obs import costs

        if self._step_cost is None:
            return {}
        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else None)
        return {"step": costs.CostReport(
            form="step", flops=self._step_cost["flops"],
            bytes_accessed=self._step_cost["bytes"],
            num_edges=int(self.graph.num_edges), device_kind=kind,
            model=("k2_cost" if self.config.partition_span
                   else "k1_cost"))}

    def contrib_inputs(self):
        """The form's kernel inputs at the current state, z freshly
        prescaled: ``(z_ext, src, row_block, num_blocks, plan)`` for K1
        (flat form), ``(z_windows, src, row_pair, pair_part, num_pairs,
        plan)`` for K2 (partitioned form). What the step feeds the
        kernel, for callers that check it at the main path's shapes."""
        r = self._r.to(self._z_dtype)
        a = self._arrays
        if not self.config.partition_span:
            torch.mul(r, self._inv_out, out=self._z_buf[: self._n_state])
            return (self._z_buf, a["src"], a["row_block"], self._num_blocks,
                    self._plan)
        # Partition k's window holds z[k*psz : (k+1)*psz]; the last
        # partition may be short of psz, its tail stays zero. torch.mul
        # into a bf16 window rounds the f32 product to nearest even, as
        # the JAX prescale's astype does.
        psz, zw = self._psz, self._z_buf
        q, rem = divmod(self._n_state, psz)
        if q:
            torch.mul(r[: q * psz].view(q, psz),
                      self._inv_out[: q * psz].view(q, psz), out=zw[:q, :psz])
        if rem:
            torch.mul(r[q * psz:], self._inv_out[q * psz:], out=zw[q, :rem])
        return (zw, a["src"], a["row_pair"], a["pair_part"], self._num_pairs,
                self._plan)

    def _contrib(self) -> torch.Tensor:
        """contrib = Aᵀ_norm·r over the padded state, in relabeled order:
        the bound kernel on cuda, the wrapper's plain version on cpu; the
        coo form's fixed-order segment sum on either."""
        if self.config.kernel == "coo":
            a = self._arrays
            return spmv.edge_contrib_segment_sum(
                self._r, a["src"], a["lengths"], a["w"], self._accum)
        inputs = self.contrib_inputs()
        if self._launch is not None:
            return self._launch()[: self._n_state]
        if not self.config.partition_span:
            z_ext, src, rb, nb, plan = inputs
            return ell_spmv.ell_contrib(
                z_ext, src, rb, nb, accum_dtype=self._accum, plan=plan,
            )[: self._n_state]
        return ell_spmv_partitioned.ell_contrib_partitioned(
            *inputs[:5], plan=inputs[5])[: self._n_state]

    def _update(self, contrib: torch.Tensor, r: torch.Tensor):
        """The update tail of a step over ``contrib``: ``(r', delta,
        m)`` as device tensors — the one spelling shared by ``step`` and
        ``step_sdc``, so a checked step computes the same bits."""
        acc = self._accum
        m = spmv.dangling_mass(r, self._dangling, acc)
        r_new = pr_model.apply_update(
            contrib, r.to(acc), self._zero_in.to(acc), m, self.graph.n,
            self.config.damping, self.config.semantics,
        )
        r_new = (r_new * self._valid.to(acc)).to(r.dtype)
        delta = torch.sum(torch.abs(r_new.to(acc) - r.to(acc)))
        return r_new, delta, m

    def step(self) -> Dict[str, float]:
        r_new, delta, m = self._update(self._contrib(), self._r)
        self._r = r_new
        self._last_ledger = None
        return {"l1_delta": float(delta), "dangling_mass": float(m)}

    def _ledger_sums(self, contrib: torch.Tensor, r: torch.Tensor):
        """The rank-mass ledger's sums of a step (``jax_engine.py:103``)
        as device scalars in the accumulation dtype: the contribution
        total, the retained (zero in-degree) mass and the previous
        mass. The one spelling ``step_probed`` and ``step_sdc`` share."""
        acc = self._accum
        ra = r.to(acc)
        zero = torch.zeros((), dtype=acc, device=r.device)
        return [torch.sum(contrib.to(acc)),
                torch.sum(torch.where(self._zero_in, ra, zero)),
                torch.sum(ra)]

    def ledger_values(self):
        """``(mass_prev, contrib_total, retained_total)`` of the step
        just taken when it was probed or checked, else None."""
        return self._last_ledger

    # -- convergence probes (obs/probes.py) ---------------------------------

    def _resolve_probe_k(self, k: int) -> int:
        return max(1, min(int(k), self.graph.n))

    def _probe_tail(self, r: torch.Tensor, k: int, prev_ids):
        """The probe over a padded relabeled rank vector, on its device
        (``jax_engine.py:3633-3662``): the rank mass in the accumulation
        dtype, the top-k ids of the valid lanes (padding at -inf; ties
        by the lowest index, ``ops/spmv.topk_lowest_index``), how many
        of them are not in ``prev_ids``, and the top-k mass."""
        acc = self._accum
        mass = torch.sum(r.to(acc))
        rv = torch.where(self._valid, r, torch.full((), float("-inf"),
                                                    dtype=r.dtype,
                                                    device=r.device))
        vals, ids = spmv.topk_lowest_index(rv, k)
        prev = (torch.full((k,), -1, dtype=ids.dtype, device=ids.device)
                if prev_ids is None else prev_ids)
        entered = torch.sum((ids[:, None] != prev[None, :]).all(dim=1))
        topk_mass = torch.sum(torch.where(
            torch.isfinite(vals), vals, torch.zeros((), dtype=vals.dtype,
                                                    device=vals.device)
        ).to(acc))
        return mass, ids, entered, topk_mass

    def _fetch(self, scalars, ids: torch.Tensor) -> np.ndarray:
        """Scalars and the k ids to the host in ONE transfer (f64: the
        ids are exact below 2^53)."""
        f64 = torch.float64
        return torch.cat([torch.stack([v.to(f64) for v in scalars]),
                          ids.to(f64)]).cpu().numpy()

    def _original_ids(self, ids_host: np.ndarray) -> np.ndarray:
        return np.asarray(self._perm)[ids_host.astype(np.int64)]

    def probe_values(self, k: int, prev_ids):
        """The probe of the CURRENT state (``PageRankEngine.
        probe_values`` contract): one transfer."""
        k = self._resolve_probe_k(k)
        mass, ids, entered, topk_mass = self._probe_tail(self._r, k,
                                                         prev_ids)
        host = self._fetch([mass, entered, topk_mass], ids)
        ids_h = host[3:].astype(np.int64)
        return (float(host[0]), int(host[1]), ids,
                self._original_ids(ids_h), float(host[2]))

    def step_probed(self, probes):
        """One iteration with the probe: ``step()``'s contribution
        launch (K1 or K2) and update, so the ranks are the plain step's
        bits, then the probe tail and the ledger sums, and
        every scalar and the k ids reach the host in ONE transfer (the
        plain step pays two). Returns ``(info, (ids_engine,
        ids_original))``; ``info`` carries ``rank_mass``,
        ``topk_churn``, ``topk_mass`` and the ``mass_ledger`` entry."""
        k = self._resolve_probe_k(probes.topk)
        prev = probes.prev_ids
        r = self._r
        contrib = self._contrib()
        r_new, delta, m = self._update(contrib, r)
        led = self._ledger_sums(contrib, r)
        del contrib
        mass, ids, entered, topk_mass = self._probe_tail(r_new, k, prev)
        host = self._fetch([delta, m, mass, entered, topk_mass, *led], ids)
        self._r = r_new
        info = {
            "l1_delta": float(host[0]),
            "dangling_mass": float(host[1]),
            "rank_mass": float(host[2]),
            "topk_churn": 0 if prev is None else int(host[3]),
            "topk_mass": float(host[4]),
        }
        ct, rt, pv = (float(v) for v in host[5:8])
        self._last_ledger = (pv, ct, rt)
        info["ledger_contrib_total"] = ct
        info["ledger_retained_total"] = rt
        info["ledger_mass_prev"] = pv
        info["mass_ledger"] = self._ledger_entry(info)
        return info, (ids, self._original_ids(host[8:].astype(np.int64)))

    # -- silent-data-corruption checks (sdc.py) -----------------------------

    def device_ids(self):
        from pagerank_tpu_torch.parallel.mesh import device_id

        return [device_id(self.device)]

    def sdc_supported(self) -> bool:
        """Every form measures the invariants, as every single-device
        form of the JAX engine does: the flat and partitioned forms with
        the source mass, the coo form (no prescale) without it."""
        return self.graph is not None

    def retain_state(self, iteration: Optional[int] = None):
        """Device-side double buffer for the SDC redo: ``(iteration,
        rank copy)``, the copy on the engine's device."""
        it = self.iteration if iteration is None else int(iteration)
        return (it, self._r.clone())

    def restore_state(self, token) -> None:
        """Rewind to a :meth:`retain_state` token (the token stays
        reusable: a second redo restores the same bits)."""
        it, r = token[0], token[1]
        self._r = r.clone()
        self.iteration = int(it)

    def _ledger_eps(self) -> float:
        return float(torch.finfo(self._accum).eps)

    def _sdc_w(self) -> torch.Tensor:
        """The seeded Rademacher projection vector over the padded
        state, in the accumulation dtype (+-1 is exact), on the device;
        built at the first checked step — a disarmed run never makes
        it."""
        if self._sdc_w_vec is None:
            from pagerank_tpu_torch import sdc as sdc_mod

            w = sdc_mod.fingerprint_vector(self.config.sdc_seed,
                                           self._n_state)
            self._sdc_w_vec = torch.from_numpy(w).to(self._accum).to(
                self.device)
        return self._sdc_w_vec

    def _has_src(self) -> bool:
        return self.config.kernel != "coo"

    def _sdc_sums(self, r: torch.Tensor):
        """(w·r, sum r, source mass) of ``r`` in the accumulation dtype;
        the source mass (vertices with out-degree > 0) only where the
        form prescales (not coo)."""
        ra = r.to(self._accum)
        sums = [torch.sum(ra * self._sdc_w()), torch.sum(ra)]
        if self._has_src():
            sums.append(torch.sum(torch.where(
                self._inv_out != 0, ra, torch.zeros((), dtype=ra.dtype,
                                                    device=ra.device))))
        return sums

    def sdc_state_values(self):
        """The standalone boundary-state check over the current state:
        ``fp``, ``mass``, ``src`` as one-device arrays (one transfer)."""
        host = torch.stack(self._sdc_sums(self._r)).cpu().numpy()
        return {"fp": host[0:1], "mass": host[1:2],
                "src": host[2:3] if self._has_src() else None}

    def step_sdc(self):
        """One SDC-checked iteration: ``(info, check record)``. The
        contribution launch and the update are ``step()``'s; the check
        tail's sums (the ledger's contribution, retained and previous
        totals, then w·r, mass and source mass of the input and w·r and
        mass of the output) come to the host in one transfer. Never
        called when SDC checking is off."""
        r = self._r
        contrib = self._contrib()
        r_new, delta, m = self._update(contrib, r)
        ins = self._sdc_sums(r)
        outs = self._sdc_sums(r_new)[:2]
        vals = [delta, m, *self._ledger_sums(contrib, r), *ins, *outs]
        host = torch.stack(vals).cpu().numpy()
        self._r = r_new
        self._last_ledger = (float(host[4]), float(host[2]), float(host[3]))
        chk = {
            "sharded": False,
            "fp_in": host[5:6], "mass_in": host[6:7],
            "src_in": host[7:8] if self._has_src() else None,
            "fp_out": host[-2:-1], "mass_out": host[-1:],
            "contrib": host[2:3], "retained": host[3:4],
            "mass_prev": host[4:5],
            "dangling_mass": float(host[1]),
            "stale_slack": 0.0,
        }
        info = {"l1_delta": float(host[0]), "dangling_mass": float(host[1]),
                "rank_mass": float(host[-1])}
        return info, chk

    # -- the async writer's payload -----------------------------------------

    def device_ranks(self):
        """The rank vector as a payload for the async writer
        (``utils/snapshot.AsyncRankWriter``), decoded by
        :meth:`decode_ranks` on its worker thread. On a card: queued on
        a side stream that first waits for the compute stream's work so
        far, the in-degree relabel undone on the device (a scatter
        through ``perm``) and the result copied into a pinned host
        buffer, with an event the worker waits on; ``record_stream``
        keeps the rank tensor's memory until the side stream has read
        it, and the steps queued after it overlap the work. The pinned
        buffers come from a pool of this engine's own, which holds as
        many as are in flight (the writer's ``max_pending`` bounds
        them): a fresh pinned allocation a payload slowed the steps
        beside it (``cudaHostAlloc`` on the main thread). On the CPU:
        the tensor itself (a step rebinds the rank vector, it never
        writes it in place)."""
        r = self._r
        if r.device.type != "cuda":
            return r
        n = self.graph.n
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=r.device)
            self._perm_dev = torch.from_numpy(
                np.ascontiguousarray(self._perm, dtype=np.int64)).to(r.device)
        side = self._copy_stream
        try:
            host = self._pinned.popleft()
        except IndexError:
            host = torch.empty(n, dtype=r.dtype, pin_memory=True)
        side.wait_stream(torch.cuda.current_stream(r.device))
        with torch.cuda.stream(side):
            orig = torch.empty(n, dtype=r.dtype, device=r.device)
            orig[self._perm_dev] = r[:n]
            host.copy_(orig, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        r.record_stream(side)
        return _PinnedRanks(host, done, self._pinned)

    def rank_mass(self) -> float:
        """sum(ranks) by one device reduction; padding lanes are zero."""
        return float(torch.sum(self._r.to(self._accum)))

    def ranks(self) -> np.ndarray:
        return self.decode_ranks(self._r)

    def decode_ranks(self, padded) -> np.ndarray:
        """A padded relabeled rank vector (a tensor, or a
        :meth:`device_ranks` payload) on the host with the in-degree
        relabel undone. A pinned payload (relabeled on the device) is
        waited on, its copy's event, copied out of its buffer and the
        buffer returned to the pool."""
        if isinstance(padded, _PinnedRanks):
            return padded.decode()
        r = padded.detach().cpu().numpy()[: self.graph.n]
        out = np.empty(self.graph.n, dtype=r.dtype)
        out[self._perm] = r
        return out

    def set_ranks(self, r: np.ndarray, iteration: int = 0) -> None:
        if r.shape != (self.graph.n,):
            raise ValueError(f"rank shape {r.shape} != ({self.graph.n},)")
        dt = np.float32 if self._dtype == torch.float32 else np.float64
        rr = np.zeros(self._n_state, dtype=dt)
        rr[: self.graph.n] = np.asarray(r, dtype=dt)[self._perm]
        self._r = torch.from_numpy(rr).to(self.device)
        self.iteration = iteration

    def layout_info(self) -> Dict[str, object]:
        """The resolved layout of this build: what actually runs."""
        return dict(self._layout)

    def snapshot_meta(self) -> Dict[str, object]:
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return {"engine": self.name, "num_devices": 1, "device": name,
                "form": self._layout.get("form"),
                "partition_span": self._layout.get("partition_span", 0)}


class _PinnedRanks:
    """A rank vector on its way to the host, in original id order: the
    pinned buffer, the event of the side-stream copy into it, and the
    pool the buffer goes back to once read."""

    def __init__(self, host: torch.Tensor, done, pool):
        self.host = host
        self.done = done
        self._pool = pool

    def decode(self) -> np.ndarray:
        self.done.synchronize()
        out = self.host.numpy().copy()
        self._pool.append(self.host)
        return out
