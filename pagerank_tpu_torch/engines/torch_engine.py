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

More than one device (``config.num_devices`` > 1 or ``vertex_sharded``;
a ``parallel/mesh.Mesh`` over a ``torch.distributed`` group, one process
a rank, every rank running this same code on its own rows):

    edge-sharded (replicated; jax_engine.py:1146-1161, :1289-1305,
    :1855-1873): the slot rows padded to a multiple of world x
    CHUNK_ROWS with inert rows and split in contiguous shares; each rank
    runs K1 (flat) or K2 (partitioned) over its share with the full z,
    then ``psum`` merges the [num_blocks·128] sums; the update runs on
    every rank, the same on each.
    vertex-sharded (jax_engine.py:2075-2357): the state padded to
    n_vs = ⌈n_state / (128·world)⌉·128·world (padding inert: valid 0,
    inv 0) and held in contiguous vertex blocks; per step
                  z_l = r_l·inv_l, z = all_gather(z_l),
                  K1 over this rank's rows,
                  contrib_l = psum_scatter(sums),
                  the update on the block, m and delta as psum'd partials.
    vs_halo (``halo_exchange``; jax_engine.py:2358-2637): the same rows
    and state, the exchange cut to the build-time halo plan
    (``parallel/partition.build_halo_plan`` over the whole padded
    table); per step
                  z_l = r_l·inv_l,
                  image[0:K] = psum(this rank's masked share of the head),
                  image[recv ids] = ppermute(z_l[send idx]) a read round,
                  image[own block] = z_l (written last),
                  K1 over this rank's rows (it reads only the positions
                  the plan filled, so its sums are the dense form's bits),
                  contrib_l = own block of the sums + the write windows
                  other ranks ppermute here, one a write round,
                  then the dense form's update.
    vs_halo_async (``halo_async``; jax_engine.py:2639-2860): vs_halo
    with a two-slot boundary buffer: step k starts shipping its head and
    read rounds into one slot (asynchronous collectives), builds the
    image from the other (step k-1's boundary) with its own block fresh,
    runs K1 and the synchronous write merge, then waits on the ship and
    swaps the slots. The buffer is primed from the ranks at build and
    at every state replacement, so the step after one is vs_halo's.
    vs_bounded (``vs_bounded``; jax_engine.py:2952-3330): the pack's dst
    blocks dealt over the ranks' ranges (``ops/ell.deal_block_order``);
    each rank holds only the rows of its own range, renumbered to local
    blocks, padded with inert rows writing one trash block; per step
                  z = all_gather(z_l), K1 into this rank's [nbd + 1, 128]
                  sums, contrib_l = their first nbd blocks (no merge),
                  then the dense form's update.
    The JAX form builds each stripe's z plane as a psum of the ranks'
    disjoint zero-extended slices (jax_engine.py:3143); each element has
    one nonzero contributor, so the all_gather of z gives the same bits
    at half the bytes, and vs_bounded gathers z as the dense form does.

The sharded forms keep the single-device forms' ledger and SDC cores
(``step_sdc``; the per-rank check values gathered to every rank, so that
each reaches the same verdict), and ``ranks``/``set_ranks`` cross world
sizes through the canonical host-order vector. The dense form and
vs_halo (both forms) time their exchange apart from the step
(``time_exchange_split``, read by ``obs/devices.attribute_exchange``).

On ``cuda`` the kernels are the hand-written ones, bound once at build
(``ell_spmv.bind``: inputs, plan and workspace checked once, so a step
pays one ctypes call); on ``cpu`` the wrappers run their plain
versions. There is no fallback between the two: a CUDA engine launches
the kernel or raises. The kernels, z and the windows stay in device
memory (the TPU forms' VMEM limits have no counterpart here).

The fused run forms (``jax_engine.py:4204-4447``: ``run_fast``,
``run_fused``, ``run_fused_chunked``, ``run_fused_tol``,
``prepare_fused``) queue steps with no host sync between them: each is
``_device_step()``, the step's launch and update with its ``l1_delta``
and dangling mass left on the device (``step()`` is that plus the two
fetches). Where JAX runs one ``lax.scan`` or ``lax.while_loop``
dispatch, the port queues the same steps on the stream: the host syncs
only at a chunk boundary that reads a value, and at the end. The tol
form masks the steps after its stop (each keeps the state the stop
left) and reads its stop flag once a chunk of ``FUSED_TOL_CHUNK`` steps.
No CUDA graph is captured: these forms port the semantics; capture is
speed work.
"""

from __future__ import annotations

import collections
import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from pagerank_tpu_torch import graph as graph_mod
from pagerank_tpu_torch.engine import PageRankEngine, register_engine
from pagerank_tpu_torch.graph import Graph
from pagerank_tpu_torch.models import pagerank as pr_model
from pagerank_tpu_torch.obs import live as obs_live
from pagerank_tpu_torch.ops import LANES
from pagerank_tpu_torch.ops import ell as ell_lib
from pagerank_tpu_torch.ops import ell_spmv, ell_spmv_partitioned
from pagerank_tpu_torch.ops import spmv
from pagerank_tpu_torch.parallel import distributed
from pagerank_tpu_torch.parallel import mesh as mesh_lib
from pagerank_tpu_torch.utils.config import torch_dtype

#: Zero lanes appended to z: the sentinel index n_state reads one.
Z_PAD = 8
#: Slot rows of the JAX pallas forms' chunk: the sharded forms pad the
#: table to a multiple of world x CHUNK_ROWS rows (jax_engine.py:1146),
#: so each rank's share is the one the JAX engine gives that device.
CHUNK_ROWS = 256


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
    # Steps ``run_fused_tol`` queues between two reads of its stop flag:
    # a run wastes at most FUSED_TOL_CHUNK - 1 masked steps past its stop
    # and pays one host sync a chunk.
    FUSED_TOL_CHUNK = 8

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

    def __init__(self, config=None, device=None, mesh=None):
        super().__init__(config)
        cfg = self.config
        dev = resolve_device(device)
        # A mesh for the vertex-sharded form at any size, and for more
        # than one device: num_devices, else the group's world size (an
        # explicit num_devices=1 builds the one-device form in a group).
        ndev = (cfg.num_devices if cfg.num_devices is not None
                else distributed.process_info()[1])
        if mesh is None and (cfg.vertex_sharded or ndev > 1):
            mesh = mesh_lib.make_mesh(cfg.num_devices, cfg.mesh_axis,
                                      device=dev)
        if mesh is not None:
            if mesh.device.type != dev.type:
                raise ValueError(f"the mesh is on {mesh.device}, the engine "
                                 f"on {dev}")
            dev = mesh.device
        #: The mesh of a sharded engine (parallel/mesh.Mesh), None for
        #: the single-device forms.
        self.mesh = mesh
        self._world = mesh.world if mesh is not None else 1
        self._vs = bool(cfg.vertex_sharded)
        self.device = dev
        self._dtype = torch_dtype(self.config.dtype)
        self._accum = torch_dtype(self.config.accum_dtype)
        # z rides in accum when that is wider than the rank dtype, so
        # the per-edge products carry accum precision into the sum.
        self._z_dtype = (self._accum if self._accum.itemsize
                         > self._dtype.itemsize else self._dtype)
        self._layout: Dict[str, object] = {}
        self._perm: Optional[np.ndarray] = None
        self._launch: Optional[ell_spmv.Launcher] = None
        self._device_edges: Optional[np.ndarray] = None
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
        self._comms_model = None
        self._comms_counter = None
        self._comms_bytes_per_iter = 0
        # The vertex-sharded form of this build (None off the mesh
        # forms), the async form's boundary slots (None on every other
        # form), the previous step's L1 delta (the async form's
        # staleness slack; 0 after a build or a state replacement) and
        # the zero contribution of the exchange timing (made at first
        # use).
        self._vs_form = None
        self._vs_layout: Dict[str, object] = {}
        self._halo_plan = None
        self._carry = None
        self._last_step_delta = 0.0
        self._exchange_zero = None
        # Per-step traces of the latest fused run, on the device; empty
        # until one runs (kept across no-op repeat calls).
        empty = torch.zeros(0, dtype=self._accum, device=self.device)
        self.last_run_metrics = {"l1_delta": empty,
                                 "dangling_mass": empty.clone()}

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
        elif self._vs and cfg.vs_bounded:
            # Dst blocks dealt over the ranks' ranges (jax_engine.py:
            # 601-630); at one rank there is nothing to deal.
            pack = ell_lib.ell_pack(graph, block_deal=self._world)
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
        halo = None
        num_blocks = pack.num_blocks
        if cfg.partition_span:
            srcs = [np.where(pack.weight[p] != 0, pack.src[p], np.int32(psz))
                    for p in range(pack.n_stripes)]
            src = np.concatenate(srcs)
            del srcs
            arrays, plan, layout = self._plan_partitioned(
                src, pack.row_block, pack.num_blocks, psz, pack.padding_ratio)
        else:
            src = ell_lib.sentinel_slots(pack)
            if self._vs and cfg.vs_bounded:
                src, rb, num_blocks = self._bounded_rows(
                    src, pack.row_block, pack.n_padded)
            elif self._vs and cfg.halo_exchange:
                src, rb = self._pad_rows(src, pack.row_block, pack.n_padded,
                                         pack.num_blocks - 1)
                halo = self._plan_halo(src, rb, pack.n_padded,
                                       pack.num_rows, pack.num_blocks)
                src, rb = self._take_share(src, rb)
            else:
                src, rb = self._shard_rows(src, pack.row_block, pack.n_padded,
                                           pack.num_blocks - 1)
            arrays, plan, layout = self._plan_flat(
                src, rb, num_blocks, pack.padding_ratio)
            del src, rb
        t2 = time.perf_counter()
        return self._place(pack.n_padded, num_blocks, planes, arrays,
                           plan, {**layout, "build": "host"},
                           {"pack": t1 - t0, "plan": t2 - t1}, t2,
                           halo=halo)

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
        drops the graph.

        Over a mesh every rank built the same graph on its own device
        (the same seed or the same uploaded edges: deterministic
        integer work); the ranks first agree on it (an ``all_gather``
        of the fingerprints; a mismatch raises), then each keeps its
        share as :meth:`build` slices a host pack: its range of the
        padded slot rows (a copy), and on the vs_halo forms the halo
        plan of the whole table, whose slot plane alone crosses to the
        host for it."""
        from pagerank_tpu_torch.ops.device_build import (DeviceEllGraph,
                                                         joined)

        if not isinstance(dg, DeviceEllGraph):
            raise TypeError(f"build_device needs a DeviceEllGraph, got "
                            f"{type(dg).__name__}")
        if self.config.vs_bounded:
            raise ValueError(
                "vs_bounded requires a host-built graph (build(), not "
                "build_device: the device build does not deal dst "
                "blocks across device ranges)"
            )
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
        self._agree_fingerprint(fp)
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
        halo = None
        if part:
            rbs = rbs if isinstance(rbs, (list, tuple)) else [rbs]
            cuts = np.cumsum([r.shape[0] for r in rbs])[:-1]
            arrays, plan, layout = self._plan_partitioned(
                src, np.split(joined(rbs).cpu().numpy(), cuts),
                dg.num_blocks, part, ratio)
        else:
            rb = joined(rbs)
            if self._vs and cfg.halo_exchange:
                src, rb = self._pad_rows(src, rb, n_padded,
                                         dg.num_blocks - 1)
                halo = self._plan_halo(src, rb, n_padded, rows,
                                       dg.num_blocks)
                src, rb = self._take_share(src, rb)
            else:
                src, rb = self._shard_rows(src, rb, n_padded,
                                           dg.num_blocks - 1)
            arrays, plan, layout = self._plan_flat(src, rb, dg.num_blocks,
                                                   ratio)
            del rb
        del src, rbs
        t2 = time.perf_counter()
        stages = {k.removesuffix("_s"): v
                  for k, v in (dg.timings or {}).items()}
        return self._place(n_padded, dg.num_blocks, planes, arrays, plan,
                           {**layout, "build": "device", "fingerprint": fp},
                           {**stages, "plan": t2 - t1}, t2, halo=halo)

    def _agree_fingerprint(self, fp: str) -> None:
        """Over a mesh of more than one rank: every rank's device graph
        fingerprint, gathered (one ``all_gather``); raises unless all
        are ``fp``, so that no rank runs on another graph than its
        peers'."""
        if self.mesh is None or not self.mesh.collective:
            return
        # The fingerprint's 48 bits, exact in f64 (a dtype every
        # backend gathers on a card).
        mine = torch.tensor([float(int(fp.removeprefix("dev-"), 16))],
                            dtype=torch.float64, device=self.device)
        every = torch.empty(self._world, dtype=torch.float64,
                            device=self.device)
        got = [int(g) for g in
               mesh_lib.all_gather(self.mesh, every, mine).cpu().tolist()]
        if len(set(got)) != 1:
            raise ValueError(
                f"the ranks built different device graphs (fingerprints "
                f"{['dev-%012x' % g for g in got]} by rank): build every "
                f"rank's graph from the same seed or the same edges on one "
                f"device type")

    def _build_coo(self, graph: Graph, t0: float) -> "TorchEngine":
        """The coo form (``jax_engine.py:666-694``): the graph's
        dst-sorted edges as they are, w = 1/out-degree[src] in the rank
        dtype (``partition_edges``' ``weight_dtype``), the per-dst edge
        counts that ``edge_contrib_segment_sum`` segments by, and a
        state of n with no padding (nothing relabeled: ``perm`` is the
        identity). Over a mesh the form is edge-sharded
        (``jax_engine.py:672-694``): ``parallel/partition.
        partition_edges`` cuts the edges into equal contiguous chunks
        (the tail padded with inert edges, w = 0), each rank sums its
        chunk and one ``psum`` of the [n] sums follows."""
        from pagerank_tpu_torch.parallel.partition import partition_edges

        cfg, dev = self.config, self.device
        n = graph.n
        dt = np.float32 if self._dtype == torch.float32 else np.float64
        src, dst, w = graph.src, graph.dst, graph.edge_weight.astype(dt)
        if self._world > 1:
            shards = partition_edges(graph, self._world, weight_dtype=dt)
            sl = mesh_lib.edge_sharding(self.mesh, shards.src.shape[0])
            src, dst, w = shards.src[sl], shards.dst[sl], shards.weight[sl]
        lengths = np.bincount(dst, minlength=n).astype(np.int64)
        mass_mask = (graph.dangling_mask if cfg.semantics == "reference"
                     else graph.out_degree == 0)
        t1 = time.perf_counter()
        self._reset_graph_state()
        self._launch = None
        self._perm = np.arange(n, dtype=np.int32)
        self._n_state = n
        self._arrays = {
            "src": torch.from_numpy(src.astype(np.int64)).to(dev),
            "lengths": torch.from_numpy(lengths).to(dev),
            "w": torch.from_numpy(np.ascontiguousarray(w)).to(dev),
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
        mesh_info = {}
        if self.mesh is not None:
            mesh_info = {"world": self._world, "rank": self.mesh.rank,
                         "backend": self.mesh.backend,
                         "vertex_sharded": False,
                         "edges_per_rank": int(src.shape[0])}
        self._layout = {
            "form": "coo", "partition_span": 0, "build": "host",
            **mesh_info,
            "kernel": "segment_reduce", "kernel_requested": cfg.kernel,
            "device": str(dev), "num_edges": graph.num_edges,
            "num_rows": None, "dtype": cfg.dtype,
            "accum_dtype": cfg.accum_dtype,
            "build_seconds": {"pack": t1 - t0, "place": t2 - t1},
        }
        return self

    def _shard_rows(self, src, row_ids, sentinel, fill_id):
        """This rank's slot rows of the whole table (host arrays):
        :meth:`_pad_rows`, then :meth:`_take_share`. Segment plans cut a
        share's rows from its first row, so a share may start inside a
        block."""
        return self._take_share(*self._pad_rows(src, row_ids, sentinel,
                                                fill_id))

    def _pad_rows(self, src, row_ids, sentinel, fill_id):
        """The whole table as the ranks share it, and each rank's count
        of real (non-sentinel) slots, kept for :meth:`device_edges`. One
        device takes the table as it is. Over a mesh the rows are padded
        with inert rows (every slot ``sentinel``, group id ``fill_id``:
        the last group's, so the ids stay ascending) to a multiple of
        world x CHUNK_ROWS (``jax_engine.py:1146-1161``). Each array is
        numpy or a tensor (a device build's planes), padded where it
        lies."""
        rows = int(src.shape[0])
        self._device_edges = None
        if self._world == 1 or rows == 0:
            return src, row_ids
        w = self._world
        mult = w * CHUNK_ROWS
        pad = -(-rows // mult) * mult - rows

        def padded(a, shape, fill):
            if isinstance(a, torch.Tensor):
                return torch.cat([a, a.new_full(shape, fill)])
            return np.concatenate([a, np.full(shape, fill, a.dtype)])

        src = padded(src, (pad, LANES), sentinel)
        row_ids = padded(row_ids, (pad,), fill_id)
        per = src.shape[0] // w
        self._device_edges = np.array(
            [int((src[r * per:(r + 1) * per] != sentinel).sum())
             for r in range(w)], np.int64)
        return src, row_ids

    def _take_share(self, src, row_ids):
        """This rank's contiguous share of a padded table
        (``mesh.edge_sharding``), a copy (a tensor's share keeps no
        reference to the whole table); one device's is the whole
        table."""
        if self._world == 1 or src.shape[0] == 0:
            return src, row_ids
        sl = mesh_lib.edge_sharding(self.mesh, src.shape[0])

        def share(a):
            if isinstance(a, torch.Tensor):
                return a[sl].clone()
            return np.ascontiguousarray(a[sl])

        return share(src), share(row_ids)

    def _vs_geometry(self, n_state):
        """(n_vs, blk): the vertex-sharded state length, n_state padded
        to a multiple of 128·world, and a rank's block of it."""
        unit = LANES * self._world
        n_vs = -(-n_state // unit) * unit
        return n_vs, n_vs // self._world

    def _plan_halo(self, src, row_ids, n_padded, real, num_blocks):
        """The halo plan of the whole padded table (``jax_engine.py:
        2429-2443``) of ``real`` slot rows before the padding: the
        port's flat pack is one stripe at lane group 1 with the
        sentinel ``n_padded`` in its inert slots, so the plan's slot
        decode reads its words as they are (a device build's table is
        read on the host for it). The padding rows' group ids go to
        ``build_halo_plan`` as the last real row's block (the JAX
        pack's dense rank ``pcount - 1``, ``jax_engine.py:1156``): a
        padding row sums to zero, so a rank's write band is the hull of
        its real rows'. Every rank builds the same plan."""
        from pagerank_tpu_torch.parallel.partition import build_halo_plan

        def host(a):
            return (a.cpu().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a))

        n_vs, _ = self._vs_geometry(n_padded)
        rb = np.array(host(row_ids), copy=True)
        if real:
            rb[real:] = rb[real - 1]
        ranks, ids, _, _ = ell_lib.dense_block_ranks(rb, num_blocks)
        item = self._z_dtype.itemsize
        return build_halo_plan(
            [host(src)], [ranks], [ids], ndev=self._world, n_vs=n_vs,
            sz=n_padded, group=1, head_k=self.config.halo_head,
            z_item=item, accum_item=self._accum.itemsize, rs_merge=True)

    def _bounded_rows(self, src, row_ids, n_padded):
        """This rank's rows of the dealt table (``jax_engine.py:
        3027-3101``): the rows whose dst block lies in its range of
        ``nbd`` blocks (one contiguous run: ids ascend), renumbered to
        local blocks, then padded with inert rows (every slot the
        sentinel ``n_padded``) to the most any rank holds, rounded up to
        CHUNK_ROWS, as the JAX form pads every device to one row count.
        The padding rows write local block ``nbd``, a trash block past
        the range, so a real block's sums keep their rows. Returns
        ``(src, row_block, nbd + 1)``; each rank's real slots are kept
        for :meth:`device_edges`."""
        _, blk = self._vs_geometry(n_padded)
        nbd = blk // LANES
        me = self.mesh.rank
        cuts = np.searchsorted(row_ids, np.arange(self._world + 1) * nbd)
        counts = np.diff(cuts)
        rows_pad = -(-int(counts.max()) // CHUNK_ROWS) * CHUNK_ROWS
        self._device_edges = None if self._world == 1 else np.array(
            [np.count_nonzero(src[cuts[d]:cuts[d + 1]] != n_padded)
             for d in range(self._world)], np.int64)
        lo, hi = int(cuts[me]), int(cuts[me + 1])
        pad = rows_pad - (hi - lo)
        src = np.concatenate([src[lo:hi], np.full((pad, LANES), n_padded,
                                                  src.dtype)])
        rb = np.concatenate([row_ids[lo:hi] - np.int32(me * nbd),
                             np.full(pad, nbd, np.int32)]).astype(np.int32)
        return src, rb, nbd + 1

    def device_edges(self):
        """Each rank's real slots (deduplicated edges) in its share of
        the slot rows (``parallel/comms.measured_device_edges``), or
        None for one device and the coo form."""
        return (None if self._device_edges is None
                else self._device_edges.copy())

    def _place_vs_state(self, n_state, planes):
        """The vertex-sharded state geometry (``jax_engine.py:2075-2108,
        2176-2263``): ``n_vs`` = n_state padded to a multiple of
        128·world and this rank's block of ``n_vs / world`` vertices;
        returns this rank's block of each per-vertex plane (numpy, or a
        tensor where it lies), the padding inert (valid 0, inv 0)."""
        self._n_vs, self._blk = self._vs_geometry(n_state)
        sl = mesh_lib.vertex_sharding(self.mesh, self._n_vs)
        self._vs_slice = sl
        padv = self._n_vs - n_state

        def block(a):
            if isinstance(a, torch.Tensor):
                return torch.cat([a, a.new_zeros(padv)])[sl].clone()
            a = np.asarray(a)
            return np.ascontiguousarray(
                np.concatenate([a, np.zeros(padv, a.dtype)])[sl])

        return {k: block(v) for k, v in planes.items()}

    def _set_comms_model(self, model) -> None:
        """Adopt a per-iteration comms model (``jax_engine.py:3453``):
        publish its gauges and keep the per-step counter feed."""
        from pagerank_tpu_torch.parallel import comms

        self._comms_model = model
        self._comms_bytes_per_iter = int(model.get("bytes_per_iter") or 0)
        self._comms_counter = comms.register(model)

    def comms_model(self):
        """The per-iteration exchange byte model of this build: the
        dense form's all_gather + reduce-scatter
        (``parallel/comms.model_dense``), vs_halo's plan
        (``model_sparse``), vs_halo_async's (``model_async``); None for
        a form with no modelled exchange (one device, edge-sharded, and
        vs_bounded, as in the JAX engine)."""
        return dict(self._comms_model) if self._comms_model else None

    def _setup_halo(self, plan) -> int:
        """The vs_halo forms at this rank (``jax_engine.py:2445-2501,
        2686-2697``): the async gate, the comms model, this rank's rows
        of the plan's tables on the device, the head's clipped index and
        mask, each round's receive buffer and, for vs_halo_async, the
        two boundary slots of width K + the read widths. A round holds
        its message tag (1.. over the read rounds, then the write
        rounds), its (source, target) pairs, its width and whether this
        rank receives; a read round this rank's send indices into z_le
        (``send``), the global ids its payload lands on (``land``) and
        its offset in a boundary slot; a write round the flat start of
        this rank's window (``start``) and where a received window lands
        in its block (``land``). Returns the widest write window (the
        trash band past a block)."""

        from pagerank_tpu_torch.parallel import comms

        cfg, dev, me = self.config, self.device, self.mesh.rank
        blk, z = self._blk, self._z_dtype
        use_async = cfg.halo_async and self._halo_async_gate(plan)
        self._vs_form = "vs_halo_async" if use_async else "vs_halo"
        self._set_comms_model(comms.model_async(plan) if use_async
                              else comms.model_sparse(plan))
        self._halo_plan = plan
        K = self._halo_k = plan.head_k
        # This rank's share of the head [0, K): the JAX form's clipped
        # gather and mask (jnp.clip(pos, 0, blk), jax_engine.py:2704);
        # the clip keeps every index in [0, blk] — a negative index
        # would wrap in torch.
        pos = np.arange(K, dtype=np.int64) - me * blk
        self._head_idx = torch.from_numpy(np.clip(pos, 0, blk)).to(dev)
        self._head_mask = torch.from_numpy((pos >= 0) & (pos < blk)).to(dev)

        def put(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        self._halo_reads, off = [], K
        for i, (rnd, si, gi) in enumerate(zip(plan.read_rounds, plan.send_idx,
                                              plan.recv_ids)):
            self._halo_reads.append(SimpleNamespace(
                tag=1 + i, perm=rnd.perm, width=rnd.width,
                receives=any(t == me for _, t in rnd.perm),
                send=put(si[me]), land=put(gi[me]), offset=off,
                recv=torch.zeros(rnd.width, dtype=z, device=dev)))
            off += rnd.width
        nr = len(plan.read_rounds)
        self._halo_writes = [
            SimpleNamespace(
                tag=1 + nr + j, perm=rnd.perm, width=rnd.width,
                receives=any(t == me for _, t in rnd.perm),
                start=int(ws[me]), land=int(wr[me]),
                recv=torch.zeros(rnd.width, dtype=z, device=dev))
            for j, (rnd, ws, wr) in enumerate(zip(
                plan.write_rounds, plan.wsend_start, plan.wrecv_start))]
        wmax = max((r.width for r in plan.write_rounds), default=0)
        self._wbuf = torch.zeros(blk + wmax, dtype=z, device=dev)
        self._vs_layout = {"halo": plan.summary(), **self._vs_layout}
        if use_async:
            self._carry = [torch.zeros(off, dtype=z, device=dev)
                           for _ in range(2)]
            self._vs_layout.update(halo_async=f"on:lag{cfg.stale_max_lag}",
                                   halo_buffer_width=off)
        if me == 0:
            from pagerank_tpu_torch.obs import log as obs_log

            obs_log.info(
                f"sparse boundary exchange ({self._vs_form}): head K={K}, "
                f"{nr} read + {len(plan.write_rounds)} write round(s), "
                f"model {plan.sparse_bytes_per_iter():,} vs dense "
                f"{plan.dense_bytes_per_iter():,} B/rank/iter")
        return wmax

    def _halo_async_gate(self, plan) -> bool:
        """The async form's gate (``jax_engine.py:2445-2480``): refused
        (recorded as ``layout_info()["halo_async"]`` = ``off:<reason>``)
        at ``stale_max_lag`` 0 (exactness: the synchronous form, an info
        line), on one device, on a plan with no boundary, and under a
        predicted overlap gain below ``halo_async_min_gain``. Every rank
        takes rank 0's predicted gain, so that all decide alike (the
        gain reads this process's ``comms.exchange_fraction`` gauge)."""
        from pagerank_tpu_torch.obs import log as obs_log
        from pagerank_tpu_torch.parallel import comms

        cfg, me = self.config, self.mesh.rank
        gain = comms.predict_overlap_gain(plan)
        if self.mesh.collective:
            g = torch.tensor([gain if me == 0 else 0.0],
                             dtype=torch.float64, device=self.device)
            gain = float(mesh_lib.psum(self.mesh, g)[0])
        comms.publish_overlap_gain(gain)
        note = None
        if cfg.stale_max_lag == 0:
            note = "stale_max_lag=0"
            if me == 0:
                obs_log.info("halo_async with stale_max_lag=0: running the "
                             "synchronous sparse exchange (exact, "
                             "unbuffered)")
        elif self._world < 2:
            note = "single_device"
        elif not plan.overlappable_bytes_per_iter():
            note = "no_boundary"
        elif gain < cfg.halo_async_min_gain:
            note = f"gain {gain:.4f} < {cfg.halo_async_min_gain:g}"
        if note and note != "stale_max_lag=0" and me == 0:
            obs_log.warn(f"halo_async downgraded to the synchronous sparse "
                         f"exchange ({note})")
        if note:
            self._vs_layout = {"halo_async": f"off:{note}"}
        return note is None

    def _head_share(self, z_le, out) -> None:
        """This rank's masked share of the head [0, K) into ``out``."""
        torch.where(self._head_mask, z_le[self._head_idx],
                    torch.zeros((), dtype=z_le.dtype, device=z_le.device),
                    out=out)

    def _halo_image(self, z_le) -> None:
        """vs_halo's z image in ``z_buf`` (``jax_engine.py:2504-2538``):
        the head psum'd into [0, K), each read round's payload at its
        global ids, then this rank's own block, written last. A position
        the plan never fills keeps its zero, and every filled one is
        rewritten each step, so the image is built in place."""
        z, K = self._z_buf, self._halo_k
        if K:
            self._head_share(z_le, z[:K])
            mesh_lib.psum(self.mesh, z[:K])
        for rnd in self._halo_reads:
            recv = mesh_lib.ppermute(self.mesh, rnd.recv, z_le[rnd.send],
                                     rnd.perm, tag=rnd.tag)
            if rnd.receives:
                z[rnd.land] = recv
        z[self._vs_slice].copy_(self._z_local)

    def _ship_boundary(self, z_le, slot):
        """vs_halo_async's ship (``jax_engine.py:2694-2714``): the head
        psum and each read round into ``slot`` ([K | round 1 | ...]),
        started asynchronously; returns their pending handles."""
        K = self._halo_k
        pending = []
        if K:
            self._head_share(z_le, slot[:K])
            pending.append(mesh_lib.psum(self.mesh, slot[:K], async_op=True))
        for rnd in self._halo_reads:
            pending.append(mesh_lib.ppermute(
                self.mesh, slot[rnd.offset:rnd.offset + rnd.width],
                z_le[rnd.send], rnd.perm, tag=rnd.tag, async_op=True))
        return pending

    def _stale_image(self, slot) -> None:
        """vs_halo_async's z image from a boundary slot (``jax_engine.py:
        2716-2741``): the slot's head and landings, then this rank's own
        block, fresh, written last."""
        z, K = self._z_buf, self._halo_k
        if K:
            z[:K] = slot[:K]
        for rnd in self._halo_reads:
            if rnd.receives:
                z[rnd.land] = slot[rnd.offset:rnd.offset + rnd.width]
        z[self._vs_slice].copy_(self._z_local)

    def _halo_merge(self, flat) -> torch.Tensor:
        """vs_halo's merge (``jax_engine.py:2540-2563``): this rank's own
        block of the sums plus the windows other ranks send it, one a
        write round. A window reaching past the owner's block lands in
        the trash band [blk, blk + wmax) of the buffer; the next owner
        gets those sums in its own round, so each arrives once."""
        me, blk = self.mesh.rank, self._blk
        own = flat[me * blk:(me + 1) * blk]
        if not self._halo_writes:
            return self._contrib_l.copy_(own)
        buf = self._wbuf
        buf.zero_()
        for rnd in self._halo_writes:
            recv = mesh_lib.ppermute(self.mesh, rnd.recv,
                                     flat[rnd.start:rnd.start + rnd.width],
                                     rnd.perm, tag=rnd.tag)
            if rnd.receives:
                buf[rnd.land:rnd.land + rnd.width] += recv
        return torch.add(own, buf[:blk], out=self._contrib_l)

    def _prime_carry(self) -> None:
        """(Re)fill the async form's current boundary slot from the
        current ranks (``jax_engine.py:4546``): at build and after every
        state replacement, so the next step reads a lag-0 boundary and
        is vs_halo's step. A no-op on every other form."""
        self._last_step_delta = 0.0
        if self._carry is None:
            return
        self._prescale()
        for p in self._ship_boundary(self._z_le, self._carry[0]):
            p.wait()

    def _prescale(self) -> None:
        """z_l = r_l·inv_l into this rank's block (vertex-sharded)."""
        torch.mul(self._r.to(self._z_dtype), self._inv_out,
                  out=self._z_local)

    def _vs_gather(self, ship=None) -> None:
        """K1's z for this step in ``z_buf``: the all_gather (dense,
        vs_bounded), vs_halo's image, or vs_halo_async's stale image
        (its ship into the other slot started first when ``ship`` is a
        list to hold its handles)."""
        self._prescale()
        if self._vs_form == "vs_halo":
            self._halo_image(self._z_le)
        elif self._vs_form == "vs_halo_async":
            if ship is not None:
                ship.extend(self._ship_boundary(self._z_le, self._carry[1]))
            self._stale_image(self._carry[0])
        else:
            mesh_lib.all_gather(self.mesh, self._z_buf[: self._n_vs],
                                self._z_local)

    def _vs_inputs(self):
        """K1's inputs on a vertex-sharded form, z in place in z_buf."""
        a = self._arrays
        return (self._z_ext, a["src"], a["row_block"], self._num_blocks,
                self._plan)

    def _vs_merge(self, flat) -> torch.Tensor:
        """This rank's block of the summed contribution: the dense
        reduce-scatter, the halo windows, or vs_bounded's own sums (no
        merge: its rows write only its own range)."""
        if self._vs_form == "vs_bounded":
            return self._contrib_l
        if self._vs_form == "vertex_sharded":
            return mesh_lib.psum_scatter(self.mesh, self._contrib_l,
                                         flat[: self._n_vs])
        return self._halo_merge(flat)

    def _place(self, n_state, num_blocks, planes, arrays, plan, layout,
               build_seconds, t2, halo=None) -> "TorchEngine":
        """The shared tail of both builds: per-vertex planes, slot arrays
        and plan on the device, the z buffer, the kernel bound (cuda),
        r0, and the layout record. ``planes`` and ``arrays`` hold torch
        tensors or numpy arrays; ``t2`` is when placement began;
        ``halo`` the halo plan of a vs_halo build."""
        cfg, dev = self.config, self.device
        n = self.graph.n
        self._reset_graph_state()
        if self._vs:
            self._vs_form = ("vs_bounded" if cfg.vs_bounded else "vs_halo"
                             if halo is not None else "vertex_sharded")

        def put(a):
            return (a if isinstance(a, torch.Tensor)
                    else torch.from_numpy(a)).to(dev)

        self._n_state = n_state
        self._num_blocks = num_blocks
        if self._vs:
            planes = self._place_vs_state(n_state, planes)
        self._dangling = put(planes["dangling"])
        self._zero_in = put(planes["zero_in"])
        self._valid = put(planes["valid"])
        self._inv_out = put(planes["inv_out"]).to(self._z_dtype)
        self._arrays = {k: put(v) for k, v in arrays.items()}
        self._plan = ell_spmv.plan_to(plan, dev)
        out = None
        if cfg.partition_span:
            table = torch.bfloat16 if cfg.stream_dtype else self._z_dtype
            self._z_buf = torch.zeros((self._parts, self._window),
                                      dtype=table, device=dev)
        elif self._vs:
            # The gathered z (or the halo forms' z image): n_vs entries
            # (the padding's are 0·0), then the zero lanes; K1 reads its
            # first n_state + Z_PAD, so its sentinel n_state reads a
            # zero. The halo image's trash slot n_vs lies in the zero
            # lanes and only ever receives zeros (the send pads read
            # z_le[blk], the zero after z_l). K1 writes its sums into
            # the first n_state entries of ``flat``, whose tail stays
            # zero for the merge over n_vs and the write windows' reach
            # past it; vs_bounded's K1 writes all of its (nbd + 1)
            # local blocks.
            z = self._z_dtype
            wmax = self._setup_halo(halo) if halo is not None else 0
            self._z_le = torch.zeros(self._blk + 1, dtype=z, device=dev)
            self._z_local = self._z_le[: self._blk]
            self._z_buf = torch.zeros(self._n_vs + Z_PAD, dtype=z,
                                      device=dev)
            if self._vs_form == "vs_bounded":
                self._vs_layout = {"local_blocks": num_blocks - 1,
                                   "trash_blocks": 1}
                self._flat = torch.zeros(num_blocks * LANES, dtype=z,
                                         device=dev)
                self._contrib_l = self._flat[: self._blk]
                out = self._flat
            else:
                self._flat = torch.zeros(self._n_vs + wmax, dtype=z,
                                         device=dev)
                self._contrib_l = torch.empty(self._blk, dtype=z,
                                              device=dev)
                out = self._flat[:n_state]
            if self._vs_form == "vertex_sharded":
                from pagerank_tpu_torch.parallel import comms

                self._set_comms_model(comms.model_dense(
                    self._world, self._blk, z.itemsize, z.itemsize))
        else:
            self._z_buf = torch.zeros(n_state + Z_PAD, dtype=self._z_dtype,
                                      device=dev)
        self._z_ext = (self._z_buf[: n_state + Z_PAD] if self._vs
                       else self._z_buf)
        kernel = ("ell_contrib_partitioned" if cfg.partition_span
                  else "ell_contrib")
        launch_info = {}
        if dev.type == "cuda" and self._world > 1:
            # Rank 0 builds the kernel (nvcc) while the others wait, then
            # each loads the one library.
            from pagerank_tpu_torch.kernels import build

            if self.mesh.rank == 0:
                build.load(kernel)
            self.mesh.barrier()
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
                    self._z_ext, a["src"], num_blocks,
                    accum_dtype=self._accum, plan=self._plan, out=out)
            launch_info = {"head": self._launch.head,
                           "grid": self._launch.grid}
        self._step_cost = self._kernel_cost(plan, layout)
        # r0 over the TRUE n (1/n in textbook mode), zero in padding.
        if self._vs:
            r0 = 1.0 if cfg.semantics == "reference" else 1.0 / n
            self._r = torch.full((self._blk,), r0, dtype=self._dtype,
                                 device=dev) * self._valid.to(self._dtype)
        else:
            self._r = torch.zeros(n_state, dtype=self._dtype, device=dev)
            self._r[:n] = pr_model.initial_rank(n, cfg.semantics,
                                                self._dtype, dev)
        self._prime_carry()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        self.iteration = 0
        mesh_info = {}
        if self.mesh is not None:
            mesh_info = {"world": self._world, "rank": self.mesh.rank,
                         "backend": self.mesh.backend,
                         "vertex_sharded": self._vs}
            if self._vs:
                mesh_info.update(n_vs=self._n_vs, comms=self.comms_model(),
                                 form=self._vs_form, **self._vs_layout)
        self._layout = {
            **layout,
            **mesh_info,
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
            "form": "vertex_sharded" if self._vs else "flat_ell",
            "partition_span": 0, "num_rows": int(src.shape[0]),
            "slot_rows": int(src.shape[0]) * self._world,
            "padding_ratio": padding_ratio,
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
        row_pair = np.concatenate(ranks)
        src, row_pair = self._shard_rows(src, row_pair, psz, pair_off - 1)
        rows = int(src.shape[0])
        if words24:
            src = spmv.pack_words24(src)
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
            "pairs": pair_off, "slot_rows": rows * self._world,
            "num_rows": rows,
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
        if self._vs:
            # z_l = r_l·inv_l, then the form's exchange into z_buf (the
            # async form's image from its current slot, with no ship).
            self._vs_gather()
            return self._vs_inputs()
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
            out = spmv.edge_contrib_segment_sum(
                self._r, a["src"], a["lengths"], a["w"], self._accum)
            return mesh_lib.psum(self.mesh, out) if self._world > 1 else out
        ship = [] if self._carry is not None else None
        if self._vs:
            self._vs_gather(ship)
            inputs = self._vs_inputs()
        else:
            inputs = self.contrib_inputs()
        if self._launch is not None:
            out = self._launch()
        elif not self.config.partition_span:
            z_ext, src, rb, nb, plan = inputs
            out = ell_spmv.ell_contrib(z_ext, src, rb, nb,
                                       accum_dtype=self._accum, plan=plan)
        else:
            out = ell_spmv_partitioned.ell_contrib_partitioned(
                *inputs[:5], plan=inputs[5])
        if self._vs:
            # The merge: each rank keeps its block of the summed
            # contribution (the tail past K1's sums stays zero).
            if self._launch is None:
                self._flat[: out.shape[0]] = out
            contrib = self._vs_merge(self._flat)
            if ship is not None:
                # The async form: this step's boundary is in, and it is
                # the next step's stale slot.
                for p in ship:
                    p.wait()
                self._carry.reverse()
            return contrib
        if self._world > 1:
            mesh_lib.psum(self.mesh, out)
        return out[: self._n_state]

    # -- comms-vs-compute attribution (obs/devices.attribute_exchange) ------

    def has_exchange_program(self) -> bool:
        """Whether this build can time its exchange apart from the step
        (``jax_engine.py:3519``): the dense vertex-sharded form and both
        vs_halo forms; vs_bounded, whose only exchange is the z gather,
        and every replicated form cannot."""
        return self._vs_form in ("vertex_sharded", "vs_halo",
                                 "vs_halo_async")

    def _exchange_step(self) -> torch.Tensor:
        """One step's exchange with the contribution replaced by zeros
        (``jax_engine.py:3481-3539``): the prescale, the same z exchange
        (all_gather; head psum and read rounds; the async form's ship,
        waited, and stale image, its slots left as they were) and the
        same merge collectives (reduce-scatter; write windows) over a
        zero contribution. Every rank must call it. Returns the first
        element of the merged block, to fence on."""
        if not self.has_exchange_program():
            raise RuntimeError(
                "this layout has no exchange-only program (a replicated "
                "form or vs_bounded)")
        if self._exchange_zero is None:
            self._exchange_zero = torch.zeros_like(self._flat)
        ship = [] if self._carry is not None else None
        self._vs_gather(ship)
        out = self._vs_merge(self._exchange_zero)
        for p in ship or ():
            p.wait()
        return out[:1]

    def fence(self) -> None:
        """Wait until the device has run everything queued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time_exchange_split(self, iters: int = 10, warmup: int = 2):
        """``(exchange_s, step_s)`` a step (``jax_engine.py:3541-3586``):
        ``iters`` exchange-only dispatches, then ``iters`` steps, each
        behind ``warmup`` of its own and closed by a device fence. The
        steps advance the solve, so the rank vector, the async carry,
        the staleness slack and the iteration count are restored
        afterwards; the ``comms.bytes_exchanged`` counter counts the
        timing steps (they moved those bytes). Every rank of the mesh
        must call it."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        saved = self._save_solve_state()
        try:
            for _ in range(max(0, warmup)):
                self._exchange_step()
            self.fence()
            t0 = time.perf_counter()
            for _ in range(iters):
                self._exchange_step()
            self.fence()
            exchange_s = (time.perf_counter() - t0) / iters
            for _ in range(max(0, warmup)):
                self.step()
            self.fence()
            t0 = time.perf_counter()
            for _ in range(iters):
                self.step()
            self.fence()
            step_s = (time.perf_counter() - t0) / iters
        finally:
            self._restore_solve_state(saved)
        return exchange_s, step_s

    def _save_solve_state(self):
        """What a step changes, kept aside: the rank vector (a step
        rebinds it, never writes it in place), copies of the async
        form's boundary slots, the staleness slack and the iteration."""
        carry = [c.clone() for c in self._carry] if self._carry else None
        return self._r, carry, self._last_step_delta, self.iteration

    def _restore_solve_state(self, saved) -> None:
        self._r, carry, self._last_step_delta, self.iteration = saved
        if carry is not None:
            self._carry = carry

    def _note_comms(self, iters: int = 1) -> None:
        """Accumulate ``comms.bytes_exchanged`` for ``iters`` steps'
        exchange (the vertex-sharded form's model; ``jax_engine.py:
        3471``). Each caller of a step notes its own, so that a fused
        run counts its executed steps and nothing it throws away."""
        if self._comms_counter is not None and iters > 0:
            self._comms_counter.inc(self._comms_bytes_per_iter * iters)

    def _update(self, contrib: torch.Tensor, r: torch.Tensor):
        """The update tail of a step over ``contrib``: ``(r', delta,
        m)`` as device tensors — the one spelling shared by ``step`` and
        ``step_sdc``, so a checked step computes the same bits."""
        acc = self._accum
        m = spmv.dangling_mass(r, self._dangling, acc)
        if self._vs:
            # The block's partial, merged (``_make_vs_tail``).
            mesh_lib.psum(self.mesh, m)
        r_new = pr_model.apply_update(
            contrib, r.to(acc), self._zero_in.to(acc), m, self.graph.n,
            self.config.damping, self.config.semantics,
        )
        r_new = (r_new * self._valid.to(acc)).to(r.dtype)
        delta = torch.sum(torch.abs(r_new.to(acc) - r.to(acc)))
        if self._vs:
            mesh_lib.psum(self.mesh, delta)
        return r_new, delta, m

    def _device_step(self):
        """One iteration with no host sync (``jax_engine.py:3590``):
        the form's contribution launch (K1 or K2 on cuda) and the
        update, ``(delta, m)`` left on the device as scalars in the
        accumulation dtype. The comms counter is the caller's to feed."""
        r_new, delta, m = self._update(self._contrib(), self._r)
        self._r = r_new
        self._last_ledger = None
        self._last_step_delta = delta
        return delta, m

    def step(self) -> Dict[str, float]:
        delta, m = self._device_step()
        self._note_comms()
        self._last_step_delta = float(delta)
        return {"l1_delta": self._last_step_delta, "dangling_mass": float(m)}

    # -- the fused run forms (jax_engine.py:4204-4447) ----------------------

    def _total_iters(self, num_iters: Optional[int]) -> int:
        """The run's last iteration: ``num_iters`` or the config's."""
        if self.graph is None:
            raise RuntimeError("call build(graph) before a run")
        return self.config.num_iters if num_iters is None else num_iters

    def _queue_steps(self, k: int):
        """``k`` steps queued back to back; their traces stacked on the
        device, ``([k] deltas, [k] masses)``."""
        ds, ms = [], []
        for _ in range(k):
            d, m = self._device_step()
            ds.append(d)
            ms.append(m)
        return torch.stack(ds), torch.stack(ms)

    def run_fast(self, num_iters: Optional[int] = None) -> np.ndarray:
        """The benchmark loop (``jax_engine.py:4204-4214``): the
        remaining steps queued with no host sync, one fence at the end,
        then the ranks."""
        total = self._total_iters(num_iters)
        k = max(0, total - self.iteration)
        for _ in range(k):
            self._device_step()
        self.iteration += k
        self._note_comms(k)
        self.fence()
        return self.ranks()

    def run_fused(self, num_iters: Optional[int] = None) -> np.ndarray:
        """All remaining iterations queued as one run
        (``jax_engine.py:4216-4257``): where JAX dispatches one
        ``lax.scan``, the same steps go onto the stream with no host
        sync between them. The per-step ``(l1_delta, dangling_mass)``
        stay on the device, stacked in :attr:`last_run_metrics` (``[k]``
        each). A run already complete is a no-op that keeps the previous
        traces; one resumed mid-way queues only the remainder."""
        total = self._total_iters(num_iters)
        k = total - self.iteration
        if k <= 0:
            return self.ranks()
        deltas, masses = self._queue_steps(k)
        self.iteration = total
        self._note_comms(k)
        self.last_run_metrics = {"l1_delta": deltas, "dangling_mass": masses}
        return self.ranks()

    def run_fused_chunked(self, num_iters: Optional[int] = None,
                          every: int = 1, on_chunk=None,
                          tol: Optional[float] = None) -> np.ndarray:
        """Fused chunks between snapshot points (``jax_engine.py:
        4308-4397``): each chunk's steps queued with no host sync, the
        chunks aligned to ABSOLUTE multiples of ``every`` (a resumed run
        lands on the stepwise loop's cadence; the last chunk may be a
        short remainder ending off-cadence at the total; ``every`` 0
        runs one chunk). At each boundary an armed stall watchdog gets
        its heartbeat and ``on_chunk(iterations_done, ranks_thunk,
        (deltas, masses))`` fires: ``ranks_thunk`` is
        :meth:`device_ranks`, whose copy is made only when it is called
        (on a card it is queued on a side stream after the chunk's last
        step). A truthy return stops the run; so does ``tol`` against the
        chunk's last delta (one fetch a boundary). Every executed step's
        trace is kept in :attr:`last_run_metrics`."""
        total = self._total_iters(num_iters)
        if every is not None and every < 0:
            raise ValueError(f"every must be >= 0, got {every}")
        every = int(every) if every else max(1, total - self.iteration)
        watchdog = obs_live.get_watchdog()
        ds, ms = [], []
        while self.iteration < total:
            k = min(every - self.iteration % every, total - self.iteration)
            deltas, masses = self._queue_steps(k)
            self.iteration += k
            self._note_comms(k)
            ds.append(deltas)
            ms.append(masses)
            if watchdog is not None:
                watchdog.heartbeat(self.iteration - 1)
            stop = None
            if on_chunk is not None:
                stop = on_chunk(self.iteration, self.device_ranks,
                                (deltas, masses))
            if stop:
                break
            if tol is not None and float(deltas[-1]) <= tol:
                break
        if ds:
            self.last_run_metrics = {"l1_delta": torch.cat(ds),
                                     "dangling_mass": torch.cat(ms)}
        return self.ranks()

    def run_fused_tol(self, tol: Optional[float] = None,
                      num_iters: Optional[int] = None) -> np.ndarray:
        """The convergence-driven fused run (``jax_engine.py:4259-4306``):
        steps until ``l1_delta <= tol`` or the budget is spent, stopping
        at the iteration the host-checked stepwise run stops at. JAX's
        ``lax.while_loop`` becomes masked chunks: each step folds
        ``live &= delta > tol`` into a device flag, and a step after the
        stop keeps the state the stop left (the ranks, the async form's
        boundary slot, the traces) while a device count advances with
        the live steps; the host reads the flag once a chunk of
        ``FUSED_TOL_CHUNK`` steps (at most that less one masked steps
        run past the stop). :attr:`last_run_metrics` holds the final
        iteration's trace only, as ``[1]`` tensors."""
        tol = self.config.tol if tol is None else tol
        if tol is None:
            raise ValueError("run_fused_tol needs a tol (arg or config)")
        total = self._total_iters(num_iters)
        k = total - self.iteration
        if k <= 0:
            return self.ranks()
        dev, acc = self.device, self._accum
        live = torch.ones((), dtype=torch.bool, device=dev)
        done = torch.zeros((), dtype=torch.int64, device=dev)
        delta = torch.full((), float("inf"), dtype=acc, device=dev)
        mass = torch.zeros((), dtype=acc, device=dev)
        while k > 0:
            for _ in range(min(self.FUSED_TOL_CHUNK, k)):
                r = self._r
                d, m = self._device_step()
                self._r = torch.where(live, self._r, r)
                if self._carry is not None:
                    # The step shipped into the other slot and swapped
                    # them: a masked step takes back the slot it read.
                    self._carry[0].copy_(torch.where(live, self._carry[0],
                                                     self._carry[1]))
                delta = torch.where(live, d, delta)
                mass = torch.where(live, m, mass)
                done += live
                live &= d > tol
                k -= 1
            if not bool(live):
                break
        n = int(done)
        self.iteration += n
        self._note_comms(n)
        self._last_step_delta = delta
        self.last_run_metrics = {"l1_delta": delta.reshape(1),
                                 "dangling_mass": mass.reshape(1)}
        return self.ranks()

    def prepare_fused(self, num_iters: Optional[int] = None,
                      tol: Optional[float] = None,
                      every: Optional[int] = None) -> int:
        """Keep the one-time costs out of a fused run's timed window
        (``jax_engine.py:4399-4447``, its ``_ms_stripe`` branch): the
        kernel was built (nvcc at first use, ``kernels/build.py``) and
        its launch bound at build; this runs one throwaway step on a
        copy of the state, so the first launch and the allocator's first
        buffers of each step land here, then restores the state. Every
        fused form runs the same step, so ``tol`` and ``every`` change
        nothing here. Returns the remaining iteration count."""
        total = self._total_iters(num_iters)
        k = total - self.iteration
        if k > 0:
            saved = self._save_solve_state()
            self._device_step()
            self.fence()
            self._restore_solve_state(saved)
        return max(0, k)

    def _stale_slack(self) -> float:
        """The previous step's L1 delta while the async form runs
        (``jax_engine.py:3621-3629``: the staleness bound the SDC and
        ledger checks allow its flows); 0 on every synchronous form and
        right after a prime, when the next step is lag-0 exact."""
        return (float(self._last_step_delta) if self._carry is not None
                else 0.0)

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
        of them are not in ``prev_ids``, and the top-k mass. On the
        vertex-sharded form ``r`` is this rank's block: the mass is
        psum'd and the top k merged (:meth:`_vs_topk`), so every rank
        holds the whole vector's probe. Edge-sharded, ``r`` is
        replicated and the tail is the one-device tail."""
        acc = self._accum
        mass = torch.sum(r.to(acc))
        rv = torch.where(self._valid, r, torch.full((), float("-inf"),
                                                    dtype=r.dtype,
                                                    device=r.device))
        if self._vs:
            mesh_lib.psum(self.mesh, mass)
            vals, ids = self._vs_topk(rv, k)
        else:
            vals, ids = spmv.topk_lowest_index(rv, k)
        prev = (torch.full((k,), -1, dtype=ids.dtype, device=ids.device)
                if prev_ids is None else prev_ids)
        entered = torch.sum((ids[:, None] != prev[None, :]).all(dim=1))
        topk_mass = torch.sum(torch.where(
            torch.isfinite(vals), vals, torch.zeros((), dtype=vals.dtype,
                                                    device=vals.device)
        ).to(acc))
        return mass, ids, entered, topk_mass

    def _vs_topk(self, rv: torch.Tensor, k: int):
        """The top ``k`` (values, global ids) of the whole vector from
        this rank's block ``rv`` (invalid lanes at -inf): each rank's
        own top k (lowest local index first among ties), its ids made
        global, one ``all_gather`` of values and ids together (as f64:
        both are exact there), then the merge by value descending and
        id ascending — ``lax.top_k`` over the whole vector, ties to the
        lowest index. The same on every rank."""
        f64 = torch.float64
        kl = min(k, self._blk)
        vals, ids = spmv.topk_lowest_index(rv, kl)
        gid = ids.to(torch.int64) + self.mesh.rank * self._blk
        mine = torch.cat([vals.to(f64), gid.to(f64)])
        every = torch.empty(self._world * 2 * kl, dtype=f64, device=rv.device)
        every = mesh_lib.all_gather(self.mesh, every, mine).view(
            self._world, 2, kl)
        v, g = every[:, 0].reshape(-1), every[:, 1].reshape(-1)
        by_id = torch.argsort(g)  # the ids are distinct
        v, g = v[by_id], g[by_id]
        top = torch.argsort(-v, stable=True)[:k]
        return v[top].to(rv.dtype), g[top].to(torch.int64)

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
        ``topk_churn``, ``topk_mass`` and the ``mass_ledger`` entry.
        Over a mesh every rank gets the same probe: edge-sharded the
        ranks are replicated after the psum; vertex-sharded the tail
        merges the blocks (:meth:`_probe_tail`) and the ledger's
        per-block partials are summed by one psum."""
        k = self._resolve_probe_k(probes.topk)
        prev = probes.prev_ids
        r = self._r
        contrib = self._contrib()
        self._note_comms()
        r_new, delta, m = self._update(contrib, r)
        led = self._ledger_sums(contrib, r)
        if self._vs:
            led = list(mesh_lib.psum(self.mesh, torch.stack(led)))
        del contrib
        mass, ids, entered, topk_mass = self._probe_tail(r_new, k, prev)
        host = self._fetch([delta, m, mass, entered, topk_mass, *led], ids)
        self._r = r_new
        self._last_step_delta = float(host[0])
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
        """The devices holding the rank vector, in mesh order: the card's
        index on one device, the members' original ids over a mesh (what
        an SDC suspect position, a fault schedule and a rescue's dead set
        name: after a rescue, ``[0, 2]`` is the group that lost member
        1)."""
        if self.mesh is not None:
            return list(self.mesh.members)
        return [mesh_lib.device_id(self.device)]

    def sdc_supported(self) -> bool:
        """Every form measures the invariants, as every form of the JAX
        engine with a ledger core does (``jax_engine.py:3828``): the
        flat and partitioned forms with the source mass, on one device
        or edge-sharded, the vertex-sharded form, and the coo form (no
        prescale) without it."""
        return self.graph is not None

    def _gather_values(self, vals) -> np.ndarray:
        """Scalars of this rank to the host as [world, len(vals)]: every
        rank gets every rank's row (one ``all_gather``), so that each
        reaches the same verdict. One device: [1, len(vals)]."""
        v = torch.stack(vals)
        if self.mesh is None:
            return v.cpu().numpy()[None, :]
        out = torch.empty(self._world * v.shape[0], dtype=v.dtype,
                          device=v.device)
        return mesh_lib.all_gather(self.mesh, out, v).reshape(
            self._world, -1).cpu().numpy()

    def retain_state(self, iteration: Optional[int] = None):
        """Device-side double buffer for the SDC redo (``jax_engine.py:
        3837-3852``): ``(iteration, rank copy, carry copies, last
        delta)``, the copies on the engine's device. The async form's
        current boundary slot and its staleness slack ride in the token,
        so a redo replays the same stale bits under the same
        tolerance."""
        it = self.iteration if iteration is None else int(iteration)
        carry = (() if self._carry is None
                 else (self._carry[0].clone(),))
        return (it, self._r.clone(), carry, float(self._last_step_delta))

    def restore_state(self, token) -> None:
        """Rewind to a :meth:`retain_state` token (the token stays
        reusable: a second redo restores the same bits). A token with no
        carry (a synchronous form's, or a two-field one) re-primes the
        async form's slot from the restored ranks: lag-0, exact."""
        it, r, *rest = token
        self._r = r.clone()
        carry = rest[0] if rest else ()
        if carry and self._carry is not None:
            self._carry[0].copy_(carry[0])
            self._last_step_delta = float(rest[1]) if len(rest) > 1 else 0.0
        else:
            self._prime_carry()
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

            if self._vs:  # this rank's block of the vector over n_vs
                w = sdc_mod.fingerprint_vector(self.config.sdc_seed,
                                               self._n_vs)[self._vs_slice]
            else:
                w = sdc_mod.fingerprint_vector(self.config.sdc_seed,
                                               self._n_state)
            self._sdc_w_vec = torch.from_numpy(
                np.ascontiguousarray(w)).to(self._accum).to(self.device)
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
        ``fp``, ``mass``, ``src`` as per-device arrays (one transfer;
        over a mesh each rank's values, gathered)."""
        host = self._gather_values(self._sdc_sums(self._r))
        return {"fp": host[:, 0], "mass": host[:, 1],
                "src": host[:, 2] if self._has_src() else None}

    def step_sdc(self):
        """One SDC-checked iteration: ``(info, check record)``. The
        contribution launch and the update are ``step()``'s; the check
        tail's sums (the ledger's contribution, retained and previous
        totals, then w·r, mass and source mass of the input and w·r and
        mass of the output) come to the host in one transfer. Never
        called when SDC checking is off."""
        r = self._r
        contrib = self._contrib()
        self._note_comms()
        r_new, delta, m = self._update(contrib, r)
        ins = self._sdc_sums(r)
        outs = self._sdc_sums(r_new)[:2]
        vals = [delta, m, *self._ledger_sums(contrib, r), *ins, *outs]
        # [world, 10]: each rank's row. delta and m are whole-run values
        # on every rank; the ledger sums are per-rank partials on the
        # vertex-sharded form (``_ledger_partials``) and whole values on
        # a replicated one (one copy kept, as ``_ledger_sums``); the
        # check values are per-device either way (``_sdc_specs``).
        host = self._gather_values(vals)
        self._r = r_new
        led = host[:, 2:5] if self._vs else host[:1, 2:5]
        sums = led.sum(axis=0)
        self._last_ledger = (float(sums[2]), float(sums[0]), float(sums[1]))
        mass_out = host[:, -1]
        chk = {
            "sharded": self._vs,
            "fp_in": host[:, 5], "mass_in": host[:, 6],
            "src_in": host[:, 7] if self._has_src() else None,
            "fp_out": host[:, -2], "mass_out": mass_out,
            "contrib": led[:, 0], "retained": led[:, 1],
            "mass_prev": led[:, 2],
            "dangling_mass": float(host[0, 1]),
            "stale_slack": self._stale_slack(),
        }
        self._last_step_delta = float(host[0, 0])
        info = {"l1_delta": float(host[0, 0]),
                "dangling_mass": float(host[0, 1]),
                "rank_mass": float(mass_out.astype(float).sum() if self._vs
                                   else np.median(mass_out))}
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
        writes it in place). Vertex-sharded: every rank's block gathered
        first (a collective: every rank calls it)."""
        r = self._full_r()
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

    def join_rank_fetch(self) -> None:
        """This rank's part in a fetch of the ranks that another rank
        keeps (over a group rank 0 alone writes the sinks): the
        vertex-sharded form's gather of every block, which every rank
        joins in step order; nothing on a replicated form."""
        if self._vs:
            self._full_r()

    def _full_r(self) -> torch.Tensor:
        """The whole padded relabeled rank vector: the rank's own on one
        device and edge-sharded, every block gathered (``all_gather``,
        on every rank) vertex-sharded."""
        if not self._vs:
            return self._r
        full = torch.empty(self._n_vs, dtype=self._r.dtype,
                           device=self._r.device)
        return mesh_lib.all_gather(self.mesh, full, self._r)

    def rank_mass(self) -> float:
        """sum(ranks) by one device reduction; padding lanes are zero
        (vertex-sharded: the blocks' partials, psum'd)."""
        mass = torch.sum(self._r.to(self._accum))
        if self._vs:
            mesh_lib.psum(self.mesh, mass)
        return float(mass)

    def ranks(self) -> np.ndarray:
        """The whole vector in original id order, on every rank (over a
        vertex-sharded mesh a collective: every rank calls it)."""
        return self.decode_ranks(self._full_r())

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
        rr = np.zeros(self._n_vs if self._vs else self._n_state, dtype=dt)
        rr[: self.graph.n] = np.asarray(r, dtype=dt)[self._perm]
        if self._vs:  # this rank's block of the canonical vector
            rr = np.ascontiguousarray(rr[self._vs_slice])
        self._r = torch.from_numpy(rr).to(self.device)
        # Replaced state: the async form's boundary slot is re-primed
        # from the new ranks (snapshot resume and warm starts land here).
        self._prime_carry()
        self.iteration = iteration

    def layout_info(self) -> Dict[str, object]:
        """The resolved layout of this build: what actually runs."""
        return dict(self._layout)

    def snapshot_meta(self) -> Dict[str, object]:
        """Provenance recorded beside every snapshot (``jax_engine.py:
        4625-4650``): the mesh size, its devices' kinds, the form and
        its geometry. Snapshots hold the canonical host-order vector, so
        one taken at one world size resumes at another."""
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return {"engine": self.name, "num_devices": self._world,
                "device": name, "device_kinds": [name],
                "device_ids": self.device_ids(),
                "vertex_sharded": self._vs,
                "n_state": int(self._n_vs if self._vs else self._n_state),
                "form": self._layout.get("form"),
                "partition_span": self._layout.get("partition_span", 0),
                "layout": {k: self._layout.get(k)
                           for k in ("form", "partition_span", "n_stripes",
                                     "stripe_span", "group")}}


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
