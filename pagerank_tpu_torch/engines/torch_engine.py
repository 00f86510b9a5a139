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

and ``_finalize`` with its ``update_tail`` (:3331-3426),
``rank_mass``/``ranks``/``decode_ranks``/``set_ranks``/``layout_info``/
``snapshot_meta`` (:4560-4650).

Every device, the CPU included, runs the same host pack as the JAX
engine's pallas forms: lane group 1, inert slots pointing at a zero
sentinel, and (flat form) z kept in ``accum_dtype`` when that is wider
than the rank dtype. Per step:

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

    def _place(self, n_state, num_blocks, planes, arrays, plan, layout,
               build_seconds, t2) -> "TorchEngine":
        """The shared tail of both builds: per-vertex planes, slot arrays
        and plan on the device, the z buffer, the kernel bound (cuda),
        r0, and the layout record. ``planes`` and ``arrays`` hold torch
        tensors or numpy arrays; ``t2`` is when placement began."""
        cfg, dev = self.config, self.device
        n = self.graph.n

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
        the bound kernel on cuda, the wrapper's plain version on cpu."""
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

    def step(self) -> Dict[str, float]:
        contrib = self._contrib()
        r = self._r
        acc = self._accum
        m = spmv.dangling_mass(r, self._dangling, acc)
        r_new = pr_model.apply_update(
            contrib, r.to(acc), self._zero_in.to(acc), m, self.graph.n,
            self.config.damping, self.config.semantics,
        )
        r_new = (r_new * self._valid.to(acc)).to(r.dtype)
        delta = torch.sum(torch.abs(r_new.to(acc) - r.to(acc)))
        self._r = r_new
        return {"l1_delta": float(delta), "dangling_mass": float(m)}

    def rank_mass(self) -> float:
        """sum(ranks) by one device reduction; padding lanes are zero."""
        return float(torch.sum(self._r.to(self._accum)))

    def ranks(self) -> np.ndarray:
        return self.decode_ranks(self._r)

    def decode_ranks(self, padded: torch.Tensor) -> np.ndarray:
        """Fetch a padded relabeled rank vector to the host and undo the
        in-degree relabel."""
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
