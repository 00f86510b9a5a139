"""Batched Personalized PageRank engines (SpMM power iteration).

Port of ``pagerank_tpu/engines/ppr.py``: ``PprResult``, ``ppr_cpu`` and
``ppr_cpu_topk`` (:24-75, host numpy: copies) and
:class:`PprTorchEngine`, from ``PprJaxEngine`` (:77-303).

The source batch runs in column chunks. Like the JAX engine, this one
keeps a chunk row-major — r, p and z2 are [n_state, k], row v the
vertex's value in each column — and sums it with K1w, the port's hand
kernel for the SpMM the JAX op ``ops/spmv.py:ell_contrib_spmm``
computes (``ops/ell_spmm.py``; one launch an iteration, bound once).
Each column's sums keep K1's plan order, so an answer repeats itself
bit for bit and does not depend on its batch-mates.

Layout: the flat blocked-ELL pack K1w reads (``ops/ell.py:ell_pack`` +
``sentinel_slots`` + ``segment_plan``); the in-degree relabel is the
JAX pack's. The JAX engine's source stripes (2^17 - 128 sources, the
TPU's fast-gather limit) and its gather chunking are not applicable:
K1w reads the whole prescaled chunk. Per iteration, per chunk:

    z2        = [r · inv_out, 0×8 rows]      (prescale, in the wider
                                              of dtype and accum; 1 in
                                              place of inv_out on the
                                              dangling rows)
    contrib   = K1w(z2, slots)                (one launch; it sums its
                                              extra dangling block
    m[j]      = Σ_{out-degree 0} r[:, j]       into 128 lanes and folds
                                              them pairwise, in-kernel)
    r'        = (1-d)·p + d·(contrib + dangling redistribution),
                padding lanes masked to 0

The top-k runs on the device — a stable descending sort along the
vertex axis, so that ties go to the lower relabeled index as
``jax.lax.top_k`` breaks them — and only [batch, k] comes back to the
host, mapped back through the relabel.

Over a mesh (``num_devices`` > 1: a ``torch.distributed`` group, one
process a device, ``parallel/mesh.py``) the slot rows are sharded and
everything else is replicated, as in the JAX engine (``:122-124``,
``:197-216``): the whole table (the dangling block, then the flat pack)
is padded with inert rows to a multiple of world x ``CHUNK_ROWS`` and
each rank keeps its contiguous share, with a segment plan of its own.
Each rank's K1w launch sums its share's rows of every block (a block
none of its rows reach comes out zero, as does the dangling mass of a
share without a dangling row), and ONE ``all_reduce`` an iteration
(``mesh.psum``) adds the ranks' contribution rows and folded dangling
masses, laid out in one buffer — the JAX engine's single psum. z2, the
update and the top-k run on every rank, so ``run`` returns the same
result on each. A mesh of one rank pads nothing and calls no
collective: its bits are the one-device engine's.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from pagerank_tpu_torch import graph as graph_lib
from pagerank_tpu_torch.engines.torch_engine import (CHUNK_ROWS,
                                                     resolve_device)
from pagerank_tpu_torch.graph import Graph
from pagerank_tpu_torch.models import ppr as ppr_model
from pagerank_tpu_torch.ops import LANES
from pagerank_tpu_torch.ops import ell as ell_lib
from pagerank_tpu_torch.ops import ell_spmm, ell_spmv, spmv
from pagerank_tpu_torch.parallel import distributed
from pagerank_tpu_torch.parallel import mesh as mesh_lib
from pagerank_tpu_torch.utils.config import PageRankConfig, torch_dtype


@dataclass
class PprResult:
    sources: np.ndarray  # [s] source vertex ids
    topk_ids: np.ndarray  # [s, k] highest-rank vertex ids per source
    topk_scores: np.ndarray  # [s, k]

    def rank_of(self, source_index: int):
        return self.topk_ids[source_index], self.topk_scores[source_index]


def ppr_cpu(
    graph: Graph,
    sources: np.ndarray,
    num_iters: int = 20,
    damping: float = 0.85,
    dangling_to: str = ppr_model.DANGLING_TO_SOURCE,
) -> np.ndarray:
    """Float64 oracle: full [n, s] PPR matrix (small graphs only)."""
    from pagerank_tpu_torch.graph import to_csr_transpose

    at = to_csr_transpose(graph)
    n, s = graph.n, len(sources)
    p = np.zeros((n, s))
    p[sources, np.arange(s)] = 1.0
    d = (graph.out_degree == 0).astype(np.float64)
    r = p.copy()
    for _ in range(num_iters):
        contrib = at @ r
        mass = d @ r
        r = ppr_model.apply_ppr_update(
            contrib, p, mass, n, damping, dangling_to, np
        )
    return r


def ppr_cpu_topk(
    graph: Graph, config: PageRankConfig, sources: np.ndarray,
    topk: int = 100, dangling_to: str = ppr_model.DANGLING_TO_SOURCE,
) -> PprResult:
    """Run the float64 CPU oracle and shape its full [n, s] matrix into
    the same top-k ``PprResult`` the device engine returns (CLI
    ``--engine cpu`` path)."""
    sources = np.asarray(sources, dtype=np.int64)
    r = ppr_cpu(
        graph, sources, num_iters=config.num_iters,
        damping=config.damping, dangling_to=dangling_to,
    )  # [n, s]
    k = min(topk, graph.n)
    order = np.argsort(-r, axis=0, kind="stable")[:k]  # [k, s]
    ids = order.T.astype(np.int32)  # [s, k]
    scores = np.take_along_axis(r, order, axis=0).T
    return PprResult(sources=sources, topk_ids=ids, topk_scores=scores)


class PprTorchEngine:
    """Chunked batched PPR, one K1w launch an iteration on each device
    (module docstring: one device, or a mesh of ranks).

    ``build(graph)`` packs and places the graph; ``run(sources, ...)``
    solves chunk by chunk. :meth:`bind` sizes the chunk buffers and, on
    cuda, binds K1w at their width (building the kernel if need be);
    ``run`` binds at its chunk width when nothing wider is bound, so a
    server binds once, at warm-up, and a narrower chunk runs only its
    live columns. The chunk buffers and K1w's workspace
    are the engine's own, so runs take turns: a dispatch a server
    abandoned at its deadline still holds the engine until it ends, and
    the next one waits rather than share the buffers."""

    def __init__(self, config: Optional[PageRankConfig] = None,
                 dangling_to: str = ppr_model.DANGLING_TO_SOURCE,
                 device=None, mesh: Optional[mesh_lib.Mesh] = None):
        self.config = (config or PageRankConfig()).validate()
        cfg = self.config
        if cfg.vertex_sharded:
            raise ValueError(
                "PPR has no vertex-sharded form: its [n, k] state is "
                "replicated and its slot rows sharded (the JAX CLI refuses "
                "--vertex-sharded with --ppr-sources)")
        if dangling_to not in (ppr_model.DANGLING_TO_SOURCE,
                               ppr_model.DANGLING_TO_UNIFORM):
            raise ValueError(f"unknown dangling_to: {dangling_to!r}")
        self.dangling_to = dangling_to
        dev = resolve_device(device)
        # The mesh as TorchEngine takes it: num_devices, else the group's
        # world size; an explicit num_devices=1 is the one-device form.
        ndev = (cfg.num_devices if cfg.num_devices is not None
                else distributed.process_info()[1])
        if mesh is None and ndev > 1:
            mesh = mesh_lib.make_mesh(cfg.num_devices, cfg.mesh_axis,
                                      device=dev)
        if mesh is not None:
            if mesh.device.type != dev.type:
                raise ValueError(f"the mesh is on {mesh.device}, the engine "
                                 f"on {dev}")
            dev = mesh.device
        #: The mesh the slot rows are sharded over (parallel/mesh.Mesh),
        #: None on one device.
        self.mesh = mesh
        self._world = mesh.world if mesh is not None else 1
        self.device = dev
        self.graph: Optional[Graph] = None
        self._dtype = torch_dtype(self.config.dtype)
        self._accum = torch_dtype(self.config.accum_dtype)
        # Prescale in the widest dtype the solver uses, so per-edge
        # products carry accum precision into the sums (the JAX
        # engine's rule, ppr.py:178-183); K1w has that entry.
        self._z_dtype = (self._accum if self._accum.itemsize
                         > self._dtype.itemsize else self._dtype)
        self._width = 0
        self._launcher: Optional[ell_spmm.SpmmLauncher] = None
        self._layout: Dict[str, object] = {}
        self._run_lock = threading.Lock()
        #: Wall seconds of each chunk of the last ``run`` (solve + top-k
        #: + fetch, ending in the fetch's sync).
        self.chunk_seconds: List[float] = []

    def build(self, graph: Graph) -> "PprTorchEngine":
        dev = self.device
        t0 = time.perf_counter()
        pack = ell_lib.ell_pack(graph)
        t1 = time.perf_counter()
        n, n_state = graph.n, pack.n_padded
        pad = n_state - n
        dang = np.concatenate([(graph.out_degree == 0)[pack.perm],
                               np.zeros(pad, bool)])
        # The dangling block: one more dst block, block 0, whose slots
        # are the dangling vertices, 128 a row. No slot of a real block
        # reads a dangling vertex (it is no edge's source), so its z2
        # row holds r itself (a prescale of 1), and K1w sums each
        # column's dangling mass into block 0's 128 lanes in its own
        # fixed order: no other kernel, and the same bits in any batch.
        # First, so that the deep blocks' segments (it and the hubs)
        # stay a prefix and the workspace small.
        d_rows = np.flatnonzero(dang).astype(np.int32)
        d_slots = np.full(-(-len(d_rows) // LANES) * LANES, n_state, np.int32)
        d_slots[: len(d_rows)] = d_rows
        num_blocks = pack.num_blocks + 1
        row_block_np = np.concatenate([
            np.zeros(len(d_slots) // LANES, np.int32), pack.row_block + 1])
        src_np = np.concatenate([d_slots.reshape(-1, LANES),
                                 ell_lib.sentinel_slots(pack)])
        slot_rows = int(src_np.shape[0])
        src_np, row_block_np = self._share(src_np, row_block_np, n_state,
                                           num_blocks)
        plan = ell_lib.segment_plan(row_block_np, num_blocks)
        src = torch.from_numpy(src_np).to(dev)
        row_block = torch.from_numpy(row_block_np).to(dev)
        inv_np = np.float64 if self._z_dtype == torch.float64 else np.float32
        inv = graph_lib.inv_out_degree(graph.out_degree, dtype=inv_np)
        inv_rel = np.concatenate([inv[pack.perm], np.zeros(pad, inv_np)])
        inv_rel[dang] = 1
        valid = np.concatenate([np.ones(n), np.zeros(pad)])
        t2 = time.perf_counter()
        self.graph = graph
        self._n_state = n_state
        self._num_blocks = num_blocks
        self._perm = pack.perm  # relabeled -> original
        self._inv_perm = pack.inv_perm  # original -> relabeled
        self._src, self._row_block = src, row_block
        self._plan = ell_spmv.plan_to(plan, dev)
        self._inv_out = torch.from_numpy(inv_rel).to(dev)
        self._valid = torch.from_numpy(valid).to(dev, self._accum)
        self._width = 0
        self._launcher = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        mesh_info = {}
        if self.mesh is not None:
            mesh_info = {"world": self._world, "rank": self.mesh.rank,
                         "backend": self.mesh.backend,
                         "slot_rows": -(-slot_rows // self._unit()) *
                         self._unit()}
        self._layout = {
            **mesh_info,
            "form": "ppr_flat_ell",
            "kernel": ("ell_contrib_spmm:cuda" if dev.type == "cuda"
                       else "ell_contrib:reference"),
            "device": str(dev), "n_state": n_state,
            "num_blocks": num_blocks, "num_rows": int(src.shape[0]),
            "dangling_rows": len(d_slots) // LANES,
            "num_segments": plan.num_segments,
            "padding_ratio": pack.padding_ratio,
            "dtype": self.config.dtype,
            "accum_dtype": self.config.accum_dtype,
            "z_dtype": str(self._z_dtype).replace("torch.", ""),
            "width": 0,
            "build_seconds": {"pack": t1 - t0, "plan": t2 - t1,
                              "place": t3 - t2},
        }
        return self

    def _unit(self) -> int:
        """The rows a sharded table is padded to a multiple of."""
        return self._world * CHUNK_ROWS if self._world > 1 else 1

    def _share(self, src, row_block, sentinel, num_blocks):
        """This rank's contiguous share of the whole slot table (host
        arrays): padded with inert rows (every slot the sentinel, the
        last block's id, so the ids stay ascending) to a multiple of
        world x ``CHUNK_ROWS`` and split as ``mesh.edge_sharding`` splits
        rows (``TorchEngine._pad_rows`` and ``_take_share``;
        ``pagerank_tpu/engines/ppr.py:147-154``). One device, or a mesh
        of one, keeps the table as it is."""
        if self._world == 1:
            return src, row_block
        unit = self._unit()
        pad = -(-len(src) // unit) * unit - len(src)
        src = np.concatenate([src, np.full((pad, LANES), sentinel,
                                           src.dtype)])
        row_block = np.concatenate([row_block, np.full(
            pad, num_blocks - 1, row_block.dtype)])
        sl = mesh_lib.edge_sharding(self.mesh, len(src))
        return (np.ascontiguousarray(src[sl]),
                np.ascontiguousarray(row_block[sl]))

    def bind(self, width: int) -> "PprTorchEngine":
        """Size the chunk buffers for ``width`` columns and, on cuda,
        bind K1w once over them. Rebinding at a width no larger than the
        bound one is a no-op."""
        if self.graph is None:
            raise RuntimeError("call build(graph) before bind()")
        if width <= self._width:
            return self
        dev = self.device
        t0 = time.perf_counter()
        # Row v is vertex v's prescaled value in each column; the last 8
        # rows stay zero (inert slots read the sentinel n_state).
        self._z2 = ell_spmm.z2_buffer(self._n_state, width, self._z_dtype,
                                      dev)
        if dev.type == "cuda":
            # K1w's sums and its folded lanes in one buffer: rows
            # [128, rows_out] are the real blocks' sums, row rows_out the
            # dangling mass, so one reduction over a mesh covers both.
            rows_out = self._num_blocks * LANES
            self._sums = torch.zeros((rows_out + LANES, self._z2.shape[1]),
                                     dtype=self._z_dtype, device=dev)
            with torch.cuda.device(dev):
                self._launcher = ell_spmm.bind_spmm(
                    self._z2, self._src, self._num_blocks,
                    accum_dtype=self._accum, plan=self._plan, width=width,
                    out=self._sums[:rows_out], fold=self._sums[rows_out:])
                torch.cuda.synchronize(dev)
            self._layout.update(kt=self._launcher.kt,
                                grid=self._launcher.grid)
        self._width = width
        self._layout["width"] = width
        self._layout["bind_seconds"] = time.perf_counter() - t0
        return self

    def _contrib(self, kc: int):
        """The contribution sums of the first kc columns of z2, [n_state,
        kc] (z dtype; blocks 1..), and the dangling mass, [kc] (accum):
        the dangling block's 128 lane sums folded pairwise
        (``ops/spmv.py:fold_rows``' order), so a column's mass is the
        same bits alone or in any batch. On cuda one K1w launch, which
        folds the lanes itself; on the CPU its plain version and
        ``fold_rows`` (z2 is in the sum's dtype: the same bits).

        Over a mesh both are this rank's share's, and one ``mesh.psum``
        of the sums' rows and the mass (one buffer) adds the ranks'."""
        rows_out = self._num_blocks * LANES
        if self._launcher is not None:
            self._launcher(kc)
            sums = self._sums
        else:
            out = ell_spmm.ell_contrib_spmm_rows(
                self._z2, self._src, self._row_block, self._num_blocks,
                accum_dtype=self._accum, plan=self._plan, k=kc)
            mass = spmv.fold_rows(out[:LANES, :kc].to(self._accum))
            if self._world == 1:
                return out[LANES: LANES + self._n_state, :kc], mass
            sums = torch.cat([out, mass[None].to(out.dtype)])
        if self._world > 1:
            mesh_lib.psum(self.mesh, sums[LANES: rows_out + 1])
        return sums[LANES: LANES + self._n_state, :kc], sums[rows_out, :kc]

    def _step(self, r: torch.Tensor, p_acc: torch.Tensor) -> torch.Tensor:
        kc, acc = r.shape[1], self._accum
        # z2 = r / out-degree, and r itself in the dangling rows.
        torch.mul(r, self._inv_out[:, None],
                  out=self._z2[: self._n_state, :kc])
        contrib, mass = self._contrib(kc)
        r_new = ppr_model.apply_ppr_update(
            contrib.to(acc), p_acc, mass, self.graph.n,
            self.config.damping, self.dangling_to, torch,
        )
        return (r_new * self._valid[:, None]).to(r.dtype)

    def solve_chunk(self, batch: np.ndarray, num_iters: int) -> torch.Tensor:
        """[n_state, len(batch)] PPR columns of the sources ``batch``
        (original ids) after ``num_iters`` iterations, on the device,
        in relabeled order."""
        kc = len(batch)
        self.bind(kc)
        p = torch.zeros((self._n_state, kc), dtype=self._dtype,
                        device=self.device)
        rel = torch.from_numpy(self._inv_perm[batch].astype(np.int64))
        p[rel.to(self.device), torch.arange(kc, dtype=torch.int64, device=self.device)] = 1.0
        p_acc = p.to(self._accum)
        r = p.clone()
        for _ in range(num_iters):
            r = self._step(r, p_acc)
        return r

    def topk(self, r: torch.Tensor, k: int):
        """Per column, the k highest scores and their relabeled ids on
        the device, [columns, k] each: a stable descending sort over the
        n real vertices, so equal scores keep the lower index first
        (``lax.top_k``'s order)."""
        vals, idx = torch.sort(r[: self.graph.n], dim=0, descending=True,
                               stable=True)
        return idx[:k].T, vals[:k].T

    def run(
        self,
        sources: np.ndarray,
        num_iters: Optional[int] = None,
        topk: int = 100,
        chunk: int = 64,
    ) -> PprResult:
        if self.graph is None:
            raise RuntimeError("call build(graph) before run()")
        if chunk < 1:
            raise ValueError(f"chunk must be positive, got {chunk}")
        cfg = self.config
        iters = cfg.num_iters if num_iters is None else num_iters
        n = self.graph.n
        sources = np.asarray(sources, dtype=np.int64)
        topk = min(topk, n)
        ids_out = np.zeros((len(sources), topk), np.int32)
        np_dtype = np.float32 if self._dtype == torch.float32 else np.float64
        scores_out = np.zeros((len(sources), topk), np_dtype)
        # A thread that launches (a server's dispatcher, a deadline
        # worker) starts on device 0: make the engine's device current.
        with self._run_lock, (
                torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext()):
            self.chunk_seconds = []
            self.bind(min(chunk, max(1, len(sources))))
            for lo in range(0, len(sources), chunk):
                t0 = time.perf_counter()
                batch = sources[lo: lo + chunk]
                r = self.solve_chunk(batch, iters)
                ids, scores = self.topk(r, topk)
                ids_rel = ids.cpu().numpy()
                ids_out[lo: lo + len(batch)] = self._perm[ids_rel]
                scores_out[lo: lo + len(batch)] = scores.cpu().numpy()
                self.chunk_seconds.append(time.perf_counter() - t0)
        return PprResult(sources=sources, topk_ids=ids_out,
                         topk_scores=scores_out)

    def layout_info(self) -> Dict[str, object]:
        """The resolved layout of this build: what actually runs."""
        return dict(self._layout)
