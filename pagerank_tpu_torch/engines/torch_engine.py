"""TorchEngine — the single-device flat-ELL PageRank solve in PyTorch.

Port of the single-device flat ELL form of ``JaxTpuEngine``
(``pagerank_tpu/engines/jax_engine.py``): the flat branch of the build
(:578-665), the pallas branch of ``_setup_ell`` (:1066-1433 — sentinel
repoint :1117-1121, prescale :1356-1358), ``_finalize`` with its
``update_tail`` (:3331-3426) and ``rank_mass``/``ranks``/
``decode_ranks``/``set_ranks``/``layout_info`` (:4560-4623).

Every device, the CPU included, runs the same host pack as the JAX
engine's pallas form: lane group 1, one stripe, inert slots pointing at
the sentinel ``n_state``, ``z_ext = [r·inv_out, 0×8]``, and z kept in
``accum_dtype`` when that is wider than the rank dtype. Per step:

    z       = r · inv_out                        (prescale, in place)
    contrib = K1(z_ext, slots)                   (ops/ell_spmv.ell_contrib)
    m       = Σ_dangling r                       (accum_dtype)
    r'      = apply_update(contrib, r, ...)      (models/pagerank.py)
    delta   = Σ |r' - r|                         (accum_dtype)

On ``cuda`` contrib is the hand-written kernel; on ``cpu`` the wrapper
runs its plain version. There is no fallback between the two: a CUDA
engine launches the kernel or raises. The kernel and z stay in device
memory (the TPU form's whole-z VMEM limit has no counterpart here).
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
from pagerank_tpu_torch.ops import ell as ell_lib
from pagerank_tpu_torch.ops import ell_spmv
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
    """Flat blocked-ELL power iteration on one device."""

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

    def build(self, graph: Graph) -> "TorchEngine":
        cfg = self.config
        dev = self.device
        self.graph = graph
        n = graph.n
        t0 = time.perf_counter()
        pack = ell_lib.ell_pack(graph)
        t1 = time.perf_counter()
        self._perm = pack.perm
        n_state = pack.n_padded
        pad = n_state - n
        self._n_state = n_state
        self._num_blocks = pack.num_blocks

        mass_mask = (graph.dangling_mask if cfg.semantics == "reference"
                     else graph.out_degree == 0)

        def relabel(a):  # per-vertex plane -> relabeled, zero-padded
            return torch.from_numpy(
                np.concatenate([a[pack.perm], np.zeros(pad, a.dtype)]))

        dangling = relabel(mass_mask)
        zero_in = relabel(graph.zero_in_mask)
        valid = relabel(np.ones(n, bool))
        inv = relabel(graph_mod.inv_out_degree(graph.out_degree))
        src = ell_lib.sentinel_slots(pack)
        plan = ell_lib.segment_plan(pack.row_block, pack.num_blocks)
        t2 = time.perf_counter()
        self._dangling = dangling.to(dev)
        self._zero_in = zero_in.to(dev)
        self._valid = valid.to(dev)
        self._inv_out = inv.to(device=dev, dtype=self._z_dtype)
        self._src = torch.from_numpy(src).to(dev)
        self._row_block = torch.from_numpy(pack.row_block).to(dev)
        self._plan = ell_spmv.plan_to(plan, dev)
        if dev.type == "cuda":
            # Build (or load) the kernel now, so nvcc never lands in a
            # timed step.
            from pagerank_tpu_torch.kernels import build as kbuild

            kbuild.load("ell_contrib")
        self._z_ext = torch.zeros(n_state + Z_PAD, dtype=self._z_dtype,
                                  device=dev)
        # r0 over the TRUE n (1/n in textbook mode), zero in padding.
        self._r = torch.zeros(n_state, dtype=self._dtype, device=dev)
        self._r[:n] = pr_model.initial_rank(n, cfg.semantics, self._dtype,
                                            dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        self.iteration = 0
        self._layout = {
            "form": "flat_ell",
            "kernel": ("ell_contrib:cuda" if dev.type == "cuda"
                       else "ell_contrib:reference"),
            "kernel_requested": cfg.kernel,
            "device": str(dev),
            "group": 1,
            "num_rows": pack.num_rows,
            "padding_ratio": pack.padding_ratio,
            "num_segments": plan.num_segments,
            "seg_rows": ell_lib.SEG_ROWS,
            "dtype": cfg.dtype,
            "accum_dtype": cfg.accum_dtype,
            "z_dtype": str(self._z_dtype).replace("torch.", ""),
            # Host wall of the build's stages: the ELL pack; the
            # per-vertex planes, sentinel repoint and segment plan; and
            # device placement (with the kernel build or load on cuda).
            "build_seconds": {"pack": t1 - t0, "plan": t2 - t1,
                              "place": t3 - t2},
        }
        return self

    def contrib_inputs(self):
        """The kernel's inputs at the current state — ``(z_ext, src,
        row_block, num_blocks, plan)`` — with z_ext freshly prescaled.
        What the step feeds K1, for callers that check the kernel at the
        main path's own shapes."""
        torch.mul(self._r.to(self._z_dtype), self._inv_out,
                  out=self._z_ext[: self._n_state])
        return (self._z_ext, self._src, self._row_block, self._num_blocks,
                self._plan)

    def step(self) -> Dict[str, float]:
        z_ext, src, rb, nb, plan = self.contrib_inputs()
        contrib = ell_spmv.ell_contrib(
            z_ext, src, rb, nb, accum_dtype=self._accum, plan=plan,
        )[: self._n_state]
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
                "form": self._layout.get("form")}
