"""ReferenceCpuEngine — float64 numpy/scipy oracle with exact reference
semantics.

Copy of ``pagerank_tpu/engines/cpu.py``, the mass-ledger sums
(``ledger_values``) included. It computes, in vectorized
form, what ``Sparky.java:187-238`` computes in local mode:

  contribs  = Aᵀ_norm r          # join+flatMap+reduceByKey, Sparky.java:192-229
  m         = Σ_{dangling} r     # danglingContrib loop,      Sparky.java:219-222
  sum       = contribs + z ⊙ r   # subtractByKey retention,   Sparky.java:224-225
  r'        = 0.15 + 0.85 (sum + m/N)                       # Sparky.java:233

It stays numpy/scipy: it is the acceptance oracle every other engine is
held against.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from pagerank_tpu_torch import graph as graph_lib
from pagerank_tpu_torch.engine import PageRankEngine, register_engine
from pagerank_tpu_torch.graph import Graph


@register_engine("cpu")
class ReferenceCpuEngine(PageRankEngine):
    """Single-host float64 oracle (scipy.sparse SpMV)."""

    def build(self, graph: Graph) -> "ReferenceCpuEngine":
        self.graph = graph
        self._at = graph_lib.to_csr_transpose(graph)  # Aᵀ_norm, CSR
        # Reference mode uses the post-repair dangUrls (uncrawled targets);
        # textbook mode uses the standard definition (out_degree == 0).
        mass_mask = (
            graph.dangling_mask
            if self.config.semantics == "reference"
            else graph.out_degree == 0
        )
        self._dangling = mass_mask.astype(np.float64)
        self._zero_in = graph.zero_in_mask.astype(np.float64)
        v = 1.0 if self.config.semantics == "reference" else 1.0 / graph.n
        self._r = np.full(graph.n, v, dtype=np.float64)
        self.iteration = 0
        return self

    def step(self) -> Dict[str, float]:
        cfg = self.config
        r = self._r
        contrib = self._at @ r
        m = float(self._dangling @ r)
        # Rank-mass-ledger sums, measured off the step's own
        # intermediates: three O(n) reductions the oracle can afford
        # unconditionally; the probed step reads them via
        # ledger_values().
        self._last_ledger = (
            float(r.sum()),
            float(contrib.sum()),
            float((self._zero_in * r).sum()),
        )
        n = self.graph.n
        if cfg.semantics == "reference":
            s = contrib + self._zero_in * r
            r_new = (1.0 - cfg.damping) + cfg.damping * (s + m / n)
        else:
            r_new = (1.0 - cfg.damping) / n + cfg.damping * (contrib + m / n)
        delta = float(np.abs(r_new - r).sum())
        self._r = r_new
        return {"dangling_mass": m, "l1_delta": delta}

    def ledger_values(self):
        return getattr(self, "_last_ledger", None)

    def ranks(self) -> np.ndarray:
        return np.asarray(self._r)

    def set_ranks(self, r: np.ndarray, iteration: int = 0) -> None:
        if r.shape != (self.graph.n,):
            raise ValueError(f"rank shape {r.shape} != ({self.graph.n},)")
        self._r = np.asarray(r, dtype=np.float64)
        self.iteration = iteration
