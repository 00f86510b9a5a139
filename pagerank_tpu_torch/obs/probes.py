"""In-loop convergence probes.

Copy of ``pagerank_tpu/obs/probes.py``.

The reference has NO convergence check — ``for (iter = 0; iter < 10;
iter++)`` runs blind (Sparky.java:187) — while the iterative-PageRank
literature (Kollias et al., arXiv:cs/0606047, PAPERS.md) shows
residual / rank-movement telemetry is THE signal that makes solver
behaviour debuggable. This module adds opt-in probes at a configurable
cadence (``--probe-every K``): at each probe point the solver records

  - the **L1 residual** ``|r' - r|_1`` (the step already computes it);
  - the **rank mass** ``sum(r)`` (the conservation/diagnostic scalar);
  - the **top-k churn** — how many of the top-``topk`` ranked vertices
    entered the set since the previous probe (rank-movement telemetry:
    PageRank consumers care about ordering stability long before the
    residual hits machine precision).

On the torch engine all three are computed on the device, in the
step's own tail at probe iterations (``TorchEngine.step_probed``: the
same K1 or K2 launch and update as ``step``, then the probe's
reductions and top-k), and fetched with the step's scalars in one
transfer, so probing adds no host sync: the plain step pays two
(``l1_delta`` and ``dangling_mass``), the probed step one.
``--probe-every 0`` / unset takes the exact pre-probe code path: the
solve loop makes zero probe calls (tests/test_torch_probes.py pins
this, mirroring the no-op tracer contract).

Probe records land in the per-iteration history (run report
``iterations``), the metrics registry (``probe.*`` gauges — the live
exporter publishes them), and the trace (``probe/convergence`` instant
events). ``--stop-tol X`` optionally early-exits when the probed
residual reaches X; None keeps exact Sparky semantics (no check at
all).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.obs import trace as obs_trace


class ConvergenceProbes:
    """Probe cadence + state + history. The engines compute the
    values (``PageRankEngine.step_probed`` / ``probe_values``); this
    object owns WHEN to probe, the previous top-k baseline the churn
    compares against, and where records go (history, registry gauges,
    trace instants). One instance per run."""

    def __init__(self, every: int, topk: int = 64,
                 stop_tol: Optional[float] = None):
        if every < 0:
            raise ValueError(f"probe every must be >= 0, got {every}")
        if topk < 1:
            raise ValueError(f"probe topk must be >= 1, got {topk}")
        if stop_tol is not None and not (0.0 < stop_tol < float("inf")):
            raise ValueError(
                f"stop_tol must be a finite positive float, got {stop_tol}"
            )
        self.every = int(every)
        self.topk = int(topk)
        self.stop_tol = stop_tol
        #: Engine-space top-k ids of the previous probe (opaque to this
        #: class: a device tensor for the torch engine, numpy for the CPU
        #: oracle). None before the first probe.
        self.prev_ids = None
        #: ORIGINAL-id-space top-k of the latest probe (numpy) — what
        #: consumers/tests compare across engines.
        self.last_topk_ids = None
        self.history: List[Dict[str, float]] = []
        #: Rank-mass-ledger violations observed this run
        #: (obs/graph_profile.mass_ledger_entry): one record per probe
        #: whose decomposition failed to reconcile, carrying the named
        #: leaking term.
        self.ledger_violations: List[Dict[str, object]] = []

    @property
    def enabled(self) -> bool:
        return self.every > 0

    def wants(self, iteration: int) -> bool:
        """Whether the step taking ``iteration`` -> ``iteration + 1``
        is a probe point (absolute cadence, like snapshot_every — a
        resumed run probes the same iterations)."""
        return self.every > 0 and (iteration + 1) % self.every == 0

    def commit(self, iteration: int, info: Dict[str, float],
               ids_engine, ids_original) -> Dict[str, float]:
        """Record one probe: ``info`` already carries the probe scalars
        (``rank_mass``, ``topk_churn`` — stuffed by the engine's probed
        step next to ``l1_delta``). Updates the churn baseline, appends
        the history record, publishes ``probe.*`` gauges, and emits a
        ``probe/convergence`` trace instant."""
        self.prev_ids = ids_engine
        self.last_topk_ids = ids_original
        l1 = info.get("l1_delta")
        rec = {
            "iteration": iteration,
            "l1_residual": None if l1 is None else float(l1),
            "rank_mass": float(info["rank_mass"]),
            "topk_churn": int(info["topk_churn"]),
        }
        # Top-k rank concentration: what fraction of the
        # total mass the top-k hold — a convergence-quality signal
        # (ordering stabilizes long before the residual bottoms out).
        tm = info.get("topk_mass")
        if tm is not None and rec["rank_mass"]:
            rec["topk_concentration"] = float(tm) / rec["rank_mass"]
        ledger = info.get("mass_ledger")
        if ledger is not None:
            rec["mass_ledger"] = dict(ledger)
        self.history.append(rec)
        obs_metrics.counter(
            "probe.points", "convergence probes taken this run"
        ).inc()
        if rec["l1_residual"] is not None:
            obs_metrics.gauge(
                "probe.l1_residual",
                "L1 residual |r' - r| at the latest probe point",
            ).set(rec["l1_residual"])
        obs_metrics.gauge(
            "probe.rank_mass", "sum(ranks) at the latest probe point"
        ).set(rec["rank_mass"])
        obs_metrics.gauge(
            "probe.topk_churn",
            "top-k entries new since the previous probe point",
        ).set(rec["topk_churn"])
        if rec.get("topk_concentration") is not None:
            obs_metrics.gauge(
                "probe.topk_concentration",
                "fraction of rank mass held by the probe top-k",
            ).set(rec["topk_concentration"])
        if ledger is not None:
            from pagerank_tpu_torch.obs import graph_profile

            graph_profile.record_ledger(ledger)
            if not ledger.get("ok", True):
                self.ledger_violations.append(
                    {"iteration": iteration, **ledger})
        tracer = obs_trace.get_tracer()
        if tracer.enabled:
            tracer.add_event("probe/convergence", **{
                k: v for k, v in rec.items() if k != "mass_ledger"})
        return rec

    def should_stop(self, rec: Dict[str, float]) -> bool:
        """``--stop-tol`` early exit: the probed residual reached the
        tolerance. None (the default) never stops — exact Sparky
        semantics."""
        return (
            self.stop_tol is not None
            and rec.get("l1_residual") is not None
            and rec["l1_residual"] <= self.stop_tol
        )

    def probe_boundary(self, engine, iteration: int,
                       l1_delta=None) -> Dict[str, float]:
        """Probe at a fused-chunk boundary (run_fused_chunked): no step
        to fuse into, so this dispatches the engine's standalone probe
        program over the current state. ``l1_delta`` is the boundary's
        last on-device trace value (the residual was already
        computed)."""
        mass, churn, ids_engine, ids_original, topk_mass = \
            engine.probe_values(self.topk, self.prev_ids)
        info = {
            "rank_mass": mass,
            "topk_churn": 0 if self.prev_ids is None else churn,
            "topk_mass": topk_mass,
        }
        if l1_delta is not None:
            info["l1_delta"] = float(l1_delta)
        # No mass ledger at a fused boundary: the decomposition's link
        # sum lives inside the step dispatch, which already retired.
        return self.commit(iteration, info, ids_engine, ids_original)
