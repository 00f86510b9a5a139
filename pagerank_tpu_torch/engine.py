"""``PageRankEngine`` — the engine interface and the solve loop.

Port of ``pagerank_tpu/engine.py:26-430``: the ``run`` loop with its
per-step health check, snapshot rollback, ``tol`` stop and the SDC
guard's checked step (``:261-287``, ``:368-373``), and the engine hooks
the guard reads (``sdc_supported``, ``retain_state``, ``restore_state``,
``ledger_values``, ``:93-110``, ``:132``). The loop plays the role of the
reference's ``for (iter = 0; iter < 10; iter++)`` block
(Sparky.java:187-238): step, hook, snapshot, repeat. The observability
hooks of the JAX loop (``:112-198``, ``:199-300``) come with it: the
convergence probes (``probe_values``, ``step_probed``,
``_ledger_entry``, ``run(probes=)``), the tracer's ``solve/step`` span,
the stall watchdog's heartbeat and the device sampler's ``on_step``.
Each is read once a run; when off, the loop pays one ``is None`` (or
``False``) check an iteration and makes zero calls.
"""

from __future__ import annotations

import abc
import math
from typing import Callable, Dict, Optional

import numpy as np

from pagerank_tpu_torch.graph import Graph
from pagerank_tpu_torch.obs import devices as obs_devices
from pagerank_tpu_torch.obs import live as obs_live
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.obs import trace as obs_trace
from pagerank_tpu_torch.utils.config import PageRankConfig


class SolverHealthError(RuntimeError):
    """The solver state went bad (NaN/Inf step info, rank-mass drift)
    and could not be healed by snapshot rollback. Carries the first
    iteration that produced a bad step and the rollbacks attempted."""

    def __init__(self, message: str, first_bad_iteration: int,
                 rollbacks: int):
        super().__init__(message)
        self.first_bad_iteration = first_bad_iteration
        self.rollbacks = rollbacks


def _health_reason(info: Dict[str, float]) -> Optional[str]:
    """Non-finite scalar in the step info, or None when healthy."""
    for k, v in info.items():
        if isinstance(v, (int, float, np.floating, np.integer)):
            if not math.isfinite(float(v)):
                return f"non-finite step info {k}={float(v)!r}"
    return None


class PageRankEngine(abc.ABC):
    """Base class for PageRank execution engines."""

    name: str = "abstract"

    def __init__(self, config: Optional[PageRankConfig] = None):
        self.config = (config or PageRankConfig()).validate()
        self.graph: Optional[Graph] = None
        self.iteration = 0
        self.health: Dict[str, Optional[int]] = {
            "rollbacks": 0, "first_bad_iteration": None,
        }

    @abc.abstractmethod
    def build(self, graph: Graph) -> "PageRankEngine":
        """Prepare solver state (placement, r0)."""

    @abc.abstractmethod
    def step(self) -> Dict[str, float]:
        """Run one power iteration; returns ``l1_delta`` and
        ``dangling_mass`` as host floats."""

    @abc.abstractmethod
    def ranks(self) -> np.ndarray:
        """Current rank vector as a host numpy array, original id order."""

    @abc.abstractmethod
    def set_ranks(self, r: np.ndarray, iteration: int = 0) -> None:
        """Overwrite solver state — used by checkpoint resume."""

    def snapshot_meta(self) -> Dict[str, object]:
        """Provenance recorded in snapshot metadata
        (``Snapshotter.mesh_meta``); engines with a device override it."""
        return {"num_devices": 1, "engine": self.name}

    def rank_mass(self) -> float:
        """sum(ranks) as a host scalar — the mass-drift health probe."""
        return float(np.asarray(self.ranks(), dtype=np.float64).sum())

    def device_ids(self):
        """Ids of the devices holding the rank vector, in mesh-position
        order (what an SDC suspect position names); none for a host
        engine."""
        return []

    def sdc_supported(self) -> bool:
        """Whether this engine can run the SDC-checked step (sdc.py).
        The base engine cannot."""
        return False

    def retain_state(self, iteration=None):
        """Opaque rewind token (iteration, rank copy) — the SDC redo's
        double buffer. Base impl holds a host copy; the torch engine
        keeps it on its device."""
        it = self.iteration if iteration is None else int(iteration)
        return (it, np.array(self.ranks(), copy=True))

    def restore_state(self, token) -> None:
        it, ranks = token
        self.set_ranks(np.array(ranks, copy=True), iteration=int(it))

    def ledger_values(self):
        """Raw rank-mass-ledger sums of the step just taken —
        ``(mass_prev, contrib_total, retained_total)`` — or None when
        this engine cannot measure them."""
        return None

    def _ledger_eps(self) -> float:
        """Machine epsilon of the accumulation dtype the ledger sums
        were computed in."""
        return float(np.finfo(np.float64).eps)

    def _stale_slack(self) -> float:
        """Staleness bound on the conservation identities of the step
        just taken: 0.0 for every synchronous engine."""
        return 0.0

    # -- convergence probes (obs/probes.py) ---------------------------------

    def probe_values(self, k: int, prev_ids):
        """(rank_mass, entered_count, topk_ids_engine_space,
        topk_ids_original_space, topk_mass) of the CURRENT state — the
        standalone probe. ``prev_ids`` is the previous probe's
        engine-space top-k (None on the first probe); ``entered_count``
        is how many current top-k ids are NOT in it; ``topk_mass`` is
        the rank mass the top-k hold. Base impl: host numpy over
        ranks() (the CPU oracle's own probe — what the device path is
        held against). Ties break by lowest id, as ``lax.top_k`` does in
        the JAX engine."""
        r = np.asarray(self.ranks(), dtype=np.float64)
        k = min(int(k), r.shape[0])
        ids = np.argsort(-r, kind="stable")[:k].astype(np.int64)
        entered = (
            k if prev_ids is None
            else int(k - np.isin(ids, np.asarray(prev_ids)).sum())
        )
        return float(r.sum()), entered, ids, ids, float(r[ids].sum())

    def _ledger_entry(self, info: Dict[str, float]):
        """Assemble one mass-ledger entry from a probed step's info
        (requires the ``ledger_*`` sums; obs/graph_profile.py owns the
        decomposition and the leak naming)."""
        from pagerank_tpu_torch.obs import graph_profile

        return graph_profile.mass_ledger_entry(
            damping=self.config.damping,
            semantics=self.config.semantics,
            n=int(self.graph.n),
            eps=self._ledger_eps(),
            mass_prev=info["ledger_mass_prev"],
            mass=info["rank_mass"],
            dangling_mass=info["dangling_mass"],
            contrib_total=info["ledger_contrib_total"],
            retained_total=info["ledger_retained_total"],
            flow_slack=self._stale_slack(),
        )

    def step_probed(self, probes):
        """One iteration WITH the convergence probe: returns
        ``(info, (ids_engine, ids_original))`` where ``info`` carries
        ``rank_mass``, ``topk_churn``, ``topk_mass`` and — when the
        engine measures the ledger sums — the ``mass_ledger``
        decomposition next to the step scalars. Base impl: plain step()
        + the host probe; TorchEngine overrides it with the probe tail
        on the device and one transfer. Never called when probing is
        off (the zero-probe-call contract)."""
        info = self.step()
        prev = probes.prev_ids
        mass, entered, ids_engine, ids_original, topk_mass = \
            self.probe_values(probes.topk, prev)
        info["rank_mass"] = mass
        info["topk_churn"] = 0 if prev is None else entered
        info["topk_mass"] = topk_mass
        led = self.ledger_values()
        if led is not None:
            (info["ledger_mass_prev"], info["ledger_contrib_total"],
             info["ledger_retained_total"]) = led
            info["mass_ledger"] = self._ledger_entry(info)
        return info, (ids_engine, ids_original)

    def run(
        self,
        num_iters: Optional[int] = None,
        on_iteration: Optional[Callable[[int, Dict[str, float]], None]] = None,
        snapshotter=None,
        probes=None,
    ) -> np.ndarray:
        """Drive the solve up to ``num_iters`` (default config.num_iters).

        ``on_iteration(i, info)`` fires after each accepted step. Each
        step's info is health-checked (NaN/Inf always; rank-mass drift
        when ``robustness.mass_tol`` is set). On a bad step with a
        ``snapshotter`` attached, the engine rolls back to the newest
        valid snapshot of the same graph at or below the bad iteration
        and recomputes, up to ``max_rollbacks`` times; the bad step's
        ``on_iteration`` never fires. Exhausting the budget, or having
        nothing to roll back to, raises :class:`SolverHealthError`.

        ``probes`` (obs/probes.ConvergenceProbes): at its cadence the
        step runs as :meth:`step_probed` and the record is committed
        after the health check accepts the step; its ``stop_tol``
        early-exits at probe points. None/off takes the unprobed path.
        The tracer (a ``solve/step`` span a step when enabled), an armed
        stall watchdog (a heartbeat a completed step) and an armed
        device sampler (``on_step``) are read once a run; off, each
        costs one check an iteration and no call."""
        if self.graph is None:
            raise RuntimeError("call build(graph) before run()")
        total = self.config.num_iters if num_iters is None else num_iters
        tol = self.config.tol
        rb = self.config.robustness
        self.health = {"rollbacks": 0, "first_bad_iteration": None}
        last_mass: Optional[float] = None
        tracer = obs_trace.get_tracer()
        trace_steps = tracer.enabled
        watchdog = obs_live.get_watchdog()
        sampler = obs_devices.get_sampler()
        probing = probes is not None and probes.enabled
        probe_ids = None
        # SDC guard (sdc.py): built ONCE per run, None when
        # sdc_check_every is 0 — the loop body then adds one `is not
        # None` check per iteration and the solve is bit-identical to
        # the unchecked path (zero check computations).
        sdc_guard = None
        if self.config.sdc_check_every:
            from pagerank_tpu_torch import sdc as sdc_mod

            sdc_guard = sdc_mod.attach_guard(self)
        while self.iteration < total:
            probe_now = probing and probes.wants(self.iteration)
            sdc_now = (sdc_guard is not None
                       and sdc_guard.wants(self.iteration))
            if trace_steps:
                with tracer.span("solve/step", iteration=self.iteration):
                    if sdc_now:
                        # Checked step: detect -> bounded redo ->
                        # transient/sticky; a sticky conviction raises
                        # DeviceQuarantinedError.
                        info = sdc_guard.checked_step()
                    elif probe_now:
                        info, probe_ids = self.step_probed(probes)
                    else:
                        info = self.step()
            elif sdc_now:
                info = sdc_guard.checked_step()
            elif probe_now:
                info, probe_ids = self.step_probed(probes)
            else:
                info = self.step()
            if watchdog is not None:
                watchdog.heartbeat(self.iteration)
            if sampler is not None:
                sampler.on_step(self.iteration)
            i = self.iteration
            reason = None
            if rb.health_checks:
                reason = _health_reason(info)
                if reason is None and rb.mass_tol is not None:
                    mass = info.get("rank_mass")
                    mass = self.rank_mass() if mass is None else float(mass)
                    if not math.isfinite(mass):
                        reason = f"non-finite rank mass {mass!r}"
                    elif (last_mass is not None
                          and abs(mass - last_mass)
                          > rb.mass_tol * max(abs(last_mass), 1e-30)):
                        reason = (
                            f"rank mass drifted {last_mass!r} -> {mass!r} "
                            f"(> mass_tol={rb.mass_tol:g} per step)"
                        )
                        # On probed steps the drift names the ledger's
                        # leaking term (link / teleport / dangling).
                        led = info.get("mass_ledger")
                        if led and led.get("leak"):
                            self.health["mass_leak"] = led["leak"]
                            reason += (
                                f"; mass ledger names the "
                                f"{led['leak']} term (residual "
                                f"{led['residual']:.3e}, unaccounted "
                                f"{led['unaccounted']!r})"
                            )
                    else:
                        last_mass = mass
            if reason is not None:
                obs_metrics.counter(
                    "engine.health_check_failures",
                    "solver steps declared unhealthy (NaN/Inf, mass "
                    "drift)",
                ).inc()
                if trace_steps:
                    tracer.add_event("solve/unhealthy_step",
                                     iteration=i, reason=reason)
                if self.health["first_bad_iteration"] is None:
                    self.health["first_bad_iteration"] = i
                first_bad = self.health["first_bad_iteration"]
                rolled = None
                if (snapshotter is not None
                        and self.health["rollbacks"] < rb.max_rollbacks):
                    rolled = snapshotter.load_latest_valid(
                        max_iteration=i, match=True
                    )
                if rolled is None:
                    if snapshotter is None:
                        why = "no snapshotter attached"
                    elif self.health["rollbacks"] >= rb.max_rollbacks:
                        why = f"rollback budget ({rb.max_rollbacks}) exhausted"
                    else:
                        why = "no valid snapshot to roll back to"
                    raise SolverHealthError(
                        f"engine {self.name}: unhealthy step at iteration "
                        f"{i} ({reason}); first bad iteration {first_bad}, "
                        f"{self.health['rollbacks']} rollback(s) attempted, "
                        f"{why}",
                        first_bad_iteration=first_bad,
                        rollbacks=self.health["rollbacks"],
                    )
                it0, ranks, _meta = rolled
                self.set_ranks(ranks, iteration=it0)
                if sdc_guard is not None:
                    # The SDC double buffer must follow the rollback: a
                    # retained token AHEAD of the restored iteration
                    # would let a later redo jump the solve forward
                    # onto the rejected state.
                    sdc_guard.note_rollback()
                self.health["rollbacks"] += 1
                obs_metrics.counter(
                    "engine.rollbacks",
                    "snapshot rollbacks performed by the self-healing "
                    "solve loop",
                ).inc()
                last_mass = None  # re-baseline the drift check
                continue
            self.iteration = i + 1
            if on_iteration is not None:
                on_iteration(i, info)
            if probe_now:
                # Committed only after the health check accepted the
                # step and after on_iteration saw the probe-augmented
                # info. An SDC-checked step took this iteration, so the
                # probe tail never ran: probe the state standalone.
                if sdc_now:
                    rec = probes.probe_boundary(
                        self, i, l1_delta=info.get("l1_delta"))
                else:
                    rec = probes.commit(i, info, *probe_ids)
                if probes.should_stop(rec):
                    break
            if tol is not None and float(info["l1_delta"]) <= tol:
                break
        return self.ranks()


_REGISTRY: Dict[str, type] = {}


def register_engine(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls

    return deco


def make_engine(name: str, config: Optional[PageRankConfig] = None,
                device=None) -> PageRankEngine:
    """Engine factory: "torch" (the ELL engine on ``device``, default
    cuda) or "cpu" (the f64 numpy/scipy oracle; aliases "reference",
    "oracle", as in the JAX package). The torch engine raises when asked
    for cuda on a host without a card: pass ``device="cpu"`` to run it
    on the CPU."""
    import pagerank_tpu_torch.engines.cpu  # noqa: F401  (registration)
    import pagerank_tpu_torch.engines.torch_engine  # noqa: F401

    alias = {"reference": "cpu", "oracle": "cpu"}
    key = alias.get(name, name)
    if key not in _REGISTRY:
        raise ValueError(f"unknown engine {name!r}; have {sorted(_REGISTRY)}")
    if key == "cpu":
        if device not in (None, "cpu"):
            raise ValueError(f"the cpu oracle runs on the host, not {device!r}")
        return _REGISTRY[key](config)
    return _REGISTRY[key](config, device=device)
