"""``PageRankEngine`` — the engine interface and the solve loop.

Port of ``pagerank_tpu/engine.py:26-430``: the ``run`` loop with its
per-step health check, snapshot rollback and ``tol`` stop. The loop
plays the role of the reference's ``for (iter = 0; iter < 10; iter++)``
block (Sparky.java:187-238): step, hook, snapshot, repeat. Probes, the
SDC guard, the stall watchdog and the tracer come with later slices.
"""

from __future__ import annotations

import abc
import math
from typing import Callable, Dict, Optional

import numpy as np

from pagerank_tpu_torch.graph import Graph
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

    def rank_mass(self) -> float:
        """sum(ranks) as a host scalar — the mass-drift health probe."""
        return float(np.asarray(self.ranks(), dtype=np.float64).sum())

    def run(
        self,
        num_iters: Optional[int] = None,
        on_iteration: Optional[Callable[[int, Dict[str, float]], None]] = None,
        snapshotter=None,
    ) -> np.ndarray:
        """Drive the solve up to ``num_iters`` (default config.num_iters).

        ``on_iteration(i, info)`` fires after each accepted step. Each
        step's info is health-checked (NaN/Inf always; rank-mass drift
        when ``robustness.mass_tol`` is set). On a bad step with a
        ``snapshotter`` attached, the engine rolls back to the newest
        valid snapshot of the same graph at or below the bad iteration
        and recomputes, up to ``max_rollbacks`` times; the bad step's
        ``on_iteration`` never fires. Exhausting the budget, or having
        nothing to roll back to, raises :class:`SolverHealthError`."""
        if self.graph is None:
            raise RuntimeError("call build(graph) before run()")
        total = self.config.num_iters if num_iters is None else num_iters
        tol = self.config.tol
        rb = self.config.robustness
        self.health = {"rollbacks": 0, "first_bad_iteration": None}
        last_mass: Optional[float] = None
        while self.iteration < total:
            info = self.step()
            i = self.iteration
            reason = None
            if rb.health_checks:
                reason = _health_reason(info)
                if reason is None and rb.mass_tol is not None:
                    mass = self.rank_mass()
                    if not math.isfinite(mass):
                        reason = f"non-finite rank mass {mass!r}"
                    elif (last_mass is not None
                          and abs(mass - last_mass)
                          > rb.mass_tol * max(abs(last_mass), 1e-30)):
                        reason = (
                            f"rank mass drifted {last_mass!r} -> {mass!r} "
                            f"(> mass_tol={rb.mass_tol:g} per step)"
                        )
                    else:
                        last_mass = mass
            if reason is not None:
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
                self.health["rollbacks"] += 1
                last_mass = None  # re-baseline the drift check
                continue
            self.iteration = i + 1
            if on_iteration is not None:
                on_iteration(i, info)
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
