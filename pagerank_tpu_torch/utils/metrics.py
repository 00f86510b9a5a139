"""Structured per-iteration metrics (SURVEY.md §5: the reference's entire
observability is one println per iteration, Sparky.java:188).

Copy of ``pagerank_tpu/utils/metrics.py`` (``oracle_l1``,
``MetricsLogger`` with the live exporter's gauge hook, :104).

Logs iter, L1 delta, dangling mass, wall-clock, iters/sec and
edges/sec/chip — the BASELINE.json metrics — to stderr and optionally a
JSONL file.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Dict, Optional, TextIO

from pagerank_tpu_torch.obs import live as obs_live
from pagerank_tpu_torch.utils import fsio


def oracle_l1(r, r_ref):
    """(raw L1, raw normalized L1, mass-normalized L1) between a rank
    vector and an oracle's. The raw and mass-normalized numbers can
    diverge only through a global-scale error, so reporting both keeps
    that error class visible; the mass-normalized number carries the
    relative structure PageRank defines."""
    import numpy as np

    r = np.asarray(r, dtype=np.float64)
    r_ref = np.asarray(r_ref, dtype=np.float64)
    l1 = float(np.abs(r - r_ref).sum())
    norm = l1 / float(np.abs(r_ref).sum())
    mass = float(np.abs(r / r.sum() - r_ref / r_ref.sum()).sum())
    return l1, norm, mass


class MetricsLogger:
    """Per-iteration logger; use as the engine's ``on_iteration`` hook."""

    def __init__(
        self,
        num_edges: int,
        num_chips: int = 1,
        log_every: int = 1,
        jsonl_path: Optional[str] = None,
        stream: Optional[TextIO] = None,
    ):
        self.num_edges = num_edges
        self.num_chips = max(1, num_chips)
        self.log_every = log_every
        self.stream = stream if stream is not None else sys.stderr
        self._jsonl = fsio.fopen(jsonl_path, "a") if jsonl_path else None
        self._t_last = time.perf_counter()
        self.history = []

    def __call__(self, iteration: int, info: Dict[str, float]) -> None:
        now = time.perf_counter()
        dt = now - self._t_last
        self._t_last = now
        self.record(iteration, info, dt)

    def record(self, iteration: int, info: Dict[str, float],
               dt: float, timing: Optional[str] = None) -> None:
        """Log one iteration with explicit wall-clock ``dt`` — for runs
        where per-iteration timing is an average over several steps
        rather than measured per call. Pass ``timing="averaged"`` there
        so JSONL consumers can tell the two apart."""
        # A zero/negative dt (clock granularity on a trivial graph)
        # yields null rates, NOT float("inf"): json.dumps writes inf as
        # a bare ``Infinity`` token, which is not JSON — strict JSONL
        # consumers (json.loads with parse_constant raising) choke on
        # the whole line.
        rec = {
            "iter": iteration,
            "seconds": dt,
            "iters_per_sec": (1.0 / dt) if dt > 0 else None,
            "edges_per_sec_per_chip": self.num_edges / dt / self.num_chips
            if dt > 0
            else None,
        }
        if timing is not None:
            rec["timing"] = timing
        # rank_mass / topk_churn appear on probe iterations only.
        for k in ("l1_delta", "dangling_mass", "rank_mass"):
            if k in info:
                # Non-finite step info (a diverging solve under
                # --no-health-checks) is encoded as null too — NaN is
                # no more a JSON token than Infinity is.
                v = float(info[k])
                rec[k] = v if math.isfinite(v) else None
        if "topk_churn" in info:
            rec["topk_churn"] = int(info["topk_churn"])
        self.history.append(rec)
        # Mirror the headline scalars into registry gauges and the
        # step-seconds histogram: the live exporter's (obs/live.py)
        # per-iteration feed; plain in-GIL arithmetic, no I/O.
        obs_live.update_solve_gauges(iteration, rec, dt)
        if self._jsonl:
            # allow_nan=False: any non-finite float reaching the dump
            # is a bug in the sanitizing above — fail loudly rather
            # than emitting a non-spec line.
            self._jsonl.write(json.dumps(rec, allow_nan=False) + "\n")
            self._jsonl.flush()
        if self.log_every and iteration % self.log_every == 0:
            parts = [f"iter {iteration}", f"{dt * 1e3:.1f} ms"]
            if rec.get("l1_delta") is not None:
                parts.append(f"l1_delta {rec['l1_delta']:.3e}")
            if rec.get("dangling_mass") is not None:
                parts.append(f"mass {rec['dangling_mass']:.6g}")
            eps = rec["edges_per_sec_per_chip"]
            if eps is not None:
                parts.append(f"{eps:.3g} edges/s/chip")
            print("  ".join(parts), file=self.stream)

    def summary(
        self,
        iters: Optional[int] = None,
        total_seconds: Optional[float] = None,
    ) -> Dict[str, float]:
        """Aggregate stats. By default both the iteration count and the
        wall-clock are inferred from the per-call history; fused tol
        runs (one record for a dynamic trip count) pass the true
        ``iters`` and ``total_seconds`` explicitly instead.

        Consistent across paths: ``iters`` is the
        count of EXECUTED iterations in both forms, and ``timed_iters``
        is how many fed the means — the stepwise form excludes the
        compile iteration 0 from timing whenever more than one record
        exists (so there ``timed_iters == iters - 1``), while fused
        forms time every executed iteration. Consumers comparing modes
        should divide by ``timed_iters``."""
        if iters is not None:
            if iters <= 0 or not total_seconds:
                return {}
            return {
                "iters": iters,
                "timed_iters": iters,
                "mean_iter_seconds": total_seconds / iters,
                "iters_per_sec": iters / total_seconds,
                "edges_per_sec_per_chip":
                    self.num_edges * iters / total_seconds / self.num_chips,
            }
        if not self.history:
            return {}
        # Skip iteration 0 (compile) when there are enough samples.
        hist = self.history[1:] if len(self.history) > 1 else self.history
        total = sum(h["seconds"] for h in hist)
        n = len(hist)
        return {
            "iters": len(self.history),
            "timed_iters": n,
            "mean_iter_seconds": total / n,
            # Same discipline as record(): a degenerate zero wall-clock
            # reports null rates, never Infinity (the summary is embedded
            # verbatim in run_report.json, which is strict JSON).
            "iters_per_sec": n / total if total > 0 else None,
            "edges_per_sec_per_chip": self.num_edges * n / total / self.num_chips
            if total > 0
            else None,
        }

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
