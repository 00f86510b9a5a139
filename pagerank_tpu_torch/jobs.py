"""Graceful drain on SIGTERM/SIGINT: ``GracefulDrain`` and
``DrainInterrupt``, copied from ``pagerank_tpu/jobs.py:75-88, 306-447``
for the serve entry point. The stage machine, its durable artifacts
and process chaos (the rest of that module) come with ROADMAP slice 7.

SIGTERM/SIGINT handlers installed only around an entry point request a
deadline-bounded drain; the run notices at its next safe point and the
process exits :data:`~pagerank_tpu_torch.exitcodes.ExitCode.INTERRUPTED`.
A second signal hard-exits ``128 + signum`` immediately. Library
modules stay handler-free for embeddability.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Dict, Optional, Tuple

from pagerank_tpu_torch.exitcodes import hard_exit_code
from pagerank_tpu_torch.obs import log as obs_log
from pagerank_tpu_torch.obs import metrics as obs_metrics

#: Default drain deadline (seconds): GCE preemption notice is 30 s; the
#: drain must flush inside it or give up the slower sinks.
DEFAULT_DRAIN_DEADLINE_S = 20.0


class DrainInterrupt(BaseException):
    """Raised at a safe point (stage boundary / completed iteration)
    after a drain request. A BaseException on purpose: no best-effort
    ``except Exception`` site (SinkGuard, telemetry exporters) may ever
    swallow a preemption — the PTL006 discipline applied to signals."""

    def __init__(self, signum: int, where: str = ""):
        super().__init__(
            f"drain requested by signal {signum}"
            + (f" (at {where})" if where else "")
        )
        self.signum = signum
        self.where = where


class GracefulDrain:
    """SIGTERM/SIGINT -> deadline-bounded drain request (the tentpole's
    preemption half). Context manager; install ONLY around the CLI
    entry point — library modules must stay handler-free (PTL008).

    First signal: records the request (``job.drain_requests`` counter,
    loud log line) and returns — the run notices at its next safe
    point (:meth:`check` raises :class:`DrainInterrupt` there). Second
    signal: hard-exits ``128 + signum`` immediately via the injectable
    ``hard_exit`` (``os._exit`` by default — no flush, the operator
    asked twice).

    Injectable for tests: ``install`` (defaults to ``signal.signal``),
    ``hard_exit``, and ``clock``. Installation degrades to a no-op
    (with a log line) off the main thread, where CPython refuses
    handlers — an embedded library use keeps working, just without
    drain."""

    def __init__(
        self,
        deadline_s: float = DEFAULT_DRAIN_DEADLINE_S,
        signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT),
        install=signal.signal,
        hard_exit=os._exit,
        clock=time.monotonic,
    ):
        self.deadline_s = float(deadline_s)
        self._signals = tuple(signals)
        self._install = install
        self._hard_exit = hard_exit
        self._clock = clock
        self._prev: Dict[int, object] = {}
        self._installed = False
        self.requested = False
        self.signum: Optional[int] = None
        self._t_request: Optional[float] = None
        # Pre-allocated handler flag: the handler may only SET simple
        # scalars (PTR003); the counter/log emission it used to do
        # in-handler is deferred to the next safe point.
        self._pending_note = False

    # -- handler lifecycle --------------------------------------------------

    def __enter__(self) -> "GracefulDrain":
        for s in self._signals:
            try:
                self._prev[s] = self._install(s, self._handler)
            except ValueError as e:
                # Non-main thread: CPython refuses handlers. Degrade —
                # embedded callers keep working without drain.
                obs_log.info(
                    f"signal handlers unavailable ({e}); preemption "
                    "drain disabled for this run"
                )
                break
        else:
            self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            try:
                self._install(s, prev)
            except ValueError:
                pass
        self._prev.clear()
        self._installed = False

    def _handler(self, signum, frame) -> None:
        """Signal-handler context (PTR003, docs/ANALYSIS.md): this body
        may only set pre-allocated flags/simple scalars. CPython runs
        handlers ON THE MAIN THREAD between bytecodes — a handler that
        takes a lock (the pre-fix ``obs_log.warn`` reached the
        tracer's ``add_event`` lock, and the registry get-or-create
        takes the registry lock) self-deadlocks the moment the signal
        lands while the main thread holds that lock. Telemetry is
        deferred to :meth:`_note_request` at the next safe point;
        ``hard_exit`` (``os._exit``) is the sanctioned exception — the
        operator asked twice."""
        if self.requested:
            # Second signal: the operator means NOW.
            self._hard_exit(hard_exit_code(signum))
            return  # injectable hard_exit may not exit (tests)
        self.requested = True
        self.signum = int(signum)
        self._t_request = self._clock()
        self._pending_note = True

    def _note_request(self) -> None:
        """Emit the drain request's counter + log line OUTSIDE handler
        context — called from every drain-side entry point (check /
        remaining / finish), so the first safe point after the signal
        reports it exactly once."""
        if not self._pending_note:
            return
        self._pending_note = False
        obs_metrics.counter(
            "job.drain_requests",
            "graceful-drain requests received (first SIGTERM/SIGINT)",
        ).inc()
        obs_log.warn(
            f"signal {self.signum}: draining (deadline "
            f"{self.deadline_s:g}s; a second signal hard-exits)"
        )

    # -- drain-side API -----------------------------------------------------

    def check(self, where: str = "") -> None:
        """Raise :class:`DrainInterrupt` when a drain was requested —
        call at safe points only (stage boundaries, completed
        iterations): the in-flight step always finishes."""
        if self.requested:
            self._note_request()
            raise DrainInterrupt(self.signum or 0, where)

    def remaining(self) -> Optional[float]:
        """Seconds left of the drain deadline (None before a request,
        never below a small positive floor so bounded flushes still
        get one attempt)."""
        if self._t_request is None:
            return None
        self._note_request()
        left = self.deadline_s - (self._clock() - self._t_request)
        return max(0.5, left)

    def finish(self) -> float:
        """Record the drain's wall (request -> flushes done) in the
        ``job.drain_seconds`` gauge; returns it."""
        self._note_request()
        spent = (
            self._clock() - self._t_request
            if self._t_request is not None else 0.0
        )
        obs_metrics.gauge(
            "job.drain_seconds",
            "wall seconds between the drain request and the final "
            "flush",
        ).set(spent)
        return spent
