"""Typed queries and outcomes for the PPR serving layer.

Copy of ``pagerank_tpu/serving/query.py``.

Every query submitted to the daemon ends in exactly ONE of the typed
terminal states below — the query-outcome state machine
(docs/ROBUSTNESS.md "Serving"). There is no silent drop: an accepted
query either resolves with a result or is rejected with a typed error
that names the policy that rejected it.

    submit ──► REJECTED_OVERLOAD   (Overloaded: predictive shed or
      │                             queue full; carries retry-after)
      │    ──► REJECTED_DRAINING   (Draining: admission closed by the
      │                             SIGTERM drain)
      ▼
    ANSWERED_CACHE                 (LRU hit at admission; never queued)
      │
    queued ──► ANSWERED            (batch computed on the mesh;
      │                             possibly after an elastic rescue —
      │                             ``degraded`` marks those)
      └────► REJECTED_DEADLINE     (QueryDeadlineExceeded: the deadline
                                    passed in-queue, or the bounded
                                    dispatch timed out)
"""

from __future__ import annotations

import threading
from typing import Optional


class ServeRejected(RuntimeError):
    """Base of every typed serving rejection. ``outcome`` is the
    stable machine-readable label the harness / HTTP layer report."""

    outcome = "rejected"


class Overloaded(ServeRejected):
    """Admission refused NOW because the query provably cannot finish:
    queue full, or queue depth x modeled batch wall exceeds the
    query's remaining deadline (predictive shed — never accept work
    that cannot finish). ``retry_after_s`` is the earliest point a
    retry with the same deadline could plausibly be admitted."""

    outcome = "shed_overload"

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class Draining(ServeRejected):
    """Admission is closed: the daemon received SIGTERM and is draining
    (docs/ROBUSTNESS.md "Graceful drain"). In-flight batches still
    finish; new work must go to another replica."""

    outcome = "rejected_draining"


class QueryDeadlineExceeded(ServeRejected):
    """The query's deadline passed before a result existed — either
    in-queue (a drain or rescue consumed its margin) or because the
    deadline-bounded device dispatch (``mesh.run_with_deadline``)
    timed out. The queue keeps moving; the query fails typed."""

    outcome = "rejected_deadline"


class PendingQuery:
    """One admitted query: the handle ``submit`` returns.

    Cross-thread discipline (PTR001): the dispatcher thread resolves,
    the submitting thread reads — every mutable field access happens
    under ``_lock``, and :meth:`result` blocks on the ``_done`` event
    (a sync primitive) outside any lock."""

    __slots__ = ("qid", "source", "k", "deadline", "t_submit",
                 "_lock", "_done", "_ids", "_scores", "_error",
                 "_served_from", "_latency_s", "trace", "_trace_id")

    def __init__(self, qid: int, source: int, k: int, deadline: float,
                 t_submit: float):
        self.qid = int(qid)
        self.source = int(source)
        self.k = int(k)
        self.deadline = float(deadline)  # absolute, on the server clock
        self.t_submit = float(t_submit)
        # Query plane: None while disarmed — every tracing
        # call site gates on it, so the hot path pays one attr read.
        self.trace = None
        self._trace_id: Optional[str] = None
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._ids = None
        self._scores = None
        self._error: Optional[ServeRejected] = None
        self._served_from = ""
        self._latency_s: Optional[float] = None

    # -- dispatcher side ----------------------------------------------------

    def resolve(self, ids, scores, served_from: str, now: float) -> None:
        with self._lock:
            self._ids = ids
            self._scores = scores
            self._served_from = served_from
            self._latency_s = max(0.0, now - self.t_submit)
        self._done.set()

    def reject(self, error: ServeRejected, now: float) -> None:
        with self._lock:
            self._error = error
            self._latency_s = max(0.0, now - self.t_submit)
        self._done.set()

    # -- caller side --------------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        """``(ids, scores)`` once resolved; raises the typed rejection
        otherwise. ``TimeoutError`` only if the daemon never settled
        the query within ``timeout`` — which the zero-silent-drops
        contract makes a bug, not an outcome."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query {self.qid} unsettled after {timeout}s — the "
                "serving layer guarantees a typed terminal state"
            )
        with self._lock:
            if self._error is not None:
                raise self._error
            return self._ids, self._scores

    @property
    def trace_id(self) -> str:
        """Stable W3C-shaped trace id: the caller's ``traceparent``
        override when one arrived, else a deterministic function of
        the qid (``qid+1`` as 32 hex digits — never the spec's
        all-zero invalid value). A plain property read: no tracer or
        plane call, so every typed outcome carries an id even with
        the query plane disarmed."""
        if self._trace_id is not None:
            return self._trace_id
        return format(self.qid + 1, "032x")

    def set_trace_id(self, trace_id: str) -> None:
        """Adopt an upstream trace id (the HTTP ``traceparent``)."""
        self._trace_id = trace_id

    @property
    def outcome(self) -> str:
        """Terminal state label ('' while pending)."""
        if not self._done.is_set():
            return ""
        with self._lock:
            if self._error is not None:
                return self._error.outcome
            return ("answered_cache" if self._served_from == "cache"
                    else "answered_degraded"
                    if self._served_from == "degraded" else "answered")

    @property
    def served_from(self) -> str:
        with self._lock:
            return self._served_from

    @property
    def latency_s(self) -> Optional[float]:
        with self._lock:
            return self._latency_s

    def error(self) -> Optional[ServeRejected]:
        with self._lock:
            return self._error
