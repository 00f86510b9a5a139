"""Bounded admission + dynamic micro-batching + predictive shedding.

Copy of ``pagerank_tpu/serving/admission.py``.

The queue is the deadline-honesty mechanism: admission is
where "cannot finish" becomes a typed :class:`~pagerank_tpu_torch.serving.
query.Overloaded` rejection with a retry-after hint, instead of a
query that times out deep in the pipeline. Two rules, both decided on
the injectable clock so the chaos harness replays them bit-for-bit:

- **shed NOW, not later**: a query is admitted only when the modeled
  wait (batches ahead of it x the modeled batch wall) plus one batch
  wall fits inside its remaining deadline;
- **batch close**: a batch closes at ``max_batch`` OR when the OLDEST
  queued query's remaining deadline margin is down to one modeled
  batch wall + ``batch_margin_s`` — whichever comes first.

Concurrency (PTR rules): one ``threading.Condition`` guards every
mutable field; the dispatcher blocks in :meth:`next_batch` (the wait
releases the lock), submitters never block. No raw clock calls — the
clock is injected (PTR006).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.serving.query import (Draining, Overloaded,
                                        PendingQuery)


class BatchWallModel:
    """EWMA model of one compiled batch's wall seconds — the quantity
    the shedding rule multiplies queue depth by. ``alpha=0`` freezes
    the model at ``initial_s`` (the chaos harness's determinism knob:
    admission decisions become a pure function of the seed)."""

    def __init__(self, initial_s: float = 0.2, alpha: float = 0.3,
                 floor_s: float = 1e-4):
        self.alpha = float(alpha)
        self.floor_s = float(floor_s)
        self._estimate = max(float(initial_s), self.floor_s)
        self._lock = threading.Lock()

    def observe(self, wall_s: float) -> None:
        if self.alpha <= 0.0:
            return
        wall_s = max(float(wall_s), self.floor_s)
        with self._lock:
            self._estimate = (
                (1.0 - self.alpha) * self._estimate + self.alpha * wall_s
            )

    def estimate(self) -> float:
        with self._lock:
            return self._estimate


class ClosedBatch(list):
    """One closed batch of :class:`PendingQuery`. A plain list (every
    existing consumer indexes/iterates it unchanged) that additionally
    carries WHY it closed — 'full' / 'deadline' / 'drain' — so the
    query plane can attribute batch-wait tails to the close policy
    instead of discarding the reason at the pop."""

    __slots__ = ("close_reason",)

    def __init__(self, queries, close_reason: str):
        super().__init__(queries)
        self.close_reason = close_reason


class AdmissionQueue:
    """Bounded FIFO of :class:`PendingQuery` with micro-batch close.

    ``submit``-side API: :meth:`offer` (typed rejections, never
    blocks). Dispatcher-side: :meth:`next_batch` (blocking, daemon
    mode) / :meth:`try_close_batch` (non-blocking, harness pump).
    Drain-side: :meth:`close` then :meth:`flush_rejected`."""

    def __init__(
        self,
        max_batch: int = 8,
        queue_depth: int = 64,
        batch_margin_s: float = 0.05,
        wall_model: Optional[BatchWallModel] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.max_batch = int(max_batch)
        self.queue_depth = int(queue_depth)
        self.batch_margin_s = float(batch_margin_s)
        self.wall_model = wall_model or BatchWallModel()
        self._clock = clock
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._closed = False
        self._stopped = False
        self._in_flight = 0  # batches currently executing
        self._depth_gauge = obs_metrics.gauge(
            "serve.queue_depth", "admitted queries waiting in a batch"
        )

    # -- submit side --------------------------------------------------------

    def offer(self, q: PendingQuery) -> None:
        """Admit ``q`` or raise a typed rejection (never blocks, never
        silently drops). The predictive shed rule:
        queue depth x modeled batch wall vs remaining deadline."""
        wall = self.wall_model.estimate()
        with self._cond:
            if self._closed:
                raise Draining(
                    "admission closed: the daemon is draining "
                    "(SIGTERM); retry against another replica"
                )
            now = self._clock()
            remaining = q.deadline - now
            if len(self._queue) >= self.queue_depth:
                raise Overloaded(
                    f"queue full ({self.queue_depth} queued)",
                    retry_after_s=wall,
                )
            # Batches that must complete before q's own: everything
            # queued ahead of it (including itself) plus any batch
            # already executing on the mesh.
            batches_ahead = (
                -(-(len(self._queue) + 1) // self.max_batch)
                + self._in_flight
            )
            predicted = batches_ahead * wall
            if predicted > remaining:
                raise Overloaded(
                    f"predicted wait {predicted:.3f}s exceeds remaining "
                    f"deadline {remaining:.3f}s "
                    f"({batches_ahead} batch(es) x {wall:.3f}s modeled "
                    "wall)",
                    retry_after_s=max(wall, predicted - remaining),
                )
            self._queue.append(q)
            self._depth_gauge.set(len(self._queue))
            self._cond.notify_all()

    # -- dispatcher side ----------------------------------------------------

    def _close_reason(self, now: float) -> Optional[str]:
        """Why a batch should close NOW ('full' / 'deadline' /
        'drain'), or None to keep accumulating. Callers already hold
        the condition; its RLock makes the re-entry free — and keeps
        every state access lexically guarded (PTR001)."""
        with self._cond:
            if not self._queue:
                return None
            if len(self._queue) >= self.max_batch:
                return "full"
            oldest = self._queue[0]
            margin = self.wall_model.estimate() + self.batch_margin_s
            if oldest.deadline - now <= margin:
                return "deadline"
            if self._closed:
                # Draining: no more arrivals will ever top this batch up.
                return "drain"
            return None

    def _pop_batch(self, reason: str) -> ClosedBatch:
        with self._cond:
            batch = []
            while self._queue and len(batch) < self.max_batch:
                batch.append(self._queue.popleft())
            self._depth_gauge.set(len(self._queue))
            self._in_flight += 1
            return ClosedBatch(batch, reason)

    def try_close_batch(self) -> Optional[ClosedBatch]:
        """Non-blocking close check (the harness pump / drain loop)."""
        with self._cond:
            reason = self._close_reason(self._clock())
            if reason is None:
                return None
            return self._pop_batch(reason)

    def next_batch(self, poll_s: float = 0.05
                   ) -> Optional[ClosedBatch]:
        """Block until a batch closes (daemon dispatcher loop); None
        once :meth:`stop` was called and the queue is empty. The wait
        is bounded by the time to the oldest query's close point, so
        a deadline-driven close fires without a new arrival."""
        with self._cond:
            while True:
                now = self._clock()
                reason = self._close_reason(now)
                if reason is not None:
                    return self._pop_batch(reason)
                if self._stopped and not self._queue:
                    return None
                timeout = poll_s
                if self._queue:
                    oldest = self._queue[0]
                    margin = (self.wall_model.estimate()
                              + self.batch_margin_s)
                    timeout = min(
                        poll_s, max(0.0, (oldest.deadline - margin) - now)
                    )
                self._cond.wait(timeout if timeout > 0 else poll_s)

    def batch_done(self) -> None:
        with self._cond:
            self._in_flight = max(0, self._in_flight - 1)
            self._cond.notify_all()

    # -- drain side ---------------------------------------------------------

    def close(self) -> None:
        """Stop admitting (subsequent offers raise Draining); queued
        work remains servable."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def stop(self) -> None:
        """close() + let next_batch return None once empty — the
        dispatcher thread's shutdown signal."""
        with self._cond:
            self._closed = True
            self._stopped = True
            self._cond.notify_all()

    def flush_rejected(self, error_factory) -> int:
        """Typed-reject everything still queued (the drain deadline
        ran out); returns the count. ``error_factory(q)`` builds the
        typed error per query."""
        with self._cond:
            flushed = list(self._queue)
            self._queue.clear()
            self._depth_gauge.set(0)
        now = self._clock()
        for q in flushed:
            q.reject(error_factory(q), now)
        return len(flushed)

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed
