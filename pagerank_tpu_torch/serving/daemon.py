"""The resident PPR query daemon.

Port of ``pagerank_tpu/serving/daemon.py`` over
:class:`~pagerank_tpu_torch.engines.ppr.PprTorchEngine`. :class:`PprServer`
owns a resident graph and one engine whose K1w launcher is bound at
``max_batch`` columns by the ``start()`` warm-up, which builds the
kernel first if need be (the JAX daemon's AOT compile and its
``compile_cache`` have no counterpart: ``kernels/build.py`` caches the
built library under ``build/kernels/``). A dispatched batch runs only
its live sources: one K1w launch an iteration over its live columns, at
most ``max_batch``, with static ``num_iters``/``topk``, so no query
ever waits on a build or a bind. The JAX daemon pads every batch to
``max_batch`` to keep one compiled shape; here the launcher takes the
live column count per call, so padding would only add columns (a
column's answer does not depend on its batch-mates): a lone query is
one launch of a 4-column tile an iteration.
Top-k runs on the device — only ``[batch, k]`` leaves the card.

Failure modes map to typed, bounded, observable outcomes:

- **overload**: decided at admission by :class:`~pagerank_tpu_torch.serving.
  admission.AdmissionQueue` (typed ``Overloaded`` with retry-after);
- **device loss / sticky-SDC quarantine** mid-serve: the elastic
  rescue — probe liveness, rebuild onto the survivors
  (``mesh.surviving_devices`` + a rebuilt engine), RE-RUN the
  in-flight batch. Counted (``serve.rescues``, ``serve.batch_reruns``)
  and never silently dropped; subsequent answers are marked
  ``degraded``. On one card nothing survives a loss:
  ``surviving_devices`` raises and the error leaves the dispatch (the
  JAX daemon's terminal path);
- **SIGTERM**: the drain — :meth:`drain` closes admission
  (typed ``Draining`` rejections), in-flight batches finish inside the
  drain deadline, the rest are typed-rejected, exit 75 at the CLI;
- **stuck dispatch**: bounded by ``mesh.run_with_deadline`` — the
  batch fails typed (``QueryDeadlineExceeded``) instead of hanging the
  queue.

Concurrency (PTR rules): the admission queue's Condition is the
cross-thread meeting point; server-side mutable state (engine,
devices, degraded flag) lives behind ``_state_lock`` and is only
written by the dispatch context. Blocking work (device dispatch,
``run_with_deadline``) happens outside every lock (PTR004). The
dispatcher thread is named and joined (PTR005); clocks are injected
(PTR006). The engine makes its device current in whichever thread
launches (the dispatcher, ``run_with_deadline``'s worker).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

import torch

from pagerank_tpu_torch.engines.ppr import PprTorchEngine
from pagerank_tpu_torch.engines.torch_engine import resolve_device
from pagerank_tpu_torch.graph import Graph
from pagerank_tpu_torch.models import ppr as ppr_model
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.parallel import mesh as mesh_lib
from pagerank_tpu_torch.parallel.elastic import (DeviceLostError,
                                           ElasticExhaustedError,
                                           looks_like_device_loss)
from pagerank_tpu_torch.serving import qtrace
from pagerank_tpu_torch.serving.admission import AdmissionQueue, BatchWallModel
from pagerank_tpu_torch.serving.cache import ResultCache
from pagerank_tpu_torch.serving.query import (Draining, PendingQuery,
                                        QueryDeadlineExceeded,
                                        ServeRejected)
from pagerank_tpu_torch.utils.config import PageRankConfig


@dataclass
class ServeConfig:
    """Knobs of the serving layer (engine numerics stay in
    :class:`PageRankConfig`)."""

    max_batch: int = 8           # bound batch width (the most columns)
    queue_depth: int = 64        # bounded admission
    deadline_ms: float = 500.0   # default per-query deadline
    topk: int = 100              # static on-device top-k width
    num_iters: Optional[int] = None   # None -> engine config's
    batch_margin_s: float = 0.02      # close-early margin before oldest deadline
    dispatch_timeout_s: float = 30.0  # run_with_deadline bound per batch
    drain_deadline_s: float = 5.0     # SIGTERM drain budget
    cache_capacity: int = 1024        # 0 disables the LRU
    wall_initial_s: float = 0.05      # batch wall model prior
    wall_alpha: float = 0.3           # EWMA weight; 0 freezes (determinism)
    max_rescues: int = 2              # elastic rescue budget while serving
    probe_timeout_s: float = 2.0      # liveness probe bound during rescue

    def validate(self) -> "ServeConfig":
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {self.deadline_ms}"
            )
        if self.topk < 1:
            raise ValueError(f"topk must be >= 1, got {self.topk}")
        return self


class PprServer:
    """Deadline-honest PPR query daemon over a resident sharded graph.

    Two drive modes share every code path except the thread:

    - ``start()`` (daemon): a named dispatcher thread blocks in
      ``AdmissionQueue.next_batch`` and serves batches as they close;
    - ``start(dispatcher=False)`` + :meth:`pump` (synchronous): the
      caller advances batches explicitly — the deterministic chaos
      harness's mode (``testing/load.py``).

    ``devices`` is a list of torch devices, ``[cuda:0]`` by default
    (``["cpu"]`` runs the plain versions on the host).
    ``engine_factory(devices)`` must return a built engine over
    exactly ``devices``; the default builds :class:`PprTorchEngine`
    with ``num_devices=len(devices)`` — more than one is ROADMAP slice
    6 — and the rescue path calls it again with the survivor list.
    ``liveness_probe(devices, timeout_s)`` defaults to
    ``mesh.probe_liveness``; tests inject their own so a CPU run sees
    the dead set a real device would report.
    """

    #: Batch walls kept in ``batch_walls`` (bounded for a long-lived
    #: daemon).
    BATCH_WALLS = 4096

    def __init__(
        self,
        graph: Graph,
        config: Optional[PageRankConfig] = None,
        serve_config: Optional[ServeConfig] = None,
        dangling_to: str = ppr_model.DANGLING_TO_SOURCE,
        devices: Optional[Sequence] = None,
        engine_factory: Optional[Callable[[Sequence], PprTorchEngine]] = None,
        liveness_probe: Optional[Callable] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.graph = graph
        self.config = (config or PageRankConfig()).validate()
        self.serve_config = (serve_config or ServeConfig()).validate()
        self.dangling_to = dangling_to
        self._clock = clock
        self._engine_factory = engine_factory or self._default_factory
        self._liveness_probe = liveness_probe or mesh_lib.probe_liveness

        sc = self.serve_config
        self.wall_model = BatchWallModel(
            initial_s=sc.wall_initial_s, alpha=sc.wall_alpha
        )
        self.queue = AdmissionQueue(
            max_batch=sc.max_batch,
            queue_depth=sc.queue_depth,
            batch_margin_s=sc.batch_margin_s,
            wall_model=self.wall_model,
            clock=clock,
        )
        self.cache = ResultCache(capacity=sc.cache_capacity)

        # Engine / mesh state crosses the submit and dispatch contexts:
        # every non-construction access goes through _state_lock.
        self._state_lock = threading.Lock()
        self._engine: Optional[PprTorchEngine] = None
        self._devices: List = ([torch.device(d) for d in devices]
                               if devices is not None else [])
        self._degraded = False
        self._rescues_done = 0  # per-instance budget (counters are global)
        self._fatal: Optional[BaseException] = None
        self._started = False
        self._dispatcher: Optional[threading.Thread] = None
        self.warmup_seconds: Optional[float] = None
        #: Dispatch wall of each answered batch, oldest first (the
        #: first ``BATCH_WALLS`` batches).
        self.batch_walls: List[float] = []
        self._graph_fp = graph.fingerprint()
        self._params_key = (
            self._iters(), self.config.damping,
            str(self.config.dtype), str(self.config.accum_dtype),
            dangling_to,
        )

        self._qid_lock = threading.Lock()
        self._next_qid = 0

        c = obs_metrics.counter
        self._c_accepted = c("serve.accepted", "queries admitted to the queue")
        self._c_answered = c("serve.answered", "queries resolved with a result")
        self._c_answered_cache = c(
            "serve.answered_cache", "queries resolved from the LRU at admission"
        )
        self._c_answered_degraded = c(
            "serve.answered_degraded", "queries answered on a degraded mesh"
        )
        self._c_shed = c(
            "serve.shed_overload", "typed Overloaded rejections at admission"
        )
        self._c_rej_draining = c(
            "serve.rejected_draining", "typed Draining rejections"
        )
        self._c_rej_deadline = c(
            "serve.rejected_deadline", "typed deadline rejections"
        )
        self._c_batches = c("serve.batches", "batches dispatched to the mesh")
        self._c_reruns = c(
            "serve.batch_reruns", "in-flight batches re-run after a rescue"
        )
        self._c_rescues = c("serve.rescues", "elastic rescues while serving")
        self._c_devices_lost = c(
            "serve.devices_lost", "devices lost or quarantined while serving"
        )
        self._c_dispatch_timeouts = c(
            "serve.dispatch_timeouts", "batches killed by run_with_deadline"
        )
        self._g_occupancy = obs_metrics.gauge(
            "serve.occupancy", "fill fraction of the last dispatched batch"
        )
        self._g_devices = obs_metrics.gauge(
            "serve.devices", "current mesh width"
        )
        self._h_latency = obs_metrics.histogram(
            "serve.latency_ms", "submit-to-resolve latency per answered query"
        )

    # -- lifecycle ----------------------------------------------------------

    def _default_factory(self, devices: Sequence) -> PprTorchEngine:
        cfg = self.config.replace(num_devices=len(devices))
        eng = PprTorchEngine(
            cfg, dangling_to=self.dangling_to, device=devices[0]
        )
        eng.build(self.graph)
        return eng

    def start(self, dispatcher: bool = True) -> "PprServer":
        """Build the engine, warm it at the serving shapes (the kernel
        built and K1w bound at ``max_batch``), then (daemon mode) start
        the named dispatcher thread. ``warmup_seconds`` holds the
        warm-up's wall, engine build included."""
        t0 = self._clock()
        with self._state_lock:
            if self._started:
                raise RuntimeError("PprServer.start() called twice")
            if not self._devices:
                self._devices = [resolve_device(None)]
            devices = list(self._devices)
        engine = self._engine_factory(devices)
        with self._state_lock:
            self._engine = engine
            self._started = True
        self._g_devices.set(len(devices))
        # Warm the exact serving shapes (full-width batch, static
        # iters/topk) so no query ever pays the build or the bind.
        self._execute(np.zeros(self.serve_config.max_batch, np.int64))
        self.warmup_seconds = self._clock() - t0
        if dispatcher:
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop,
                name="pagerank-serve-dispatch",
            )
            self._dispatcher.start()
        return self

    def _iters(self) -> int:
        sc = self.serve_config
        return (self.config.num_iters if sc.num_iters is None
                else sc.num_iters)

    @property
    def degraded(self) -> bool:
        with self._state_lock:
            return self._degraded

    @property
    def fatal(self) -> Optional[BaseException]:
        with self._state_lock:
            return self._fatal

    @property
    def device_count(self) -> int:
        with self._state_lock:
            return len(self._devices)

    @property
    def rescues_done(self) -> int:
        with self._state_lock:
            return self._rescues_done

    def device_ids(self) -> List[int]:
        with self._state_lock:
            return [mesh_lib.device_id(d) for d in self._devices]

    # -- submit side --------------------------------------------------------

    def submit(self, source: int, k: Optional[int] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None) -> PendingQuery:
        """Admit one query. ALWAYS returns a :class:`PendingQuery` —
        rejections settle the handle with the typed error instead of
        raising here, so every submission has exactly one terminal
        outcome to account for (the zero-silent-drops ledger).
        ``trace_id`` adopts an upstream W3C trace id (the HTTP
        ``traceparent``); every outcome carries ``q.trace_id`` either
        way, armed or not."""
        with self._state_lock:
            started = self._started
        if not started:
            raise RuntimeError("call start() before submit()")
        sc = self.serve_config
        k = sc.topk if k is None else min(int(k), sc.topk)
        k = max(1, min(k, self.graph.n))
        if deadline_s is None:
            deadline_s = sc.deadline_ms / 1000.0
        now = self._clock()
        with self._qid_lock:
            qid = self._next_qid
            self._next_qid += 1
        q = PendingQuery(qid=qid, source=int(source), k=k,
                         deadline=now + deadline_s, t_submit=now)
        if trace_id is not None:
            q.set_trace_id(trace_id)
        # Query plane: tr stays None while disarmed, and
        # every tracing branch below gates on it — the disarmed hot
        # path is byte-identical to the untraced one (booby-trap test).
        plane = qtrace.get_query_plane()
        tr = None
        if plane is not None:
            tr = q.trace = plane.new_trace(
                q.qid, q.source, q.trace_id, start_s=now
            )

        # Publish-last ordering (also below, in _serve_batch): settle
        # the trace BEFORE resolve()/reject() set the done event, so
        # the awakened caller thread can never observe — or touch — a
        # trace mid-settle (qtrace's happens-before contract).
        key = ResultCache.key(self._graph_fp, q.source, self._params_key, k)
        if tr is not None:
            t_c0 = self._clock()
        hit = self.cache.get(key)
        if hit is not None:
            self._c_accepted.inc()
            self._c_answered_cache.inc()
            now2 = self._clock()
            lat_ms = 1000.0 * max(0.0, now2 - q.t_submit)
            if tr is not None:
                tr.phase("query/cache", t_c0, now2 - t_c0, hit=True)
                self._h_latency.record(lat_ms, trace_id=q.trace_id)
                plane.settle(tr, "answered_cache", now2, lat_ms)
            else:
                self._h_latency.record(lat_ms)
            q.resolve(hit[0], hit[1], "cache", now2)
            return q
        if tr is not None:
            tr.phase("query/cache", t_c0, self._clock() - t_c0, hit=False)
            t_a0 = self._clock()
        try:
            self.queue.offer(q)
        except Draining as e:
            self._c_rej_draining.inc()
            now2 = self._clock()
            if tr is not None:
                tr.phase("query/admission", t_a0, now2 - t_a0,
                         decision="rejected_draining")
                plane.settle(tr, "rejected_draining", now2,
                             1000.0 * max(0.0, now2 - q.t_submit))
            q.reject(e, now2)
            return q
        except ServeRejected as e:  # Overloaded
            self._c_shed.inc()
            now2 = self._clock()
            if tr is not None:
                tr.phase("query/admission", t_a0, now2 - t_a0,
                         decision="shed_overload")
                plane.settle(tr, "shed_overload", now2,
                             1000.0 * max(0.0, now2 - q.t_submit))
            q.reject(e, now2)
            return q
        self._c_accepted.inc()
        if tr is not None:
            now2 = self._clock()
            tr.phase("query/admission", t_a0, now2 - t_a0,
                     decision="admitted")
            tr.t_admitted = now2
        return q

    # -- dispatch side ------------------------------------------------------

    def _dispatch_loop(self) -> None:
        if qtrace.get_query_plane() is not None:
            from pagerank_tpu_torch.obs import trace as obs_trace
            obs_trace.get_tracer().set_thread_label(
                threading.get_ident(), "serve-dispatch"
            )
        while True:
            batch = self.queue.next_batch()
            if batch is None:
                return
            try:
                self._serve_batch(batch)
            finally:
                self.queue.batch_done()

    def pump(self, max_batches: Optional[int] = None) -> int:
        """Synchronously serve every closeable batch (harness mode);
        returns the number of batches dispatched."""
        served = 0
        while max_batches is None or served < max_batches:
            batch = self.queue.try_close_batch()
            if batch is None:
                return served
            try:
                self._serve_batch(batch)
            finally:
                self.queue.batch_done()
            served += 1
        return served

    def _execute(self, sources: np.ndarray):
        """One batch dispatch: ``[b] -> ([b, topk] ids, scores)``, b <=
        ``max_batch``. The fault harness wraps THIS seam — it
        survives an engine rebuild because the rescue path swaps
        ``_engine`` underneath it."""
        with self._state_lock:
            engine = self._engine
        res = engine.run(
            sources, num_iters=self._iters(),
            topk=self.serve_config.topk, chunk=self.serve_config.max_batch,
        )
        return res.topk_ids, res.topk_scores

    def _rescue(self, exc: BaseException) -> None:
        """Chip loss / quarantine mid-serve: classify the casualty,
        re-shard onto the survivors, swap the engine. Raises
        ``ElasticExhaustedError`` when the budget is spent."""
        with self._state_lock:
            devices = list(self._devices)
            rescues = self._rescues_done
        if rescues >= self.serve_config.max_rescues:
            raise ElasticExhaustedError(
                f"serving rescue budget spent ({rescues} rescues): {exc}",
                tuple(getattr(exc, "device_ids", ())), rescues,
            )
        dead = set(getattr(exc, "device_ids", ()) or ())
        alive = self._liveness_probe(
            devices, timeout_s=self.serve_config.probe_timeout_s
        )
        dead |= {i for i, ok in alive.items() if not ok}
        if not dead:
            raise exc  # loss-shaped but every device answers: surface it
        survivors = mesh_lib.surviving_devices(dead, devices=devices)
        engine = self._engine_factory(survivors)
        with self._state_lock:
            self._engine = engine
            self._devices = survivors
            self._degraded = True
            self._rescues_done += 1
        self._c_rescues.inc()
        self._c_devices_lost.inc(len(dead))
        self._g_devices.set(len(survivors))

    def _serve_batch(self, batch: List[PendingQuery]) -> None:
        sc = self.serve_config
        plane = qtrace.get_query_plane()
        close_reason = getattr(batch, "close_reason", None)
        now = self._clock()
        live = []
        for q in batch:
            if q.deadline <= now:
                self._c_rej_deadline.inc()
                tr = q.trace
                if tr is not None:
                    if tr.t_admitted is not None:
                        tr.phase("query/batch_wait", tr.t_admitted,
                                 now - tr.t_admitted,
                                 close_reason=close_reason, expired=True)
                    if plane is not None:
                        plane.settle(tr, "rejected_deadline", now,
                                     1000.0 * max(0.0, now - q.t_submit))
                q.reject(QueryDeadlineExceeded(
                    f"deadline passed in-queue "
                    f"({now - q.deadline:.3f}s late)"), now)
            else:
                live.append(q)
        if not live:
            return
        self._g_occupancy.set(len(live) / sc.max_batch)

        traced = [q for q in live if q.trace is not None]
        if traced:
            # Batch membership: every member's trace links to its
            # batch-mates' trace ids (the span-link half of the plane).
            members = [q.trace_id for q in live]
            for q in traced:
                tr = q.trace
                if tr.t_admitted is not None:
                    tr.phase("query/batch_wait", tr.t_admitted,
                             now - tr.t_admitted,
                             close_reason=close_reason,
                             batch_size=len(live))
                for m in members:
                    if m != q.trace_id:
                        tr.link(m)

        sources = np.array([q.source for q in live], np.int64)

        rerun = False
        attempts = 0
        while True:
            t0 = self._clock()
            attempts += 1
            try:
                ids, scores = mesh_lib.run_with_deadline(
                    lambda: self._execute(sources), sc.dispatch_timeout_s
                )
                break
            except mesh_lib.DeadlineExpired as e:
                self._c_dispatch_timeouts.inc()
                now = self._clock()
                for q in live:
                    self._c_rej_deadline.inc()
                    tr = q.trace
                    if tr is not None:
                        tr.phase("query/dispatch", t0, now - t0,
                                 error="DeadlineExpired",
                                 attempts=attempts)
                        if plane is not None:
                            plane.settle(tr, "rejected_deadline", now,
                                         1000.0 * max(0.0,
                                                      now - q.t_submit))
                    q.reject(QueryDeadlineExceeded(
                        f"device dispatch exceeded its "
                        f"{sc.dispatch_timeout_s}s bound: {e}"), now)
                return
            except Exception as e:  # noqa: BLE001 - classified below
                if not (isinstance(e, DeviceLostError)
                        or looks_like_device_loss(e)):
                    raise
                try:
                    self._rescue(e)
                except ElasticExhaustedError as term:
                    with self._state_lock:
                        self._fatal = term
                    now = self._clock()
                    for q in live:
                        tr = q.trace
                        if tr is not None:
                            tr.phase("query/dispatch", t0, now - t0,
                                     error="ElasticExhausted",
                                     attempts=attempts)
                            if plane is not None:
                                plane.settle(
                                    tr, "rejected", now,
                                    1000.0 * max(0.0, now - q.t_submit))
                        q.reject(ServeRejected(
                            f"serving terminal: {term}"), now)
                    self.queue.stop()
                    if plane is not None:
                        plane.flight_dump("fatal")
                    return
                rerun = True  # RE-RUN the same in-flight batch
                if plane is not None:
                    plane.flight_dump("rescue")
        wall = self._clock() - t0
        self.wall_model.observe(wall)
        if len(self.batch_walls) < self.BATCH_WALLS:
            self.batch_walls.append(wall)
        self._c_batches.inc()
        if rerun:
            self._c_reruns.inc()
        for q in traced:
            q.trace.phase("query/dispatch", t0, wall, rerun=rerun,
                          attempts=attempts)

        degraded = self.degraded
        served_from = "degraded" if degraded else "compute"
        outcome = "answered_degraded" if degraded else "answered"
        now = self._clock()
        for i, q in enumerate(live):
            tr = q.trace
            if tr is not None:
                t_f0 = self._clock()
            q_ids = np.array(ids[i, : q.k])
            q_scores = np.array(scores[i, : q.k])
            key = ResultCache.key(
                self._graph_fp, q.source, self._params_key, q.k
            )
            self.cache.put(key, q_ids, q_scores)
            self._c_answered.inc()
            if degraded:
                self._c_answered_degraded.inc()
            lat_ms = 1000.0 * max(0.0, now - q.t_submit)
            if tr is not None:
                tr.phase("query/fetch", t_f0, self._clock() - t_f0)
                self._h_latency.record(lat_ms, trace_id=q.trace_id)
                if plane is not None:
                    plane.settle(tr, outcome, now, lat_ms)
            else:
                self._h_latency.record(lat_ms)
            # resolve LAST: the done event publishes the query to the
            # blocked ingress thread, so the settled record is complete
            # before any other thread can see this query again.
            q.resolve(q_ids, q_scores, served_from, now)

    # -- drain side ---------------------------------------------------------

    def drain(self, deadline_s: Optional[float] = None) -> int:
        """The SIGTERM path: close admission (new offers raise typed
        ``Draining``), let queued batches finish inside the drain
        deadline, typed-reject whatever remains. Returns the number of
        flushed (rejected) queries. Idempotent."""
        if deadline_s is None:
            deadline_s = self.serve_config.drain_deadline_s
        t_end = self._clock() + deadline_s
        self.queue.stop()
        if self._dispatcher is not None:
            self._dispatcher.join(
                timeout=max(0.1, t_end - self._clock())
            )
        else:
            while self._clock() < t_end and len(self.queue) > 0:
                if self.pump() == 0:
                    break
        plane = qtrace.get_query_plane()

        def _drain_reject(q: PendingQuery) -> Draining:
            if plane is not None and q.trace is not None:
                plane.settle(q.trace, "rejected_draining",
                             self._clock(), None)
            return Draining(
                "drain deadline reached before this query's batch "
                "dispatched; retry against another replica"
            )

        flushed = self.queue.flush_rejected(_drain_reject)
        self._c_rej_draining.inc(flushed)
        if self._dispatcher is not None:
            # Queue is now empty + stopped: the thread exits its wait
            # promptly; join for real (PTR005).
            self._dispatcher.join()
            self._dispatcher = None
        if plane is not None:
            plane.flight_dump("drain")
        return flushed

    def stop(self) -> None:
        """drain() with the configured deadline — the normal shutdown."""
        self.drain()
