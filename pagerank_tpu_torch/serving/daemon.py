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
  JAX daemon's terminal path). Over a process group the roll call
  takes the probe's place (below);
- **SIGTERM**: the drain — :meth:`drain` closes admission
  (typed ``Draining`` rejections), in-flight batches finish inside the
  drain deadline, the rest are typed-rejected, exit 75 at the CLI;
- **stuck dispatch**: bounded by ``mesh.run_with_deadline`` — the
  batch fails typed (``QueryDeadlineExceeded``) instead of hanging the
  queue.

Over a process group (``pagerank_tpu/serving/daemon.py:207-233,
412-441`` over the port's groups): a server built inside a joined group
with the default engine factory runs its engine over the whole group
(``PprTorchEngine`` sharded by rows, ``num_devices`` = the world).
Rank 0 owns everything a client sees — admission, the cache, the
dispatcher or :meth:`pump`, and whatever the caller puts in front (the
HTTP ingress, the exporter, the query trace, the run report). Every
other rank calls :meth:`follow`: it receives each dispatch (the live
sources padded to ``max_batch``, their count, iterations, k and a
sequence number) by ``mesh.broadcast`` and runs the same
``engine.run``, so every collective of the solve meets its peers, and
it leaves on the stop word :meth:`drain` broadcasts. While no batch
runs, rank 0 broadcasts an idle word every quarter of the group's
collective timeout, so a follower's wait never reaches it. A
dispatch whose collective fails because a member is gone (gloo's
"Connection closed/reset by peer", the group's timeout) is classified
by ``elastic.looks_like_device_loss``; every survivor tears the group
down, takes the launcher store's roll call (``distributed.roll_call``,
bounded by ``probe_timeout_s``, the liveness bound; so the ranks must
come from ``spawn_group(..., rescue=True)``),
regroups over the survivors, rebuilds its engine there, and rank 0
re-runs the in-flight batch (``answered_degraded``). ``device_ids()``
names the surviving member ids; each rescue's wall by part (roll call,
regroup, rebuild, re-run) is kept in ``rescue_walls``.

Member 0 losing its DEVICE (a ``DeviceLostError`` naming member 0, or
its own echo failing) is survived as the JAX daemon survives the loss
of its device 0 (``pagerank_tpu/serving/daemon.py:412-441``): member
0's process owns every client-facing part, so it keeps them and
becomes the FRONT. It tears the group down, posts its presence in
the roll call and then that its device is lost
(``distributed.roll_call_verdict``: the verdict names member 0 dead
and among the ``hosts``, the dead whose process lives). The presence
goes up before the echo, so an echo that takes the whole deadline on a
hung card cannot make the live process look gone; a loss that names
member 0 needs no echo. The survivors (members 1 and up) regroup and rebuild
``PprTorchEngine`` over themselves, so K1w runs over their shares with
one psum an iteration among them. The front holds no engine and
launches nothing: each dispatch header goes to the survivors through
the launcher's store (``g<k>/serve/hdr/<i>``, ``k`` the survivors'
generation), the lowest survivor reads it, broadcasts it to its group
(and the idle word while none comes), and writes the top-k ids and
scores back (``g<k>/serve/res/<i>``). The store is a host channel, so
it needs no device of member 0's, under NCCL too. The in-flight batch
re-runs as ``answered_degraded``; ``device_count`` is then the world
less one. A later loss among the survivors rescues as a follower's
loss does: the front reads their verdict from the store and re-sends
the in-flight batch on the next generation's channel; the
``max_rescues`` budget counts both kinds. The front's ``rescue_walls``
entry holds its roll call and its re-run (the survivors' regroup and
rebuild inside it). Losing member 0's PROCESS (a SIGKILL) stays
terminal, as the death of the JAX daemon's process is: no host is left
to answer, so the followers raise ``ElasticExhaustedError`` saying the
serving process was lost and exit non-zero.

Concurrency (PTR rules): the admission queue's Condition is the
cross-thread meeting point; server-side mutable state (engine,
devices, degraded flag) lives behind ``_state_lock`` and is only
written by the dispatch context. Blocking work (device dispatch,
``run_with_deadline``) happens outside every lock (PTR004). The
dispatcher thread is named and joined (PTR005); the admission clock
is injected (PTR006), while the group's keepalive, the front's wait and
the rescue walls read the host's real clock (waived in
``analysis/allowlist.txt``, each with its reason). The engine makes its device current in whichever thread
launches (the dispatcher, ``run_with_deadline``'s worker).
"""

from __future__ import annotations

import gc
import io
import json
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

import torch

from pagerank_tpu_torch.engines.ppr import PprTorchEngine
from pagerank_tpu_torch.engines.torch_engine import resolve_device
from pagerank_tpu_torch.graph import Graph
from pagerank_tpu_torch.models import ppr as ppr_model
from pagerank_tpu_torch.obs import log as obs_log
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.parallel import distributed
from pagerank_tpu_torch.parallel import mesh as mesh_lib
from pagerank_tpu_torch.parallel.elastic import (DeviceLostError,
                                           ElasticExhaustedError,
                                           RankLeftError,
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
    with ``num_devices=len(devices)``, and the rescue path calls it
    again with the survivor list.
    ``liveness_probe(devices, timeout_s)`` defaults to
    ``mesh.probe_liveness``; tests inject their own so a CPU run sees
    the dead set a real device would report.

    Inside a joined process group with the default factory the server
    runs over the group (module docstring): ``devices`` is then this
    rank's device alone (default cuda, one card a rank), rank 0 calls
    :meth:`start` and every other rank :meth:`follow`, and every rank
    must be given the same graph, configs and ``max_batch``.
    """

    #: Batch walls kept in ``batch_walls`` (bounded for a long-lived
    #: daemon).
    BATCH_WALLS = 4096
    #: The first entry of a dispatch header rank 0 broadcasts over a
    #: group, then the live count, iterations, k and the sequence
    #: number; the sources follow, padded to ``max_batch``.
    STOP, RUN, IDLE = 0, 1, 2
    HEADER = 5

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
        # Over a process group: the default factory inside a joined
        # group (the member ids of the current group, this rank's mesh
        # for the dispatch broadcasts).
        self._grouped = engine_factory is None and distributed.group_up()
        self._members: List[int] = (list(distributed.members())
                                    if self._grouped else [])
        self._mesh: Optional[mesh_lib.Mesh] = None
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
        #: Each rescue over a group by part, seconds: roll_call,
        #: regroup, rebuild and (rank 0) rerun.
        self.rescue_walls: List[Dict[str, float]] = []
        # The dispatch broadcast and its run go together: an abandoned
        # dispatch finishes its collectives before the next one starts.
        self._dispatch_lock = threading.Lock()
        self._seq = 0
        self._last_word = 0.0
        self._group_open = self._grouped
        # Member 0 once its device is lost (the front: no engine, the
        # survivors compute), a follower whose group serves a front,
        # and the front's channel: the survivors' generation and the
        # index of its next header.
        self._front = False
        self._fronted = False
        self._chan_gen = 0
        self._chan_seq = 0
        self._keepalive: Optional[threading.Thread] = None
        self._keepalive_stop = threading.Event()
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
        """An engine over ``devices``; over a group, ``devices`` are the
        current group's member ids and the engine runs on this rank's
        device over the whole group."""
        cfg = self.config.replace(num_devices=len(devices))
        with self._state_lock:
            device = self._devices[0] if self._grouped else devices[0]
        eng = PprTorchEngine(cfg, dangling_to=self.dangling_to,
                             device=device)
        eng.build(self.graph)
        return eng

    def _join_group(self) -> None:
        """This rank's mesh over the current group (the broadcasts'),
        on ``devices[0]`` (default cuda: ``make_mesh`` picks the card
        of a rank)."""
        with self._state_lock:
            dev = self._devices[0] if self._devices else None
        mesh = mesh_lib.make_mesh(device=dev)
        with self._state_lock:
            self._mesh = mesh
            self._devices = [mesh.device]
            self._members = list(mesh.members)

    def start(self, dispatcher: bool = True) -> "PprServer":
        """Build the engine, warm it at the serving shapes (the kernel
        built and K1w bound at ``max_batch``), then (daemon mode) start
        the named dispatcher thread. ``warmup_seconds`` holds the
        warm-up's wall, engine build included."""
        t0 = self._clock()
        with self._state_lock:
            if self._started:
                raise RuntimeError("PprServer.start() called twice")
        if self._grouped:
            if distributed.process_info()[0] != 0:
                raise RuntimeError("over a process group only rank 0 "
                                   "serves: the other ranks call follow()")
            self._join_group()
        with self._state_lock:
            if not self._devices:
                self._devices = [resolve_device(None)]
            devices = (list(self._members) if self._grouped
                       else list(self._devices))
        engine = self._engine_factory(devices)
        with self._state_lock:
            self._engine = engine
            self._started = True
        self._g_devices.set(len(devices))
        # Warm the exact serving shapes (full-width batch, static
        # iters/topk) so no query ever pays the build or the bind.
        self._execute(np.zeros(self.serve_config.max_batch, np.int64))
        self.warmup_seconds = self._clock() - t0
        if self._grouped:
            self._keepalive = threading.Thread(
                target=self._keepalive_loop, name="pagerank-serve-keepalive",
                daemon=True)
            self._keepalive.start()
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
            return len(self._members if self._grouped else self._devices)

    @property
    def rescues_done(self) -> int:
        with self._state_lock:
            return self._rescues_done

    def device_ids(self) -> List[int]:
        """The device ids the engine runs over; over a group, the
        member ids (``Mesh.members``)."""
        with self._state_lock:
            if self._grouped:
                return list(self._members)
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
        with self._dispatch_lock:
            if self._front:
                return self._front_dispatch(sources)
            with self._state_lock:
                engine = self._engine
            if self._grouped:
                self._announce(self.RUN, sources)
            res = engine.run(
                sources, num_iters=self._iters(),
                topk=self.serve_config.topk,
                chunk=self.serve_config.max_batch,
            )
        return res.topk_ids, res.topk_scores

    # -- over a process group -------------------------------------------------

    def _header(self) -> "torch.Tensor":
        return torch.zeros(self.HEADER + self.serve_config.max_batch,
                           dtype=torch.int64, device=self._mesh.device)

    def _words(self, word: int, sources=()) -> "torch.Tensor":
        """One dispatch header on the host (the caller holds the
        dispatch lock): the word, the live count, iterations, k and the
        sequence number, then the sources padded to ``max_batch``."""
        hdr = torch.zeros(self.HEADER + self.serve_config.max_batch,
                          dtype=torch.int64)
        hdr[:self.HEADER] = torch.tensor(
            [word, len(sources), self._iters(), self.serve_config.topk,
             self._seq])
        hdr[self.HEADER: self.HEADER + len(sources)] = torch.as_tensor(
            np.asarray(sources, np.int64))
        if word == self.RUN:
            self._seq += 1
        return hdr

    def _announce(self, word: int, sources=()) -> None:
        """Rank 0: broadcast one dispatch header (the caller holds the
        dispatch lock)."""
        hdr = self._words(word, sources)
        mesh_lib.broadcast(self._mesh, hdr.to(self._mesh.device))
        self._last_word = time.perf_counter()

    # -- the front: member 0 after its device was lost --------------------------

    def _chan(self) -> str:
        return f"g{self._chan_gen}/serve/"

    def _front_post(self, word: int, sources=()) -> int:
        """The front: post one header on the survivors' channel; returns
        its index there (the caller holds the dispatch lock)."""
        i = self._chan_seq
        hdr = self._words(word, sources)
        distributed.launcher_store().set(f"{self._chan()}hdr/{i}",
                                         hdr.numpy().tobytes())
        self._chan_seq += 1
        return i

    def _front_dispatch(self, sources: np.ndarray):
        """The front's dispatch: post the header, wait for the
        survivors' answer. A verdict of their roll call, or the end of
        every survivor's process, raises ``DeviceLostError`` naming the
        dead (the rescue then moves to the next generation's channel);
        past ``dispatch_timeout_s`` it raises ``TimeoutError``."""
        store = distributed.launcher_store()
        key = f"{self._chan()}res/{self._front_post(self.RUN, sources)}"
        verdict = f"g{self._chan_gen}/roll/verdict"
        with self._state_lock:
            members = list(self._members)
        t_end = time.perf_counter() + self.serve_config.dispatch_timeout_s
        while not distributed.store_wait(store, key, 0.05):
            if store.check([verdict]):
                raise DeviceLostError(
                    "a survivor of the front's group was lost",
                    device_ids=json.loads(store.get(verdict))["dead"])
            if all(store.check([f"exited/{m}"]) for m in members):
                raise DeviceLostError(
                    f"every member of the front's group {members} ended",
                    device_ids=members)
            if time.perf_counter() > t_end:
                raise TimeoutError(
                    f"no answer from the survivors {members} within "
                    f"{self.serve_config.dispatch_timeout_s}s")
        with np.load(io.BytesIO(store.get(key))) as f:
            ids, scores = f["ids"], f["scores"]
        store.delete_key(key)
        return ids, scores

    def _front_rescue(self, exc: BaseException) -> List[int]:
        """The front's part of a loss among the survivors: adopt their
        roll call's verdict (every member of the group, where all of
        their processes ended with none) and move to the next
        generation's channel. Raises ``ElasticExhaustedError`` when no
        survivor is left."""
        store = distributed.launcher_store()
        verdict = f"g{self._chan_gen}/roll/verdict"
        with self._state_lock:
            members = list(self._members)
            rescues = self._rescues_done
        dead = (json.loads(store.get(verdict))["dead"]
                if store.check([verdict]) else list(members))
        survivors = [m for m in members if m not in dead]
        if not survivors:
            raise ElasticExhaustedError(
                f"no surviving devices: all of {members} reported dead "
                f"({exc})", tuple(dead), rescues) from exc
        obs_log.warn(f"SERVE RESCUE: member(s) {dead} lost ({exc}); the "
                     f"front serves on over {survivors}")
        with self._state_lock:
            self._members = survivors
        self._chan_gen += 1
        self._chan_seq = 0
        # The survivors took the roll call; the front's part is the
        # re-run, their regroup and rebuild inside it.
        self.rescue_walls.append({})
        return list(dead)

    def _become_front(self, survivors: List[int], walls) -> None:
        """Member 0, its device lost: free the engine and serve on from
        the host over the survivors' next generation."""
        with self._state_lock:
            self._engine = None
            self._members = list(survivors)
            self._degraded = True
        self._front = True
        self._chan_gen = distributed.generation() + 1
        self._chan_seq = 0
        self.rescue_walls.append(walls)

    def _relay(self):
        """Rank 0 of a group serving a front: the next header from the
        front's channel, broadcast to this group, with its index there.
        While none comes, the idle word goes out every quarter of the
        collective timeout; the end of the front's process is
        terminal."""
        store = distributed.launcher_store()
        every = distributed.collective_timeout_s() / 4
        key = f"{self._chan()}hdr/{self._chan_seq}"
        while not distributed.store_wait(store, key, min(0.5, every)):
            if store.check(["exited/0"]):
                raise ElasticExhaustedError(
                    "serving terminal: the serving process (member 0) was "
                    "lost; no host is left to answer", (0,),
                    self.rescues_done)
            if time.perf_counter() - self._last_word >= every:
                mesh_lib.broadcast(self._mesh,
                                   self._words(self.IDLE).to(
                                       self._mesh.device))
                self._last_word = time.perf_counter()
        hdr = torch.from_numpy(np.frombuffer(store.get(key),
                                             np.int64).copy())
        store.delete_key(key)
        i = self._chan_seq
        self._chan_seq += 1
        mesh_lib.broadcast(self._mesh, hdr.to(self._mesh.device))
        self._last_word = time.perf_counter()
        return hdr, i

    def _reply(self, i: int, res) -> None:
        """Rank 0 of a group serving a front: the answer to the front's
        header ``i``."""
        buf = io.BytesIO()
        np.savez(buf, ids=np.asarray(res.topk_ids),
                 scores=np.asarray(res.topk_scores))
        distributed.launcher_store().set(f"{self._chan()}res/{i}",
                                         buf.getvalue())

    def _keepalive_loop(self) -> None:
        """Rank 0: the idle word, whenever no word went out for a
        quarter of the group's collective timeout. A failed broadcast is
        left to the next dispatch, which classifies it."""
        every = distributed.collective_timeout_s() / 4
        while not self._keepalive_stop.wait(every / 4):
            with self._dispatch_lock:
                if (not self._group_open or self.fatal is not None
                        or time.perf_counter() - self._last_word < every):
                    continue
                try:
                    self._announce(self.IDLE)
                except Exception as e:  # noqa: BLE001 - see docstring
                    obs_log.warn(f"serve: keepalive broadcast failed ({e})")

    def _stop_followers(self) -> None:
        """Rank 0: end the keepalive, then send the followers the stop
        word (once; not over a group already torn down)."""
        self._keepalive_stop.set()
        if self._keepalive is not None:
            self._keepalive.join()
            self._keepalive = None
        with self._dispatch_lock:
            if self._front:
                if self.device_count:
                    try:
                        self._front_post(self.STOP)
                    except Exception as e:  # noqa: BLE001 - drain goes on
                        obs_log.warn(f"serve: the survivors' stop word "
                                     f"failed ({e})")
                return
            if not self._group_open or self._mesh is None:
                return
            self._group_open = False
            try:
                self._announce(self.STOP)
            except Exception as e:  # noqa: BLE001 - the drain goes on
                obs_log.warn(f"serve: the followers' stop word failed ({e})")

    def follow(self) -> None:
        """A rank other than 0 of a group: build the engine over the
        group, then run every dispatch rank 0 broadcasts until its stop
        word. A loss rescues as rank 0 does (:meth:`_group_rescue`).
        Once member 0 serves as the front, rank 0 of this group relays
        its headers from the store (:meth:`_relay`) and writes the
        answers back. Raises ``RankLeftError`` when the roll call names
        this rank, and ``ElasticExhaustedError`` when member 0's process
        is gone. A seeded
        ``ProcessKillPlan`` in the environment (stage ``serve``,
        iteration = the dispatch's sequence number; the warm-up is 0)
        kills this process after it received that dispatch."""
        from pagerank_tpu_torch.testing.faults import ProcessKillPlan

        if not self._grouped or distributed.process_info()[0] == 0:
            raise RuntimeError("follow() runs on a rank other than 0 of a "
                               "process group")
        kill = ProcessKillPlan.from_env()
        self._join_group()
        with self._state_lock:
            members = list(self._members)
        engine = self._engine_factory(members)
        with self._state_lock:
            self._engine = engine
            self._started = True
        chunk = self.serve_config.max_batch
        while True:
            try:
                relay = self._fronted and self._mesh.rank == 0
                if relay:
                    hdr, i = self._relay()
                else:
                    hdr = mesh_lib.broadcast(self._mesh,
                                             self._header()).cpu()
                word, live, iters, topk, seq = hdr[:self.HEADER].tolist()
                if word == self.STOP:
                    return
                if word == self.IDLE:
                    continue
                if kill is not None:
                    kill.check("serve", seq)
                sources = hdr[self.HEADER: self.HEADER + live].numpy()
                with self._state_lock:
                    engine = self._engine
                res = engine.run(sources, num_iters=iters, topk=topk,
                                 chunk=chunk)
                if relay:
                    self._reply(i, res)
            except Exception as e:  # noqa: BLE001 - classified below
                if not (isinstance(e, DeviceLostError)
                        or looks_like_device_loss(e)):
                    raise
                engine = res = None  # the rescue drops the group's holders
                self._group_rescue(e)

    def _echo_own(self, device) -> bool:
        """Whether this rank's own ``device`` answers a 4-byte echo
        within the liveness deadline."""
        try:
            return bool(mesh_lib.run_with_deadline(
                lambda: mesh_lib._echo(device),
                self.serve_config.probe_timeout_s))
        except Exception:  # noqa: BLE001 - a silent device is a dead one
            return False

    def _release(self, exc: BaseException):
        """Drop this rank's hold on its broken group (the engine, the
        mesh and the error's frames), then tear the group down: gloo
        closes a group's pairs only once nothing holds it, and a peer
        blocked in a collective with this rank then raises. Returns this
        rank's device."""
        device = self._mesh.device
        with self._state_lock:
            self._engine = None
        self._mesh = None
        if exc.__traceback__ is not None:
            traceback.clear_frames(exc.__traceback__)
        distributed.abandon_group()
        gc.collect()
        return device

    def _group_rescue(self, exc: BaseException) -> List[int]:
        """Every survivor's part of a rescue over a group: tear the
        group down, take the roll call, regroup over the survivors and
        rebuild the engine there; returns the dead member ids. Member 0
        whose device the verdict names becomes the front instead
        (module docstring). Raises ``exc`` when the roll call finds no
        one dead, ``RankLeftError`` when it names this rank (a
        follower), and ``ElasticExhaustedError`` when member 0's
        process is gone, no device survives, or the ranks have no
        launcher store to take the roll call in."""
        carried = (exc.device_ids if isinstance(exc, DeviceLostError)
                   else ())
        t = time.perf_counter()
        with self._state_lock:
            members = list(self._members)
            rescues = self._rescues_done
        self._group_open = False
        device = self._release(exc)
        if distributed.launcher_store() is None:
            raise ElasticExhaustedError(
                f"a loss over a process group without the launcher's store "
                f"is terminal (start the ranks with spawn_group(..., "
                f"rescue=True)): {exc}", tuple(carried), rescues) from exc
        # The presence goes up before the echo (a hung card's echo may
        # take the whole deadline); a loss that names this member needs
        # no echo.
        me = distributed.member()
        verdict = distributed.roll_call_verdict(
            carried,
            alive=lambda: me not in carried and self._echo_own(device),
            timeout_s=self.serve_config.probe_timeout_s)
        dead = verdict["dead"]
        walls = {"roll_call": time.perf_counter() - t}
        if not dead:
            raise exc
        if 0 in dead and 0 not in verdict["hosts"]:
            raise ElasticExhaustedError(
                f"serving terminal: the serving process (member 0) was "
                f"lost ({exc}); no host is left to answer", tuple(dead),
                rescues) from exc
        survivors = [m for m in members if m not in dead]
        if not survivors:
            raise ElasticExhaustedError(
                f"no surviving devices: all of {members} reported dead "
                f"({exc})", tuple(dead), rescues) from exc
        if 0 in dead and distributed.member() == 0:
            obs_log.warn(f"SERVE RESCUE: member 0's device lost ({exc}); "
                         f"serving on from the host over {survivors}")
            self._become_front(survivors, walls)
            return list(dead)
        self._fronted = self._fronted or 0 in dead
        if distributed.member() not in survivors:
            raise RankLeftError(
                f"member {distributed.member()} was declared lost by the "
                f"group's roll call; the survivors {survivors} serve on",
                device_ids=[distributed.member()])
        obs_log.warn(f"SERVE RESCUE: member(s) {dead} lost ({exc}); "
                     f"regrouping over {survivors}")
        t = time.perf_counter()
        distributed.regroup(survivors)
        walls["regroup"] = time.perf_counter() - t
        t = time.perf_counter()
        self._join_group()
        with self._state_lock:
            members = list(self._members)
        engine = self._engine_factory(members)
        walls["rebuild"] = time.perf_counter() - t
        with self._state_lock:
            self._engine = engine
            self._degraded = True
        if self._fronted:
            self._chan_gen = distributed.generation()
            self._chan_seq = 0
        self._group_open = not self._fronted
        self.rescue_walls.append(walls)
        return list(dead)

    def _rescue(self, exc: BaseException) -> None:
        """Chip loss / quarantine mid-serve: classify the casualty,
        re-shard onto the survivors, swap the engine. Raises
        ``ElasticExhaustedError`` when the budget is spent."""
        with self._state_lock:
            devices = list(self._devices)
            rescues = self._rescues_done
        if rescues >= self.serve_config.max_rescues:
            if self._grouped:
                # The followers see the group go, find member 0 missing
                # from the roll call, and end.
                with self._dispatch_lock:
                    self._group_open = False
                    distributed.abandon_group()
            raise ElasticExhaustedError(
                f"serving rescue budget spent ({rescues} rescues): {exc}",
                tuple(getattr(exc, "device_ids", ())), rescues,
            )
        if self._grouped:
            with self._dispatch_lock:
                dead = (self._front_rescue(exc) if self._front
                        else self._group_rescue(exc))
            with self._state_lock:
                self._rescues_done += 1
                width = len(self._members)
            self._c_rescues.inc()
            self._c_devices_lost.inc(len(dead))
            self._g_devices.set(width)
            return
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
            t0, t_host = self._clock(), time.perf_counter()
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
        if rerun and self.rescue_walls:
            self.rescue_walls[-1].setdefault("rerun",
                                             time.perf_counter() - t_host)
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
        if self._grouped:
            self._stop_followers()
        if plane is not None:
            plane.flight_dump("drain")
        return flushed

    def stop(self) -> None:
        """drain() with the configured deadline — the normal shutdown."""
        self.drain()
