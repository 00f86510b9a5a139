"""Seed-deterministic serving chaos harness.

Copy of ``pagerank_tpu/testing/load.py`` over the port's daemon. Drives
a :class:`~pagerank_tpu_torch.serving.daemon.PprServer` in its
synchronous pump mode on a virtual clock, with faults from the same
:class:`~pagerank_tpu_torch.testing.faults.DeviceFaultSchedule`
machinery the solver chaos tests use. Everything that shapes an
admission or shed decision is a pure function of the seed:

- arrivals, sources, per-query deadlines come from ``random.Random
  (seed)`` (:class:`QueryLoadGenerator`);
- time is a :class:`~pagerank_tpu_torch.testing.schedules.VirtualClock` the
  harness advances explicitly (arrival gaps + a fixed per-batch
  service wall), so no real scheduler jitter leaks in;
- the batch wall model is FROZEN (``wall_alpha=0``) at the injected
  service wall, so the predictive shed compares the same numbers every
  run;
- the fault shim consults ``schedule.decide(batch_index, device_ids)``
  — and a post-rescue RE-RUN of the in-flight batch re-consults the
  SAME index, where the schedule's one-shot memory guarantees the
  killed device cannot die twice.

Contract the report makes checkable: same seed => same admissions,
same sheds, same casualty, bit-identical served results
(``results_digest``), and every submitted query in exactly one typed
terminal state (``unsettled == 0`` — the zero-silent-drops ledger).

Where the JAX harness runs over a fake 8-device CPU mesh
(``:198-228``), :func:`chaos_run` here serves over eight injected
device descriptors (``cuda:0`` .. ``cuda:7``; nothing runs on them)
with an engine factory that builds the one-process CPU engine, as the
daemon's rescue tests do: the casualty, the survivor list and every
admission decision are the JAX run's, and the answers are the CPU
engine's.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pagerank_tpu_torch.parallel.elastic import DeviceLostError
from pagerank_tpu_torch.serving import qtrace
from pagerank_tpu_torch.serving.daemon import PprServer
from pagerank_tpu_torch.testing.faults import DeviceFaultSchedule
from pagerank_tpu_torch.testing.schedules import VirtualClock


#: The device descriptors :func:`chaos_run` serves over: the JAX
#: harness's eight fake CPU devices, by id.
DESCRIPTORS = tuple(torch.device("cuda", i) for i in range(8))


@dataclass
class QueryLoadGenerator:
    """Open-loop arrival plan: ``plan()`` yields
    ``(gap_s, source, k, deadline_s)`` tuples, a pure function of the
    seed. ``repeat_frac`` of queries re-ask one of ``hot_set`` sources
    (the LRU cache's traffic); deadlines draw uniformly from
    ``deadline_range_s``."""

    seed: int = 0
    num_queries: int = 64
    n: int = 1 << 10              # source id space (graph order)
    mean_gap_s: float = 0.01      # open-loop exponential arrivals
    k: int = 8
    deadline_range_s: Tuple[float, float] = (0.25, 0.75)
    repeat_frac: float = 0.25
    hot_set: int = 4
    _rng: random.Random = field(init=False, repr=False)

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def plan(self) -> List[Tuple[float, int, int, float]]:
        rng = random.Random(self.seed)
        hot = [rng.randrange(self.n) for _ in range(max(1, self.hot_set))]
        out = []
        lo, hi = self.deadline_range_s
        for _ in range(self.num_queries):
            gap = rng.expovariate(1.0 / self.mean_gap_s) \
                if self.mean_gap_s > 0 else 0.0
            if rng.random() < self.repeat_frac:
                source = hot[rng.randrange(len(hot))]
            else:
                source = rng.randrange(self.n)
            deadline = lo + (hi - lo) * rng.random()
            out.append((gap, source, self.k, deadline))
        return out


def install_serve_faults(server: PprServer,
                         schedule: DeviceFaultSchedule,
                         clock: Optional[VirtualClock] = None,
                         service_s: float = 0.0) -> PprServer:
    """Wrap the server's ``_execute`` seam with the fault shim.

    The seam is SERVER-level (not engine-level) so it survives the
    rescue path's engine rebuild without re-installation. The shim
    consults the schedule once per batch *attempt*, keyed by the count
    of batches completed so far — a rescue re-run therefore re-consults
    the same index, and ``DeviceFaultSchedule``'s one-shot ``_fired``
    memory keeps the casualty list stable. ``kill`` actions raise
    :class:`DeviceLostError` BEFORE the dispatch (the device died
    mid-collective); ``delay`` actions stretch the virtual service
    wall; other action kinds are solver-plane and ignored here.
    ``service_s`` > 0 advances the virtual clock per completed dispatch
    so latency and deadline dynamics replay identically."""
    orig = getattr(server, "_prefault_execute", server._execute)
    server._prefault_execute = orig
    state = {"batch": 0}

    def shimmed(sources):
        i = state["batch"]
        actions = schedule.decide(i, server.device_ids())
        kills = [a for a in actions if a[0] == "kill"]
        if kills:
            raise DeviceLostError(
                f"injected device loss at serve batch {i} "
                f"(seed {schedule.seed})",
                device_ids=[a[1] for a in kills],
            )
        out = orig(sources)
        if clock is not None:
            extra = sum(a[2] for a in actions if a[0] == "delay")
            clock.advance(service_s + extra)
        state["batch"] = i + 1
        return out

    server._execute = shimmed
    return server


def run_serve_load(
    server: PprServer,
    clock: VirtualClock,
    plan: List[Tuple[float, int, int, float]],
    drain_at: Optional[int] = None,
    drain_deadline_s: float = 1.0,
    settle_step_s: float = 0.05,
    max_settle_steps: int = 10_000,
) -> Dict:
    """Replay ``plan`` against a started (pump-mode) server on the
    virtual clock; returns the determinism report.

    ``drain_at=j`` triggers the SIGTERM path right before query ``j``
    is submitted: :meth:`PprServer.drain` runs (queued batches finish
    inside ``drain_deadline_s``, the rest typed-reject), and the
    remaining arrivals still submit — exercising typed ``Draining``
    rejections at closed admission."""
    handles = []
    for idx, (gap, source, k, deadline_s) in enumerate(plan):
        if drain_at is not None and idx == drain_at:
            server.drain(deadline_s=drain_deadline_s)
        clock.advance(gap)
        handles.append(server.submit(source, k=k, deadline_s=deadline_s))
        server.pump()
    # Settle: advance virtual time until every queued batch closes
    # (deadline-margin closes need the clock to move).
    steps = 0
    while len(server.queue) > 0:
        steps += 1
        if steps > max_settle_steps:
            raise RuntimeError(
                f"queue failed to settle within {max_settle_steps} "
                f"virtual steps — a hang the serving contract forbids"
            )
        clock.advance(settle_step_s)
        server.pump()

    outcomes: Dict[str, int] = {}
    digest = hashlib.sha256()
    latencies_ms = []
    unsettled = 0
    admission_log = []
    for q in handles:
        out = q.outcome
        if not out:
            unsettled += 1
            out = "<unsettled>"
        outcomes[out] = outcomes.get(out, 0) + 1
        admission_log.append((q.qid, q.source, out))
        digest.update(f"{q.qid}:{q.source}:{out}".encode())
        if out.startswith("answered"):
            ids, scores = q.result(timeout=0)
            digest.update(np.ascontiguousarray(ids).tobytes())
            digest.update(np.ascontiguousarray(scores).tobytes())
            latencies_ms.append(1000.0 * (q.latency_s or 0.0))
    rep = {
        "queries": len(handles),
        "outcomes": outcomes,
        "unsettled": unsettled,
        "admission_log": admission_log,
        "results_digest": digest.hexdigest(),
        "latencies_ms": latencies_ms,
        "degraded": server.degraded,
        "device_count": server.device_count,
    }
    plane = qtrace.get_query_plane()
    if plane is not None:
        # Query plane armed: the timestamp-free span-tree
        # digest rides the determinism report — same seed must give
        # the same trace structure, not just the same outcomes.
        rep["trace_digest"] = plane.structure_digest()
    return rep


def chaos_run(seed: int = 7, queries: int = 40, iters: int = 5,
              kill_batch: int = 3, kill_device: int = 5,
              drain_at: Optional[int] = None,
              service_s: float = 0.05) -> Dict:
    """One canonical seed-deterministic chaos run (the acceptance
    smoke's shape, reusable from the CLI): 256-vertex R-MAT graph,
    pump-mode server on a virtual clock, frozen batch wall, one
    injected device kill, optional mid-load drain. The server runs
    over :data:`DESCRIPTORS` (module docstring); every engine it builds
    is the one-process CPU engine."""
    from pagerank_tpu_torch import PageRankConfig, build_graph
    from pagerank_tpu_torch.engines.ppr import PprTorchEngine
    from pagerank_tpu_torch.serving.daemon import ServeConfig
    from pagerank_tpu_torch.utils import synth

    n = 256
    src, dst = synth.rmat_edges(8, edge_factor=8, seed=3)
    g = build_graph(src, dst, n=n)
    cfg = PageRankConfig(num_iters=iters)
    sc = ServeConfig(max_batch=4, queue_depth=16, deadline_ms=400.0,
                     topk=8, wall_alpha=0.0, wall_initial_s=0.05,
                     cache_capacity=64, batch_margin_s=0.01)
    clock = VirtualClock()
    sched = DeviceFaultSchedule(seed=seed, kill={kill_batch: kill_device})
    srv = PprServer(g, config=cfg, serve_config=sc, devices=DESCRIPTORS,
                    engine_factory=lambda devices: PprTorchEngine(
                        cfg, device="cpu").build(g),
                    liveness_probe=sched.liveness_probe, clock=clock)
    srv.start(dispatcher=False)
    install_serve_faults(srv, sched, clock=clock, service_s=service_s)
    plan = QueryLoadGenerator(seed=seed, num_queries=queries, n=n,
                              mean_gap_s=0.02, k=8).plan()
    return run_serve_load(srv, clock, plan, drain_at=drain_at,
                          drain_deadline_s=1.0)


def main(argv=None) -> int:
    """``python -m pagerank_tpu_torch.testing.load``: run the canonical
    chaos load with the query plane armed; ``--trace PATH`` exports a
    Perfetto-loadable Chrome trace with per-thread lanes, and the
    JSON determinism report (with ``trace_digest``) prints to stdout.
    """
    import argparse
    import json
    import threading

    from pagerank_tpu_torch.obs import trace as obs_trace

    p = argparse.ArgumentParser(
        description="seed-deterministic serving chaos harness")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--queries", type=int, default=40)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--kill-batch", type=int, default=3)
    p.add_argument("--kill-device", type=int, default=5)
    p.add_argument("--drain-at", type=int, default=None,
                   help="trigger the SIGTERM drain path before query N")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="export a Chrome trace (Perfetto-loadable) of "
                        "the run's query spans, one lane per thread")
    p.add_argument("--slow-query-ms", type=float, default=None,
                   help="log outliers >= this latency as strict JSONL "
                        "(requires --slow-query-log)")
    p.add_argument("--slow-query-log", default=None, metavar="PATH",
                   help="destination for the slow-query JSONL "
                        "(requires --slow-query-ms)")
    args = p.parse_args(argv)
    if (args.slow_query_ms is None) != (args.slow_query_log is None):
        # Half the pair silently counts-without-writing (or never arms
        # the threshold) — refuse it at parse time, like serve's CLI.
        p.error(
            "--slow-query-ms and --slow-query-log must be given together"
        )

    tracer = None
    if args.trace:
        tracer = obs_trace.enable_tracing()
        tracer.set_thread_label(threading.get_ident(), "serve-harness")
    qtrace.arm_query_plane(slow_query_ms=args.slow_query_ms,
                           slow_query_path=args.slow_query_log)
    try:
        rep = chaos_run(seed=args.seed, queries=args.queries,
                        iters=args.iters, kill_batch=args.kill_batch,
                        kill_device=args.kill_device,
                        drain_at=args.drain_at)
        plane = qtrace.get_query_plane()
        rep["phase_p99_ms"] = plane.phase_p99_ms()
    finally:
        qtrace.disarm_query_plane()
        if tracer is not None:
            obs_trace.disable_tracing()
            tracer.export_chrome(args.trace)
    print(json.dumps(rep, allow_nan=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
