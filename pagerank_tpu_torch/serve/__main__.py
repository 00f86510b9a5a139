"""CLI for the deadline-honest PPR query daemon.

    python -m pagerank_tpu_torch.serve --scale 14 --max-batch 8 \
        --deadline-ms 500 --port 8080

Port of ``pagerank_tpu/serve/__main__.py``. Builds a synthetic R-MAT
graph (the repo's zero-egress workload stand-in), warms the engine at
the serving shapes (the kernel built, K1w bound at ``--max-batch``) on
``--device`` (default cuda), and serves ``GET /ppr?source=<id>`` over
loopback HTTP until SIGTERM enters the drain (admission closes with
typed rejections, in-flight batches finish, exit 75). ``--serve-smoke
N`` instead runs N seeded queries in-process against the started daemon
and exits — the self-test mode. ``--metrics-port`` serves the metrics
registry (the daemon's ``serve.*`` counters and latency histogram with
its trace-id exemplars) at ``GET /metrics`` in ``--metrics-format``
(prometheus or openmetrics), and ``--run-report`` writes the run report
with the serving flight-recorder section on the SIGTERM drain.

``--num-devices N`` serves over a process group of N ranks, one device
a rank (``pagerank_tpu/serve/__main__.py:49-50,104``): outside torchrun
this process starts them itself (``parallel/distributed.spawn_group``
with the rescue store: nccl on cuda:i, or gloo on the CPU with
``--device cpu``) and waits for them; under torchrun it joins its
group. Rank 0 is the daemon — it alone binds ``--port`` and
``--metrics-port``, prints, writes the report, and its exit code and
drain are the run's; a SIGTERM to the launcher is passed on to it. The
other ranks follow its dispatches (``PprServer.follow``), and a member
that dies is rescued onto the survivors.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

from pagerank_tpu_torch import PageRankConfig, build_graph, jobs
from pagerank_tpu_torch.exitcodes import ExitCode
from pagerank_tpu_torch.utils import synth

#: span-retention bound for --query-trace: the daemon may trace for its
#: whole lifetime, so the Tracer keeps a ring of the most recent spans
#: (~6 spans per query -> tens of thousands of queries of tail) instead
#: of growing without bound the way a finite solver capture may.
QUERY_TRACE_MAX_SPANS = 200_000


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pagerank_tpu_torch.serve",
        description="Deadline-honest PPR query daemon over a resident "
        "sharded graph (typed overload/drain/degraded outcomes).",
    )
    g = p.add_argument_group("graph / solver")
    g.add_argument("--scale", type=int, default=12,
                   help="R-MAT scale: 2**scale vertices (default 12)")
    g.add_argument("--edge-factor", type=int, default=16,
                   help="edges per vertex (default 16)")
    g.add_argument("--seed", type=int, default=0,
                   help="graph + smoke load seed (default 0)")
    g.add_argument("--iters", type=int, default=10,
                   help="PPR power iterations per query (default 10)")
    g.add_argument("--damping", type=float, default=0.85)
    g.add_argument("--num-devices", type=int, default=None,
                   help="ranks to serve over, one device each: N > 1 "
                   "starts N processes (under torchrun: its group)")
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs (default cuda; cpu only "
                   "when asked)")
    s = p.add_argument_group("serving")
    s.add_argument("--topk", type=int, default=100,
                   help="on-device top-k width (default 100)")
    s.add_argument("--max-batch", type=int, default=8,
                   help="bound batch width: the most queries one batch "
                   "runs (default 8)")
    s.add_argument("--deadline-ms", type=float, default=500.0,
                   help="default per-query deadline (default 500)")
    s.add_argument("--queue-depth", type=int, default=64,
                   help="bounded admission depth (default 64)")
    s.add_argument("--cache-capacity", type=int, default=1024,
                   help="LRU result-cache entries; 0 disables")
    s.add_argument("--port", type=int, default=8080,
                   help="query ingress HTTP port (0 = ephemeral)")
    s.add_argument("--metrics-port", type=int, default=None,
                   help="serve /metrics on this port too (0 = ephemeral)")
    s.add_argument("--drain-deadline", type=float, default=5.0,
                   help="SIGTERM drain budget, seconds (default 5)")
    s.add_argument("--serve-smoke", type=int, default=None, metavar="N",
                   help="self-test: run N in-process queries, print a "
                   "JSON summary, exit (no HTTP)")
    o = p.add_argument_group("query plane (observability)")
    o.add_argument("--metrics-format", choices=("prometheus", "openmetrics"),
                   default="prometheus",
                   help="/metrics text format; openmetrics carries "
                   "trace-id exemplars on latency buckets")
    o.add_argument("--slow-query-ms", type=float, default=None,
                   help="log queries slower than this as strict JSONL "
                   "phase breakdowns (arms the query plane; requires "
                   "--slow-query-log)")
    o.add_argument("--slow-query-log", default=None, metavar="PATH",
                   help="slow-query JSONL destination (required with, "
                   "and only meaningful with, --slow-query-ms)")
    o.add_argument("--query-trace", default=None, metavar="PATH",
                   help="debug/short-capture: export a Chrome trace of "
                   "per-query spans (one lane per thread) at shutdown; "
                   f"retains only the most recent {QUERY_TRACE_MAX_SPANS} "
                   "spans (a bounded ring), so long-lived daemons stay "
                   "bounded but export only the tail of the run")
    o.add_argument("--run-report", default=None, metavar="PATH",
                   help="write the run report (with the serving flight "
                   "recorder section) here on SIGTERM drain")
    return p


def _build_server(args):
    from pagerank_tpu_torch.engines.torch_engine import resolve_device
    from pagerank_tpu_torch.serving import PprServer, ServeConfig

    device = resolve_device(args.device)  # raises without a card
    if args.num_devices is not None and args.num_devices < 1:
        raise ValueError(f"--num-devices must be >= 1, got "
                         f"{args.num_devices}")

    src, dst = synth.rmat_edges(
        args.scale, edge_factor=args.edge_factor, seed=args.seed
    )
    graph = build_graph(src, dst, n=1 << args.scale)
    config = PageRankConfig(
        num_iters=args.iters, damping=args.damping,
        num_devices=args.num_devices,
    ).validate()
    serve_config = ServeConfig(
        max_batch=args.max_batch,
        queue_depth=args.queue_depth,
        deadline_ms=args.deadline_ms,
        topk=args.topk,
        cache_capacity=args.cache_capacity,
        drain_deadline_s=args.drain_deadline,
    )
    return PprServer(graph, config=config, serve_config=serve_config,
                     devices=[device])


def _run_smoke(server, args) -> int:
    """N seeded in-process queries against the started daemon; prints
    one JSON summary line. Exit 0 iff every query reached a typed
    terminal state (answered or typed-rejected, zero unsettled)."""
    import random

    rng = random.Random(args.seed)
    n = server.graph.n
    handles = [
        server.submit(rng.randrange(n), k=min(args.topk, 8))
        for _ in range(args.serve_smoke)
    ]
    settle = args.deadline_ms / 1000.0 + 5.0
    outcomes = {}
    unsettled = 0
    for q in handles:
        q.wait(settle)
        out = q.outcome or "<unsettled>"
        unsettled += out == "<unsettled>"
        outcomes[out] = outcomes.get(out, 0) + 1
    server.stop()
    walls = sorted(server.batch_walls)

    def pct(q):  # nearest rank
        return 1e3 * walls[min(len(walls) - 1, int(q * len(walls)))]

    print(json.dumps({
        "smoke": "ppr_serve",
        "queries": len(handles),
        "outcomes": outcomes,
        "unsettled": unsettled,
        "devices": server.device_count,
        "degraded": server.degraded,
        "warmup_s": server.warmup_seconds,
        "batches": len(walls),
        "batch_wall_ms": ({"first": 1e3 * server.batch_walls[0],
                           "p50": pct(0.5), "p99": pct(0.99)}
                          if walls else None),
    }, sort_keys=True))
    return int(ExitCode.OK) if unsettled == 0 else int(ExitCode.FAILURE)


def _write_run_report(path: str) -> None:
    """Dump the run report (the serving flight-recorder section
    included: ``build_run_report`` picks up the armed query plane)."""
    from pagerank_tpu_torch.obs.report import build_run_report

    with open(path, "w") as f:
        json.dump(build_run_report(), f, sort_keys=True)
        f.write("\n")


def main(argv=None) -> int:
    parser = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    if (args.slow_query_ms is None) != (args.slow_query_log is None):
        # Half a pair is a silent no-op (counting without writing, or a
        # path that never arms the plane) — refuse it at parse time.
        parser.error(
            "--slow-query-ms and --slow-query-log must be given together"
        )
    from pagerank_tpu_torch.parallel import distributed

    if (args.num_devices or 1) > 1 and not distributed.group_up():
        if os.environ.get("WORLD_SIZE"):
            distributed.maybe_initialize_distributed(
                distributed.default_backend(args.device))
            try:
                return _serve(args)
            finally:
                distributed.shutdown()
        return _launch(args, argv)
    return _serve(args)


def _launch(args, argv) -> int:
    """``--num-devices N`` outside torchrun: N spawned ranks of one
    rescue-armed group; returns rank 0's exit code. A SIGTERM or SIGINT
    to this process is passed on to rank 0, which drains the daemon and
    stops the followers."""
    import multiprocessing
    import tempfile

    from pagerank_tpu_torch.engines.torch_engine import resolve_device
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.parallel import mesh as mesh_lib

    try:
        mesh_lib.check_visible(args.num_devices,
                               resolve_device(args.device).type)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return int(ExitCode.USAGE)

    def forward(signum, frame):
        for p in multiprocessing.active_children():
            if p.name == "pagerank-rank-0":
                os.kill(p.pid, signum)

    old = {s: signal.signal(s, forward)
           for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        with tempfile.TemporaryDirectory(prefix="pagerank-serve-") as tmp:
            codes = distributed.spawn_group(
                "pagerank_tpu_torch.serve.__main__:_rank_main",
                args.num_devices, argv, tmp,
                backend=distributed.default_backend(args.device),
                rescue=True)
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    if codes.lost:
        print(f"serve: lost rank(s) {list(codes.lost)} (exit codes "
              f"{ {r: codes[r] for r in codes.lost} })", file=sys.stderr)
    return int(codes[0]) if codes[0] is not None else int(ExitCode.FAILURE)


def _rank_main(argv) -> int:
    """One spawned rank of :func:`_launch`. CPU ranks share the host's
    cores: each takes its share of them as torch threads."""
    args = build_parser().parse_args(argv)
    if args.device == "cpu":
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // max(1, args.num_devices)))
    return _serve(args)


def _follow(server) -> int:
    """A rank other than 0: follow rank 0's dispatches until its stop
    word. A rank the roll call declared lost, or one that lost rank 0,
    ends with exit 1."""
    from pagerank_tpu_torch.parallel.elastic import (ElasticExhaustedError,
                                                     RankLeftError)

    try:
        server.follow()
    except (RankLeftError, ElasticExhaustedError) as e:
        print(f"serve: {e}", file=sys.stderr)
        return int(ExitCode.FAILURE)
    return int(ExitCode.OK)


def _serve(args) -> int:
    """The daemon in this process: alone, or as its rank of a group."""
    from pagerank_tpu_torch.parallel import distributed

    try:
        server = _build_server(args)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return int(ExitCode.USAGE)
    if distributed.process_info()[0] != 0:
        return _follow(server)

    # Query plane: armed only on request — the disarmed
    # daemon keeps its zero-tracer-call hot path (the booby-trap pin).
    plane_armed = (args.slow_query_ms is not None or args.query_trace
                   or args.run_report)
    tracer = None
    if plane_armed:
        from pagerank_tpu_torch.serving import qtrace

        if args.query_trace:
            import threading

            from pagerank_tpu_torch.obs import trace as obs_trace

            tracer = obs_trace.enable_tracing(
                obs_trace.Tracer(max_spans=QUERY_TRACE_MAX_SPANS)
            )
            tracer.set_thread_label(threading.get_ident(), "serve-main")
        qtrace.arm_query_plane(slow_query_ms=args.slow_query_ms,
                               slow_query_path=args.slow_query_log)

    # SIGTERM/SIGINT handlers live ONLY around entry points (PTL008);
    # a drain request surfaces as DrainInterrupt at the poll below and
    # the daemon exits ExitCode.INTERRUPTED after the bounded drain.
    drain = jobs.GracefulDrain(deadline_s=args.drain_deadline)
    with drain:
        server.start()
        try:
            if args.serve_smoke is not None:
                return _run_smoke(server, args)
            from pagerank_tpu_torch.serving.http import QueryIngress

            exporter = None
            if args.metrics_port is not None:
                from pagerank_tpu_torch.obs.live import MetricsExporter

                exporter = MetricsExporter(port=args.metrics_port,
                                           format=args.metrics_format)
            with QueryIngress(server, port=args.port) as ingress:
                print(
                    f"serving PPR on http://127.0.0.1:{ingress.port}/ppr "
                    f"(graph 2**{args.scale} vertices, "
                    f"{server.device_count} device(s), "
                    f"batch {args.max_batch}, "
                    f"deadline {args.deadline_ms:g}ms, warm-up "
                    f"{server.warmup_seconds:.3f}s"
                    + (f", metrics :{exporter.port}" if exporter else "")
                    + ") — SIGTERM drains",
                    flush=True,
                )
                try:
                    while True:
                        drain.check("serve-loop")
                        time.sleep(0.5)
                finally:
                    if exporter is not None:
                        exporter.close()
        except jobs.DrainInterrupt:
            flushed = server.drain(deadline_s=drain.remaining())
            spent = drain.finish()
            if args.run_report:
                # The drain just pushed a flight-recorder snapshot;
                # persist it before the process exits.
                _write_run_report(args.run_report)
            print(
                f"drained: admission closed, {flushed} queued "
                f"query(ies) typed-rejected, {spent:.2f}s spent "
                f"(exit {int(ExitCode.INTERRUPTED)})"
            )
            return int(ExitCode.INTERRUPTED)
        finally:
            if tracer is not None:
                from pagerank_tpu_torch.obs import trace as obs_trace

                obs_trace.disable_tracing()
                tracer.export_chrome(args.query_trace)
            if plane_armed:
                from pagerank_tpu_torch.serving import qtrace

                qtrace.disarm_query_plane()


if __name__ == "__main__":
    sys.exit(main())
