"""Command-line entry point of the port: ``python -m pagerank_tpu_torch.cli``.

Port of the main-path part of ``pagerank_tpu/cli.py``: the flags of
:45-304 and :440-470 that the main path reads (``--partition-span`` and
``--stream-dtype`` with the JAX help text, :156-172; the robustness
flags :230-272; the ingest flags :440-470), ``load_graph`` (:713-869)
for edge lists, ``.npz``, synthetic graphs, crawl TSV/JSONL files and
SequenceFile segments (a file, a directory or a comma list; the SEQ
magic rule), the out-of-core build (``--host-mem-cap-gb``), the
partition-span resolution (:1639-1679, through
``ops/device_build.plan_partition_span``), ``--device-build`` (:64-76,
648-705, 716-869: the graph built on the card by
``ops/device_build.py`` from a seed or the uploaded raw edges, the span
resolved before the build) and the ``--out`` writer (:2305-2320, with
``--top``), whose TSV matches the JAX CLI's, and personalized PageRank
(``--ppr-sources``, ``--ppr-topk``, ``--ppr-chunk``, ``--ppr-dangling``,
:475-493; ``parse_ppr_sources``, ``reject_ppr_incompatible_flags`` and
``run_ppr``, :496-645; the ``--device-build`` refusal, :1439-1443),
and the robustness plane: the per-iteration sinks (``--dump-text-dir``,
``--sync-io``, ``--write-retries``, ``--on-write-failure``, :195-228,
wired as :1705-1860: the async writer by default), the resumable job
(``--job-dir``, ``--drain-deadline``, :242-263, and the stage hooks of
:667-690, :1234-1335, :1551-1585, :1937-2001, :2304-2323) and the
SDC-checked step (``--sdc-check-every``, ``--sdc-seed``,
``--sdc-redo-deadline``, :274-302, with the quarantine hook of :1557).
Every input and sink path may be a URI of a registered scheme
(``utils/fsio``; ``s3://`` through ``utils/s3``). The observability
plane (:305-436): ``--trace``, ``--run-report`` (also on the failure
and drain paths), ``--profile-dir``, ``--history``, ``--probe-every``,
``--probe-topk``, ``--stop-tol``, ``--metrics-textfile``,
``--metrics-port``, ``--device-sample-every``, ``--preflight``,
``--graph-profile``, ``--stall-timeout`` and ``--stall-action
warn|raise|rescue``, wired as :893-1093, :1165, :1538-1545, :1863-1956.
More than one device: ``--num-devices``, ``--vertex-sharded`` and the
vertex-sharded forms' flags (``--halo-exchange``, ``--halo-head``,
``--halo-async``, ``--stale-max-lag``, ``--halo-async-min-gain``,
``--vs-bounded``, :91-146, with the JAX config's refusals). The elastic
solve (``--stall-action rescue``, ``--max-rescues``, wired as
:2088-2145 with the validation of :1464-1490 and the summary of
:936-945, :2228-2242): the ``parallel/elastic.ElasticRunner`` drives the
solve; over ``--num-devices N`` the launcher hosts the group's store and
the survivors of a lost rank regroup and finish (``main`` returns their
code and reports the lost ranks). Under torchrun (``WORLD_SIZE`` set)
``--stall-action rescue`` exits 2: its agent tears the whole worker
group down when a worker exits, so no survivor would be left.
``--ppr-sources`` with ``--num-devices N`` runs the PPR engine's rows
sharded over the group (rank 0 alone prints and writes ``--out``).
Over a group of more than one rank rank 0 owns every output and the
job directory: it decides each job stage's hit or miss and the others
follow (:func:`_job_hit`), only rank 0 submits to the async writer
(the others join the vertex-sharded form's gather of the ranks), and
the drain is agreed by every rank at the stage boundaries of ingest
and build as after every step (:func:`_stage_drain`). The fused run
(``--fused``, :175-182, with the refusals of :1444-1505 and the solve
block of :1957-2074, :2202): ``TorchEngine.run_fused``,
``run_fused_chunked`` between the snapshot and probe points, or
``run_fused_tol`` under ``--tol``, on one device or over a mesh.
The solve runs on ``--device`` (default cuda) through the torch
engines; ``--device cpu``, or ``--engine cpu`` (the f64 oracle), runs it
on a host without a card.

``run(argv)`` is the programmatic entry point (it returns the solve's
summary: ranks, graph, ids, engine, timings, the input format and the
ingest route); ``main(argv)`` wraps it with the SIGTERM/SIGINT drain.
"""

from __future__ import annotations

import argparse
import os
import signal
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from pagerank_tpu_torch.exitcodes import ExitCode
from pagerank_tpu_torch.graph import build_graph
from pagerank_tpu_torch import jobs
from pagerank_tpu_torch.ops.device_build import plan_partition_span
from pagerank_tpu_torch.utils import fsio


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pagerank_tpu_torch.cli",
        description="PageRank with reference (Sparky.java) semantics on an "
        "NVIDIA GPU: blocked-ELL power iteration through a hand-written "
        "CUDA kernel.",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument(
        "--input",
        help="edge list (text: 'src dst' per line), binary .npz with "
        "src/dst (+ n), crawl TSV/JSONL, or Hadoop SequenceFile(s) of "
        "(Text url, Text json): a file, a segment directory, or a "
        "comma-joined list (the reference's input form, "
        "Sparky.java:42-61)")
    src.add_argument("--synthetic", help="synthetic graph: rmat:SCALE or "
                     "uniform:N:E")
    p.add_argument("--format", default="auto",
                   choices=["auto", "edgelist", "npz", "crawl", "seqfile"],
                   help="input format (auto: by extension/magic — 'SEQ' "
                   "magic => seqfile, .npz => npz, text with non-integer "
                   "columns => crawl)")
    p.add_argument(
        "--device-build", action="store_true",
        help="build + pack the graph ON THE DEVICE (ops/device_build): "
        "--synthetic ships only a seed and integer edge inputs "
        "(npz/edgelist) ship 8 bytes/edge instead of the packed layout; "
        "dedup, degrees, the in-degree relabel and the ELL pack run as "
        "torch ops on --device. Crawl/seqfile inputs work too: ids are "
        "assigned host-side (the url->int map is inherently host work), "
        "then the dedup/sort/pack runs on the device with the "
        "reference's uncrawled-targets dangling mask. Requires --engine "
        "torch. Snapshots taken with --device-build resume only with "
        "--device-build (different fingerprint derivation)")
    p.add_argument("--iters", type=int, default=10,
                   help="iterations (reference: 10)")
    p.add_argument("--damping", type=float, default=0.85)
    p.add_argument("--semantics", choices=["reference", "textbook"],
                   default="reference")
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--accum-dtype", default=None,
                   choices=["float32", "float64"], help="defaults to --dtype")
    p.add_argument(
        "--partition-span", type=int, default=0,
        help="partition-centric SpMV layout: sub-bin slots by source "
        "partition of this many vertices so each gather reads one "
        "partition's window of the rank vector (kernel K2). 0 = off "
        "(default layout), -1 = auto (engine rule: dense cells + "
        "resident window, off when not worth it), >0 = explicit span "
        "(rounded down to a multiple of 128). 32-bit accumulation only",
    )
    p.add_argument(
        "--stream-dtype", default="", choices=["", "bfloat16"],
        help="stream the gather windows in this dtype with f32 "
        "accumulation (~half the window bytes for ~2^-9 relative z "
        "quantization). Requires --partition-span (only the "
        "partitioned layout consumes the narrowed stream)",
    )
    p.add_argument("--tol", type=float, default=None,
                   help="L1 early-stop (default: none)")
    p.add_argument(
        "--fused", action="store_true",
        help="run the iteration loop as fused device runs "
        "(TorchEngine.run_fused: the steps queued on the device with no "
        "host sync between them; per-iteration metrics come from "
        "on-device traces and wall-clock is averaged). With "
        "--snapshot-dir, one fused run per --snapshot-every iterations "
        "with snapshots at the boundaries (run_fused_chunked). With "
        "--tol the early stop runs on device (run_fused_tol: masked "
        "chunks; only the final delta/mass exist) or at chunk "
        "boundaries when snapshotting. torch engine only; incompatible "
        "with --dump-text-dir, which needs host control every iteration",
    )
    p.add_argument("--engine", choices=["torch", "cpu"], default="torch",
                   help="torch: the ELL engine on --device (default); cpu: "
                   "the f64 numpy/scipy oracle on the host")
    p.add_argument("--snapshot-dir", default=None,
                   help="write ranks_iter{i}.npz snapshots here")
    p.add_argument("--snapshot-every", type=int, default=1,
                   help="snapshot cadence in iterations; 0 disables "
                   "(reference: every iter)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest valid snapshot")
    p.add_argument(
        "--sync-io", action="store_true",
        help="write snapshots/text dumps synchronously in the iteration "
        "loop instead of overlapping the device->host offload with "
        "compute (AsyncRankWriter)")
    p.add_argument(
        "--dump-text-dir", default=None,
        help="also write plain-text rank dumps per iteration "
        "(PageRank{i}/part-00000 tuple lines, mirroring the reference's "
        "per-iteration saveAsTextFile); a local path or a URI")
    p.add_argument("--out", default=None,
                   help="write final ranks (TSV: id/url, rank)")
    p.add_argument("--top", type=int, default=0,
                   help="write only the N highest-ranked vertices to --out, "
                   "sorted by rank descending (ties by id ascending); 0 = "
                   "the full vector in id order (the reference's dump "
                   "shape, Sparky.java:237)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the torch engine's solve runs (default cuda; "
                   "cpu only when asked)")
    md = p.add_argument_group("more than one device")
    md.add_argument(
        "--num-devices", type=int, default=None,
        help="ranks of the mesh: one process a device (rank i on cuda:i "
        "under nccl, or on the CPU under gloo with --device cpu). Under "
        "torchrun it must equal WORLD_SIZE; otherwise N > 1 starts the N "
        "ranks itself and 1 runs one rank in a group of one. Rank 0 "
        "writes every output")
    md.add_argument(
        "--vertex-sharded", action="store_true",
        help="partition the per-vertex state (rank vector, masks, "
        "1/out-degree) over the mesh instead of replicating it — the "
        "reference's hash-partitioned ranks RDD (Sparky.java:165-170); "
        "per-device state memory scales as 1/num_devices (ell kernel)")
    md.add_argument(
        "--halo-exchange", action="store_true",
        help="with --vertex-sharded: sparse boundary exchange — replace "
        "the dense all_gather + reduce-scatter with build-time halo "
        "tables (head-replication psum + static point-to-point rounds), "
        "so per-iteration exchanged bytes scale with the boundary "
        "instead of n; comms.* counters report the model")
    md.add_argument(
        "--halo-head", type=int, default=-1,
        help="head-replication K for --halo-exchange: -1 auto (the "
        "in-degree prefix whose replication MINIMIZES the modeled "
        "exchange bytes over the build-time read sets — may resolve to "
        "0 on mild graphs), 0 off, >0 explicit (rounded up to a multiple "
        "of 128)")
    md.add_argument(
        "--halo-async", action="store_true",
        help="with --halo-exchange: asynchronous stale-boundary iteration "
        "— double-buffer the boundary so iteration k's K1 overlaps the "
        "exchange of iteration k's boundary outputs (remote reads lag "
        "one iteration); downgrades to the synchronous exchange when the "
        "predicted overlap gain (comms.predicted_overlap_gain) is below "
        "--halo-async-min-gain, the mesh is one device or the plan has no "
        "boundary (the layout records the downgrade)")
    md.add_argument(
        "--stale-max-lag", type=int, default=1, choices=(0, 1),
        help="staleness bound for --halo-async: 1 (default) runs the "
        "double-buffered overlap with boundary reads one iteration "
        "stale; 0 is the exact synchronous path (bit-identical to the "
        "plain sparse exchange, no extra buffers)")
    md.add_argument(
        "--halo-async-min-gain", type=float, default=0.02,
        help="auto-gate threshold for --halo-async: the predicted overlap "
        "gain (exchange fraction x overlappable byte share) below which "
        "the build downgrades to the synchronous exchange; 0 pins the "
        "gate open (useful on toy graphs where the modeled exchange "
        "fraction is negligible)")
    md.add_argument(
        "--vs-bounded", action="store_true",
        help="with --vertex-sharded: owner-computes — dst blocks dealt "
        "over the ranks' ranges, each rank holding only the slot rows of "
        "its own range, so the contribution merge disappears; results "
        "agree with the other forms to accumulation-dtype rounding "
        "(host-built graphs only)")
    ft = p.add_argument_group("fault tolerance")
    ft.add_argument(
        "--write-retries", type=int, default=3,
        help="total attempts per snapshot/text-dump write before the "
        "--on-write-failure policy applies (1 disables retries)")
    ft.add_argument(
        "--on-write-failure", choices=["fail", "warn_and_drop"],
        default="fail",
        help="when a snapshot/dump write exhausts its retries: 'fail' "
        "aborts the run (default); 'warn_and_drop' records the dropped "
        "iteration in a dead_letter.json manifest next to the snapshots "
        "and keeps solving")
    ft.add_argument(
        "--job-dir", default=None, metavar="PATH",
        help="run as a RESUMABLE job: each pipeline stage (ingest -> "
        "build -> solve -> output) persists a checksummed durable "
        "artifact into PATH, snapshots default into PATH/snapshots, and "
        "a restarted job with the same command validates the artifacts "
        "(graph fingerprint + layout geometry + config hash) and SKIPS "
        "completed stages. SIGTERM/SIGINT trigger a graceful drain "
        f"(exit {int(ExitCode.INTERRUPTED)}); corrupt or mismatched "
        "artifacts are recomputed, never trusted")
    ft.add_argument(
        "--drain-deadline", type=float, default=jobs.DEFAULT_DRAIN_DEADLINE_S,
        metavar="SECONDS",
        help="budget for the graceful SIGTERM/SIGINT drain: finish the "
        "in-flight step, flush the async writer (a failing sink still "
        "honors the dead-letter policy), write a final snapshot. A "
        "flush still hanging at the deadline is abandoned with a "
        "warning; a SECOND signal hard-exits 128+signum immediately")
    ft.add_argument(
        "--sdc-check-every", type=int, default=0, metavar="K",
        help="silent-data-corruption defense (sdc.py): every K-th step "
        "runs the checked variant — the same kernel launch and update, "
        "then a dual w.r random-projection fingerprint, link-mass "
        "conservation and the mass-ledger identity. A breach triggers a "
        "deadline-bounded re-execution from the retained device state: "
        "a clean redo is TRANSIENT (counted, continue); a repeat breach "
        "on the same device is STICKY and quarantines it (persisted in "
        "job.json under --job-dir). 0 (default) disables: the solve is "
        "bit-identical with zero check computations")
    ft.add_argument(
        "--sdc-seed", type=int, default=0,
        help="seed of the SDC random-projection fingerprint vector")
    ft.add_argument(
        "--sdc-redo-deadline", type=float, default=30.0, metavar="SECONDS",
        help="wall-clock budget for one SDC breach's bounded "
        "re-execution before the episode escalates")
    ft.add_argument(
        "--max-rescues", type=int, default=None,
        help="elastic-rescue budget under --stall-action rescue: group "
        "teardown + regroup + re-shard + warm-start recoveries after "
        "device losses before failing (default: --max-rollbacks)")
    ft.add_argument("--max-rollbacks", type=int, default=3,
                    help="snapshot rollbacks the self-healing solve loop "
                    "may perform on an unhealthy step (NaN/Inf, mass "
                    "drift) before raising; needs --snapshot-dir to have "
                    "anything to roll back to")
    ft.add_argument("--mass-tol", type=float, default=None,
                    help="opt-in per-step relative rank-mass drift "
                    "tolerance for the health check (default: NaN/Inf "
                    "checks only)")
    ft.add_argument("--no-health-checks", action="store_true",
                    help="disable the per-step solver health check")
    ob = p.add_argument_group("observability")
    ob.add_argument(
        "--trace", default=None, metavar="PATH",
        help="record a span trace of the whole run and export it here: "
        "Chrome trace-event JSON (open in Perfetto / chrome://tracing), "
        "or span-per-line JSONL when PATH ends in .jsonl")
    ob.add_argument(
        "--run-report", default=None, metavar="PATH",
        help="write the run flight-recorder JSON here: environment "
        "fingerprint (torch/CUDA versions, the card's name and power "
        "limit, git), resolved config, span summary, metrics-registry "
        "snapshot, per-iteration history, robustness summary, the "
        "kernel's cost model, the device memory watermark (written on "
        "the failure path too). Implies tracing")
    ob.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler Chrome trace (trace.json) of the "
        "solve here (stopped on every exit path, recorded as a "
        "'profile' span when tracing)")
    ob.add_argument(
        "--history", default=None, metavar="LEDGER",
        help="perf-history ledger (obs/history.py): arm the history.* "
        "baseline-delta gauges from the ledger's median for this run's "
        "leg (named from the engine's layout) and card, and append this "
        "run's normalized record after the solve. A missing ledger "
        "just means no baseline yet; the append creates it")
    ob.add_argument(
        "--probe-every", type=int, default=0, metavar="K",
        help="compute convergence probes every K iterations — L1 "
        "residual, rank mass, top-k churn, top-k mass and the rank-mass "
        "ledger — on the card in the step's own tail, fetched with the "
        "step's scalars in one transfer. Records land in the "
        "per-iteration history, probe.* gauges and the trace. 0 "
        "(default) disables: the unprobed code path")
    ob.add_argument(
        "--probe-topk", type=int, default=64, metavar="N",
        help="top-k set size the probe's churn telemetry tracks")
    ob.add_argument(
        "--stop-tol", type=float, default=None,
        help="early-exit when the PROBED L1 residual reaches this "
        "(checked at probe points only — needs --probe-every; --tol "
        "checks every iteration instead)")
    ob.add_argument(
        "--metrics-textfile", default=None, metavar="PATH",
        help="live Prometheus text-format export of the metrics "
        "registry, atomically rewritten every iteration")
    ob.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="serve the same registry snapshot over HTTP GET /metrics "
        "on 127.0.0.1:PORT (0 = ephemeral)")
    ob.add_argument(
        "--device-sample-every", type=int, default=0, metavar="K",
        help="sample the card's memory (torch.cuda.memory_allocated, "
        "max_memory_allocated, mem_get_info) every K completed steps: "
        "device.<id>.* gauges, counter tracks in the --trace Chrome "
        "export, the high-water mark in the run report. 0 (default) "
        "disarms: the solve loop makes zero sampler calls, and reports "
        "still carry a one-shot sample")
    ob.add_argument(
        "--preflight", action="store_true",
        help="OOM-preflight fit check (obs/devices.fit_check): an "
        "analytic per-stage model of the device build and the placed "
        "engine at this run's geometry against the card's memory "
        "(mem_get_info, or the Hopper table); exits 3 with the table "
        "when it does not fit. Synthetic specs check before any graph "
        "work; file inputs after the parse, before the build")
    ob.add_argument(
        "--graph-profile", action="store_true",
        help="arm the data-plane profiler (obs/graph_profile.py): device "
        "builds compute the structural profile — log2 degree "
        "histograms, dedup/self-loop counts, top hubs, partition skew — "
        "in one pass of reductions over the sorted edges; host builds "
        "profile in numpy. Publishes graph.* gauges, the run report's "
        "`graph` section and, under --job-dir, a checksummed profile "
        "artifact keyed by graph fingerprint. Off: zero profile "
        "computations")
    ob.add_argument(
        "--stall-timeout", type=float, default=None, metavar="SECONDS",
        help="arm the stall watchdog: if no solve step completes within "
        "SECONDS, log a loud diagnostic (last completed iteration and "
        "the card's view)")
    ob.add_argument(
        "--stall-action", choices=["warn", "raise", "rescue"],
        default="warn",
        help="what the watchdog does on a stall: 'warn' logs and keeps "
        "waiting; 'raise' also interrupts the run — the CLI's SIGINT "
        "drain then ends it at the next step boundary (exit 75). A main "
        "thread blocked in a CUDA synchronization sees the interrupt "
        "only when that call returns. 'rescue' runs the solve under the "
        "elastic runner: a lost device (an injected loss, a backend error "
        "of a dead peer, or a stall whose classification finds one) "
        "makes the surviving ranks agree on the dead, regroup, re-shard "
        "and warm-start from the newest snapshot; with more than one rank "
        "the group's collective timeout is bounded by --stall-timeout. "
        "Refused under torchrun")
    p.add_argument("--log-every", type=int, default=1,
                   help="0 silences per-iter logs")
    p.add_argument("--jsonl", default=None,
                   help="append per-iter metrics to this JSONL file")
    p.add_argument("--strict-parse", action="store_true",
                   help="crawl mode: die on bad records")
    p.add_argument(
        "--ingest-workers", type=int, default=None,
        help="parallel parse processes for multi-file SequenceFile "
        "segments (the reference parses its 301 segment files across "
        "the cluster, Sparky.java:61). Setting this selects the Python "
        "process-pool path explicitly (default: the native C++ parser "
        "when available — one thread per core, capped by file count; "
        "1 = serial). Record order (and so vertex ids) is identical on "
        "every path",
    )
    p.add_argument(
        "--no-native-ingest", action="store_true",
        help="force the pure-Python crawl/SequenceFile parser instead "
        "of the native C++ L1 (native/crawl_ingest.cpp)",
    )
    p.add_argument(
        "--host-mem-cap-gb", type=float, default=None,
        help="route the host build through the out-of-core external "
        "sort (ingest/external.py) with this working-memory cap in GiB. "
        "Integer edge inputs (text/.npz) stream directly; "
        "crawl/SequenceFile inputs drain the native L1's edges per "
        "batch into the same sort (the url table, O(vertices), stays "
        "in RAM). Identical graph. Not with --synthetic or "
        "--device-build",
    )
    ppr = p.add_argument_group("personalized PageRank (batched SpMM)")
    ppr.add_argument(
        "--ppr-sources",
        default=None,
        help="run PPR instead of global PageRank: comma-separated vertex "
        "ids, 'random:K' for K random sources, or a file with one id/url "
        "per line",
    )
    ppr.add_argument("--ppr-topk", type=int, default=100,
                     help="top-k ranked vertices reported per source")
    ppr.add_argument("--ppr-chunk", type=int, default=64,
                     help="source-batch columns processed per device pass")
    ppr.add_argument(
        "--ppr-dangling",
        choices=["source", "uniform"],
        default="source",
        help="where dangling mass re-enters (source = standard PPR)",
    )
    return p


def parse_ppr_sources(spec: str, ids, n: int) -> np.ndarray:
    """--ppr-sources value -> vertex id array. Accepts 'random:K', a
    comma list of ids (or urls when the graph has an id map), or a path
    (local, or a URI of a registered scheme) to a file of one id/url
    per line."""

    def resolve(tok: str) -> int:
        tok = tok.strip()
        if tok.lstrip("-").isdigit():
            v = int(tok)
            if not 0 <= v < n:
                raise SystemExit(f"--ppr-sources: id {v} out of range [0, {n})")
            return v
        if ids is None:
            raise SystemExit(
                f"--ppr-sources: {tok!r} is not an integer id and this "
                f"input has no url->id table"
            )
        v = ids.get(tok)
        if v is None:
            raise SystemExit(f"--ppr-sources: unknown url {tok!r}")
        return v

    if spec.startswith("random:"):
        try:
            k = int(spec.split(":", 1)[1])
        except ValueError:
            raise SystemExit(f"--ppr-sources: bad count in {spec!r}")
        if k <= 0:
            raise SystemExit(f"--ppr-sources: count must be positive in {spec!r}")
        rng = np.random.default_rng(0)
        return rng.choice(n, size=min(k, n), replace=False).astype(np.int64)
    # Treat the spec as a source FILE only when it plausibly is one: a
    # local path that exists, or a registered-scheme URI that exists.
    # URL-named vertices (crawl graphs) contain "://": "http://a/,http://b/"
    # resolves through the id map, not as a file.
    scheme = fsio.scheme_of(spec)
    if (fsio.exists(spec) if scheme is not None and fsio.registered(scheme)
            else scheme is None and os.path.exists(spec)):
        with fsio.fopen(spec) as f:
            toks = [ln for ln in (l.strip() for l in f) if ln]
        return np.array([resolve(t) for t in toks], dtype=np.int64)
    return np.array([resolve(t) for t in spec.split(",")], dtype=np.int64)


def reject_ppr_incompatible_flags(args) -> None:
    """Flags that only apply to the global-PageRank path; reject loudly
    rather than silently dropping what the user asked for. Pure-args —
    called before the graph load. The JAX CLI's list over the flags the
    port has, plus the layout flags of the global solve (the PPR engine
    runs the flat form through K1)."""
    ignored = [
        (name, flag)
        for name, flag in (
            ("--semantics", args.semantics != "reference"),
            ("--tol", args.tol is not None),
            ("--snapshot-dir", args.snapshot_dir is not None),
            ("--resume", args.resume),
            ("--jsonl", args.jsonl is not None),
            ("--partition-span", bool(args.partition_span)),
            ("--stream-dtype", bool(args.stream_dtype)),
            ("--vertex-sharded", args.vertex_sharded),
            ("--vs-bounded", args.vs_bounded),
        )
        if flag
    ]
    if ignored:
        raise SystemExit(
            "ppr mode does not support: "
            + ", ".join(name for name, _ in ignored)
        )
    if args.ppr_chunk is not None and args.ppr_chunk <= 0:
        raise SystemExit("--ppr-chunk must be positive")


def run_ppr(args, graph, ids) -> Dict[str, object]:
    """PPR of the ``--ppr-sources`` on ``graph``: ``--engine cpu`` runs
    the f64 oracle, else :class:`~pagerank_tpu_torch.engines.ppr.
    PprTorchEngine` on ``--device``. Writes ``source<TAB>vertex<TAB>
    repr(score)`` rows (keys are urls where the input has an id map) to
    ``--out`` or stdout, as the JAX CLI does; returns ``ppr`` (the
    PprResult), ``engine`` (None for the oracle), ``sources`` and
    ``ppr_seconds`` (engine build and solve, as the stderr line).

    Over ``--num-devices N`` every rank runs the engine over its share
    of the rows on the same sources (``parse_ppr_sources`` derives them
    from the seed and the graph), and rank 0 alone prints and writes."""
    from pagerank_tpu_torch.utils.config import PageRankConfig

    try:
        cfg = PageRankConfig(
            num_iters=args.iters,
            damping=args.damping,
            dtype=args.dtype,
            accum_dtype=args.accum_dtype or args.dtype,
            num_devices=args.num_devices,
        ).validate()
    except ValueError as e:
        raise SystemExit(str(e))
    sources = parse_ppr_sources(args.ppr_sources, ids, graph.n)
    t0 = time.perf_counter()
    eng = None
    if args.engine == "cpu":
        from pagerank_tpu_torch.engines.ppr import ppr_cpu_topk

        print(
            "ppr --engine cpu runs the float64 numpy oracle; "
            "--ppr-chunk/--device/--dtype/--accum-dtype do not apply",
            file=sys.stderr,
        )
        res = ppr_cpu_topk(
            graph, cfg, sources, topk=args.ppr_topk,
            dangling_to=args.ppr_dangling,
        )
    else:
        from pagerank_tpu_torch.engines.ppr import PprTorchEngine

        eng = PprTorchEngine(cfg, dangling_to=args.ppr_dangling,
                             device=args.device).build(graph)
        res = eng.run(sources, topk=args.ppr_topk, chunk=args.ppr_chunk)
    dt = time.perf_counter() - t0
    topk = int(res.topk_ids.shape[1])
    _log(f"ppr: {len(sources)} sources x {args.iters} iters, top-{topk} "
         f"in {dt:.2f}s ({graph.num_edges * len(sources) * args.iters / dt:.3g} "
         f"edge·vectors/s)")
    out = {"ppr": res, "engine": eng, "sources": sources, "ppr_seconds": dt}
    mesh = getattr(eng, "mesh", None)
    if mesh is not None and mesh.rank != 0:
        return out
    names = ids.names if ids is not None else None
    path = args.out
    f = fsio.fopen(path, "w") if path else sys.stdout
    try:
        for si, s in enumerate(res.sources):
            skey = names[s] if names else s
            for v, r in zip(res.topk_ids[si], res.topk_scores[si]):
                vkey = names[v] if names else v
                f.write(f"{skey}\t{vkey}\t{float(r)!r}\n")
    finally:
        if path:
            f.close()
    if path:
        _log(f"wrote {len(res.sources)}x{topk} ppr rows to {path}")
    return out


def _synthetic(spec: str, device=None):
    """(src, dst, n) for a --synthetic spec: the JAX CLI's grammar and
    defaults (rmat scale 20, 16 edges per vertex, seed 0). With a
    ``device`` the edges are generated there (only the seed crosses)."""
    from pagerank_tpu_torch.utils import synth

    if device is not None:
        from pagerank_tpu_torch.ops import device_build as db
    kind, _, rest = spec.partition(":")
    try:
        if kind == "rmat":
            scale = int(rest or 20)
            src, dst = (synth.rmat_edges(scale) if device is None else
                        db.rmat_edges_device(scale, device=device))
            return src, dst, 1 << scale
        if kind == "uniform":
            n_s, _, e_s = rest.partition(":")
            n, e = int(n_s), int(e_s or 16 * int(n_s))
            src, dst = (synth.uniform_edges(n, e) if device is None else
                        db.uniform_edges_device(n, e, device=device))
            return src, dst, n
    except ValueError:
        pass
    raise SystemExit(f"unknown synthetic spec {spec!r}")


def detect_format(args) -> str:
    """The input's format: ``--format`` unless "auto"; then a directory
    or comma list is a SequenceFile segment (its first file must carry
    the SEQ magic), a file starting with ``SEQ`` and a version byte <= 6
    is a SequenceFile, ``.npz`` is binary edges, a text file whose first
    non-comment line is two integers is an edge list, anything else a
    crawl TSV/JSONL (``pagerank_tpu/cli.py:743-785``)."""
    from pagerank_tpu_torch.ingest.seqfile import expand_seqfile_paths

    fmt, path = args.format, args.input
    if fmt != "auto":
        return fmt
    probe = path
    if fsio.isdir(path) or ("," in path and not fsio.exists(path)):
        probe = expand_seqfile_paths(path)[0]
    with fsio.fopen(probe, "rb") as fb:
        magic = fb.read(4)
    # A text file that merely starts with "SEQ" ("SEQ\t", "SEQ\n")
    # falls through to the text detection: the version byte must be one
    # the reader supports.
    if magic[:3] == b"SEQ" and len(magic) == 4 and magic[3] <= 6:
        return "seqfile"
    if probe != path:
        raise SystemExit(
            f"{path}: directory / comma-list inputs are for Hadoop "
            f"SequenceFile segments, but {probe} has no SEQ magic")
    if path.endswith(".npz"):
        return "npz"
    with fsio.fopen(path, "r", errors="replace") as f:
        first = f.readline()
        while first.startswith("#"):
            first = f.readline()
    tokens = first.split()
    return ("edgelist" if len(tokens) == 2
            and all(t.lstrip("-").isdigit() for t in tokens) else "crawl")


def load_graph(args, cfg):
    """``(graph, ids, info)`` for the run's input (``cfg`` is the run's
    config, which plans a device build's layout): the graph (a
    ``DeviceEllGraph`` under ``--device-build``), the IdMap of a crawl
    input (else None), and ``info``: ``format``, ``ingest_route`` (the
    parser that ran: "native" or "python"), ``ingest_threads`` (the
    native L1's threads, else None), ``input_seconds`` (read, parse or
    generate) and ``graph_seconds`` (``build_graph``, or the device
    build; 0.0 where the out-of-core build does both); a device build
    adds ``partition_span`` (resolved before the build),
    ``device_build_seconds`` (its four stages) and, for file inputs,
    ``upload_seconds``."""
    from pagerank_tpu_torch.ingest import edgelist as el

    if args.host_mem_cap_gb and (args.device_build or args.synthetic):
        # Never silently drop a memory-bound promise.
        raise SystemExit(
            "--host-mem-cap-gb applies to the HOST build of file inputs "
            "(text/.npz/crawl/SequenceFile); it cannot combine with "
            "--device-build or --synthetic")
    info = {"format": "synthetic", "ingest_route": "python",
            "ingest_threads": None, "graph_seconds": 0.0}
    t0 = time.perf_counter()
    if args.synthetic:
        if args.device_build:
            info["ingest_route"] = "device"
            *edges, n = _synthetic(args.synthetic, device=_device(args))
            return _device_build(args, cfg, info, t0, edges, n), None, info
        src, dst, n = _synthetic(args.synthetic)
        return _build(info, t0, src, dst, n=n), None, info
    fmt = info["format"] = detect_format(args)
    path = args.input
    mem_cap = (int(args.host_mem_cap_gb * (1 << 30))
               if args.host_mem_cap_gb else None)
    if fmt in ("seqfile", "crawl"):
        return _load_crawl(args, cfg, fmt, mem_cap, info, t0)
    if mem_cap:
        from pagerank_tpu_torch.ingest import external

        graph = external.build_graph_external(path, mem_cap_bytes=mem_cap)
        info["input_seconds"] = time.perf_counter() - t0
        return graph, None, info
    if fmt == "npz":
        src, dst, n = el.load_binary_edges(path)
    else:
        (src, dst), info["ingest_route"] = el.load_edgelist_routed(path)
        n = None
    if args.device_build:
        if n is None:  # mirror build_graph's max + 1
            n = int(max(src.max(), dst.max())) + 1 if len(src) else 0
        edges = [src, dst]
        del src, dst
        return _device_build(args, cfg, info, t0, edges, n), None, info
    return _build(info, t0, src, dst, n=n), None, info


def _device(args):
    from pagerank_tpu_torch.engines.torch_engine import resolve_device

    return resolve_device(args.device)


def _sync(dev):
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def _device_build(args, cfg, info, t0, edges, n, dangling_mask=None,
                  names=None):
    """The graph built on the device from the raw ``edges`` = [src, dst]
    — device tensors (a seed crossed) or host arrays, uploaded once (8 B
    an edge) — with the span planned first over the raw edge count, as
    the JAX CLI's ``_device_build_graph`` does: lane group 1, the
    resolved partition span as the stripe span, no weight plane. The
    list is emptied, so the build holds the only references to the
    edges and frees them before its sort's peak. Times the load (from
    ``t0``), the upload and the build into ``info``."""
    import torch

    from pagerank_tpu_torch.ops import device_build as db

    if n == 0:
        raise ValueError("empty graph: no vertices")
    dev = _device(args)
    _sync(dev)  # edges generated on the device are there: time the load
    job = getattr(args, "_job", None)
    if job is not None:
        # Resumable-job hook (armed by _job_load_graph): a file input's
        # raw edges (and a crawl's names) become the ingest artifact
        # BEFORE the build, so a job killed mid-build resumes without
        # re-parsing. A seed's edges are on the device: only the seed
        # crossed, nothing worth persisting.
        if not isinstance(edges[0], torch.Tensor):
            arrays = {"src": np.asarray(edges[0]),
                      "dst": np.asarray(edges[1])}
            if dangling_mask is not None:
                arrays["dangling_mask"] = np.asarray(dangling_mask)
            job.save_stage_artifact(
                "ingest", arrays,
                {"key": args._job_key, "kind": "raw_edges", "n": int(n)})
            if names is not None:
                job.save_names(names, args._job_key)
            job.complete("ingest")
        else:
            job.complete("ingest", synthetic=True)
        job.begin("build")
    t1 = time.perf_counter()
    info["input_seconds"] = t1 - t0
    preflight = getattr(args, "_preflight", None)
    if preflight is not None:
        # --preflight of a file input: after the parse, before the
        # edges reach the card.
        preflight(n, len(edges[0]))
    stripe = info["partition_span"] = (plan_partition_span(
        cfg, n, len(edges[0]), args.partition_span)
        if args.partition_span else 0)
    if not isinstance(edges[0], torch.Tensor):
        edges[:] = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
                    .to(dev) for a in edges]
        if dangling_mask is not None:
            dangling_mask = torch.from_numpy(dangling_mask).to(dev)
        _sync(dev)
        t2 = time.perf_counter()
        info["upload_seconds"] = t2 - t1
        t1 = t2
    timings = {}
    dg = db.build_ell_device(edges.pop(0), edges.pop(0), n,
                             stripe_size=stripe, with_weights=False,
                             dangling_mask=dangling_mask, timings=timings,
                             device=dev)
    info["graph_seconds"] = time.perf_counter() - t1
    info["device_build_seconds"] = dict(timings)
    return dg


def _build(info, t0, src, dst, **kw):
    """build_graph on loaded edges, timing the load (from ``t0``) and
    the build into ``info``."""
    t1 = time.perf_counter()
    info["input_seconds"] = t1 - t0
    graph = build_graph(src, dst, **kw)
    info["graph_seconds"] = time.perf_counter() - t1
    return graph


def _load_crawl(args, cfg, fmt, mem_cap, info, t0):
    """Crawl TSV/JSONL or SequenceFile input: the native L1 unless
    ``--no-native-ingest`` or ``--ingest-workers`` asks for the Python
    parser (or its library is unavailable, which the route reports);
    then the graph build with the uncrawled-targets dangling mask."""
    from pagerank_tpu_torch.ingest import native as native_mod
    from pagerank_tpu_torch.ingest.crawljson import load_crawl_file_routed
    from pagerank_tpu_torch.ingest.seqfile import (
        expand_seqfile_paths, load_crawl_seqfile_routed)

    native = "off" if args.no_native_ingest else "auto"
    paths = expand_seqfile_paths(args.input) if fmt == "seqfile" else [
        args.input]
    kind = "seqfile" if fmt == "seqfile" else "tsv"
    if mem_cap:
        # Out-of-core: native L1 batches drained into the external
        # sort. Without the native path the memory bound cannot be
        # kept, so it is refused, never dropped.
        if native == "off":
            raise SystemExit(
                "--host-mem-cap-gb with crawl/SequenceFile inputs needs "
                "the native ingest path; drop --no-native-ingest")
        res = native_mod.crawl_load_external(
            paths, kind, mem_cap_bytes=mem_cap, strict=args.strict_parse,
            threads=args.ingest_workers)
        if res is None:
            raise SystemExit(
                "--host-mem-cap-gb with crawl/SequenceFile inputs needs "
                "the native library (g++ and zlib), which is unavailable: "
                f"{native_mod.build_error('crawl_ingest')}")
        info.update(ingest_route="native",
                    ingest_threads=native_mod.default_threads(
                        paths, args.ingest_workers),
                    input_seconds=time.perf_counter() - t0)
        return res[0], res[1], info
    if fmt == "seqfile":
        (src, dst, crawled, ids), route = load_crawl_seqfile_routed(
            args.input, strict=args.strict_parse,
            workers=args.ingest_workers, native=native, raw=True)
    else:
        (src, dst, crawled, ids), route = load_crawl_file_routed(
            args.input, strict=args.strict_parse, native=native, raw=True)
    info["ingest_route"] = route
    if route == "native":
        info["ingest_threads"] = native_mod.default_threads(paths, None)
    if args.device_build:
        edges = [src, dst]
        del src, dst
        return _device_build(args, cfg, info, t0, edges, len(ids),
                             dangling_mask=~crawled,
                             names=ids.names), ids, info
    graph = _build(info, t0, src, dst, n=len(ids), dangling_mask=~crawled,
                   vertex_names=ids.names)
    return graph, ids, info


def _log(msg: str) -> None:
    """A line on stderr; over a mesh only rank 0 logs."""
    from pagerank_tpu_torch.parallel import distributed

    if distributed.process_info()[0] == 0:
        print(msg, file=sys.stderr, flush=True)


def resolve_layout(cfg, args, graph, part=None):
    """``cfg`` with the run's partition span and stream dtype: the
    span resolved by :func:`plan_partition_span` (``part`` when a
    device build resolved it already); an explicit span the planner
    refused exits with the config error; ``--stream-dtype`` without a
    resolved span is dropped with a note on stderr."""
    if args.partition_span:
        if part is None:
            part = plan_partition_span(cfg, graph.n, graph.num_edges,
                                       args.partition_span)
        if part:
            cfg = cfg.replace(partition_span=part)
        elif args.partition_span > 0:
            try:
                cfg.replace(partition_span=args.partition_span).validate()
            except ValueError as e:
                raise SystemExit(str(e))
    if args.stream_dtype:
        if cfg.partition_span:
            cfg = cfg.replace(stream_dtype=args.stream_dtype)
        else:
            _log("--stream-dtype needs the partitioned layout "
                 "(--partition-span); running without the narrowed stream")
    return cfg.validate()


def _usage(msg: str):
    """Print a usage error and exit with the taxonomy's USAGE code."""
    print(msg, file=sys.stderr)
    raise SystemExit(int(ExitCode.USAGE))


def _check_args(args) -> None:
    """Pure-args validation before any work (``pagerank_tpu/cli.py:
    1435-1535``): the fused, rescue, SDC and job flags keep the JAX
    CLI's refusals."""
    if args.fused:
        # --tol is fused-compatible: its early stop runs on the device.
        bad = [flag for flag, on in (
            ("--dump-text-dir", args.dump_text_dir is not None),
            ("--ppr-sources", bool(args.ppr_sources)),
        ) if on]
        if bad:
            _usage(f"--fused runs the loop in fused device dispatches; "
                   f"{', '.join(bad)} need host control every iteration")
        if args.engine != "torch":
            _usage("--fused requires --engine torch")
    if args.stall_action == "rescue":
        # Rescue rebuilds the engine over the survivors, which needs the
        # stepwise loop and a host graph to re-shard (a device-built
        # graph is not kept).
        bad = [flag for flag, on in (
            ("--fused", args.fused),
            ("--device-build", args.device_build),
            ("--ppr-sources", bool(args.ppr_sources)),
        ) if on]
        if bad:
            _usage(f"--stall-action rescue re-shards the graph onto a "
                   f"rebuilt mesh (stepwise loop, host-built graph); "
                   f"incompatible with {', '.join(bad)}")
        if args.engine != "torch":
            _usage("--stall-action rescue requires --engine torch")
        if _torchrun():
            _usage("--stall-action rescue under torchrun: its agent tears "
                   "the whole worker group down when one worker exits, so "
                   "no survivor would be left to rescue onto; launch the "
                   "ranks with --num-devices N instead")
    world = _world(args)
    if world < 1:
        _usage("--num-devices must be >= 1")
    if (world > 1 or args.vertex_sharded) and args.engine != "torch":
        _usage("--num-devices/--vertex-sharded run the torch engine "
               "(the cpu oracle is one host process)")
    if args.probe_every < 0:
        _usage("--probe-every must be >= 0")
    if args.device_sample_every < 0:
        _usage("--device-sample-every must be >= 0")
    if args.stall_timeout is not None and args.stall_timeout <= 0:
        _usage("--stall-timeout must be positive")
    if args.preflight and args.engine != "torch":
        _usage("--preflight sizes against the card's memory; it requires "
               "--engine torch")
    if args.resume and not args.snapshot_dir and not args.job_dir:
        raise SystemExit("--resume needs --snapshot-dir")
    if args.snapshot_every < 0:
        raise SystemExit(f"snapshot_every must be >= 0 (0 disables), got "
                         f"{args.snapshot_every}")
    if args.device_build and args.engine != "torch":
        raise SystemExit("--device-build requires --engine torch")
    if args.device_build and args.ppr_sources:
        raise SystemExit("--device-build does not support --ppr-sources "
                         "(the PPR engine builds from a host graph)")
    if args.ppr_sources:
        reject_ppr_incompatible_flags(args)
    if args.sdc_check_every:
        if args.sdc_check_every < 0:
            _usage("--sdc-check-every must be >= 0")
        if args.fused:
            _usage("--sdc-check-every drives the stepwise loop (bounded "
                   "re-execution needs host control between steps); "
                   "incompatible with --fused")
        if args.engine != "torch":
            _usage("--sdc-check-every requires --engine torch (the ABFT "
                   "invariants are device measurements)")
    if args.job_dir:
        if args.ppr_sources:
            _usage("--job-dir does not support --ppr-sources (the stage "
                   "machine covers the global-PageRank pipeline)")
        if args.drain_deadline <= 0:
            _usage("--drain-deadline must be positive")
        if not args.snapshot_dir:
            args.snapshot_dir = fsio.join(args.job_dir, "snapshots")
        args.resume = True


def _input_stamp(path):
    """Best-effort identity of a LOCAL input beyond its path string:
    (size, mtime_ns) — a file regenerated in place between runs must
    not let a resumed job serve the old graph's artifacts. Remote
    paths, comma lists and vanished files give None: the checksum and
    fingerprint still guard the artifacts' integrity."""
    if not path:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    return [int(st.st_size), int(st.st_mtime_ns)]


def _job_graph_key(args) -> str:
    """Hash of everything that determines the ingest/build artifacts'
    content (input spec and layout-shaping args): artifacts of another
    input or layout never satisfy this run's stages."""
    return jobs.key_hash({
        "input": args.input or args.synthetic,
        "input_stamp": _input_stamp(args.input),
        "format": args.format,
        "strict_parse": bool(args.strict_parse),
        "device_build": bool(args.device_build),
        "host_mem_cap_gb": args.host_mem_cap_gb,
        "dtype": args.dtype,
        "accum_dtype": args.accum_dtype or args.dtype,
        "partition_span": args.partition_span,
        "device": args.device if args.device_build else None,
    })


def _restored_info(t0) -> Dict[str, object]:
    return {"format": "restored", "ingest_route": "restored",
            "ingest_threads": None,
            "input_seconds": time.perf_counter() - t0, "graph_seconds": 0.0}


def _stage_drain(drain):
    """The drain check at the stage boundaries of ingest and build, and
    after a job's solve: ``drain.check`` on one rank; over a group of
    more than one rank ``drain.check_agreed`` through a sum of the
    request flag over the default group (there is no engine or mesh
    yet), so that a signal to any one rank stops every rank at the same
    boundary. Every rank reaches these boundaries in the same order."""
    from pagerank_tpu_torch.parallel import distributed

    if distributed.process_info()[1] == 1:
        return drain.check
    return lambda where: drain.check_agreed(distributed.group_sum, where)


def _open_job(directory):
    """The run's job supervisor. Over a group rank 0's owns the
    directory and every other rank's is a follower
    (``JobSupervisor(write=False)``), made after a barrier that follows
    rank 0's manifest write, so that it reads this run's manifest."""
    from pagerank_tpu_torch.parallel import distributed

    rank, world = distributed.process_info()
    if world == 1:
        return jobs.JobSupervisor(directory)
    job = jobs.JobSupervisor(directory) if rank == 0 else None
    distributed.group_barrier()
    return job or jobs.JobSupervisor(directory, write=False)


def _job_hit(job, stage, expect, restore):
    """A job stage's artifact as ``restore(arrays, meta)`` gives it, or
    None to recompute the stage. Rank 0 validates the artifact and
    decides; over a group every rank follows its decision (one
    broadcast), and the others read the artifact only after it, so a
    rank never skips a stage another runs. A restore that raises
    ``ValueError`` or ``ArtifactCorruptError`` on rank 0 rejects the
    artifact; on another rank, after rank 0 accepted it, it raises."""
    import warnings

    from pagerank_tpu_torch.parallel import distributed

    got = None
    lead = distributed.process_info()[0] == 0
    if lead:
        hit = job.load_stage_artifact(stage, expect=expect)
        if hit is not None:
            try:
                got = restore(*hit)
            except (ValueError, jobs.ArtifactCorruptError) as e:
                warnings.warn(f"job {stage} artifact rejected ({e}); "
                              "recomputing", RuntimeWarning)
    if not distributed.rank0_decides(got is not None):
        return None
    if not lead:
        hit = job.load_stage_artifact(stage, expect=expect)
        if hit is None:
            raise RuntimeError(
                f"job {stage} artifact in {job.directory} was accepted by "
                f"rank 0 and does not load here")
        got = restore(*hit)
    return got


def _job_load_graph(args, cfg, job, drain):
    """The ingest and build stages of a resumable job
    (``pagerank_tpu/cli.py:1234-1335``): restore the graph from a
    validated artifact keyed to this run, else run the loaders and
    persist the artifacts. A host build's artifact is the built Graph
    (the engine packs at its own build); a device build's is the packed
    planes (``checkpoint_arrays``), with the raw edges of a file input
    saved as the ingest artifact before the build. Corrupt or
    mismatched artifacts are recomputed, never trusted. Over a group
    rank 0 decides every hit (:func:`_job_hit`) and alone writes, and
    the drain checks are agreed (:func:`_stage_drain`)."""
    check = _stage_drain(drain)
    key = _job_graph_key(args)
    t0 = time.perf_counter()
    if not args.device_build:
        hit = _job_hit(job, "ingest", {"key": key}, lambda arrays, meta: (
            jobs.graph_from_arrays(arrays, meta), arrays, meta))
        if hit is not None:
            graph, arrays, meta = hit
            job.skip("ingest", fingerprint=meta.get("fingerprint"))
            job.skip("build", note="host layout packs at engine build")
            names = jobs.decode_names(arrays)
            return (graph, jobs.RestoredIds(names) if names else None,
                    _restored_info(t0))
        job.begin("ingest")
        graph, ids, info = load_graph(args, cfg)
        if job.write:
            arrays, meta = jobs.graph_to_arrays(graph)
            meta["key"] = key
            job.save_stage_artifact("ingest", arrays, meta)
            fp = meta["fingerprint"]
        else:
            fp = graph.fingerprint()
        job.complete("ingest", fingerprint=fp)
        job.begin("build")
        job.complete("build", note="host layout packs at engine build")
        # Drain AFTER the artifact commit: the resume skips this work.
        check("ingest")
        return graph, ids, info

    from pagerank_tpu_torch.ops import device_build as db

    hit = _job_hit(job, "build", {"key": key}, lambda arrays, meta: (
        db.restore_device_graph(arrays, meta, device=_device(args)), meta))
    if hit is not None:
        graph, meta = hit
        job.skip("ingest", note="covered by build artifact")
        job.skip("build", fingerprint=meta.get("fingerprint"))
        info = _restored_info(t0)
        info["partition_span"] = int(meta.get("partition_span") or 0)
        names = job.load_names(key)
        return graph, (jobs.RestoredIds(names) if names else None), info
    graph = ids = None
    if not args.synthetic:
        # A prior run may have died DURING the build: the raw-edges
        # ingest artifact still skips the host parse.
        ing = _job_hit(job, "ingest", {"key": key},
                       lambda arrays, meta: (arrays, meta))
        if ing is not None:
            arrs, imeta = ing
            job.skip("ingest")
            check("ingest")
            names = job.load_names(key)
            ids = jobs.RestoredIds(names) if names else None
            job.begin("build")
            info = _restored_info(t0)
            mask = arrs.get("dangling_mask")
            graph = _device_build(args, cfg, info, t0,
                                  [arrs["src"], arrs["dst"]],
                                  int(imeta["n"]), dangling_mask=mask)
    if graph is None:
        # Fresh run: the loaders, with the hook armed so _device_build
        # persists a file input's raw edges and marks the stages.
        args._job, args._job_key = job, key
        try:
            graph, ids, info = load_graph(args, cfg)
        finally:
            args._job = None
    if job.write:
        arrays, meta = db.checkpoint_arrays(graph)
        meta["key"] = key
        if info.get("partition_span"):
            meta["partition_span"] = int(info["partition_span"])
        job.save_stage_artifact("build", arrays, meta)
    job.complete("build", fingerprint=graph.fingerprint())
    check("build")
    return graph, ids, info


def _s3_retry_total(paths) -> int:
    """Transparent request retries across the distinct S3FileSystem
    instances serving the given paths (for the robustness summary)."""
    from pagerank_tpu_torch.utils.s3 import S3FileSystem

    seen, total = set(), 0
    for p in paths:
        scheme = fsio.scheme_of(p) if p else None
        if scheme is None or not fsio.registered(scheme):
            continue
        fs = fsio.get_fs(p)
        if isinstance(fs, S3FileSystem) and id(fs) not in seen:
            seen.add(id(fs))
            total += fs.retry_stats.retries
    return total


def _robustness_line(args, engine, guard, dead_letter) -> None:
    """The robustness summary on stderr (``pagerank_tpu/cli.py:
    2195-2242``), printed only when something is worth reporting:
    rollbacks, elastic rescues, write retries, SDC breaches, S3 request
    retries and dropped writes."""
    from pagerank_tpu_torch import sdc as sdc_mod

    rb = _robustness_summary(args, engine, guard)
    rollbacks, rescues = rb["rollbacks"], rb["rescues"]
    sdc = sdc_mod.report_section()
    detected = int(sdc.get("flips_detected", 0)) if sdc else 0
    io_retries = rb["s3_request_retries"]
    if not (rollbacks or rescues or guard.retries or guard.dropped
            or io_retries or detected):
        return
    parts = [f"{rollbacks} rollback(s)", f"{guard.retries} write retr(y/ies)"]
    if rescues:
        parts.append(f"{rescues} elastic rescue(s) ({rb['devices_lost']} "
                     f"device(s) lost)")
    if detected:
        parts.append(f"{detected} SDC breach(es) ({sdc['transient']} "
                     f"transient, {len(sdc['quarantined_devices'])} "
                     f"quarantined chip(s))")
    if io_retries:
        parts.append(f"{io_retries} s3 request retr(y/ies)")
    if guard.dropped:
        parts.append(
            f"{len(guard.dropped)} DROPPED write(s) (iterations "
            f"{[d['iteration'] for d in guard.dropped]}"
            + (f", manifest {dead_letter}" if dead_letter else "") + ")")
    _log("robustness: " + ", ".join(parts))


def _publish_graph_profile(args, graph, engine, job) -> None:
    """--graph-profile (``pagerank_tpu/cli.py:893-930``): make sure a
    profile exists and is published — a device build computed it in the
    build, a resumed job restores the checksummed artifact keyed by
    graph fingerprint, a host build profiles in numpy at the layout the
    engine packed — and persist the job artifact. Telemetry: never
    fails the run. Then the skew-driven load prediction for this run's
    mesh (``parallel/comms``) is attached and published."""
    from pagerank_tpu_torch.obs import graph_profile
    from pagerank_tpu_torch.parallel import comms

    try:
        prof = graph_profile.get_profile()
        restored = False
        if prof is None and job is not None:
            prof = job.load_profile(graph.fingerprint())
            if prof is not None:
                graph_profile.publish(prof)
                restored = True
        if prof is None and hasattr(graph, "in_degree"):
            lay = engine.layout_info() if hasattr(engine, "layout_info") \
                else {}
            group, span = graph_profile.layout_profile_geometry(lay)
            prof = graph_profile.profile_graph(graph, group=group,
                                               partition_span=span)
            graph_profile.publish(prof)
        if prof is None:
            return  # device graph restored without its artifact
        mesh = getattr(engine, "mesh", None)
        pred = comms.predict_from_profile(
            prof, mesh.world if mesh is not None else 1)
        comms.publish_prediction(pred)
        prof.prediction = pred
        if job is not None and not restored:
            job.save_profile(prof)
    except Exception as e:  # telemetry must not fail the solve
        _log(f"pagerank_tpu_torch: graph profile publish failed ({e!r})")


def _robustness_summary(args, engine, guard) -> dict:
    """The run's robustness counters as one dict
    (``pagerank_tpu/cli.py:947-969``): the stderr line and the run
    report read it."""
    from pagerank_tpu_torch import obs

    counters = obs.get_registry().snapshot()["counters"]
    return {
        "rollbacks": (getattr(engine, "health", {}) or {}).get(
            "rollbacks", 0) or 0,
        "rescues": int(counters.get("elastic.rescues", 0)),
        "devices_lost": int(counters.get("elastic.devices_lost", 0)),
        "write_retries": guard.retries,
        "dropped_writes": len(guard.dropped),
        "s3_request_retries": _s3_retry_total(
            (args.snapshot_dir, args.dump_text_dir, args.out, args.jsonl)),
        "sdc_flips_detected": int(counters.get("sdc.flips_detected", 0)),
        "sdc_transient_flips": int(counters.get("sdc.transient_flips", 0)),
        "sdc_quarantined_devices": int(
            counters.get("sdc.quarantined_devices", 0)),
    }


def _env_class(device):
    """(backend, card name) of the run's device: the environment class a
    perf-history baseline is taken within."""
    if device is not None and device.type == "cuda":
        import torch

        return ("cuda", torch.cuda.get_device_name(device))
    return ("cpu", "cpu")


def _arm_history_baseline(ledger_path, layout, graph, device) -> None:
    """--history, the live half (``pagerank_tpu/cli.py:963-1000``): the
    ledger's robust baseline (median of the trailing window) of
    edges/s/chip for THIS run's leg within THIS card's class, armed as
    the ``history.*`` gauges. Advisory: an unreadable or empty ledger
    means no baseline."""
    from pagerank_tpu_torch.obs import history as history_mod
    from pagerank_tpu_torch.obs import live as obs_live

    try:
        records = history_mod.read_ledger(ledger_path)
    except ValueError as e:
        _log(f"pagerank_tpu_torch: perf ledger unreadable ({e}); no "
             "baseline armed")
        return
    leg = history_mod.leg_name_for_layout(layout)
    pts = history_mod.series(records, leg, "edges_per_sec_per_chip",
                             klass=_env_class(device))
    vals = [v for _, v in pts][-history_mod.DEFAULT_DETECTION["window"]:]
    if not vals:
        _log(f"pagerank_tpu_torch: perf ledger {ledger_path} has no "
             f"'{leg}' records for this card; no baseline armed")
        return
    med, _mad = history_mod.median_mad(vals)
    obs_live.arm_history_baseline(obs_live.HistoryBaseline(
        leg=leg, baseline_eps=med, num_edges=int(graph.num_edges),
        num_chips=1, n_baseline=len(vals)))


def _append_history_record(args, report) -> None:
    """--history, the durable half (``pagerank_tpu/cli.py:1003-1035``):
    this run's run report normalized to a RunRecord and appended to the
    ledger (content-hash deduped). Never fails the run."""
    from pagerank_tpu_torch.obs import history as history_mod

    try:
        rec = history_mod.normalize_result(report, source="cli")
        added = history_mod.append_record(args.history, rec)
    except (OSError, ValueError) as e:
        _log(f"pagerank_tpu_torch: perf-history append failed: {e!r}")
        return
    _log(("appended run record to" if added else "run record already in")
         + f" perf ledger {args.history}")


def _build_report(args, ctx, error=None, interrupted=None) -> dict:
    """The run report of whatever run state ``ctx`` holds
    (``pagerank_tpu/cli.py:1038-1093``): every section present, the
    failure and interrupt markers set."""
    from pagerank_tpu_torch import obs
    from pagerank_tpu_torch import sdc as sdc_mod

    graph, engine = ctx.get("graph"), ctx.get("engine")
    metrics, probes = ctx.get("metrics"), ctx.get("probes")
    guard = ctx.get("guard")
    job = ctx.get("job")
    extra = {
        "graph": ({"n": int(graph.n), "num_edges": int(graph.num_edges),
                   **obs.graph_profile.report_section()}
                  if graph is not None else None),
        "engine": args.engine,
        "fused": bool(args.fused),
        "failed": error is not None,
        "interrupted": interrupted is not None,
        "probes": probes.history if probes is not None else [],
        "sdc": sdc_mod.report_section(),
        "layout": (engine.layout_info() if hasattr(engine, "layout_info")
                   else ctx.get("layout")),
    }
    if error is not None:
        extra["error"] = repr(error)
    if interrupted is not None:
        extra["interrupt_signal"] = getattr(interrupted, "signum", None)
    return obs.build_run_report(
        config=ctx.get("cfg"), tracer=ctx.get("tracer"),
        registry=obs.get_registry(),
        history=metrics.history if metrics is not None else [],
        summary=(metrics.summary(**ctx.get("fused_summary", {}))
                 if metrics is not None else {}),
        robustness=(_robustness_summary(args, engine, guard)
                    if guard is not None else {}),
        job=job.report_section() if job is not None else None,
        extra=extra,
    )


def _export_observability(args, ctx, error=None, interrupted=None):
    """Write the --trace export and the --run-report artifact; on the
    failure and drain paths too (best-effort there: never masks the
    primary error). Returns the report when one was built."""
    from pagerank_tpu_torch import obs

    tracer = ctx.get("tracer")
    if tracer is None or not tracer.enabled:
        return None
    try:
        if args.trace:
            tracer.export(args.trace)
            _log(f"wrote trace to {args.trace}")
        if not args.run_report:
            return None
        report = _build_report(args, ctx, error, interrupted)
        obs.write_run_report(args.run_report, report)
        _log(f"wrote run report to {args.run_report}")
        return report
    except Exception as e2:
        if error is None and interrupted is None:
            raise
        _log(f"pagerank_tpu_torch: observability export failed: {e2!r}")
        return None


def _torchrun() -> bool:
    """Whether this process was started by torchrun (``WORLD_SIZE`` set)
    and not by ``main``'s own launcher (whose ranks reach its store)."""
    from pagerank_tpu_torch.parallel import distributed

    return (bool(os.environ.get("WORLD_SIZE"))
            and distributed.launcher_store() is None
            and not os.environ.get(distributed.STORE_ENV))


def _world(args) -> int:
    """The mesh size of this run: ``--num-devices``, else torchrun's
    ``WORLD_SIZE``, else 1."""
    if args.num_devices is not None:
        return int(args.num_devices)
    env = os.environ.get("WORLD_SIZE")
    return int(env) if env else 1


def _synthetic_geometry(spec: str):
    """(n, raw num_edges, scale-or-None) of a --synthetic spec, or None
    when it is malformed: the grammar and defaults of :func:`_synthetic`
    (rmat scale 20, 16 edges a vertex)."""
    kind, _, rest = spec.partition(":")
    try:
        if kind == "rmat":
            scale = int(rest or 20)
            return 1 << scale, 16 << scale, scale
        if kind == "uniform":
            n_s, _, e_s = rest.partition(":")
            n = int(n_s)
            return n, int(e_s or 16 * n), None
    except ValueError:
        return None
    return None


def _run_preflight(args, cfg, n: int, num_edges: int, scale,
                   device_build: bool) -> None:
    """--preflight (``pagerank_tpu/cli.py:1152-1178``): the fit check at
    THIS run's geometry (its planned span and stream dtype); exits 3
    with the per-stage table when the card cannot hold it."""
    from pagerank_tpu_torch.obs import devices as obs_devices

    span = (plan_partition_span(cfg, n, num_edges, args.partition_span)
            if args.partition_span else 0)
    res = obs_devices.fit_check(
        scale if device_build else None, n=n, num_edges=num_edges,
        dtype=args.dtype, accum_dtype=args.accum_dtype or args.dtype,
        device_build=device_build,
        generated=bool(args.synthetic) and device_build,
        partition_span=span,
        stream_dtype=args.stream_dtype if span else "",
        ndev=_world(args), vertex_sharded=bool(args.vertex_sharded),
    )
    _log(obs_devices.render_fit(res))
    if not res.fits:
        raise SystemExit(int(ExitCode.PREFLIGHT_UNFIT))


def run(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Load, build, solve and write outputs; returns the summary:
    ``ranks`` (host, original id order), ``graph``, ``ids`` (the IdMap
    of a crawl input, else None), ``engine`` (None when a job's solve
    stage was restored), ``resumed_from``, ``iterations``,
    ``step_seconds`` (one per step, each ending in a device sync; the
    sinks are not in them), ``snapshot_seconds`` and ``dump_seconds``
    (one per save and per text dump, timed where they ran: on the
    writer's thread unless ``--sync-io``), ``queue_wait_seconds`` (the
    async writer's waits on a full queue), ``decode_seconds`` (the
    fetch of the ranks to the host for the sinks: the async writer's
    decode of each payload, or ``engine.ranks()`` under ``--sync-io``),
    ``writer_item_seconds`` (each async item's whole wall on the
    writer's thread), ``writer`` ("async", "sync"
    or None), ``dump_route`` (the text formatter that ran, else None),
    ``solve_seconds`` (the solve's wall to the last flushed write),
    ``out_seconds`` (the ``--out`` write, else None), ``format`` (the
    detected input format; "restored" from a job artifact),
    ``ingest_route`` ("native", "python" or "restored"),
    ``ingest_threads``, ``input_seconds``, ``graph_seconds``
    (build_graph, or the device build's wall), ``sort_route``
    (``Graph.sort_route``; "device" under ``--device-build``),
    ``device_build_seconds``, ``upload_seconds``,
    ``engine_build_seconds`` (pack, plan and placement; its split is in
    ``engine.layout_info()["build_seconds"]``), the layout that ran
    (``form``, ``partition_span``, ``partitions``, ``num_rows``),
    ``sdc`` (the SDC section, empty when off), ``dropped`` (writes
    dropped under ``--on-write-failure warn_and_drop``), ``job``
    (the job manifest, else None) and ``report`` (the run report dict,
    else None). With ``--ppr-sources`` it returns,
    after the load, ``graph``, ``ids``, the load's timings and what
    :func:`run_ppr` returns. No signal handler is installed here (see
    :func:`main`)."""
    args = build_parser().parse_args(argv)
    return _run(args, jobs.GracefulDrain(deadline_s=args.drain_deadline))


def _run(args, drain) -> Dict[str, object]:
    """:func:`run` on parsed ``args`` under ``drain`` (a
    :class:`~pagerank_tpu_torch.jobs.GracefulDrain`, installed by
    :func:`main`): a drain request surfaces as
    :class:`~pagerank_tpu_torch.jobs.DrainInterrupt` after the writer
    was flushed, a final snapshot and the interrupted-marked run report
    written. Whatever way it ends, the tracer, the watchdog, the
    sampler, the history baseline and the graph profiler are disarmed,
    and a failing run still writes its trace and failure-marked
    report (``pagerank_tpu/cli.py:1339-1357``)."""
    from pagerank_tpu_torch import obs

    ctx = {"args": args}
    try:
        return _run_body(args, drain, ctx)
    except jobs.DrainInterrupt as e:
        _export_observability(args, ctx, interrupted=e)
        raise
    except BaseException as e:
        _export_observability(args, ctx, error=e)
        raise
    finally:
        obs.disable_tracing()
        obs.disarm_watchdog()
        obs.disarm_sampler()
        obs.disarm_history_baseline()
        obs.graph_profile.disarm()


def _drain_check(drain, engine):
    """The solve's drain check: ``drain.check`` on one rank, and over a
    mesh of more than one rank ``drain.check_agreed`` through a psum of
    the request flag, so that every rank stops after the same step."""
    mesh = getattr(engine, "mesh", None)
    if mesh is None or mesh.world == 1:
        return drain.check
    import torch

    from pagerank_tpu_torch.parallel import mesh as mesh_lib

    flag = torch.zeros((), dtype=torch.int32, device=engine.device)

    def reduce(x: int) -> int:
        flag.fill_(x)
        return int(mesh_lib.psum(mesh, flag))

    return lambda where: drain.check_agreed(reduce, where)


def _drop_quarantined(job, quarantined) -> int:
    """A group job's members that a prior run of the job quarantined
    leave before the build (``pagerank_tpu/cli.py:1726-1752``): rank 0
    decides the set from its manifest (one broadcast), the launcher's
    store records it as the generation's verdict, a quarantined
    member's process leaves (``RankLeftError``, as a member the elastic
    path names does) and the others regroup over the rest. Returns the
    world the build runs on. Exits with ``mesh.surviving_devices``'
    wording when every member is quarantined, and without the
    launcher's store (torchrun) when there is none to regroup
    through."""
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.parallel.elastic import RankLeftError

    members = list(distributed.members())
    mask = distributed.rank0_decides(sum(
        1 << i for i, m in enumerate(members) if m in quarantined))
    bad = [m for i, m in enumerate(members) if mask >> i & 1]
    if not bad:
        return len(members)
    survivors = [m for m in members if m not in bad]
    if not survivors:
        raise SystemExit(f"no surviving devices: all of {members} "
                         f"reported dead")
    if distributed.launcher_store() is None:
        raise SystemExit(
            f"member(s) {bad} of this group were quarantined for silent "
            f"data corruption by a prior run of this job "
            f"({job.manifest_path}); without the launcher's store "
            f"(torchrun) there is no store to regroup the others through: "
            f"relaunch it over the other devices")
    distributed.declare_dead(bad)
    me = distributed.member()
    if me in bad:
        raise RankLeftError(
            f"member {me} was quarantined for silent data corruption by a "
            f"prior run of this job ({job.manifest_path}); the members "
            f"{survivors} build on", device_ids=[me])
    distributed.regroup(survivors)
    _log(f"excluding quarantined device(s) {sorted(quarantined)} (job "
         f"manifest); building on {len(survivors)} device(s)")
    return len(survivors)


def _elastic_runner(args, cfg, graph, ref, drain, snap, roll_snap, job,
                    ctx):
    """The elastic runner of ``--stall-action rescue``
    (``pagerank_tpu/cli.py:2088-2145``): a factory building a fresh
    engine over the survivors from the host graph, ``on_rebuild``
    re-binding the engine holder, its drain check, the run context and
    the snapshot ``mesh_meta`` (with the quarantined members),
    ``exclude_device_ids`` from the job's persisted quarantine, and a
    DeviceHealthMonitor at the configured straggler factor. At one device
    without a group it wraps the plain run, as in JAX."""
    from pagerank_tpu_torch.engines.torch_engine import TorchEngine
    from pagerank_tpu_torch.parallel.elastic import (DeviceHealthMonitor,
                                                     ElasticRunner,
                                                     snapshot_meta_after)

    def factory(members):
        return TorchEngine(cfg.replace(num_devices=len(members)),
                           device=args.device).build(graph)

    box = {}

    def rebound(engine):
        ref["engine"] = engine
        mesh = getattr(engine, "mesh", None)
        if job is not None and (mesh is None or mesh.rank == 0):
            # Rank 0 of the group a rescue formed owns the job now.
            job.write = True
        ref["drain"] = _drain_check(drain, engine)
        ctx["engine"] = engine
        ctx["layout"] = engine.layout_info()
        if snap is not None:
            snap.mesh_meta = snapshot_meta_after(engine, box.get("runner"))

    # Conviction persistence rides the sdc quarantine hook (set at job
    # creation): it fires AT conviction time, before the rescue starts.
    quarantined = job.quarantined_devices() if job is not None else ()
    runner = ElasticRunner(
        ref["engine"], factory, snapshotter=roll_snap,
        max_rescues=cfg.robustness.rescue_budget(),
        monitor=DeviceHealthMonitor(
            straggler_factor=cfg.robustness.straggler_factor),
        on_rebuild=rebound, exclude_device_ids=sorted(quarantined))
    box["runner"] = runner
    return runner


def _run_body(args, drain, ctx) -> Dict[str, object]:
    from pagerank_tpu_torch import obs
    from pagerank_tpu_torch import sdc as sdc_mod
    from pagerank_tpu_torch.engine import make_engine
    from pagerank_tpu_torch.engines.torch_engine import (
        TorchEngine, resolve_device)
    from pagerank_tpu_torch.utils.config import (PageRankConfig,
                                                 RobustnessConfig)
    from pagerank_tpu_torch.utils.metrics import MetricsLogger
    from pagerank_tpu_torch.utils.snapshot import (
        AsyncRankWriter, SinkGuard, Snapshotter, TextDumper,
        WriterSyncedSnapshotter, resume_engine)

    from pagerank_tpu_torch.parallel import distributed

    _check_args(args)
    rank, world = distributed.process_info()
    owner = rank == 0
    rescue = args.stall_action == "rescue"
    # The outputs written once the solve has ended: under rescue over a
    # group a rank that is not rank 0 now may be after a rescue (rank 0
    # of the new group owns every output), so it keeps them aside.
    deferred = {}
    # What a rank other than 0 sets aside: rank 0 of the group a job's
    # quarantine leaves (below) takes every output back.
    outputs = ("out", "jsonl", "run_report", "trace", "history",
               "metrics_textfile", "metrics_port", "profile_dir",
               "log_every")
    nulled = {name: getattr(args, name) for name in outputs}
    if not owner:
        # Rank 0 owns every output: the ranks file, the text dumps and
        # snapshots, --jsonl, the report, trace, history, metrics and
        # logs. The other ranks compute and read (a resume or rollback
        # reads rank 0's snapshots).
        if rescue:
            deferred = {name: nulled[name] for name in
                        ("out", "run_report", "trace", "history")}
        for name in outputs[:-1]:
            setattr(args, name, None)
        args.log_every = 0
    try:
        cfg = PageRankConfig(
            num_iters=args.iters, damping=args.damping,
            num_devices=args.num_devices,
            vertex_sharded=args.vertex_sharded,
            vs_bounded=args.vs_bounded, halo_exchange=args.halo_exchange,
            halo_head=args.halo_head, halo_async=args.halo_async,
            stale_max_lag=args.stale_max_lag,
            halo_async_min_gain=args.halo_async_min_gain,
            semantics=args.semantics, dtype=args.dtype,
            accum_dtype=args.accum_dtype or args.dtype, tol=args.tol,
            probe_every=args.probe_every, probe_topk=args.probe_topk,
            stop_tol=args.stop_tol,
            sdc_check_every=args.sdc_check_every, sdc_seed=args.sdc_seed,
            robustness=RobustnessConfig(
                health_checks=not args.no_health_checks,
                mass_tol=args.mass_tol, max_rollbacks=args.max_rollbacks,
                write_attempts=args.write_retries,
                on_write_failure=args.on_write_failure,
                sdc_redo_deadline_s=args.sdc_redo_deadline,
                max_rescues=args.max_rescues),
        ).validate()
    except ValueError as e:
        raise SystemExit(str(e))
    if args.engine == "torch":
        resolve_device(args.device)  # raises without a card, before work
    # Observability state is per run, never inherited from an earlier
    # in-process run (``pagerank_tpu/cli.py:1533-1545``).
    obs.disable_tracing()
    obs.get_registry().reset()
    obs.costs.reset()
    obs.graph_profile.reset()
    sdc_mod.reset()
    if args.graph_profile:
        # Armed BEFORE the load, so a device build profiles in its own
        # pass; disarmed in _run's finally.
        obs.graph_profile.arm()
    # A rank other than 0 may come to own the outputs (after a rescue,
    # or when a job's manifest drops member 0 before the build): it
    # traces from the start, so a report it writes holds every span.
    may_own = owner or rescue or (args.job_dir and world > 1)
    tracer = (obs.enable_tracing()
              if may_own and (nulled["trace"] or nulled["run_report"])
              else obs.get_tracer())
    ctx["tracer"], ctx["cfg"] = tracer, cfg
    job = _open_job(args.job_dir) if args.job_dir else None
    ctx["job"] = job
    if job is not None and args.sdc_check_every:
        # Convictions persist AT conviction time: a sticky chip lands
        # in job.json before the quarantine error raises.
        sdc_mod.set_quarantine_hook(job.quarantine_devices)
    if args.preflight and args.synthetic:
        # The spec alone gives the geometry: the check runs before any
        # graph work.
        geo = _synthetic_geometry(args.synthetic)
        if geo is None:
            raise SystemExit(f"unknown synthetic spec {args.synthetic!r}")
        _run_preflight(args, cfg, *geo, device_build=args.device_build)
    if args.preflight and not args.synthetic:
        args._preflight = lambda n, e: _run_preflight(
            args, cfg, n, e, None, device_build=True)

    try:
        with tracer.span("load"):
            if job is not None:
                graph, ids, info = _job_load_graph(args, cfg, job, drain)
            else:
                graph, ids, info = load_graph(args, cfg)
    except ValueError as e:
        # e.g. "empty graph: no vertices": a clean CLI error
        raise SystemExit(str(e))
    finally:
        args._preflight = None
    ctx["graph"] = graph
    _stage_drain(drain)("ingest")
    if args.preflight and not args.synthetic and not args.device_build:
        # A host build: the engine's placement is the device allocation.
        _run_preflight(args, cfg, graph.n, graph.num_edges, None,
                       device_build=False)
    threads = (f", {info['ingest_threads']} threads"
               if info["ingest_threads"] else "")
    sort_route = "device" if args.device_build else graph.sort_route
    stages = info.get("device_build_seconds")
    detail = ""
    if stages is not None:
        upload = info.get("upload_seconds")
        split = ", ".join(f"{k[:-2]} {v:.3f}" for k, v in stages.items())
        detail = (f"{f', upload {upload:.3f} s' if upload is not None else ''}"
                  f"; {split} s; {graph.num_rows:,} slot rows")
    _log(f"graph: n={graph.n:,} edges={graph.num_edges:,} ({info['format']} "
         f"input, {info['ingest_route']} ingest{threads} "
         f"{info['input_seconds']:.3f} s, {sort_route or 'no'} sort, "
         f"build {info['graph_seconds']:.3f} s{detail})")
    if args.ppr_sources:
        return {"graph": graph, "ids": ids, **info, "sort_route": sort_route,
                **run_ppr(args, graph, ids)}
    if args.engine == "torch":
        cfg = resolve_layout(cfg, args, graph, info.get("partition_span"))
    ctx["cfg"] = cfg

    # The solve stage of a job: a validated final-ranks artifact of a
    # completed prior solve satisfies it outright (no engine is built).
    solve_fp = solve_hash = solve_hit = None
    if job is not None:
        solve_fp = graph.fingerprint()
        solve_hash = jobs.solve_config_hash(cfg)
        # Snapshots scoped by solve config: a rerun with other solve
        # flags must not warm-start the old config's trajectory.
        args.snapshot_dir = fsio.join(args.snapshot_dir, solve_hash)
        solve_hit = _job_hit(
            job, "solve",
            {"fingerprint": solve_fp, "solve_config": solve_hash},
            lambda arrays, meta: (arrays, meta))
    guard = SinkGuard()
    ctx["guard"] = guard
    dead_letter = None
    step_s: List[float] = []
    save_s: List[float] = []
    dump_s: List[float] = []
    fetch_s: List[float] = []
    writer = dumper = engine = probes = exporter = watchdog = None
    resumed, build_s, solve_s = 0, 0.0, None
    lay = {"form": None, "partition_span": 0}
    if solve_hit is not None:
        ranks = solve_hit[0]["ranks"]
        job.skip("solve", iterations=solve_hit[1].get("iterations"))
        _log("solve stage satisfied by durable artifact "
             f"({solve_hit[1].get('iterations')} iteration(s) recorded)")
        iterations = solve_hit[1].get("iterations")
        if args.graph_profile:
            _publish_graph_profile(args, graph, None, job)
    else:
        if job is not None:
            job.begin("solve")
        t0 = time.perf_counter()
        with tracer.span("engine/build"):
            if args.engine == "cpu":
                engine = make_engine("cpu", cfg).build(graph)
                lay = {"form": "cpu_f64", "partition_span": 0}
                _log(f"engine: the f64 oracle on the host (build "
                     f"{time.perf_counter() - t0:.3f} s)")
            else:
                from pagerank_tpu_torch.parallel.mesh import device_id

                quarantined = (set(job.quarantined_devices())
                               if job is not None else set())
                if world > 1 and job is not None:
                    group = world
                    world = _drop_quarantined(job, quarantined)
                    if world != group:
                        cfg = cfg.replace(num_devices=world).validate()
                        ctx["cfg"] = cfg
                        if distributed.process_info()[0] == 0 and not owner:
                            # Rank 0 of the smaller group owns the job
                            # and every output now.
                            job.write = True
                            for name, value in nulled.items():
                                setattr(args, name, value)
                elif device_id(resolve_device(args.device)) in quarantined:
                    # One device: a chip a prior run of this job
                    # convicted of sticky corruption leaves nothing to
                    # build on.
                    raise SystemExit(
                        f"device {args.device} was quarantined for silent "
                        f"data corruption by a prior run of this job "
                        f"({job.manifest_path}); no device is left")
                engine = TorchEngine(cfg, device=args.device)
                ctx["engine"] = engine
                if args.device_build:
                    engine.build_device(graph)
                else:
                    engine.build(graph)
                lay = engine.layout_info()
                _log_layout(lay, time.perf_counter() - t0)
        ctx["engine"], ctx["layout"] = engine, lay
        build_s = time.perf_counter() - t0
        # A rescue REPLACES the engine mid-run (regroup + rebuild over
        # the survivors), so every closure below reaches the engine, its
        # drain check and its ownership through this holder.
        ref = {"engine": engine, "drain": _drain_check(drain, engine)}

        def owns() -> bool:
            mesh = getattr(ref["engine"], "mesh", None)
            return mesh is None or mesh.rank == 0

        # A signal during the engine build surfaces here, not after a
        # whole first iteration.
        ref["drain"]("solve")
        if args.graph_profile:
            _publish_graph_profile(args, graph, engine, job)

        snap = None
        if args.snapshot_dir:
            snap = Snapshotter(args.snapshot_dir, graph.fingerprint(),
                               cfg.semantics, mesh_meta=engine.snapshot_meta())
            if args.resume:
                try:
                    resumed = resume_engine(engine, snap)
                except ValueError as e:
                    # A job dir reused for another graph: recompute
                    # from r0, never trust (a plain --resume refuses).
                    if job is None:
                        raise
                    import warnings

                    warnings.warn(f"job snapshots do not match this graph "
                                  f"({e}); solving from r0", RuntimeWarning)
                    resumed = 0
                if resumed:
                    _log(f"resumed from iteration {resumed}")
        metrics = MetricsLogger(graph.num_edges, world,
                                log_every=args.log_every,
                                jsonl_path=args.jsonl)
        ctx["metrics"] = metrics
        if args.history:
            dev = getattr(engine, "device", None)
            _arm_history_baseline(args.history, lay, graph, dev)
        if args.dump_text_dir:
            dumper = TextDumper(args.dump_text_dir,
                                names=ids.names if ids is not None else None)

        def write_sinks(i, payload):
            # THE single sink path: async and --sync-io runs write the
            # same bytes. Over a mesh every rank fetched the ranks (a
            # collective on the vertex-sharded form); rank 0 writes.
            if not owns():
                return
            want_snap, ranks = payload
            if want_snap:
                t = time.perf_counter()
                snap.save(i + 1, ranks)
                save_s.append(time.perf_counter() - t)
            if dumper is not None:
                t = time.perf_counter()
                dumper.dump(i, ranks)
                dump_s.append(time.perf_counter() - t)

        if args.on_write_failure == "warn_and_drop":
            base = args.snapshot_dir or args.dump_text_dir
            if base:
                dead_letter = fsio.join(base, "dead_letter.json")
        guard = SinkGuard(retry_policy=cfg.robustness.write_retry_policy(),
                          on_failure=args.on_write_failure,
                          dead_letter_path=dead_letter)
        ctx["guard"] = guard
        # Async offload: the loop submits the engine's payload (a copy
        # to pinned host memory on a side stream) and keeps stepping; a
        # worker thread decodes it and feeds the sinks. --sync-io keeps
        # the reference-like barrier; the f64 oracle's ranks are on the
        # host already, so it stays synchronous.
        can_write = dumper is not None or (snap and args.snapshot_every)
        if can_write and args.engine == "torch" and not args.sync_io:
            writer = AsyncRankWriter(
                lambda p: (p[0], ref["engine"].decode_ranks(p[1])),
                [write_sinks], guard=guard)

        # Convergence probes: --probe-every 0 leaves this None and the
        # solve loop makes zero probe calls.
        if args.probe_every:
            probes = obs.ConvergenceProbes(
                args.probe_every, topk=args.probe_topk,
                stop_tol=args.stop_tol)
        ctx["probes"] = probes
        # Built (and argument-checked) before the exporter spawns its
        # HTTP thread; armed right before the solve.
        if args.stall_timeout:
            # Classification echoes the SOLVE's own device (tracking
            # the rebuilt engine after a rescue), not every visible card.
            watchdog = obs.StallWatchdog(
                args.stall_timeout, action=args.stall_action,
                device_source=lambda: [ref["engine"].device])
        if args.device_sample_every:
            # The run's own card (a foreign process's memory on a
            # shared host is not this run's watermark).
            dev = getattr(engine, "device", None)
            obs.arm_sampler(obs.DeviceSampler(
                every=args.device_sample_every,
                devices=[dev] if dev is not None else None))
        if args.metrics_textfile or args.metrics_port is not None:
            exporter = obs.MetricsExporter(textfile=args.metrics_textfile,
                                           port=args.metrics_port)
            if exporter.port is not None:
                _log(f"serving metrics on http://127.0.0.1:{exporter.port}"
                     f"/metrics")
        # A seeded process-kill plan (testing/faults.ProcessKillPlan, its
        # environment variable) reaches a mesh run's ranks at their step
        # boundaries; a job's stage machine checks it itself.
        chaos = None
        if job is None and world > 1:
            from pagerank_tpu_torch.testing.faults import ProcessKillPlan

            chaos = ProcessKillPlan.from_env()
        t_last = [time.perf_counter()]

        def on_iteration(i, step_info):
            step_s.append(time.perf_counter() - t_last[0])
            metrics.record(i, step_info, step_s[-1])
            if exporter is not None:
                exporter.write_textfile()
            want_snap = bool(snap and args.snapshot_every
                             and (i + 1) % args.snapshot_every == 0)
            if want_snap or dumper is not None:
                if not owns():
                    # Rank 0 writes: this rank only joins the gather of
                    # the vertex-sharded form, in step order.
                    ref["engine"].join_rank_fetch()
                elif writer is not None:
                    writer.submit(i, (want_snap,
                                      ref["engine"].device_ranks()))
                else:
                    # One device->host fetch for both sinks, outside the
                    # guard: a retried write never repeats a collective.
                    t = time.perf_counter()
                    ranks = ref["engine"].ranks()
                    fetch_s.append(time.perf_counter() - t)
                    guard(i, lambda: write_sinks(i, (want_snap, ranks)))
            # Preemption points, AFTER this step's sinks were queued:
            # the seeded chaos plan may deliver its signal here and a
            # pending drain request surfaces here.
            if job is not None:
                job.tick("solve", i)
            elif chaos is not None:
                chaos.check("solve", i)
            ref["drain"]("solve")
            t_last[0] = time.perf_counter()

        roll_snap = snap
        if snap is not None and writer is not None:
            # Rollback scans drain the writer's queue first; over a group
            # every rank then waits for rank 0's writes to be on disk.
            def mesh_barrier():
                mesh = getattr(ref["engine"], "mesh", None)
                if mesh is not None:
                    mesh.barrier()

            roll_snap = WriterSyncedSnapshotter(snap, writer,
                                                barrier=mesh_barrier)
        runner = None
        if rescue:
            runner = _elastic_runner(args, cfg, graph, ref, drain, snap,
                                     roll_snap, job, ctx)
        ctx["runner"] = runner
        if watchdog is not None:
            obs.arm_watchdog(watchdog)
        interrupted = None
        t_solve = time.perf_counter()
        try:
            with obs.profiler_session(args.profile_dir), \
                    tracer.span("solve", iters=cfg.num_iters):
                if runner is not None:
                    ranks = runner.run(on_iteration=on_iteration,
                                       probes=probes)
                elif args.fused:
                    ranks, ctx["fused_summary"] = _fused_solve(
                        args, engine, snap, writer, guard, write_sinks,
                        probes, exporter, ref["drain"], metrics, tracer,
                        owns())
                else:
                    ranks = engine.run(on_iteration=on_iteration,
                                       snapshotter=roll_snap, probes=probes)
        except jobs.DrainInterrupt as di:
            interrupted = di
        finally:
            propagating = sys.exc_info()[0] is not None
            obs.disarm_watchdog()
            metrics.close()
            try:
                if exporter is not None:
                    exporter.close()
                if writer is not None:
                    # A drain bounds the flush by its deadline: a
                    # hanging sink is abandoned (warned and counted).
                    writer.close(timeout=drain.remaining()
                                 if drain.requested else None)
            except Exception:
                if not propagating:
                    raise
        solve_s = time.perf_counter() - t_solve
        engine = ref["engine"]
        if deferred and owns():
            # Rank 0 of the group a rescue formed: its outputs now.
            for name, value in deferred.items():
                setattr(args, name, value)
        if interrupted is not None:
            # Final snapshot of the drained state (the last completed
            # step), then the manifest, then the interrupt.
            if snap is not None:
                try:
                    ranks_now = engine.ranks()  # every rank: a collective
                    if owns():
                        guard(engine.iteration, lambda: snap.save(
                            engine.iteration, ranks_now))
                except Exception as e:
                    _log(f"pagerank_tpu_torch: final drain snapshot "
                         f"failed: {e!r}")
            if job is not None:
                job.interrupt("solve", iteration=int(engine.iteration),
                              signal=interrupted.signum)
            raise interrupted
        iterations = engine.iteration
        step_seconds = None  # the step the cost model's share is of
        if step_s:
            ms = statistics.median(step_s) * 1e3
            sinks = ""
            if save_s:
                sinks += (f", snapshot save median "
                          f"{statistics.median(save_s) * 1e3:.3f} ms")
            if dump_s:
                sinks += (f", text dump median "
                          f"{statistics.median(dump_s) * 1e3:.3f} ms "
                          f"({dumper.route})")
            if writer is not None:
                sinks += (f", async writer (queue wait "
                          f"{sum(writer.queue_wait_s) * 1e3:.3f} ms)")
            _log(f"solve: {len(step_s)} iteration(s), median {ms:.3f} "
                 f"ms/iter, {graph.num_edges / (ms / 1e3):.4g} edges/s, "
                 f"wall {solve_s:.3f} s to the last write{sinks}")
            step_seconds = ms / 1e3
        summ = metrics.summary(**ctx["fused_summary"]) if args.fused else {}
        if summ:
            # The JAX CLI's line: the true iteration count and the
            # averaged wall of the fused run.
            eps = summ["edges_per_sec_per_chip"]
            _log(f"done: {summ['iters']} iters, "
                 f"{summ['mean_iter_seconds'] * 1e3:.2f} ms/iter"
                 + (f", {eps:.4g} edges/s/chip" if eps is not None else ""))
            step_seconds = summ["mean_iter_seconds"]
        if step_seconds is not None:
            # The kernel's cost model, with the measured step attached:
            # the report's costs section (achieved share of the bound).
            for form, rep in (getattr(engine, "cost_reports", dict)()
                              ).items():
                obs.costs.record_report(rep)
                obs.costs.attach_measurement(form, step_seconds)
        if job is not None:
            # Durable solve artifact: a later restart skips straight to
            # the output stage.
            job.save_stage_artifact(
                "solve", {"ranks": np.asarray(ranks)},
                {"fingerprint": solve_fp, "solve_config": solve_hash,
                 "iterations": int(iterations)})
            job.complete("solve", iterations=int(iterations))
            _stage_drain(drain)("solve")
    _robustness_line(args, engine, guard, dead_letter)

    out_s = None
    if job is not None:
        job.begin("output")
    if args.out:
        t0 = time.perf_counter()
        with tracer.span("output"):
            n_out = write_ranks(args.out, ranks,
                                ids.names if ids is not None else None,
                                args.top)
        out_s = time.perf_counter() - t0
        _log(f"wrote {n_out:,} ranks to {args.out}")
    if job is not None:
        job.complete("output", out=args.out)
        job.finish()
    report = _export_observability(args, ctx)
    if args.history:
        _append_history_record(args, report if report is not None
                               else _build_report(args, ctx))
    if job is not None:
        skipped = [s for s, r in job.manifest["stages"].items()
                   if r.get("skipped")]
        _log(f"job complete in {args.job_dir} (resume "
             f"#{job.manifest['resumes']}, {len(skipped)} stage(s) "
             f"satisfied by durable artifacts"
             + (f": {', '.join(skipped)}" if skipped else "") + ")")
    return {
        "ranks": ranks, "graph": graph, "ids": ids, "engine": engine,
        "resumed_from": resumed, "iterations": iterations,
        "step_seconds": step_s, "snapshot_seconds": save_s,
        "dump_seconds": dump_s,
        "queue_wait_seconds": (list(writer.queue_wait_s)
                               if writer is not None else []),
        "decode_seconds": (list(writer.decode_s)
                           if writer is not None else fetch_s),
        "writer_item_seconds": (list(writer.item_s)
                                if writer is not None else []),
        "writer": ("async" if writer is not None else
                   "sync" if (save_s or dump_s) else None),
        "dump_route": dumper.route if dumper is not None else None,
        "solve_seconds": solve_s,
        "out_seconds": out_s, "format": info["format"],
        "ingest_route": info["ingest_route"],
        "ingest_threads": info["ingest_threads"],
        "input_seconds": info["input_seconds"],
        "graph_seconds": info["graph_seconds"],
        "sort_route": sort_route,
        "device_build_seconds": info.get("device_build_seconds"),
        "upload_seconds": info.get("upload_seconds"),
        "engine_build_seconds": build_s,
        "form": lay["form"], "partition_span": lay["partition_span"],
        "partitions": lay.get("partitions", 1),
        "num_rows": lay.get("num_rows"),
        "sdc": sdc_mod.report_section(),
        "dropped": list(guard.dropped),
        "job": dict(job.manifest) if job is not None else None,
        "elastic": _elastic_summary(ctx.get("runner")),
        "report": report,
    }


def _fused_solve(args, engine, snap, writer, guard, write_sinks, probes,
                 exporter, drain_check, metrics, tracer, owner=True):
    """The solve as fused device runs (``pagerank_tpu/cli.py:1957-2074``):
    chunks between the host-visible points (the gcd of the snapshot and
    probe cadences) through ``run_fused_chunked``, else one
    ``run_fused_tol`` (``--tol``) or ``run_fused``, with
    ``prepare_fused`` outside the timed window. At a chunk boundary: the
    drain check, the probe and ``--stop-tol`` at probe points, the
    exporter's textfile, and a snapshot on the stepwise loop's absolute
    cadence through the async writer or the guarded sync path (so both
    modes write the same files). One record an executed iteration with
    the run's averaged wall (the tol form has its final iteration's
    only). ``owner`` is false on a rank of a group other than rank 0,
    which only joins the gather of the ranks at a snapshot. Returns
    ``(ranks, the metrics summary's iters and total_seconds)``."""
    import math

    first = engine.iteration
    snap_every = (args.snapshot_every
                  if (snap is not None and args.snapshot_every) else 0)
    cadences = [c for c in (snap_every, args.probe_every) if c]
    chunk_every = math.gcd(*cadences) if cadences else 0
    if chunk_every and chunk_every < min(cadences):
        # Neither cadence divides the other: the gcd can be far below
        # both (1 when coprime: a host sync every step).
        _log(f"--snapshot-every {snap_every} and --probe-every "
             f"{args.probe_every} share no cadence; fused chunks drop to "
             f"gcd={chunk_every} iterations — align one to a multiple of "
             f"the other to keep dispatches fused")
    engine.prepare_fused(tol=args.tol, every=chunk_every or None)
    t_run = time.perf_counter()
    if chunk_every:
        def on_chunk(done_iters, ranks_thunk, traces):
            drain_check("solve")
            # --stop-tol fires at probe points only: a snapshot-only
            # boundary never ends the solve.
            stop = False
            if probes is not None and done_iters % args.probe_every == 0:
                rec = probes.probe_boundary(
                    engine, done_iters - 1, l1_delta=float(traces[0][-1]))
                stop = probes.should_stop(rec)
            if exporter is not None:
                exporter.write_textfile()
            # No snapshot at an off-cadence final remainder; the rank
            # copy is made only when the thunk is called.
            if not snap_every or done_iters % snap_every != 0:
                return stop
            if not owner:
                engine.join_rank_fetch()
            elif writer is not None:
                writer.submit(done_iters - 1, (True, ranks_thunk()))
            else:
                ranks_now = engine.decode_ranks(ranks_thunk())
                guard(done_iters - 1, lambda: write_sinks(
                    done_iters - 1, (True, ranks_now)))
            return stop

        ranks = engine.run_fused_chunked(every=chunk_every,
                                         on_chunk=on_chunk, tol=args.tol)
    elif args.tol is not None:
        ranks = engine.run_fused_tol(args.tol)
    else:
        ranks = engine.run_fused()
    total = time.perf_counter() - t_run
    traces = engine.last_run_metrics
    deltas = traces["l1_delta"].cpu().numpy()
    masses = traces["dangling_mass"].cpu().numpy()
    done = engine.iteration - first
    if tracer.enabled:
        tracer.add_span("solve/fused", t_run, total, iters=done)
    for i in range(len(deltas) if done else 0):
        it = first + (i if len(deltas) == done else done - 1)
        metrics.record(it, {"l1_delta": deltas[i],
                            "dangling_mass": masses[i]},
                       total / max(1, done), timing="averaged")
    return ranks, {"iters": done, "total_seconds": total}


def _elastic_summary(runner):
    """What the elastic runner did (None when it did not drive the
    solve): rescues, restarts, lost and quarantined members, the final
    mesh's members and each rescue's wall by part."""
    if runner is None:
        return None
    return {"rescues": runner.rescues, "restarts": runner.restarts,
            "lost": list(runner.lost_device_ids),
            "quarantined": list(runner.quarantined_device_ids),
            "members": [int(d) for d in runner.engine.device_ids()],
            "walls": list(runner.rescue_walls)}


def _log_layout(lay, build_s):
    if lay["partition_span"]:
        detail = (f"span {lay['partition_span']:,}, K={lay['partitions']} "
                  f"partitions, {lay['pairs']:,} pairs, "
                  f"{'words24' if lay['words24'] else 'int32 words'}, "
                  f"{lay['z_dtype']} windows, ")
    else:
        detail = ""
    _log(f"engine: {lay['form']} on {lay['device']}, kernel {lay['kernel']}, "
         f"{detail}{lay['num_rows']:,} slot rows in {lay['num_segments']:,} "
         f"segments (build {build_s:.3f} s)")


def write_ranks(path: str, ranks: np.ndarray, names=None, top: int = 0) -> int:
    """Write ``key<TAB>repr(rank)`` lines (the key is the vertex's name
    when ``names`` is given, else its id): the full vector in id order,
    or with ``top`` > 0 the ``top`` highest ranks, rank descending and
    ties by id ascending (a total order before the cut, so boundary
    ties select by id), clamped to n. Returns the lines written."""
    if top > 0:
        k = min(top, len(ranks))
        order = np.lexsort((np.arange(len(ranks)), -ranks))[:k]
    else:
        order = range(len(ranks))
    with fsio.fopen(path, "w") as f:
        for i in order:
            key = names[i] if names else i
            f.write(f"{key}\t{float(ranks[i])!r}\n")
    return len(order)


def main(argv: Optional[List[str]] = None) -> int:
    """The process entry point: SIGTERM/SIGINT handlers installed around
    :func:`run` only (``pagerank_tpu/cli.py:1380-1400``). A first signal
    drains at the next safe point (the in-flight step finishes, the
    writer flushes within ``--drain-deadline``, a final snapshot is
    written) and exits 75; a second hard-exits 128 + signum.

    The mesh (``--num-devices``): under torchrun (``WORLD_SIZE`` set)
    this process joins the group from torchrun's variables and runs as
    its rank. Otherwise ``--num-devices N`` > 1 starts N ranks itself
    (:func:`parallel.distributed.spawn_group`: rank i on cuda:i under
    nccl, or on the CPU under gloo with ``--device cpu``), after the
    argument checks and the visible-device check, and exits 0 only if
    every rank did; ``--num-devices 1`` runs this process as the one
    rank of a group of one. The backend follows ``--device``.

    With ``--stall-action rescue`` the launcher hosts the group's store
    (``spawn_group(..., rescue=True)``), the group's collective timeout
    is bounded by ``--stall-timeout``, and a rank the group's roll call
    declared lost does not fail the run: the exit code is the
    survivors', and the lost ranks are reported with their codes."""
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.parallel import mesh as mesh_lib

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if distributed.group_up():
        return _main_in_process(args)
    backend = distributed.default_backend(args.device)
    if os.environ.get("WORLD_SIZE"):
        world = int(os.environ["WORLD_SIZE"])
        if args.num_devices is not None and args.num_devices != world:
            _usage(f"--num-devices {args.num_devices} != torchrun's "
                   f"WORLD_SIZE {world}")
        _check_args(args)  # before joining: e.g. rescue is refused here
        distributed.maybe_initialize_distributed(backend)
        try:
            return _main_in_process(args)
        finally:
            distributed.shutdown()
    if args.num_devices is None or args.engine != "torch":
        return _main_in_process(args)
    _check_args(args)
    from pagerank_tpu_torch.engines.torch_engine import resolve_device

    try:
        mesh_lib.check_visible(args.num_devices,
                               resolve_device(args.device).type)
    except ValueError as e:
        raise SystemExit(str(e))
    import tempfile

    with tempfile.TemporaryDirectory(prefix="pagerank-mesh-") as tmp:
        if args.num_devices == 1:
            distributed.maybe_initialize_distributed(
                backend, init_method=f"file://{tmp}/rendezvous",
                world_size=1, rank=0)
            try:
                return _main_in_process(args)
            finally:
                distributed.shutdown()
        rescue = args.stall_action == "rescue"
        timeout_s = distributed.DEFAULT_TIMEOUT_S
        if rescue and args.stall_timeout:
            # A wedged peer must not hold the survivors in a collective
            # past the stall deadline (the watchdog's interrupt reaches
            # a thread blocked there only when the call returns).
            timeout_s = min(timeout_s, float(args.stall_timeout))
        # A job hosts the store too: a quarantine its manifest records
        # regroups the others through it before the build.
        codes = distributed.spawn_group(
            "pagerank_tpu_torch.cli:_rank_main", args.num_devices, argv, tmp,
            backend=backend, timeout_s=timeout_s,
            rescue=rescue or bool(args.job_dir))
    lost = set(codes.lost)
    if lost:
        _log(f"pagerank_tpu_torch: lost rank(s) {sorted(lost)} (exit codes "
             f"{ {r: codes[r] for r in sorted(lost)} }); the survivors "
             f"finished the solve")
    survivors = [c for r, c in enumerate(codes) if r not in lost]
    if survivors and all(c == 0 for c in survivors):
        return 0
    _log(f"pagerank_tpu_torch: rank exit codes {list(codes)}")
    if survivors and all(c in (0, int(ExitCode.INTERRUPTED))
                         for c in survivors):
        return int(ExitCode.INTERRUPTED)
    return next((c for c in survivors if c and c > 0), 1)


def _rank_main(argv: List[str]) -> int:
    """One spawned rank of ``main``'s mesh: the run in this process's
    group, its own drain handlers installed. CPU ranks share the host's
    cores: each takes its share of them as torch threads."""
    args = build_parser().parse_args(argv)
    if args.device == "cpu":
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // max(1, args.num_devices)))
    return _main_in_process(args)


def _main_in_process(args) -> int:
    """:func:`main` on parsed ``args`` in this process (its group, if
    any, already joined). A rank the group's roll call declared lost
    leaves with exit 1 (the launcher reports it; the survivors decide
    the run's code)."""
    from pagerank_tpu_torch.parallel.elastic import RankLeftError

    drain = jobs.GracefulDrain(deadline_s=args.drain_deadline)
    with drain:
        try:
            _run(args, drain)
        except RankLeftError as e:
            _log(f"pagerank_tpu_torch: {e}")
            return int(ExitCode.FAILURE)
        except jobs.DrainInterrupt as e:
            spent = drain.finish()
            try:
                sig = signal.Signals(e.signum).name if e.signum else "signal"
            except ValueError:
                sig = f"signal {e.signum}"
            _log(f"pagerank_tpu_torch: interrupted by {sig}; drained in "
                 f"{spent:.2f}s"
                 + (f" — rerun with --job-dir {args.job_dir} to resume"
                    if args.job_dir else "")
                 + f" (exit {int(ExitCode.INTERRUPTED)})")
            return int(ExitCode.INTERRUPTED)
    return 0


if __name__ == "__main__":
    sys.exit(main())
