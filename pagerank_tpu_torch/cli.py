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
``run_ppr``, :496-645; the ``--device-build`` refusal, :1439-1443). The
solve runs on ``--device`` (default cuda) through the torch engines;
``--device cpu``, or ``--engine cpu`` (the f64 oracle), runs it on a
host without a card.

``run(argv)`` is the programmatic entry point (it returns the solve's
summary: ranks, graph, ids, engine, timings, the input format and the
ingest route); ``main(argv)`` wraps it.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from pagerank_tpu_torch.graph import build_graph
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
    ft = p.add_argument_group("fault tolerance")
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
    to a file of one id/url per line (a local path: the port has no
    remote file systems yet, so a URI is a url list)."""

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
    # URL-named vertices (crawl graphs) contain "://": "http://a/,http://b/"
    # resolves through the id map, not as a file.
    if fsio.scheme_of(spec) is None and os.path.exists(spec):
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
    ``ppr_seconds`` (engine build and solve, as the stderr line)."""
    from pagerank_tpu_torch.utils.config import PageRankConfig

    try:
        cfg = PageRankConfig(
            num_iters=args.iters,
            damping=args.damping,
            dtype=args.dtype,
            accum_dtype=args.accum_dtype or args.dtype,
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
    print(
        f"ppr: {len(sources)} sources x {args.iters} iters, top-{topk} "
        f"in {dt:.2f}s ({graph.num_edges * len(sources) * args.iters / dt:.3g} "
        f"edge·vectors/s)",
        file=sys.stderr,
    )
    names = ids.names if ids is not None else None
    out = args.out
    f = fsio.fopen(out, "w") if out else sys.stdout
    try:
        for si, s in enumerate(res.sources):
            skey = names[s] if names else s
            for v, r in zip(res.topk_ids[si], res.topk_scores[si]):
                vkey = names[v] if names else v
                f.write(f"{skey}\t{vkey}\t{float(r)!r}\n")
    finally:
        if out:
            f.close()
    if out:
        print(f"wrote {len(res.sources)}x{topk} ppr rows to {out}",
              file=sys.stderr)
    return {"ppr": res, "engine": eng, "sources": sources,
            "ppr_seconds": dt}


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


def _device_build(args, cfg, info, t0, edges, n, dangling_mask=None):
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
    t1 = time.perf_counter()
    info["input_seconds"] = t1 - t0
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
                             dangling_mask=~crawled), ids, info
    graph = _build(info, t0, src, dst, n=len(ids), dangling_mask=~crawled,
                   vertex_names=ids.names)
    return graph, ids, info


def _log(msg: str) -> None:
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


def run(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Load, build, solve and write outputs; returns the summary:
    ``ranks`` (host, original id order), ``graph``, ``ids`` (the IdMap
    of a crawl input, else None), ``engine``, ``resumed_from``,
    ``iterations``, ``step_seconds`` (one per step, each ending in a
    device sync; snapshot saves are not in them), ``snapshot_seconds``
    (one per save), ``out_seconds`` (the ``--out`` write, else None),
    ``format`` (the detected input format), ``ingest_route`` ("native"
    or "python": the parser that ran), ``ingest_threads``,
    ``input_seconds`` (read, parse or generate the edges),
    ``graph_seconds`` (build_graph, or the device build's wall),
    ``sort_route`` (``Graph.sort_route``; "device" under
    ``--device-build``), ``device_build_seconds`` (the device build's
    relabel/sort/slots/scatter stages, else None), ``upload_seconds``
    (the raw edges of a device-built file input, else None) and
    ``engine_build_seconds`` (pack, plan and placement; its split is in
    ``engine.layout_info()["build_seconds"]``), and the layout that ran:
    ``form``, ``partition_span`` (0 for the flat form), ``partitions``
    and ``num_rows`` (slot rows; None for the cpu engine). With ``--ppr-sources`` it returns, after the load, ``graph``,
    ``ids``, the load's timings and what :func:`run_ppr` returns."""
    from pagerank_tpu_torch.engine import make_engine
    from pagerank_tpu_torch.engines.torch_engine import (
        TorchEngine, resolve_device)
    from pagerank_tpu_torch.utils.config import (PageRankConfig,
                                                 RobustnessConfig)
    from pagerank_tpu_torch.utils.metrics import MetricsLogger
    from pagerank_tpu_torch.utils.snapshot import Snapshotter, resume_engine

    args = build_parser().parse_args(argv)
    try:
        cfg = PageRankConfig(
            num_iters=args.iters, damping=args.damping,
            semantics=args.semantics, dtype=args.dtype,
            accum_dtype=args.accum_dtype or args.dtype, tol=args.tol,
            robustness=RobustnessConfig(
                health_checks=not args.no_health_checks,
                mass_tol=args.mass_tol, max_rollbacks=args.max_rollbacks),
        ).validate()
    except ValueError as e:
        raise SystemExit(str(e))
    if args.resume and not args.snapshot_dir:
        raise SystemExit("--resume needs --snapshot-dir")
    if args.device_build and args.engine != "torch":
        raise SystemExit("--device-build requires --engine torch")
    if args.device_build and args.ppr_sources:
        raise SystemExit("--device-build does not support --ppr-sources "
                         "(the PPR engine builds from a host graph)")
    if args.ppr_sources:
        reject_ppr_incompatible_flags(args)
    if args.engine == "torch":
        resolve_device(args.device)  # raises without a card, before work

    try:
        graph, ids, info = load_graph(args, cfg)
    except ValueError as e:
        # e.g. "empty graph: no vertices": a clean CLI error
        raise SystemExit(str(e))
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
    t0 = time.perf_counter()
    if args.engine == "cpu":
        engine = make_engine("cpu", cfg).build(graph)
        lay = {"form": "cpu_f64", "partition_span": 0}
        _log(f"engine: the f64 oracle on the host (build "
             f"{time.perf_counter() - t0:.3f} s)")
    else:
        cfg = resolve_layout(cfg, args, graph, info.get("partition_span"))
        engine = TorchEngine(cfg, device=args.device)
        t0 = time.perf_counter()
        if args.device_build:
            engine.build_device(graph)
        else:
            engine.build(graph)
        lay = engine.layout_info()
        _log_layout(lay, time.perf_counter() - t0)
    build_s = time.perf_counter() - t0
    parts = lay.get("partitions", 1)

    snap = None
    resumed = 0
    if args.snapshot_dir:
        snap = Snapshotter(args.snapshot_dir, graph.fingerprint(),
                           cfg.semantics, mesh_meta=engine.snapshot_meta())
        if args.resume:
            resumed = resume_engine(engine, snap)
            if resumed:
                _log(f"resumed from iteration {resumed}")

    metrics = MetricsLogger(graph.num_edges, 1, log_every=args.log_every,
                            jsonl_path=args.jsonl)
    step_s: List[float] = []
    save_s: List[float] = []
    t_last = [time.perf_counter()]

    def on_iteration(i, info):
        step_s.append(time.perf_counter() - t_last[0])
        metrics.record(i, info, step_s[-1])
        if snap is not None and args.snapshot_every and (
                (i + 1) % args.snapshot_every == 0):
            t_save = time.perf_counter()
            snap.save(i + 1, engine.ranks())
            save_s.append(time.perf_counter() - t_save)
        t_last[0] = time.perf_counter()

    try:
        ranks = engine.run(on_iteration=on_iteration, snapshotter=snap)
    finally:
        metrics.close()
    if step_s:
        ms = statistics.median(step_s) * 1e3
        saves = (f", snapshot save median "
                 f"{statistics.median(save_s) * 1e3:.3f} ms" if save_s
                 else "")
        _log(f"solve: {len(step_s)} iteration(s), median {ms:.3f} ms/iter, "
             f"{graph.num_edges / (ms / 1e3):.4g} edges/s{saves}")

    out_s = None
    if args.out:
        t0 = time.perf_counter()
        n_out = write_ranks(args.out, ranks,
                            ids.names if ids is not None else None, args.top)
        out_s = time.perf_counter() - t0
        _log(f"wrote {n_out:,} ranks to {args.out}")
    return {
        "ranks": ranks, "graph": graph, "ids": ids, "engine": engine,
        "resumed_from": resumed, "iterations": engine.iteration,
        "step_seconds": step_s, "snapshot_seconds": save_s,
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
        "partitions": parts, "num_rows": lay.get("num_rows"),
    }


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
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
