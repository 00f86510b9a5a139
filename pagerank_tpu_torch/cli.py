"""Command-line entry point of the port: ``python -m pagerank_tpu_torch.cli``.

Port of the main-path part of ``pagerank_tpu/cli.py``: the flags of
:45-208 that the main path reads (``--partition-span`` and
``--stream-dtype`` with the JAX help text, :156-172), ``load_graph``
(:713-869; here ``load_edges`` + ``build_graph``) for edge lists,
``.npz`` and synthetic graphs, the partition-span resolution
(:1639-1679, with the partition part of ``ops/device_build.py:
plan_build``, :344-368, as :func:`plan_partition_span`) and the
``--out`` writer (:2305-2320), whose TSV matches the JAX CLI's. The
solve runs on ``--device`` (default cuda); ``--device cpu`` is the only
way to run it on a host without a card.

``run(argv)`` is the programmatic entry point (it returns the solve's
summary: ranks, graph, engine, timings); ``main(argv)`` wraps it.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Dict, List, Optional

from pagerank_tpu_torch.graph import build_graph
from pagerank_tpu_torch.utils import fsio


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pagerank_tpu_torch.cli",
        description="PageRank with reference (Sparky.java) semantics on an "
        "NVIDIA GPU: blocked-ELL power iteration through a hand-written "
        "CUDA kernel.",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--input", help="edge list (text: 'src dst' per line) "
                     "or binary .npz with src/dst (+ n)")
    src.add_argument("--synthetic", help="synthetic graph: rmat:SCALE or "
                     "uniform:N:E")
    p.add_argument("--format", default="auto",
                   choices=["auto", "edgelist", "npz", "crawl", "seqfile"],
                   help="input format (auto: .npz by extension, else a text "
                   "edge list; crawl and seqfile inputs are not ported yet)")
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
    p.add_argument("--snapshot-dir", default=None,
                   help="write ranks_iter{i}.npz after every iteration")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest valid snapshot")
    p.add_argument("--out", default=None,
                   help="write final ranks (TSV: id, rank)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the solve runs (default cuda; cpu only when "
                   "asked)")
    return p


def _synthetic(spec: str):
    """(src, dst, n) for a --synthetic spec: the JAX CLI's grammar and
    defaults (rmat scale 20, 16 edges per vertex, seed 0)."""
    from pagerank_tpu_torch.utils import synth

    kind, _, rest = spec.partition(":")
    try:
        if kind == "rmat":
            scale = int(rest or 20)
            src, dst = synth.rmat_edges(scale)
            return src, dst, 1 << scale
        if kind == "uniform":
            n_s, _, e_s = rest.partition(":")
            n = int(n_s)
            src, dst = synth.uniform_edges(n, int(e_s or 16 * n))
            return src, dst, n
    except ValueError:
        pass
    raise SystemExit(f"unknown synthetic spec {spec!r}")


def load_edges(args):
    """(src, dst, n or None) of the run's input: synthetic, .npz or a
    text edge list."""
    from pagerank_tpu_torch.ingest import edgelist as el

    if args.synthetic:
        return _synthetic(args.synthetic)
    fmt, path = args.format, args.input
    if fmt == "auto":
        with fsio.fopen(path, "rb") as fb:
            magic = fb.read(4)
        if magic[:3] == b"SEQ" and len(magic) == 4 and magic[3] <= 6:
            fmt = "seqfile"
        elif path.endswith(".npz"):
            fmt = "npz"
        else:
            with fsio.fopen(path, "r", errors="replace") as f:
                first = f.readline()
                while first.startswith("#"):
                    first = f.readline()
            tokens = first.split()
            fmt = ("edgelist" if len(tokens) == 2
                   and all(t.lstrip("-").isdigit() for t in tokens)
                   else "crawl")
    if fmt in ("crawl", "seqfile"):
        raise SystemExit(
            f"{path}: {fmt} inputs are not ported yet (crawl ingest: "
            f"ROADMAP slice 3); use pagerank_tpu.cli or an edge list"
        )
    if fmt == "npz":
        return el.load_binary_edges(path)
    src, dst = el.load_edgelist(path)
    return src, dst, None


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def plan_partition_span(cfg, n: int, num_edges: Optional[int],
                        partition_span: int) -> int:
    """The partition span a build should use for ``cfg`` on a graph of
    ``n`` vertices: 0 (off) under 64-bit accumulation, vertex sharding
    or a non-ELL kernel; the engine's auto rule for -1
    (``TorchEngine.partition_span``, 0 when the graph is too small or
    sparse to win); then at most the padded vertex count, rounded down
    to a multiple of 128."""
    from pagerank_tpu_torch.engines.torch_engine import TorchEngine
    from pagerank_tpu_torch.ops import LANES
    from pagerank_tpu_torch.utils.config import torch_dtype

    n_padded = -(-n // LANES) * LANES
    z_item = max(torch_dtype(cfg.dtype).itemsize,
                 torch_dtype(cfg.accum_dtype).itemsize)
    part = partition_span
    if part and (z_item > 4 or cfg.vertex_sharded
                 or cfg.kernel not in ("auto", "ell", "pallas")):
        if part > 0:
            _log("partition_span requires an ELL kernel with 32-bit "
                 "accumulation, replicated mode; planning the default "
                 "layout")
        part = 0
    if part == -1:
        part = TorchEngine.partition_span(n_padded, num_edges, z_item)
    part = min(int(part or 0), n_padded)
    if part:
        rounded = max(LANES, part & ~(LANES - 1))
        if rounded != part:
            _log(f"partition_span rounded {part} -> {rounded} (must be a "
                 f"multiple of {LANES})")
            part = rounded
    return part


def resolve_layout(cfg, args, graph):
    """``cfg`` with the run's partition span and stream dtype: the
    span resolved by :func:`plan_partition_span`; an explicit span the
    planner refused exits with the config error; ``--stream-dtype``
    without a resolved span is dropped with a note on stderr."""
    if args.partition_span:
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
    ``ranks`` (host, original id order), ``graph``, ``engine``,
    ``resumed_from``, ``iterations``, ``step_seconds`` (one per step,
    each ending in a device sync), ``input_seconds`` (read or generate
    the edges), ``graph_seconds`` (build_graph) and
    ``engine_build_seconds`` (pack, plan and placement; its split is in
    ``engine.layout_info()["build_seconds"]``), and the layout that ran:
    ``form``, ``partition_span`` (0 for the flat form) and
    ``partitions``."""
    from pagerank_tpu_torch.engines.torch_engine import (
        TorchEngine, resolve_device)
    from pagerank_tpu_torch.utils.config import PageRankConfig
    from pagerank_tpu_torch.utils.snapshot import Snapshotter, resume_engine

    args = build_parser().parse_args(argv)
    cfg = PageRankConfig(
        num_iters=args.iters, damping=args.damping, semantics=args.semantics,
        dtype=args.dtype, accum_dtype=args.accum_dtype or args.dtype,
        tol=args.tol,
    ).validate()
    resolve_device(args.device)  # raises without a card, before any work

    t0 = time.perf_counter()
    src, dst, n = load_edges(args)
    t1 = time.perf_counter()
    graph = build_graph(src, dst, n=n)
    del src, dst
    t2 = time.perf_counter()
    input_s, graph_s = t1 - t0, t2 - t1
    _log(f"graph: n={graph.n:,} edges={graph.num_edges:,} (input "
         f"{input_s:.3f} s, build {graph_s:.3f} s)")
    cfg = resolve_layout(cfg, args, graph)
    engine = TorchEngine(cfg, device=args.device)
    t0 = time.perf_counter()
    engine.build(graph)
    build_s = time.perf_counter() - t0
    lay = engine.layout_info()
    parts = lay.get("partitions", 1)
    if lay["partition_span"]:
        detail = (f"span {lay['partition_span']:,}, K={parts} partitions, "
                  f"{lay['pairs']:,} pairs, "
                  f"{'words24' if lay['words24'] else 'int32 words'}, "
                  f"{lay['z_dtype']} windows, ")
    else:
        detail = ""
    _log(f"engine: {lay['form']} on {lay['device']}, kernel {lay['kernel']}, "
         f"{detail}{lay['num_rows']:,} slot rows in {lay['num_segments']:,} "
         f"segments (build {build_s:.3f} s)")

    snap = None
    resumed = 0
    if args.snapshot_dir:
        snap = Snapshotter(args.snapshot_dir, graph.fingerprint(),
                           cfg.semantics, mesh_meta=engine.snapshot_meta())
        if args.resume:
            resumed = resume_engine(engine, snap)
            if resumed:
                _log(f"resumed from iteration {resumed}")
    elif args.resume:
        raise SystemExit("--resume needs --snapshot-dir")

    step_s: List[float] = []
    t_last = [time.perf_counter()]

    def on_iteration(i, info):
        now = time.perf_counter()
        step_s.append(now - t_last[0])
        _log(f"iter {i + 1}: l1_delta={info['l1_delta']:.6e} "
             f"dangling_mass={info['dangling_mass']:.6e} "
             f"({step_s[-1] * 1e3:.3f} ms)")
        if snap is not None:
            snap.save(i + 1, engine.ranks())
        t_last[0] = time.perf_counter()

    ranks = engine.run(on_iteration=on_iteration, snapshotter=snap)
    if step_s:
        ms = statistics.median(step_s) * 1e3
        _log(f"solve: {len(step_s)} iteration(s), median {ms:.3f} ms/iter, "
             f"{graph.num_edges / (ms / 1e3):.4g} edges/s")

    if args.out:
        with fsio.fopen(args.out, "w") as f:
            for i in range(len(ranks)):
                f.write(f"{i}\t{float(ranks[i])!r}\n")
        _log(f"wrote {len(ranks):,} ranks to {args.out}")
    return {
        "ranks": ranks, "graph": graph, "engine": engine,
        "resumed_from": resumed, "iterations": engine.iteration,
        "step_seconds": step_s, "input_seconds": input_s,
        "graph_seconds": graph_s, "engine_build_seconds": build_s,
        "form": lay["form"], "partition_span": lay["partition_span"],
        "partitions": parts,
    }


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
