"""Measured host-ingest costs of the port, with the host's facts.

Port of ``scripts/host_ingest_bench.py``. Three measurements:

  1. ``build_graph`` on R-MAT edges (``utils/synth.rmat_edges``) by each
     sort route, ``np.unique`` and the native C++ radix sort-dedup, each
     in a fresh forked process so its peak RSS is its own;
  2. the parts of the ``np.unique`` route in one more forked process:
     packing the (dst, src) keys, ``np.unique`` of them, and the same
     dedup done as ``np.sort`` + a mask of adjacent differences;
  3. a crawl segment (``utils/synth.crawl_segment``: ``--files`` block-
     compressed SequenceFiles of ``--recs-per-file`` records) written
     under ``build/`` of the checkout (removed after),
     then ingested to raw arrays by each route: the native L1 (threads:
     one per core, at most one per file), the Python parser serially
     and over a forked pool of one process per core; the routes must
     agree bit for bit.

It prints the host facts first (numpy version, ``os.cpu_count()``,
usable cores, ``MemAvailable``), then a markdown table, then one JSON
line with every number (peak RSS of each child and of this process).

Run:  python -m pagerank_tpu_torch.scripts.host_ingest_bench
          [--scale 22] [--files 301] [--recs-per-file 10000]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import queue
import resource
import shutil
import sys
import tempfile
import time

import numpy as np


def rss_gb() -> float:
    """Peak RSS of this process, GB (Linux ru_maxrss is KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def host_facts() -> dict:
    mem = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    mem = int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return {"numpy": np.__version__, "cpu_count": os.cpu_count(),
            "usable_cores": len(os.sched_getaffinity(0)),
            "mem_available_gb": mem}


def _child_build(q, src, dst, n, native):
    from pagerank_tpu_torch.graph import build_graph

    t0 = time.perf_counter()
    g = build_graph(src, dst, n=n, use_native_sort=native)
    q.put({"seconds": time.perf_counter() - t0, "edges": g.num_edges,
           "route": g.sort_route, "peak_rss_gb": rss_gb()})


def _child_unique_split(q, src, dst, n):
    t0 = time.perf_counter()
    key = np.asarray(dst, np.int64) * np.int64(n) + np.asarray(src, np.int64)
    t1 = time.perf_counter()
    s = np.sort(key)
    keep = np.empty(len(s), bool)
    keep[:1] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    by_sort = s[keep]
    t2 = time.perf_counter()
    by_unique = np.unique(key)
    t3 = time.perf_counter()
    if not np.array_equal(by_sort, by_unique):
        raise AssertionError("np.sort + mask and np.unique disagree")
    q.put({"pack_seconds": t1 - t0, "sort_dedup_seconds": t2 - t1,
           "unique_seconds": t3 - t2, "edges": len(by_unique),
           "peak_rss_gb": rss_gb()})


def _in_child(target, *args):
    """Run ``target(q, *args)`` in a forked process (the edges shared
    copy-on-write) and return what it put on the queue."""
    ctx = multiprocessing.get_context("fork")
    q = ctx.Queue()
    p = ctx.Process(target=target, args=(q, *args))
    p.start()
    try:
        while True:
            try:
                return q.get(timeout=30)
            except queue.Empty:
                if not p.is_alive():
                    raise RuntimeError(f"{target.__name__} child exited "
                                       f"with {p.exitcode} before reporting")
    finally:
        p.join()


def bench_host_build(scale: int, edge_factor: int) -> dict:
    from pagerank_tpu_torch.ingest import native as native_mod
    from pagerank_tpu_torch.utils.synth import rmat_edges

    # Build the sorter's library outside the timed window.
    if not native_mod.available("fast_ingest"):
        raise RuntimeError("the native sorter is unavailable: "
                           f"{native_mod.build_error('fast_ingest')}")

    t0 = time.perf_counter()
    src, dst = rmat_edges(scale, edge_factor, seed=0)
    gen_s = time.perf_counter() - t0
    n = 1 << scale
    print(f"rmat:{scale} ef {edge_factor}: {len(src):,} raw edges generated "
          f"in {gen_s:.3f} s", file=sys.stderr, flush=True)
    out = {"scale": scale, "raw_edges": len(src), "generate_seconds": gen_s}
    for label, native in (("numpy", False), ("native", True)):
        r = out[f"build_{label}"] = _in_child(_child_build, src, dst, n,
                                              native)
        print(f"build_graph[{label}]: route {r['route']}, {r['edges']:,} "
              f"edges in {r['seconds']:.3f} s, child peak RSS "
              f"{r['peak_rss_gb']:.3f} GB", file=sys.stderr, flush=True)
        if r["route"] != label:
            raise RuntimeError(f"asked for the {label} sort, ran "
                               f"{r['route']}")
    r = out["unique_split"] = _in_child(_child_unique_split, src, dst, n)
    print(f"np.unique split: pack {r['pack_seconds']:.3f} s, np.sort + mask "
          f"{r['sort_dedup_seconds']:.3f} s, np.unique "
          f"{r['unique_seconds']:.3f} s", file=sys.stderr, flush=True)
    return out


def bench_segment(files: int, per_file: int) -> dict:
    from pagerank_tpu_torch.ingest import native as native_mod
    from pagerank_tpu_torch.ingest.seqfile import load_crawl_seqfile_routed
    from pagerank_tpu_torch.utils.synth import crawl_segment

    scratch = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "build")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(prefix="ingest_bench_", dir=scratch)
    try:
        t0 = time.perf_counter()
        seg = crawl_segment(work, files=files, per_file=per_file)
        seg["write_seconds"] = time.perf_counter() - t0
        print(f"segment: {files} files x {per_file} records, "
              f"{seg['links']:,} links, {seg['bytes']:,} B written in "
              f"{seg['write_seconds']:.3f} s", file=sys.stderr, flush=True)
        # Build the native library outside the timed window; a host
        # without it reports so and drops the row.
        modes = []
        if native_mod.available("crawl_ingest"):
            modes.append(("native", dict(native="auto"),
                          native_mod.default_threads(range(files))))
        else:
            print("native crawl library unavailable: "
                  f"{native_mod.build_error('crawl_ingest')}",
                  file=sys.stderr)
        cores = len(os.sched_getaffinity(0))
        modes += [("python", dict(native="off", workers=w), w)
                  for w in sorted({1, cores})]
        rows, ref = [], None
        for label, kw, threads in modes:
            t0 = time.perf_counter()
            (src, dst, crawled, ids), route = load_crawl_seqfile_routed(
                work, raw=True, **kw)
            dt = time.perf_counter() - t0
            if route != label:
                raise RuntimeError(f"asked for the {label} route, ran {route}")
            got = (src, dst, crawled, ids.names)
            if ref is None:
                ref = got
            elif not (np.array_equal(src, ref[0]) and np.array_equal(dst, ref[1])
                      and np.array_equal(crawled, ref[2])
                      and ids.names == ref[3]):
                raise AssertionError(f"the {label} route ({threads}) differs "
                                     f"from the {modes[0][0]} route")
            rows.append({"route": label, "threads": threads, "seconds": dt,
                         "records_per_s": files * per_file / dt,
                         "raw_edges": len(src), "vertices": len(ids),
                         "crawled": int(crawled.sum())})
            print(f"ingest[{label}, {threads}]: {len(src):,} raw edges, "
                  f"{len(ids):,} vertices in {dt:.3f} s "
                  f"({files * per_file / dt:,.0f} records/s)",
                  file=sys.stderr, flush=True)
            del src, dst, crawled, ids, got
        seg["ingest"] = rows
        return seg
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=int, default=22)
    p.add_argument("--edge-factor", type=int, default=16)
    p.add_argument("--files", type=int, default=301)
    p.add_argument("--recs-per-file", type=int, default=10_000)
    args = p.parse_args(argv)

    facts = host_facts()
    print(f"host: numpy {facts['numpy']}, os.cpu_count() "
          f"{facts['cpu_count']}, usable cores {facts['usable_cores']}, "
          f"MemAvailable {facts['mem_available_gb']:.3f} GB", flush=True)
    seg = bench_segment(args.files, args.recs_per_file)
    build = bench_host_build(args.scale, args.edge_factor)
    facts["peak_rss_gb"] = rss_gb()

    print("\n| measurement | input | result |")
    print("|---|---|---|")
    raw = build["raw_edges"]
    for label in ("numpy", "native"):
        r = build[f"build_{label}"]
        print(f"| build_graph ({label}) | rmat:{args.scale}: {raw:,} raw / "
              f"{r['edges']:,} unique edges | {r['seconds']:.3f} s, peak RSS "
              f"{r['peak_rss_gb']:.3f} GB |")
    u = build["unique_split"]
    print(f"| np.unique route parts | the same keys | pack "
          f"{u['pack_seconds']:.3f} s, np.sort + mask "
          f"{u['sort_dedup_seconds']:.3f} s, np.unique "
          f"{u['unique_seconds']:.3f} s |")
    for r in seg["ingest"]:
        print(f"| segment ingest ({r['route']}, {r['threads']}) | "
              f"{args.files} x {args.recs_per_file} records, block-compressed "
              f"| {r['seconds']:.3f} s = {r['records_per_s']:,.0f} records/s; "
              f"{r['raw_edges']:,} raw edges, {r['vertices']:,} vertices |")
    print(json.dumps({"host": facts, "build": build, "segment": seg}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
