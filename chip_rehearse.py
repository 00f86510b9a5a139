"""Rehearse a few of chip_smoke.py's checks on one card, alone.

    python3 chip_rehearse.py [--rounds N]
    python3 chip_rehearse.py --only profiler [--rounds N]
    python3 chip_rehearse.py --only bench [--out DIR]
    python3 chip_rehearse.py --only fixtures [--rounds N] [--root DIR]
    python3 chip_rehearse.py --only probe [--rounds N]

Builds the kernels, then, by default:

  1. builds the flat, partitioned f32 and partitioned bf16 engines on
     chip_smoke.py's rmat:22 main-path graph and runs its phase-4/6
     ``step_breakdown`` (torch.profiler over 10 steps) ``N`` times on
     each (default 15), counting the profiled windows whose launches fall
     short of the steps (phase 6 profiles such a window again when the
     kernel's wrapper counted one launch a step); a short window is
     counted, not fatal;
  2. phase 16 on phase 15(a)'s rmat:20 graph and references;
  3. phase 21, the acceptance keys.

With ``--only profiler``: step 1 alone. With ``--only bench``: chip_smoke.py's phase 22 (the bench in single
mode, the acceptance keys D, N and AA in process), then each mode of
``python -m pagerank_tpu_torch.bench`` as a subprocess at the sizes of
``BENCH_MODES`` (couple, single, ``--build-only``, ``--multichip`` over
two ranks, ``--ppr-serve``), each record written to ``--out`` (default
``build/bench_records``) and its headline printed. With ``--only
fixtures``: builds ``defect_fixtures`` alone and runs chip_smoke.py's
phase 11b (``fixture_phase``, F1-F6) ``N`` times (default 15), then
prints each fixture's median and spread (least to most) over the rounds
of each time its records hold; ``--root`` takes chip_smoke.py and the
package from another checkout (an unpacked ``git archive`` of an
earlier commit), so that two versions are timed by one script, each in
its own process. With ``--only probe``: builds ``gather_probe`` alone
and runs phase 7's uniform sweep (``probe_sweep``: P1-P3 beside
``F.embedding_bag``, ``index_select`` then ``mul`` and ``index_select``
at 2^19 rows) ``N`` times.

The phases fail as in chip_smoke.py; a bench mode fails on a non-zero
exit. Exits 0 when they passed and no split was short, 1 otherwise.
Needs a CUDA card and a checkout of the repo beside it.
"""

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: (mode, arguments) of each bench run of ``--only bench``.
BENCH_MODES = (
    ("couple", ["--scale", "20", "--iters", "10", "--accuracy-scale",
                "18"]),
    ("single", ["--dtype", "float32", "--scale", "22", "--iters", "10",
                "--accuracy-scale", "18"]),
    ("build_only", ["--build-only", "--scale", "22"]),
    ("multichip", ["--multichip", "--scale", "18", "--multichip-devices",
                   "2", "--iters", "10", "--accuracy-scale", "18"]),
    ("ppr_serve", ["--ppr-serve", "--scale", "20", "--iters", "20"]),
)


def _headline(mode, doc):
    """One line of a bench record's headline numbers."""
    if mode == "build_only":
        return (f"f64 {doc['f64']['build_s']:.3f} s, f32 "
                f"{doc['f32']['build_s']:.3f} s, f64 warm "
                f"{doc['f64_warm']['build_s']:.3f} s")
    if mode == "ppr_serve":
        return (f"{doc['value']:.4g} queries/s, p50 {doc['p50_ms']:.3f} ms, "
                f"p99 {doc['p99_ms']:.3f} ms, shed "
                f"{doc['shed_fraction']:.3f}, K1w "
                f"{doc['layout']['launches']['K1w']} in "
                f"{doc['layout']['batches']} batches")
    if mode == "multichip":
        legs = ("single_chip", "dense_exchange", "sparse_exchange",
                "sparse_async", "pallas_partitioned")
        return ", ".join(f"{k} {doc[k]['ms_per_iter']:.3f} ms/iter"
                         for k in legs) + (
            f"; L1 {doc['accuracy']['normalized_l1_vs_f64_oracle']:.3e}")
    head = (f"{doc['value']:.4g} edges/s, "
            f"{doc['costs']['step']['seconds_per_iter'] * 1e3:.4f} ms/iter")
    for leg in ("fast_f32", "partitioned_f32", "fast_bf16"):
        if leg in doc:
            head += (f"; {leg} {doc[leg]['value']:.4g} edges/s, "
                     f"{doc[leg]['costs']['step']['seconds_per_iter'] * 1e3:.4f}"
                     f" ms/iter")
    acc = doc.get("accuracy")
    if acc:
        head += f"; L1 {acc['normalized_l1_vs_f64_oracle']:.3e}"
    return head


def bench_modes(out_dir):
    """Each BENCH_MODES run as ``python -m pagerank_tpu_torch.bench``;
    returns the modes that failed."""
    import json
    import subprocess

    os.makedirs(out_dir, exist_ok=True)
    failed = []
    env = dict(os.environ, PYTHONPATH=ROOT)
    for mode, argv in BENCH_MODES:
        out = os.path.join(out_dir, f"{mode}.json")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "pagerank_tpu_torch.bench",
                            *argv, "--out", out], capture_output=True,
                           text=True, cwd=ROOT, env=env, timeout=900)
        wall = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"{mode}.err"), "w") as f:
            f.write(r.stderr)
        if r.returncode != 0:
            failed.append(mode)
            print(f"bench {mode}: exit {r.returncode}: {r.stderr[-1500:]}",
                  flush=True)
            continue
        with open(out) as f:
            doc = json.load(f)
        print(f"bench {mode} ({' '.join(argv)}): exit 0 in {wall:.1f} s: "
              f"{_headline(mode, doc)}", flush=True)
    return failed


#: The times of a phase-11b record that ``--only fixtures`` summarises.
FIXTURE_TIMES = ("ms", "host_ms", "bare_ms", "bare_host_ms", "plain_ms",
                 "library_ms", "library_host_ms", "prealloc_ms",
                 "prealloc_host_ms", "prealloc_bare_ms")
#: F4's wrapper host time by part (its records' ``host_split``).
HOST_SPLIT = ("check_ms", "alloc_args_ms", "entry_ms", "dispatch_ms")


def fixture_rounds(rounds):
    """Phase 11b ``rounds`` times on the fixtures' library alone; prints
    each fixture's median (least-most) of each time over the rounds, or
    "not measured" where the checkout's records lack it or hold None (a
    checkout whose records have no ``prealloc_ms`` held its preallocated
    call under ``library_ms``). Returns the records of every round."""
    import statistics

    import chip_smoke as cs
    from pagerank_tpu_torch.analysis import kernels
    from pagerank_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all(["defect_fixtures"])
    print(f"fixtures: defect_fixtures built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # The rule each fixture trips under the source model (phase 11b only
    # prints it; chip_smoke.py reads it with compile facts).
    rules = {c.label.split(":")[1]: kernels.check_kernel_case(c)[0].rule
             for c in kernels.defect_cases()}
    runs = [cs.fixture_phase(rules) for _ in range(rounds)]
    for i, rec in enumerate(runs[0]):
        parts = []
        for key in FIXTURE_TIMES + (HOST_SPLIT if "host_split" in rec
                                    else ()):
            vals = [run[i].get(key, run[i].get("host_split", {}).get(key))
                    for run in runs]
            vals = [v for v in vals if v is not None]
            parts.append(f"{key} {statistics.median(vals):.4f} "
                         f"({min(vals):.4f}-{max(vals):.4f})" if vals
                         else f"{key} not measured")
        print(f"fixtures {rec['name']} over {rounds} rounds: "
              + ", ".join(parts), flush=True)
    return runs


def profiler_rounds(rounds):
    """{kernel: [(round, message) of each short split]}."""
    import chip_smoke as cs
    from pagerank_tpu_torch import PageRankConfig, TorchEngine, cli
    from pagerank_tpu_torch.graph import build_graph
    from pagerank_tpu_torch.utils.synth import rmat_edges

    t0 = time.perf_counter()
    g = build_graph(*rmat_edges(22), n=1 << 22)
    span = cli.plan_partition_span(PageRankConfig(), g.n, g.num_edges, -1)
    forms = []
    for label, symbol, kw in (
            ("K1", "ell_contrib_kernel", {}),
            ("K2", "ell_contrib_part_kernel", {"partition_span": span}),
            ("K2 (bf16 windows)", "ell_contrib_part_kernel",
             {"partition_span": span, "stream_dtype": "bfloat16"})):
        eng = TorchEngine(PageRankConfig(num_iters=cs.ITERS, **kw),
                          device="cuda").build(g)
        forms.append((eng, label, symbol))
    print(f"profiler rounds: rmat:22 engines built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    short = {label: [] for _, label, _ in forms}
    for r in range(rounds):
        for eng, label, symbol in forms:
            try:
                got = cs.step_breakdown(eng, label, symbol)
                if got["short_windows"]:
                    short[label].append(
                        (r, f"{got['short_windows']} short window(s), "
                            f"then a whole one"))
            except AssertionError as e:
                short[label].append((r, str(e)[:200]))
    for label, got in short.items():
        print(f"profiler {label}: {len(got)} of {rounds} splits short: "
              f"{got}", flush=True)
    return short


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=15,
                   help="profiled splits a kernel, phase-11b runs or probe sweeps "
                   "(default 15)")
    p.add_argument("--only", choices=["bench", "fixtures", "probe",
                                      "profiler"],
                   default=None,
                   help="rehearse phase 22 and the bench CLI's modes, "
                   "phase 11b, phase 7's uniform sweep, or only the "
                   "profiled splits, instead")
    p.add_argument("--out", default=os.path.join(ROOT, "build",
                                                 "bench_records"),
                   help="where --only bench writes the bench records")
    p.add_argument("--root", default=ROOT,
                   help="the checkout whose chip_smoke.py and package "
                   "--only fixtures runs (default: this one)")
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root if args.only == "fixtures" else ROOT)
    sys.path.insert(0, root)
    import chip_smoke as cs

    t_all = time.perf_counter()
    cs.card_identity()
    if args.only == "fixtures":
        print(f"fixtures from {root}", flush=True)
        fixture_rounds(args.rounds)
        print(f"chip_rehearse took {time.perf_counter() - t_all:.1f} s")
        return 0
    if args.only == "probe":
        from pagerank_tpu_torch.kernels import build

        build.build_all(["gather_probe"])
        gen = torch.Generator(device="cuda")
        gen.manual_seed(11)
        for _ in range(args.rounds):
            cs.probe_sweep(gen)
        print(f"chip_rehearse took {time.perf_counter() - t_all:.1f} s")
        return 0
    cs.build_kernels()
    if args.only == "bench":
        cs.bench_phase()
        failed = bench_modes(args.out)
        print(f"chip_rehearse took {time.perf_counter() - t_all:.1f} s")
        return 1 if failed else 0
    short = profiler_rounds(args.rounds)
    if args.only == "profiler":
        print(f"chip_rehearse took {time.perf_counter() - t_all:.1f} s")
        return 1 if any(short.values()) else 0
    torch.cuda.empty_cache()
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_rehearse_",
                                     dir=scratch) as tmp:
        d = os.path.join(tmp, "sharded")
        os.makedirs(d, exist_ok=True)
        _, span, refs, _ = cs._shard_refs(d)
        np.savez(os.path.join(d, "refs_a.npz"), span=span, **refs)
        cs.elastic_phase(tmp)
        cs.acceptance_phase()
    print(f"chip_rehearse took {time.perf_counter() - t_all:.1f} s")
    return 1 if any(short.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
