"""Rehearse a few of chip_smoke.py's checks on one card, alone.

    python3 chip_rehearse.py [--rounds N]

Builds the kernels, then:

  1. builds the flat, partitioned f32 and partitioned bf16 engines on
     chip_smoke.py's rmat:22 main-path graph and runs its phase-4/6
     ``step_breakdown`` (torch.profiler over 10 steps) ``N`` times on
     each (default 15), counting the splits whose profiled launches fall
     short of the steps; a short split is counted, not fatal;
  2. phase 16 on phase 15(a)'s rmat:20 graph and references;
  3. phase 21, the acceptance keys.

Phases 16 and 21 fail as in chip_smoke.py. Exits 0 when they passed and
no split was short, 1 otherwise. Needs a CUDA card and a checkout of the
repo beside it.
"""

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


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
                cs.step_breakdown(eng, label, symbol)
            except AssertionError as e:
                short[label].append((r, str(e)[:200]))
    for label, got in short.items():
        print(f"profiler {label}: {len(got)} of {rounds} splits short: "
              f"{got}", flush=True)
    return short


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=15,
                   help="profiled splits a kernel (default 15)")
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    t_all = time.perf_counter()
    cs.card_identity()
    cs.build_kernels()
    short = profiler_rounds(args.rounds)
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
