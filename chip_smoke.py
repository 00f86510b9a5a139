#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the full check (R-MAT scale 22)
    python3 chip_smoke.py --scale 16      # a quicker rehearsal

What it does, in order:

  1. prints the card's name and power limit (nvidia-smi) and
     torch.cuda.get_device_name(0);
  2. builds every kernel under pagerank_tpu_torch/csrc/ with nvcc for
     sm_90a (one nvcc per source, all at once) and prints the build
     seconds and the ptxas register report;
  3. drives the flat main path through the CLI entry point in-process
     (``pagerank_tpu_torch.cli.run``): --synthetic rmat:SCALE, reference
     semantics, 10 iterations, f32, --snapshot-dir and --out in a temp
     dir, on cuda. Every kernel's launch count is set to 0 just before
     and read just after: K1's must equal the number of steps, K2's 0.
     The ranks are checked against the port's f64 ReferenceCpuEngine on
     the same graph (mass-normalised L1 <= 1e-4), and the last snapshot
     and the --out file against the returned ranks;
  4. holds K1 (ell_contrib, one persistent launch a call) on the card
     at the main path's own shapes (the engine's packed slots, the
     prescaled final ranks) in every entry (f32/f32, f32/f64, f64/f64)
     and on a small adversarial pack (a hub block hundreds of segments
     deep, empty blocks, all-sentinel rows): torch.equal to its plain
     plan-order version computed on the CPU from the same inputs; two
     launches on one workspace and a head of 0 bit-identical; normalised max error against exact (f64) sums <=
     1e-5 (f32), 1e-6 (f32/f64), 1e-12 (f64). Prints the share of real
     slots below the head and of sentinels. Times the wrapper call
     (CUDA events, median of 30), the bare launch of the bound launcher
     (50 launches between two events, median of 7 rounds) with the
     largest head and a head of 0, in turns, the
     twin and one torch.sparse.mm of the same matrix as a yardstick,
     beside K1's byte bound; then splits a main-path step's time by
     kernel with torch.profiler (K1 once a step, no pass-2 kernel, the
     elementwise kernels, the device's idle share);
  5. the partition-centric path on the graph phase 3 built: the span
     from the CLI's resolver at -1, a TorchEngine on cuda for 10
     iterations in f32 and again with the bf16 window stream. The
     counts are set to 0 before each run and read after: K2's must be
     10, K1's 0. Normalised L1 against phase 3's f64 oracle <= 1e-4
     (f32), and in (1e-7, 5e-3) for bf16 (a real bf16 run, inside
     quantization grade);
  6. holds K2 (ell_contrib_partitioned, which now writes the block sums
     itself) the same way at that path's shapes in every entry (f32 and
     bf16 windows, 3-byte and int32 words) and on adversarial packs
     (deep hub pairs, empty partitions, empty blocks, all-sentinel
     rows; at 59 partitions a hub block fed by more than 32 pairs),
     against its plain plan-order version on the CPU and exact
     (f64) sums of the same widened values (<= 1e-5). Prints the head's
     share of partition 0's slots. Times the wrapper call, the bare
     launches in turns (largest head and 0, f32 and bf16 windows), the twin and one torch.sparse.mm of the same
     block-row x windowed-z matrix (f32) beside K2's byte bound, and
     splits the partitioned step (f32 and bf16 windows) by kernel with
     torch.profiler: K2 once a step, no expansion kernel;
  7. the gather probe (P1-P3, ``pagerank_tpu_torch.scripts.
     probe_gather.run_probe``): out = z[src]*w through each of the
     three gather kernels and its plain version, (a) on the main path's
     own slot arrays: K1's flat pack with z_ext (taken in phase 3) and
     K2's windowed pack as global indices into the flattened windows,
     f32 and bf16 windows (taken in phase 6), each printed beside that
     kernel's profiled device time; (b) a uniform sweep, 2^19 rows x 128
     slots, n in {2^15, 2^20, 2^22, 2^24}, f32 and bf16. At every point
     the counts are set to 0 before run_probe and read after (each
     kernel that applies launched warm-up + 30 times, the others 0);
     each kernel is torch.equal to its plain version and bit-identical
     on repeat; times are CUDA-event medians of 30 beside the byte
     bound, the plain version and one torch.index_select. P3 runs
     where z fits shared memory (n = 2^15 here), P2 where n % 8 == 0;
  8. resume determinism on the card, for the flat form and through the
     CLI's --partition-span -1: 6 iterations with snapshots, a resume
     to 10, and an uninterrupted 10 give bit-equal ranks;
  9. the kernel-plane check (``pagerank_tpu_torch.analysis``): (a)
     ``python -m pagerank_tpu_torch.analysis --select PTK --compiled
     --json`` as subprocesses, all at once: the shipped registry exits
     0 with no finding and each ``--kernel-fixture NAME`` exits 1 with
     exactly its rule, with the compile facts read from the built
     libraries (every shipped symbol's registers, shared bytes and
     spills printed); (b) F1-F6 on the card at the JAX fixtures'
     shapes, the counts set to 0 before and read after: F1 at its
     geometry refused with no error left pending and equal to its plain
     copy at 2^15, F2 and F5 equal, F3 equal with NaN at exactly the
     elements PTK003 names, F4 one of its two writers in every element,
     F6 within 1e-5 of an f64 matmul; each timed beside its bound,
     its plain version and ``Tensor.copy_`` / ``torch.matmul``;
 10. prints one JSON line with every kernel's numbers (K1, K2, P1 and
     P2 at K1's slots, P3 at n = 2^15 f32, F1-F6), then last
     ``{"ok": true, "device": {...}}``.

Every byte bound comes from the registry's cost models
(``pagerank_tpu_torch/analysis/kernels.py``: ``k1_cost``, ``k2_cost``,
``probe_cost``) and the card's memory rate from the device table
(``pagerank_tpu_torch/obs/costs.py``); K1's and K2's cases are also
held to PTK001-005 on the main path's own rmat:22 plans.

Any failed check raises; the script then exits non-zero and prints no
result line. It also exits non-zero when no CUDA device is available,
and when it is not run from a checkout of the repo.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
ITERS = 10


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _median_ms(fn, repeats, warmup=3):
    """Median over ``repeats`` CUDA-event-timed calls of ``fn``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _card():
    """The device table's entry of the card (obs/costs.py)."""
    import torch

    from pagerank_tpu_torch.obs import costs

    return costs.device_spec(torch.cuda.get_device_name(0))


def _bound_ms(cost):
    """The least time for a cost model {flops, bytes} on this card: the
    larger of bytes over the memory rate and FLOPs over the f32 rate
    (outside the tensor cores); returns (ms, "bytes" or "operations")."""
    card = _card()
    t_bytes = cost["bytes"] / card.hbm_bytes_per_s * 1e3
    t_ops = cost["flops"] / card.fp32_flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dt(t):
    """A tensor's dtype as its short name (float32, bfloat16, ...)."""
    return str(t.dtype).removeprefix("torch.")


def card_identity():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    return line


def build_kernels():
    from pagerank_tpu_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all(extra_flags=("-Xptxas", "-v"))
    secs = time.perf_counter() - t0
    for name in build.sources():
        build.load(name)
    print(f"kernels built in {secs:.3f} s: {', '.join(build.sources())}")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "entry function" in ln or "registers" in ln:
                print(f"  {name}: {ln.strip()}")
    return secs


def _reset_counts():
    from pagerank_tpu_torch.ops import (defect_fixtures, ell_spmv,
                                        ell_spmv_partitioned, gather_probe)

    ell_spmv.launches = 0
    ell_spmv_partitioned.launches = 0
    for counts in (gather_probe.launches, defect_fixtures.launches):
        for name in counts:
            counts[name] = 0


def _read_counts():
    """(K1 launches, K2 launches, {P1-P3 wrapper: launches}) since the
    last reset; the F1-F6 counts join P1-P3's dict, keyed fx:<name>."""
    from pagerank_tpu_torch.ops import (defect_fixtures, ell_spmv,
                                        ell_spmv_partitioned, gather_probe)

    return (ell_spmv.launches, ell_spmv_partitioned.launches,
            {**gather_probe.launches,
             **{f"fx:{k}": v for k, v in defect_fixtures.launches.items()}})


def _check_case(case):
    """Hold one launch case of a path's real plan to PTK001-005."""
    from pagerank_tpu_torch.analysis import kernels

    found = kernels.check_kernel_case(case)
    _check(not found, f"{case.label}: " + "; ".join(f.render()
                                                     for f in found))


def main_path(scale, tmp):
    """Phase 3: the CLI's main path on cuda; returns (summary, report,
    the f64 oracle's ranks)."""
    import numpy as np

    from pagerank_tpu_torch import PageRankConfig, ReferenceCpuEngine, cli

    snap_dir = os.path.join(tmp, "snaps")
    out = os.path.join(tmp, "ranks.tsv")
    _reset_counts()
    summary = cli.run([
        "--synthetic", f"rmat:{scale}", "--iters", str(ITERS),
        "--semantics", "reference", "--dtype", "float32",
        "--snapshot-dir", snap_dir, "--out", out,
    ])
    launches, k2_launches, probe = _read_counts()
    graph, ranks = summary["graph"], summary["ranks"]
    _check(summary["engine"].device.type == "cuda", "main path not on cuda")
    _check(summary["form"] == "flat_ell", f"main path ran {summary['form']}")
    _check(launches == summary["iterations"] == ITERS and k2_launches == 0
           and not any(probe.values()),
           f"ell_contrib launched {launches} times (ell_contrib_partitioned "
           f"{k2_launches}, the probe kernels {probe}) in "
           f"{summary['iterations']} steps (want one K1 launch per step, "
           f"{ITERS} steps, no other kernel)")
    _check(ranks.shape == (graph.n,) and np.isfinite(ranks).all(),
           "ranks are not finite of shape (n,)")
    t0 = time.perf_counter()
    oracle = ReferenceCpuEngine(PageRankConfig(num_iters=ITERS)).build(
        graph).run()
    oracle_s = time.perf_counter() - t0
    l1 = float(np.abs(ranks - oracle).sum() / np.abs(oracle).sum())
    _check(l1 <= 1e-4, f"main path vs f64 oracle: normalised L1 {l1} > 1e-4")
    snap = np.load(os.path.join(snap_dir, f"ranks_iter{ITERS}.npz"))
    _check(np.array_equal(snap["ranks"], ranks), "last snapshot != ranks")
    with open(out) as f:
        lines = sum(1 for _ in f)
    _check(lines == graph.n, f"--out has {lines} lines, want {graph.n}")
    ms = statistics.median(summary["step_seconds"]) * 1e3
    bs = summary["engine"].layout_info()["build_seconds"]
    host_s = (summary["input_seconds"] + summary["graph_seconds"]
              + summary["engine_build_seconds"])
    print(f"main path rmat:{scale}: n={graph.n} edges={graph.num_edges} "
          f"{ms:.3f} ms/iter {graph.num_edges / (ms / 1e3):.6g} edges/s, "
          f"ell_contrib launches {launches} in {ITERS} steps, f64 oracle "
          f"normalised L1 {l1:.3e} ({oracle_s:.1f} s)")
    print(f"host build {host_s:.3f} s: R-MAT edges "
          f"{summary['input_seconds']:.3f} s, build_graph "
          f"{summary['graph_seconds']:.3f} s, ELL pack {bs['pack']:.3f} s, "
          f"planes + sentinels + segment plan {bs['plan']:.3f} s, placement "
          f"{bs['place']:.3f} s")
    return summary, {"launches": launches, "ms_per_iter": ms, "l1": l1}, \
        oracle


def _launch_ms(launchers, launches=50, rounds=7):
    """Per-launch device time of bound launchers, in turns on one card:
    each round times ``launches`` back-to-back calls of each launcher
    between two CUDA events, the order reversed every other round;
    returns {name: median over the rounds}."""
    import torch

    for fn in launchers.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in launchers}
    names = list(launchers)
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(launches):
                launchers[k]()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b) / launches)
    return {k: statistics.median(v) for k, v in times.items()}


def _host_ms(fn, repeats=200):
    """Mean host-clock time of ``fn`` over ``repeats`` calls (what a call
    costs the host before the card sees its launch)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) * 1e3 / repeats


def _held(label, got, want, exact, tol):
    """``got`` (a kernel's output on the card) torch.equal to ``want``
    (its plain plan-order version computed on the CPU), and its
    normalised distance to ``exact`` (f64 sums of the same values) within
    ``tol``. Returns the max abs error against ``exact``."""
    _check(_equal(got, want),
           f"{label}: the kernel differs from its plain plan-order version "
           f"computed on the CPU")
    scale = max(float(exact.abs().max()), 1e-300)
    err = float((got.double().cpu() - exact.cpu()).abs().max())
    _check(err / scale <= tol,
           f"{label}: normalised max error {err / scale:.3e} > {tol:g}")
    return err


def _equal(a, b):
    import torch

    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def _variants(bind):
    """The two launchers of one kernel's inputs: the largest head (what
    the path uses) and a head of 0. ``bind(head)`` binds one."""
    return {"head max": bind(None), "head 0": bind(0)}


def _k1_entry(z_ext, src, rb, nb, plan, accum, tol, label):
    """K1 at one entry: torch.equal to the plain plan-order sums computed
    on the CPU from the same inputs; two launches on one workspace
    bit-identical, its counters left zero; a head of 0 bit-identical too;
    within ``tol`` of the exact (f64) sums.
    Returns K1's max abs error against the exact sums."""
    import torch

    from pagerank_tpu_torch.ops import ell_spmv

    work = ell_spmv.workspace(plan, accum, z_ext.device)

    def run(**kw):
        return ell_spmv.ell_contrib(z_ext, src, rb, nb, accum_dtype=accum,
                                    plan=plan, work=work, **kw)

    a, b, c = run(), run(), run(head=0)
    torch.cuda.synchronize()
    _check(torch.equal(a, b), f"K1 {label}: two launches differ")
    _check(not work.counter.any(), f"K1 {label}: counters left non-zero")
    _check(torch.equal(a, c), f"K1 {label}: a head of 0 changed bits")
    want = ell_spmv.ell_contrib_plan_reference(
        z_ext.cpu(), src.cpu(), accum_dtype=accum,
        plan=ell_spmv.plan_to(plan, "cpu"))
    exact = ell_spmv.ell_contrib_reference(z_ext.double(), src, rb, nb,
                                           accum_dtype=torch.float64)
    err = _held(f"K1 {label}", a, want, exact, tol)
    print(f"K1 {label}: torch.equal to the CPU plan-order sums; repeat "
          f"and head 0 bit-identical; vs exact f64 sums max abs err "
          f"{err:.3e} (normalised <= {tol:g})")
    return err


def adversarial_pack():
    """A graph whose pack has a hub block hundreds of segments deep,
    empty dst blocks (kernel_checks appends all-sentinel rows)."""
    import numpy as np

    from pagerank_tpu_torch import build_graph

    rng = np.random.default_rng(5)
    n = 40000
    hub_src = np.arange(1, n)  # every vertex links to vertex 0
    src = np.concatenate([hub_src, rng.integers(0, n, 60000)])
    dst = np.concatenate([np.zeros(n - 1, np.int64),
                          rng.integers(0, n // 4, 60000)])
    return build_graph(src, dst, n=n)


def _shares(words, real, below):
    """'x% of real slots below the head, y% of slots sentinels'."""
    n_real = max(int(real.sum()), 1)
    return (f"{int(below.sum()) / n_real:.1%} of real slots below the head, "
            f"{1 - n_real / words.numel():.1%} of slots sentinels")


def kernel_checks(engine):
    """Phase 4: K1 against its plain versions, the head's share, and its
    timings; returns the K1 record."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine
    from pagerank_tpu_torch.analysis import kernels
    from pagerank_tpu_torch.ops import ell_spmv
    from pagerank_tpu_torch.ops.ell import segment_plan

    # -- at the main path's own shapes, every entry on the same slots
    z_ext, src, rb, nb, plan = engine.contrib_inputs()
    f32, f64 = torch.float32, torch.float64
    max_err = _k1_entry(z_ext, src, rb, nb, plan, f32, 1e-5,
                        "main-path f32/f32")
    _k1_entry(z_ext, src, rb, nb, plan, f64, 1e-6, "main-path f32/f64")
    _k1_entry(z_ext.double(), src, rb, nb, plan, f64, 1e-12,
              "main-path f64/f64")

    # -- the adversarial pack, in every entry
    g = adversarial_pack()
    eng = TorchEngine(PageRankConfig(), device="cuda").build(g)
    eng.set_ranks(np.random.default_rng(9).random(g.n).astype(np.float32))
    za, sa, ra, na, _ = eng.contrib_inputs()
    # A packed block always has a real slot in each row; append rows of
    # sentinels only (the JAX engine's row padding) to the last block.
    sent = torch.full((100, 128), za.shape[0] - 8, dtype=torch.int32,
                      device=sa.device)
    sa = torch.cat([sa, sent])
    ra = torch.cat([ra, torch.full((100,), na - 1, dtype=torch.int32,
                                   device=ra.device)])
    pa = ell_spmv.plan_to(segment_plan(ra.cpu().numpy(), na), sa.device)
    segs = torch.diff(pa.block_seg_start)
    _check(int(segs[0]) >= 100 and int((segs == 0).sum()) > 0,
           "adversarial pack lacks a deep hub block or an empty block")
    _k1_entry(za, sa, ra, na, pa, f32, 1e-5, "adversarial f32/f32")
    _k1_entry(za, sa, ra, na, pa, f64, 1e-6, "adversarial f32/f64")
    _k1_entry(za.double(), sa, ra, na, pa, f64, 1e-12,
              "adversarial f64/f64")
    del za, sa, ra, pa, eng

    # -- the head's share of the main path's slots
    n_state = z_ext.shape[0] - 8
    real = src != n_state
    head = ell_spmv.check_head(None, 4, n_state,
                               torch.cuda.get_device_name(0))
    print(f"K1 head {head} (f32): " + _shares(src, real, real & (src < head)))

    # -- times at the main path's shapes (f32/f32, as the main path runs)
    work = ell_spmv.workspace(plan, f32, z_ext.device)

    def k1():
        ell_spmv.ell_contrib(z_ext, src, rb, nb, accum_dtype=f32, plan=plan,
                             work=work)

    def twin():
        ell_spmv.ell_contrib_reference(z_ext, src, rb, nb, accum_dtype=f32)

    mask = src != n_state
    lanes = torch.arange(128, device=src.device)
    rows = (rb.long()[:, None] * 128 + lanes)[mask]
    ncols = z_ext.shape[0]
    key, _ = torch.sort(rows * ncols + src.long()[mask])
    rows, cols = key // ncols, key % ncols
    del key, mask
    crow = torch.zeros(nb * 128 + 1, dtype=torch.long, device=src.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=nb * 128), 0)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a_t = torch.sparse_csr_tensor(
            crow, cols,
            torch.ones(cols.shape[0], dtype=f32, device=src.device),
            size=(nb * 128, ncols))
    del rows
    zcol = z_ext[:, None]

    def library():
        torch.sparse.mm(a_t, zcol)

    lib_out = torch.sparse.mm(a_t, zcol)[:, 0]
    k_out = ell_spmv.ell_contrib(z_ext, src, rb, nb, accum_dtype=f32,
                                 plan=plan)
    lib_err = float((lib_out - k_out).abs().max()
                    / max(float(k_out.abs().max()), 1e-300))
    _check(lib_err <= 1e-5, f"torch.sparse.mm disagrees with K1: {lib_err}")

    ms = _median_ms(k1, 30)
    bind_ms = _host_ms(lambda: ell_spmv.bind(z_ext, src, nb, accum_dtype=f32,
                                             plan=plan, work=work))
    plain_ms = _median_ms(twin, 20)
    library_ms = _median_ms(library, 20)
    bare = _launch_ms(_variants(
        lambda head: ell_spmv.bind(z_ext, src, nb, accum_dtype=f32,
                                   plan=plan, head=head)))
    used = "head max"
    rows_n = src.shape[0]
    case = kernels.k1_case_from_inputs(
        "ell_contrib@main-path", z_ext, src, rb, nb, plan,
        device_kind=torch.cuda.get_device_name(0))
    _check_case(case)
    bytes_moved = int(case.cost_model["bytes"])
    bound_ms, bound_by = _bound_ms(case.cost_model)
    print(f"K1 timing at main-path shapes ({rows_n} rows x 128, "
          f"{plan.num_segments} segments, {nb} blocks, "
          f"{plan.empty_groups.shape[0]} empty): wrapper call {ms:.4f} ms "
          f"(its bind alone {bind_ms:.4f} ms on the host clock); "
          f"bare launch (bound launcher, 50 launches between two events, "
          f"median of 7 rounds in turns): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in bare.items())
          + f"; twin {plain_ms:.4f} ms, torch.sparse.mm {library_ms:.4f} ms, "
          f"{bound_by} bound {bound_ms:.4f} ms ({bytes_moved} B at "
          f"{_card().hbm_bytes_per_s / 1e12:g} TB/s; {bound_ms / ms:.1%} of "
          f"bound for the wrapper call, {bound_ms / bare[used]:.1%} for the "
          f"bare launch); PTK001-005 clean on the main path's plan")
    return {
        "name": "ell_contrib", "route": "cuda",
        "source": "pagerank_tpu_torch/csrc/ell_contrib.cu",
        "replaces": "pagerank_tpu/ops/pallas_spmv.py:98",
        "checked": True, "max_abs_err": max_err, "ms": ms,
        "launch_ms": bare[used], "variants_ms": bare,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "shapes": f"z_ext {_dt(z_ext)}[{z_ext.shape[0]}], src int32"
                  f"[{rows_n},128], {plan.num_segments} segments, {nb} "
                  f"blocks, head {head}",
    }


#: The old passes' kernel names: none may run in a step now.
OLD_PASSES = ("segment_partials", "block_sums", "pair_segment_partials",
              "pair_sums")


def step_breakdown(engine, kernel="K1", symbol="ell_contrib_kernel",
                   steps=10):
    """Where a step's time goes, on a path's engine: the host wall per
    step of ``steps`` unprofiled steps, then the device time per kernel
    over as many steps under torch.profiler — the path's one kernel
    ``symbol`` (launched once a step), the step's other (elementwise)
    kernels — and the device's idle share of the unprofiled wall. Fails
    if a pass-2 kernel of the first form, an ``index_add_`` or a slice
    add of the old pair expansion runs in the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # One warm-up step inside the profiler, whose events are dropped: the
    # first launch after the tracer starts can go unrecorded. The active
    # steps' events are taken when their cycle ends.
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        for _ in range(steps + 1):
            engine.step()
            torch.cuda.synchronize()
            prof.step()
    _check(len(traced) == 1, f"the profiler closed {len(traced)} cycles")
    per_kernel, calls, ops = {}, {}, set()
    for ev in traced[0]:
        if str(getattr(ev, "device_type", "")) != "DeviceType.CUDA":
            ops.add(ev.key)
            continue
        if ev.key.startswith("ProfilerStep"):
            continue  # the schedule's step ranges, not kernels
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us / 1e3 / steps
        calls[ev.key] = calls.get(ev.key, 0) + ev.count

    def named(k, p):  # "p" not preceded by a letter or "_"
        return re.search(rf"(?<![A-Za-z_]){p}", k) is not None

    mine = [k for k in per_kernel if named(k, symbol)]
    k_ms = sum(per_kernel[k] for k in mine)
    old = [k for k in per_kernel if any(named(k, p) for p in OLD_PASSES)
           or "index" in k.lower()]
    expand_ops = sorted(o for o in ops if o in ("aten::index_add_",
                                               "aten::add_"))
    busy = sum(per_kernel.values())
    other = busy - k_ms
    top = sorted(((v, k) for k, v in per_kernel.items() if k not in mine),
                 reverse=True)[:6]
    print(f"{kernel} step breakdown over {steps} steps: wall {wall_ms:.4f} "
          f"ms/step; device busy {busy:.4f} ms/step = {kernel} {k_ms:.4f} "
          f"({sum(calls[k] for k in mine)} launches) + other kernels "
          f"{other:.4f}; device idle {1 - busy / wall_ms:.1%} of the wall")
    for v, k in top:
        print(f"  other kernel {v:.4f} ms/step: {k[:100]}")
    _check(k_ms > 0 and sum(calls[k] for k in mine) == steps,
           f"the profiled steps show {sum(calls[k] for k in mine)} {kernel} "
           f"launches for {steps} steps")
    _check(not old and not expand_ops,
           f"a pass-2 or expansion kernel runs in the {kernel} step: "
           f"{old} {expand_ops}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "kernel_ms": k_ms,
            "other_ms": other}


def partitioned_path(graph, oracle, flat_rows):
    """Phase 5: the partition-centric path on the main path's graph, in
    f32 and with the bf16 window stream; returns (f32 engine, bf16
    engine, report)."""
    import numpy as np

    from pagerank_tpu_torch import PageRankConfig, TorchEngine, cli

    span = cli.plan_partition_span(PageRankConfig(), graph.n,
                                   graph.num_edges, -1)
    _check(span > 0, f"the auto rule turned the partitioned form off at "
           f"n={graph.n} edges={graph.num_edges}")
    engines, report = [], {}
    for stream in ("", "bfloat16"):
        cfg = PageRankConfig(num_iters=ITERS, partition_span=span,
                             stream_dtype=stream)
        eng = TorchEngine(cfg, device="cuda")
        t0 = time.perf_counter()
        eng.build(graph)
        build_s = time.perf_counter() - t0
        lay = eng.layout_info()
        step_s = []
        t_last = [time.perf_counter()]

        def on_iteration(i, info):
            now = time.perf_counter()
            step_s.append(now - t_last[0])
            t_last[0] = now

        _reset_counts()
        ranks = eng.run(on_iteration=on_iteration)
        k1, k2, probe = _read_counts()
        label = f"partitioned {stream or 'f32'}"
        _check(k2 == ITERS == eng.iteration and k1 == 0
               and not any(probe.values()),
               f"{label}: ell_contrib_partitioned launched {k2} times "
               f"(ell_contrib {k1}, the probe kernels {probe}) in "
               f"{eng.iteration} steps")
        _check(ranks.shape == (graph.n,) and np.isfinite(ranks).all(),
               f"{label}: ranks are not finite of shape (n,)")
        l1 = float(np.abs(ranks - oracle).sum() / np.abs(oracle).sum())
        if stream:
            _check(1e-7 < l1 < 5e-3, f"{label}: normalised L1 {l1} vs the "
                   f"f64 oracle outside (1e-7, 5e-3)")
        else:
            _check(l1 <= 1e-4, f"{label}: normalised L1 {l1} > 1e-4")
        ms = statistics.median(step_s) * 1e3
        bs = lay["build_seconds"]
        print(f"{label} rmat path: span {lay['partition_span']} K="
              f"{lay['partitions']} pairs {lay['pairs']} slot rows "
              f"{lay['slot_rows']} ({lay['slot_rows'] / flat_rows:.4f}x the "
              f"flat pack's {flat_rows}), {lay['num_segments']} segments, "
              f"words24 {lay['words24']}, {lay['z_dtype']} windows; "
              f"{ms:.3f} ms/iter {graph.num_edges / (ms / 1e3):.6g} edges/s, "
              f"K2 launches {k2} in {ITERS} steps, f64 oracle normalised "
              f"L1 {l1:.3e}; build {build_s:.3f} s = pack {bs['pack']:.3f} "
              f"+ planes/pair ranks/words/plan {bs['plan']:.3f} + placement "
              f"{bs['place']:.3f}")
        engines.append(eng)
        report[stream or "f32"] = {"launches": k2, "ms_per_iter": ms,
                                   "l1": l1}
    return engines[0], engines[1], report


def _k2_entry(inputs, label, tol=1e-5):
    """K2 at one entry: its block sums torch.equal to the plain
    plan-order sums computed on the CPU from the same inputs; repeat and a
    head of 0 bit-identical on one workspace, its counters left zero; within ``tol`` of the exact (f64) sums of the
    same widened values. Returns K2's max abs error."""
    import torch

    from pagerank_tpu_torch.ops import ell_spmv
    from pagerank_tpu_torch.ops import ell_spmv_partitioned as k2

    zw, slots, rp, pp, npairs, plan = inputs
    work = k2.workspace(plan, zw.device)

    def run(**kw):
        return k2.ell_contrib_partitioned(zw, slots, rp, pp, npairs,
                                          plan=plan, work=work, **kw)

    a, b, c = run(), run(), run(head=0)
    torch.cuda.synchronize()
    _check(torch.equal(a, b), f"K2 {label}: two launches differ")
    _check(not work.counter.any(), f"K2 {label}: counters left non-zero")
    _check(torch.equal(a, c), f"K2 {label}: a head of 0 changed bits")
    want = k2.ell_contrib_partitioned_plan_reference(
        zw.cpu(), slots.cpu(), pp.cpu(), plan=ell_spmv.plan_to(plan, "cpu"))
    exact = k2.expand_pairs(
        k2.ell_contrib_partitioned_reference(zw.double(), slots, rp, pp,
                                             npairs),
        pp, plan.pair_block, plan.num_blocks)
    err = _held(f"K2 {label}", a, want, exact, tol)
    print(f"K2 {label}: block sums torch.equal to the CPU plan-order sums; "
          f"repeat and head 0 bit-identical; vs exact f64 sums max abs err "
          f"{err:.3e} (normalised <= {tol:g})")
    return err


def adversarial_partitioned(span=4096, deep=50):
    """Inputs of K2 on a pack with deep hub pairs (the hub's in-edges
    cut over every partition; at least ``deep`` segments), empty
    partitions (isolated vertices relabeled last), empty blocks and
    appended all-sentinel rows. At a span of 1024 (59 partitions, hub
    pairs of 16 segments) the hub's block is fed by 40 pairs, more than
    the 32 segments of a finisher's chunk."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine, build_graph
    from pagerank_tpu_torch.ops import ell_spmv
    from pagerank_tpu_torch.ops.ell import pair_plan
    from pagerank_tpu_torch.ops.spmv import pack_words24

    rng = np.random.default_rng(5)
    n, live = 60000, 40000  # ids >= 40000 are isolated
    src = np.concatenate([np.arange(1, live), rng.integers(0, live, 60000)])
    dst = np.concatenate([np.zeros(live - 1, np.int64),
                          rng.integers(0, live // 4, 60000)])
    g = build_graph(src, dst, n=n)
    eng = TorchEngine(PageRankConfig(partition_span=span),
                      device="cuda").build(g)
    eng.set_ranks(rng.random(n).astype(np.float32))
    zw, slots, rp, pp, npairs, plan = eng.contrib_inputs()
    # 100 rows of sentinels only, appended to the last pair.
    sent = torch.full((1, 128), plan.sentinel, dtype=torch.int32,
                      device=zw.device)
    slots = torch.cat([slots, pack_words24(sent).expand(100, -1)]).contiguous()
    rp = torch.cat([rp, torch.full((100,), npairs - 1, dtype=torch.int32,
                                   device=rp.device)])
    plan = ell_spmv.plan_to(pair_plan(
        rp.cpu().numpy(), npairs, plan.pair_block.cpu().numpy(),
        plan.num_blocks, plan.sentinel), zw.device)
    segs = torch.diff(plan.block_seg_start)
    part_rows = torch.bincount(pp[rp.long()].long(), minlength=zw.shape[0])
    _check(int(segs.max()) >= deep and int((part_rows == 0).sum()) > 0
           and plan.empty_blocks.shape[0] > 0
           and int(torch.diff(plan.block_pair_start).max()) > 1,
           "adversarial partitioned pack lacks a deep pair, an empty "
           "partition, an empty block or a block of several pairs")
    return zw, slots, rp, pp, npairs, plan


def _block_csr(zw, slots, rp, pp, plan):
    """K2's function as a CSR matrix: row block*128 + lane, column
    part*W + word, one 1 per real slot (block sums = matrix x windows)."""
    import torch

    from pagerank_tpu_torch.ops.spmv import unpack_words24

    words = unpack_words24(slots).long()
    mask = words != plan.sentinel
    lanes = torch.arange(128, device=slots.device)
    rows = (plan.pair_block.long()[rp.long()][:, None] * 128 + lanes)[mask]
    ncols = zw.numel()
    cols = (pp.long()[rp.long()][:, None] * zw.shape[1] + words)[mask]
    del words, mask
    key, _ = torch.sort(rows * ncols + cols)
    rows, cols = key // ncols, key % ncols
    del key
    nrows = plan.num_blocks * 128
    crow = torch.zeros(nrows + 1, dtype=torch.long, device=slots.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=nrows), 0)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            crow, cols, torch.ones(cols.shape[0], dtype=torch.float32,
                                   device=slots.device),
            size=(nrows, ncols))


def k2_checks(eng32, eng16):
    """Phase 6: K2 against its plain versions in every entry, the head's
    share, and its timings; returns the K2 record."""
    import torch

    from pagerank_tpu_torch.analysis import kernels
    from pagerank_tpu_torch.ops import ell_spmv
    from pagerank_tpu_torch.ops import ell_spmv_partitioned as k2
    from pagerank_tpu_torch.ops import spmv

    inputs = eng32.contrib_inputs()
    zw, slots, rp, pp, npairs, plan = inputs
    max_err = _k2_entry(inputs, "path f32 windows, words24")
    int32 = (zw, spmv.unpack_words24(slots).contiguous()) + inputs[2:]
    _k2_entry(int32, "path f32 windows, int32 words")
    in16 = eng16.contrib_inputs()
    _k2_entry(in16, "path bf16 windows, words24")
    _k2_entry((in16[0],) + int32[1:], "path bf16 windows, int32 words")
    adv = adversarial_partitioned()
    _k2_entry(adv, "adversarial f32 windows, words24")
    _k2_entry((adv[0].to(torch.bfloat16),) + adv[1:],
              "adversarial bf16 windows, words24")
    adv = adversarial_partitioned(1024, deep=16)
    _check(int(torch.diff(adv[5].block_pair_start).max()) > ell_spmv.CHUNK,
           "the 59-partition pack has no block of more than 32 pairs")
    _k2_entry(adv, "adversarial 59 partitions, f32 windows, words24")
    del adv

    words = spmv.unpack_words24(slots)
    real = words != plan.sentinel
    part0 = (pp.long()[rp.long()] == 0)[:, None]
    kind = torch.cuda.get_device_name(0)
    for table, item in (("f32", 4), ("bf16", 2)):
        h = ell_spmv.check_head(None, item, plan.sentinel, kind)
        print(f"K2 head {h} of partition 0 ({table} windows, words24): "
              + _shares(words, real, real & part0 & (words < h)))
    del words, real, part0

    work = k2.workspace(plan, zw.device)

    def kernel(args):
        return lambda: k2.ell_contrib_partitioned(*args[:5], plan=args[5],
                                                  work=work)

    def twin():
        k2.expand_pairs(k2.ell_contrib_partitioned_reference(*inputs[:5]),
                        pp, plan.pair_block, plan.num_blocks)

    a_t = _block_csr(zw, slots, rp, pp, plan)
    zcol = zw.reshape(-1, 1)

    def library():
        torch.sparse.mm(a_t, zcol)

    lib_out = torch.sparse.mm(a_t, zcol)[:, 0]
    k_out = kernel(inputs)()
    lib_err = float((lib_out - k_out).abs().max()
                    / max(float(k_out.abs().max()), 1e-300))
    _check(lib_err <= 1e-5, f"torch.sparse.mm disagrees with K2: {lib_err}")

    ms = _median_ms(kernel(inputs), 30)
    bind_ms = _host_ms(lambda: k2.bind(zw, slots, pp, npairs, plan=plan,
                                       work=work))
    ms_int32 = _median_ms(kernel(int32), 30)
    ms_bf16 = _median_ms(kernel(in16), 30)
    plain_ms = _median_ms(twin, 20)
    library_ms = _median_ms(library, 20)

    def binder(args):
        return lambda head: k2.bind(args[0], args[1], args[3], args[4],
                                    plan=args[5], head=head)

    bare = _launch_ms(_variants(binder(inputs)))
    bare16 = _launch_ms(_variants(binder(in16)))
    used = "head max"
    rows = slots.shape[0]
    case = kernels.k2_case_from_inputs("ell_contrib_partitioned@path",
                                       *inputs, device_kind=kind)
    case16 = kernels.k2_case_from_inputs(
        "ell_contrib_partitioned@path-bf16", *in16, device_kind=kind)
    for c in (case, case16,
              kernels.k2_case_from_inputs("ell_contrib_partitioned@int32",
                                          *int32, device_kind=kind)):
        _check_case(c)
    bytes_moved = int(case.cost_model["bytes"])
    bound_ms, bound_by = _bound_ms(case.cost_model)
    print(f"K2 timing at path shapes ({rows} rows x 384 B, {zw.shape[0]} "
          f"windows of {zw.shape[1]}, {plan.num_segments} segments, {npairs} "
          f"pairs, {plan.num_blocks} blocks, {plan.empty_blocks.shape[0]} "
          f"empty): wrapper call {ms:.4f} ms (f32 windows, words24; block "
          f"sums, the expansion included; its bind alone {bind_ms:.4f} ms "
          f"on the host clock), {ms_int32:.4f} ms (int32 words), "
          f"{ms_bf16:.4f} ms (bf16 windows; byte bound "
          f"{_bound_ms(case16.cost_model)[0]:.4f} ms); bare launch (50 "
          f"between two events, median of 7 rounds in turns), f32: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in bare.items())
          + "; bf16: " + ", ".join(f"{k} {v:.4f} ms"
                                   for k, v in bare16.items())
          + f"; twin + expansion {plain_ms:.4f} ms, torch.sparse.mm "
          f"{library_ms:.4f} ms, {bound_by} bound {bound_ms:.4f} ms "
          f"({bytes_moved} B at {_card().hbm_bytes_per_s / 1e12:g} TB/s; "
          f"{bound_ms / ms:.1%} of bound for the wrapper call, "
          f"{bound_ms / bare[used]:.1%} for the bare launch); PTK001-005 "
          f"clean on the path's plans (f32, bf16, int32 words)")
    return {
        "name": "ell_contrib_partitioned", "route": "cuda",
        "source": "pagerank_tpu_torch/csrc/ell_contrib_partitioned.cu",
        "replaces": "pagerank_tpu/ops/pallas_spmv.py:241",
        "checked": True, "max_abs_err": max_err, "ms": ms,
        "launch_ms": bare[used], "variants_ms": bare,
        "variants_bf16_ms": bare16,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "shapes": f"z_windows {_dt(zw)}[{zw.shape[0]},{zw.shape[1]}], "
                  f"words24 int8[{rows},384], {plan.num_segments} "
                  f"segments, {npairs} pairs, {plan.num_blocks} blocks",
    }


# (kernel form, its plain form) of the gather probe, P1-P3.
PROBE_PAIRS = (("probe_take", "take1d"), ("probe_group8", "onehot8"),
               ("probe_rowsel_smem", "onehot128mxu"))
PROBE_ITERS = 30
# The Pallas body each kernel form replaces.
PROBE_REPLACES = {"probe_take": "scripts/probe_gather.py:169",
                  "probe_group8": "scripts/probe_gather.py:174",
                  "probe_rowsel_smem": "scripts/probe_gather.py:183"}


def _probe_point(label, z, src, w):
    """One point of the gather probe: ``run_probe`` over P1-P3 (where
    each applies) and their plain forms, with every count set to 0 just
    before and read just after; then each kernel that ran against its
    plain version (torch.equal), twice (bit-identical, counted), and one
    ``torch.index_select`` as the library yardstick. Returns {kernel
    form: numbers}."""
    import torch

    from pagerank_tpu_torch.analysis.kernels import probe_cost
    from pagerank_tpu_torch.ops import gather_probe as gp
    from pagerank_tpu_torch.scripts import probe_gather as pg

    rows, n = src.shape[0], z.shape[0]
    ran = [k for k, _ in PROBE_PAIRS if pg.skip_reason(k, n, z.dtype) is None]
    forms = [f for k, plain in PROBE_PAIRS
             for f in ((k, plain) if k in ran else (k,))]
    _reset_counts()
    times = pg.run_probe(z, src, w, iters=PROBE_ITERS, forms=forms)
    k1, k2, counts = _read_counts()
    want = {pg.KERNELS[k]: pg.WARMUP + PROBE_ITERS if k in ran else 0
            for k, _ in PROBE_PAIRS}
    want.update({k: 0 for k in counts if k.startswith("fx:")})
    _check(counts == want and k1 == 0 and k2 == 0,
           f"probe {label}: launches {counts} (K1 {k1}, K2 {k2}), want "
           f"{want} and no K1 or K2")
    bound_ms = _bound_ms(probe_cost(rows, n, z.element_size()))[0]
    library_ms = _median_ms(lambda: torch.index_select(z, 0, src.view(-1)),
                            PROBE_ITERS)
    out, parts = {}, []
    for kform, plain in PROBE_PAIRS:
        if kform not in ran:
            parts.append(f"{kform} {times[kform]}")
            continue
        name = pg.KERNELS[kform]
        before = gp.launches[name]
        a = pg.FORMS[kform](z, src, w)
        b = pg.FORMS[kform](z, src, w)
        ref = pg.FORMS[plain](z, src, w)
        torch.cuda.synchronize()
        _check(gp.launches[name] == before + 2,
               f"probe {label}: {name} counted {gp.launches[name] - before} "
               f"of 2 launches")
        _check(torch.equal(a, b), f"probe {label}: two {name} launches differ")
        _check(torch.equal(a, ref),
               f"probe {label}: {name} differs from its plain version")
        ms = times[kform]
        out[kform] = {"ms": ms, "plain_ms": times[plain],
                      "library_ms": library_ms, "bound_ms": bound_ms,
                      "launches": counts[name],
                      "max_abs_err": float((a.float() - ref.float()).abs()
                                           .max()),
                      "shapes": f"z {_dt(z)}[{n}], src int32[{rows},128], "
                                f"w {_dt(w)}[{rows},128]"}
        parts.append(f"{kform} {ms:.4f} ms ({bound_ms / ms:.1%} of bound; "
                     f"plain {times[plain]:.4f} ms)")
    print(f"probe {label}: rows {rows} x 128, z {_dt(z)}[{n}]; byte bound "
          f"{bound_ms:.4f} ms, index_select {library_ms:.4f} ms; "
          + "; ".join(parts) + "; each kernel torch.equal to its plain "
          "version, repeat bit-identical, launches counted")
    return out


def _k2_global_slots(eng):
    """K2's slots of ``eng`` as global indices into its flattened
    windows: (z [K*W], src int32 [rows, 128])."""
    import torch

    from pagerank_tpu_torch.ops.spmv import unpack_words24

    zw, slots, rp, pp, _, _ = eng.contrib_inputs()
    base = pp.long()[rp.long()] * zw.shape[1]
    src = (base[:, None] + unpack_words24(slots).long()).to(torch.int32)
    return zw.reshape(-1), src


def gather_probe_phase(k1_slots, k2_slots, step_ms):
    """Phase 7: P1-P3 on the main path's own slot arrays (K1's flat
    pack, K2's windowed pack as global indices, f32 and bf16 windows)
    beside each kernel's device time in a profiled step, then the
    uniform sweep at 2^19 rows. Returns the P1, P2, P3 records."""
    import torch

    from pagerank_tpu_torch.scripts.probe_gather import KERNELS

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)

    def weights(src, dtype):
        return torch.rand(src.shape, generator=gen, device="cuda").to(dtype)

    t0 = time.perf_counter()
    z, src = k1_slots
    at_k1 = _probe_point("on K1's slots (flat pack, rmat:22)", z, src,
                         weights(src, z.dtype))
    print(f"  K1 (profiled step) {step_ms['K1']:.4f} ms against P1 "
          f"{at_k1['probe_take']['ms']:.4f} ms and P2 "
          f"{at_k1['probe_group8']['ms']:.4f} ms on the same slots")
    for label, (z, src) in k2_slots.items():
        at = _probe_point(f"on {label}'s slots (windowed pack, rmat:22)", z,
                          src, weights(src, z.dtype))
        print(f"  {label} (profiled step) {step_ms[label]:.4f} ms "
              f"against P1 {at['probe_take']['ms']:.4f} ms and P2 "
              f"{at['probe_group8']['ms']:.4f} ms on the same slots")
    rows = 1 << 19
    w32 = torch.rand((rows, 128), generator=gen, device="cuda")
    sweep = {}
    for log_n in (15, 20, 22, 24):
        n = 1 << log_n
        src = torch.randint(0, n, (rows, 128), generator=gen, device="cuda",
                            dtype=torch.int32)
        z32 = torch.rand(n, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            sweep[log_n, dtype] = _probe_point(
                f"uniform n=2^{log_n}", z32.to(dtype), src, w32.to(dtype))
        del src, z32
    for dtype in (torch.float32, torch.bfloat16):
        _check("probe_rowsel_smem" in sweep[15, dtype],
               f"P3 did not run at n=2^15 {dtype}")
    print(f"gather probe phase took {time.perf_counter() - t0:.1f} s")
    picks = (("probe_take", at_k1), ("probe_group8", at_k1),
             ("probe_rowsel_smem", sweep[15, torch.float32]))
    return [{"name": KERNELS[k], "route": "cuda",
             "source": "pagerank_tpu_torch/csrc/gather_probe.cu",
             "replaces": PROBE_REPLACES[k], "checked": True,
             "bound_by": "bytes", **at[k]} for k, at in picks]


def _analysis(*args):
    """Start ``python -m pagerank_tpu_torch.analysis --select PTK
    --compiled --json`` with ``args``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, "-m", "pagerank_tpu_torch.analysis", "--select",
         "PTK", "--compiled", "--json", *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def analysis_phase():
    """Phase 9a: the kernel-plane check with the compile facts read from
    the built libraries: the shipped registry exits 0 with no finding,
    each defect fixture exits 1 with exactly its rule. Prints every
    shipped symbol's registers, shared bytes and spills."""
    from pagerank_tpu_torch.analysis import kernels

    t0 = time.perf_counter()
    fixtures = {c.label.split(":")[1]: c for c in kernels.defect_cases()}
    procs = {"shipped": _analysis()}
    procs.update({n: _analysis("--kernel-fixture", n) for n in fixtures})
    docs = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        want = 0 if name == "shipped" else 1
        _check(proc.returncode == want,
               f"analysis --compiled {name}: exit {proc.returncode}, want "
               f"{want}\n{out[-2000:]}\n{err[-2000:]}")
        docs[name] = json.loads(out)
        _check(docs[name]["compiled"], f"analysis {name}: no compile facts")
    _check(not docs["shipped"]["findings"],
           f"shipped kernels have findings: {docs['shipped']['findings']}")
    rules = {}
    for name, case in fixtures.items():
        got = {f["rule"] for f in docs[name]["findings"]}
        want = {f.rule for f in kernels.check_kernel_case(case)}
        _check(len(want) == 1 and got == want,
               f"fixture {name}: rules {sorted(got)} with compile facts, "
               f"want exactly {sorted(want)}")
        rules[name] = got.pop()
    dyn = {}
    shipped = kernels.shipped_cases()
    for case in shipped:
        for ln in case.launches:
            dyn[ln.key] = max(dyn.get(ln.key, 0), ln.dynamic_smem)
    facts = docs["shipped"]["compile_facts"]
    print(f"kernel-plane check with compile facts (cuobjdump): "
          f"{len(shipped)} shipped cases clean over "
          f"{len(facts)} symbols; fixtures trip "
          + ", ".join(f"{n} {r}" for n, r in rules.items())
          + f" ({time.perf_counter() - t0:.1f} s)")
    for key, f in sorted(facts.items()):
        print(f"  {key}: {f['regs']} registers, {f['shared']} B static "
              f"shared, up to {dyn[key]} B dynamic, {f['local']} B local "
              f"(spills), launch bounds {f['max_threads']}, f64 ops "
              f"{list(f['f64_ops']) or 'none'}")
    return rules


# F1-F6: the JAX fixture's pl.pallas_call each kernel replaces.
FIXTURE_REPLACES = {
    "vmem_overflow": "pagerank_tpu/analysis/kernels.py:358",
    "misaligned_tile": "pagerank_tpu/analysis/kernels.py:371",
    "index_gap": "pagerank_tpu/analysis/kernels.py:384",
    "index_overlap": "pagerank_tpu/analysis/kernels.py:398",
    "f64_scratch": "pagerank_tpu/analysis/kernels.py:411",
    "cost_mismatch": "pagerank_tpu/analysis/kernels.py:425",
}


def fixture_phase(rules):
    """Phase 9b: F1-F6 on the card at the JAX fixtures' shapes, the counts
    set to 0 before and read after. F1 at its geometry must be refused
    and leave no error pending; at 2^15 it equals its plain copy. F2 and
    F5 equal their plain versions; F3 too, with NaN at exactly the
    elements PTK003 names; F4 holds one of its two writers in every
    element; F6 is within 1e-5 (normalised) of an f64 matmul. Each is
    timed beside its bound and a library call. Returns the records."""
    import torch

    from pagerank_tpu_torch.analysis import kernels
    from pagerank_tpu_torch.ops import defect_fixtures as fx

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    cases = {c.label.split(":")[1]: c for c in kernels.defect_cases()}
    inputs = {"vmem_overflow": (rnd(1 << 15),),
              "misaligned_tile": (rnd(200, 128),),
              "index_gap": (rnd(16, 128),), "index_overlap": (rnd(32, 128),),
              "f64_scratch": (rnd(16, 128),),
              "cost_mismatch": (rnd(256, 128), rnd(128, 128))}
    big = rnd(fx.OVERFLOW_N)
    _reset_counts()
    try:
        fx.vmem_overflow(big)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    torch.cuda.synchronize()
    pending = fx.last_error()
    outs = {n: getattr(fx, n)(*a) for n, a in inputs.items()}
    torch.cuda.synchronize()
    k1, k2, counts = _read_counts()
    del big
    _check(refused is not None, "F1 launched 32 MiB of shared memory")
    _check(pending == 0, f"F1's refusal left CUDA error {pending} pending")
    want = {f"fx:{n}": 1 for n in inputs}
    _check({k: v for k, v in counts.items() if k.startswith("fx:")} == want
           and k1 == k2 == 0
           and not any(v for k, v in counts.items()
                       if not k.startswith("fx:")),
           f"fixture launches {counts} (K1 {k1}, K2 {k2}), want {want}")
    print(f"F1 at its geometry (x f32 [{fx.OVERFLOW_N}], "
          f"{fx.OVERFLOW_N * 4} B of shared memory; the checker says "
          f"{rules['vmem_overflow']}) refused: {refused}; no error pending "
          f"after it")
    errs = {}
    for name, args in inputs.items():
        got = outs[name]
        ref = getattr(fx, f"{name}_reference")(*args)
        if name == "index_overlap":
            x = args[0]
            one = torch.zeros_like(got, dtype=torch.bool)
            err = torch.zeros_like(got)
            for t in range(got.shape[0] // 8):
                o = got[t * 8:(t + 1) * 8]
                a, b = x[t * 8:(t + 1) * 8], x[(t + 2) * 8:(t + 3) * 8]
                one[t * 8:(t + 1) * 8] = (o == a) | (o == b)
                err[t * 8:(t + 1) * 8] = torch.minimum((o - a).abs(),
                                                       (o - b).abs())
            _check(bool(one.all()), "F4: an element holds neither writer")
            errs[name] = float(err.max())
        elif name == "cost_mismatch":
            exact = args[0].double() @ args[1].double()
            errs[name] = float((got.double() - exact).abs().max())
            _check(errs[name] <= 1e-5 * float(exact.abs().max()),
                   f"F6: max error {errs[name]} vs the f64 matmul")
        else:
            _check(got.shape == ref.shape and torch.equal(
                torch.nan_to_num(got, nan=-1.0),
                torch.nan_to_num(ref, nan=-1.0))
                and torch.equal(got.isnan(), ref.isnan()),
                f"{name} differs from its plain version")
            errs[name] = 0.0
        if name == "index_gap":
            nan = torch.zeros(got.numel(), dtype=torch.bool, device="cuda")
            for a, b in kernels.write_gaps(cases[name], "out"):
                nan[a:b] = True
            _check(torch.equal(got.reshape(-1).isnan(), nan),
                   "F3: NaN elements differ from the gaps PTK003 names")
    print("F2, F3 (NaN at exactly the PTK003 gaps "
          f"{kernels.write_gaps(cases['index_gap'], 'out')}) and F5 equal "
          f"their plain versions; F4 holds one writer per element (max "
          f"distance to the nearer writer {errs['index_overlap']}); F6 max "
          f"abs error {errs['cost_mismatch']:.3e} vs an f64 matmul")
    records = []
    for name, args in inputs.items():
        fn = getattr(fx, name)
        ref = getattr(fx, f"{name}_reference")
        if name == "cost_mismatch":
            lib_out = torch.empty_like(outs[name])

            def library():
                torch.matmul(*args, out=lib_out)
        else:
            lib_out = torch.empty_like(args[0])

            def library():
                lib_out.copy_(args[0])
        before = fx.launches[name]
        ms = _median_ms(lambda: fn(*args), 30)
        timed = fx.launches[name] - before
        plain_ms = _median_ms(lambda: ref(*args), 30)
        library_ms = _median_ms(library, 30)
        # Each input read once and the output written once; F6 also its
        # 2mkn FLOPs.
        cost = {"bytes": float(sum(a.numel() for a in args)
                               + outs[name].numel()) * 4,
                "flops": (2.0 * args[0].shape[0] * args[0].shape[1]
                          * args[1].shape[1] if name == "cost_mismatch"
                          else 0.0)}
        bound_ms, bound_by = _bound_ms(cost)
        print(f"F {name}: {ms:.4f} ms a wrapper call, its NaN fill "
              f"included ({timed} launches timed), plain "
              f"{plain_ms:.4f} ms, {'torch.matmul' if name == 'cost_mismatch' else 'Tensor.copy_'} "
              f"{library_ms:.4f} ms, {bound_by} bound {bound_ms:.6f} ms "
              f"({int(cost['bytes'])} B, {int(cost['flops'])} FLOP)")
        records.append({
            "name": f"fx_{name}", "route": "cuda",
            "source": "pagerank_tpu_torch/csrc/defect_fixtures.cu",
            "replaces": FIXTURE_REPLACES[name], "checked": True,
            "launches": counts[f"fx:{name}"], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "rule": rules[name],
            "shapes": ", ".join(f"{_dt(a)}{list(a.shape)}" for a in args)})
    return records


def resume_determinism(scale, tmp, extra=()):
    """Phase 8: 6 iterations + resume to 10 == 10 uninterrupted, through
    the CLI with ``extra`` flags."""
    import numpy as np

    from pagerank_tpu_torch import cli

    base = ["--synthetic", f"rmat:{scale}", "--dtype", "float32", *extra]
    tag = "-".join(extra) or "flat"
    cut = os.path.join(tmp, f"cut{tag}")
    ctrl = os.path.join(tmp, f"ctrl{tag}")
    cli.run(base + ["--iters", "6", "--snapshot-dir", cut])
    s = cli.run(base + ["--iters", str(ITERS), "--snapshot-dir", cut,
                        "--resume"])
    _check(s["resumed_from"] == 6, f"resumed from {s['resumed_from']}, not 6")
    cli.run(base + ["--iters", str(ITERS), "--snapshot-dir", ctrl])
    a = np.load(os.path.join(cut, f"ranks_iter{ITERS}.npz"))["ranks"]
    b = np.load(os.path.join(ctrl, f"ranks_iter{ITERS}.npz"))["ranks"]
    _check(np.array_equal(a, b), "resumed run differs from uninterrupted")
    print(f"resume rmat:{scale} {' '.join(extra)} ({s['form']}, span "
          f"{s['partition_span']}, K={s['partitions']}): 6 + resume to "
          f"{ITERS} is bit-equal to an uninterrupted {ITERS}")
    return s["form"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=int, default=22,
                   help="R-MAT scale of the main path (default 22)")
    p.add_argument("--resume-scale", type=int, default=18,
                   help="R-MAT scale of the resume check (default 18)")
    args = p.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "pagerank_tpu_torch", "csrc")):
        print("chip_smoke.py must run from a checkout of the repo "
              "(pagerank_tpu_torch/ is missing beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card_identity()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    build_kernels()
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=scratch) as tmp:
        summary, report, oracle = main_path(args.scale, tmp)
        k1 = kernel_checks(summary["engine"])
        k1["launches"] = report["launches"]
        step_ms = {"K1": step_breakdown(summary["engine"])["kernel_ms"]}
        k1_slots = summary["engine"].contrib_inputs()[:2]
        graph = summary["graph"]
        flat_rows = summary["engine"].layout_info()["num_rows"]
        del summary
        eng32, eng16, part_report = partitioned_path(graph, oracle, flat_rows)
        del graph, oracle
        k2 = k2_checks(eng32, eng16)
        k2["launches"] = part_report["f32"]["launches"]
        k2_slots = {}
        for eng, label in ((eng32, "K2"), (eng16, "K2 (bf16 windows)")):
            step_ms[label] = step_breakdown(
                eng, label, "ell_contrib_part_kernel")["kernel_ms"]
            k2_slots[label] = _k2_global_slots(eng)
        del eng32, eng16
        probe = gather_probe_phase(k1_slots, k2_slots, step_ms)
        del k1_slots, k2_slots
        resume_determinism(args.resume_scale, tmp)
        form = resume_determinism(args.resume_scale, tmp,
                                  ("--partition-span", "-1"))
        _check(form == "pallas_partitioned",
               f"--partition-span -1 at rmat:{args.resume_scale} ran {form}")
    fixtures = fixture_phase(analysis_phase())
    print(f"chip smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, *probe, *fixtures]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
