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
  4. holds K1 (ell_contrib) against its plain PyTorch twin on the card,
     at the main path's own shapes (the engine's packed slots, the
     prescaled final ranks) and on a small adversarial pack (a hub block
     hundreds of segments deep, empty blocks, all-sentinel rows):
     normalised max error against the twin's exact (f64) sums of the
     same values <= 1e-5 in f32 (the sum order differs), <= 1e-12 in
     f64, and two launches on the same inputs bit-identical.
     Times K1 (CUDA events, median of 30 launches after warm-up), the
     twin, and one torch.sparse.mm of the same matrix as a yardstick,
     beside K1's byte bound; then splits a main-path step's time by
     kernel with torch.profiler (K1's two passes, the elementwise
     kernels, the device's idle share);
  5. the partition-centric path on the graph phase 3 built: the span
     from the CLI's resolver at -1, a TorchEngine on cuda for 10
     iterations in f32 and again with the bf16 window stream. The
     counts are set to 0 before each run and read after: K2's must be
     10, K1's 0. Normalised L1 against phase 3's f64 oracle <= 1e-4
     (f32), and in (1e-7, 5e-3) for bf16 (a real bf16 run, inside
     quantization grade);
  6. holds K2 (ell_contrib_partitioned) against its twin on the card at
     that path's shapes, with f32 and bf16 windows, 3-byte and int32
     words, and on an adversarial pack (deep hub pairs, empty
     partitions, all-sentinel rows): normalised max error against the
     twin's exact (f64) sums of the same (widened) values <= 1e-5, two
     launches bit-identical. Times K2, the twin and one torch.sparse.mm
     of the same pair-row x windowed-z matrix (f32) beside K2's byte
     bound, times the pair -> block expansion, and splits the
     partitioned step (f32 and bf16 windows) by kernel with
     torch.profiler;
  7. resume determinism on the card, for the flat form and through the
     CLI's --partition-span -1: 6 iterations with snapshots, a resume
     to 10, and an uninterrupted 10 give bit-equal ranks;
  8. prints one JSON line with every kernel's numbers, then last
     ``{"ok": true, "device": {...}}``.

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
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
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
    from pagerank_tpu_torch.ops import ell_spmv, ell_spmv_partitioned

    ell_spmv.launches = 0
    ell_spmv_partitioned.launches = 0


def _read_counts():
    """(K1 launches, K2 launches) since the last reset."""
    from pagerank_tpu_torch.ops import ell_spmv, ell_spmv_partitioned

    return ell_spmv.launches, ell_spmv_partitioned.launches


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
    launches, k2_launches = _read_counts()
    graph, ranks = summary["graph"], summary["ranks"]
    _check(summary["engine"].device.type == "cuda", "main path not on cuda")
    _check(summary["form"] == "flat_ell", f"main path ran {summary['form']}")
    _check(launches == summary["iterations"] == ITERS and k2_launches == 0,
           f"ell_contrib launched {launches} times (ell_contrib_partitioned "
           f"{k2_launches}) in {summary['iterations']} steps (want one K1 "
           f"launch per step, {ITERS} steps, no K2)")
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


def _k1_compare(z_ext, src, rb, nb, plan, accum, tol, label):
    """K1 vs its plain twin on the same inputs; bit-identity on repeat.

    The gate holds K1 against the twin run on the same z values widened
    to f64 with f64 sums (the exact answer to ~1e-16): a hub block sums
    ~10^5 terms, so at f32 any two summation orders — K1's segments and
    the twin's atomics — differ by ~1e-5 of the largest sum, and the
    gate must say which one is off. K1 against the twin in K1's own
    dtypes is printed beside it. Returns K1's max abs error."""
    import torch

    from pagerank_tpu_torch.ops import ell_spmv

    a = ell_spmv.ell_contrib(z_ext, src, rb, nb, accum_dtype=accum, plan=plan)
    b = ell_spmv.ell_contrib(z_ext, src, rb, nb, accum_dtype=accum, plan=plan)
    exact = ell_spmv.ell_contrib_reference(z_ext.double(), src, rb, nb,
                                           accum_dtype=torch.float64)
    twin = ell_spmv.ell_contrib_reference(z_ext, src, rb, nb,
                                          accum_dtype=accum)
    torch.cuda.synchronize()
    _check(torch.equal(a, b), f"{label}: two launches differ")
    scale = max(float(exact.abs().max()), 1e-300)
    err = float((a.double() - exact).abs().max())
    twin_err = float((twin.double() - exact).abs().max())
    k_vs_twin = float((a.double() - twin.double()).abs().max())
    _check(err / scale <= tol,
           f"{label}: normalised max error {err / scale:.3e} > {tol:g}")
    print(f"K1 {label}: vs exact sums max abs err {err:.3e}, normalised "
          f"{err / scale:.3e} (<= {tol:g}); twin vs exact {twin_err / scale:.3e}"
          f"; K1 vs twin {k_vs_twin / scale:.3e}; repeat bit-identical")
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


def kernel_checks(engine):
    """Phase 4: K1 against its twin and timings; returns the K1 record."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine
    from pagerank_tpu_torch.ops import ell_spmv
    from pagerank_tpu_torch.ops.ell import segment_plan

    # -- at the main path's own shapes (f32, then f64 on the same slots)
    z_ext, src, rb, nb, plan = engine.contrib_inputs()
    f32 = torch.float32
    max_err = _k1_compare(z_ext, src, rb, nb, plan, f32, 1e-5,
                          "main-path f32/f32")
    _k1_compare(z_ext.double(), src, rb, nb, plan, torch.float64, 1e-12,
                "main-path f64/f64")

    # -- the adversarial pack, in every dtype pair the kernel has
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
    _k1_compare(za, sa, ra, na, pa, f32, 1e-5, "adversarial f32/f32")
    _k1_compare(za, sa, ra, na, pa, torch.float64, 1e-6,
                "adversarial f32/f64")
    _k1_compare(za.double(), sa, ra, na, pa, torch.float64, 1e-12,
                "adversarial f64/f64")

    # -- times at the main path's shapes (f32/f32, as the main path runs)
    def k1():
        ell_spmv.ell_contrib(z_ext, src, rb, nb, accum_dtype=f32, plan=plan)

    def twin():
        ell_spmv.ell_contrib_reference(z_ext, src, rb, nb, accum_dtype=f32)

    n_state = z_ext.shape[0] - 8
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
    plain_ms = _median_ms(twin, 20)
    library_ms = _median_ms(library, 20)
    rows_n = src.shape[0]
    item = z_ext.element_size()
    bytes_moved = (rows_n * 128 * 4 + n_state * item + nb * 128 * item
                   + plan.seg_row_start.nbytes + plan.block_seg_start.nbytes)
    bound_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    print(f"K1 timing at main-path shapes ({rows_n} rows x 128, "
          f"{plan.num_segments} segments, {nb} blocks): {ms:.4f} ms, twin "
          f"{plain_ms:.4f} ms, torch.sparse.mm {library_ms:.4f} ms, byte "
          f"bound {bound_ms:.4f} ms ({bytes_moved} B at 3.35 TB/s; "
          f"{bound_ms / ms:.1%} of bound)")
    return {
        "name": "ell_contrib", "route": "cuda",
        "source": "pagerank_tpu_torch/csrc/ell_contrib.cu",
        "replaces": "pagerank_tpu/ops/pallas_spmv.py:98",
        "checked": True, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": library_ms,
    }


def step_breakdown(engine, kernel="K1", passes=("segment_partials",
                                                 "block_sums"), steps=10):
    """Where a step's time goes, on a path's engine: the host wall per
    step of ``steps`` unprofiled steps, then the device time per kernel
    over as many steps under torch.profiler — the kernel's two
    ``passes`` apart, the ``index_add_`` kernels of the pair expansion
    (partitioned form), the step's other (elementwise) kernels — and the
    device's idle share of the unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")) != "DeviceType.CUDA":
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us / 1e3 / steps
    # A pass name not preceded by a letter or "_" (demangled "::name",
    # mangled "16name"): K1's segment_partials must not match K2's
    # pair_segment_partials.
    def named(k, p):
        return re.search(rf"(?<![A-Za-z_]){p}", k) is not None

    def part(pred):
        return sum(v for k, v in per_kernel.items() if pred(k))

    def is_pass(k):
        return any(named(k, p) for p in passes)

    p1 = part(lambda k: named(k, passes[0]))
    p2 = part(lambda k: named(k, passes[1]))
    expand = part(lambda k: not is_pass(k) and "index" in k.lower())
    busy = sum(per_kernel.values())
    other = busy - p1 - p2 - expand
    top = sorted(((v, k) for k, v in per_kernel.items() if not is_pass(k)),
                 reverse=True)[:6]
    print(f"{kernel} step breakdown over {steps} steps: wall {wall_ms:.4f} "
          f"ms/step; device busy {busy:.4f} ms/step = {kernel} pass 1 "
          f"{p1:.4f} + {kernel} pass 2 {p2:.4f} + index_add_ {expand:.4f} + "
          f"other kernels {other:.4f}; device idle "
          f"{1 - busy / wall_ms:.1%} of the wall")
    for v, k in top:
        print(f"  other kernel {v:.4f} ms/step: {k[:100]}")
    _check(p1 > 0 and p2 > 0,
           f"the profiled steps show no {kernel} device time")
    return {"wall_ms": wall_ms, "busy_ms": busy, "pass1_ms": p1,
            "pass2_ms": p2, "index_add_ms": expand, "other_ms": other}


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
        k1, k2 = _read_counts()
        label = f"partitioned {stream or 'f32'}"
        _check(k2 == ITERS == eng.iteration and k1 == 0,
               f"{label}: ell_contrib_partitioned launched {k2} times "
               f"(ell_contrib {k1}) in {eng.iteration} steps")
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


def _k2_compare(inputs, label, tol=1e-5):
    """K2 vs its twin's exact (f64) sums of the same widened window
    values, and bit-identity on repeat. Returns K2's max abs error."""
    import torch

    from pagerank_tpu_torch.ops import ell_spmv_partitioned as k2

    zw, slots, rp, pp, npairs, plan = inputs
    a = k2.ell_contrib_partitioned(zw, slots, rp, pp, npairs, plan=plan)
    b = k2.ell_contrib_partitioned(zw, slots, rp, pp, npairs, plan=plan)
    exact = k2.ell_contrib_partitioned_reference(zw.double(), slots, rp, pp,
                                                 npairs)
    twin = k2.ell_contrib_partitioned_reference(zw, slots, rp, pp, npairs)
    torch.cuda.synchronize()
    _check(torch.equal(a, b), f"K2 {label}: two launches differ")
    scale = max(float(exact.abs().max()), 1e-300)
    err = float((a.double() - exact).abs().max())
    twin_err = float((twin.double() - exact).abs().max())
    _check(err / scale <= tol,
           f"K2 {label}: normalised max error {err / scale:.3e} > {tol:g}")
    print(f"K2 {label}: vs exact sums max abs err {err:.3e}, normalised "
          f"{err / scale:.3e} (<= {tol:g}); twin vs exact "
          f"{twin_err / scale:.3e}; repeat bit-identical")
    return err


def adversarial_partitioned():
    """Inputs of K2 on a pack with deep hub pairs (the hub's in-edges
    cut over every partition), empty partitions (isolated vertices
    relabeled last) and appended all-sentinel rows."""
    import numpy as np
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine, build_graph
    from pagerank_tpu_torch.ops import ell_spmv
    from pagerank_tpu_torch.ops.ell import segment_plan
    from pagerank_tpu_torch.ops.spmv import pack_words24

    rng = np.random.default_rng(5)
    n, live = 60000, 40000  # ids >= 40000 are isolated
    src = np.concatenate([np.arange(1, live), rng.integers(0, live, 60000)])
    dst = np.concatenate([np.zeros(live - 1, np.int64),
                          rng.integers(0, live // 4, 60000)])
    g = build_graph(src, dst, n=n)
    eng = TorchEngine(PageRankConfig(partition_span=4096),
                      device="cuda").build(g)
    eng.set_ranks(rng.random(n).astype(np.float32))
    zw, slots, rp, pp, npairs, _ = eng.contrib_inputs()
    # 100 rows of sentinels only, appended to the last pair.
    sent = torch.full((1, 128), eng.layout_info()["partition_span"],
                      dtype=torch.int32, device=zw.device)
    slots = torch.cat([slots, pack_words24(sent).expand(100, -1)]).contiguous()
    rp = torch.cat([rp, torch.full((100,), npairs - 1, dtype=torch.int32,
                                   device=rp.device)])
    plan = ell_spmv.plan_to(segment_plan(rp.cpu().numpy(), npairs), zw.device)
    segs = torch.diff(plan.block_seg_start)
    part_rows = torch.bincount(pp[rp.long()].long(), minlength=zw.shape[0])
    _check(int(segs.max()) >= 50 and int((part_rows == 0).sum()) > 0,
           "adversarial partitioned pack lacks a deep pair or an empty "
           "partition")
    return zw, slots, rp, pp, npairs, plan


def _pair_csr(zw, slots, rp, pp, npairs, psz):
    """The pair-row x windowed-z matrix of K2's inputs as a CSR tensor:
    row pair*128 + lane, column part*W + word, one 1 per real slot."""
    import torch

    from pagerank_tpu_torch.ops.spmv import unpack_words24

    words = unpack_words24(slots).long()
    mask = words != psz
    lanes = torch.arange(128, device=slots.device)
    rows = (rp.long()[:, None] * 128 + lanes)[mask]
    ncols = zw.numel()
    cols = (pp.long()[rp.long()][:, None] * zw.shape[1] + words)[mask]
    del words, mask
    key, _ = torch.sort(rows * ncols + cols)
    rows, cols = key // ncols, key % ncols
    del key
    crow = torch.zeros(npairs * 128 + 1, dtype=torch.long,
                       device=slots.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=npairs * 128), 0)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            crow, cols, torch.ones(cols.shape[0], dtype=torch.float32,
                                   device=slots.device),
            size=(npairs * 128, ncols))


def k2_checks(eng32, eng16):
    """Phase 6: K2 against its twin, its timings and the expansion's;
    returns the K2 record."""
    import torch

    from pagerank_tpu_torch.ops import ell_spmv_partitioned as k2
    from pagerank_tpu_torch.ops import spmv

    inputs = eng32.contrib_inputs()
    zw, slots, rp, pp, npairs, plan = inputs
    max_err = _k2_compare(inputs, "path f32 windows, words24")
    int32 = (zw, spmv.unpack_words24(slots).contiguous()) + inputs[2:]
    _k2_compare(int32, "path f32 windows, int32 words")
    in16 = eng16.contrib_inputs()
    _k2_compare(in16, "path bf16 windows, words24")
    _k2_compare((in16[0],) + int32[1:], "path bf16 windows, int32 words")
    adv = adversarial_partitioned()
    _k2_compare(adv, "adversarial f32 windows, words24")
    _k2_compare((adv[0].to(torch.bfloat16),) + adv[1:],
                "adversarial bf16 windows, words24")

    def kernel(args):
        return lambda: k2.ell_contrib_partitioned(*args[:5], plan=args[5])

    def twin():
        k2.ell_contrib_partitioned_reference(*inputs[:5])

    a_t = _pair_csr(zw, slots, rp, pp, npairs,
                    eng32.layout_info()["partition_span"])
    zcol = zw.reshape(-1, 1)

    def library():
        torch.sparse.mm(a_t, zcol)

    lib_out = torch.sparse.mm(a_t, zcol)[:, 0]
    k_out = kernel(inputs)()
    lib_err = float((lib_out - k_out).abs().max()
                    / max(float(k_out.abs().max()), 1e-300))
    _check(lib_err <= 1e-5, f"torch.sparse.mm disagrees with K2: {lib_err}")

    def expand():
        eng32.expand_pairs(k_out)

    ms = _median_ms(kernel(inputs), 30)
    ms_int32 = _median_ms(kernel(int32), 30)
    ms_bf16 = _median_ms(kernel(in16), 30)
    plain_ms = _median_ms(twin, 20)
    library_ms = _median_ms(library, 20)
    expand_ms = _median_ms(expand, 30)
    rows = slots.shape[0]
    plan_bytes = sum(t.nbytes for t in (plan.seg_row_start, plan.seg_block,
                                        plan.block_seg_start, pp))
    bytes_moved = (slots.nbytes + zw.nbytes + npairs * 128 * 4 + plan_bytes)
    bound_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    bf16_bytes = slots.nbytes + in16[0].nbytes + npairs * 128 * 4 + plan_bytes
    print(f"K2 timing at path shapes ({rows} rows x 384 B, {zw.shape[0]} "
          f"windows of {zw.shape[1]}, {plan.num_segments} segments, {npairs} "
          f"pairs): {ms:.4f} ms (f32 windows, words24), {ms_int32:.4f} ms "
          f"(int32 words), {ms_bf16:.4f} ms (bf16 windows; byte bound "
          f"{bf16_bytes / H100_BYTES_PER_S * 1e3:.4f} ms); twin "
          f"{plain_ms:.4f} ms, torch.sparse.mm {library_ms:.4f} ms, byte "
          f"bound {bound_ms:.4f} ms ({bytes_moved} B at 3.35 TB/s; "
          f"{bound_ms / ms:.1%} of bound); pair -> block expansion "
          f"{expand_ms:.4f} ms ({zw.shape[0]} partitions)")
    return {
        "name": "ell_contrib_partitioned", "route": "cuda",
        "source": "pagerank_tpu_torch/csrc/ell_contrib_partitioned.cu",
        "replaces": "pagerank_tpu/ops/pallas_spmv.py:241",
        "checked": True, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": library_ms,
    }


def resume_determinism(scale, tmp, extra=()):
    """Phase 7: 6 iterations + resume to 10 == 10 uninterrupted, through
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
        step_breakdown(summary["engine"])
        graph = summary["graph"]
        flat_rows = summary["engine"].layout_info()["num_rows"]
        del summary
        eng32, eng16, part_report = partitioned_path(graph, oracle, flat_rows)
        del graph, oracle
        k2 = k2_checks(eng32, eng16)
        k2["launches"] = part_report["f32"]["launches"]
        for eng, label in ((eng32, "K2"), (eng16, "K2 (bf16 windows)")):
            step_breakdown(eng, label, ("pair_segment_partials", "pair_sums"))
        del eng32, eng16
        resume_determinism(args.resume_scale, tmp)
        form = resume_determinism(args.resume_scale, tmp,
                                  ("--partition-span", "-1"))
        _check(form == "pallas_partitioned",
               f"--partition-span -1 at rmat:{args.resume_scale} ran {form}")
    print(f"chip smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
