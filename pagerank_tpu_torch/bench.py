"""Benchmark: PageRank power-iteration throughput of the port on the card.

Port of ``bench.py`` (the JAX system's bench CLI, at the repo root): the
same modes, flags, defaults and one-JSON-line output, on ``cuda`` unless
``--device cpu`` is given.

    python -m pagerank_tpu_torch.bench [--device cuda|cpu] ...

Prints ONE JSON line. Default (couple) mode measures speed and accuracy
together (BASELINE.md config 4 couples them: 50 iterations over
Twitter-2010's 1.47e9 edges in under 60 s, ranks within 1e-6 L1):

  {"metric": "edges_per_sec_per_chip",
   "value": <f64/f64 accuracy-grade rate>, "unit": "edges/s/chip",
   "vs_baseline": <rate / job-target rate>,
   "fast_f32": {"value": ..., "vs_baseline": ..., "costs": ...,
                "layout": ...},
   "partitioned_f32": {... the partition-centric layout leg (K2) ...},
   "fast_bf16": {... the same with bf16 z windows ...},
   "accuracy": {"config": "f64", "scale": 20, "iters": 50,
                "normalized_l1_vs_f64_oracle": ...,
                "mass_normalized_l1": ...,
                "fast_bf16": {"normalized_l1_vs_f64_oracle": ...}}}

What differs from the JAX tool:

- The headline is f64 rank storage with f64 sums through K1's
  ``ell_contrib_f64_f64`` entry (the card sums f64 natively; the JAX
  pair-packed f64 is a TPU workaround): its layout says ``pair: false``
  and its accuracy config is ``"f64"``.
- The couple has no ``pallas_partitioned`` leg: every ELL leg of the
  port already runs a hand kernel, so that leg would repeat
  ``partitioned_f32``. ``--multichip`` keeps the key for the
  edge-sharded K2 over the group.
- ``vs_baseline`` divides by the job target itself (50 x 1.47e9 edges in
  60 s) shared by the cards the leg used.
- ``costs`` is the kernel's analytic byte model (``obs/costs.py``,
  ``TorchEngine.cost_reports``) over the measured step, with the leg's
  ``torch.cuda.max_memory_allocated`` as ``peak_bytes``; ``lowering`` is
  null (the port lowers no HLO). Each rate leg's ``layout`` records the
  launches it made of K1, K2 and K1w and its steps, one launch a step:
  warm-up, timed steps, the SDC leg's and a multichip leg's attribution
  steps. ``--ppr-serve``'s records the daemon's K1w launches, its
  batches and its steps (the warm-up's and each batch's iterations).
- The ``--build-only`` stages: ``autotune_s`` is 0.0 (nothing is tuned
  at build) and ``compile_s`` the seconds ``kernels/build.py`` spent in
  ``nvcc`` inside the call.
- ``--multichip`` runs its sharded legs over a process group that
  ``parallel/distributed.spawn_group`` starts: ``--multichip-devices``
  ranks, NCCL with one rank a card where the host has that many cards
  (and ``--device`` names no card index), otherwise gloo ranks sharing
  the one device. The single-device leg and the f64 oracle run in this
  process.
- No ``--lane-group``, ``--stripe-size``, ``--dump-hlo`` or compile cache.

Workload: R-MAT (Graph500 parameters) generated and packed on the
device (``ops/device_build.py``) unless ``--host-build``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from pagerank_tpu_torch.exitcodes import ExitCode

#: The job target of BASELINE.md config 4: 50 iterations over
#: Twitter-2010's 1.47e9 edges in 60 s, in edges/s. A leg's
#: ``vs_baseline`` is its per-card rate over this rate shared by the cards
#: it used.
JOB_EDGES_PER_SEC = 1.47e9 * 50 / 60

# Version of the bench's own JSON schemas (couple, single, --build-only,
# --multichip, --ppr-serve): 2 stamps the field and the workload geometry
# on every emit, as the JAX tool does.
BENCH_SCHEMA_VERSION = 2

# The per-stage device-build breakdown (--build-only; the acceptance
# script's build smoke D checks every key). Stage walls are fenced on the
# device; compile_s counts nvcc's seconds inside the call.
BUILD_STAGE_KEYS = ("gen_s", "relabel_s", "sort_s", "slots_s", "scatter_s",
                    "autotune_s", "engine_s", "compile_s")

_MODULE = "pagerank_tpu_torch.bench"


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launch_counts() -> dict:
    """The K1, K2 and K1w wrappers' launch counts in this process."""
    from pagerank_tpu_torch.ops import ell_spmm, ell_spmv, ell_spmv_partitioned

    return {"K1": ell_spmv.launches, "K2": ell_spmv_partitioned.launches,
            "K1w": ell_spmm.launches}


def _launches_since(before: dict) -> dict:
    now = _launch_counts()
    return {k: now[k] - before[k] for k in now}


def _card_index(dev) -> int:
    """The card of a cuda device (an unindexed one is the current card),
    CUDA initialized: the allocator's statistics exist only after."""
    import torch

    torch.cuda.init()
    return torch.cuda.current_device() if dev.index is None else dev.index


def _reset_peak(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(_card_index(dev))


def _peak_bytes(dev):
    import torch

    if dev.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(_card_index(dev)))


def _vs_baseline(eps_chip: float, chips: int) -> float:
    return eps_chip / (JOB_EDGES_PER_SEC / max(1, chips))


def _device_graph(scale, edge_factor, stripe, seed=0, timings=None,
                  device=None):
    """THE device graph generation + pack, shared by run_rate's legs and
    run_build's breakdown, so the measured breakdown is the build the
    rate legs run. ``timings`` engages ``ops/device_build``'s per-stage
    fences (plus the generator's fence here); None keeps the build
    queued with no sync. ``stripe`` is the partition span (0: the one
    stripe the flat form reads)."""
    from pagerank_tpu_torch.ops import device_build as db

    t0 = time.perf_counter()
    edges = list(db.rmat_edges_device(scale, edge_factor, seed=seed,
                                      device=device))
    dev = edges[0].device
    if timings is not None:
        _sync(dev)
        timings["gen_s"] = time.perf_counter() - t0
    return db.build_ell_device(edges.pop(0), edges.pop(0), n=1 << scale,
                               stripe_size=stripe, with_weights=False,
                               timings=timings, device=dev)


def run_build(scale, edge_factor=16, dtype="float32", accum_dtype=None,
              seed=0, label=None, device=None):
    """One device build of the bench R-MAT geometry with the per-stage
    breakdown (BUILD_STAGE_KEYS): generation and the device build's four
    stages fenced by _device_graph's timing mode, then the engine's
    placement (planes, plans, the kernel bound) fenced by the engine.
    Importable: the acceptance script's build smoke calls it. Returns
    {"build_s", "stages", "num_edges"}."""
    from pagerank_tpu_torch import PageRankConfig, TorchEngine
    from pagerank_tpu_torch.engines.torch_engine import resolve_device
    from pagerank_tpu_torch.kernels import build as kernel_build

    dev = resolve_device(device)
    accum_dtype = accum_dtype or dtype
    cfg = PageRankConfig(num_iters=1, dtype=dtype,
                         accum_dtype=accum_dtype).validate()
    # Start EMPTY: every key but the two constants must be written by a
    # real fence or timer below, so a dropped stage fence shows as a
    # missing key in the acceptance gate instead of a pre-seeded 0.0.
    stages = {}
    c0 = kernel_build.build_seconds
    t_total = time.perf_counter()
    dg = _device_graph(scale, edge_factor, 0, seed=seed, timings=stages,
                       device=dev)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, device=dev).build_device(dg)
    engine.fence()
    stages["engine_s"] = time.perf_counter() - t0
    stages["autotune_s"] = 0.0  # the port tunes nothing at build
    stages["compile_s"] = kernel_build.build_seconds - c0
    build_s = time.perf_counter() - t_total
    num_edges = int(dg.num_edges)
    del engine, dg
    if label is None:
        label = dtype + (f"/{accum_dtype}" if accum_dtype != dtype else "")
    print(
        f"build[{label}]: scale {scale}: {build_s:.1f}s total — "
        + " ".join(f"{k[:-2]} {stages[k]:.1f}" for k in BUILD_STAGE_KEYS
                   if k in stages),
        file=sys.stderr,
    )
    return {"build_s": build_s, "stages": stages, "num_edges": num_edges}


def _fallback_span(n: int) -> int:
    """THE one spelling of the small-graph fallback partition span the
    bench legs use when the engine's auto rule says 'not worth it': a
    quarter of the padded range, so the partitioned and bf16 legs always
    run and record what they ran."""
    n_padded = -(-n // 128) * 128
    return max(128, (n_padded // 4) & ~127)


def _env_fingerprint(dev):
    """The environment fingerprint of every bench record
    (``obs/report.environment_fingerprint``), naming the device the run
    used: a ``--device cpu`` run on a card's host is a CPU record."""
    from pagerank_tpu_torch.obs.report import environment_fingerprint

    env = environment_fingerprint()
    if dev.type == "cpu":
        env.update(backend="cpu", device_kind="cpu", device_count=1,
                   power_limit=None)
    return env


def _emit(out: dict, args) -> dict:
    """THE one output path: stamp the schema version, print the ONE JSON
    line, and write the canonical artifacts: ``--out`` saves the record
    itself (strict JSON), ``--history`` normalizes it into the
    append-only perf ledger (``obs/history.py``)."""
    from pagerank_tpu_torch.obs.report import _json_safe

    out["schema_version"] = BENCH_SCHEMA_VERSION
    line = json.dumps(_json_safe(out), allow_nan=False)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
        print(f"wrote bench record to {args.out}", file=sys.stderr)
    if args.history:
        from pagerank_tpu_torch.obs import history as history_mod

        source = os.path.basename(args.out) if args.out else "bench"
        rec = history_mod.normalize_result(json.loads(line), source=source)
        added = history_mod.append_record(args.history, rec)
        print(("appended record to" if added
               else "record already in (content-hash dedupe)")
              + f" perf ledger {args.history}", file=sys.stderr)
    return out


def run_rate(args, dtype: str, accum_dtype: str, build_only: bool = False,
             partition_span: int = 0, stream_dtype: str = "",
             force_span_fallback: bool = False, kernel: str = ""):
    """One throughput measurement: build (on the device by default), then
    ``warmup`` and ``iters`` calls of ``TorchEngine._device_step``, each
    run closed by ``fence()``. Returns the result dict.

    ``partition_span`` engages the partition-centric layout (-1 = the
    engine's auto rule); ``force_span_fallback`` makes a -1 that resolves
    to "off" run on a quarter-range fallback span instead (the couple's
    partitioned legs always run and record what they ran).
    ``stream_dtype`` streams bf16 z windows (the ``fast_bf16`` leg).
    ``build_only``: build, time it, free, and return only ``build_s``
    (the couple's last, warm rebuild of the headline config)."""
    from pagerank_tpu_torch import PageRankConfig, TorchEngine, build_graph
    from pagerank_tpu_torch.engines.torch_engine import resolve_device
    from pagerank_tpu_torch.obs import graph_profile
    from pagerank_tpu_torch.ops.device_build import plan_partition_span

    dev = resolve_device(args.device)
    host_build = args.host_build
    kernel = kernel or args.kernel
    if kernel == "coo" and not host_build:
        print("--kernel coo requires the host ingest path; using "
              "--host-build", file=sys.stderr)
        host_build = True
    n = 1 << args.scale
    cfg = PageRankConfig(num_iters=args.iters, dtype=dtype,
                         accum_dtype=accum_dtype, kernel=kernel).validate()
    # The raw edge count: the auto rule is a density threshold, dedup
    # loss is noise (as the CLI's device build resolves it).
    raw = args.edge_factor << args.scale
    part = plan_partition_span(cfg, n, raw, partition_span)
    if partition_span == -1 and not part and force_span_fallback:
        part = plan_partition_span(cfg, n, raw, _fallback_span(n))
    cfg = cfg.replace(partition_span=part,
                      stream_dtype=stream_dtype if part else "").validate()
    if stream_dtype and not part:
        print("stream_dtype needs the partitioned layout; leg runs "
              "without the narrowed stream", file=sys.stderr)

    def do_build():
        if host_build:
            from pagerank_tpu_torch.utils.synth import rmat_edges

            src, dst = rmat_edges(args.scale, args.edge_factor, seed=0)
            graph = build_graph(src, dst, n=n)
            return (TorchEngine(cfg, device=dev).build(graph),
                    graph.num_edges, graph)
        dg = _device_graph(args.scale, args.edge_factor, part, device=dev)
        return (TorchEngine(cfg, device=dev).build_device(dg),
                int(dg.num_edges), None)

    # Rate legs arm the graph profiler, so every leg carries its `graph`
    # block (a device build computes the profile inside the build, a host
    # leg profiles in numpy below). --build-only stays disarmed: its
    # build_s must measure the bare pipeline.
    if not build_only:
        graph_profile.reset()
        graph_profile.arm()
    _reset_peak(dev)
    t0 = time.perf_counter()
    try:
        engine, num_edges, host_graph = do_build()
        engine.fence()
    finally:
        if not build_only:
            graph_profile.disarm()
    t_build = time.perf_counter() - t0
    label = dtype + (f"+{accum_dtype}-accum" if accum_dtype != dtype else "")
    if part:
        label += f"+span{part}"
        if stream_dtype:
            label += f"+{stream_dtype}"
    if kernel == "coo":
        label += "+coo"
    if build_only:
        del engine
        print(f"build[{label}]: warm rebuild {t_build:.1f}s",
              file=sys.stderr)
        return {"build_s": t_build}
    print(
        f"graph[{label}]: scale {args.scale}: {n:,} vertices, "
        f"{num_edges:,} unique edges "
        f"({'host' if host_build else 'device'} build {t_build:.1f}s)",
        file=sys.stderr,
    )
    chips = len(engine.device_ids())
    c0 = _launch_counts()
    for _ in range(args.warmup):
        engine._device_step()
    engine.fence()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        engine._device_step()
    engine.fence()
    dt = time.perf_counter() - t0

    eps_chip = num_edges * args.iters / dt / chips
    print(
        f"rate[{label}]: {args.iters} iters in {dt:.3f}s on {chips} "
        f"device(s): {dt / args.iters * 1e3:.3f} ms/iter, "
        f"{eps_chip:.4g} edges/s/chip",
        file=sys.stderr,
    )
    costs = _leg_costs(engine, dt / args.iters, num_edges,
                       _peak_bytes(dev))
    layout = engine.layout_info()
    graph_block = _leg_graph_block(engine, host_graph, layout)
    # SDC detection overhead (sdc.py): with --sdc-check-every, time the
    # CHECKED step against the plain loop just measured. None when
    # disarmed.
    sdc_overhead, sdc_steps = None, 0
    if getattr(args, "sdc_check_every", 0):
        sdc_overhead, sdc_steps = _sdc_overhead_pct(engine, args.iters,
                                                    dt / args.iters)
        print(f"sdc[{label}]: checked-step overhead "
              f"{sdc_overhead:.1f}% per checked iteration",
              file=sys.stderr)
    layout.update(pair=False, launches=_launches_since(c0),
                  steps=args.warmup + args.iters + sdc_steps)
    del engine  # free the card before the next leg builds
    return {
        "sdc_check_overhead_pct": sdc_overhead,
        "value": eps_chip,
        "vs_baseline": _vs_baseline(eps_chip, chips),
        "build_s": t_build,
        # The kernel's byte model over the measured step
        # (obs/costs.py): bytes/edge and the achieved share of the card's
        # memory rate, with the leg's peak device memory.
        "costs": costs,
        # The resolved layout: the form, its geometry, the kernel that
        # ran, and this leg's launches of K1/K2/K1w.
        "layout": layout,
        "lowering": None,  # the port lowers no HLO
        # Data-plane block (obs/graph_profile.py): the structural profile
        # and the skew prediction of this leg's graph and layout.
        "graph": graph_block,
    }


def _sdc_overhead_pct(engine, iters: int, plain_s_per_iter: float):
    """Per-checked-iteration SDC detection overhead: ``iters`` full
    checked boundaries (the boundary-state check, the checked step with
    its one fetch, and the host-side reconciliation: what
    ``SdcGuard.checked_step`` pays a boundary) against the plain loop's
    wall, as percent extra; and the checked steps it ran (each one
    kernel launch). The engine's state is retained and restored, so the
    measured solve is untouched."""
    from pagerank_tpu_torch import sdc as sdc_mod

    cfg = engine.config
    ne = int(engine.graph.num_edges) if engine.graph is not None else None

    def boundary():
        pre = engine.sdc_state_values()
        _info, chk = engine.step_sdc()
        sdc_mod.evaluate_check(
            pre, chk, damping=cfg.damping, semantics=cfg.semantics,
            n=int(engine.graph.n), num_edges=ne, eps=engine._ledger_eps(),
        )

    token = engine.retain_state()
    steps = max(1, iters)
    try:
        boundary()  # first launch outside the timing
        engine.restore_state(token)
        t0 = time.perf_counter()
        for _ in range(steps):
            boundary()
        checked = (time.perf_counter() - t0) / steps
    finally:
        engine.restore_state(token)
    return (max(0.0, (checked - plain_s_per_iter)
                / max(plain_s_per_iter, 1e-12) * 100.0), steps + 1)


def _leg_graph_block(engine, host_graph, layout, ndev=1):
    """One rate leg's ``graph`` block: the profile the device build
    published (or a numpy profile of the host graph at the leg's resolved
    layout) plus the load prediction for ``ndev`` devices. None when
    neither source exists."""
    from pagerank_tpu_torch.obs import graph_profile
    from pagerank_tpu_torch.parallel import comms

    prof = graph_profile.get_profile()
    if prof is None and host_graph is not None:
        group, span = graph_profile.layout_profile_geometry(layout)
        prof = graph_profile.profile_graph(host_graph, group=group,
                                           partition_span=span)
        graph_profile.publish(prof)
    if prof is None:
        return None
    pred = comms.predict_from_profile(prof, ndev)
    comms.publish_prediction(pred)
    prof.prediction = pred
    return {"profile": prof.summary(), "prediction": pred}


def _leg_costs(engine, seconds_per_iter, num_edges, peak_bytes=None):
    """One rate leg's cost block: the ledger reset (a second leg must not
    inherit the first's entries), the engine's kernel model recorded,
    the measured per-iteration wall attached to the whole-iteration
    'step' form, and the leg's peak device memory beside it."""
    from pagerank_tpu_torch.obs import costs as obs_costs

    obs_costs.reset()
    for rep in engine.cost_reports().values():
        obs_costs.record_report(rep)
    step = obs_costs.attach_measurement("step", seconds_per_iter,
                                        num_edges=num_edges)
    if step is not None and step.bytes_per_edge is not None:
        line = f"cost[step]: {step.bytes_per_edge:.1f} B/edge"
        if step.roofline_fraction is not None:
            line += f", {step.roofline_fraction:.1%} of the memory rate"
        print(line, file=sys.stderr)
    snap = obs_costs.ledger_snapshot()
    for c in snap.values():
        c["peak_bytes"] = peak_bytes
    return snap


def run_accuracy(scale: int = 20, iters: int = 50, with_bf16: bool = False,
                 bf16_partition_span: int = -1, device=None):
    """Standing accuracy field: the accuracy-grade config (f64 ranks, f64
    sums) against the float64 CPU oracle on the SAME host-built R-MAT
    graph, full-run L1; ``with_bf16`` adds the bf16-window leg's L1
    against the same oracle. Two numbers each: the raw N-scaled L1 and
    the mass-normalized L1 (they diverge only through a global-scale
    error)."""
    from pagerank_tpu_torch import (PageRankConfig, ReferenceCpuEngine,
                                    TorchEngine, build_graph)
    from pagerank_tpu_torch.engines.torch_engine import resolve_device
    from pagerank_tpu_torch.ops.device_build import plan_partition_span
    from pagerank_tpu_torch.utils.metrics import oracle_l1
    from pagerank_tpu_torch.utils.synth import rmat_edges

    dev = resolve_device(device)
    t0 = time.perf_counter()
    src, dst = rmat_edges(scale, 16, seed=3)
    g = build_graph(src, dst, n=1 << scale)
    cfg = PageRankConfig(num_iters=iters, dtype="float64",
                         accum_dtype="float64")
    r_dev = TorchEngine(cfg, device=dev).build(g).run_fast()
    r_cpu = ReferenceCpuEngine(cfg).build(g).run()
    l1, norm, mass_norm = oracle_l1(r_dev, r_cpu)
    print(
        f"accuracy[f64]: scale-{scale}, {iters} iters: L1 vs f64 oracle "
        f"{l1:.3e} (normalized {norm:.3e}, mass-normalized "
        f"{mass_norm:.3e}) [{time.perf_counter() - t0:.1f}s]",
        file=sys.stderr,
    )
    out = {
        "config": "f64",
        "scale": scale,
        "iters": iters,
        "normalized_l1_vs_f64_oracle": norm,
        "mass_normalized_l1": mass_norm,
    }
    if with_bf16:
        # The fast_bf16 leg's accuracy bound: the same graph and
        # iteration count through the bf16-window partitioned form,
        # against the same f64 oracle.
        cfg_f = PageRankConfig(num_iters=iters)
        span = bf16_partition_span
        if span == -1:
            span = (plan_partition_span(cfg_f, g.n, g.num_edges, -1)
                    or plan_partition_span(cfg_f, g.n, g.num_edges,
                                           _fallback_span(g.n)))
        cfg_b = PageRankConfig(num_iters=iters, stream_dtype="bfloat16",
                               partition_span=span)
        r_b = TorchEngine(cfg_b, device=dev).build(g).run_fast()
        _l1b, norm_b, mass_b = oracle_l1(r_b, r_cpu)
        print(f"accuracy[fast_bf16]: scale-{scale}, {iters} iters: "
              f"normalized L1 vs f64 oracle {norm_b:.3e} "
              f"(mass-normalized {mass_b:.3e})", file=sys.stderr)
        out["fast_bf16"] = {"normalized_l1_vs_f64_oracle": norm_b,
                            "mass_normalized_l1": mass_b}
    return out


# -- the multichip benchmark -------------------------------------------------


def _mc_leg(graph, *, ndev, iters, warmup, halo, label, device,
            kernel="", partition_span=0, halo_async=False):
    """One multichip rate leg: a vertex-sharded f32 solve over ``ndev``
    devices through the dense or the sparse (halo) exchange; with
    ``kernel``/``partition_span``, the edge-sharded partitioned form (K2
    over each rank's share of the slot rows) instead. Over a group every
    rank runs it in step. Returns the leg dict: edges/s/chip, the cost,
    layout and comms blocks, the ``comms.bytes_exchanged`` counter's
    delta over the timed steps (the model is static, so it is iters x
    the model) and the ``attribution`` block (fenced exchange-only vs
    full-step timing, ``obs/devices.attribute_exchange``).

    ``halo_async``: the stale-boundary double-buffered exchange, its
    gate pinned open (``halo_async_min_gain=0``) so that the leg
    measures the async form at any geometry."""
    from pagerank_tpu_torch import PageRankConfig, TorchEngine
    from pagerank_tpu_torch.obs import devices as obs_devices
    from pagerank_tpu_torch.obs import graph_profile
    from pagerank_tpu_torch.obs import metrics as obs_metrics

    if kernel:
        cfg = PageRankConfig(
            num_iters=iters, num_devices=ndev, kernel=kernel,
            partition_span=partition_span,
        ).validate()
    else:
        async_kw = ({"halo_async": True, "halo_async_min_gain": 0.0}
                    if halo_async else {})
        cfg = PageRankConfig(
            num_iters=iters, num_devices=ndev, vertex_sharded=True,
            halo_exchange=halo, **async_kw,
        ).validate()
    _reset_peak(device)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, device=device).build(graph)
    engine.fence()
    t_build = time.perf_counter() - t0
    c0 = _launch_counts()
    for _ in range(warmup):
        engine._device_step()
    engine.fence()
    ctr = obs_metrics.counter("comms.bytes_exchanged")
    b0 = ctr.value
    t0 = time.perf_counter()
    for _ in range(iters):
        engine._device_step()
    engine.fence()
    dt = time.perf_counter() - t0
    # The stepwise callers feed the counter; the timed loop is this one.
    engine._note_comms(iters)
    # The delta is read BEFORE the attribution: its own timing steps
    # move bytes too, and the schema pins delta == iters x model.
    bytes_exchanged = int(ctr.value - b0)
    attr_iters, attr_warmup = max(2, min(iters, 10)), 1
    attribution = obs_devices.attribute_exchange(
        engine, iters=attr_iters, warmup=attr_warmup)
    launches = _launches_since(c0)
    # Its full steps (the exchange-only dispatches launch no kernel).
    attr_steps = attr_iters + attr_warmup if attribution else 0
    eps_chip = graph.num_edges * iters / dt / ndev
    line = (f"multichip[{label}]: {iters} iters on {ndev} device(s): "
            f"{dt / iters * 1e3:.3f} ms/iter, {eps_chip:.4g} edges/s/chip")
    if attribution and attribution.get("exchange_fraction") is not None:
        line += (
            f"; exchange {attribution['exchange_s'] * 1e3:.3f} ms "
            f"({attribution['exchange_fraction']:.0%} of step"
            + (f", {attribution['achieved_bytes_per_sec'] / 1e9:.2f} "
               f"GB/s achieved"
               if attribution.get("achieved_bytes_per_sec") else "")
            + ")")
    if engine.mesh is None or engine.mesh.rank == 0:
        print(line, file=sys.stderr)
    costs = _leg_costs(engine, dt / iters, graph.num_edges,
                       _peak_bytes(engine.device))
    # Each leg profiles at ITS layout geometry and predicts for ITS mesh.
    graph_profile.reset()
    layout = engine.layout_info()
    graph_block = _leg_graph_block(engine, graph, layout, ndev=ndev)
    layout.update(launches=launches, steps=warmup + iters + attr_steps)
    leg = {
        "value": eps_chip,
        "vs_baseline": _vs_baseline(eps_chip, ndev),
        "n_devices": ndev,
        "ms_per_iter": dt / iters * 1e3,
        "build_s": t_build,
        "costs": costs,
        "lowering": None,
        "graph": graph_block,
        "layout": layout,
        "comms": engine.comms_model(),
        "bytes_exchanged": bytes_exchanged,
        # None on the forms with no exchange-only program (the
        # edge-sharded partitioned form).
        "attribution": attribution,
    }
    del engine
    return leg


def _save_graph(graph, d: str) -> None:
    from pagerank_tpu_torch import jobs

    arrays, meta = jobs.graph_to_arrays(graph)
    os.makedirs(d, exist_ok=True)
    for k, a in arrays.items():
        np.save(os.path.join(d, f"{k}.npy"), a)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)


def _load_graph(d: str):
    from pagerank_tpu_torch import jobs

    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    arrays = {p[:-4]: np.load(os.path.join(d, p))
              for p in os.listdir(d) if p.endswith(".npy")}
    return jobs.graph_from_arrays(arrays, meta)


def _mc_rank(payload) -> int:
    """A rank of ``--multichip`` (``spawn_group``'s target): the sharded
    legs, the accuracy solve and the staleness sweep in step with the
    other ranks; each rank writes ``rank<r>.json`` (its legs, its
    device), rank 0 also the accuracy solve's ranks."""
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine
    from pagerank_tpu_torch.obs.report import _json_safe
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.parallel import mesh as mesh_lib

    rank, world = distributed.process_info()
    torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1) // world)))
    dev = torch.device(payload["device"])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    graph = _load_graph(os.path.join(payload["out"], "graph"))
    iters, warmup = payload["iters"], payload["warmup"]
    kw = dict(ndev=world, iters=iters, warmup=warmup, device=dev)
    legs = {
        "dense_exchange": _mc_leg(graph, halo=False,
                                  label="dense_exchange", **kw),
        "sparse_exchange": _mc_leg(graph, halo=True,
                                   label="sparse_exchange", **kw),
        "sparse_async": _mc_leg(graph, halo=True, halo_async=True,
                                label="sparse_async", **kw),
        # The edge-sharded K2 over the group (the JAX key: its hand-kernel
        # leg over the mesh).
        "pallas_partitioned": _mc_leg(
            graph, halo=False, label="pallas_partitioned", kernel="pallas",
            partition_span=payload["pspan"], **kw),
    }
    acc_dir = os.path.join(payload["out"], "graph_acc")
    g_acc = _load_graph(acc_dir) if os.path.isdir(acc_dir) else graph
    acc_iters = payload["acc_iters"]
    cfg_s = PageRankConfig(num_iters=acc_iters, num_devices=world,
                           vertex_sharded=True, halo_exchange=True)
    eng = TorchEngine(cfg_s, device=dev).build(g_acc)
    r_sparse = eng.run_fast()
    acc_cm = eng.comms_model()
    del eng
    # Convergence against staleness: iterations to tol at boundary lag 0
    # (the async plumbing with fresh reads: must match sync) and lag 1
    # (the overlapped schedule), textbook semantics (a contraction, so
    # there is a fixed point to converge to).
    sweep_tol, sweep_cap = 1e-6, 400
    sweep = {"tol": sweep_tol, "semantics": "textbook", "legs": {}}
    for name, akw in (
        ("sync", {}),
        ("async_lag0", {"halo_async": True, "stale_max_lag": 0,
                        "halo_async_min_gain": 0.0}),
        ("async_lag1", {"halo_async": True, "stale_max_lag": 1,
                        "halo_async_min_gain": 0.0}),
    ):
        cfg_w = PageRankConfig(
            num_iters=sweep_cap, num_devices=world, vertex_sharded=True,
            halo_exchange=True, semantics="textbook", **akw,
        ).validate()
        eng_w = TorchEngine(cfg_w, device=dev).build(g_acc)
        eng_w.run_fused_tol(tol=sweep_tol, num_iters=sweep_cap)
        sweep["legs"][name] = {"iters_to_tol": int(eng_w.iteration),
                               "converged": bool(eng_w.iteration
                                                 < sweep_cap)}
        del eng_w
    doc = {"legs": legs, "acc_comms": acc_cm, "sweep": sweep,
           "device_view": mesh_lib.device_view([dev])[0]}
    if rank == 0:
        np.save(os.path.join(payload["out"], "r_sparse.npy"), r_sparse)
    with open(os.path.join(payload["out"], f"rank{rank}.json"), "w") as f:
        json.dump(_json_safe(doc), f)
    return 0


def _group_plan(dev, world: int):
    """(backend, the device string a rank takes) of the multichip group:
    NCCL, one card a rank, where ``dev`` is a card without an index and
    the host has ``world`` cards; otherwise gloo ranks sharing ``dev``
    (its card, or the CPU)."""
    import torch

    if (dev.type == "cuda" and dev.index is None
            and torch.cuda.device_count() >= world):
        return "nccl", "cuda"
    if dev.type == "cuda":
        return "gloo", f"cuda:{dev.index or 0}"
    return "gloo", "cpu"


def run_multichip(args):
    """The multichip benchmark: ONE host-built R-MAT graph, its
    vertex-sharded f32 solve through the DENSE exchange (all_gather +
    reduce-scatter), the SPARSE boundary exchange and its async form,
    and the edge-sharded K2 form, over a group of
    ``--multichip-devices`` ranks, against a single-device leg of the
    same config for the scaling-efficiency figure. The accuracy leg
    (scale capped at ``--accuracy-scale`` with a floor of 18 above it)
    runs the sparse solve over the group against the f64 CPU oracle;
    the staleness sweep prices the async form's convergence."""
    from pagerank_tpu_torch import (PageRankConfig, ReferenceCpuEngine,
                                    TorchEngine, build_graph)
    from pagerank_tpu_torch.engines.torch_engine import resolve_device
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.utils.metrics import oracle_l1
    from pagerank_tpu_torch.utils.synth import rmat_edges

    dev = resolve_device(args.device)
    ndev = int(args.multichip_devices)
    if ndev < 1:
        raise ValueError(f"--multichip-devices must be >= 1, got {ndev}")
    backend, rank_dev = _group_plan(dev, ndev)
    t0 = time.perf_counter()
    src, dst = rmat_edges(args.scale, args.edge_factor, seed=0)
    graph = build_graph(src, dst, n=1 << args.scale)
    del src, dst
    print(f"multichip graph: scale {args.scale}: {graph.n:,} vertices, "
          f"{graph.num_edges:,} unique edges "
          f"({time.perf_counter() - t0:.1f}s host build); {ndev} {backend} "
          f"rank(s) on {rank_dev}", file=sys.stderr)
    single = _mc_leg(graph, ndev=1, iters=args.iters, warmup=args.warmup,
                     halo=False, label="single_chip", device=dev)
    n_padded = -(-graph.n // 128) * 128
    pspan = (TorchEngine.partition_span(n_padded, graph.num_edges)
             or _fallback_span(graph.n))
    acc_scale = (min(args.scale, max(18, args.accuracy_scale))
                 if args.scale > 18 else args.scale)
    acc_iters = min(args.iters, 20)
    work = tempfile.mkdtemp(prefix="pagerank_multichip_")
    try:
        _save_graph(graph, os.path.join(work, "graph"))
        if acc_scale == args.scale:
            g_acc = graph
        else:
            s2, d2 = rmat_edges(acc_scale, args.edge_factor, seed=3)
            g_acc = build_graph(s2, d2, n=1 << acc_scale)
            del s2, d2
            _save_graph(g_acc, os.path.join(work, "graph_acc"))
        if dev.type == "cuda":
            import torch

            torch.cuda.empty_cache()
        payload = {"out": work, "device": rank_dev, "iters": args.iters,
                   "warmup": args.warmup, "pspan": pspan,
                   "acc_iters": acc_iters}
        codes = distributed.spawn_group(
            f"{_MODULE}:_mc_rank", ndev, payload, work, backend=backend,
            timeout_s=300.0)
        if list(codes) != [0] * ndev:
            raise RuntimeError(f"multichip group failed: exit codes "
                               f"{list(codes)}")
        ranks = []
        for r in range(ndev):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        r_sparse = np.load(os.path.join(work, "r_sparse.npy"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    legs = ranks[0]["legs"]
    dense, sparse = legs["dense_exchange"], legs["sparse_exchange"]
    sparse_async, pallas = legs["sparse_async"], legs["pallas_partitioned"]
    # Overlap verdict: is the async leg's full-step wall below the sync
    # leg's compute + exchange sum (what the synchronous schedule pays a
    # step)? Both from the fenced attribution blocks of this run.
    overlap = None
    a_sync, a_async = sparse.get("attribution"), \
        sparse_async.get("attribution")
    if a_sync and a_async:
        sync_sum = a_sync["compute_s"] + a_sync["exchange_s"]
        overlap = {
            "sync_compute_plus_exchange_s": sync_sum,
            "async_step_s": a_async["step_s"],
            "async_below_sync_sum": bool(a_async["step_s"] < sync_sum),
            "gain": (1.0 - a_async["step_s"] / sync_sum
                     if sync_sum > 0 else None),
        }
        print(f"multichip[overlap]: async step "
              f"{a_async['step_s'] * 1e3:.3f} ms vs sync compute+exchange "
              f"{sync_sum * 1e3:.3f} ms ("
              f"{'HIDDEN' if overlap['async_below_sync_sum'] else 'NOT hidden'}"
              ")", file=sys.stderr)
    cm = sparse["comms"]
    sm = cm.get("sparse_bytes_per_iter")
    out = {
        "metric": "multichip_edges_per_sec_per_chip",
        "value": sparse["value"],
        "unit": "edges/s/chip",
        "n_devices": ndev,
        "scale": args.scale,
        "iters": args.iters,
        "single_chip": single,
        "dense_exchange": dense,
        "sparse_exchange": sparse,
        "sparse_async": sparse_async,
        "pallas_partitioned": pallas,
        "exchange_overlap": overlap,
        # Per-device rate retained at ndev devices against one (1.0 =
        # linear scaling).
        "scaling_efficiency": sparse["value"] / single["value"],
        "scaling_efficiency_dense": dense["value"] / single["value"],
        "exchanged_bytes": {
            "sparse_model_per_iter": sm,
            "dense_model_per_iter": cm["dense_bytes_per_iter"],
            "sparse_below_dense": (bool(sm < cm["dense_bytes_per_iter"])
                                   if sm is not None else None),
            "halo_fraction": cm["halo_fraction"],
            "head_k": cm["head_k"],
        },
        # One line a rank: the device it ran on.
        "device_view": [f"rank {r}: {rk['device_view']}"
                        for r, rk in enumerate(ranks)],
    }
    cfg_o = PageRankConfig(num_iters=acc_iters, dtype="float64",
                           accum_dtype="float64")
    r_oracle = ReferenceCpuEngine(cfg_o).build(g_acc).run()
    _l1, norm, mass_norm = oracle_l1(r_sparse, r_oracle)
    print(f"multichip accuracy[sparse {ndev}-dev]: scale-{acc_scale}, "
          f"{acc_iters} iters: normalized L1 vs f64 oracle {norm:.3e}",
          file=sys.stderr)
    acc_cm = ranks[0]["acc_comms"] or {}
    acc_sm = acc_cm.get("sparse_bytes_per_iter")
    out["accuracy"] = {
        "config": f"sparse-exchange f32 x{ndev}",
        "scale": acc_scale,
        "iters": acc_iters,
        "normalized_l1_vs_f64_oracle": norm,
        "mass_normalized_l1": mass_norm,
        "sparse_model_per_iter": acc_sm,
        "dense_model_per_iter": acc_cm.get("dense_bytes_per_iter"),
        "sparse_below_dense": (
            bool(acc_sm < acc_cm["dense_bytes_per_iter"])
            if acc_sm is not None else None),
    }
    sweep = ranks[0]["sweep"]
    print("multichip staleness sweep (textbook, tol "
          f"{sweep['tol']:g}): " + ", ".join(
              f"{k}={v['iters_to_tol']}"
              for k, v in sweep["legs"].items()), file=sys.stderr)
    out["staleness_sweep"] = sweep
    # The async leg carries its own iterations-to-tol, so that the
    # history normalizer tracks it as a leg metric.
    sparse_async["iters_to_tol"] = sweep["legs"]["async_lag1"]["iters_to_tol"]
    out["edge_factor"] = args.edge_factor
    out["env"] = _env_fingerprint(dev)
    return _emit(out, args)


def _preflight(args) -> bool:
    """``--preflight``: the OOM fit check (``obs/devices.fit_check``, an
    analytic model: nothing allocates) at the geometry this invocation
    is about to build. Couple mode checks the headline f64/f64 config
    (the fattest resident set of its legs); ``--dtype`` that config;
    ``--multichip`` the single-device leg of the vertex-sharded solve,
    then a rank's share over the group (host-built graph: no build
    stages). Prints the per-stage table; returns whether it fits."""
    import torch

    from pagerank_tpu_torch import PageRankConfig
    from pagerank_tpu_torch.engines.torch_engine import resolve_device
    from pagerank_tpu_torch.obs import devices as obs_devices
    from pagerank_tpu_torch.ops.device_build import plan_partition_span

    dev = resolve_device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
    if args.multichip:
        res_single = obs_devices.fit_check(
            args.scale, edge_factor=args.edge_factor, ndev=1,
            vertex_sharded=True, device_build=False, device_kind=kind)
        print(obs_devices.render_fit(res_single), file=sys.stderr)
        if not res_single.fits:
            return False
        res = obs_devices.fit_check(
            args.scale, edge_factor=args.edge_factor,
            ndev=args.multichip_devices, vertex_sharded=True,
            device_build=False, device_kind=kind)
    else:
        dtype = args.dtype or "float64"
        part = 0
        if args.partition_span:
            cfg = PageRankConfig(dtype=dtype, accum_dtype=dtype)
            part = plan_partition_span(cfg, 1 << args.scale,
                                       args.edge_factor << args.scale,
                                       args.partition_span)
        res = obs_devices.fit_check(
            args.scale, edge_factor=args.edge_factor, dtype=dtype,
            accum_dtype=dtype, device_build=not args.host_build,
            partition_span=part, device_kind=kind)
    print(obs_devices.render_fit(res), file=sys.stderr)
    return res.fits


def run_ppr_serve(args):
    """The ``ppr_serve`` leg: drive the resident PPR query daemon
    (``serving/``, K1w) open-loop at ``--serve-qps`` and report the
    serving headline: sustained queries/s over answered queries, exact
    p50/p99 latency (percentiles of the per-query walls), the shed
    fraction (typed Overloaded rejections over offered) and the rescue
    count. One JSON line, ``metric: ppr_serve_queries_per_sec``; its
    ``layout`` records the daemon's K1w launches and batches."""
    from pagerank_tpu_torch import PageRankConfig, build_graph
    from pagerank_tpu_torch.engines.torch_engine import resolve_device
    from pagerank_tpu_torch.serving import PprServer, ServeConfig, qtrace
    from pagerank_tpu_torch.testing.load import QueryLoadGenerator
    from pagerank_tpu_torch.utils.synth import rmat_edges

    dev = resolve_device(args.device)
    n = 1 << args.scale
    src, dst = rmat_edges(args.scale, edge_factor=args.edge_factor,
                          seed=args.seed)
    graph = build_graph(src, dst, n=n)
    cfg = PageRankConfig(num_iters=args.iters)
    sc = ServeConfig(
        max_batch=args.serve_max_batch,
        queue_depth=args.serve_queue_depth,
        deadline_ms=args.serve_deadline_ms,
        topk=min(args.serve_topk, n),
    )
    c0 = _launch_counts()
    server = PprServer(graph, config=cfg, serve_config=sc, devices=[dev])
    server.start()  # the dispatcher thread; the warm-up runs here

    gap = 1.0 / max(args.serve_qps, 1e-9)
    plan = QueryLoadGenerator(
        seed=args.seed, num_queries=args.serve_queries, n=n,
        mean_gap_s=gap, k=sc.topk,
        deadline_range_s=(sc.deadline_ms / 1e3, sc.deadline_ms / 1e3),
    ).plan()

    # The query plane, armed for the measured window: the leg carries
    # where the tail lives, not just how long it is.
    plane = qtrace.arm_query_plane()
    try:
        handles = []
        t0 = time.perf_counter()
        for gap_s, source, k, deadline_s in plan:
            time.sleep(gap_s)
            handles.append(server.submit(source, k=k, deadline_s=deadline_s))
        # Settle: every handle resolves (answered or typed-rejected);
        # nothing is silently dropped.
        settle = sc.deadline_ms / 1e3 + sc.dispatch_timeout_s + 5.0
        for q in handles:
            q.wait(timeout=settle)
        elapsed = time.perf_counter() - t0
        rescues = server.rescues_done
        server.drain()
        phase_p99_ms = plane.phase_p99_ms()
    finally:
        qtrace.disarm_query_plane()

    outcomes = {}
    lat_ms = []
    for q in handles:
        outcomes[q.outcome or "unsettled"] = (
            outcomes.get(q.outcome or "unsettled", 0) + 1)
        if q.outcome.startswith("answered") and q.latency_s is not None:
            lat_ms.append(q.latency_s * 1e3)
    answered = sum(v for k_, v in outcomes.items()
                   if k_.startswith("answered"))
    shed = outcomes.get("shed_overload", 0)
    out = {
        "metric": "ppr_serve_queries_per_sec",
        "value": answered / elapsed if elapsed > 0 else 0.0,
        "unit": "queries/s",
        "p50_ms": float(np.percentile(lat_ms, 50)) if lat_ms else None,
        "p99_ms": float(np.percentile(lat_ms, 99)) if lat_ms else None,
        "phase_p99_ms": phase_p99_ms,
        "shed_fraction": shed / len(handles) if handles else 0.0,
        "rescues": rescues,
        "queries": len(handles),
        "answered": answered,
        "outcomes": outcomes,
        "elapsed_s": elapsed,
        "offered_qps": args.serve_qps,
        "scale": args.scale,
        "iters": args.iters,
        "edge_factor": args.edge_factor,
        "max_batch": sc.max_batch,
        "deadline_ms": sc.deadline_ms,
        "queue_depth": sc.queue_depth,
        "topk": sc.topk,
        # The daemon's kernel and its launches: K1w once an iteration of
        # the warm-up and of every dispatched batch.
        "layout": {"kernel": ("ell_contrib_spmm:cuda" if dev.type == "cuda"
                              else "ell_contrib_spmm:reference"),
                   "device": str(dev), "launches": _launches_since(c0),
                   "batches": len(server.batch_walls),
                   "steps": args.iters * (len(server.batch_walls) + 1)},
        "env": _env_fingerprint(dev),
    }
    return _emit(out, args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"python -m {_MODULE}",
        description="PageRank power-iteration throughput of the port "
        "(one JSON line; README.md, 'PyTorch/CUDA port')")
    p.add_argument("--scale", type=int, default=23,
                   help="R-MAT scale (2^scale vertices). 23 = 8.4M "
                        "vertices / 131M unique edges")
    p.add_argument("--edge-factor", type=int, default=16)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--dtype", default=None,
                   help="single-config mode: run ONLY this dtype "
                        "(storage and accumulation). Default: couple "
                        "mode — f64/f64 headline + f32 legs")
    p.add_argument("--kernel", default="auto",
                   help="auto|ell|pallas|coo (auto, ell and pallas all run "
                        "the hand kernels: K1 flat, K2 partitioned; coo "
                        "the segment sum, host build)")
    p.add_argument("--partition-span", type=int, default=0,
                   help="partition-centric layout span. Couple mode: the "
                        "partitioned_f32/fast_bf16 legs always run (0 here "
                        "means those legs use the engine's auto rule); "
                        "single-config mode: 0 = off, -1 = auto, >0 = "
                        "explicit span for the one measured config")
    p.add_argument("--multichip", action="store_true",
                   help="the multichip benchmark: a vertex-sharded f32 "
                        "solve over a process group through the dense AND "
                        "the sparse (halo) exchange, plus a single-device "
                        "leg for scaling efficiency and an oracle-parity "
                        "accuracy leg; one JSON line")
    p.add_argument("--multichip-devices", type=int, default=8,
                   help="ranks of the --multichip group: one card a rank "
                        "(NCCL) where the host has that many, else gloo "
                        "ranks sharing the device")
    p.add_argument("--ppr-serve", action="store_true",
                   help="the serving benchmark: drive the resident PPR "
                        "query daemon (pagerank_tpu_torch/serving/) "
                        "open-loop at --serve-qps and report sustained "
                        "queries/s, exact p50/p99 latency, shed fraction "
                        "and rescue count — one JSON line "
                        "(ppr_serve_queries_per_sec)")
    p.add_argument("--serve-queries", type=int, default=200,
                   help="queries offered by the --ppr-serve leg")
    p.add_argument("--serve-qps", type=float, default=100.0,
                   help="offered open-loop rate for --ppr-serve (mean of "
                        "the seeded exponential gaps)")
    p.add_argument("--serve-max-batch", type=int, default=8,
                   help="--ppr-serve daemon micro-batch size (the most "
                        "columns a dispatch)")
    p.add_argument("--serve-deadline-ms", type=float, default=500.0,
                   help="--ppr-serve per-query deadline")
    p.add_argument("--serve-queue-depth", type=int, default=64,
                   help="--ppr-serve admission queue bound")
    p.add_argument("--serve-topk", type=int, default=64,
                   help="--ppr-serve top-k returned per query (clamped "
                        "to n)")
    p.add_argument("--seed", type=int, default=0,
                   help="R-MAT + load-plan seed (--ppr-serve)")
    p.add_argument("--host-build", action="store_true",
                   help="build the graph on the host and copy it to the "
                        "device (default: generated and packed on the "
                        "device)")
    p.add_argument("--build-only", action="store_true",
                   help="device builds only, with the per-stage breakdown "
                        "(BUILD_STAGE_KEYS); couple mode builds f64/f64 "
                        "then f32 then f64/f64 again (warm) and reports "
                        "the ratios, --dtype builds one config")
    p.add_argument("--accuracy-scale", type=int, default=20,
                   help="R-MAT scale of the standing accuracy probe")
    p.add_argument("--no-accuracy", action="store_true",
                   help="skip the standing accuracy field")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="ALSO write the JSON record here, directly")
    p.add_argument("--history", default=None, metavar="LEDGER",
                   help="auto-append this run, normalized to the canonical "
                        "RunRecord, to the append-only perf ledger "
                        "(pagerank_tpu_torch/obs/history.py). Inspect with "
                        "`python -m pagerank_tpu_torch.obs history trend "
                        "LEDGER`")
    p.add_argument("--sdc-check-every", type=int, default=0, metavar="K",
                   help="ALSO measure the SDC-checked step's overhead per "
                        "rate leg (pagerank_tpu_torch/sdc.py): each leg's "
                        "JSON carries 'sdc_check_overhead_pct', percent "
                        "extra wall per CHECKED iteration against the plain "
                        "step. 0 (default) disarms: the field rides as null")
    p.add_argument("--preflight", action="store_true",
                   help="OOM-preflight fit check (obs/devices.fit_check, "
                        "analytic: nothing allocates) BEFORE anything "
                        "allocates: exit 3 with the per-stage table when "
                        "this run's geometry does not fit the card")
    p.add_argument("--device", default="cuda",
                   help="where the legs run (default cuda; 'cpu' runs the "
                        "kernels' plain versions on the host; 'cuda:N' "
                        "pins a card, and a --multichip group then shares "
                        "it)")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.preflight and not _preflight(args):
        # The CLI's --preflight refusal code (exitcodes.py).
        sys.exit(int(ExitCode.PREFLIGHT_UNFIT))

    if args.ppr_serve:
        return run_ppr_serve(args)

    if args.multichip:
        return run_multichip(args)

    from pagerank_tpu_torch.engines.torch_engine import resolve_device

    dev = resolve_device(args.device)

    if args.build_only:
        if args.host_build:
            p.error("--build-only measures the device build pipeline; "
                    "drop --host-build")
        if args.kernel not in ("auto", "ell"):
            p.error(f"--build-only measures the flat ELL build; --kernel "
                    f"{args.kernel} builds a different one")
        kw = dict(scale=args.scale, edge_factor=args.edge_factor,
                  device=dev)
        if args.dtype is not None:
            rec = run_build(dtype=args.dtype, **kw)
            out = {"metric": "build_s", "value": rec["build_s"],
                   "unit": "s", "scale": args.scale, **rec}
        else:
            f64 = run_build(dtype="float64", accum_dtype="float64", **kw)
            f32 = run_build(dtype="float32", **kw)
            # The warm f64 rebuild: the first pays every first-use cost
            # (the kernel builds, the allocator's first buffers), so both
            # ratios are reported.
            f64_warm = run_build(dtype="float64", accum_dtype="float64",
                                 label="float64 warm", **kw)
            out = {"metric": "build_s", "value": f64["build_s"],
                   "unit": "s", "scale": args.scale, "f64": f64,
                   "f32": f32, "f64_warm": f64_warm,
                   "f64_over_f32": f64["build_s"] / f32["build_s"],
                   "f64_warm_over_f32":
                       f64_warm["build_s"] / f32["build_s"]}
        out["env"] = _env_fingerprint(dev)
        return _emit(out, args)

    if args.dtype is not None:
        # Single-config mode (the original schema).
        rate = run_rate(args, args.dtype, args.dtype,
                        partition_span=args.partition_span)
        out = {
            "metric": "edges_per_sec_per_chip",
            "value": rate["value"],
            "unit": "edges/s/chip",
            "vs_baseline": rate["vs_baseline"],
            "build_s": rate["build_s"],
            "costs": rate["costs"],
            "lowering": rate["lowering"],
            "graph": rate["graph"],
            "layout": rate["layout"],
            "sdc_check_overhead_pct": rate["sdc_check_overhead_pct"],
            "scale": args.scale,
            "iters": args.iters,
            "edge_factor": args.edge_factor,
        }
        if not args.no_accuracy:
            out["accuracy"] = run_accuracy(args.accuracy_scale, args.iters,
                                           device=dev)
        out["env"] = _env_fingerprint(dev)
        return _emit(out, args)

    # Couple mode: the headline is the accuracy-grade config's rate (f64
    # ranks, f64 sums: f32 ranks lose the 1e-6 grade over 50
    # reference-semantics iterations), with the f32 legs and the standing
    # oracle-L1 field beside it.
    f64_rate = run_rate(args, "float64", "float64")
    f32_rate = run_rate(args, "float32", "float32")
    # The partition-centric legs: the same f32 workload through K2, and
    # with bf16 z windows. --partition-span > 0 forces the span;
    # otherwise the engine's auto rule (with the small-graph fallback)
    # sizes it, and each leg's layout records what ran.
    leg_span = args.partition_span if args.partition_span > 0 else -1
    part_rate = run_rate(args, "float32", "float32", partition_span=leg_span,
                         force_span_fallback=True)
    bf16_rate = run_rate(args, "float32", "float32", partition_span=leg_span,
                         stream_dtype="bfloat16", force_span_fallback=True)
    out = {
        "metric": "edges_per_sec_per_chip",
        "value": f64_rate["value"],
        "unit": "edges/s/chip",
        "vs_baseline": f64_rate["vs_baseline"],
        "build_s": f64_rate["build_s"],
        "costs": f64_rate["costs"],
        "lowering": f64_rate["lowering"],
        "graph": f64_rate["graph"],
        "layout": f64_rate["layout"],
        "sdc_check_overhead_pct": f64_rate["sdc_check_overhead_pct"],
        "fast_f32": f32_rate,
        "partitioned_f32": part_rate,
        "fast_bf16": bf16_rate,
        "scale": args.scale,
        "iters": args.iters,
        "edge_factor": args.edge_factor,
    }
    if not args.host_build and args.kernel != "coo":
        # LAST, so that the rebuild cannot perturb the rate legs: the
        # headline config built again, warm.
        out["build_warm_s"] = run_rate(args, "float64", "float64",
                                       build_only=True)["build_s"]
    if not args.no_accuracy:
        out["accuracy"] = run_accuracy(args.accuracy_scale, args.iters,
                                       with_bf16=True, device=dev)
    out["env"] = _env_fingerprint(dev)
    return _emit(out, args)


if __name__ == "__main__":
    main()
