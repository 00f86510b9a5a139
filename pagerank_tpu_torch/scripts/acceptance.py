"""Standing acceptance runs of the port on the card.

Port of ``scripts/acceptance.py``: the BASELINE.md config-2/3/5
stand-ins in f64 against the f64 oracle, the PPR stand-in, the
reference's literal job and the gate smokes of every plane, each key a
pass/fail record.

    python -m pagerank_tpu_torch.scripts.acceptance [--only KEY]
        [--no-append] [--no-analysis] [--device cuda|cpu]

It runs on ``cuda`` unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it exits 2 and runs nothing.

Keys (``CONFIGS``; the default order is ``DEFAULT_KEYS``):

  A, B, T, BV, BB, TV, C, CV   R-MAT stand-ins in f64/f64 through K1's
        ``ell_contrib_f64_f64`` entry (the card has native f64: the JAX
        script's pair-f64 accumulation is a TPU workaround and does not
        apply), held to the port's f64 ``ReferenceCpuEngine`` on the same
        graph: the raw AND the mass-normalised L1 <= 1e-6. BV/BB/TV are
        the vertex-sharded and vs_bounded forms at world 1, in process.
        C and CV (rmat:24, 50 iterations) run only through ``--only``;
  P     PPR through K1w at rmat:20, 256 sources, top-100, against
        ``ppr_cpu``: top-k overlap >= 0.999, top-k score L1 <= 1e-4;
  E     the reference's literal job: 301 SequenceFiles x 1000 records ->
        native L1 -> host build -> 10 f64 iterations with the
        ``PageRank{i}/`` dumps through ``AsyncRankWriter`` + ``TextDumper``;
  F G H K R U W   in-process smokes (fault injection, observability,
        live telemetry, the partitioned form, the preemptible job, the
        PTR pass, the PTK pass);
  L M O S V X Y Z   group smokes over gloo ranks that
        ``parallel/distributed.spawn_group`` starts on the one card (the
        JAX script runs them on 8 fake CPU devices): world 3 where a
        member is lost (L, V, Y, Z), world 2 for M, O, X; S predicts for
        8 ranks and measures the per-rank edges with the engine's own
        share functions at world 8.

Refused (exit 2): D, N and AA wait for the port's benchmark (ROADMAP
queue 1); Q (``obs hlo``) is not applicable.

Every record keeps the JAX script's keys; ``tpu_seconds`` is
``device_seconds``. ``main`` adds the card (``nvidia-smi`` name and power
limit) and the key's wall to each record, writes each key's row into
the "Acceptance runs on the card" table of PERF.md in place of the
key's older row (``--no-append`` skips it), prints the records as one
JSON line and returns 0 when every record passed, else 1.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import shutil
import signal
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_MODULE = "pagerank_tpu_torch.scripts.acceptance"

GATE = 1e-6

CONFIGS = {
    "A": dict(scale=20, iters=20, label="config-2 stand-in (web-Google class)"),
    "B": dict(scale=23, iters=30, label="config-3 stand-in (LiveJournal class)"),
    "C": dict(scale=24, iters=50,
              label="config-4 per-chip stand-in (Twitter class, 50 iters)"),
    "T": dict(scale=20, iters=50, semantics="textbook",
              label="textbook-mode stand-in (scale-20, 50 iters)"),
    "P": dict(scale=20, iters=20, sources=256, topk=100, kind="ppr",
              label="config-5 stand-in (PPR, 256 sources)"),
    "BV": dict(scale=23, iters=30, vertex_sharded=True,
               label="config-3 stand-in, VERTEX-SHARDED (psum+slice merge)"),
    "BB": dict(scale=23, iters=30, vertex_sharded=True, vs_bounded=True,
               label="config-3 stand-in, VS-BOUNDED (dst-partitioned)"),
    "TV": dict(scale=20, iters=50, semantics="textbook",
               vertex_sharded=True,
               label="textbook-mode stand-in, VERTEX-SHARDED"),
    "CV": dict(scale=24, iters=50, vertex_sharded=True,
               label="config-4 per-chip stand-in, VERTEX-SHARDED"),
    "E": dict(kind="e2e", files=301, records=1000, iters=10,
              label="reference-job end-to-end (301-file segment)"),
    "F": dict(kind="faults", seed=23, iters=12,
              label="fault-injection smoke (seeded chaos, rollback+retry)"),
    "D": dict(kind="build", scale=18,
              label="build-stage smoke (scale-18 pair-f64 device build)"),
    "G": dict(kind="obs", iters=4,
              label="observability smoke (traced run + flight recorder)"),
    "H": dict(kind="live", iters=6, probe_every=2,
              label="live-telemetry smoke (probes + exporter + watchdog)"),
    "K": dict(kind="partitioned", iters=6, probe_every=2, span=512,
              label="partition-centric smoke (windowed solve + contracts)"),
    "L": dict(kind="elastic", iters=12, kill_iter=6, kill_device=2,
              seed=5,
              label="elastic-rescue smoke (8-fake-device chaos, "
                    "one device kill)"),
    "M": dict(kind="halo", scale=12, iters=12,
              label="sparse-exchange smoke (8-fake-device halo solve)"),
    "N": dict(kind="history", scale=14, iters=3,
              label="perf-sentry smoke (ledger ingest + noise-aware "
                    "gate)"),
    # fit_bad_scale: 26 in the JAX script (past a 16 GB v5e); on an
    # 80 GB card rmat:26 fits and 27 is the first refused, so the
    # absurd scale is 30 (17.2 billion raw edges).
    "O": dict(kind="devices", scale=12, iters=8, fit_ok_scale=14,
              fit_bad_scale=30,
              label="device-plane smoke (attributed multichip + "
                    "sampler + fit check)"),
    "Q": dict(kind="hlo", scale=14, forms="default,partitioned",
              label="compiler-plane smoke (optimized-HLO gather "
                    "verdict, default + partitioned)"),
    "R": dict(kind="jobs", scale=10, iters=12, kill_iter=6,
              label="preemption smoke (SIGTERM drain + job-dir "
                    "resume)"),
    "S": dict(kind="graph", scale=14, ndev=8, iters=3,
              label="data-plane smoke (graph profile + mass ledger + "
                    "skew prediction)"),
    "U": dict(kind="concurrency",
              label="concurrency-plane smoke (PTR race pass, zero "
                    "unwaived findings)"),
    "V": dict(kind="sdc", iters=12, flip_iter=5, flip_device=2,
              seed=11,
              label="sdc smoke (sticky bit-flip -> detect/localize/"
                    "quarantine on 8 fake devices)"),
    "W": dict(kind="kernels",
              label="kernel-plane smoke (PTK pass clean, every seeded "
                    "defect trips its rule)"),
    "X": dict(kind="halo_async", scale=12, iters=120,
              label="async-exchange smoke (8-fake-device stale-"
                    "boundary halo solve)"),
    "Y": dict(kind="serve", seed=7, queries=40, iters=5,
              kill_batch=3, kill_device=5, drain_at=34,
              label="serving smoke (8-fake-device query daemon under "
                    "chaos: kill + SIGTERM drain, bit-identical "
                    "replay)"),
    "Z": dict(kind="qtrace", seed=7, queries=40, iters=5,
              kill_batch=3, kill_device=5, drain_at=34,
              label="query-plane smoke (armed tracing under chaos: "
                    "determinism, exemplars, slow-query log, flight "
                    "recorder)"),
    "AA": dict(kind="campaign",
               label="campaign-plane smoke (dry-run campaign on 8 "
                     "fake devices: all legs, 5 non-binding "
                     "verdicts, decision ledger)"),
}
DEFAULT_KEYS = ["G", "H", "K", "L", "M", "X", "Y", "Z", "O", "R", "S",
                "U", "V", "W", "F", "A", "B", "T", "P", "E", "BV", "BB",
                "TV"]

#: Keys the port does not run, and why (exit 2 with the message).
REFUSED = {
    "D": "smoke D runs bench.run_build: it waits for the port's benchmark "
         "(ROADMAP.md queue 1, slice 8b)",
    "N": "smoke N runs bench.py into the history ledger: it waits for the "
         "port's benchmark (ROADMAP.md queue 1, slice 8b)",
    "AA": "smoke AA is the campaign (obs/campaign.py), whose legs run "
          "bench.py: it waits for the port's benchmark (ROADMAP.md queue "
          "1, slice 8b)",
    "Q": "smoke Q is `obs hlo`: not applicable to the port, which lowers "
         "no HLO (ROADMAP.md queue 1); `python -m pagerank_tpu_torch."
         "analysis --compiled` reads the CUDA kernels' compile facts",
}

# Wall budgets of the smokes, in seconds. Each times what the JAX
# script's budget times (the run, never a group's spawn, a first build
# or the f64 oracle) and was set from this script's own run on one
# NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md, "Acceptance
# runs on the card"; the wall measured there in brackets): about three
# times that wall, and never below the JAX script's number.
OBS_SMOKE_BUDGET_S = 2.0            # [0.38 s]
LIVE_SMOKE_BUDGET_S = 3.5           # [1.11 s]
PARTITIONED_SMOKE_BUDGET_S = 120.0  # [9.98 s, the PTK registry's build]
ELASTIC_SMOKE_BUDGET_S = 3.0        # [0.39 s]
SERVE_SMOKE_BUDGET_S = 3.0          # [0.34 s]
QTRACE_SMOKE_BUDGET_S = 3.0         # [0.32 s]
SDC_SMOKE_BUDGET_S = 3.0            # [0.57 s]
HALO_SMOKE_BUDGET_S = 3.0           # [0.20 s]
HALO_ASYNC_SMOKE_BUDGET_S = 3.0     # [0.55 s]
DEVICES_SMOKE_BUDGET_S = 3.0        # [0.17 s]
GRAPH_SMOKE_BUDGET_S = 2.0          # [0.20 s]
CONCURRENCY_SMOKE_BUDGET_S = 11.0   # [3.56 s]
# [0.88 s after K built the PTK registry; its build is most of K's 9.98]
KERNELS_SMOKE_BUDGET_S = 30.0
R_SMOKE_BUDGET_S = 3.0              # [0.16 s]

#: Every terminal outcome the serving daemon may hand back
#: (serving/query.py); anything else is a silent drop.
SERVE_OUTCOMES = frozenset({
    "answered", "answered_cache", "answered_degraded",
    "shed_overload", "rejected_draining", "rejected_deadline",
})

#: The standing f32-grade oracle gate (normalised L1) of the smokes.
ELASTIC_F32_GATE = 1e-4

#: Group sizes of the group smokes on one card: three where a member is
#: lost, so that a group survives it; two otherwise.
LOSS_WORLD = 3
GROUP_WORLD = 2
#: The member the loss smokes (L, V, Y, Z) take out: a follower (the
#: JAX script's device 2 of 8 for L and V, device 5 of 8 for Y and Z).
LOSS_MEMBER = 2

# PPR gates (the JAX script's).
PPR_TIE_EPS = 1e-6
PPR_OVERLAP_GATE = 0.999
PPR_SCORE_L1_GATE = 1e-4

#: Seeded defect fixture -> the ONE PTK rule it must trip.
KERNELS_FIXTURE_RULES = {
    "fixture:vmem_overflow": "PTK001",
    "fixture:misaligned_tile": "PTK002",
    "fixture:index_gap": "PTK003",
    "fixture:index_overlap": "PTK003",
    "fixture:f64_scratch": "PTK004",
    "fixture:cost_mismatch": "PTK005",
}
#: PTK findings the checked-in allowlist waives: none (the JAX
#: package's four whole-z VMEM waivers have no counterpart: K1 stages
#: only a head of z).
PTK_WAIVERS = 0

#: Threads the PTR pass must find, by label.
THREAD_ROOTS = frozenset({
    "rank-writer", "pagerank-stall-watchdog", "pagerank-metrics-http",
    "pagerank-deadline-dispatch", "pagerank-liveness-probe",
})
#: The skew gate of smoke S (relative).
GRAPH_SKEW_GATE = 0.10


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _verdict(passed) -> str:
    return "PASS" if passed else "FAIL"


def card_identity(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them; on
    the CPU, ``cpu``."""
    if not device.startswith("cuda"):
        return "cpu"
    import torch

    from pagerank_tpu_torch.obs.report import power_limit

    return power_limit() or (f"{torch.cuda.get_device_name(0)}, power "
                             f"limit unread")


def _facts_line(key: str) -> None:
    from pagerank_tpu_torch.scripts.host_ingest_bench import (host_facts,
                                                              rss_gb)

    avail = host_facts()["mem_available_gb"]
    _say(f"[{key}] host: MemAvailable "
         f"{'unread' if avail is None else f'{avail:.1f} GB'}, peak RSS "
         f"{rss_gb():.2f} GB")


def _k1_launches() -> int:
    from pagerank_tpu_torch.ops import ell_spmv

    return ell_spmv.launches


def _reset_k1() -> None:
    from pagerank_tpu_torch.ops import ell_spmv

    ell_spmv.launches = 0


def _l1(ranks, oracle) -> float:
    return float(np.abs(ranks - oracle).sum()) / float(np.abs(oracle).sum())


def _strict_json(text: str):
    def no_const(name):
        raise ValueError(f"non-spec JSON constant {name!r}")

    return json.loads(text, parse_constant=no_const)


# -- the f64 oracle runs -----------------------------------------------------

#: Graphs and oracle ranks already built in this process, by R-MAT scale
#: and by (scale, iterations, semantics): B, BV and BB share one graph
#: and one oracle, as A, P, T and TV share theirs.
_GRAPHS: dict = {}
_ORACLES: dict = {}


def _make_graph(key: str, scale: int):
    """The R-MAT graph of ``scale`` (seed 11, edge factor 16, the JAX
    script's) and its host stage seconds (0 where it was built for an
    earlier key of this process)."""
    if scale in _GRAPHS:
        g = _GRAPHS[scale]
        _say(f"[{key}] graph: scale {scale}: {g.n:,} vertices, "
             f"{g.num_edges:,} edges (built for an earlier key)")
        return g, {"rmat_s": 0.0, "build_graph_s": 0.0}
    from pagerank_tpu_torch import build_graph
    from pagerank_tpu_torch.utils.synth import rmat_edges

    t0 = time.perf_counter()
    src, dst = rmat_edges(scale, 16, seed=11)
    t1 = time.perf_counter()
    g = build_graph(src, dst, n=1 << scale)
    t2 = time.perf_counter()
    del src, dst
    _GRAPHS[scale] = g
    _say(f"[{key}] graph: scale {scale}: {g.n:,} vertices, "
         f"{g.num_edges:,} edges (R-MAT {t1 - t0:.1f}s, build_graph "
         f"{t2 - t1:.1f}s)")
    return g, {"rmat_s": t1 - t0, "build_graph_s": t2 - t1}


def _oracle(g, scale: int, iters: int, semantics: str):
    from pagerank_tpu_torch import PageRankConfig, ReferenceCpuEngine

    k = (scale, iters, semantics)
    if k not in _ORACLES:
        t0 = time.perf_counter()
        cfg = PageRankConfig(num_iters=iters, dtype="float64",
                             accum_dtype="float64", semantics=semantics)
        _ORACLES[k] = (ReferenceCpuEngine(cfg).build(g).run(),
                       time.perf_counter() - t0)
        return _ORACLES[k]
    return _ORACLES[k][0], 0.0


def _head_share(eng) -> str:
    """K1's staged head and the share of the real slots below it."""
    import torch

    from pagerank_tpu_torch.ops import ell_spmv

    z_ext, src = eng.contrib_inputs()[:2]
    head = eng.layout_info().get("head")
    if head is None:
        kind = (torch.cuda.get_device_name(z_ext.device)
                if z_ext.device.type == "cuda" else None)
        head = ell_spmv.head_capacity(z_ext.element_size(), kind)
    sentinel = z_ext.shape[0] - 8
    real = src < sentinel
    below = (src < head) & real
    n_real = max(int(real.sum()), 1)
    return (f"head {head:,} {str(z_ext.dtype).removeprefix('torch.')} "
            f"entries: {int(below.sum()) / n_real:.1%} of real slots below "
            f"it")


def run_one(key: str, device: str = "cuda"):
    """A, B, C, T, BV, BB, TV, CV: f64/f64 through K1 against the f64
    oracle on the same graph. The timed window is the JAX one: a warm
    step, the initial ranks restored, ``iters`` ``_device_step`` calls
    and one fence."""
    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine
    from pagerank_tpu_torch.models.pagerank import initial_rank
    from pagerank_tpu_torch.utils.metrics import oracle_l1

    spec = CONFIGS[key]
    scale, iters = spec["scale"], spec["iters"]
    semantics = spec.get("semantics", "reference")
    g, host = _make_graph(key, scale)
    cfg = PageRankConfig(
        num_iters=iters, dtype="float64", accum_dtype="float64",
        semantics=semantics,
        vertex_sharded=spec.get("vertex_sharded", False),
        vs_bounded=spec.get("vs_bounded", False),
    )
    t0 = time.perf_counter()
    eng = TorchEngine(cfg, device=device).build(g)
    t_dev_build = time.perf_counter() - t0
    _reset_k1()
    eng.step()
    eng.fence()
    eng.set_ranks(initial_rank(g.n, semantics, torch.float64).numpy(),
                  iteration=0)
    chips = len(eng.device_ids())
    t0 = time.perf_counter()
    for _ in range(iters):
        eng._device_step()
    eng.fence()
    t_run = time.perf_counter() - t0
    launches = _k1_launches()
    r_dev = eng.ranks()
    form = eng.layout_info().get("form")
    # The C entry the bound launch calls (None on the CPU, which runs
    # K1's plain version).
    entry = getattr(getattr(getattr(eng, "_launch", None), "_fn", None),
                    "__name__", None)
    share = _head_share(eng) if eng.device.type == "cuda" else "n/a (cpu)"
    del eng

    r_cpu, t_oracle = _oracle(g, scale, iters, semantics)
    _, norm, mass_norm = oracle_l1(r_dev, r_cpu)
    rate = g.num_edges * iters / t_run / chips
    # On a card every step is one K1 launch (the warm step's too); the
    # CPU runs K1's plain version, which counts nothing.
    want = iters + 1 if device != "cpu" else 0
    want_entry = "ell_contrib_f64_f64" if device != "cpu" else None
    rec = {
        "config": key,
        "label": spec["label"],
        "semantics": semantics,
        "scale": scale,
        "iters": iters,
        "num_edges": int(g.num_edges),
        "normalized_l1": norm,
        "mass_normalized_l1": mass_norm,
        "mass_growth": float(r_cpu.sum()) / g.n,
        "gate": GATE,
        "passed": bool(norm <= GATE and mass_norm <= GATE
                       and launches == want and entry == want_entry),
        "device_seconds": t_run,
        "edges_per_sec_per_chip": rate,
        "form": form,
        "k1_launches": launches,
        "k1_entry": entry,
        "host_stages_s": {**host, "engine_build_s": t_dev_build,
                          "oracle_s": t_oracle},
    }
    _say(f"[{key}] {form} f64/f64, {iters} iters in {t_run:.3f}s (engine "
         f"build {t_dev_build:.1f}s, oracle {t_oracle:.1f}s): normalized "
         f"L1 {norm:.3e} (mass-normalized {mass_norm:.3e}) vs gate "
         f"{GATE:g}; K1 launches {launches} (want {want}) through "
         f"{entry or 'its plain version'}; {share} -> "
         f"{_verdict(rec['passed'])}; {rate:.4g} edges/s/chip")
    _facts_line(key)
    return rec


def run_ppr(key: str, device: str = "cuda"):
    """P: PPR through K1w against the f64 ``ppr_cpu`` oracle, per-source
    top-k id overlap and top-k score L1 (the JAX gates)."""
    from pagerank_tpu_torch import PageRankConfig
    from pagerank_tpu_torch.engines.ppr import PprTorchEngine, ppr_cpu
    from pagerank_tpu_torch.ops import ell_spmm

    spec = CONFIGS[key]
    scale, iters = spec["scale"], spec["iters"]
    n_sources, topk = spec["sources"], spec["topk"]
    g, host = _make_graph(key, scale)
    rng = np.random.default_rng(17)
    sources = rng.choice(g.n, size=n_sources, replace=False)

    cfg = PageRankConfig(num_iters=iters, dtype="float32",
                         accum_dtype="float32")
    t0 = time.perf_counter()
    eng = PprTorchEngine(cfg, device=device).build(g)
    t_dev_build = time.perf_counter() - t0
    chunk = 64
    assert n_sources % chunk == 0 or n_sources < chunk, (n_sources, chunk)
    eng.run(sources[:chunk], topk=topk, chunk=chunk)
    ell_spmm.launches = 0
    res = eng.run(sources, topk=topk, chunk=chunk)
    launches = ell_spmm.launches

    # The rate window: the chunks solved back to back on the device
    # (no per-chunk fetch), one fence at the end.
    t0 = time.perf_counter()
    tails = []
    for lo in range(0, n_sources, chunk):
        r = eng.solve_chunk(sources[lo: lo + chunk], iters)
        tails.append(eng.topk(r, topk))
    float(tails[-1][1][0, 0])
    t_run = time.perf_counter() - t0
    del eng, tails, r

    t0 = time.perf_counter()
    r_full = ppr_cpu(g, sources, num_iters=iters, damping=cfg.damping)
    t_oracle = time.perf_counter() - t0

    cols = np.arange(n_sources)
    part = np.argpartition(r_full, g.n - topk, axis=0)[g.n - topk:]
    top_scores = np.take_along_axis(r_full, part, axis=0)
    kth = top_scores.min(axis=0)
    dev_scores_true = r_full[res.topk_ids, cols[:, None]]
    overlaps = (dev_scores_true >= (kth[:, None] - PPR_TIE_EPS)).mean(axis=1)
    oracle_topk = np.sort(top_scores, axis=0)[::-1].T
    score_l1 = np.abs(
        res.topk_scores.astype(np.float64) - oracle_topk).sum(axis=1)
    del r_full
    rate = g.num_edges * n_sources * iters / t_run  # one card
    want = (n_sources // chunk) * iters if device != "cpu" else 0
    rec = {
        "config": key,
        "kind": "ppr",
        "label": spec["label"],
        "scale": scale,
        "iters": iters,
        "sources": n_sources,
        "topk": topk,
        "num_edges": int(g.num_edges),
        "min_topk_overlap": float(overlaps.min()),
        "mean_topk_overlap": float(overlaps.mean()),
        "max_score_l1": float(score_l1.max()),
        "overlap_gate": PPR_OVERLAP_GATE,
        "score_l1_gate": PPR_SCORE_L1_GATE,
        "passed": bool(overlaps.min() >= PPR_OVERLAP_GATE
                       and score_l1.max() <= PPR_SCORE_L1_GATE
                       and launches == want),
        "device_seconds": t_run,
        "edge_vectors_per_sec_per_chip": rate,
        "rate_protocol": "pipelined-device",
        "k1w_launches": launches,
        "host_stages_s": {**host, "engine_build_s": t_dev_build,
                          "oracle_s": t_oracle},
    }
    _say(f"[{key}] {n_sources} sources x {iters} iters, top-{topk} in "
         f"{t_run:.3f}s (engine build {t_dev_build:.1f}s, oracle "
         f"{t_oracle:.1f}s): overlap min {overlaps.min():.4f} / mean "
         f"{overlaps.mean():.4f} (gate {PPR_OVERLAP_GATE}), max score L1 "
         f"{score_l1.max():.3e} (gate {PPR_SCORE_L1_GATE:g}); K1w launches "
         f"{launches} (want {want}) -> {_verdict(rec['passed'])}; "
         f"{rate:.4g} edge-vectors/s/chip")
    _facts_line(key)
    return rec


def _gen_segment(d: str, files: int, per_file: int, seed: int = 23) -> float:
    """The JAX script's synthetic crawl segment, record for record:
    ``files`` SequenceFiles ``metadata-%05d`` of ``per_file`` (url,
    json-metadata) records; ~8% of pages linkless, ~15% of link targets
    never crawled. Returns the generation's seconds."""
    from pagerank_tpu_torch.ingest.seqfile import write_sequence_file

    rng = np.random.default_rng(seed)
    n_crawled = files * per_file

    def url(i: int) -> str:
        return f"http://site{i % 997}.test/p{i}"

    t0 = time.perf_counter()
    for fi in range(files):
        pairs = []
        base = fi * per_file
        for ri in range(per_file):
            u = url(base + ri)
            links = []
            if rng.random() >= 0.08:
                for t in rng.integers(0, n_crawled, rng.integers(3, 13)):
                    links.append(
                        f"http://uncrawled{int(t)}.test/"
                        if rng.random() < 0.15 else url(int(t)))
            pairs.append((u, json.dumps(
                {"url": u, "content": {"links": [
                    {"type": "a", "href": x} for x in links]}})))
        write_sequence_file(os.path.join(d, f"metadata-{fi:05d}"), pairs)
    return time.perf_counter() - t0


def run_e2e(key: str, device: str = "cuda"):
    """E: the reference's literal job in its layer split — L1 segment
    parse (native), L2 host build, L3 engine build + 10 f64 reference
    iterations on the card, L4 per-iteration ``PageRank{i}/`` dumps
    through the async writer — against the f64 oracle."""
    import torch

    from pagerank_tpu_torch import (PageRankConfig, ReferenceCpuEngine,
                                    TorchEngine, build_graph)
    from pagerank_tpu_torch.ingest import load_crawl_seqfile_arrays
    from pagerank_tpu_torch.models.pagerank import initial_rank
    from pagerank_tpu_torch.utils.metrics import oracle_l1
    from pagerank_tpu_torch.utils.snapshot import AsyncRankWriter, TextDumper

    spec = CONFIGS[key]
    files, per_file, iters = spec["files"], spec["records"], spec["iters"]
    work = tempfile.mkdtemp(prefix="pagerank_e2e_")
    try:
        seg = os.path.join(work, "segment")
        os.makedirs(seg)
        t_gen = _gen_segment(seg, files, per_file)

        t0 = time.perf_counter()
        src, dst, crawled, ids = load_crawl_seqfile_arrays(seg)
        t_l1 = time.perf_counter() - t0

        t0 = time.perf_counter()
        g = build_graph(src, dst, n=len(ids), dangling_mask=~crawled)
        t_l2 = time.perf_counter() - t0

        cfg = PageRankConfig(num_iters=iters, dtype="float64",
                             accum_dtype="float64")
        t0 = time.perf_counter()
        eng = TorchEngine(cfg, device=device).build(g)
        t_eng_build = time.perf_counter() - t0
        _reset_k1()
        eng.step()
        eng.fence()
        eng.set_ranks(initial_rank(g.n, "reference", torch.float64).numpy(),
                      iteration=0)

        dumper = TextDumper(os.path.join(work, "out"), names=ids.names)
        t_dump_work = [0.0]

        def dump_sink(i, ranks):
            t1 = time.perf_counter()
            dumper.dump(i, ranks)
            t_dump_work[0] += time.perf_counter() - t1

        t_solve = 0.0
        t_loop0 = time.perf_counter()
        with AsyncRankWriter(eng.decode_ranks, [dump_sink]) as writer:
            for it in range(iters):
                t0 = time.perf_counter()
                eng._device_step()
                eng.fence()
                t_solve += time.perf_counter() - t0
                writer.submit(it, eng.device_ranks())
        t_l4 = time.perf_counter() - t_loop0 - t_solve
        launches = _k1_launches()
        r_dev = eng.ranks()

        for it in range(iters):
            d = os.path.join(work, "out", f"PageRank{it}")
            assert os.path.exists(os.path.join(d, "_SUCCESS")), d
            assert os.path.exists(os.path.join(d, "part-00000")), d
        with open(os.path.join(work, "out", f"PageRank{iters - 1}",
                               "part-00000")) as f:
            dump_lines = sum(1 for _ in f)
        assert dump_lines == g.n, (dump_lines, g.n)

        t0 = time.perf_counter()
        r_cpu = ReferenceCpuEngine(
            PageRankConfig(num_iters=iters, dtype="float64",
                           accum_dtype="float64")).build(g).run()
        t_oracle = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)

    _, norm, mass_norm = oracle_l1(r_dev, r_cpu)
    want = iters + 1 if device != "cpu" else 0
    rec = {
        "config": key,
        "kind": "e2e",
        "label": spec["label"],
        "files": files,
        "records": files * per_file,
        "n": int(g.n),
        "num_edges": int(g.num_edges),
        "iters": iters,
        "normalized_l1": norm,
        "mass_normalized_l1": mass_norm,
        "gate": GATE,
        "passed": bool(norm <= GATE and mass_norm <= GATE
                       and launches == want),
        "l1_parse_s": t_l1,
        "host_build_s": t_l2,
        "engine_build_s": t_eng_build,
        "solve_s": t_solve,
        "dumps_s": t_l4,
        "dump_work_s": t_dump_work[0],
        "dump_lines_per_s": iters * int(g.n) / t_dump_work[0],
        "records_per_sec_l1": files * per_file / t_l1,
        "k1_launches": launches,
        "gen_s": t_gen,
        "oracle_s": t_oracle,
    }
    _say(f"[{key}] {files} files / {files * per_file:,} records -> "
         f"{g.n:,} vertices / {g.num_edges:,} edges; split: gen "
         f"{t_gen:.1f}s (not part of the job), L1 {t_l1:.2f}s, host "
         f"build {t_l2:.2f}s, engine build {t_eng_build:.2f}s, solve "
         f"{t_solve:.3f}s, dumps exposed {t_l4:.2f}s (worker dump work "
         f"{t_dump_work[0]:.2f}s = {rec['dump_lines_per_s']:.4g} "
         f"lines/s; oracle {t_oracle:.1f}s); normalized L1 {norm:.3e} "
         f"(mass-normalized {mass_norm:.3e}) vs gate {GATE:g}; K1 launches "
         f"{launches} (want {want}) -> {_verdict(rec['passed'])}")
    _facts_line(key)
    return rec


# -- the in-process smokes ---------------------------------------------------


def run_fault_smoke(key: str, device: str = "cuda"):
    """F: a solve with per-iteration snapshots through a seeded
    fault-injecting filesystem, a mid-run NaN poisoning plus a corrupted
    snapshot healed by rollback, run twice with one seed: ranks within
    1e-6 of the f64 oracle, at least one fault and one rollback, the two
    fault schedules and rank vectors bit-identical. The engine is the
    port's f64 ``TorchEngine`` on ``device`` (the JAX script's is the
    CPU oracle engine)."""
    from pagerank_tpu_torch import (PageRankConfig, ReferenceCpuEngine,
                                    TorchEngine, build_graph)
    from pagerank_tpu_torch.testing.faults import (FaultInjectingFileSystem,
                                                   FaultSchedule)
    from pagerank_tpu_torch.utils import fsio
    from pagerank_tpu_torch.utils.retry import RetryPolicy
    from pagerank_tpu_torch.utils.snapshot import SinkGuard, Snapshotter

    spec = CONFIGS[key]
    seed, iters = spec["seed"], spec["iters"]
    rng = np.random.default_rng(3)
    n, e = 1500, 12000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    cfg = PageRankConfig(num_iters=iters, dtype="float64",
                         accum_dtype="float64")

    def chaos_run():
        g = build_graph(src, dst, n=n)
        inner = fsio.MemoryFileSystem()
        sched = FaultSchedule(seed=seed, fail_rate=0.08, truncate_rate=0.04,
                              max_faults=8)
        fsio.register("chaos", FaultInjectingFileSystem(
            inner, sched, sleep=lambda s: None))
        try:
            snap = Snapshotter("chaos://ck", g.fingerprint(), "reference")
            guard = SinkGuard(retry_policy=RetryPolicy(
                max_attempts=6, base_delay=0.0, seed=seed))
            eng = TorchEngine(cfg, device=device).build(g)
            orig, state = eng.step, {"fired": False}

            def step():
                info = orig()
                if eng.iteration == iters // 2 and not state["fired"]:
                    state["fired"] = True
                    with fsio.fopen(snap.path(iters // 2), "wb") as f:
                        f.write(b"corrupted mid-run")
                    eng._r = eng._r * float("nan")
                    return {k: float("nan") for k in info}
                return info

            eng.step = step
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                ranks = eng.run(
                    on_iteration=lambda i, info: guard(
                        i, lambda: snap.save(i + 1, eng.ranks())),
                    snapshotter=snap,
                )
            return ranks, list(sched.log), dict(eng.health), guard.retries
        finally:
            fsio.unregister("chaos")

    t0 = time.perf_counter()
    r1, log1, health1, retries1 = chaos_run()
    r2, log2, _, _ = chaos_run()
    oracle = ReferenceCpuEngine(cfg).build(build_graph(src, dst, n=n)).run()
    t_run = time.perf_counter() - t0
    l1 = _l1(r1, oracle)
    faults = sum(1 for _, _, _, a in log1 if a != "-")
    passed = bool(log1 == log2 and np.array_equal(r1, r2) and l1 <= GATE
                  and faults > 0 and health1["rollbacks"] >= 1)
    rec = {
        "config": key,
        "kind": "faults",
        "label": spec["label"],
        "seed": seed,
        "iters": iters,
        "faults_injected": faults,
        "write_retries": retries1,
        "rollbacks": health1["rollbacks"],
        "schedule_reproducible": bool(log1 == log2),
        "normalized_l1": l1,
        "gate": GATE,
        "seconds": t_run,
        "passed": passed,
    }
    _say(f"[{key}] seed {seed}: {faults} fault(s) injected, {retries1} "
         f"write retr(y/ies), {health1['rollbacks']} rollback(s); schedule "
         f"{'reproducible' if rec['schedule_reproducible'] else 'DIVERGED'}"
         f"; oracle L1 {l1:.3e} vs gate {GATE:g} ({t_run:.2f}s) -> "
         f"{_verdict(passed)}")
    return rec


def run_obs_smoke(key: str, device: str = "cuda", budget_s=None):
    """G: one traced CLI run on a tiny graph: exit 0, a run report with
    every section, the environment fingerprint and one solve/step span
    and history record an iteration, a strict-JSON Chrome trace with
    schema-complete events, under the budget."""
    from pagerank_tpu_torch.cli import main as cli_main
    from pagerank_tpu_torch.obs.report import REPORT_KEYS

    spec = CONFIGS[key]
    budget = OBS_SMOKE_BUDGET_S if budget_s is None else budget_s
    iters = spec["iters"]
    work = tempfile.mkdtemp(prefix="pagerank_obs_")
    t0 = time.perf_counter()
    try:
        report_path = os.path.join(work, "run_report.json")
        trace_path = os.path.join(work, "trace.json")
        rc = cli_main(["--synthetic", "uniform:400:3000", "--device", device,
                   "--iters", str(iters), "--log-every", "0",
                   "--trace", trace_path, "--run-report", report_path])
        with open(report_path) as f:
            report = _strict_json(f.read())
        with open(trace_path) as f:
            trace_doc = _strict_json(f.read())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t_run = time.perf_counter() - t0

    missing = [k for k in REPORT_KEYS if k not in report]
    env_ok = all(k in report.get("environment", {})
                 for k in ("torch_version", "backend", "device_kind",
                           "git_rev"))
    steps = report.get("spans", {}).get("solve/step", {})
    events = trace_doc.get("traceEvents", [])
    trace_ok = bool(events) and all(
        "name" in e and e.get("ph") in ("X", "i") and "ts" in e
        and "pid" in e and "tid" in e
        and ("dur" in e if e.get("ph") == "X" else True)
        for e in events)
    passed = bool(rc == 0 and not missing and env_ok and trace_ok
                  and steps.get("count") == iters
                  and len(report.get("iterations", [])) == iters
                  and t_run <= budget)
    rec = {
        "config": key,
        "kind": "obs",
        "label": spec["label"],
        "iters": iters,
        "missing_report_keys": missing,
        "env_fingerprint_ok": env_ok,
        "trace_events": len(events),
        "trace_schema_ok": trace_ok,
        "seconds": t_run,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] traced run + flight recorder in {t_run:.2f}s vs budget "
         f"{budget:g}s; report "
         f"{'complete' if not missing else 'MISSING ' + repr(missing)}; "
         f"env fingerprint {'OK' if env_ok else 'INCOMPLETE'}; "
         f"{len(events)} trace event(s) "
         f"{'schema-OK' if trace_ok else 'SCHEMA-BAD'} -> {_verdict(passed)}")
    return rec


_PROM_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})?'
    r" (?:[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|Inf)|NaN)$")
_OM_VALUE = r"(?:[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|Inf)|NaN)"
_OM_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})?'
    r" " + _OM_VALUE + r'( # \{trace_id="[^"]+"\} ' + _OM_VALUE + r")?$")


def _parse_prometheus_strict(text: str) -> int:
    """Line-by-line strict parse of the Prometheus text format; the
    sample count. Raises AssertionError on a bad line."""
    samples = 0
    for line in text.splitlines():
        if not line or line.startswith(("# HELP ", "# TYPE ")):
            continue
        assert _PROM_SAMPLE_RE.match(line), f"bad exporter line: {line!r}"
        samples += 1
    return samples


def _parse_openmetrics_strict(text: str):
    """Strict parse of the OpenMetrics rendering (``# EOF`` last,
    optional trace-id exemplars); ``(samples, exemplars)``."""
    lines = text.splitlines()
    assert lines and lines[-1] == "# EOF", "missing # EOF terminator"
    samples = exemplars = 0
    for line in lines[:-1]:
        if not line or line.startswith(("# HELP ", "# TYPE ")):
            continue
        assert _OM_SAMPLE_RE.match(line), f"bad openmetrics line: {line!r}"
        samples += 1
        exemplars += " # {" in line
    return samples, exemplars


def run_live_smoke(key: str, device: str = "cuda", budget_s=None):
    """H: one probed CLI run with the textfile exporter and the stall
    watchdog armed: probe records at the cadence in the report and its
    history, the textfile strict-parses and counts the probe points, the
    watchdog never fired, under the budget."""
    from pagerank_tpu_torch.cli import main as cli_main

    spec = CONFIGS[key]
    budget = LIVE_SMOKE_BUDGET_S if budget_s is None else budget_s
    iters, every = spec["iters"], spec["probe_every"]
    work = tempfile.mkdtemp(prefix="pagerank_live_")
    t0 = time.perf_counter()
    try:
        report_path = os.path.join(work, "run_report.json")
        textfile = os.path.join(work, "metrics.prom")
        rc = cli_main(["--synthetic", "uniform:400:3000", "--device", device,
                   "--iters", str(iters), "--log-every", "0",
                   "--probe-every", str(every), "--probe-topk", "16",
                   "--metrics-textfile", textfile,
                   "--stall-timeout", "300",
                   "--run-report", report_path])
        with open(report_path) as f:
            report = json.load(f)
        with open(textfile) as f:
            text = f.read()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t_run = time.perf_counter() - t0

    want_iters = [i for i in range(iters) if (i + 1) % every == 0]
    probes = report.get("probes") or []
    probes_ok = ([r.get("iteration") for r in probes] == want_iters
                 and all(r.get("l1_residual") is not None
                         and r.get("rank_mass") is not None
                         and r.get("topk_churn") is not None
                         for r in probes))
    history_ok = [r["iter"] for r in report.get("iterations", [])
                  if "rank_mass" in r] == want_iters
    try:
        samples = _parse_prometheus_strict(text)
        text_ok = (samples > 0
                   and f"pagerank_probe_points {len(want_iters)}" in text)
    except AssertionError as e:
        samples, text_ok = 0, False
        _say(f"[{key}] {e}")
    counters = (report.get("metrics") or {}).get("counters") or {}
    watchdog_quiet = counters.get("watchdog.stalls", 0) == 0
    passed = bool(rc == 0 and probes_ok and history_ok and text_ok
                  and watchdog_quiet and t_run <= budget)
    rec = {
        "config": key,
        "kind": "live",
        "label": spec["label"],
        "iters": iters,
        "probe_every": every,
        "probe_records_ok": probes_ok,
        "history_records_ok": history_ok,
        "exporter_samples": samples,
        "exporter_syntax_ok": text_ok,
        "watchdog_fired": not watchdog_quiet,
        "seconds": t_run,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] probed run + exporter + watchdog in {t_run:.2f}s vs "
         f"budget {budget:g}s; probe records {'OK' if probes_ok else 'BAD'}"
         f"; history {'OK' if history_ok else 'BAD'}; {samples} exporter "
         f"sample(s) {'parse OK' if text_ok else 'PARSE BAD'}; watchdog "
         f"{'quiet' if watchdog_quiet else 'FIRED'} -> {_verdict(passed)}")
    return rec


@functools.lru_cache(maxsize=None)
def _shipped_cases():
    """The PTK registry's launch cases, built once a process (K and W
    both read them)."""
    from pagerank_tpu_torch.analysis import kernels

    return tuple(kernels.shipped_cases())


#: The partitioned form's K2 entries the PTK launch cases must cover:
#: f32 and bf16 windows (the JAX script's partitioned and
#: partitioned_bf16 forms; its device_build_partitioned form packs the
#: same planes, so the same entries).
PARTITIONED_ENTRIES = ("ell_contrib_part_f32_w24", "ell_contrib_part_bf16_w24")


def run_partitioned_smoke(key: str, device: str = "cuda", budget_s=None):
    """K: a short solve on the partitioned form (K2) through the CLI
    with an explicit span and ``--probe-every``: exit 0, probe records
    at the exact cadence, and the PTK launch cases covering the
    partitioned form's K2 entries (the JAX script's contract sweep has
    no counterpart: the port traces no program), under the budget."""
    from pagerank_tpu_torch.cli import main as cli_main

    spec = CONFIGS[key]
    budget = PARTITIONED_SMOKE_BUDGET_S if budget_s is None else budget_s
    iters, every, span = spec["iters"], spec["probe_every"], spec["span"]
    work = tempfile.mkdtemp(prefix="pagerank_part_")
    t0 = time.perf_counter()
    try:
        report_path = os.path.join(work, "run_report.json")
        rc = cli_main(["--synthetic", "uniform:2048:65536", "--device", device,
                   "--iters", str(iters), "--log-every", "0",
                   "--partition-span", str(span),
                   "--probe-every", str(every), "--probe-topk", "16",
                   "--run-report", report_path])
        with open(report_path) as f:
            report = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    want_iters = [i for i in range(iters) if (i + 1) % every == 0]
    probes = report.get("probes") or []
    probes_ok = [r.get("iteration") for r in probes] == want_iters
    entries = {ln.entry for c in _shipped_cases() for ln in c.launches
               if ln.source == "ell_contrib_partitioned"}
    covered = all(e in entries for e in PARTITIONED_ENTRIES)
    t_run = time.perf_counter() - t0
    passed = bool(rc == 0 and probes_ok and covered and t_run <= budget)
    rec = {
        "config": key,
        "kind": "partitioned",
        "label": spec["label"],
        "iters": iters,
        "partition_span": span,
        "probe_records_ok": probes_ok,
        "ptk_forms_covered": covered,
        "seconds": t_run,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] partitioned solve (span {span}, probe every {every}) "
         f"in {t_run:.1f}s vs budget {budget:g}s; probes "
         f"{'OK' if probes_ok else 'BAD'}; PTK launch cases "
         f"{'cover' if covered else 'MISS'} {', '.join(PARTITIONED_ENTRIES)}"
         f" -> {_verdict(passed)}")
    return rec


def run_jobs_smoke(key: str, device: str = "cuda", budget_s=None):
    """R: a resumable job SIGTERMed in its solve by a seeded
    ``ProcessKillPlan``: exit 75 with the manifest interrupted, then the
    rerun resumes (build skipped, solve warm-started) to ranks within
    the f32 gate of the f64 oracle with ``job.resumes == 1``, both runs
    under the budget."""
    from pagerank_tpu_torch import (PageRankConfig, ReferenceCpuEngine,
                                    build_graph)
    from pagerank_tpu_torch.cli import main as cli_main
    from pagerank_tpu_torch.exitcodes import ExitCode
    from pagerank_tpu_torch.testing.faults import ProcessKillPlan
    from pagerank_tpu_torch.utils import synth

    spec = CONFIGS[key]
    budget = R_SMOKE_BUDGET_S if budget_s is None else budget_s
    scale, iters, kill_iter = spec["scale"], spec["iters"], spec["kill_iter"]
    work = tempfile.mkdtemp(prefix="pagerank_jobs_")
    job_dir = os.path.join(work, "job")
    out_path = os.path.join(work, "ranks.tsv")
    report_path = os.path.join(work, "run_report.json")
    argv = ["--synthetic", f"rmat:{scale}", "--device", device,
            "--iters", str(iters), "--job-dir", job_dir,
            "--out", out_path, "--log-every", "0"]
    plan_env = ProcessKillPlan(
        "solve", iteration=kill_iter, signum=signal.SIGTERM).to_env()
    n = 1 << scale
    t0 = time.perf_counter()
    try:
        os.environ.update(plan_env)
        try:
            rc_kill = cli_main(argv)
        finally:
            for k in plan_env:
                os.environ.pop(k, None)
        with open(os.path.join(job_dir, "job.json")) as f:
            man_killed = json.load(f)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            rc_resume = cli_main(argv + ["--run-report", report_path])
        t_run = time.perf_counter() - t0
        with open(report_path) as f:
            report = json.load(f)
        got = np.zeros(n)
        with open(out_path) as f:
            for line in f:
                k, v = line.split("\t")
                got[int(k)] = float(v)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    src, dst = synth.rmat_edges(scale)
    oracle = ReferenceCpuEngine(
        PageRankConfig(num_iters=iters, dtype="float64",
                       accum_dtype="float64")).build(
        build_graph(src, dst, n=n)).run()
    l1 = _l1(got, oracle)
    jb = report.get("job") or {}
    stages = jb.get("stages") or {}
    drained = (rc_kill == int(ExitCode.INTERRUPTED)
               and man_killed.get("status") == "interrupted")
    resumed_ok = (rc_resume == 0 and jb.get("resumes") == 1
                  and jb.get("status") == "complete"
                  and (stages.get("build") or {}).get("skipped") is True
                  and (stages.get("solve") or {}).get("skipped") is False)
    passed = bool(drained and resumed_ok and l1 <= ELASTIC_F32_GATE
                  and t_run <= budget)
    rec = {
        "config": key,
        "kind": "jobs",
        "label": spec["label"],
        "scale": scale,
        "iters": iters,
        "kill_iter": kill_iter,
        "kill_exit_code": rc_kill,
        "resume_exit_code": rc_resume,
        "drained": drained,
        "job_resumes": jb.get("resumes"),
        "stages_skipped": sorted(s for s, r in stages.items()
                                 if r.get("skipped")),
        "accuracy_l1": l1,
        "seconds": t_run,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] SIGTERM at solve iter {kill_iter}: exit {rc_kill} "
         f"({'drained' if drained else 'NOT DRAINED'}); resume exit "
         f"{rc_resume}, resumes={jb.get('resumes')}, skipped "
         f"{','.join(rec['stages_skipped']) or 'none'}; oracle L1 "
         f"{l1:.2e} vs {ELASTIC_F32_GATE:g}; {t_run:.2f}s vs budget "
         f"{budget:g}s -> {_verdict(passed)}")
    return rec


def _ptr_pass():
    """The PTR pass over the port: (program, active, waived)."""
    from pagerank_tpu_torch.analysis import concurrency as conc_mod
    from pagerank_tpu_torch.analysis.findings import (load_allowlist,
                                                      split_allowlisted)

    prog = conc_mod.build_package_program()
    findings = conc_mod.analyze_program(prog)
    allow = os.path.join(REPO, "pagerank_tpu_torch", "analysis",
                         "allowlist.txt")
    active, waived = split_allowlisted(findings, load_allowlist(allow))
    return prog, active, waived


def run_concurrency_smoke(key: str, device: str = "cuda", budget_s=None):
    """U: the PTR race pass over the port: no unwaived finding, every
    known thread root found with its label, the GracefulDrain signal
    root found, under the budget."""
    spec = CONFIGS[key]
    budget = CONCURRENCY_SMOKE_BUDGET_S if budget_s is None else budget_s
    t0 = time.perf_counter()
    prog, active, waived = _ptr_pass()
    t_run = time.perf_counter() - t0
    labels = {ts.label for ts in prog.thread_sites}
    missing_roots = sorted(THREAD_ROOTS - labels)
    signal_ok = any(r == "jobs.py::GracefulDrain._handler"
                    for _label, r in prog.signal_roots)
    ptr_waived = sum(1 for f, _w in waived if f.rule.startswith("PTR"))
    passed = bool(not active and not missing_roots and signal_ok
                  and t_run <= budget)
    rec = {
        "config": key,
        "kind": "concurrency",
        "label": spec["label"],
        "active_findings": [f.render() for f in active],
        "ptr_waived": ptr_waived,
        "thread_roots": sorted(labels),
        "missing_roots": missing_roots,
        "signal_root_ok": signal_ok,
        "seconds": t_run,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] PTR race pass in {t_run:.2f}s vs budget {budget:g}s; "
         f"{len(active)} unwaived / {ptr_waived} waived PTR finding(s); "
         f"roots {'complete' if not missing_roots else 'MISSING ' + repr(missing_roots)}"
         f"; signal root {'OK' if signal_ok else 'MISSING'} -> "
         f"{_verdict(passed)}")
    return rec


def run_kernels_smoke(key: str, device: str = "cuda", budget_s=None):
    """W: the PTK pass over the port's launch registry: no unwaived
    finding, exactly ``PTK_WAIVERS`` waived, and each seeded defect
    (F1-F6) tripping exactly its rule, under the budget. Static: nothing
    runs on the card."""
    from pagerank_tpu_torch.analysis import kernels as kernels_mod
    from pagerank_tpu_torch.analysis.findings import (load_allowlist,
                                                      split_allowlisted)

    spec = CONFIGS[key]
    budget = KERNELS_SMOKE_BUDGET_S if budget_s is None else budget_s
    t0 = time.perf_counter()
    findings = kernels_mod.check_kernel_plane(_shipped_cases())
    allow = os.path.join(REPO, "pagerank_tpu_torch", "analysis",
                         "allowlist.txt")
    active, waived = split_allowlisted(findings, load_allowlist(allow))
    fixture_bad = {}
    for case in kernels_mod.defect_cases():
        rules = sorted({f.rule for f in kernels_mod.check_kernel_case(case)})
        if rules != [KERNELS_FIXTURE_RULES[case.label]]:
            fixture_bad[case.label] = rules
    t_run = time.perf_counter() - t0
    ptk_waived = sum(1 for f, _w in waived if f.rule.startswith("PTK"))
    passed = bool(not active and not fixture_bad
                  and ptk_waived == PTK_WAIVERS and t_run <= budget)
    rec = {
        "config": key,
        "kind": "kernels",
        "label": spec["label"],
        "active_findings": [f.render() for f in active],
        "ptk_waived": ptk_waived,
        "fixtures_checked": len(KERNELS_FIXTURE_RULES),
        "fixture_mismatches": fixture_bad,
        "seconds": t_run,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] PTK kernel pass in {t_run:.2f}s vs budget {budget:g}s; "
         f"{len(active)} unwaived / {ptk_waived} waived finding(s); "
         f"fixtures "
         f"{'all trip' if not fixture_bad else 'BAD ' + repr(fixture_bad)}"
         f" -> {_verdict(passed)}")
    return rec


def run_graph_smoke(key: str, device: str = "cuda", budget_s=None):
    """S: ``obs graph --scale 14 --ndev 8 --json`` in this process:
    strict JSON, the mass ledger reconciled over every probed
    iteration, and the predicted per-rank skew within 10% of the
    measured one, under the budget. The port's ``obs graph`` measures
    nothing at ``--ndev 8`` (one process holds one rank's rows), so the
    measured per-rank edges come from the engine's own share functions:
    a ``TorchEngine`` over a world-8 mesh (``Mesh(group=None, rank=0,
    world=8)``) built on the same graph cuts its rows as a world-8 group
    does and counts each rank's real slots (``device_edges``)."""
    import contextlib
    import io

    import torch

    from pagerank_tpu_torch import PageRankConfig, TorchEngine, build_graph
    from pagerank_tpu_torch.obs import graph_profile
    from pagerank_tpu_torch.obs import metrics as obs_metrics
    from pagerank_tpu_torch.obs.__main__ import main as obs_main
    from pagerank_tpu_torch.parallel import comms
    from pagerank_tpu_torch.parallel.mesh import Mesh
    from pagerank_tpu_torch.utils import synth

    spec = CONFIGS[key]
    budget = GRAPH_SMOKE_BUDGET_S if budget_s is None else budget_s
    scale, ndev, iters = spec["scale"], spec["ndev"], spec["iters"]
    argv = ["graph", "--scale", str(scale), "--ndev", str(ndev),
            "--iters", str(iters), "--device", device, "--json"]
    obs_metrics.get_registry().reset()
    graph_profile.reset()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = obs_main(argv)
    t_run = time.perf_counter() - t0
    graph_profile.reset()

    doc, json_ok = {}, False
    try:
        doc = _strict_json(buf.getvalue())
        json_ok = {"profile", "prediction", "measured", "ledger"} <= set(doc)
    except ValueError:
        pass
    # The measured per-rank edges at world 8: obs graph's own graph
    # (rmat seed 0, edge factor 16), rank 0's share of a world-8 mesh.
    src, dst = synth.rmat_edges(scale, 16, seed=0)
    g = build_graph(src, dst, n=1 << scale)
    eng = TorchEngine(PageRankConfig(num_iters=1, num_devices=ndev),
                      device=device, mesh=Mesh(group=None, rank=0, world=ndev,
                                               device=torch.device(device))
                      ).build(g)
    counts = comms.measured_device_edges(eng, ndev)
    meas = (float(counts.max() / (counts.sum() / len(counts)))
            if counts is not None and counts.sum() else None)
    ledger = doc.get("ledger") or {}
    ledger_ok = bool(ledger.get("ok")) and ledger.get("entries", 0) >= iters
    pred = (doc.get("prediction") or {}).get("predicted_straggler_skew")
    skew_rel_err = (abs(pred - meas) / meas
                    if isinstance(pred, (int, float)) and meas else None)
    skew_ok = skew_rel_err is not None and skew_rel_err <= GRAPH_SKEW_GATE
    passed = bool(rc == 0 and json_ok and ledger_ok and skew_ok
                  and t_run <= budget)
    rec = {
        "config": key,
        "kind": "graph",
        "label": spec["label"],
        "scale": scale,
        "ndev": ndev,
        "exit_code": rc,
        "strict_json": json_ok,
        "ledger_ok": ledger_ok,
        "ledger_max_abs_residual": ledger.get("max_abs_residual"),
        "predicted_skew": pred,
        "measured_skew": meas,
        "skew_rel_err": skew_rel_err,
        "skew_gate": GRAPH_SKEW_GATE,
        "in_process": True,
        "seconds": t_run,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] obs graph scale {scale} x{ndev} ranks: rc {rc}, strict "
         f"JSON {'OK' if json_ok else 'BAD'}, ledger "
         f"{'OK' if ledger_ok else 'VIOLATED'} (max |resid| "
         f"{ledger.get('max_abs_residual')}), skew pred {pred} vs measured "
         f"{meas} (per-rank edges {None if counts is None else counts.tolist()})"
         + (f" ({skew_rel_err:.1%} vs {GRAPH_SKEW_GATE:.0%} gate)"
            if skew_rel_err is not None else " (UNMEASURED)")
         + f"; {t_run:.2f}s vs budget {budget:g}s -> {_verdict(passed)}")
    return rec


# -- the group smokes --------------------------------------------------------


def _spawn(key: str, world: int, device: str, rescue: bool = False,
           **extra):
    """Run this key's rank side (:func:`group_rank`) on ``world`` gloo
    ranks that share ``device``; returns (exit codes, {member: record},
    the spawn's wall). Each rank writes ``member<m>.json``."""
    from pagerank_tpu_torch.parallel import distributed

    work = tempfile.mkdtemp(prefix=f"pagerank_group_{key}_")
    payload = {"spec": CONFIGS[key], "out": work,
               "device": _device_of(device), **extra}
    t0 = time.perf_counter()
    try:
        codes = distributed.spawn_group(
            f"{_MODULE}:group_rank", world, payload, work, backend="gloo",
            timeout_s=120.0, deadline_s=900.0, rescue=rescue)
        reps = {}
        for m in range(world):
            path = os.path.join(work, f"member{m}.json")
            if os.path.exists(path):
                with open(path) as f:
                    reps[m] = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return codes, reps, time.perf_counter() - t0


def group_rank(payload) -> int:
    """A rank of a group smoke (``spawn_group`` target): runs the key's
    rank side and writes ``member<m>.json``."""
    import torch

    from pagerank_tpu_torch.parallel import distributed

    rank, world = distributed.process_info()
    torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1) // world)))
    kind = payload["spec"]["kind"]
    rep = _RANK_SIDES[kind](payload, rank, world)
    me = distributed.member()
    with open(os.path.join(payload["out"], f"member{me}.json"), "w") as f:
        json.dump(rep, f)
    return 0


def _counters(report, prefix):
    counters = (report.get("metrics") or {}).get("counters") or {}
    return {k: v for k, v in counters.items() if k.startswith(prefix)}


def _rank_elastic(payload, rank, world):
    """L's rank side: a snapshotted f32 ElasticRunner solve with member
    ``kill_device`` lost at ``kill_iter``."""
    from pagerank_tpu_torch import PageRankConfig, TorchEngine, build_graph, obs
    from pagerank_tpu_torch.parallel.elastic import (
        DeviceHealthMonitor, ElasticExhaustedError, ElasticRunner,
        RankLeftError, snapshot_meta_after)
    from pagerank_tpu_torch.testing.faults import (DeviceFaultSchedule,
                                                   install_device_faults)
    from pagerank_tpu_torch.utils.snapshot import Snapshotter

    from pagerank_tpu_torch.ops import ell_spmv

    spec, dev = payload["spec"], payload["device"]
    iters = spec["iters"]
    src, dst, n = _elastic_graph()
    g = build_graph(src, dst, n=n)
    cfg = PageRankConfig(num_iters=iters, dtype="float32",
                         accum_dtype="float32", num_devices=world)
    obs.disable_tracing()
    obs.get_registry().reset()
    tracer = obs.enable_tracing()
    snap = Snapshotter(os.path.join(payload["out"], "snaps"),
                       g.fingerprint(), "reference")
    sched = DeviceFaultSchedule(seed=spec["seed"],
                                kill={spec["kill_iter"]: payload["victim"]})
    eng = TorchEngine(cfg, device=dev).build(g)
    install_device_faults(eng, sched)
    box = {}
    # The budget times the chaos run itself: solve, kill, roll call,
    # regroup, rebuild and warm start; not the first build above.
    t0 = time.perf_counter()

    def factory(members):
        return TorchEngine(cfg.replace(num_devices=len(members)),
                           device=dev).build(g)

    def rebound(e2):
        install_device_faults(e2, sched)
        snap.mesh_meta = snapshot_meta_after(e2, box["runner"])

    runner = ElasticRunner(eng, factory, snapshotter=snap, max_rescues=2,
                           monitor=DeviceHealthMonitor(), on_rebuild=rebound,
                           liveness_timeout_s=20.0)
    box["runner"] = runner
    snap.mesh_meta = snapshot_meta_after(eng, runner)

    def on_iteration(i, info):
        e2 = runner.engine
        r = e2.ranks()
        if e2.mesh.rank == 0:
            snap.save(i + 1, r)

    rep = {"status": "ok"}
    # K1's launches in this rank's chaos run (0 on the CPU, which runs
    # K1's plain version): one a step it took, none for a build.
    ell_spmv.launches = 0
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            rep["ranks"] = runner.run(on_iteration=on_iteration).tolist()
    except RankLeftError:
        rep["status"] = "left"
    except ElasticExhaustedError:
        rep["status"] = "exhausted"
    rep["seconds"] = time.perf_counter() - t0
    rep["k1_launches"] = ell_spmv.launches
    report = obs.build_run_report(
        config=cfg, tracer=tracer, registry=obs.get_registry(),
        robustness={"rescues": runner.rescues,
                    "lost_devices": runner.lost_device_ids})
    obs.disable_tracing()
    rep.update(rescues=runner.rescues, members=runner.engine.device_ids(),
               lost=list(runner.lost_device_ids),
               rescue_span="elastic/rescue" in (report.get("spans") or {}),
               counters=_counters(report, "elastic."),
               walls=runner.rescue_walls)
    return rep


def _oracle_small(src, dst, n, iters, semantics="reference"):
    from pagerank_tpu_torch import (PageRankConfig, ReferenceCpuEngine,
                                    build_graph)

    return ReferenceCpuEngine(PageRankConfig(
        num_iters=iters, dtype="float64", accum_dtype="float64",
        semantics=semantics)).build(build_graph(src, dst, n=n)).run()


def _elastic_graph():
    rng = np.random.default_rng(9)
    n, e = 1024, 8192
    return rng.integers(0, n, e), rng.integers(0, n, e), n


def run_elastic_smoke(key: str, device: str = "cuda", budget_s=None):
    """L: an f32 solve over three gloo ranks on the card, snapshotted
    every iteration, with member 2 lost at iteration 6: one rescue, the
    solve finishes on the two survivors within the f32 gate of the f64
    oracle, the elastic/rescue span and the elastic.* counters in the
    report, the chaos run under the budget (the spawn is printed
    apart). On a card each member's K1 launches are its steps: every
    step for a survivor (none recomputed after the rescue), the steps
    before ``kill_iter`` for the victim."""
    spec = CONFIGS[key]
    budget = ELASTIC_SMOKE_BUDGET_S if budget_s is None else budget_s
    iters, kill_iter = spec["iters"], spec["kill_iter"]
    codes, reps, t_spawn = _spawn(key, LOSS_WORLD, device, rescue=True,
                                  victim=LOSS_MEMBER)
    r0 = reps.get(0) or {}
    victim = reps.get(LOSS_MEMBER) or {}
    launches = {m: (reps.get(m) or {}).get("k1_launches")
                for m in range(LOSS_WORLD)}
    # The CPU runs K1's plain version, which counts nothing.
    want = ({m: kill_iter if m == LOSS_MEMBER else iters
             for m in range(LOSS_WORLD)} if device != "cpu"
            else dict.fromkeys(range(LOSS_WORLD), 0))
    src, dst, n = _elastic_graph()
    oracle = _oracle_small(src, dst, n, iters)
    ranks = np.asarray(r0.get("ranks") or np.zeros(n))
    l1 = _l1(ranks, oracle)
    counters = r0.get("counters") or {}
    t_run = float(r0.get("seconds", float("inf")))
    surviving = len(r0.get("members") or [])
    passed = bool(
        list(codes) == [0] * LOSS_WORLD
        and r0.get("status") == "ok" and victim.get("status") == "left"
        and r0.get("rescues") == 1
        and surviving == LOSS_WORLD - 1
        and l1 <= ELASTIC_F32_GATE
        and r0.get("rescue_span")
        and counters.get("elastic.rescues") == 1
        and counters.get("elastic.devices_lost") == 1
        and launches == want
        and t_run <= budget)
    rec = {
        "config": key,
        "kind": "elastic",
        "label": spec["label"],
        "iters": iters,
        "devices": LOSS_WORLD,
        "kill": {"iteration": kill_iter, "device": LOSS_MEMBER},
        "rescues": r0.get("rescues"),
        "surviving_devices": surviving,
        "normalized_l1": l1,
        "gate": ELASTIC_F32_GATE,
        "rescue_span_ok": bool(r0.get("rescue_span")),
        "elastic_counters": counters,
        "k1_launches": launches,
        "seconds": t_run,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] kill member {LOSS_MEMBER} @ iter {kill_iter} on "
         f"{LOSS_WORLD} gloo ranks ({device}): exit codes {list(codes)}, "
         f"{r0.get('rescues')} rescue(s), finished on {surviving} rank(s) "
         f"{r0.get('members')}; oracle L1 {l1:.3e} vs gate "
         f"{ELASTIC_F32_GATE:g}; rescue span "
         f"{'OK' if r0.get('rescue_span') else 'MISSING'}; counters "
         f"{sorted(counters)}; K1 launches by member {launches} (want "
         f"{want}); rescue walls {r0.get('walls')}; {t_run:.2f}s "
         f"vs budget {budget:g}s (spawn {t_spawn:.1f}s) -> {_verdict(passed)}")
    return rec


def _rank_sdc(payload, rank, world):
    """V's rank side: a checked f32 solve with a sticky mantissa flip on
    member ``flip_device`` at ``flip_iter``."""
    from pagerank_tpu_torch import PageRankConfig, TorchEngine, build_graph, obs
    from pagerank_tpu_torch import sdc as sdc_mod
    from pagerank_tpu_torch.parallel.elastic import (DeviceHealthMonitor,
                                                     ElasticExhaustedError,
                                                     ElasticRunner,
                                                     RankLeftError)
    from pagerank_tpu_torch.testing.faults import (DeviceFaultSchedule,
                                                   install_device_faults)

    spec, dev = payload["spec"], payload["device"]
    src, dst, n = _elastic_graph()
    g = build_graph(src, dst, n=n)
    cfg = PageRankConfig(num_iters=spec["iters"], dtype="float32",
                         accum_dtype="float32", num_devices=world,
                         sdc_check_every=1)
    obs.disable_tracing()
    obs.get_registry().reset()
    sdc_mod.reset()
    tracer = obs.enable_tracing()
    sched = DeviceFaultSchedule(
        seed=spec["seed"],
        flip={spec["flip_iter"]: (payload["victim"], "mantissa")},
        sticky_flips=[spec["flip_iter"]])
    eng = TorchEngine(cfg, device=dev).build(g)
    install_device_faults(eng, sched)
    t0 = time.perf_counter()

    def factory(members):
        return TorchEngine(cfg.replace(num_devices=len(members)),
                           device=dev).build(g)

    runner = ElasticRunner(
        eng, factory, snapshotter=None, max_rescues=2,
        monitor=DeviceHealthMonitor(), liveness_timeout_s=20.0,
        on_rebuild=lambda e2: install_device_faults(e2, sched))
    rep = {"status": "ok"}
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            rep["ranks"] = runner.run().tolist()
    except RankLeftError:
        rep["status"] = "left"
    except ElasticExhaustedError:
        rep["status"] = "exhausted"
    rep["seconds"] = time.perf_counter() - t0
    rep["k1_launches"] = ell_spmv.launches
    report = obs.build_run_report(
        config=cfg, tracer=tracer, registry=obs.get_registry(),
        extra={"sdc": sdc_mod.report_section()})
    obs.disable_tracing()
    rep.update(
        rescues=runner.rescues, members=runner.engine.device_ids(),
        quarantined=list(runner.quarantined_device_ids),
        localized=((report.get("sdc") or {}).get("last_breach")
                   or {}).get("device"),
        counters=_counters(report, "sdc."))
    return rep


def run_sdc_smoke(key: str, device: str = "cuda", budget_s=None):
    """V: a checked f32 solve over three gloo ranks with a sticky
    mantissa flip on member 2 at iteration 5: detected, localized to
    member 2, convicted sticky, quarantined through the elastic rescue,
    finished on two ranks within the f32 gate, the sdc.* counters in
    the report, under the budget."""
    spec = CONFIGS[key]
    budget = SDC_SMOKE_BUDGET_S if budget_s is None else budget_s
    iters, flip_iter = spec["iters"], spec["flip_iter"]
    codes, reps, t_spawn = _spawn(key, LOSS_WORLD, device, rescue=True,
                                  victim=LOSS_MEMBER)
    r0 = reps.get(0) or {}
    src, dst, n = _elastic_graph()
    oracle = _oracle_small(src, dst, n, iters)
    ranks = np.asarray(r0.get("ranks") or np.zeros(n))
    l1 = _l1(ranks, oracle)
    counters = r0.get("counters") or {}
    t_run = float(r0.get("seconds", float("inf")))
    surviving = len(r0.get("members") or [])
    passed = bool(
        list(codes) == [0] * LOSS_WORLD
        and counters.get("sdc.flips_detected", 0) >= 1
        and counters.get("sdc.quarantined_devices") == 1
        and r0.get("localized") == LOSS_MEMBER
        and r0.get("quarantined") == [LOSS_MEMBER]
        and r0.get("rescues") == 1
        and surviving == LOSS_WORLD - 1
        and l1 <= ELASTIC_F32_GATE
        and t_run <= budget)
    rec = {
        "config": key,
        "kind": "sdc",
        "label": spec["label"],
        "iters": iters,
        "devices": LOSS_WORLD,
        "flip": {"iteration": flip_iter, "device": LOSS_MEMBER,
                 "kind": "mantissa", "sticky": True},
        "localized_device": r0.get("localized"),
        "quarantined": r0.get("quarantined"),
        "rescues": r0.get("rescues"),
        "surviving_devices": surviving,
        "normalized_l1": l1,
        "gate": ELASTIC_F32_GATE,
        "sdc_counters": counters,
        "seconds": t_run,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] sticky mantissa flip on member {LOSS_MEMBER} @ iter "
         f"{flip_iter} over {LOSS_WORLD} gloo ranks ({device}): exit codes "
         f"{list(codes)}, detected {counters.get('sdc.flips_detected', 0)}, "
         f"localized to member {r0.get('localized')}, quarantined "
         f"{r0.get('quarantined')}, finished on {surviving} rank(s); oracle "
         f"L1 {l1:.3e} vs gate {ELASTIC_F32_GATE:g}; {t_run:.2f}s vs budget "
         f"{budget:g}s (spawn {t_spawn:.1f}s) -> {_verdict(passed)}")
    return rec


def _halo_cfg(spec, world, **extra):
    from pagerank_tpu_torch import PageRankConfig

    return PageRankConfig(num_iters=spec["iters"], dtype="float32",
                          accum_dtype="float32", num_devices=world,
                          vertex_sharded=True, halo_exchange=True, **extra)


def _halo_graph(scale):
    from pagerank_tpu_torch import build_graph
    from pagerank_tpu_torch.utils.synth import rmat_edges

    src, dst = rmat_edges(scale, 8, seed=4)
    return src, dst, build_graph(src, dst, n=1 << scale)


def _rank_halo(payload, rank, world):
    """M's and X's rank side: a vertex-sharded f32 solve through the
    halo exchange (X: the async lag-1 form, textbook semantics)."""
    from pagerank_tpu_torch import TorchEngine, obs
    from pagerank_tpu_torch.obs import metrics as obs_metrics

    spec, dev = payload["spec"], payload["device"]
    _, _, g = _halo_graph(spec["scale"])
    obs.get_registry().reset()
    extra = {}
    if spec["kind"] == "halo_async":
        extra = dict(halo_async=True, halo_async_min_gain=0.0,
                     semantics="textbook")
    eng = TorchEngine(_halo_cfg(spec, world, **extra), device=dev).build(g)
    li = eng.layout_info()
    cm = eng.comms_model() or {}
    ctr = obs_metrics.counter("comms.bytes_exchanged")
    c0 = ctr.value
    t0 = time.perf_counter()
    ranks = eng.run_fast()
    t_run = time.perf_counter() - t0
    snap = obs.get_registry().snapshot()
    return {"ranks": ranks.tolist(), "seconds": t_run,
            "form": li.get("form"), "halo_async": str(li.get("halo_async", "")),
            "measured": int(ctr.value - c0),
            "model": {k: cm.get(k) for k in (
                "sparse_bytes_per_iter", "dense_bytes_per_iter",
                "bytes_per_iter", "overlappable_bytes_per_iter",
                "halo_fraction", "head_k")},
            "counters": sorted(snap.get("counters", {})),
            "gauges": {k: v for k, v in snap.get("gauges", {}).items()
                       if k.startswith("comms.")}}


def run_halo_smoke(key: str, device: str = "cuda", budget_s=None):
    """M: a vertex-sharded f32 solve over two gloo ranks on the card
    through the halo exchange: the vs_halo form, the f32 oracle gate,
    the measured exchanged bytes = iters x the sparse model and below
    the dense model, the comms.* metrics present, the solve under the
    budget."""
    spec = CONFIGS[key]
    budget = HALO_SMOKE_BUDGET_S if budget_s is None else budget_s
    scale, iters = spec["scale"], spec["iters"]
    codes, reps, t_spawn = _spawn(key, GROUP_WORLD, device)
    r0 = reps.get(0) or {}
    src, dst, _ = _halo_graph(scale)
    oracle = _oracle_small(src, dst, 1 << scale, iters)
    l1 = _l1(np.asarray(r0.get("ranks") or np.zeros(1 << scale)), oracle)
    cm = r0.get("model") or {}
    sparse = int(cm.get("sparse_bytes_per_iter") or 0)
    dense = int(cm.get("dense_bytes_per_iter") or 0)
    measured = int(r0.get("measured") or 0)
    comms_visible = ("comms.bytes_exchanged" in (r0.get("counters") or [])
                     and "comms.halo_fraction" in (r0.get("gauges") or {}))
    t_run = float(r0.get("seconds", float("inf")))
    form = r0.get("form")
    passed = bool(list(codes) == [0] * GROUP_WORLD and form == "vs_halo"
                  and l1 <= ELASTIC_F32_GATE and 0 < sparse < dense
                  and measured == sparse * iters and comms_visible
                  and t_run <= budget)
    rec = {
        "config": key,
        "kind": "halo",
        "label": spec["label"],
        "scale": scale,
        "iters": iters,
        "devices": GROUP_WORLD,
        "form": form,
        "normalized_l1": l1,
        "gate": ELASTIC_F32_GATE,
        "sparse_bytes_per_iter": sparse,
        "dense_bytes_per_iter": dense,
        "measured_bytes": measured,
        "halo_fraction": cm.get("halo_fraction"),
        "head_k": cm.get("head_k"),
        "comms_metrics_ok": comms_visible,
        "seconds": t_run,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] sparse exchange over {GROUP_WORLD} gloo ranks ({device}; "
         f"scale {scale}, {iters} iters): exit codes {list(codes)}, form "
         f"{form}; oracle L1 {l1:.3e} vs gate {ELASTIC_F32_GATE:g}; "
         f"bytes/iter {sparse:,} sparse < {dense:,} dense "
         f"({'OK' if 0 < sparse < dense else 'BAD'}), measured "
         f"{measured:,}; comms metrics "
         f"{'OK' if comms_visible else 'MISSING'}; {t_run:.3f}s vs budget "
         f"{budget:g}s (spawn {t_spawn:.1f}s) -> {_verdict(passed)}")
    return rec


def run_halo_async_smoke(key: str, device: str = "cuda", budget_s=None):
    """X: a textbook f32 solve over two gloo ranks through the async
    lag-1 halo exchange: the vs_halo_async form with its gate open, the
    f32 gate against the textbook oracle, the measured bytes = iters x
    the model with overlappable bytes, and the PTR pass clean, the
    solve under the budget. The JAX script's vs_halo_async contract
    sweep has no counterpart (the port traces no program)."""
    spec = CONFIGS[key]
    budget = HALO_ASYNC_SMOKE_BUDGET_S if budget_s is None else budget_s
    scale, iters = spec["scale"], spec["iters"]
    codes, reps, t_spawn = _spawn(key, GROUP_WORLD, device)
    r0 = reps.get(0) or {}
    src, dst, _ = _halo_graph(scale)
    oracle = _oracle_small(src, dst, 1 << scale, iters, "textbook")
    l1 = _l1(np.asarray(r0.get("ranks") or np.zeros(1 << scale)), oracle)
    _, active, _ = _ptr_pass()
    cm = r0.get("model") or {}
    model = int(cm.get("bytes_per_iter") or 0)
    overlappable = int(cm.get("overlappable_bytes_per_iter") or 0)
    measured = int(r0.get("measured") or 0)
    form, async_state = r0.get("form"), r0.get("halo_async") or ""
    predicted_gain = (r0.get("gauges") or {}).get(
        "comms.predicted_overlap_gain")
    t_run = float(r0.get("seconds", float("inf")))
    passed = bool(list(codes) == [0] * GROUP_WORLD
                  and form == "vs_halo_async"
                  and async_state.startswith("on:")
                  and l1 <= ELASTIC_F32_GATE and model > 0
                  and measured == model * iters and overlappable > 0
                  and not active and t_run <= budget)
    rec = {
        "config": key,
        "kind": "halo_async",
        "label": spec["label"],
        "scale": scale,
        "iters": iters,
        "devices": GROUP_WORLD,
        "form": form,
        "halo_async": async_state,
        "normalized_l1": l1,
        "gate": ELASTIC_F32_GATE,
        "bytes_per_iter": model,
        "overlappable_bytes_per_iter": overlappable,
        "measured_bytes": measured,
        "predicted_overlap_gain": predicted_gain,
        "ptr_unwaived": len(active),
        "seconds": t_run,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] async stale-boundary exchange over {GROUP_WORLD} gloo "
         f"ranks ({device}; scale {scale}, {iters} iters, textbook): exit "
         f"codes {list(codes)}, form {form} ({async_state}); oracle L1 "
         f"{l1:.3e} vs gate {ELASTIC_F32_GATE:g}; measured {measured:,} == "
         f"{iters} x {model:,} model "
         f"({'OK' if measured == model * iters else 'BAD'}, "
         f"{overlappable:,} overlappable); PTR {len(active)} unwaived; "
         f"{t_run:.3f}s vs budget {budget:g}s (spawn {t_spawn:.1f}s) -> "
         f"{_verdict(passed)}")
    return rec


def _rank_devices(payload, rank, world):
    """O's rank side: an attributed vertex-sharded halo solve with the
    device sampler armed."""
    from pagerank_tpu_torch import TorchEngine, obs
    from pagerank_tpu_torch.obs import devices as obs_devices
    from pagerank_tpu_torch.obs import live as obs_live
    from pagerank_tpu_torch.parallel import mesh as mesh_lib

    spec, dev = payload["spec"], payload["device"]
    _, _, g = _halo_graph(spec["scale"])
    obs.get_registry().reset()
    obs.disarm_sampler()
    eng = TorchEngine(_halo_cfg(spec, world), device=dev).build(g)
    cm = eng.comms_model() or {}
    obs.arm_sampler(obs.DeviceSampler(every=2, devices=[eng.device]))
    try:
        t0 = time.perf_counter()
        eng.run()
        att = obs_devices.attribute_exchange(eng, iters=4, warmup=1)
        t_run = time.perf_counter() - t0
    finally:
        sampler = obs.disarm_sampler()
    gauges = obs.get_registry().snapshot()["gauges"]
    try:
        _parse_prometheus_strict(obs_live.render_prometheus())
        prom_ok = True
    except AssertionError:
        prom_ok = False
    return {"seconds": t_run, "attribution": att,
            "model_bytes_per_iter": cm.get("bytes_per_iter"),
            "gauges": {k: v for k, v in gauges.items()
                       if k.startswith("comms.")},
            "sampled_ids": sorted(
                int(k.split(".")[1]) for k in gauges
                if k.startswith("device.") and k.endswith(".bytes_in_use")),
            "device_id": mesh_lib.device_id(eng.device),
            "samples": sampler.samples if sampler is not None else 0,
            "prom_ok": prom_ok}


def run_devices_smoke(key: str, device: str = "cuda", budget_s=None):
    """O: an attributed vertex-sharded halo solve over two gloo ranks on
    the card: the attribution block present and consistent with the
    comms model (comms.exchange_fraction and achieved_bytes_per_sec
    published), the device sampler's gauges of the rank's card
    registered and the exporter strict-parsing, and the fit check
    passing at scale 14 while refusing scale 26; the solve and the
    attribution under the budget."""
    from pagerank_tpu_torch.obs import devices as obs_devices

    spec = CONFIGS[key]
    budget = DEVICES_SMOKE_BUDGET_S if budget_s is None else budget_s
    scale, iters = spec["scale"], spec["iters"]
    codes, reps, t_spawn = _spawn(key, GROUP_WORLD, device)
    r0 = reps.get(0) or {}
    att = r0.get("attribution")
    gauges = r0.get("gauges") or {}
    att_ok = bool(
        att is not None and att["mode"] == "sparse"
        and att["exchange_s"] > 0 and att["step_s"] > 0
        and 0 <= att["exchange_fraction"] <= 1
        and att["model_bytes_per_iter"] == r0.get("model_bytes_per_iter")
        and att["achieved_bytes_per_sec"] > 0
        and gauges.get("comms.exchange_fraction") == att["exchange_fraction"]
        and "comms.achieved_bytes_per_sec" in gauges)
    sampled_ids = r0.get("sampled_ids") or []
    sampler_ok = bool(sampled_ids == [r0.get("device_id")]
                      and r0.get("samples", 0) >= iters // 2
                      and r0.get("prom_ok"))
    kind = None
    if device != "cpu":
        import torch

        kind = torch.cuda.get_device_name(0)
    fit_ok = obs_devices.fit_check(spec["fit_ok_scale"], device_kind=kind)
    fit_bad = obs_devices.fit_check(spec["fit_bad_scale"], device_kind=kind)
    fit_verdicts_ok = bool(fit_ok.fits and not fit_bad.fits)
    t_run = float(r0.get("seconds", float("inf")))
    passed = bool(list(codes) == [0] * GROUP_WORLD and att_ok and sampler_ok
                  and fit_verdicts_ok and t_run <= budget)
    rec = {
        "config": key,
        "kind": "devices",
        "label": spec["label"],
        "scale": scale,
        "iters": iters,
        "devices": GROUP_WORLD,
        "attribution": {k: att.get(k) for k in (
            "exchange_s", "step_s", "exchange_fraction",
            "achieved_bytes_per_sec", "mode")} if att else None,
        "attribution_ok": att_ok,
        "sampler_ok": sampler_ok,
        "sampled_devices": sampled_ids,
        "fit_ok_scale": spec["fit_ok_scale"],
        "fit_bad_scale": spec["fit_bad_scale"],
        "fit_verdicts_ok": fit_verdicts_ok,
        "seconds": t_run,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] attributed halo solve over {GROUP_WORLD} gloo ranks "
         f"({device}; scale {scale}, {iters} iters): exit codes "
         f"{list(codes)}, attribution {'OK' if att_ok else 'BAD'}"
         + (f" (exchange {att['exchange_fraction']:.0%} of step)"
            if att else "")
         + f"; sampler {'OK' if sampler_ok else 'BAD'} (devices "
         f"{sampled_ids}, exporter {'parses' if r0.get('prom_ok') else 'BROKEN'}"
         f"); fit scale {spec['fit_ok_scale']} "
         f"{'fits' if fit_ok.fits else 'REFUSED'} / scale "
         f"{spec['fit_bad_scale']} "
         f"{'refused' if not fit_bad.fits else 'ACCEPTED (BAD)'}; "
         f"{t_run:.3f}s vs budget {budget:g}s (spawn {t_spawn:.1f}s) -> "
         f"{_verdict(passed)}")
    return rec


def _serve_config(cache_capacity=64):
    """The JAX smokes' serving config: the batch-wall model frozen, so
    every admission decision is a function of the seed and the virtual
    clock."""
    from pagerank_tpu_torch.serving import ServeConfig

    return ServeConfig(max_batch=4, queue_depth=16, deadline_ms=400.0,
                       topk=8, wall_alpha=0.0, wall_initial_s=0.05,
                       cache_capacity=cache_capacity, batch_margin_s=0.01)


def _serve_graph():
    from pagerank_tpu_torch import build_graph
    from pagerank_tpu_torch.utils import synth

    src, dst = synth.rmat_edges(8, edge_factor=8, seed=3)
    return build_graph(src, dst, n=256)


def _rank_serve(payload, rank, world):
    """Y's and Z's rank side: the seeded chaos load twice, each run in a
    group generation of its own over every member (``reform``). Rank 0
    serves on a virtual clock with member ``victim`` lost at batch
    ``kill_batch`` (the load harness's fault shim) and a drain at query
    ``drain_at``; the others follow. Z arms the query plane per run."""
    from pagerank_tpu_torch import PageRankConfig, obs
    from pagerank_tpu_torch.obs import live as obs_live
    from pagerank_tpu_torch.parallel import distributed
    from pagerank_tpu_torch.parallel.elastic import (ElasticExhaustedError,
                                                     RankLeftError)
    from pagerank_tpu_torch.serving import PprServer, qtrace
    from pagerank_tpu_torch.testing.faults import DeviceFaultSchedule
    from pagerank_tpu_torch.testing.load import (QueryLoadGenerator,
                                                 install_serve_faults,
                                                 run_serve_load)
    from pagerank_tpu_torch.testing.schedules import VirtualClock

    spec, dev, out = payload["spec"], payload["device"], payload["out"]
    armed = spec["kind"] == "qtrace"
    g = _serve_graph()
    obs.disable_tracing()
    obs.get_registry().reset()
    tracer = obs.enable_tracing()
    runs, statuses = [], []
    for k in range(2):
        distributed.reform(100 * (k + 1), range(world))
        plane = None
        if armed:
            plane = qtrace.arm_query_plane(
                slow_query_ms=0.0,
                slow_query_path=os.path.join(payload.get("logs", out),
                                             f"slow{k + 1}.jsonl"))
        try:
            cfg = PageRankConfig(num_iters=spec["iters"],
                                 num_devices=distributed.process_info()[1])
            srv = PprServer(g, config=cfg, serve_config=_serve_config(),
                            devices=[dev], clock=VirtualClock())
            if distributed.process_info()[0] != 0:
                try:
                    srv.follow()
                    statuses.append("stopped")
                except RankLeftError:
                    statuses.append("left")
                except ElasticExhaustedError:
                    statuses.append("terminal")
                continue
            clock = srv._clock
            sched = DeviceFaultSchedule(
                seed=spec["seed"],
                kill={spec["kill_batch"]: payload["victim"]})
            srv.start(dispatcher=False)
            install_serve_faults(srv, sched, clock=clock, service_s=0.05)
            plan = QueryLoadGenerator(seed=spec["seed"],
                                      num_queries=spec["queries"], n=256,
                                      mean_gap_s=0.02, k=8).plan()
            t0 = time.perf_counter()
            rep = run_serve_load(srv, clock, plan, drain_at=spec["drain_at"],
                                 drain_deadline_s=1.0)
            rep["seconds"] = time.perf_counter() - t0
            if plane is not None:
                rep["slow_count"] = plane.slow_count
                rep["phase_p99_ms"] = plane.phase_p99_ms()
            rep["admission_log"] = [list(e) for e in rep["admission_log"]]
            rep.pop("latencies_ms", None)
            runs.append(rep)
            statuses.append("served")
        finally:
            if armed:
                qtrace.disarm_query_plane()
    out_rep = {"statuses": statuses, "runs": runs}
    if runs:
        report = obs.build_run_report(tracer=tracer,
                                      registry=obs.get_registry())
        out_rep["counters"] = _counters(report, "serve.")
        if armed:
            out_rep["openmetrics"] = obs_live.render_openmetrics()
    obs.disable_tracing()
    return out_rep


def _sigterm_drain(g, device, armed):
    """The real-SIGTERM drain through the installed handler, on a
    one-device server in this process: (drained, the query before the
    signal, the query after it, the run report's serving section)."""
    from pagerank_tpu_torch import PageRankConfig, jobs, obs
    from pagerank_tpu_torch.serving import PprServer, qtrace
    from pagerank_tpu_torch.testing.schedules import VirtualClock

    cfg = PageRankConfig(num_iters=CONFIGS["Y"]["iters"])
    obs.disable_tracing()
    tracer = obs.enable_tracing()
    if armed:
        qtrace.arm_query_plane()
    try:
        clock = VirtualClock()
        srv = PprServer(g, config=cfg, serve_config=_serve_config(0),
                        devices=[device], clock=clock)
        srv.start(dispatcher=False)
        drained = False
        with jobs.GracefulDrain(deadline_s=5.0) as drain:
            q_before = srv.submit(5, k=4)
            clock.advance(0.36)  # inside the close margin, before expiry
            srv.pump()
            os.kill(os.getpid(), signal.SIGTERM)
            try:
                drain.check("serve-smoke")
            except jobs.DrainInterrupt:
                srv.drain(deadline_s=drain.remaining())
                drained = True
            q_after = srv.submit(6, k=4)
            drain.finish()
        report = obs.build_run_report(config=cfg, tracer=tracer,
                                      registry=obs.get_registry())
    finally:
        obs.disable_tracing()
        if armed:
            qtrace.disarm_query_plane()
    return drained, q_before, q_after, report.get("serving") or {}


def _device_of(device: str) -> str:
    return "cuda:0" if device.startswith("cuda") else device


def run_serve_smoke(key: str, device: str = "cuda", budget_s=None):
    """Y: the PPR daemon over three gloo ranks on the card under the
    seeded chaos load: member 2 lost at batch 3, a rescue and re-run of
    the in-flight batch, a drain at query 34; every query in a typed
    outcome, a second same-seed run (a fresh generation of the group)
    bit-identical (admission log and result digest), one rescue and at
    least one re-run a run in the serve.* counters; then a real SIGTERM
    drain through the installed handler (on one device, in this
    process); the first chaos run under the budget (the spawn is
    printed apart)."""
    spec = CONFIGS[key]
    budget = SERVE_SMOKE_BUDGET_S if budget_s is None else budget_s
    codes, reps, t_spawn = _spawn(key, LOSS_WORLD, device, rescue=True,
                                  victim=LOSS_MEMBER)
    r0 = reps.get(0) or {}
    runs = r0.get("runs") or []
    r1, r2 = (runs + [{}, {}])[:2]
    drained, q_before, q_after, _ = _sigterm_drain(
        _serve_graph(), _device_of(device), armed=False)
    sigterm_ok = bool(drained and q_before.outcome == "answered"
                      and q_after.outcome == "rejected_draining")
    serve_counters = r0.get("counters") or {}
    outcomes_seen = set(r1.get("outcomes", {})) | set(r2.get("outcomes", {}))
    accounted = bool(len(runs) == 2 and r1["unsettled"] == 0
                     and r2["unsettled"] == 0
                     and outcomes_seen <= SERVE_OUTCOMES)
    replay_ok = bool(runs and r1.get("results_digest")
                     == r2.get("results_digest")
                     and r1.get("admission_log") == r2.get("admission_log"))
    seconds = float(r1.get("seconds", float("inf")))
    passed = bool(
        list(codes) == [0] * LOSS_WORLD
        and accounted and replay_ok
        and r1.get("degraded") and r1.get("device_count") == LOSS_WORLD - 1
        and r1.get("outcomes", {}).get("rejected_draining", 0) >= 1
        and serve_counters.get("serve.rescues") == 2
        and serve_counters.get("serve.batch_reruns", 0) >= 2
        and sigterm_ok and seconds <= budget)
    rec = {
        "config": key,
        "kind": "serve",
        "label": spec["label"],
        "devices": LOSS_WORLD,
        "queries": spec["queries"],
        "kill": {"batch": spec["kill_batch"], "device": LOSS_MEMBER},
        "outcomes": dict(r1.get("outcomes", {})),
        "unsettled": r1.get("unsettled", 0) + r2.get("unsettled", 0),
        "degraded": r1.get("degraded"),
        "surviving_devices": r1.get("device_count"),
        "replay_identical": replay_ok,
        "sigterm_drain_ok": sigterm_ok,
        "serve_counters": serve_counters,
        "seconds": seconds,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] {spec['queries']} queries over {LOSS_WORLD} gloo ranks "
         f"({device}), member {LOSS_MEMBER} lost @ batch "
         f"{spec['kill_batch']}: exit codes {list(codes)}, followers "
         f"{[reps.get(m, {}).get('statuses') for m in range(1, LOSS_WORLD)]}"
         f", outcomes {dict(sorted(rec['outcomes'].items()))}, finished on "
         f"{r1.get('device_count')} rank(s); replay "
         f"{'bit-identical' if replay_ok else 'DIVERGED'}; SIGTERM drain "
         f"{'OK' if sigterm_ok else 'BAD'}; counters "
         f"{sorted(serve_counters)}; {seconds:.2f}s vs budget {budget:g}s "
         f"(spawn {t_spawn:.1f}s) -> {_verdict(passed)}")
    return rec


def _slow_log_ok(text: str, expect: int) -> bool:
    """Strict-JSONL schema gate on one slow-query log."""
    from pagerank_tpu_torch.serving import qtrace

    count = 0
    for line in text.splitlines():
        rec = _strict_json(line)
        if (set(rec) != set(qtrace.SLOW_QUERY_KEYS)
                or rec["type"] != "slow_query"
                or not (isinstance(rec["trace_id"], str)
                        and len(rec["trace_id"]) == 32)):
            return False
        count += 1
    return count == expect and count > 0


def run_qtrace_smoke(key: str, device: str = "cuda", budget_s=None):
    """Z: Y's chaos load with the query plane and the tracer armed:
    determinism survives the instrumentation (admission log, result
    digest and the trace-structure digest replay identically), the
    slow-query JSONL logs schema-validate, the OpenMetrics rendering
    strict-parses with at least one trace-id exemplar, the batch-wait
    leg is decomposed, and a real SIGTERM drain leaves a flight dump of
    trace-carrying timelines in the report's serving section; the first
    armed run under the budget."""
    from pagerank_tpu_torch.serving import qtrace

    spec = CONFIGS[key]
    budget = QTRACE_SMOKE_BUDGET_S if budget_s is None else budget_s
    work = tempfile.mkdtemp(prefix="pagerank_qtrace_")
    try:
        codes, reps, t_spawn = _spawn(key, LOSS_WORLD, device, rescue=True,
                                      victim=LOSS_MEMBER, logs=work)
        r0 = reps.get(0) or {}
        runs = r0.get("runs") or []
        r1, r2 = (runs + [{}, {}])[:2]
        slow_ok = False
        logs = [os.path.join(work, f"slow{k}.jsonl") for k in (1, 2)]
        if len(runs) == 2 and all(os.path.exists(p) for p in logs):
            texts = [open(p, encoding="utf-8").read() for p in logs]
            slow_ok = bool(_slow_log_ok(texts[0], r1["slow_count"])
                           and _slow_log_ok(texts[1], r2["slow_count"]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    try:
        _, exemplars = _parse_openmetrics_strict(r0.get("openmetrics") or "")
        exemplar_ok = exemplars >= 1
    except AssertionError:
        exemplar_ok = False
    drained, q_before, _, serving = _sigterm_drain(
        _serve_graph(), _device_of(device), armed=True)
    dumps = serving.get("flight_dumps") or []
    drain_dumps = [d for d in dumps if d.get("reason") == "drain"]
    dump_traces_ok = bool(drain_dumps and drain_dumps[-1]["traces"]
                          and all(len(t.get("trace_id", "")) == 32
                                  for t in drain_dumps[-1]["traces"]))
    sigterm_ok = bool(drained and serving.get("enabled")
                      and q_before.outcome == "answered" and dump_traces_ok)
    trace_ok = bool(r1.get("trace_digest")
                    and r1.get("trace_digest") == r2.get("trace_digest"))
    replay_ok = bool(runs and r1.get("results_digest")
                     == r2.get("results_digest")
                     and r1.get("admission_log") == r2.get("admission_log"))
    accounted = bool(len(runs) == 2 and r1["unsettled"] == 0
                     and r2["unsettled"] == 0)
    p99 = r1.get("phase_p99_ms") or {}
    decomposed = bool(all(leg in p99 for leg in qtrace.DECOMPOSITION_LEGS)
                      and (p99.get("batch_wait") or 0) > 0)
    seconds = float(r1.get("seconds", float("inf")))
    passed = bool(list(codes) == [0] * LOSS_WORLD and accounted and replay_ok
                  and trace_ok and decomposed and slow_ok and exemplar_ok
                  and sigterm_ok and seconds <= budget)
    rec = {
        "config": key,
        "kind": "qtrace",
        "label": spec["label"],
        "devices": LOSS_WORLD,
        "queries": spec["queries"],
        "outcomes": dict(r1.get("outcomes", {})),
        "trace_digest_identical": trace_ok,
        "replay_identical": replay_ok,
        "phase_p99_ms": p99,
        "slow_log_ok": slow_ok,
        "slow_queries": r1.get("slow_count"),
        "exemplars_ok": exemplar_ok,
        "sigterm_flight_dump_ok": sigterm_ok,
        "seconds": seconds,
        "budget_s": budget,
        "passed": passed,
    }
    _say(f"[{key}] armed chaos x2 over {LOSS_WORLD} gloo ranks ({device}): "
         f"exit codes {list(codes)}, trace digest "
         f"{'identical' if trace_ok else 'DIVERGED'}; replay "
         f"{'bit-identical' if replay_ok else 'DIVERGED'}; "
         f"{r1.get('slow_count')} slow-query line(s) "
         f"{'schema OK' if slow_ok else 'SCHEMA BAD'}; exemplars "
         f"{'parse OK' if exemplar_ok else 'PARSE BAD'}; SIGTERM flight "
         f"dump {'OK' if sigterm_ok else 'BAD'}; {seconds:.2f}s vs budget "
         f"{budget:g}s (spawn {t_spawn:.1f}s) -> {_verdict(passed)}")
    return rec


_RANK_SIDES = {"elastic": _rank_elastic, "sdc": _rank_sdc,
               "halo": _rank_halo, "halo_async": _rank_halo,
               "devices": _rank_devices, "serve": _rank_serve,
               "qtrace": _rank_serve}

RUNNERS = {"ppr": run_ppr, "e2e": run_e2e, "faults": run_fault_smoke,
           "obs": run_obs_smoke, "live": run_live_smoke,
           "partitioned": run_partitioned_smoke,
           "elastic": run_elastic_smoke, "serve": run_serve_smoke,
           "qtrace": run_qtrace_smoke, "halo": run_halo_smoke,
           "halo_async": run_halo_async_smoke,
           "devices": run_devices_smoke, "jobs": run_jobs_smoke,
           "graph": run_graph_smoke, "concurrency": run_concurrency_smoke,
           "sdc": run_sdc_smoke, "kernels": run_kernels_smoke}


def runner_of(key: str):
    return RUNNERS.get(CONFIGS[key].get("kind"), run_one)


# -- the record table in PERF.md ---------------------------------------------

PERF_HEADER = "## Acceptance runs on the card"
PERF_INTRO = (
    "Rows written by `python -m pagerank_tpu_torch.scripts.acceptance`, "
    "one a key: a key's newest run replaces its row. Gate values: the f64 runs' raw / mass-normalised "
    "L1 against the f64 oracle (gate 1e-6), P's top-k overlap min and "
    "score L1, the smokes' oracle L1 or their checks. Device s: the timed "
    "window on the card (the f64 runs' and P's steps, E's solve, a "
    "smoke's run under its budget). Host split: R-MAT, build_graph, "
    "engine build and oracle seconds (E: L1 parse, host build, engine "
    "build, dumps exposed).\n\n"
    "| Key | Card | Result | Wall s | Gate values | Device s | edges/s | "
    "Host split s |\n"
    "|---|---|---|---|---|---|---|---|\n")


def _gate_values(r) -> str:
    if "mass_normalized_l1" in r:
        return (f"{r['normalized_l1']:.3e} / "
                f"{r['mass_normalized_l1']:.3e}")
    if r.get("kind") == "ppr":
        return f"overlap {r['min_topk_overlap']:.4f}, L1 {r['max_score_l1']:.3e}"
    for k in ("normalized_l1", "accuracy_l1"):
        if r.get(k) is not None:
            return f"L1 {r[k]:.3e}"
    if r.get("skew_rel_err") is not None:
        return f"skew err {r['skew_rel_err']:.2%}"
    return "checks " + _verdict(r.get("passed"))


def perf_row(r) -> str:
    dev_s = (r.get("device_seconds") or r.get("solve_s")
             or r.get("seconds"))
    rate = (r.get("edges_per_sec_per_chip")
            or r.get("edge_vectors_per_sec_per_chip"))
    host = r.get("host_stages_s")
    if r.get("kind") == "e2e":
        split = (f"L1 {r['l1_parse_s']:.2f}, build {r['host_build_s']:.2f}, "
                 f"engine {r['engine_build_s']:.2f}, dumps {r['dumps_s']:.2f}")
    elif host:
        split = ", ".join(f"{k.removesuffix('_s')} {v:.1f}"
                          for k, v in host.items())
    else:
        split = "-"
    return (f"| {r['config']} | {r.get('card', '-')} | "
            f"{_verdict(r.get('passed'))} | {r.get('wall_s', 0.0):.1f} | "
            f"{_gate_values(r)} | "
            f"{'-' if dev_s is None else f'{dev_s:.4f}'} | "
            f"{'-' if rate is None else f'{rate:.4g}'} | {split} |\n")


def append_perf(recs, path=None) -> None:
    """Write one row a record into PERF.md's "Acceptance runs on the
    card" table, making the table at the end of the file on first use.
    A key's new row takes the place of its old one, so the table keeps
    one row a key, in the order the keys first came."""
    path = path or os.path.join(REPO, "PERF.md")
    with open(path) as f:
        text = f.read()
    new = {r["config"]: perf_row(r) for r in recs}
    if PERF_HEADER not in text:
        text = (text.rstrip("\n") + f"\n\n{PERF_HEADER}\n\n{PERF_INTRO}"
                + "".join(new.values()))
    else:
        start = text.index(PERF_HEADER)
        end = text.find("\n## ", start + len(PERF_HEADER))
        end = len(text) if end == -1 else end
        out = []
        for line in text[start:end].rstrip("\n").split("\n"):
            key = line.split("|")[1].strip() if line.startswith("| ") else None
            out.append(new.pop(key).rstrip("\n") if key in new else line)
        out += [row.rstrip("\n") for row in new.values()]
        text = text[:start] + "\n".join(out) + "\n" + text[end:]
    with open(path, "w") as f:
        f.write(text)
    _say(f"wrote {len(recs)} row(s) to {path}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog=f"python -m {_MODULE}",
        description="the standing acceptance runs of the port")
    p.add_argument("--only", choices=sorted(CONFIGS), default=None)
    p.add_argument("--no-append", action="store_true",
                   help="do not write the records into PERF.md")
    p.add_argument("--no-analysis", action="store_true",
                   help="skip the static-analysis pre-gate")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the runs go (default cuda; without a card "
                   "the script exits 2 unless --device cpu is given)")
    args = p.parse_args(argv)

    if args.only in REFUSED:
        _say(f"acceptance: {REFUSED[args.only]}")
        return 2
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        _say("acceptance: no CUDA device is available (pass --device cpu "
             "to run on the host)")
        return 2
    if not args.no_analysis:
        from pagerank_tpu_torch.analysis.__main__ import main as analysis_main

        if analysis_main(["--select", "PTL,PTR"]) != 0:
            _say("acceptance: static analysis failed (run `python -m "
                 "pagerank_tpu_torch.analysis --select PTL,PTR`)")
            return 1
    card = card_identity(args.device)
    _say(f"acceptance on {card}")
    if args.device == "cuda":
        # The kernels are built (one nvcc a source, all at once) and the
        # card's context made before the first key, so that no budget
        # times a build or a context.
        from pagerank_tpu_torch.kernels import build

        t0 = time.perf_counter()
        build.build_all()
        torch.zeros(1, device="cuda").sum().item()
        _say(f"kernels built and the card's context made in "
             f"{time.perf_counter() - t0:.1f}s")
    keys = [args.only] if args.only else DEFAULT_KEYS
    recs = []
    for k in keys:
        t0 = time.perf_counter()
        rec = runner_of(k)(k, args.device)
        rec["card"] = card
        rec["wall_s"] = time.perf_counter() - t0
        recs.append(rec)
    if not args.no_append:
        append_perf(recs)
    print(json.dumps(recs))
    return 0 if all(r["passed"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
