"""Perf-regression sentry: the bench-history ledger and noise-aware
gating.

Copy of ``pagerank_tpu/obs/history.py``: :func:`normalize_result` (ONE
``RunRecord`` shape recovered from every historical result schema —
the wrapped ``BENCH_r*.json``, the flat ``MULTICHIP_*`` schema,
``BASELINE.json``, run reports), the append-only JSONL ledger
(:func:`append_record`, :func:`read_ledger`) with content-hash dedupe,
per-(leg, metric) robust baselines (median + MAD over a trailing
window, :func:`detect_changes`) with program-change vs env-drift
classification, and the budget gate (:func:`evaluate_gate`). What
differs: the environment class that separates series is (backend,
card name) from the port's run-report fingerprint
(``obs/report.environment_fingerprint``), its drift keys are torch's
and CUDA's versions and the card's power limit, and a port run
report's leg is named from the engine's resolved layout
(:func:`leg_name_for_layout`: flat, partitioned, bf16 windows, coo)
rather than the JAX config's legs, and a bench couple's headline from
its layout too (``pair_f64`` where it ran pair sums or records no
layout, ``f64`` for the port's f64/f64 headline).

Surfaces: the CLI's ``--history PATH`` (arms the live exporter's
``history.*`` baseline-delta gauges from the ledger and appends the
run's record after the solve).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from pagerank_tpu_torch.obs.report import _json_safe
from pagerank_tpu_torch.utils import fsio

#: Version of the LEDGER record shape (not of the source artifacts —
#: those carry their own ``schema_version`` of their own, and the
#: unversioned r01-r05 files still ingest).
LEDGER_SCHEMA_VERSION = 1

#: Canonical per-leg metrics a RunRecord carries (the
#: set). Every one is optional per leg — legacy artifacts recorded a
#: subset — but the KEY vocabulary is closed so series never fork on
#: spelling.
LEG_METRICS = (
    "edges_per_sec_per_chip",
    "seconds_per_iter",
    "build_s",
    "build_warm_s",
    "accuracy_l1",
    "cost_bytes_per_edge",
    "comms_bytes_per_iter",
    # The multichip legs' per-chip-rate-retained figure
    # (recorded since r06 but invisible in the trend until now), and
    # the comms-vs-compute attribution axes — the r06+ trend carries
    # whether the sharded step is exchange-bound.
    "scaling_efficiency",
    "exchange_fraction",
    "comms_achieved_bytes_per_sec",
    # The compiler plane's HLO-derived traffic estimate —
    # reconciles the analytic cost model against what the optimized
    # HLO actually schedules (legs also carry the non-numeric
    # ``lowering_fingerprint`` / ``gather_strategy`` the trend and
    # classifier read).
    "hlo_bytes_per_edge",
    # The data plane's profile scalars — a DATA change (new
    # crawl segment, different synthetic seed/skew) gates distinctly
    # from a program or env change: classify_change attributes a flag
    # whose cost model is flat but whose profile scalars moved as
    # **data-change** (warns, never fails). Older ledger rows
    # simply lack the keys (no re-ingest, no fork).
    "graph_dangling_fraction",
    "graph_partition_skew",
    "graph_topk_concentration",
    # Per-checked-iteration SDC detection overhead (percent
    # extra wall vs the plain step) — present only on legs measured
    # with ``bench.py --sdc-check-every`` armed; None-tolerant like
    # every leg metric (disarmed legs simply lack the key).
    "sdc_check_overhead_pct",
    # Iterations-to-tol of the stale-boundary async solve —
    # what the one-iteration boundary lag COSTS in convergence, priced
    # in iterations (textbook semantics, bench --multichip staleness
    # sweep). Present only on the sparse_async_f32 leg.
    "iters_to_tol",
    # The ppr_serve leg (bench.py --ppr-serve) — sustained
    # serving throughput and tail latency of the deadline-honest query
    # daemon, plus the shed fraction (admission honesty: what fraction
    # of offered load the predictive shed refused).
    "queries_per_sec",
    "p50_ms",
    "p99_ms",
    "shed_fraction",
    # The query plane's p99 phase decomposition — WHERE the
    # serving tail lives (admission decision / queue wait / device
    # dispatch / top-k fetch), carried on the same ppr_serve leg the
    # chip-time session already gates, so a p99 miss names its phase.
    "admission_wait_p99_ms",
    "batch_wait_p99_ms",
    "dispatch_p99_ms",
    "fetch_p99_ms",
)

#: Profile scalars whose motion marks the DATA axis (classify_change
#: rule 1c) — and the relative motion treated as "the data changed"
#: (the profile is exact arithmetic over the graph, so anything beyond
#: float formatting noise is a real data delta).
GRAPH_DATA_KEYS = ("graph_dangling_fraction", "graph_partition_skew")
DATA_MOVED_REL = 0.01

#: Which direction is BAD, per metric (direction-aware thresholds:
#: a throughput DROP is a regression, a build-time RISE is).
METRIC_BAD_DIRECTION = {
    "edges_per_sec_per_chip": "down",
    "seconds_per_iter": "up",
    "build_s": "up",
    "build_warm_s": "up",
    "accuracy_l1": "up",
    "cost_bytes_per_edge": "up",
    "comms_bytes_per_iter": "up",
    "scaling_efficiency": "down",
    "exchange_fraction": "up",
    "comms_achieved_bytes_per_sec": "down",
    "hlo_bytes_per_edge": "up",
    # Data-plane directions are nominal (a moved profile is DRIFT to
    # attribute, not a regression to gate): more dangling mass, more
    # partition skew, and more top-k concentration all make the solve
    # harder, so "up" renders as the worse direction.
    "graph_dangling_fraction": "up",
    "graph_partition_skew": "up",
    "graph_topk_concentration": "up",
    "sdc_check_overhead_pct": "up",
    # More iterations to the same tolerance = the staleness cost grew.
    "iters_to_tol": "up",
    # Serving: throughput down = regression; latency tails
    # and shed fraction up = regression (shedding MORE at the same
    # offered load means the modeled batch wall grew).
    "queries_per_sec": "down",
    "p50_ms": "up",
    "p99_ms": "up",
    "shed_fraction": "up",
    # Query plane: any phase's tail growing is a regression
    # in that leg of the serving pipeline.
    "admission_wait_p99_ms": "up",
    "batch_wait_p99_ms": "up",
    "dispatch_p99_ms": "up",
    "fetch_p99_ms": "up",
}

#: Env-fingerprint keys that define the SERIES a record belongs to:
#: numbers measured on different backends/device kinds are never
#: baselined against each other (a CPU smoke is not a regression of a
#: card cell).
ENV_CLASS_KEYS = ("backend", "device_kind")

#: Env keys whose WITHIN-class drift marks the environment axis
#: (jax/jaxlib upgrades, x64 flips, host moves). git_rev is excluded:
#: a code-rev change is the PROGRAM axis, exactly as in
#: obs/report.diff_reports.
ENV_DRIFT_KEYS = ("jax_version", "jaxlib_version", "x64", "device_count",
                  "process_count", "python", "platform", "torch_version",
                  "cuda_version", "power_limit")

#: Relative cost-model motion treated as "the program changed" — the
#: model is analytic (XLA's own accounting of the compiled program),
#: so anything beyond float formatting noise is a real program delta.
COST_MOVED_REL = 0.01

#: Detection defaults (perf_budgets.json "detection" overrides).
DEFAULT_DETECTION = {
    "window": 8,          # trailing baseline samples per (leg, metric)
    "threshold_mads": 4.0,  # flag beyond k scaled MADs...
    "rel_floor": 0.05,      # ...but never inside this relative band
    "min_samples": 3,       # refuse to flag on thinner history
}


# -- normalization: every historical schema -> one RunRecord ---------------


def _num(v) -> Optional[float]:
    """Finite float or None (strict-JSON discipline: the ledger never
    stores NaN/Inf — obs/report._json_safe does the same for reports)."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    f = float(v)
    return f if f == f and f not in (float("inf"), float("-inf")) else None


def _round_of(source: str) -> Optional[int]:
    m = re.search(r"_r(\d+)", source or "")
    return int(m.group(1)) if m else None


def _rate_leg(d: dict) -> dict:
    """One bench/multichip rate-leg dict -> canonical leg metrics.
    Tolerates every vintage: r01-r05 legs carry value (+build_s);
    modern legs add costs/layout/comms."""
    leg: Dict[str, object] = {}
    for src_key, dst_key in (("value", "edges_per_sec_per_chip"),
                             ("build_s", "build_s")):
        v = _num(d.get(src_key))
        if v is not None:
            leg[dst_key] = v
    ms = _num(d.get("ms_per_iter"))
    if ms is not None:
        leg["seconds_per_iter"] = ms / 1e3
    step = (d.get("costs") or {}).get("step") or {}
    if "seconds_per_iter" not in leg:
        spi = _num(step.get("seconds_per_iter"))
        if spi is not None:
            leg["seconds_per_iter"] = spi
    bpe = _num(step.get("bytes_per_edge"))
    if bpe is not None:
        leg["cost_bytes_per_edge"] = bpe
    comms = d.get("comms") or {}
    cb = _num(comms.get("bytes_per_iter"))
    if cb is not None:
        leg["comms_bytes_per_iter"] = cb
    # Comms-vs-compute attribution block (bench --multichip
    # legs since r10): the exchange-bound verdict joins the series.
    att = d.get("attribution") or {}
    ef = _num(att.get("exchange_fraction"))
    if ef is not None:
        leg["exchange_fraction"] = ef
    ab = _num(att.get("achieved_bytes_per_sec"))
    if ab is not None:
        leg["comms_achieved_bytes_per_sec"] = ab
    if isinstance(d.get("layout"), dict):
        leg["layout"] = _json_safe(d["layout"])
    # Compiler-plane block (bench legs since r11): the
    # whole-iteration form's lowering fingerprint + gather verdict
    # joins the series, so a jax/libtpu upgrade that changes the
    # LOWERING is attributable as program-change, not noise. Pre-
    # Older artifacts simply lack the key (back-compat: no
    # re-ingest, the series starts when the instrument did).
    _leg_lowering(d.get("lowering"), leg)
    # Data-plane block (bench legs since r13): the graph
    # profile's headline scalars join the series so classify_change
    # can attribute a move to the DATA axis. Older artifacts
    # lack the key (back-compat, same discipline as lowering).
    _leg_graph(d.get("graph"), leg)
    # SDC-plane overhead (bench legs since r15): present
    # only when the leg was measured with the checked step armed —
    # disarmed legs lack the key (None-tolerant by schema contract,
    # tests/test_bench_contract.py).
    so = _num(d.get("sdc_check_overhead_pct"))
    if so is not None:
        leg["sdc_check_overhead_pct"] = so
    # Staleness convergence cost (the sparse_async multichip
    # leg since r17) — absent on every synchronous leg.
    itt = _num(d.get("iters_to_tol"))
    if itt is not None:
        leg["iters_to_tol"] = itt
    nd = d.get("n_devices")
    if isinstance(nd, int):
        leg["n_devices"] = nd
    return leg


def _leg_graph(graph_block, leg: dict) -> None:
    """Fold one ``graph`` data-plane block (obs/graph_profile
    report_section shape: {"profile": summary, "prediction": ...})
    into canonical leg metrics."""
    if not isinstance(graph_block, dict):
        return
    prof = graph_block.get("profile")
    if not isinstance(prof, dict):
        return
    for src_key, dst_key in (
        ("dangling_fraction", "graph_dangling_fraction"),
        ("partition_skew", "graph_partition_skew"),
    ):
        v = _num(prof.get(src_key))
        if v is not None:
            leg[dst_key] = v


def _leg_lowering(lowering, leg: dict) -> None:
    """Fold one per-form ``lowering`` block (obs/hlo.ledger_snapshot
    shape) into canonical leg metrics: the WHOLE-ITERATION form's
    fingerprint, gather strategy, and HLO bytes/edge."""
    if not isinstance(lowering, dict):
        return
    whole = lowering.get("step") or lowering.get("final") or {}
    if not isinstance(whole, dict):
        return
    fp = whole.get("fingerprint")
    if isinstance(fp, str) and fp:
        leg["lowering_fingerprint"] = fp
    strategy = (whole.get("gather") or {}).get("strategy")
    if isinstance(strategy, str):
        leg["gather_strategy"] = strategy
    hb = _num(whole.get("hlo_bytes_per_edge"))
    if hb is not None:
        leg["hlo_bytes_per_edge"] = hb


def _leg_name_from_layout(layout: Optional[dict], default: str = "f32") -> str:
    """Single-config bench leg name from the RESOLVED layout record.
    Legacy single-mode files (r01) have no layout: they predate the
    couple schema and measured the plain-f32 config (the first cell),
    so the documented default is ``f32``."""
    if not isinstance(layout, dict):
        return default
    if layout.get("form") == "pallas_partitioned":
        return "pallas_partitioned_f32"
    if layout.get("stream_dtype") == "bfloat16":
        return "fast_bf16"
    if (layout.get("partition_span") or 0) > 0:
        return "partitioned_f32"
    if layout.get("pair"):
        return "pair_f64"
    accum = layout.get("accum_dtype")
    if accum == "float64":
        return "f64"
    return "fast_f32"


def leg_name_for_layout(layout: dict) -> str:
    """The ledger leg of a port run, from its engine's resolved layout
    (``TorchEngine.layout_info()``): ``flat_f32`` (K1), ``flat_f64``,
    ``flat_f32_acc64``, ``partitioned_f32`` (K2, f32 windows),
    ``partitioned_bf16`` (bf16 windows), ``coo_f32``/``coo_f64``, and
    ``cpu_f64`` for the oracle."""
    form = layout.get("form")
    dt = layout.get("dtype") or "float32"
    acc = layout.get("accum_dtype") or dt
    short = {"float32": "f32", "float64": "f64"}
    if form == "cpu_f64":
        return "cpu_f64"
    if form == "pallas_partitioned":
        return ("partitioned_bf16" if layout.get("stream_dtype")
                == "bfloat16" else "partitioned_f32")
    if form == "coo":
        return f"coo_{short.get(dt, dt)}"
    name = f"flat_{short.get(dt, dt)}"
    if acc != dt:
        name += f"_acc{short.get(acc, acc)[1:]}"
    return name


def leg_name_for_config(cfg) -> str:
    """The ledger leg a CLI/run-report solve belongs to, derived from
    the resolved config (dataclass or its _json_safe dict) — the same
    vocabulary bench.py's couple legs use, so a live run's % -vs-
    baseline compares against the right series."""
    def get(key, default=None):
        if isinstance(cfg, dict):
            return cfg.get(key, default)
        return getattr(cfg, key, default)

    if get("vertex_sharded"):
        if get("halo_async"):
            # The stale-boundary async exchange: its own
            # series — one-iteration-lagged boundary reads change both
            # the rate AND the convergence cost, so its numbers never
            # baseline against the synchronous sparse series.
            return "sparse_async_f32"
        return ("multichip_sparse" if get("halo_exchange")
                else "multichip_dense")
    if get("kernel") == "pallas" and get("partition_span"):
        # The fused Mosaic kernel leg: its own series —
        # comparing it against partitioned_f32's XLA pipeline is the
        # whole point of the ledger entry.
        return "pallas_partitioned_f32"
    if get("stream_dtype") == "bfloat16" and get("partition_span"):
        return "fast_bf16"
    if get("partition_span"):
        return "partitioned_f32"
    if get("dtype") == "float64":
        # "auto" resolves to pair on TPU backends — the backend every
        # f64 series in the ledger was measured on — and the CLI can't
        # set wide_accum at all, so auto joins the headline pair_f64
        # series; explicit native wide f64 is its own (rare) series,
        # matching _leg_name_from_layout's "f64".
        return ("pair_f64" if get("wide_accum") in ("pair", "auto", None)
                else "f64")
    if get("dtype") == "float32":
        return "fast_f32"
    return str(get("dtype") or "f32")


def _couple_headline_name(layout) -> str:
    """The couple's headline leg: ``pair_f64`` where its layout ran the
    pair-packed f64 sums (the JAX tool's) or records no layout (the
    r01-r05 rounds, whose headline was pair-f64), ``f64`` where it ran
    native f64 sums (the port's ``layout.pair`` false)."""
    if not isinstance(layout, dict) or layout.get("pair"):
        return "pair_f64"
    return "f64"


def _normalize_bench_couple(doc: dict, rec: dict) -> None:
    rec["kind"] = "bench_couple"
    legs = rec["legs"]
    head = _couple_headline_name(doc.get("layout"))
    legs[head] = _rate_leg(doc)
    warm = _num(doc.get("build_warm_s"))
    if warm is not None:
        legs[head]["build_warm_s"] = warm
    for key, name in (("fast_f32", "fast_f32"),
                      ("partitioned_f32", "partitioned_f32"),
                      ("pallas_partitioned", "pallas_partitioned_f32"),
                      ("fast_bf16", "fast_bf16")):
        if isinstance(doc.get(key), dict):
            legs[name] = _rate_leg(doc[key])
    acc = doc.get("accuracy") or {}
    l1 = _num(acc.get("normalized_l1_vs_f64_oracle"))
    if l1 is not None:
        legs[head]["accuracy_l1"] = l1
    bf = acc.get("fast_bf16") or {}
    l1b = _num(bf.get("normalized_l1_vs_f64_oracle"))
    if l1b is not None and "fast_bf16" in legs:
        legs["fast_bf16"]["accuracy_l1"] = l1b


def _normalize_bench_single(doc: dict, rec: dict) -> None:
    rec["kind"] = "bench_single"
    name = _leg_name_from_layout(doc.get("layout"))
    rec["legs"][name] = _rate_leg(doc)
    acc = doc.get("accuracy") or {}
    l1 = _num(acc.get("normalized_l1_vs_f64_oracle"))
    if l1 is not None:
        # Single mode's standing accuracy probe certifies the
        # accuracy-grade config, not the measured leg (bench.run_accuracy):
        # pair-f64 in the JAX tool, f64 in the port's.
        head = "f64" if acc.get("config") == "f64" else "pair_f64"
        rec["legs"].setdefault(head, {})["accuracy_l1"] = l1


def _normalize_multichip(doc: dict, rec: dict) -> None:
    rec["kind"] = "multichip"
    legs = rec["legs"]
    # The pallas leg joins the SAME pallas_partitioned_f32 series the
    # couple mode feeds (its replicated-rank form measures per-chip
    # rate like every other series entry); the exchange legs keep
    # their multichip_* names.
    for key, name in (("single_chip", "multichip_single"),
                      ("dense_exchange", "multichip_dense"),
                      ("sparse_exchange", "multichip_sparse"),
                      ("sparse_async", "sparse_async_f32"),
                      ("pallas_partitioned", "pallas_partitioned_f32")):
        if isinstance(doc.get(key), dict):
            legs[name] = _rate_leg(doc[key])
    acc = doc.get("accuracy") or {}
    l1 = _num(acc.get("normalized_l1_vs_f64_oracle"))
    if l1 is not None and "multichip_sparse" in legs:
        legs["multichip_sparse"]["accuracy_l1"] = l1
    # scaling_efficiency joins the LEG metrics (
    # the field existed since r06 but was invisible in the trend) AND
    # stays in extras — already-ingested ledger records carry only the
    # extras spelling, and metric_value() reads both.
    for k, leg in (("scaling_efficiency", "multichip_sparse"),
                   ("scaling_efficiency_dense", "multichip_dense")):
        v = _num(doc.get(k))
        if v is not None:
            rec["extras"][k] = v
            if leg in legs:
                legs[leg]["scaling_efficiency"] = v


def _normalize_build_only(doc: dict, rec: dict) -> None:
    rec["kind"] = "bench_build"
    # The JAX tool's legs, and the port's (f64/f64 in place of pair-f64).
    for key, name in (("pair", "build_pair"), ("f32", "build_f32"),
                      ("pair_warm", "build_pair_warm"), ("f64", "build_f64"),
                      ("f64_warm", "build_f64_warm")):
        b = _num((doc.get(key) or {}).get("build_s"))
        if b is not None:
            rec["legs"][name] = {"build_s": b}


def leg_name_for_report(doc: dict) -> str:
    """The ledger leg of a run report: its engine's resolved layout
    (:func:`leg_name_for_layout`) where the report carries one (every
    port run does), else its config's (:func:`leg_name_for_config`)."""
    layout = doc.get("layout")
    if isinstance(layout, dict):
        return leg_name_for_layout(layout)
    return leg_name_for_config(doc.get("config") or {})


def _normalize_run_report(doc: dict, rec: dict) -> None:
    rec["kind"] = "run_report"
    rec["env"] = _json_safe(doc.get("environment") or {})
    created = _num(doc.get("created_unix"))
    if created is not None:
        rec["created_unix"] = created
    cfg = doc.get("config") or {}
    leg: Dict[str, object] = {}
    summ = doc.get("summary") or {}
    eps = _num(summ.get("edges_per_sec_per_chip"))
    if eps is not None:
        leg["edges_per_sec_per_chip"] = eps
    spi = _num(summ.get("mean_iter_seconds"))
    if spi is not None:
        leg["seconds_per_iter"] = spi
    step = (doc.get("costs") or {}).get("step") or {}
    bpe = _num(step.get("bytes_per_edge"))
    if bpe is not None:
        leg["cost_bytes_per_edge"] = bpe
    gauges = (doc.get("metrics") or {}).get("gauges") or {}
    cb = _num(gauges.get("comms.bytes_per_iter"))
    if cb is not None:
        leg["comms_bytes_per_iter"] = cb
    for gauge_key, metric in (
        ("comms.exchange_fraction", "exchange_fraction"),
        ("comms.achieved_bytes_per_sec", "comms_achieved_bytes_per_sec"),
    ):
        v = _num(gauges.get(gauge_key))
        if v is not None:
            leg[metric] = v
    _leg_lowering(doc.get("lowering"), leg)
    _leg_graph(doc.get("graph"), leg)
    # Top-k rank concentration: the last probe record's
    # convergence-quality signal joins the leg when the run probed.
    conc = [_num((p or {}).get("topk_concentration"))
            for p in (doc.get("probes") or [])]
    conc = [c for c in conc if c is not None]
    if conc:
        leg["graph_topk_concentration"] = conc[-1]
    if leg:
        rec["legs"][leg_name_for_report(doc)] = leg
    iters = cfg.get("num_iters") if isinstance(cfg, dict) else None
    if isinstance(iters, int):
        rec["workload"]["iters"] = iters


def _normalize_ppr_serve(doc: dict, rec: dict) -> None:
    rec["kind"] = "bench_ppr_serve"
    leg: Dict[str, object] = {}
    qps = _num(doc.get("value"))
    if qps is not None:
        leg["queries_per_sec"] = qps
    for key in ("p50_ms", "p99_ms", "shed_fraction"):
        v = _num(doc.get(key))
        if v is not None:
            leg[key] = v
    # Query plane: the per-phase p99 decomposition, folded
    # into the same leg so the trend/gate read WHERE the tail lives.
    phase = doc.get("phase_p99_ms")
    if isinstance(phase, dict):
        for short in ("admission_wait", "batch_wait", "dispatch",
                      "fetch"):
            v = _num(phase.get(short))
            if v is not None:
                leg[short + "_p99_ms"] = v
    if leg:
        rec["legs"]["ppr_serve"] = leg
    for key in ("queries", "rescues", "max_batch", "deadline_ms", "topk"):
        if doc.get(key) is not None:
            rec["extras"][key] = doc[key]


def normalize_result(doc: dict, source: str = "") -> dict:
    """Any historical result artifact -> one canonical RunRecord dict.

    Accepted shapes (detected, never declared):
      - the legacy driver wrapper ``{n, cmd, rc, tail, parsed}``
        (BENCH_r01-r05) — ``parsed`` is unwrapped and normalized;
      - flat bench couple/single JSON (``metric ==
        edges_per_sec_per_chip``), versioned or not;
      - ``--build-only`` JSON (``metric == build_s``);
      - ``--ppr-serve`` JSON (``metric == ppr_serve_queries_per_sec``);
      - flat MULTICHIP JSON (``metric ==
        multichip_edges_per_sec_per_chip``) and the r01-r05 dryrun
        shape ``{n_devices, rc, ok, skipped, tail}``;
      - ``run_report.json`` (the flight recorder).

    Raises ValueError on a shape none of the readers claim.
    """
    if not isinstance(doc, dict):
        raise ValueError(f"perf history: not a JSON object: {type(doc)}")
    rec: Dict[str, object] = {
        "schema_version": LEDGER_SCHEMA_VERSION,
        "kind": None,
        "source": source or "",
        "round": _round_of(source),
        "env": {},
        "workload": {},
        "legs": {},
        "extras": {},
        "legacy": False,
    }
    inner = doc
    if "cmd" in doc and "tail" in doc:  # the legacy driver wrapper
        rec["legacy"] = True
        rec["extras"]["wrapper_rc"] = doc.get("rc")
        inner = doc.get("parsed")
        if not isinstance(inner, dict):
            rec["kind"] = "bench_failed"
            return _finish(rec)
    metric = inner.get("metric")
    if metric == "edges_per_sec_per_chip":
        if "fast_f32" in inner:
            _normalize_bench_couple(inner, rec)
        else:
            _normalize_bench_single(inner, rec)
    elif metric == "multichip_edges_per_sec_per_chip":
        _normalize_multichip(inner, rec)
    elif metric == "build_s":
        _normalize_build_only(inner, rec)
    elif metric == "ppr_serve_queries_per_sec":
        _normalize_ppr_serve(inner, rec)
    elif "environment" in inner and "spans" in inner:
        _normalize_run_report(inner, rec)
    elif set(inner) >= {"n_devices", "rc", "ok"}:  # multichip dryrun
        rec["kind"] = "multichip_dryrun"
        rec["extras"].update(
            ok=bool(inner.get("ok")), rc=inner.get("rc"),
            n_devices=inner.get("n_devices"),
        )
    else:
        raise ValueError(
            f"perf history: unrecognized result shape (keys "
            f"{sorted(inner)[:8]}) in {source or '<inline>'}"
        )
    if rec["kind"] != "run_report":
        if isinstance(inner.get("env"), dict):
            rec["env"] = _json_safe(inner["env"])
        for k in ("scale", "iters", "edge_factor"):
            if isinstance(inner.get(k), int):
                rec["workload"][k] = inner[k]
        v = inner.get("schema_version")
        if isinstance(v, int):
            rec["extras"]["source_schema_version"] = v
    return _finish(rec)


def content_hash(rec: dict) -> str:
    """Dedupe key: sha256 over the canonical record content. Ingest
    metadata (``ingested_unix``) is excluded so re-ingesting the same
    artifact is a no-op; ``source`` is INCLUDED so two rounds that
    happened to measure identical values both stay in the series."""
    body = {k: v for k, v in rec.items()
            if k not in ("content_hash", "ingested_unix")}
    return hashlib.sha256(
        json.dumps(_json_safe(body), sort_keys=True,
                   allow_nan=False).encode()
    ).hexdigest()[:16]


def _finish(rec: dict) -> dict:
    rec = _json_safe(rec)
    rec["content_hash"] = content_hash(rec)
    return rec


# -- the ledger -------------------------------------------------------------


def read_ledger(path: str) -> List[dict]:
    """All records, oldest first. A MISSING ledger is an empty one
    (the first ingest creates it); any other read failure — permission,
    a directory, a bad mount — RAISES, and a malformed line raises
    too: a CI gate silently passing on an unreadable ledger is exactly
    the failure mode this module exists to prevent."""
    try:
        with fsio.fopen(path) as f:
            text = f.read()
    except FileNotFoundError:
        return []
    records = []
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}:{ln}: malformed ledger line: {e}")
    return records


def append_record(path: str, rec: dict,
                  existing: Optional[List[dict]] = None,
                  now: Optional[float] = None) -> bool:
    """Append one RunRecord; returns False when its content hash is
    already present (dedupe). Strict JSON (``allow_nan=False``), one
    record per line, append-only — history is never rewritten."""
    import time

    if existing is None:
        existing = read_ledger(path)
    h = rec.get("content_hash") or content_hash(rec)
    if any(r.get("content_hash") == h for r in existing):
        return False
    out = dict(rec)
    out["content_hash"] = h
    out["ingested_unix"] = float(now if now is not None else time.time())
    line = json.dumps(_json_safe(out), sort_keys=True, allow_nan=False)
    with fsio.fopen(path, "a") as f:
        f.write(line + "\n")
    existing.append(out)
    return True


def ingest_paths(ledger: str, paths: Sequence[str]) -> Tuple[int, int]:
    """Normalize + append each artifact; returns (added, deduped)."""
    existing = read_ledger(ledger)
    added = deduped = 0
    for p in paths:
        with fsio.fopen(p) as f:
            doc = json.load(f)
        rec = normalize_result(doc, source=os.path.basename(p))
        if append_record(ledger, rec, existing=existing):
            added += 1
        else:
            deduped += 1
    return added, deduped


# -- robust baselines + change detection ------------------------------------


def env_class(rec: dict) -> Optional[Tuple]:
    """The comparability class of a record: (backend, device_kind), or
    None when the fingerprint was never recorded (legacy rounds).
    Baselines never mix classes — and legacy records, whose class is
    unknowable, only baseline each other."""
    env = rec.get("env") or {}
    vals = tuple(env.get(k) for k in ENV_CLASS_KEYS)
    return None if all(v is None for v in vals) else vals


def metric_value(rec: dict, leg: str, metric: str) -> Optional[float]:
    v = _num((rec.get("legs") or {}).get(leg, {}).get(metric))
    if v is None and metric == "scaling_efficiency":
        # Back-compat: records ingested before the leg metric existed carry the
        # multichip scaling figure only under extras (the r06 ledger
        # rows) — the series must not fork on ingest vintage.
        extras = rec.get("extras") or {}
        if leg == "multichip_sparse":
            v = _num(extras.get("scaling_efficiency"))
        elif leg == "multichip_dense":
            v = _num(extras.get("scaling_efficiency_dense"))
    return v


def series(records: Sequence[dict], leg: str, metric: str,
           klass=...) -> List[Tuple[int, float]]:
    """(record index, value) pairs for one (leg, metric), optionally
    restricted to one env class (pass ``klass``; default: all)."""
    out = []
    for i, r in enumerate(records):
        if klass is not ... and env_class(r) != klass:
            continue
        v = metric_value(r, leg, metric)
        if v is not None:
            out.append((i, v))
    return out


def median_mad(values: Sequence[float]) -> Tuple[float, float]:
    """Median and RAW median-absolute-deviation (callers scale by
    1.4826 for the normal-consistent sigma). Robust to the exact
    outliers we hunt — one bad round cannot drag its own baseline."""
    vs = sorted(values)
    n = len(vs)
    med = (vs[n // 2] if n % 2 else 0.5 * (vs[n // 2 - 1] + vs[n // 2]))
    dev = sorted(abs(v - med) for v in vs)
    mad = (dev[n // 2] if n % 2 else 0.5 * (dev[n // 2 - 1] + dev[n // 2]))
    return med, mad


@dataclass
class Change:
    """One flagged (or clean) per-(leg, metric) verdict on the newest
    record vs its trailing baseline."""

    leg: str
    metric: str
    value: float
    baseline_median: float
    baseline_mad: float
    n_baseline: int
    rel_delta: float                    # (value - median) / median
    flagged: bool
    direction: str = "flat"             # regression | improvement | flat
    # program-change | env-drift | data-change | noise
    classification: str = "noise"
    evidence: str = ""

    def to_dict(self) -> dict:
        return _json_safe(dataclasses.asdict(self))


def _mode(values):
    """Most common non-None value (newest wins ties) — the baseline
    window's consensus env field."""
    known = [v for v in values if v is not None]
    if not known:
        return None
    counts: Dict[object, int] = {}
    for v in known:
        counts[json.dumps(_json_safe(v), sort_keys=True)] = (
            counts.get(json.dumps(_json_safe(v), sort_keys=True), 0) + 1
        )
    best = max(counts.values())
    for v in reversed(known):
        if counts[json.dumps(_json_safe(v), sort_keys=True)] == best:
            return v
    return known[-1]


def classify_change(target: dict, baseline: Sequence[dict],
                    leg: str) -> Tuple[str, str]:
    """(classification, evidence) for a flagged wall/metric move —
    the obs-report pairwise logic generalized to a series:

      1. the leg's cost model (bytes/edge) moved vs its baseline
         median ⇒ **program-change** (the compiled program itself
         costs differently — XLA's model is deterministic);
      1b. the leg's LOWERING FINGERPRINT (obs/hlo.py) moved
         vs the baseline consensus ⇒ **program-change** — the compiler
         emitted a structurally different program (a jax/libtpu
         upgrade that changes the lowering is a program change even
         when the analytic cost model is flat, e.g. a defeated
         gather);
      1c. cost flat but the leg's GRAPH-PROFILE scalars (
         obs/graph_profile) moved vs their baseline medians ⇒
         **data-change** — the INPUT changed shape (new crawl
         segment, different skew), which explains a perf move without
         indicting the program or the backend; the gate warns, never
         fails;
      2. cost flat (or unmeasurable) and the env fingerprint drifted
         within the class ⇒ **env-drift**;
      3. cost flat and the baseline never recorded a fingerprint ⇒
         conservatively **env-drift** (unattributable — the legacy
         rounds predate the fingerprint; a gate must not fail on
         evidence nobody recorded);
      4. cost flat and env provably identical ⇒ **program-change**
         (same backend, same flags: what remains is the code axis —
         obs/report prints the matching "deltas below are code or
         load" banner).
    """
    cost_now = metric_value(target, leg, "cost_bytes_per_edge")
    cost_base = [metric_value(r, leg, "cost_bytes_per_edge")
                 for r in baseline]
    cost_base = [c for c in cost_base if c is not None]
    if cost_now is not None and cost_base:
        med, _ = median_mad(cost_base)
        if med > 0 and abs(cost_now - med) / med > COST_MOVED_REL:
            return ("program-change",
                    f"cost model moved: {med:.1f} -> {cost_now:.1f} "
                    f"B/edge ({(cost_now - med) / med:+.1%})")
    fp_now = (target.get("legs") or {}).get(leg, {}).get(
        "lowering_fingerprint")
    fp_base = _mode([
        (r.get("legs") or {}).get(leg, {}).get("lowering_fingerprint")
        for r in baseline
    ])
    if fp_now and fp_base and fp_now != fp_base:
        strat = (target.get("legs") or {}).get(leg, {}).get(
            "gather_strategy")
        return ("program-change",
                f"lowering fingerprint moved: {fp_base} -> {fp_now} — "
                f"the compiler emitted a different program shape"
                + (f" (gather now {strat})" if strat else ""))
    # Rule 1c: cost model flat but the DATA moved — the
    # graph profile scalars are exact arithmetic over the input, so a
    # move beyond formatting noise means the graph itself changed.
    for data_metric in GRAPH_DATA_KEYS:
        d_now = metric_value(target, leg, data_metric)
        d_base = [metric_value(r, leg, data_metric) for r in baseline]
        d_base = [v for v in d_base if v is not None]
        if d_now is None or not d_base:
            continue
        med, _ = median_mad(d_base)
        moved = (abs(d_now - med) / abs(med) > DATA_MOVED_REL
                 if med else d_now != 0)
        if moved:
            return ("data-change",
                    f"cost model flat; graph profile moved "
                    f"({data_metric}: {med:.4g} -> {d_now:.4g}) — the "
                    f"input data changed shape")
    t_env = target.get("env") or {}
    drifted = []
    baseline_known = False
    for k in ENV_DRIFT_KEYS:
        base_v = _mode([(r.get("env") or {}).get(k) for r in baseline])
        now_v = t_env.get(k)
        if base_v is None and now_v is None:
            continue
        baseline_known = baseline_known or base_v is not None
        if base_v is not None and now_v is not None and base_v != now_v:
            drifted.append(f"{k}: {base_v!r} -> {now_v!r}")
    if drifted:
        return ("env-drift",
                "cost model flat; environment drifted (" +
                "; ".join(drifted) + ")")
    if not baseline_known:
        return ("env-drift",
                "unattributable: baseline records carry no environment "
                "fingerprint (legacy rounds) — treated as drift, not "
                "gated")
    git_a = _mode([r.get("env", {}).get("git_rev") for r in baseline])
    git_b = t_env.get("git_rev")
    return ("program-change",
            "cost model flat/unreported and environment identical — "
            f"attributed to the program (git {git_a} -> {git_b})")


def detect_changes(records: Sequence[dict],
                   detection: Optional[dict] = None) -> List[Change]:
    """Evaluate the NEWEST record's legs against trailing per-(leg,
    metric) baselines drawn from the same env class. Returns one
    :class:`Change` per evaluable series (flagged or clean); series
    with fewer than ``min_samples`` baseline points are skipped — a
    two-point history cannot define noise."""
    det = dict(DEFAULT_DETECTION)
    det.update(detection or {})
    if not records:
        return []
    target = records[-1]
    prior = records[:-1]
    klass = env_class(target)
    out: List[Change] = []
    for leg, metrics in sorted((target.get("legs") or {}).items()):
        for metric in LEG_METRICS:
            value = _num(metrics.get(metric))
            if value is None:
                continue
            pts = series(prior, leg, metric, klass=klass)
            pts = pts[-det["window"]:]
            if len(pts) < det["min_samples"]:
                continue
            base_recs = [prior[i] for i, _ in pts]
            med, mad = median_mad([v for _, v in pts])
            if med == 0:
                continue
            threshold = max(det["threshold_mads"] * 1.4826 * mad,
                            det["rel_floor"] * abs(med))
            delta = value - med
            rel = delta / med
            ch = Change(leg=leg, metric=metric, value=value,
                        baseline_median=med, baseline_mad=mad,
                        n_baseline=len(pts), rel_delta=rel,
                        flagged=abs(delta) > threshold)
            if ch.flagged:
                bad = METRIC_BAD_DIRECTION.get(metric, "up")
                worse = (delta < 0) if bad == "down" else (delta > 0)
                ch.direction = "regression" if worse else "improvement"
                ch.classification, ch.evidence = classify_change(
                    target, base_recs, leg)
            out.append(ch)
    return out


# -- budgets + the CI gate --------------------------------------------------


def load_budgets(path: str) -> dict:
    with fsio.fopen(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "budgets" not in doc:
        raise ValueError(f"{path}: not a perf_budgets file "
                         "(expected a 'budgets' list)")
    return doc


def _budget_applies(budget: dict, rec: dict) -> bool:
    """Env-scoped budgets fire only on records that PROVABLY match:
    an unrecorded fingerprint field never satisfies a constraint (a
    TPU floor must not fail — or pass — a legacy/CPU record), and a
    ``min_scale`` budget skips records of smaller (or unrecorded)
    workloads — throughput floors are statements about the headline
    geometry, not a scale-14 smoke."""
    env = rec.get("env") or {}
    for k, want in (budget.get("env") or {}).items():
        if env.get(k) != want:
            return False
    ms = budget.get("min_scale")
    if ms is not None:
        sc = (rec.get("workload") or {}).get("scale")
        if sc is None or sc < ms:
            return False
    return True


def check_budgets(rec: dict, budgets: dict) -> List[str]:
    """Absolute floor/ceiling violations of the newest record."""
    violations = []
    for b in budgets.get("budgets", []):
        leg, metric = b.get("leg"), b.get("metric")
        v = metric_value(rec, leg, metric)
        if v is None or not _budget_applies(b, rec):
            continue
        lo, hi = _num(b.get("min")), _num(b.get("max"))
        if lo is not None and v < lo:
            violations.append(
                f"{leg}.{metric} = {v:.4g} below budget min {lo:.4g}"
                + (f" ({b['note']})" if b.get("note") else ""))
        if hi is not None and v > hi:
            violations.append(
                f"{leg}.{metric} = {v:.4g} above budget max {hi:.4g}"
                + (f" ({b['note']})" if b.get("note") else ""))
    return violations


def _round_sig(v: float, digits: int = 3) -> float:
    """3-significant-figure rounding for proposed bounds — a floor of
    5.4e8 is a statement a human can defend; 543217890.3 is noise."""
    return float(f"{float(v):.{digits}g}")


def propose_budgets(records: Sequence[dict], budgets: dict,
                    safety: float = 0.9) -> dict:
    """The ROADMAP's "refresh floors from real numbers" step,
    mechanized: for every budget entry whose env/min_scale
    scope matches enough ledger rows (the entry's OWN scoping rule —
    :func:`_budget_applies` — so a TPU floor is only ever derived
    from TPU rows), derive the refreshed bound from the trailing
    window's median: ``min`` -> safety * median (a floor the measured
    plateau clears with 1/safety headroom), ``max`` -> median / safety.
    Entries with fewer than ``min_samples`` matching measurements are
    skipped, never guessed. Returns::

        {"proposal": <a valid perf_budgets doc with updated bounds,
                      each changed entry annotated with its
                      derivation>,
         "changes": [{leg, metric, bound, old, new, median, n}, ...],
         "skipped": [{leg, metric, rows, needed}, ...]}

    The proposal is diffed against the checked-in file by
    ``obs history gate --propose-budgets`` and rendered as the
    campaign decision ledger's perf_budgets diff (obs/campaign.py).
    """
    if not 0 < safety <= 1:
        raise ValueError(f"safety must be in (0, 1], got {safety}")
    det = dict(DEFAULT_DETECTION)
    det.update(budgets.get("detection") or {})
    window = int(det.get("window", 8))
    min_samples = int(det.get("min_samples", 3))
    proposal = json.loads(json.dumps(_json_safe(budgets)))
    changes: List[dict] = []
    skipped: List[dict] = []
    for b in proposal.get("budgets", []):
        leg, metric = b.get("leg"), b.get("metric")
        vals = [metric_value(r, leg, metric) for r in records
                if _budget_applies(b, r)]
        vals = [v for v in vals if v is not None][-window:]
        if len(vals) < min_samples:
            skipped.append({"leg": leg, "metric": metric,
                            "rows": len(vals), "needed": min_samples})
            continue
        med, mad = median_mad(vals)
        derived = False
        for bound, new in (("min", _round_sig(med * safety)),
                           ("max", _round_sig(med / safety))):
            old = _num(b.get(bound))
            if old is None or new == old:
                continue
            b[bound] = new
            derived = True
            changes.append({"leg": leg, "metric": metric,
                            "bound": bound, "old": old, "new": new,
                            "median": med, "n": len(vals)})
        if derived:
            b["derived"] = {"median": med, "mad": mad,
                            "n": len(vals), "safety": safety}
    return {"proposal": proposal, "changes": changes,
            "skipped": skipped}


@dataclass
class GateResult:
    """One gate evaluation: violations fail CI; drift warnings and
    improvements pass with a note."""

    ok: bool = True
    violations: List[str] = field(default_factory=list)
    drift_warnings: List[str] = field(default_factory=list)
    improvements: List[str] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)
    changes: List[Change] = field(default_factory=list)

    def to_dict(self) -> dict:
        return _json_safe({
            "ok": self.ok,
            "violations": self.violations,
            "drift_warnings": self.drift_warnings,
            "improvements": self.improvements,
            "notes": self.notes,
            "changes": [dataclasses.asdict(c) for c in self.changes],
        })


def evaluate_gate(records: Sequence[dict],
                  budgets: Optional[dict] = None) -> GateResult:
    """The CI perf gate over a ledger's newest record:

      - absolute budget floors/ceilings (env-scoped);
      - MAD regression flags classified **program-change** fail;
      - flags classified **env-drift** warn and PASS (backend drift is
        not a code regression);
      - improvements and clean series are reported, never gated.
    """
    res = GateResult()
    if not records:
        res.notes.append("empty ledger: nothing to gate")
        return res
    target = records[-1]
    label = target.get("source") or target.get("kind") or "latest"
    res.notes.append(
        f"gating {label} (kind {target.get('kind')}, "
        f"{len(records) - 1} prior record(s))")
    if budgets:
        res.violations.extend(check_budgets(target, budgets))
    detection = (budgets or {}).get("detection")
    res.changes = detect_changes(records, detection)
    evaluated = 0
    for ch in res.changes:
        evaluated += 1
        if not ch.flagged:
            continue
        line = (f"{ch.leg}.{ch.metric}: {ch.value:.4g} vs baseline "
                f"{ch.baseline_median:.4g} (n={ch.n_baseline}, "
                f"{ch.rel_delta:+.1%}) [{ch.classification}] "
                f"{ch.evidence}")
        if ch.direction == "improvement":
            res.improvements.append(line)
        elif ch.classification == "env-drift":
            res.drift_warnings.append("DRIFT " + line)
        elif ch.classification == "data-change":
            # The INPUT changed shape — not a code
            # regression; warn like drift, with the distinct tag.
            res.drift_warnings.append("DATA " + line)
        else:
            res.violations.append("REGRESSION " + line)
    if not evaluated:
        res.notes.append(
            "no series had enough same-environment history to "
            "baseline (min_samples) — budgets only")
    res.ok = not res.violations
    return res


# -- trend rendering --------------------------------------------------------

_METRIC_SHORT = {
    "edges_per_sec_per_chip": "edges/s/chip",
    "seconds_per_iter": "s/iter",
    "build_s": "build s",
    "build_warm_s": "warm build s",
    "accuracy_l1": "accuracy L1",
    "cost_bytes_per_edge": "cost B/edge",
    "comms_bytes_per_iter": "comms B/iter",
    "scaling_efficiency": "scaling eff",
    "exchange_fraction": "exch frac",
    "comms_achieved_bytes_per_sec": "achieved B/s",
    "hlo_bytes_per_edge": "hlo B/edge",
    "graph_dangling_fraction": "dangling frac",
    "graph_partition_skew": "part skew",
    "graph_topk_concentration": "topk conc",
    "sdc_check_overhead_pct": "sdc ovh %",
    "iters_to_tol": "iters to tol",
    "queries_per_sec": "queries/s",
    "p50_ms": "p50 ms",
    "p99_ms": "p99 ms",
    "shed_fraction": "shed frac",
    "admission_wait_p99_ms": "adm p99 ms",
    "batch_wait_p99_ms": "bwait p99 ms",
    "dispatch_p99_ms": "disp p99 ms",
    "fetch_p99_ms": "fetch p99 ms",
}


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    a = abs(v)
    if a != 0 and (a >= 1e5 or a < 1e-3):
        return f"{v:.3e}"
    return f"{v:.4g}"


def record_label(rec: dict, index: int) -> str:
    rnd = rec.get("round")
    if rnd is not None:
        prefix = "m" if str(rec.get("kind", "")).startswith("multichip") \
            else "r"
        return f"{prefix}{rnd:02d}"
    return f"#{index}"


def render_trend(records: Sequence[dict],
                 detection: Optional[dict] = None,
                 metrics: Sequence[str] = LEG_METRICS) -> str:
    """ASCII trend: the record roster, then one series row per (leg,
    metric) — every leg ever recorded renders (no dropped legs), with
    the robust baseline and the newest record's flags below. The
    mechanical form of the ROADMAP's hand-computed plateau read."""
    if not records:
        return "perf history: empty ledger"
    lines = [f"perf history: {len(records)} record(s)"]
    for i, r in enumerate(records):
        env = r.get("env") or {}
        legs = sorted((r.get("legs") or {}))
        lines.append(
            f"  {record_label(r, i):<5} {str(r.get('kind')):<17} "
            f"git {str(env.get('git_rev') or '-'):<9} "
            f"backend {str(env.get('backend') or '?'):<5} "
            f"{r.get('source') or ''}"
            + (f"  legs: {', '.join(legs)}" if legs else "  (no legs)")
        )
    leg_names = sorted({leg for r in records
                        for leg in (r.get("legs") or {})})
    rows = []
    for leg in leg_names:
        for metric in metrics:
            pts = series(records, leg, metric)
            if not pts:
                continue
            vals = [v for _, v in pts]
            med, mad = median_mad(vals)
            label = f"{leg} {_METRIC_SHORT.get(metric, metric)}"
            cells = " ".join(
                f"{record_label(records[i], i)}={_fmt(v)}"
                for i, v in pts)
            rows.append((label, len(pts), med, mad, cells))
    if rows:
        w = max(len(r[0]) for r in rows)
        lines.append("")
        lines.append(f"{'series':<{w}}  {'n':>2}  {'median':>10}  "
                     f"{'MAD':>9}  oldest -> newest")
        for label, n, med, mad, cells in rows:
            lines.append(f"{label:<{w}}  {n:>2}  {_fmt(med):>10}  "
                         f"{_fmt(mad):>9}  {cells}")
    # Lowering fingerprints: the compiler-plane series —
    # a fingerprint change next to a rate shift attributes the shift
    # to the emitted program (a jax/libtpu lowering change), the
    # attribution the MAD classifier also applies mechanically.
    low_rows = []
    for leg in leg_names:
        fps = [
            (i, (r.get("legs") or {}).get(leg, {}).get(
                "lowering_fingerprint"))
            for i, r in enumerate(records)
        ]
        fps = [(i, f) for i, f in fps if isinstance(f, str) and f]
        if not fps:
            continue
        cells = " ".join(
            f"{record_label(records[i], i)}={f[:8]}" for i, f in fps
        )
        changed = len({f for _, f in fps}) > 1
        low_rows.append(f"  {leg}: {cells}"
                        + ("  << LOWERING CHANGED" if changed else ""))
    if low_rows:
        lines.append("")
        lines.append("lowering fingerprints (optimized-HLO structure "
                     "per leg):")
        lines.extend(low_rows)
    changes = detect_changes(records, detection)
    flagged = [c for c in changes if c.flagged]
    lines.append("")
    if flagged:
        lines.append("flags on the newest record:")
        for c in flagged:
            lines.append(
                f"  {c.direction.upper()}: {c.leg}.{c.metric} "
                f"{_fmt(c.value)} vs {_fmt(c.baseline_median)} "
                f"({c.rel_delta:+.1%}) [{c.classification}] {c.evidence}")
    elif changes:
        lines.append(f"newest record: {len(changes)} series within "
                     "noise of their baselines")
    else:
        lines.append("newest record: no series had enough "
                     "same-environment history to baseline")
    return "\n".join(lines)


# -- obs report x history ---------------------------------------------------


def baseline_pseudo_report(records: Sequence[dict], leg: str,
                           detection: Optional[dict] = None,
                           env: Optional[dict] = None) -> Tuple[
                               Optional[dict], int]:
    """A synthetic run-report-shaped dict standing in for 'the
    ledger's baseline of this form', so ``obs report --against-history``
    can reuse diff_reports' env-drift-first rendering verbatim.
    ``env`` (the target report's fingerprint) prefers SAME-CLASS
    ledger records when any exist; otherwise every record of the leg
    stands in and the diff's env banner calls the drift out.
    Returns (pseudo_report | None, n_baseline_records)."""
    det = dict(DEFAULT_DETECTION)
    det.update(detection or {})
    hits = [r for r in records if leg in (r.get("legs") or {})]
    if env:
        vals = tuple(env.get(k) for k in ENV_CLASS_KEYS)
        if not all(v is None for v in vals):
            same = [r for r in hits if env_class(r) == vals]
            if same:
                hits = same
    hits = hits[-det["window"]:]
    if not hits:
        return None, 0
    env = {}
    for k in set(ENV_CLASS_KEYS) | set(ENV_DRIFT_KEYS) | {"git_rev"}:
        env[k] = _mode([(r.get("env") or {}).get(k) for r in hits])
    summary = {}
    for metric, key in (("edges_per_sec_per_chip",
                         "edges_per_sec_per_chip"),
                        ("seconds_per_iter", "mean_iter_seconds")):
        vals = [v for _, v in series(hits, leg, metric)]
        if vals:
            summary[key] = median_mad(vals)[0]
    costs = {}
    bpe = [v for _, v in series(hits, leg, "cost_bytes_per_edge")]
    if bpe:
        costs["step"] = {"bytes_per_edge": median_mad(bpe)[0]}
    return ({"schema_version": 1, "environment": env, "spans": {},
             "summary": summary, "costs": costs, "metrics": {},
             "iterations": [], "robustness": {}}, len(hits))
