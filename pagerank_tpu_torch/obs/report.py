"""Run flight-recorder: one JSON artifact that explains a run.

Port of ``pagerank_tpu/obs/report.py`` (``build_run_report``,
``write_run_report``, ``load_report``, ``render_report``,
``diff_reports``; the section keys are the JAX report's). What differs:

  - the **environment fingerprint** names torch and its CUDA version,
    the backend (``cuda`` or ``cpu``), the card's name and count, its
    power limit (``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``, None where there is no ``nvidia-smi``) and
    the git revision — the drift axis of a card number;
  - the **costs** section is the port's cost ledger
    (``obs/costs.py``): the step's bytes from its kernel's analytic
    byte model and its achieved share of the byte bound, in place of
    XLA's ``cost_analysis``;
  - ``lowering`` (the JAX compiler plane) stays an empty section.

Every CLI run can write ``run_report.json`` carrying the environment,
the resolved config, the span summary, the metrics registry snapshot,
the per-iteration history, the robustness summary, the device
watermark, the job, graph, SDC and serving sections. Reports are STRICT
JSON: every float is sanitized (non-finite -> null) and dumped with
``allow_nan=False``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import time
from typing import Dict, List, Optional

from pagerank_tpu_torch.utils import fsio

SCHEMA_VERSION = 1

#: Top-level keys every run report carries — the JAX report's
#: (``pagerank_tpu/obs/report.py:70``). ``devices``: the per-device
#: memory watermark and last sample, on failure-marked reports too.
#: ``lowering``: empty (the JAX compiler plane has no counterpart).
#: ``job``: the resumable job's stages (jobs.py), empty without
#: ``--job-dir``. ``graph``: n, edge count and, under
#: ``--graph-profile``, the structural profile (diffed first by
#: :func:`diff_reports` as data drift). ``sdc``: the SDC plane's counts
#: (sdc.py), empty when off. ``serving``: the query plane's section
#: (serving/qtrace.report_section), ``{"enabled": false}`` when off.
REPORT_KEYS = (
    "schema_version", "created_unix", "environment", "config", "spans",
    "metrics", "iterations", "summary", "robustness", "costs",
    "devices", "lowering", "job", "graph", "sdc", "serving",
)


def _json_safe(obj):
    """Recursively coerce to strict-JSON values: non-finite floats ->
    None, dataclasses -> dicts, unknown scalars -> repr strings."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _json_safe(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    try:  # numpy scalars: sanitize through their python value
        return _json_safe(obj.item())
    except (AttributeError, ValueError):
        return repr(obj)


def canonical_json(doc) -> str:
    """THE canonical serialization: strict JSON, sorted keys, fixed
    2-space indent, trailing newline. Two runs that produced the same
    document produce the same BYTES — the campaign plane's
    byte-identical resumed-report contract (obs/campaign.py) hangs off
    this, so change it only with a schema bump."""
    return json.dumps(_json_safe(doc), sort_keys=True, indent=2,
                      allow_nan=False) + "\n"


def git_rev(repo_dir: Optional[str] = None) -> Optional[str]:
    """Short git revision of the checkout (None outside a repo / without
    git) — pins the code axis of a report."""
    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=repo_dir,
            capture_output=True, text=True, timeout=10,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    rev = out.stdout.strip()
    return rev if out.returncode == 0 and rev else None


def power_limit() -> Optional[str]:
    """The first card's ``name, power.limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    None where there is no ``nvidia-smi`` (or it fails)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def environment_fingerprint() -> Dict[str, object]:
    """The drift axis: everything about WHERE a run executed that can
    move its numbers without a code change. Every field degrades to
    None rather than failing — a report must be writable even when the
    card is the thing that broke."""
    import platform

    env: Dict[str, object] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "git_rev": git_rev(),
        "process_count": 1,
    }
    try:
        import torch

        env["torch_version"] = torch.__version__
        env["cuda_version"] = torch.version.cuda
        try:
            cuda = torch.cuda.is_available()
            env["backend"] = "cuda" if cuda else "cpu"
            env["device_count"] = torch.cuda.device_count() if cuda else 1
            env["device_kind"] = (torch.cuda.get_device_name(0) if cuda
                                  else "cpu")
        except Exception as e:  # a broken driver: record, don't die
            env["backend"] = None
            env["device_count"] = None
            env["device_kind"] = None
            env["backend_error"] = repr(e)
    except ImportError:
        env["torch_version"] = None
    env["power_limit"] = (power_limit() if env.get("backend") == "cuda"
                          else None)
    return env


def build_run_report(
    config=None,
    tracer=None,
    registry=None,
    history: Optional[List[dict]] = None,
    summary: Optional[dict] = None,
    robustness: Optional[dict] = None,
    costs: Optional[dict] = None,
    devices: Optional[dict] = None,
    lowering: Optional[dict] = None,
    job: Optional[dict] = None,
    serving: Optional[dict] = None,
    extra: Optional[dict] = None,
) -> dict:
    """Assemble the report dict. Every section is optional — a bench
    run has no per-iteration history, a CPU run has no profile — but
    every REPORT_KEYS key is always present (null/empty when unused)
    so consumers never key-error across producers. ``costs`` defaults
    to the cost-accounting ledger (obs/costs.py): the per-compiled-form
    FLOPs/HBM-bytes/peak-allocation model — the "did the model
    change or just the wall time" axis. ``devices`` defaults to the
    device plane's watermark section (obs/devices.report_section):
    the HBM high-water mark + last per-device sample — the evidence
    an OOM post-mortem reads, embedded in failure-marked reports
    too."""
    if costs is None:
        from pagerank_tpu_torch.obs import costs as costs_mod

        costs = costs_mod.ledger_snapshot()
    if devices is None:
        from pagerank_tpu_torch.obs import devices as devices_mod

        devices = devices_mod.report_section()
    if serving is None:
        # Query plane: whatever the armed plane's flight recorder
        # holds — {"enabled": False} on a disarmed (default) run.
        from pagerank_tpu_torch.serving import qtrace as qtrace_mod

        serving = qtrace_mod.report_section()
    report = {
        "schema_version": SCHEMA_VERSION,
        "created_unix": time.time(),
        "environment": environment_fingerprint(),
        "config": _json_safe(config) if config is not None else None,
        "spans": _json_safe(tracer.summary()) if tracer is not None else {},
        "metrics": _json_safe(registry.snapshot())
        if registry is not None else {},
        "iterations": _json_safe(history or []),
        "summary": _json_safe(summary or {}),
        "robustness": _json_safe(robustness or {}),
        "costs": _json_safe(costs or {}),
        "devices": _json_safe(devices or {}),
        "lowering": _json_safe(lowering or {}),
        "job": _json_safe(job or {}),
        # Data plane: producers that profiled the graph
        # override via ``extra["graph"]`` (the CLI merges n/num_edges
        # with obs/graph_profile.report_section); the key is always
        # present so consumers never key-error.
        "graph": {},
        # SDC plane: producers override via
        # ``extra["sdc"]`` (pagerank_tpu/sdc.report_section); always
        # present, empty on a disarmed run.
        "sdc": {},
        "serving": _json_safe(serving or {"enabled": False}),
    }
    if extra:
        report.update(_json_safe(extra))
    return report


def write_run_report(path: str, report: dict) -> None:
    """Strict-JSON dump (``allow_nan=False``: a non-finite float
    reaching here is a bug in _json_safe coverage, surfaced loudly)."""
    with fsio.fopen(path, "w") as f:
        json.dump(report, f, indent=2, allow_nan=False)
        f.write("\n")


def load_report(path: str) -> dict:
    with fsio.fopen(path) as f:
        return json.load(f)


def _fmt_s(v) -> str:
    return f"{v:.3f}s" if isinstance(v, (int, float)) else "-"


def _fmt_qty(v) -> str:
    """Compact magnitude formatting for cost-model quantities (flops,
    bytes); '-' for unreported (None)."""
    if not isinstance(v, (int, float)):
        return "-"
    for div, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(v) >= div:
            return f"{v / div:.2f}{suffix}"
    return f"{v:.0f}"


def render_report(report: dict) -> str:
    """Human view of one report: environment, headline rates, phase
    table, robustness + notable metrics."""
    lines = []
    env = report.get("environment", {})
    lines.append(
        f"run report (schema v{report.get('schema_version')}): "
        f"torch {env.get('torch_version')} / cuda {env.get('cuda_version')}"
        f", backend {env.get('backend')} ({env.get('device_kind')}, "
        f"{env.get('device_count')} device(s), power "
        f"{env.get('power_limit')}), git {env.get('git_rev')}"
    )
    summ = report.get("summary") or {}
    if summ:
        its = summ.get("iters")
        ms = summ.get("mean_iter_seconds")
        eps = summ.get("edges_per_sec_per_chip")
        lines.append(
            f"solve: {its} iters, "
            + (f"{ms * 1e3:.2f} ms/iter, " if ms is not None else "")
            + (f"{eps:.4g} edges/s/chip" if eps is not None else "")
        )
    spans = report.get("spans") or {}
    if spans:
        lines.append("phases (total wall, count, mean):")
        w = max(len(n) for n in spans)
        for name, a in spans.items():
            lines.append(
                f"  {name:<{w}}  {a['total_s']:9.3f}s  x{a['count']:<5d}"
                f"  mean {a['mean_s'] * 1e3:9.2f} ms"
            )
    costs = report.get("costs") or {}
    if costs:
        lines.append("cost model (per iteration; '-' = backend did not "
                     "report):")
        w = max(len(n) for n in costs)
        for form in sorted(costs):
            c = costs[form]
            lines.append(
                f"  {form:<{w}}  flops {_fmt_qty(c.get('flops_per_iter'))}"
                f"  hbm {_fmt_qty(c.get('bytes_per_iter'))}B"
                f"  peak {_fmt_qty(c.get('peak_bytes'))}B"
                + (f"  {c['bytes_per_edge']:.1f} B/edge"
                   if c.get("bytes_per_edge") is not None else "")
                + (f"  roofline {c['roofline_fraction']:.1%}"
                   if c.get("roofline_fraction") is not None else "")
            )
    rb = report.get("robustness") or {}
    if any(rb.values()):
        lines.append(
            "robustness: "
            + ", ".join(f"{k}={v}" for k, v in rb.items() if v)
        )
    sdc = report.get("sdc") or {}
    if sdc:
        lines.append(
            f"sdc: {sdc.get('checks', 0)} checked step(s), "
            f"{sdc.get('flips_detected', 0)} breach(es) "
            f"({sdc.get('transient', 0)} transient, "
            f"{sdc.get('sticky', 0)} sticky), quarantined "
            f"{sdc.get('quarantined_devices') or []}"
        )
        lb = sdc.get("last_breach") or {}
        if lb:
            kinds = ", ".join(
                r.get("kind", "?") for r in (lb.get("reasons") or []))
            lines.append(
                f"  last breach @ iter {lb.get('iteration')}: {kinds}"
                + (f" -> {lb.get('classified')}"
                   if lb.get("classified") else "")
                + (f" (device {lb.get('device')})"
                   if lb.get("device") is not None else "")
            )
    sv = report.get("serving") or {}
    if sv.get("enabled"):
        p99 = sv.get("phase_p99_ms") or {}
        dumps = sv.get("flight_dumps") or []
        lines.append(
            f"serving (query plane): {sv.get('settled', 0)} settled, "
            f"{sv.get('slow_queries', 0)} slow; p99 ms "
            + ", ".join(f"{k}={v:g}" for k, v in p99.items())
        )
        if dumps:
            lines.append(
                "  flight dumps: "
                + ", ".join(
                    f"{d.get('reason')}({len(d.get('traces') or [])})"
                    for d in dumps)
            )
    jb = report.get("job") or {}
    if jb.get("stages"):
        mark = ("INTERRUPTED" if report.get("interrupted")
                else jb.get("status"))
        lines.append(
            f"job: {mark}, resume #{jb.get('resumes', 0)} "
            f"({jb.get('dir')})"
        )
        for s, r in jb["stages"].items():
            w = r.get("wall_s")
            lines.append(
                f"  {s:<8} {r.get('status')}"
                + ("  [skipped: durable artifact]" if r.get("skipped")
                   else (f"  {w:.3f}s" if isinstance(w, (int, float))
                         else ""))
            )
    gr = report.get("graph") or {}
    prof = gr.get("profile") or {}
    if prof:
        lines.append(
            f"graph profile: {prof.get('num_edges'):,} unique edges"
            + (f" ({prof.get('duplicate_edges'):,} dups collapsed)"
               if prof.get("duplicate_edges") is not None else "")
            + f", dangling {prof.get('dangling_fraction', 0):.3%}"
            + (f", partition skew {prof['partition_skew']:.2f}"
               if prof.get("partition_skew") is not None else "")
            + (f", alpha {prof['powerlaw_alpha']:.2f}"
               if prof.get("powerlaw_alpha") is not None else "")
        )
        pred = gr.get("prediction") or {}
        if pred:
            lines.append(
                f"  predicted (ndev {pred.get('ndev')}): straggler "
                f"skew {pred.get('predicted_straggler_skew')}, halo "
                f"head-K {pred.get('predicted_halo_head_k')}"
            )
    dv = report.get("devices") or {}
    if dv.get("hbm_high_water_bytes") is not None:
        per_dev = dv.get("per_device_peak_bytes") or {}
        lines.append(
            f"devices: HBM high water "
            f"{dv['hbm_high_water_bytes'] / 1e9:.2f}GB over "
            f"{dv.get('samples', 0)} sample(s)"
            + (f", per device " + ", ".join(
                f"{k}={v / 1e9:.2f}GB" for k, v in per_dev.items())
               if per_dev else "")
        )
    mets = report.get("metrics") or {}
    counters = mets.get("counters") or {}
    if counters:
        lines.append("counters:")
        for k, v in counters.items():
            lines.append(f"  {k} = {v}")
    n_iter = len(report.get("iterations") or [])
    if n_iter:
        lines.append(f"iterations recorded: {n_iter}")
    return "\n".join(lines)


def _rel(a, b) -> Optional[float]:
    if not isinstance(a, (int, float)) or not isinstance(b, (int, float)):
        return None
    if a == 0:
        return None
    return (b - a) / a


#: Profile scalars the data-drift diff compares (a subset of
#: obs/graph_profile.GraphProfile.summary() chosen to move whenever
#: the DATA moved: size, dedup shape, mass structure, skew, tail).
GRAPH_DRIFT_KEYS = (
    "n", "num_edges", "raw_edges", "duplicate_edges", "self_loops",
    "dangling_count", "dangling_fraction", "zero_in_count",
    "partition_skew", "powerlaw_alpha", "fingerprint",
)


def _diff_graph_block(ga: dict, gb: dict) -> List[str]:
    """The ``graph`` section's data-drift lines (empty when nothing
    moved / neither run profiled)."""
    lines: List[str] = []
    diffs = []
    for k in ("n", "num_edges"):
        va, vb = ga.get(k), gb.get(k)
        if va != vb and (va is not None or vb is not None):
            diffs.append(f"  {k}: {va!r} -> {vb!r}")
    pa = ga.get("profile") or {}
    pb = gb.get("profile") or {}
    for k in GRAPH_DRIFT_KEYS:
        va, vb = pa.get(k), pb.get(k)
        if va is None and vb is None:
            continue
        if isinstance(va, float) and isinstance(vb, float):
            if va == vb or (va and abs(vb - va) / abs(va) < 1e-9):
                continue
        elif va == vb:
            continue
        diffs.append(f"  profile.{k}: {va!r} -> {vb!r}")
    qa = ga.get("prediction") or {}
    qb = gb.get("prediction") or {}
    for k in ("predicted_straggler_skew", "predicted_halo_head_k"):
        va, vb = qa.get(k), qb.get(k)
        if va != vb and (va is not None or vb is not None):
            diffs.append(f"  prediction.{k}: {va!r} -> {vb!r}")
    if diffs:
        lines.append("data DIFFERS (the GRAPH changed — deltas below "
                     "may be data-shaped, not code or backend):")
        lines.extend(diffs)
    elif pa or pb:
        lines.append("data: graph profile identical (deltas below are "
                     "not data drift)")
    return lines


def diff_reports(a: dict, b: dict) -> str:
    """Phase-by-phase diff of two reports: environment differences
    first (the backend-drift axis — if these differ, wall deltas below
    may be drift, not code), then per-phase wall deltas, rate deltas,
    and counter deltas."""
    lines = []
    ea, eb = a.get("environment", {}), b.get("environment", {})
    keys = sorted(set(ea) | set(eb))
    env_diffs = [
        f"  {k}: {ea.get(k)!r} -> {eb.get(k)!r}"
        for k in keys if ea.get(k) != eb.get(k) and k != "git_rev"
    ]
    if ea.get("git_rev") != eb.get("git_rev"):
        lines.append(
            f"code: git {ea.get('git_rev')} -> {eb.get('git_rev')}"
        )
    if env_diffs:
        lines.append("environment DIFFERS (wall deltas below may be "
                     "backend drift, not code):")
        lines.extend(env_diffs)
    else:
        lines.append("environment: identical (deltas below are code or "
                     "load, not backend drift)")

    # Data-plane drift (obs/graph_profile.py) — called out
    # BEFORE any perf delta, like env drift: if the GRAPH changed,
    # wall/rate/skew deltas below may be data-shaped, not code.
    lines.extend(_diff_graph_block(a.get("graph") or {},
                                   b.get("graph") or {}))

    sa, sb = a.get("spans") or {}, b.get("spans") or {}
    names = sorted(set(sa) | set(sb),
                   key=lambda n: -(sa.get(n, sb.get(n))["total_s"]))
    if names:
        lines.append("phase wall deltas (A -> B):")
        w = max(len(n) for n in names)
        for name in names:
            ta = sa.get(name, {}).get("total_s")
            tb = sb.get(name, {}).get("total_s")
            rel = _rel(ta, tb)
            tag = (f"{rel:+.1%}" if rel is not None
                   else "only in B" if ta is None else "only in A")
            lines.append(
                f"  {name:<{w}}  {_fmt_s(ta):>10} -> {_fmt_s(tb):>10}"
                f"  {tag}"
            )

    ra, rb = a.get("summary") or {}, b.get("summary") or {}
    rate_keys = ("mean_iter_seconds", "iters_per_sec",
                 "edges_per_sec_per_chip")
    rate_lines = []
    for k in rate_keys:
        va, vb = ra.get(k), rb.get(k)
        if va is None and vb is None:
            continue
        rel = _rel(va, vb)
        rate_lines.append(
            f"  {k}: {va if va is not None else '-'} -> "
            f"{vb if vb is not None else '-'}"
            + (f"  ({rel:+.1%})" if rel is not None else "")
        )
    if rate_lines:
        lines.append("rate deltas:")
        lines.extend(rate_lines)

    # Cost-model deltas: a changed model means the CODE
    # changed what a step should cost; identical models with moved wall
    # times point at the backend — the regression-vs-drift separation,
    # now on the analytic axis too.
    qa, qb = a.get("costs") or {}, b.get("costs") or {}
    cost_lines = []
    for form in sorted(set(qa) | set(qb)):
        fa, fb = qa.get(form, {}), qb.get(form, {})
        deltas = []
        for key, tag in (("flops_per_iter", "flops"),
                         ("bytes_per_iter", "hbm"),
                         ("peak_bytes", "peak"),
                         # The size-normalized axis the perf-history
                         # ledger baselines on (obs/history.py) — a
                         # pseudo-baseline report may carry ONLY this.
                         ("bytes_per_edge", "B/edge")):
            va, vb = fa.get(key), fb.get(key)
            if va == vb:
                continue
            rel = _rel(va, vb)
            deltas.append(
                f"{tag} {_fmt_qty(va)} -> {_fmt_qty(vb)}"
                + (f" ({rel:+.1%})" if rel is not None else "")
            )
        if not fa:
            deltas = ["only in B"]
        elif not fb:
            deltas = ["only in A"]
        if deltas:
            cost_lines.append(f"  {form}: " + ", ".join(deltas))
    if cost_lines:
        lines.append("cost-model deltas (the program changed, not just "
                     "the wall):")
        lines.extend(cost_lines)
    elif qa or qb:
        lines.append("cost model: identical (wall deltas above are "
                     "execution, not program, changes)")

    # Device-plane deltas: the comms attribution gauges
    # (exchange fraction, achieved wire bytes/s) and the per-run HBM
    # high-water mark — "did the exchange get slower or did we start
    # running closer to the memory ceiling" as a mechanical diff.
    ga = (a.get("metrics") or {}).get("gauges") or {}
    gb = (b.get("metrics") or {}).get("gauges") or {}
    comms_keys = sorted(
        k for k in set(ga) | set(gb)
        if k.startswith("comms.") and ga.get(k) != gb.get(k)
    )
    comms_lines = []
    for k in comms_keys:
        va, vb = ga.get(k), gb.get(k)
        rel = _rel(va, vb)
        comms_lines.append(
            f"  {k}: {_fmt_qty(va)} -> {_fmt_qty(vb)}"
            + (f"  ({rel:+.1%})" if rel is not None else "")
        )
    da = (a.get("devices") or {}).get("hbm_high_water_bytes")
    db = (b.get("devices") or {}).get("hbm_high_water_bytes")
    if da != db and (da is not None or db is not None):
        rel = _rel(da, db)
        comms_lines.append(
            f"  hbm_high_water_bytes: {_fmt_qty(da)} -> {_fmt_qty(db)}"
            + (f"  ({rel:+.1%})" if rel is not None else "")
        )
    if comms_lines:
        lines.append("device-plane deltas (comms attribution + HBM "
                     "watermark):")
        lines.extend(comms_lines)

    # Resumable-job deltas: which stages a resumed run
    # skipped via durable artifacts vs executed — "did the restart
    # actually avoid the 75 s build" as a mechanical diff.
    ja, jb = a.get("job") or {}, b.get("job") or {}
    if ja.get("stages") or jb.get("stages"):
        job_lines = []
        if ja.get("resumes") != jb.get("resumes"):
            job_lines.append(
                f"  resumes: {ja.get('resumes', 0)} -> "
                f"{jb.get('resumes', 0)}"
            )
        names = sorted(set(ja.get("stages") or {})
                       | set(jb.get("stages") or {}))
        for s in names:
            ra = (ja.get("stages") or {}).get(s) or {}
            rb_ = (jb.get("stages") or {}).get(s) or {}
            da = ("skipped" if ra.get("skipped") else ra.get("status"))
            db_ = ("skipped" if rb_.get("skipped") else rb_.get("status"))
            if da != db_:
                job_lines.append(f"  {s}: {da} -> {db_}")
        if job_lines:
            lines.append("job-stage deltas (resume skips vs executed "
                         "work):")
            lines.extend(job_lines)

    # SDC-plane deltas: detection/classification/quarantine
    # movement between two runs — "did the integrity plane fire" as a
    # mechanical diff, next to the robustness counters it extends.
    xa, xb = a.get("sdc") or {}, b.get("sdc") or {}
    if xa or xb:
        sdc_lines = []
        for k in ("checks", "flips_detected", "transient", "sticky"):
            va, vb = xa.get(k, 0), xb.get(k, 0)
            if va != vb:
                sdc_lines.append(f"  {k}: {va} -> {vb}")
        qa_, qb_ = (xa.get("quarantined_devices") or [],
                    xb.get("quarantined_devices") or [])
        if qa_ != qb_:
            sdc_lines.append(
                f"  quarantined_devices: {qa_!r} -> {qb_!r}")
        if sdc_lines:
            lines.append("sdc deltas (silent-data-corruption plane):")
            lines.extend(sdc_lines)

    ca = (a.get("metrics") or {}).get("counters") or {}
    cb = (b.get("metrics") or {}).get("counters") or {}
    counter_lines = [
        f"  {k}: {ca.get(k, 0)} -> {cb.get(k, 0)}"
        for k in sorted(set(ca) | set(cb)) if ca.get(k, 0) != cb.get(k, 0)
    ]
    if counter_lines:
        lines.append("counter deltas:")
        lines.extend(counter_lines)
    return "\n".join(lines)
