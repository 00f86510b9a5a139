"""``python -m pagerank_tpu_torch.obs`` — inspect run flight-recorder
artifacts, the perf-history ledger, the OOM-preflight fit check and the
data-plane profile of the port.

Port of ``pagerank_tpu/obs/__main__.py`` over the port's ``obs``
modules: the same subcommands, flags, help text, JSON documents and
exit codes.

  report A.json            pretty-print one run report
  report A.json B.json     diff two reports (phase-by-phase wall and
                           rate deltas; environment differences called
                           out first so backend drift is separable
                           from code regressions)
  report A.json --against-history LEDGER
                           diff A against the ledger's robust baseline
                           for its dispatch form (same env-drift-first
                           rendering)

  history ingest LEDGER FILE...   normalize + append result artifacts
                                  (BENCH/MULTICHIP/run_report shapes,
                                  legacy wrappers included; content-
                                  hash dedupe)
  history trend LEDGER            ASCII per-(leg, metric) series with
                                  robust baselines + newest-record
                                  flags (--json for the records)
  history gate LEDGER             the CI perf gate: budgets +
                                  program-change regressions fail
                                  (exit 1); env-drift warns and passes

  fit --scale N [--ndev D]        OOM preflight: the build+step at the
                                  target geometry, per stage, against
                                  the card's memory (live
                                  mem_get_info or the Hopper table),
                                  exit nonzero with the per-stage
                                  table when it does not fit. The port
                                  has no XLA memory_analysis to ask:
                                  every stage is the analytic model of
                                  ``obs/devices.fit_check`` (NOTHING
                                  allocates), so its byte counts are
                                  not the JAX tool's

  graph --scale N [--ndev D]      data-plane inspection
                                  (obs/graph_profile.py): build a
                                  synthetic graph with the profiler
                                  armed (on the card unless --device
                                  cpu), print the structural profile,
                                  the skew-driven load prediction for
                                  --ndev devices, and run a short
                                  PROBED solve whose rank-mass ledger
                                  must reconcile — exit 1 on any
                                  ledger violation

  hlo                             exits 2: the port has no HLO
                                  (ROADMAP.md's not-applicable list);
                                  ``python -m pagerank_tpu_torch.
                                  analysis --compiled`` reads the
                                  compiler's facts instead
  campaign run|status|report      the measurement-campaign
                                  orchestrator (obs/campaign.py): the
                                  checked-in leg order as one resumable
                                  command (checksummed per-leg
                                  artifacts, typed verdicts, the
                                  decision ledger); its legs run the
                                  port's obs CLI and bench in process;
                                  SIGTERM drains to exit 75 at a leg
                                  boundary

Exit codes: 0 ok, 1 gate violation / does not fit / mass-ledger
violation / incomplete campaign, 2 usage/unreadable input, 75 a
campaign drained on a signal.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from pagerank_tpu_torch.exitcodes import ExitCode
from pagerank_tpu_torch.obs import history as history_mod
from pagerank_tpu_torch.obs import report as report_mod


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pagerank_tpu_torch.obs",
        description="Run-report and perf-history tooling for the "
        "port's observability layer (README.md, 'PyTorch/CUDA port').",
    )
    sub = p.add_subparsers(dest="command", required=True)
    rp = sub.add_parser(
        "report", help="render one run_report.json, or diff two"
    )
    rp.add_argument("paths", nargs="+", metavar="REPORT.json",
                    help="one report to render, or two to diff (A B)")
    rp.add_argument("--json", action="store_true",
                    help="emit the loaded report (or {'a','b'} pair) "
                    "as JSON instead of the human rendering")
    rp.add_argument(
        "--against-history", default=None, metavar="LEDGER",
        help="diff ONE report against the perf-history ledger's "
        "baseline for its dispatch form (median of the trailing "
        "window) — the pairwise env-drift-first diff, with the ledger "
        "standing in for run A",
    )
    hp = sub.add_parser(
        "history",
        help="perf-history ledger: ingest results, render the trend, "
        "run the CI perf gate",
    )
    hsub = hp.add_subparsers(dest="history_command", required=True)
    ing = hsub.add_parser(
        "ingest", help="normalize result JSONs into the ledger "
        "(append-only, content-hash deduped)")
    ing.add_argument("ledger", metavar="LEDGER.jsonl")
    ing.add_argument("files", nargs="+", metavar="RESULT.json",
                     help="bench couple/single/--build-only JSON, "
                     "MULTICHIP JSON (dryrun or promoted), "
                     "run_report.json, or a legacy {n,cmd,rc,tail,"
                     "parsed} wrapper")
    ing.add_argument("--json", action="store_true",
                     help="emit {'added','deduped'} as JSON")
    tr = hsub.add_parser(
        "trend", help="ASCII per-(leg, metric) series over the ledger "
        "with robust baselines and newest-record flags")
    tr.add_argument("ledger", metavar="LEDGER.jsonl")
    tr.add_argument("--json", action="store_true",
                    help="emit the ledger records as JSON instead of "
                    "the table")
    tr.add_argument("--budgets", default=None, metavar="BUDGETS.json",
                    help="read detection knobs (window/threshold/"
                    "min_samples) from this perf_budgets file")
    ga = hsub.add_parser(
        "gate", help="the CI perf gate: exits 1 on a budget breach or "
        "a program-change regression; env-drift flags warn and pass")
    ga.add_argument("ledger", metavar="LEDGER.jsonl")
    ga.add_argument("--budgets", default=None, metavar="BUDGETS.json",
                    help="perf_budgets.json: absolute env-scoped "
                    "floors/ceilings + detection knobs (default: "
                    "MAD detection only)")
    ga.add_argument("--record", default=None, metavar="RESULT.json",
                    help="gate this result artifact against the "
                    "ledger instead of the ledger's own newest record "
                    "(the artifact is normalized, not appended)")
    ga.add_argument("--json", action="store_true",
                    help="emit the GateResult as JSON")
    ga.add_argument("--propose-budgets", default=None,
                    metavar="OUT.json",
                    help="also derive refreshed floors/ceilings from "
                    "the measured medians of each budget entry's "
                    "matching env-class rows (requires --budgets), "
                    "write the full proposal doc to OUT.json, and "
                    "print the diff vs the input budgets — the "
                    "ROADMAP's 'refresh floors from real numbers' "
                    "step, mechanized")
    fp = sub.add_parser(
        "fit",
        help="OOM-preflight fit check (obs/devices.py): will the device "
        "build + solve at this geometry fit the card's memory? Exits 1 "
        "with the per-stage table when it won't — BEFORE any real "
        "allocation (analytic per-stage bytes; the port has no XLA "
        "memory_analysis)",
    )
    fp.add_argument("--scale", type=int, required=True,
                    help="R-MAT scale (2^scale vertices, "
                    "edge_factor<<scale raw edges) — the bench/ROADMAP "
                    "geometry vocabulary")
    fp.add_argument("--ndev", type=int, default=1,
                    help="target device count; >1 implies the "
                    "vertex-sharded (memory-scaling) solve")
    fp.add_argument("--vs-bounded", action="store_true",
                    help="size the owner-computes bounded mode "
                    "(config.vs_bounded): per-chip step transients "
                    "O(stripe_span + N/ndev) instead of O(N); "
                    "implies --host-build (the mode requires a "
                    "host-built graph)")
    fp.add_argument("--edge-factor", type=int, default=16)
    fp.add_argument("--dtype", default="float32")
    fp.add_argument("--accum-dtype", default=None,
                    help="defaults to --dtype")
    fp.add_argument("--wide-accum", default="auto",
                    choices=["auto", "pair", "native"],
                    help="accepted for the JAX tool's command lines; the "
                    "port has no pair-f64 form (Hopper sums f64 "
                    "natively), so it changes nothing")
    fp.add_argument("--host-build", action="store_true",
                    help="skip the device-build pipeline stages (the "
                    "graph arrives host-built; only the solve "
                    "residency gates)")
    fp.add_argument("--hbm-gb", type=float, default=None,
                    help="explicit per-card memory limit in GiB "
                    "(default: live mem_get_info, else the device-kind "
                    "capacity table, else the table's H100 entry)")
    fp.add_argument("--device-kind", default=None,
                    help="size against this device kind's published "
                    "memory capacity (e.g. 'NVIDIA H100 80GB HBM3', "
                    "from the Hopper table) instead of the attached "
                    "device")
    fp.add_argument("--headroom", type=float, default=None,
                    help="fraction of the limit usable after runtime "
                    "reserve (default 0.9)")
    fp.add_argument("--json", action="store_true",
                    help="emit the FitResult as JSON")
    gp = sub.add_parser(
        "graph",
        help="data-plane inspection (obs/graph_profile.py): "
        "structural profile + skew-driven load prediction + the "
        "rank-mass conservation ledger over a short probed solve — "
        "exit 1 on a ledger violation",
    )
    gp.add_argument("--scale", type=int, default=14,
                    help="R-MAT scale of the probe graph (default 14)")
    gp.add_argument("--edge-factor", type=int, default=16)
    gp.add_argument("--synthetic", default=None, metavar="SPEC",
                    help="synthetic spec (the CLI grammar: rmat:N | "
                    "uniform:N[:E]) instead of --scale")
    gp.add_argument("--ndev", type=int, default=1,
                    help="target device count for the load prediction; "
                    "> 1 also runs the vertex-sharded solve and "
                    "reports MEASURED per-device edge counts when the "
                    "mesh exists")
    gp.add_argument("--iters", type=int, default=4,
                    help="probed solve iterations for the ledger check")
    gp.add_argument("--device-build", action="store_true",
                    help="profile via the on-device build's fused "
                    "reduction pass (default: host build + numpy "
                    "profile)")
    gp.add_argument("--semantics", choices=["reference", "textbook"],
                    default="textbook",
                    help="solve semantics for the ledger check "
                    "(textbook sums to 1 — the default gate)")
    gp.add_argument("--topk", type=int, default=100,
                    help="hub count / rank-concentration k "
                    "(default 100)")
    gp.add_argument("--json", action="store_true",
                    help="emit {profile, prediction, measured, ledger} "
                    "as strict JSON")
    gp.add_argument("--device", default="cuda",
                    help="where the graph is built and the probed solve "
                    "runs (default cuda; 'cpu' runs the kernels' plain "
                    "versions on the host)")
    hp2 = sub.add_parser(
        "hlo",
        help="not applicable to the port (exits 2): there is no HLO; "
        "'python -m pagerank_tpu_torch.analysis --compiled' reads the "
        "compiler's facts of the CUDA kernels instead",
    )
    hp2.add_argument(
        "--form", default="default", metavar="FORM",
        help="dispatch form(s) to inspect: comma-separated names from "
        "{default, pair, partitioned, partitioned_bf16, coo, "
        "vertex_sharded, vs_halo}, or 'all'",
    )
    hp2.add_argument("--scale", type=int, default=14,
                     help="R-MAT scale of the host-built probe graph "
                     "(default 14 — sub-second on CPU, big enough "
                     "that the hot gather is unambiguous)")
    hp2.add_argument("--edge-factor", type=int, default=16)
    hp2.add_argument("--json", action="store_true",
                     help="emit {form: {program: LoweringReport}} as "
                     "strict JSON")
    hp2.add_argument("--dump-hlo", default=None, metavar="DIR",
                     help="also write every inspected program's raw "
                     "optimized HLO to DIR as <form>.<program>.hlo")
    cp = sub.add_parser(
        "campaign",
        help="the measurement-campaign orchestrator (obs/campaign.py): "
        "run/resume the checked-in campaign as one command with "
        "checksummed per-leg artifacts, typed verdicts, and a decision "
        "ledger",
    )
    csub = cp.add_subparsers(dest="campaign_command", required=True)
    cr = csub.add_parser(
        "run", help="run (or resume) the campaign; completed legs "
        "with validated artifacts are skipped, SIGTERM drains to "
        "exit 75 at the next leg boundary")
    cr.add_argument("--campaign-dir", required=True, metavar="DIR",
                    help="artifact + manifest directory (the resume "
                    "key: rerun with the same DIR to resume)")
    cr.add_argument("--fake-devices", type=int, default=0, metavar="N",
                    help="non-binding dry run: the smoke-scale profile "
                    "with the multichip leg over N gloo ranks sharing "
                    "the one --device, and every verdict 'defer' — the "
                    "rehearsal of the binding session")
    cr.add_argument("--profile", choices=["auto", "roadmap", "smoke"],
                    default="auto",
                    help="campaign geometry (default auto: smoke when "
                    "--fake-devices is set, roadmap otherwise)")
    cr.add_argument("--ndev", type=int, default=8,
                    help="target device count for the fit/graph/"
                    "multichip legs (default 8)")
    cr.add_argument("--budgets", default=None, metavar="BUDGETS.json",
                    help="perf_budgets file the gate leg and verdict "
                    "floors read (default: the checked-in "
                    "perf_budgets.json)")
    cr.add_argument("--drain-deadline", type=float, default=8.0,
                    metavar="S",
                    help="seconds after SIGTERM before the hard exit "
                    "(default 8.0)")
    cr.add_argument("--json", action="store_true",
                    help="emit the stable campaign report as JSON "
                    "instead of the human rendering")
    cr.add_argument("--device", default="cuda",
                    help="where the graph and bench legs run (default "
                    "cuda; 'cpu' runs the kernels' plain versions on the "
                    "host)")
    cst = csub.add_parser(
        "status", help="per-leg progress from the campaign manifest")
    cst.add_argument("--campaign-dir", required=True, metavar="DIR")
    cst.add_argument("--json", action="store_true",
                     help="emit the manifest as JSON")
    crp = csub.add_parser(
        "report", help="rebuild the campaign report from the on-disk "
        "artifacts (never re-runs anything): typed verdicts + the "
        "decision ledger; exit 1 while the campaign is incomplete")
    crp.add_argument("--campaign-dir", required=True, metavar="DIR")
    crp.add_argument("--budgets", default=None, metavar="BUDGETS.json",
                     help="perf_budgets file the verdict floors read "
                     "(default: the checked-in perf_budgets.json)")
    crp.add_argument("--json", action="store_true",
                     help="emit the report as canonical strict JSON")
    crp.add_argument("--full", action="store_true",
                     help="include the volatile evidence: per-verdict "
                     "measurements, per-leg walls, raw leg docs "
                     "(NOT byte-stable across runs)")
    return p


def _cmd_graph(args) -> int:
    """Data-plane inspection: profile -> prediction -> measured ->
    ledger, nonzero exit on a ledger violation. One process drives one
    device: a prediction for ``--ndev`` > 1 is made, and the solve runs
    on the one device (the measured per-device counts need a group)."""
    from pagerank_tpu_torch import PageRankConfig, build_graph
    from pagerank_tpu_torch.engines.torch_engine import (TorchEngine,
                                                         resolve_device)
    from pagerank_tpu_torch.obs import graph_profile
    from pagerank_tpu_torch.obs.probes import ConvergenceProbes
    from pagerank_tpu_torch.parallel import comms

    if args.iters < 1 or args.ndev < 1:
        print("obs graph: --iters and --ndev must be >= 1",
              file=sys.stderr)
        return 2
    # Synthetic geometry through THE shared spec grammar (cli.py) so
    # `obs graph` and the CLI can never disagree about what a spec
    # means; --scale is shorthand for rmat:N.
    kind, scale, n, e = "rmat", args.scale, 1 << args.scale, None
    if args.synthetic:
        from pagerank_tpu_torch.cli import _synthetic_geometry

        geo = _synthetic_geometry(args.synthetic)
        if geo is None:
            print(f"obs graph: unknown synthetic spec "
                  f"{args.synthetic!r}", file=sys.stderr)
            return 2
        n, e, scale = geo
        kind = "rmat" if scale is not None else "uniform"
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as err:
        print(f"obs graph: {err}", file=sys.stderr)
        return 2
    if args.ndev > 1:
        print(f"obs graph: {args.ndev} devices requested, 1 available "
              f"to one process — prediction targets {args.ndev}, the "
              f"measured solve runs on 1", file=sys.stderr)

    graph_profile.reset()
    graph_profile.arm()
    try:
        cfg = PageRankConfig(
            num_iters=args.iters, semantics=args.semantics,
            probe_every=1, probe_topk=args.topk,
        ).validate()
        engine = TorchEngine(cfg, device=dev)
        if args.device_build:
            from pagerank_tpu_torch.ops import device_build as db

            if kind == "rmat":
                src, dst = db.rmat_edges_device(
                    scale, edge_factor=args.edge_factor, seed=0,
                    device=dev)
            else:
                src, dst = db.uniform_edges_device(n, e, seed=0,
                                                   device=dev)
            dg = db.build_ell_device(src, dst, n=n, device=dev)
            del src, dst
            profile = graph_profile.get_profile()
            engine.build_device(dg)
        else:
            from pagerank_tpu_torch.utils import synth

            if kind == "rmat":
                src, dst = synth.rmat_edges(scale, args.edge_factor,
                                            seed=0)
            else:
                src, dst = synth.uniform_edges(n, e)
            g = build_graph(src, dst, n=n)
            engine.build(g)
            # Profile at the layout the engine ACTUALLY packed (shared
            # derivation — the CLI uses the same one).
            group, span = graph_profile.layout_profile_geometry(
                engine.layout_info())
            profile = graph_profile.profile_graph(
                g, group=group, partition_span=span, topk=args.topk,
            )
            graph_profile.publish(profile)

        prediction = comms.predict_from_profile(profile, args.ndev)
        comms.publish_prediction(prediction)
        if profile is not None:
            profile.prediction = prediction

        probes = ConvergenceProbes(1, topk=args.topk)
        engine.run(probes=probes)
        measured = None
    finally:
        graph_profile.disarm()

    residuals = [abs((r.get("mass_ledger") or {}).get("residual", 0.0))
                 for r in probes.history if r.get("mass_ledger")]
    entries = sum(1 for r in probes.history if r.get("mass_ledger"))
    ledger = {
        "probes": len(probes.history),
        "entries": entries,
        "max_abs_residual": max(residuals) if residuals else None,
        "violations": [
            {k: v for k, v in rec.items()}
            for rec in probes.ledger_violations
        ],
        # NOT vacuous: a run whose probed steps never measured the
        # ledger (a form without a ledger core) must FAIL the gate —
        # "no evidence" is not "reconciled".
        "ok": (entries == len(probes.history) and entries > 0
               and not probes.ledger_violations),
    }
    doc = {
        "profile": profile.summary() if profile is not None else None,
        "prediction": prediction,
        "measured": measured,
        "ledger": ledger,
    }
    if args.json:
        print(json.dumps(report_mod._json_safe(doc), indent=2,
                         allow_nan=False))
    else:
        prof = doc["profile"] or {}
        print(f"graph profile ({prof.get('source')}): n={prof.get('n'):,}, "
              f"{prof.get('num_edges'):,} unique edges"
              + (f" ({prof.get('duplicate_edges'):,} dups)"
                 if prof.get("duplicate_edges") is not None else "")
              + (f", {prof.get('self_loops'):,} self-loops"
                 if prof.get("self_loops") is not None else ""))
        print(f"  dangling {prof.get('dangling_fraction', 0):.3%} "
              f"({prof.get('dangling_count'):,}), zero-in "
              f"{prof.get('zero_in_count'):,}")
        print(f"  in-degree hist (log2 bins): "
              f"{_fmt_hist(prof.get('in_hist') or [])}")
        print(f"  out-degree hist (log2 bins): "
              f"{_fmt_hist(prof.get('out_hist') or [])}")
        hubs = list(zip(prof.get("top_hub_ids") or [],
                        prof.get("top_hub_in_degrees") or []))[:8]
        print("  top hubs (id:in-degree): "
              + ", ".join(f"{i}:{d}" for i, d in hubs))
        if prof.get("partition_skew") is not None:
            print(f"  partition skew (max/mean over "
                  f"{len(prof.get('partition_edges') or [])} "
                  f"partition(s)): {prof['partition_skew']:.3f}")
        if prof.get("powerlaw_alpha") is not None:
            print(f"  power-law tail alpha ~ "
                  f"{prof['powerlaw_alpha']:.2f}")
        if prediction:
            print(f"predicted @ ndev {prediction['ndev']}: straggler "
                  f"skew {prediction.get('predicted_straggler_skew')}, "
                  f"halo head-K "
                  f"{prediction.get('predicted_halo_head_k')}")
        if measured:
            print(f"measured  @ ndev {measured['ndev']}: straggler "
                  f"skew {measured['straggler_skew']:.4f} "
                  f"(per-device edges {measured['device_edges']})")
        print(f"mass ledger: {ledger['entries']}/{ledger['probes']} "
              f"probed iteration(s) reconciled"
              + (f", max |residual| {ledger['max_abs_residual']:.3e}"
                 if ledger["max_abs_residual"] is not None else "")
              + (" -> OK" if ledger["ok"] else
                 f" -> {len(ledger['violations'])} VIOLATION(S)"))
        for v in ledger["violations"]:
            print(f"  iteration {v.get('iteration')}: {v.get('leak')} "
                  f"term leaked (residual {v.get('residual'):.3e})")
    return 0 if ledger["ok"] else 1


def _fmt_hist(hist) -> str:
    top = max(len(hist) - 1, 0)
    while top > 0 and not hist[top]:
        top -= 1
    return "[" + " ".join(str(int(v)) for v in hist[:top + 1]) + "]"


def _cmd_hlo(args) -> int:
    print("obs hlo: not applicable to the port: it lowers no program to "
          "HLO (ROADMAP.md's not-applicable list names obs/hlo.py); "
          "'python -m pagerank_tpu_torch.analysis --compiled' reads the "
          "CUDA kernels' compile facts instead", file=sys.stderr)
    return int(ExitCode.USAGE)


def _cmd_fit(args) -> int:
    from pagerank_tpu_torch.obs import devices as devices_mod

    kwargs = {}
    if args.hbm_gb is not None:
        if args.hbm_gb <= 0:
            print("obs fit: --hbm-gb must be positive", file=sys.stderr)
            return 2
        kwargs["limit_bytes"] = int(args.hbm_gb * (1 << 30))
    if args.headroom is not None:
        if not 0 < args.headroom <= 1:
            print("obs fit: --headroom must be in (0, 1]",
                  file=sys.stderr)
            return 2
        kwargs["headroom"] = args.headroom
    try:
        res = devices_mod.fit_check(
            args.scale, ndev=args.ndev, edge_factor=args.edge_factor,
            dtype=args.dtype, accum_dtype=args.accum_dtype,
            vertex_sharded=args.vs_bounded or args.ndev > 1,
            device_build=not (args.host_build or args.vs_bounded),
            device_kind=args.device_kind, **kwargs,
        )
    except ValueError as e:
        print(f"obs fit: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report_mod._json_safe(res.to_json()),
                         indent=2, allow_nan=False))
    else:
        print(devices_mod.render_fit(res))
    return 0 if res.fits else 1


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _cmd_report(args) -> int:
    if len(args.paths) > 2:
        print("report takes one or two files", file=sys.stderr)
        return 2
    if args.against_history and len(args.paths) != 1:
        print("--against-history diffs exactly one report",
              file=sys.stderr)
        return 2
    try:
        reports = [report_mod.load_report(p) for p in args.paths]
    except (OSError, json.JSONDecodeError) as e:
        print(f"obs report: cannot load report: {e}", file=sys.stderr)
        return 2
    if args.against_history:
        try:
            records = history_mod.read_ledger(args.against_history)
        except ValueError as e:
            print(f"obs report: {e}", file=sys.stderr)
            return 2
        # The leg its ingest would file it under (the port names legs
        # by the engine's resolved layout).
        leg = history_mod.leg_name_for_report(reports[0])
        baseline, n = history_mod.baseline_pseudo_report(
            records, leg, env=reports[0].get("environment"))
        if baseline is None:
            print(f"obs report: ledger {args.against_history} has no "
                  f"'{leg}' records to baseline against",
                  file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps({"baseline": baseline, "b": reports[0]},
                             indent=2, allow_nan=False))
            return 0
        print(f"against history: leg '{leg}', baseline = median of "
              f"{n} ledger record(s) (A = baseline, B = this run)")
        print(report_mod.diff_reports(baseline, reports[0]))
        return 0
    if args.json:
        doc = (reports[0] if len(reports) == 1
               else {"a": reports[0], "b": reports[1]})
        print(json.dumps(doc, indent=2))
        return 0
    if len(reports) == 1:
        print(report_mod.render_report(reports[0]))
    else:
        print(report_mod.diff_reports(reports[0], reports[1]))
    return 0


def _cmd_history(args) -> int:
    try:
        if args.history_command == "ingest":
            added, deduped = history_mod.ingest_paths(args.ledger,
                                                      args.files)
            if args.json:
                print(json.dumps({"added": added, "deduped": deduped},
                                 allow_nan=False))
            else:
                print(f"ingested {added} record(s) into {args.ledger}"
                      + (f" ({deduped} duplicate(s) skipped)"
                         if deduped else ""))
            return 0
        # trend/gate READ the ledger: a missing path is a usage error
        # (a mistyped ledger in CI must not gate green on "empty"),
        # while `ingest` legitimately creates it.
        records = history_mod.read_ledger(args.ledger)
        if not records and not os.path.exists(args.ledger):
            print(f"obs history: no such ledger: {args.ledger}",
                  file=sys.stderr)
            return int(ExitCode.USAGE)
        budgets = (history_mod.load_budgets(args.budgets)
                   if args.budgets else None)
        if args.history_command == "trend":
            if args.json:
                print(json.dumps(records, indent=2, allow_nan=False))
            else:
                print(history_mod.render_trend(
                    records,
                    detection=(budgets or {}).get("detection")))
            return 0
        # gate
        if args.record:
            rec = history_mod.normalize_result(
                _load_json(args.record), source=args.record)
            records = list(records) + [rec]
        res = history_mod.evaluate_gate(records, budgets)
        prop = None
        if args.propose_budgets:
            if budgets is None:
                print("obs history: --propose-budgets needs --budgets "
                      "(there is nothing to refresh without the "
                      "checked-in floors)", file=sys.stderr)
                return int(ExitCode.USAGE)
            prop = history_mod.propose_budgets(records, budgets)
            with open(args.propose_budgets, "w") as f:
                f.write(json.dumps(
                    report_mod._json_safe(prop["proposal"]),
                    indent=2, allow_nan=False) + "\n")
        if args.json:
            doc = res.to_dict()
            if prop is not None:
                doc = {"gate": doc,
                       "proposal": {"changes": prop["changes"],
                                    "skipped": prop["skipped"],
                                    "out": args.propose_budgets}}
            print(json.dumps(doc, indent=2, allow_nan=False))
        else:
            for line in res.notes:
                print(f"gate: {line}")
            for line in res.improvements:
                print(f"gate: IMPROVEMENT {line}")
            for line in res.drift_warnings:
                print(f"gate: WARNING {line}")
            for line in res.violations:
                print(f"gate: FAIL {line}")
            print("gate: " + ("PASS" if res.ok else "FAIL")
                  + (f" ({len(res.drift_warnings)} drift warning(s))"
                     if res.drift_warnings else ""))
            if prop is not None:
                for c in prop["changes"]:
                    print(f"propose: {c['leg']}.{c['metric']} "
                          f"{c['bound']} {c['old']:.4g} -> "
                          f"{c['new']:.4g} (median {c['median']:.4g} "
                          f"over {c['n']} row(s))")
                for s in prop["skipped"]:
                    print(f"propose: {s['leg']}.{s['metric']} "
                          f"unchanged — {s['rows']} matching row(s), "
                          f"need {s['needed']}")
                print(f"propose: wrote {args.propose_budgets}")
        # The exit-code taxonomy (exitcodes.py): FAILURE
        # is a judged-bad gate, USAGE a bad/missing invocation.
        return int(ExitCode.OK if res.ok else ExitCode.FAILURE)
    except (OSError, json.JSONDecodeError, ValueError) as e:
        print(f"obs history: {e}", file=sys.stderr)
        return int(ExitCode.USAGE)


def _cmd_campaign(args) -> int:
    """The campaign orchestrator CLI (obs/campaign.py)."""
    from pagerank_tpu_torch.obs import campaign as campaign_mod

    if args.campaign_command == "status":
        try:
            _spec, manifest, _docs, _metas = \
                campaign_mod.load_campaign(args.campaign_dir)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"obs campaign: no campaign in "
                  f"{args.campaign_dir}: {e}", file=sys.stderr)
            return int(ExitCode.USAGE)
        if args.json:
            print(json.dumps(report_mod._json_safe(manifest),
                             indent=2, allow_nan=False))
        else:
            print(campaign_mod.render_status(manifest))
        return int(ExitCode.OK)

    if args.campaign_command == "report":
        try:
            spec, manifest, docs, metas = \
                campaign_mod.load_campaign(args.campaign_dir)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"obs campaign: no campaign in "
                  f"{args.campaign_dir}: {e}", file=sys.stderr)
            return int(ExitCode.USAGE)
        budgets = campaign_mod._load_budgets_quiet(
            args.budgets or campaign_mod.default_budgets_path())
        rep = campaign_mod.build_report(spec, manifest, docs, metas,
                                        budgets, full=args.full)
        if args.json:
            sys.stdout.write(report_mod.canonical_json(rep))
        else:
            print(campaign_mod.render_report(rep))
        return int(ExitCode.OK if rep.get("complete")
                   else ExitCode.FAILURE)

    # run
    from pagerank_tpu_torch import jobs

    if args.fake_devices < 0:
        print("obs campaign: --fake-devices must be >= 0",
              file=sys.stderr)
        return int(ExitCode.USAGE)
    profile = args.profile
    if profile == "auto":
        profile = "smoke" if args.fake_devices else "roadmap"
    device = args.device
    ndev = args.ndev
    if args.fake_devices:
        # The dry run's group: N gloo ranks sharing the one device (an
        # indexed card, never one card a rank).
        ndev = args.fake_devices
        if device == "cuda":
            device = "cuda:0"
    spec = campaign_mod.build_spec(profile=profile, ndev=ndev,
                                   device=device)
    runner = campaign_mod.CampaignRunner(
        args.campaign_dir, spec, fake_devices=args.fake_devices,
        budgets_path=args.budgets)
    drain = jobs.GracefulDrain(deadline_s=args.drain_deadline)
    with drain:
        try:
            runner.run(drain=drain,
                       progress=lambda line: print(line,
                                                   file=sys.stderr))
        except jobs.DrainInterrupt as e:
            runner.interrupt(str(e))
            print(f"obs campaign: drained on signal ({e}); completed "
                  "legs are durable — resume with the same command",
                  file=sys.stderr)
            return int(ExitCode.INTERRUPTED)
    rep = runner.write_report()
    if args.json:
        sys.stdout.write(report_mod.canonical_json(rep))
    else:
        print(campaign_mod.render_report(rep))
        print(f"report written to {runner.report_path}",
              file=sys.stderr)
    return int(ExitCode.OK if rep.get("complete")
               else ExitCode.FAILURE)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "report":
        return _cmd_report(args)
    if args.command == "fit":
        return _cmd_fit(args)
    if args.command == "hlo":
        return _cmd_hlo(args)
    if args.command == "graph":
        return _cmd_graph(args)
    if args.command == "campaign":
        return _cmd_campaign(args)
    return _cmd_history(args)


if __name__ == "__main__":
    sys.exit(main())
