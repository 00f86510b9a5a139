"""The campaign plane: a resumable measurement-campaign orchestrator
with typed verdicts and a decision ledger.

Port of ``pagerank_tpu/obs/campaign.py``: the same :class:`LegSpec`,
:class:`CampaignSpec`, runner (checksummed per-leg artifacts keyed by a
content hash of the leg's parameters, resume by artifact validation,
the SIGTERM drain to exit 75 at a leg boundary, ``jobs.GracefulDrain``
wired in ``obs/__main__``), stable report and decision ledger. The legs
run in process: the port's ``obs`` CLI (``fit``, ``graph``), its bench
(``python -m pagerank_tpu_torch.bench``: couple, ``--multichip``,
``--ppr-serve``) and its history gate.

What differs on the H100:

* The leg order keeps ``fit``, ``graph``, ``bench_couple``,
  ``bench_multichip``, ``ppr_serve`` and ``history_gate`` with the JAX
  geometry, and drops the ``hlo`` leg and its ``gather_native``
  precondition: the port lowers no HLO (``obs hlo`` exits 2).
* Four verdicts (:data:`VERDICTS`): ``partitioned_vs_default``,
  ``halo_vs_dense``, ``async_overlap``, ``ppr_serve_floors``, and
  ``history.propose_budgets``, unchanged. ``pallas_keep_or_delete`` is
  dropped: its decisions name the JAX package's Pallas kernel, which the
  port replaced by hand-written CUDA.
* ``partitioned_vs_default``'s ``model_bytes_per_edge``, ``model_ratio``
  and ``model_fraction_realized`` are the JAX package's byte model of
  its TPU step pipeline, kept so that both packages give the same
  verdict on the same documents (``partitioned_hlo_bytes_per_edge``
  stays null: the port lowers no HLO). Where the legs carry the port's
  own model (``costs.step.bytes_per_edge``, as every port record does),
  the evidence adds it as ``port_bytes_per_edge`` and
  ``port_model_ratio``, and the reason quotes that ratio.
* ``device`` (``build_spec``) is forwarded to the legs that take
  ``--device`` (the graph leg and the bench legs).
* Budgets are read from the root ``perf_budgets.json`` as data; its
  floors are scoped to ``{"backend": "tpu"}`` and never fire on a card's
  record.

Non-binding mode: ``campaign run --fake-devices N`` runs every leg at
smoke scale with the multichip leg over N gloo ranks on the one device;
preconditions downgrade to warnings and every verdict's decision is
``defer`` (the would-be decision is kept in its evidence), so an
interrupted-then-resumed dry run renders a report byte-identical
(``report.canonical_json``) to an uninterrupted one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from pagerank_tpu_torch import jobs
from pagerank_tpu_torch.utils import fsio

SCHEMA_VERSION = 1
MANIFEST_NAME = "campaign.json"
REPORT_NAME = "report.json"
LEDGER_NAME = "campaign_ledger.jsonl"

#: The partition-centric byte model (arXiv:1709.07122) of the JAX
#: package's verdict: modeled bytes touched per edge of the default
#: 'step' gather pipeline against the partitioned layout. Kept as the
#: JAX verdict has it, so that both give the same decision and evidence
#: on the same documents; the port's own byte models ride each bench
#: leg's ``costs`` block.
MODEL_BYTES_PER_EDGE = {"default_step": 588.6, "partitioned": 165.7}

#: Flip thresholds — deliberately far below the model ratio (~3.55x):
#: a default flip needs a REAL, reproducible win, not a tie broken in
#: the new code's favor.
PARTITIONED_FLIP_MIN_RATIO = 1.10
#: Async halo flips the default only when overlap buys >= 5% of step
#: wall AND stale boundaries did not blow up iterations-to-tol.
ASYNC_FLIP_MIN_GAIN = 0.05
ASYNC_MAX_ITER_PENALTY = 1.5
#: Serving floors are TIGHTENED (not just kept) when measured
#: throughput clears the current floor by >= 20%.
SERVE_TIGHTEN_MARGIN = 1.20

NONBINDING_REASON = (
    "non-binding dry run on fake devices; the measured would-be "
    "decision is preserved in this verdict's evidence block"
)


# -- spec --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LegSpec:
    """One campaign leg: an in-process entrypoint + params, a wall
    budget, preconditions over earlier legs' documents, and the typed
    verdicts extracted from this leg's artifact."""

    name: str
    entrypoint: str                       # ENTRYPOINTS key
    params: Dict[str, object]             # JSON-able entrypoint input
    budget_s: float
    preconditions: Tuple[str, ...] = ()   # PRECONDITIONS keys
    verdicts: Tuple[str, ...] = ()        # VERDICTS keys

    def to_doc(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "entrypoint": self.entrypoint,
            "params": self.params,
            "budget_s": self.budget_s,
            "preconditions": list(self.preconditions),
            "verdicts": list(self.verdicts),
        }


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    name: str
    legs: Tuple[LegSpec, ...]

    def to_doc(self) -> Dict[str, object]:
        return {
            "schema_version": SCHEMA_VERSION,
            "name": self.name,
            "legs": [leg.to_doc() for leg in self.legs],
        }

    @staticmethod
    def from_doc(doc: Dict[str, object]) -> "CampaignSpec":
        legs = tuple(
            LegSpec(
                name=d["name"], entrypoint=d["entrypoint"],
                params=d.get("params") or {},
                budget_s=float(d.get("budget_s", 0.0)),
                preconditions=tuple(d.get("preconditions") or ()),
                verdicts=tuple(d.get("verdicts") or ()),
            )
            for d in doc.get("legs", [])
        )
        return CampaignSpec(name=str(doc.get("name", "campaign")),
                            legs=legs)


def default_budgets_path() -> str:
    """The checked-in perf_budgets.json at the repo root."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "perf_budgets.json")


def build_spec(profile: str = "roadmap", ndev: int = 8,
               device: Optional[str] = None) -> CampaignSpec:
    """THE checked-in campaign: the ROADMAP's order of operations
    (`obs fit` -> `obs graph` -> bench couple -> bench --multichip ->
    bench --ppr-serve -> `obs history gate`) as a declarative spec.
    ``roadmap`` is the binding session's geometry; ``smoke`` the dry
    run's, which the tier-1 tests and acceptance smoke AA run end to
    end. ``device`` (None: each leg's default, cuda) is passed as
    ``--device`` to the legs that take it."""
    if profile not in ("roadmap", "smoke"):
        raise ValueError(f"unknown campaign profile {profile!r} "
                         "(choices: roadmap, smoke)")
    smoke = profile == "smoke"
    ndev = max(int(ndev), 1)
    # Geometry: smoke stays tiny (every leg builds and runs in seconds);
    # roadmap is the ROADMAP's measured-session geometry.
    couple_scale = 8 if smoke else 23
    mc_scale = 8 if smoke else 24
    serve_scale = 8 if smoke else 22
    iters = 2 if smoke else 40
    graph_scale = 8 if smoke else 20
    acc_scale = 8 if smoke else 20
    serve_queries = 24 if smoke else 400
    serve_qps = 400 if smoke else 100
    on = ["--device", str(device)] if device else []
    # Wall budgets: smoke budgets are GENEROUS (an over-budget flag in
    # the stable report would break dry-run byte-identity on a slow
    # host); roadmap budgets bound a wedged leg.
    legs = (
        LegSpec(
            "fit", "obs_cli",
            {"argv": ["fit", "--scale", str(mc_scale),
                      "--ndev", str(ndev), "--json"]},
            budget_s=120.0 if smoke else 300.0,
        ),
        LegSpec(
            "graph", "obs_cli",
            {"argv": ["graph", "--scale", str(graph_scale),
                      "--ndev", str(ndev),
                      "--iters", "2" if smoke else "4", "--json", *on]},
            budget_s=180.0 if smoke else 1800.0,
        ),
        LegSpec(
            "bench_couple", "bench",
            {"argv": ["--scale", str(couple_scale),
                      "--iters", str(iters),
                      "--accuracy-scale", str(acc_scale), *on]},
            budget_s=600.0 if smoke else 3600.0,
            verdicts=("partitioned_vs_default",),
        ),
        LegSpec(
            "bench_multichip", "bench",
            {"argv": ["--multichip", "--scale", str(mc_scale),
                      "--multichip-devices", str(ndev),
                      "--iters", str(iters),
                      "--accuracy-scale", str(acc_scale), *on]},
            budget_s=600.0 if smoke else 3600.0,
            preconditions=("fits",),
            verdicts=("halo_vs_dense", "async_overlap"),
        ),
        LegSpec(
            "ppr_serve", "bench",
            {"argv": ["--ppr-serve", "--scale", str(serve_scale),
                      "--serve-queries", str(serve_queries),
                      "--serve-qps", str(serve_qps), *on]},
            budget_s=300.0 if smoke else 1800.0,
            verdicts=("ppr_serve_floors",),
        ),
        LegSpec(
            "history_gate", "history_gate",
            {"ingest": ["bench_couple", "bench_multichip", "ppr_serve"]},
            budget_s=60.0 if smoke else 120.0,
            preconditions=("have_bench_evidence",),
        ),
    )
    return CampaignSpec(name=f"roadmap-{profile}", legs=legs)


# -- entrypoints -------------------------------------------------------------
# Each entrypoint runs IN-PROCESS (the campaign is one resumable
# command, not a shell script), captures the command's one-JSON-object
# stdout, and returns the leg document:
#   {"command": [...], "exit_code": int, "output": <parsed JSON>}
# Meaningful nonzero exits (fit says "won't fit", hlo says "gather
# defeated", gate says "budget breached") are DATA the preconditions
# and verdicts read, not leg failures; only an unparseable/absent
# document fails the leg.


def _ep_obs_cli(params: Dict[str, object], ctx: Dict[str, object]):
    from pagerank_tpu_torch.obs import __main__ as obs_cli

    argv = [str(a) for a in params["argv"]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_cli.main(list(argv))
    text = buf.getvalue().strip()
    if not text:
        raise RuntimeError(f"obs {argv[0]} produced no JSON document "
                           f"(exit {rc})")
    return {"command": ["obs", *argv], "exit_code": int(rc),
            "output": json.loads(text)}


def _ep_bench(params: Dict[str, object], ctx: Dict[str, object]):
    from pagerank_tpu_torch import bench
    from pagerank_tpu_torch.obs import report as report_mod

    argv = [str(a) for a in params["argv"]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        doc = bench.main(list(argv))
    if doc is None:
        raise RuntimeError(f"bench {argv} produced no record")
    return {"command": ["bench", *argv], "exit_code": 0,
            "output": report_mod._json_safe(doc)}


def _ep_history_gate(params: Dict[str, object], ctx: Dict[str, object]):
    """The campaign's own gate leg: normalize the earlier bench legs'
    documents into a campaign-local ledger, run the CI perf gate
    against the session budgets, and (when budgets exist) derive the
    refreshed-floor proposal (history.propose_budgets) the decision
    ledger renders as a perf_budgets.json diff."""
    from pagerank_tpu_torch.obs import history

    ledger = os.path.join(str(ctx["dir"]), LEDGER_NAME)
    ingested = 0
    for leg_name in params.get("ingest", []):
        doc = (ctx["docs"].get(leg_name) or {})
        out = doc.get("output")
        if not isinstance(out, dict):
            continue
        rec = history.normalize_result(out, source=f"campaign:{leg_name}")
        ingested += int(history.append_record(ledger, rec))
    records = history.read_ledger(ledger)
    budgets = None
    budgets_path = ctx.get("budgets_path")
    if budgets_path:
        try:
            budgets = history.load_budgets(str(budgets_path))
        except (OSError, ValueError, json.JSONDecodeError):
            budgets = None
    res = history.evaluate_gate(records, budgets)
    output = {
        "gate": res.to_dict(),
        "ingested": ingested,
        "records": len(records),
        "budgets_path": budgets_path,
    }
    if budgets is not None:
        prop = history.propose_budgets(records, budgets)
        output["proposal"] = {"changes": prop["changes"],
                              "skipped": prop["skipped"]}
    return {"command": ["obs", "history", "gate"],
            "exit_code": 0 if res.ok else 1, "output": output}


ENTRYPOINTS: Dict[str, Callable] = {
    "obs_cli": _ep_obs_cli,
    "bench": _ep_bench,
    "history_gate": _ep_history_gate,
}


# -- preconditions -----------------------------------------------------------
# Pure predicates over the documents of EARLIER legs. In a binding
# run a failed precondition BLOCKS the leg (no point burning an hour
# of card time on a geometry that provably won't fit); in a
# non-binding dry run it downgrades to a recorded warning and the leg
# runs anyway — the dry run's whole job is exercising every leg.


def _get(doc, *path):
    """None-tolerant nested lookup: any missing key / non-dict hop
    yields None instead of a KeyError — degraded artifacts are a
    first-class verdict input, not a crash."""
    cur = doc
    for key in path:
        if not isinstance(cur, dict):
            return None
        cur = cur.get(key)
    return cur


def _pc_fits(docs) -> Tuple[bool, str]:
    doc = docs.get("fit")
    if doc is None:
        return False, "fit leg produced no artifact"
    fits = _get(doc, "output", "fits")
    if fits is None:
        return False, "fit leg carries no fits field"
    if not fits:
        return False, "fit check says the geometry does NOT fit per-chip HBM"
    return True, "fit check passed"


def _pc_have_bench_evidence(docs) -> Tuple[bool, str]:
    have = [name for name in ("bench_couple", "bench_multichip",
                              "ppr_serve")
            if isinstance(_get(docs.get(name), "output"), dict)]
    if not have:
        return False, "no bench leg produced a record to gate"
    return True, "bench evidence present: " + ", ".join(have)


PRECONDITIONS: Dict[str, Callable] = {
    "fits": _pc_fits,
    "have_bench_evidence": _pc_have_bench_evidence,
}


# -- typed verdicts ----------------------------------------------------------
# Each extractor is a pure function (leg output doc, budgets doc) ->
# (decision, reason, evidence). Decisions come from a CLOSED
# vocabulary (ACTION_TEXT) — a campaign report can be diffed and
# machine-applied; prose cannot.


def _budget_bound(budgets, leg: str, metric: str, bound: str):
    for b in (budgets or {}).get("budgets") or []:
        if b.get("leg") == leg and b.get("metric") == metric \
                and bound in b:
            try:
                return float(b[bound])
            except (TypeError, ValueError):
                return None
    return None


def _ratio(num, den):
    try:
        num, den = float(num), float(den)
    except (TypeError, ValueError):
        return None
    if den == 0:
        return None
    return num / den


def _v_partitioned_vs_default(out, budgets):
    part = _get(out, "partitioned_f32", "value")
    base = _get(out, "fast_f32", "value")
    ratio = _ratio(part, base)
    model_ratio = (MODEL_BYTES_PER_EDGE["default_step"]
                   / MODEL_BYTES_PER_EDGE["partitioned"])
    evidence = {
        "partitioned_f32_value": part,
        "fast_f32_value": base,
        "measured_ratio": ratio,
        "model_bytes_per_edge": dict(MODEL_BYTES_PER_EDGE),
        "model_ratio": model_ratio,
        "flip_min_ratio": PARTITIONED_FLIP_MIN_RATIO,
        "partitioned_hlo_bytes_per_edge": _get(
            out, "partitioned_f32", "lowering", "step",
            "hlo_bytes_per_edge"),
    }
    port = {leg: _get(out, leg, "costs", "step", "bytes_per_edge")
            for leg in ("fast_f32", "partitioned_f32")}
    headroom = f"model headroom {model_ratio:.2f}x"
    if any(v is not None for v in port.values()):
        evidence["port_bytes_per_edge"] = port
        evidence["port_model_ratio"] = _ratio(port["fast_f32"],
                                              port["partitioned_f32"])
        if evidence["port_model_ratio"] is not None:
            headroom = (f"the port's model headroom "
                        f"{evidence['port_model_ratio']:.2f}x")
    if ratio is None:
        return ("inconclusive",
                "bench_couple record lacks partitioned_f32/fast_f32 "
                "rate values", evidence)
    evidence["model_fraction_realized"] = _ratio(ratio - 1.0,
                                                 model_ratio - 1.0)
    if ratio >= PARTITIONED_FLIP_MIN_RATIO:
        return ("flip_partitioned_to_default",
                f"partitioned layout measured {ratio:.2f}x the fast_f32 "
                f"step form ({headroom})", evidence)
    return ("keep_step_default",
            f"partitioned layout measured {ratio:.2f}x, below the "
            f"{PARTITIONED_FLIP_MIN_RATIO:.2f}x flip threshold",
            evidence)


def _v_halo_vs_dense(out, budgets):
    sparse = _get(out, "sparse_exchange", "value")
    dense = _get(out, "dense_exchange", "value")
    ratio = _ratio(sparse, dense)
    evidence = {
        "sparse_value": sparse,
        "dense_value": dense,
        "measured_ratio": ratio,
        "exchange_fraction": _get(out, "sparse_exchange",
                                  "attribution", "exchange_fraction"),
        "achieved_bytes_per_sec": _get(out, "sparse_exchange",
                                       "attribution",
                                       "achieved_bytes_per_sec"),
        "halo_fraction": _get(out, "exchanged_bytes", "halo_fraction"),
        "head_k": _get(out, "exchanged_bytes", "head_k"),
        "sparse_below_dense_bytes": _get(out, "exchanged_bytes",
                                         "sparse_below_dense"),
    }
    if ratio is None:
        return ("inconclusive",
                "multichip record lacks sparse/dense exchange rate "
                "values", evidence)
    if ratio >= 1.0 and evidence["sparse_below_dense_bytes"] is not False:
        return ("keep_sparse_halo_default",
                f"sparse halo exchange measured {ratio:.2f}x the dense "
                "all-gather at the session geometry", evidence)
    return ("prefer_dense_exchange",
            f"sparse halo exchange measured {ratio:.2f}x the dense "
            "all-gather — the halo bookkeeping does not pay for "
            "itself here", evidence)


def _v_async_overlap(out, budgets):
    below = _get(out, "exchange_overlap", "async_below_sync_sum")
    gain = _get(out, "exchange_overlap", "gain")
    sync_iters = _get(out, "staleness_sweep", "legs", "sync",
                      "iters_to_tol")
    async_iters = _get(out, "staleness_sweep", "legs", "async_lag1",
                       "iters_to_tol")
    converged = _get(out, "staleness_sweep", "legs", "async_lag1",
                     "converged")
    iter_penalty = _ratio(async_iters, sync_iters)
    evidence = {
        "async_below_sync_sum": below,
        "gain": gain,
        "sync_compute_plus_exchange_s": _get(
            out, "exchange_overlap", "sync_compute_plus_exchange_s"),
        "async_step_s": _get(out, "exchange_overlap", "async_step_s"),
        "sync_iters_to_tol": sync_iters,
        "async_lag1_iters_to_tol": async_iters,
        "async_lag1_converged": converged,
        "iter_penalty": iter_penalty,
        "flip_min_gain": ASYNC_FLIP_MIN_GAIN,
        "max_iter_penalty": ASYNC_MAX_ITER_PENALTY,
    }
    if below is None or gain is None:
        return ("inconclusive",
                "multichip record lacks the exchange_overlap "
                "attribution block", evidence)
    if converged is False:
        return ("keep_synchronous_exchange",
                "lag-1 stale boundaries failed to converge at the gate "
                "tolerance — wall gain is moot", evidence)
    if iter_penalty is not None and iter_penalty > ASYNC_MAX_ITER_PENALTY:
        return ("keep_synchronous_exchange",
                f"async convergence penalty {iter_penalty:.2f}x "
                f"iterations exceeds the {ASYNC_MAX_ITER_PENALTY:.1f}x "
                "bound — overlap gain is eaten by extra iterations",
                evidence)
    if below and gain >= ASYNC_FLIP_MIN_GAIN:
        return ("flip_halo_async_default",
                f"async step wall sits {gain:.1%} below the sync "
                "compute+exchange sum with acceptable convergence",
                evidence)
    return ("keep_synchronous_exchange",
            f"overlap gain {gain:.1%} below the "
            f"{ASYNC_FLIP_MIN_GAIN:.0%} flip threshold", evidence)


def _v_ppr_serve_floors(out, budgets):
    qps = _get(out, "value")
    p99 = _get(out, "p99_ms")
    shed = _get(out, "shed_fraction")
    floors = {
        "queries_per_sec_min": _budget_bound(budgets, "ppr_serve",
                                             "queries_per_sec", "min"),
        "p99_ms_max": _budget_bound(budgets, "ppr_serve", "p99_ms",
                                    "max"),
        "shed_fraction_max": _budget_bound(budgets, "ppr_serve",
                                           "shed_fraction", "max"),
    }
    evidence = {
        "queries_per_sec": qps,
        "p99_ms": p99,
        "shed_fraction": shed,
        "floors": floors,
        "tighten_margin": SERVE_TIGHTEN_MARGIN,
    }
    if qps is None or p99 is None or shed is None:
        return ("inconclusive",
                "ppr_serve record lacks qps/p99/shed fields", evidence)
    if not any(v is not None for v in floors.values()):
        return ("inconclusive",
                "no ppr_serve floors in the budgets file to adjudicate "
                "against", evidence)
    violations = []
    if floors["queries_per_sec_min"] is not None \
            and qps < floors["queries_per_sec_min"]:
        violations.append("queries_per_sec below floor")
    if floors["p99_ms_max"] is not None and p99 > floors["p99_ms_max"]:
        violations.append("p99_ms above ceiling")
    if floors["shed_fraction_max"] is not None \
            and shed > floors["shed_fraction_max"]:
        violations.append("shed_fraction above ceiling")
    evidence["violations"] = violations
    if violations:
        return ("investigate_serve_regression",
                "serving floors violated: " + "; ".join(violations),
                evidence)
    if floors["queries_per_sec_min"] is not None \
            and qps >= floors["queries_per_sec_min"] * SERVE_TIGHTEN_MARGIN:
        return ("tighten_serve_floors",
                f"measured {qps:.3g} q/s clears the current floor "
                f"{floors['queries_per_sec_min']:.3g} by >= "
                f"{SERVE_TIGHTEN_MARGIN - 1:.0%} — adopt the proposed "
                "floors from the gate leg", evidence)
    return ("keep_serve_floors",
            "serving floors met without enough margin to tighten",
            evidence)


VERDICTS: Dict[str, Callable] = {
    "partitioned_vs_default": _v_partitioned_vs_default,
    "halo_vs_dense": _v_halo_vs_dense,
    "async_overlap": _v_async_overlap,
    "ppr_serve_floors": _v_ppr_serve_floors,
}

#: The decision ledger's closed decision -> human action vocabulary.
ACTION_TEXT = {
    # Verbatim the JAX tool's text: a dry run's stable report is
    # byte-identical to the JAX report of the same manifest.
    "defer": "DEFER — non-binding dry run on fake devices; rerun on "
             "TPU quota to adjudicate",
    "inconclusive": "INCONCLUSIVE — evidence missing or suspect; see "
                    "the verdict reason",
    "flip_partitioned_to_default": "flip the partition-centric layout "
        "to the couple default (engine auto-span; retire the step "
        "form from the headline)",
    "keep_step_default": "keep the step-form couple default; the "
        "partitioned layout did not clear the flip threshold",
    "keep_sparse_halo_default": "keep sparse halo exchange as the "
        "multichip default",
    "prefer_dense_exchange": "flip the multichip default to dense "
        "all-gather exchange at this geometry",
    "flip_halo_async_default": "flip async halo overlap on by default "
        "(parallel plane) and pin the staleness budget",
    "keep_synchronous_exchange": "keep synchronous halo exchange as "
        "the default",
    "tighten_serve_floors": "tighten the ppr_serve floors in "
        "perf_budgets.json to the gate leg's proposed values",
    "keep_serve_floors": "keep the current ppr_serve floors",
    "investigate_serve_regression": "serving floors violated — "
        "investigate the query plane before tightening anything",
}


def extract_verdict(vname: str, leg_name: str, doc, budgets,
                    binding: bool, over_budget: bool) -> Dict[str, object]:
    """Run one extractor and apply the campaign-level overrides: a
    missing artifact or (in a binding run) a blown wall budget forces
    ``inconclusive``; a non-binding run forces ``defer`` and demotes
    the measured would-be decision into the evidence block."""
    if doc is None:
        decision, reason, evidence = (
            "inconclusive", f"leg {leg_name} produced no artifact", {})
    else:
        decision, reason, evidence = VERDICTS[vname](
            _get(doc, "output"), budgets)
        if over_budget and binding:
            decision = "inconclusive"
            reason = (f"leg {leg_name} exceeded its wall budget; its "
                      "measurements are suspect and do not bind")
    if not binding:
        evidence = dict(evidence)
        evidence["would_decide"] = decision
        evidence["would_reason"] = reason
        decision, reason = "defer", NONBINDING_REASON
    return {"verdict": vname, "binding": binding, "decision": decision,
            "reason": reason, "evidence": evidence}


# -- runner ------------------------------------------------------------------


class CampaignRunner:
    """Execute a :class:`CampaignSpec` through the job-plane
    machinery: checksummed per-leg artifacts, an atomic advisory
    manifest, seeded process-kill chaos, drain checks at leg
    boundaries, and resume-by-artifact-validation."""

    def __init__(self, directory: str, spec: CampaignSpec,
                 fake_devices: int = 0,
                 budgets_path: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.directory = directory
        self.spec = spec
        self.fake_devices = int(fake_devices)
        self.budgets_path = budgets_path or default_budgets_path()
        self.clock = clock
        self.docs: Dict[str, Dict] = {}
        self.metas: Dict[str, Dict] = {}
        fsio.makedirs(directory)
        self.manifest = self._load_or_init_manifest()
        # Seeded process-kill chaos (testing/faults.py): active only
        # when the env plan is set — zero cost otherwise. Leg names
        # are the chaos stages.
        from pagerank_tpu_torch.testing.faults import ProcessKillPlan

        self.chaos = ProcessKillPlan.from_env()

    # -- manifest ------------------------------------------------------------

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    @property
    def report_path(self) -> str:
        return os.path.join(self.directory, REPORT_NAME)

    def _load_or_init_manifest(self) -> Dict:
        try:
            with open(self.manifest_path) as f:
                m = json.load(f)
        except (OSError, json.JSONDecodeError):
            m = None
        if isinstance(m, dict) and m.get("kind") == "campaign":
            m["resumes"] = int(m.get("resumes", 0)) + 1
            m["status"] = "running"
            # The spec is re-stamped every run: artifact keys (not the
            # manifest) decide what survives a spec edit.
            m["spec"] = self.spec.to_doc()
            m["fake_devices"] = self.fake_devices
            m.setdefault("legs", {})
        else:
            m = {
                "schema_version": SCHEMA_VERSION,
                "kind": "campaign",
                "campaign": self.spec.name,
                "created_unix": time.time(),
                "resumes": 0,
                "status": "running",
                "fake_devices": self.fake_devices,
                "spec": self.spec.to_doc(),
                "legs": {},
            }
        return m

    def _write_manifest(self) -> None:
        with fsio.atomic_write(self.manifest_path, "w",
                               suffix=".tmp") as f:
            json.dump(self.manifest, f, indent=2, sort_keys=True)
            f.write("\n")

    def _set_leg(self, name: str, **fields) -> None:
        leg = self.manifest["legs"].setdefault(name, {})
        leg.update(fields)
        self._write_manifest()

    # -- artifacts -----------------------------------------------------------

    def leg_key(self, leg: LegSpec) -> str:
        return jobs.key_hash({
            "campaign": self.spec.name,
            "leg": leg.name,
            "entrypoint": leg.entrypoint,
            "params": leg.params,
            "fake_devices": self.fake_devices,
            "schema": SCHEMA_VERSION,
        })

    def artifact_path(self, idx: int, leg: LegSpec) -> str:
        return os.path.join(self.directory,
                            f"leg_{idx:02d}_{leg.name}.npz")

    def _try_resume_leg(self, idx: int, leg: LegSpec) -> Optional[Dict]:
        """A validated artifact with the expected key IS the leg —
        checksum + key mismatch both mean recompute, never trust."""
        path = self.artifact_path(idx, leg)
        try:
            arrays, meta = jobs.load_artifact(path)
        except FileNotFoundError:
            return None
        except jobs.ArtifactCorruptError:
            return None
        if meta.get("leg") != leg.name \
                or meta.get("key") != self.leg_key(leg):
            return None
        doc = jobs.doc_from_arrays(arrays)
        if doc is None:
            return None
        self.metas[leg.name] = meta
        return doc

    # -- execution -----------------------------------------------------------

    def run(self, drain=None,
            progress: Optional[Callable[[str], None]] = None) -> Dict:
        """Run (or resume) the campaign. Raises jobs.DrainInterrupt
        out of a SIGTERM drain at the next leg boundary — the caller
        (obs/__main__) owns the exit-75 translation."""
        say = progress or (lambda line: None)
        ctx = {"dir": self.directory, "docs": self.docs,
               "fake_devices": self.fake_devices,
               "budgets_path": self.budgets_path}
        failed = False
        for idx, leg in enumerate(self.spec.legs):
            if drain is not None:
                drain.check(f"campaign/{leg.name}")
            resumed = self._try_resume_leg(idx, leg)
            if resumed is not None:
                self.docs[leg.name] = resumed
                self._set_leg(leg.name, status="done", skipped=True)
                say(f"campaign: leg {leg.name} — validated artifact, "
                    "skipping")
                continue
            warnings: List[str] = []
            blocked = None
            for pc in leg.preconditions:
                ok, reason = PRECONDITIONS[pc](self.docs)
                if ok:
                    continue
                if self.fake_devices:
                    warnings.append(
                        f"{pc}: {reason} (non-binding dry run: leg "
                        "runs anyway)")
                else:
                    blocked = f"{pc}: {reason}"
                    break
            if blocked is not None:
                self._set_leg(leg.name, status="blocked", skipped=False,
                              error=blocked, warnings=warnings)
                say(f"campaign: leg {leg.name} BLOCKED — {blocked}")
                failed = True
                continue
            self._set_leg(leg.name, status="running", skipped=False,
                          warnings=warnings)
            say(f"campaign: leg {leg.name} — running "
                f"({leg.entrypoint} {leg.params})")
            if self.chaos is not None:
                self.chaos.check(leg.name)
            t0 = self.clock()
            try:
                doc = ENTRYPOINTS[leg.entrypoint](leg.params, ctx)
            except jobs.DrainInterrupt:
                raise
            except (Exception, SystemExit) as e:
                self._set_leg(leg.name, status="failed",
                              error=repr(e), wall_s=self.clock() - t0)
                say(f"campaign: leg {leg.name} FAILED — {e!r}")
                failed = True
                continue
            wall = self.clock() - t0
            meta = {
                "leg": leg.name,
                "key": self.leg_key(leg),
                "wall_s": wall,
                "budget_s": leg.budget_s,
                "over_budget": wall > leg.budget_s,
                "fake_devices": self.fake_devices,
            }
            jobs.save_artifact(self.artifact_path(idx, leg),
                               jobs.doc_to_arrays(doc), meta)
            self.docs[leg.name] = doc
            self.metas[leg.name] = meta
            self._set_leg(leg.name, status="done", skipped=False,
                          wall_s=wall, over_budget=meta["over_budget"])
            say(f"campaign: leg {leg.name} done in {wall:.1f}s"
                + (" (OVER BUDGET)" if meta["over_budget"] else ""))
        self.manifest["status"] = "failed" if failed else "complete"
        self._write_manifest()
        return self.docs

    def interrupt(self, where: str) -> None:
        """SIGTERM drain landed: record it without downgrading any
        completed leg — the artifacts already on disk are the truth
        resume trusts."""
        self.manifest["status"] = "interrupted"
        self.manifest["interrupted_at"] = where
        self._write_manifest()

    def write_report(self, budgets=None) -> Dict:
        """Render + atomically persist the STABLE report (canonical
        bytes — the resume byte-identity contract)."""
        from pagerank_tpu_torch.obs import report as report_mod

        if budgets is None:
            budgets = _load_budgets_quiet(self.budgets_path)
        rep = build_report(self.spec, self.manifest, self.docs,
                           self.metas, budgets)
        with fsio.atomic_write(self.report_path, "w",
                               suffix=".tmp") as f:
            f.write(report_mod.canonical_json(rep))
        return rep


def _load_budgets_quiet(path: Optional[str]):
    if not path:
        return None
    from pagerank_tpu_torch.obs import history

    try:
        return history.load_budgets(path)
    except (OSError, ValueError, json.JSONDecodeError):
        return None


# -- report ------------------------------------------------------------------


def load_campaign(directory: str):
    """Rebuild (spec, manifest, docs, metas) from a campaign dir —
    report/status never re-run anything. Raises FileNotFoundError
    when the directory holds no campaign manifest."""
    path = os.path.join(directory, MANIFEST_NAME)
    with open(path) as f:
        manifest = json.load(f)
    if not isinstance(manifest, dict) \
            or manifest.get("kind") != "campaign":
        raise ValueError(f"{path} is not a campaign manifest")
    spec = CampaignSpec.from_doc(manifest.get("spec") or {})
    docs: Dict[str, Dict] = {}
    metas: Dict[str, Dict] = {}
    for idx, leg in enumerate(spec.legs):
        apath = os.path.join(directory,
                             f"leg_{idx:02d}_{leg.name}.npz")
        try:
            arrays, meta = jobs.load_artifact(apath)
        except (FileNotFoundError, jobs.ArtifactCorruptError):
            continue
        if meta.get("leg") != leg.name:
            continue
        doc = jobs.doc_from_arrays(arrays)
        if doc is None:
            continue
        docs[leg.name] = doc
        metas[leg.name] = meta
    return spec, manifest, docs, metas


def build_report(spec: CampaignSpec, manifest: Dict, docs: Dict,
                 metas: Dict, budgets=None,
                 full: bool = False) -> Dict:
    """The campaign report. The stable form (full=False) is a pure
    function of spec identity + leg statuses + verdict DECISIONS —
    no walls, no timestamps, no resume counts, and (non-binding) no
    measured numbers — so resumed and uninterrupted dry runs render
    byte-identical documents. ``full`` adds the volatile evidence:
    per-verdict measurements, per-leg walls, and the raw leg docs."""
    binding = not manifest.get("fake_devices")
    leg_states = manifest.get("legs") or {}
    legs_out = []
    verdicts: Dict[str, Dict] = {}
    for leg in spec.legs:
        st = leg_states.get(leg.name) or {}
        meta = metas.get(leg.name) or {}
        over = bool(meta.get("over_budget", False))
        legs_out.append({
            "name": leg.name,
            "entrypoint": leg.entrypoint,
            "status": st.get("status", "pending"),
            "within_budget": not over,
            "warnings": list(st.get("warnings") or []),
        })
        for vname in leg.verdicts:
            verdicts[vname] = extract_verdict(
                vname, leg.name, docs.get(leg.name), budgets,
                binding, over)
    complete = bool(legs_out) and all(
        e["status"] == "done" for e in legs_out)
    ledger = [f"[{v['verdict']}] {ACTION_TEXT[v['decision']]}"
              for v in (verdicts[k] for k in sorted(verdicts))]
    rep: Dict[str, object] = {
        "schema_version": SCHEMA_VERSION,
        "kind": "campaign_report",
        "campaign": spec.name,
        "binding": binding,
        "fake_devices": int(manifest.get("fake_devices") or 0),
        "complete": complete,
        "legs": legs_out,
        "verdicts": {
            k: {f: v[f] for f in ("verdict", "binding", "decision",
                                  "reason")}
            for k, v in verdicts.items()
        },
        "decision_ledger": ledger,
    }
    if binding:
        # The proposed perf_budgets diff (`history gate
        # --propose-budgets` shares the derivation) — measured numbers,
        # so binding reports only.
        changes = _get(docs.get("history_gate"), "output", "proposal",
                       "changes")
        rep["budget_proposal"] = {"changes": changes or []}
    if full:
        rep["evidence"] = {k: v["evidence"]
                           for k, v in verdicts.items()}
        rep["measured"] = {
            name: {"wall_s": meta.get("wall_s"),
                   "budget_s": meta.get("budget_s"),
                   "over_budget": meta.get("over_budget")}
            for name, meta in metas.items()
        }
        rep["resumes"] = manifest.get("resumes")
        rep["status"] = manifest.get("status")
        rep["leg_docs"] = docs
    return rep


def render_report(rep: Dict) -> str:
    """Human rendering of a campaign report: leg table + verdict
    table + the decision ledger."""
    lines = [
        f"campaign {rep.get('campaign')} — "
        + ("BINDING" if rep.get("binding") else
           f"non-binding dry run ({rep.get('fake_devices')} fake "
           "devices)")
        + (", complete" if rep.get("complete") else ", INCOMPLETE"),
    ]
    for leg in rep.get("legs") or []:
        mark = {"done": "ok", "failed": "FAILED",
                "blocked": "BLOCKED", "running": "running",
                "pending": "pending"}.get(leg.get("status"),
                                          str(leg.get("status")))
        lines.append(
            f"  leg {leg.get('name'):<16} {mark:<8}"
            + ("" if leg.get("within_budget", True)
               else " OVER BUDGET"))
        for w in leg.get("warnings") or []:
            lines.append(f"       warning: {w}")
    lines.append("verdicts:")
    for name in sorted(rep.get("verdicts") or {}):
        v = rep["verdicts"][name]
        lines.append(f"  {name:<24} -> {v.get('decision')}"
                     f" ({v.get('reason')})")
    lines.append("decision ledger:")
    for entry in rep.get("decision_ledger") or []:
        lines.append(f"  {entry}")
    changes = (rep.get("budget_proposal") or {}).get("changes")
    if changes:
        lines.append("proposed perf_budgets.json changes:")
        for c in changes:
            lines.append(
                f"  {c.get('leg')}/{c.get('metric')} {c.get('bound')}: "
                f"{c.get('old')} -> {c.get('new')} "
                f"(median {c.get('median')}, n={c.get('n')})")
    return "\n".join(lines)


def render_status(manifest: Dict) -> str:
    lines = [
        f"campaign {manifest.get('campaign')}: "
        f"{manifest.get('status')} "
        f"(resumes {manifest.get('resumes', 0)}, fake_devices "
        f"{manifest.get('fake_devices', 0)})",
    ]
    spec = manifest.get("spec") or {}
    states = manifest.get("legs") or {}
    for leg in spec.get("legs") or []:
        st = states.get(leg.get("name")) or {}
        extra = ""
        if st.get("wall_s") is not None:
            extra = f" ({st['wall_s']:.1f}s"
            extra += (" OVER BUDGET)" if st.get("over_budget")
                      else ")")
        if st.get("skipped"):
            extra += " [resumed: validated artifact]"
        if st.get("error"):
            extra += f" — {st['error']}"
        lines.append(f"  {leg.get('name'):<16} "
                     f"{st.get('status', 'pending'):<9}{extra}")
    return "\n".join(lines)
