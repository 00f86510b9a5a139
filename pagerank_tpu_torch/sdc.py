"""Silent-data-corruption defense (the
robustness plane).

The robustness planes so far cover chips that DIE (parallel/elastic.py
rescues device loss) and processes that die (jobs.py resumes them) —
but not chips that LIE: a flipped bit in the SpMV propagates through
every later iteration with no symptom the NaN/Inf health check or the
global ``--mass-tol`` scalar can see. PageRank is unusually well
suited to algorithm-based fault tolerance: the step is LINEAR, so a
handful of cheap redundant invariants localize a corruption to a
device, and recovery costs exactly one bounded re-execution —
asynchronous-iteration theory (Kollias et al., arXiv:cs/0606047)
guarantees convergence survives that kind of localized redo, and the
bf16-streamed leg (arXiv:2009.10443) is why the tolerances below are
DERIVED from dtype/edge-count rather than ad-hoc epsilons: rounding
and corruption must be distinguishable.

Three layers, all opt-in via ``--sdc-check-every K`` (0 = today's
step, bit-identical, ZERO check computations — the tracer/sampler
booby-trap discipline, tests/test_sdc.py):

1. **Detection** — every K-th step runs the engine's SDC-checked step
   (``JaxTpuEngine.step_sdc``): the rank-mass-ledger core
   plus per-device ABFT check partials computed INSIDE the step's own
   dispatch — local reductions only, the exact collective multiset of
   the plain step (contract PTC008). Host-side, four invariant
   families reconcile (:func:`evaluate_check`):

   - **copy consistency** (replicated forms): every device holds its
     own copy of the rank vector, and each computes the seeded
     random-projection fingerprint ``w . r`` over ITS buffer — the
     per-device values are bitwise equal absent corruption, so ANY
     divergent copy (mass-preserving flips included: ``w`` is a
     Rademacher vector, two cancelling flips cannot cancel in the
     projection) is detected AND localized in one pass;
   - **dual fingerprint** (every form): ``w . r`` is computed two
     independent ways — a standalone state dispatch at the boundary
     and the in-step check tail — so a buffer that changes between
     retiring and being consumed is caught, per-shard partials
     localizing the owner on sharded forms;
   - **link conservation** (every form): the contribution total
     (measured through the whole gather/segment-sum machinery) must
     equal the directly-measured source mass ``sum(r[out_degree>0])``
     — two independent computations of the same linear functional;
   - **mass-ledger identity** (every form): the rank-mass-ledger
     decomposition (teleport + link + retained + dangling vs measured
     mass) with its NAMED leak — the link/teleport/dangling corruption
     classes fall out of the existing ledger vocabulary.

2. **Localization + recovery** (:class:`SdcGuard`) — a breach
   triggers a deadline-bounded re-execution of the window since the
   last clean boundary from the RETAINED device-side state
   (double-buffered like the health-check rollback; the retained copy
   is taken at clean boundaries only, so a poisoned iterate is never
   retained). A clean redo classifies the episode TRANSIENT (counted,
   solve continues); a repeat breach attributing to the SAME device
   classifies STICKY and raises
   :class:`~pagerank_tpu_torch.parallel.elastic.DeviceQuarantinedError` —
   the elastic rescue path tears the mesh down and re-shards over the
   remaining devices with the convicted chip excluded, and the id is
   persisted (job.json + snapshot mesh_meta) so a resumed job never
   re-adopts a known-bad chip.

3. **Injection + telemetry** — ``testing/faults.DeviceFaultSchedule``
   grows seed-deterministic bit-flip kinds (mantissa/exponent/sign,
   chosen device/iteration, sticky or one-shot) so the whole
   detect -> localize -> redo -> quarantine machine runs on 8 fake CPU
   devices; ``sdc.*`` counters ride the metrics registry and the run
   report's ``sdc`` section (diffed by ``obs report``), and bench legs
   carry the measured per-checked-iteration overhead
   (``sdc_check_overhead_pct``).

Import cost: stdlib + numpy + obs.metrics (jax stays inside the
engine), the obs/graph_profile.py discipline.

Copy of ``pagerank_tpu/sdc.py``: the host logic as it is, over the
port's one-device engine. ``TorchEngine.step_sdc`` runs the same
contribution launch (K1, K2 or the coo segment sum) and update as
``step()`` plus a check tail of torch reductions fetched in one
transfer; a mesh position maps to the engine's device id
(``engine.device_ids()``), and ``DeviceQuarantinedError`` is the port's
(``parallel/elastic.py``).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np

from pagerank_tpu_torch.obs import log as obs_log
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.obs import trace as obs_trace
from pagerank_tpu_torch.parallel.elastic import DeviceQuarantinedError

#: Copy-consistency / dual-fingerprint tolerance factor: the redundant
#: computations are the SAME deterministic program over the same bits
#: (replicated copies; boundary state vs in-step tail), so they agree
#: to reduction-order rounding only — ``16 * eps * sqrt(n)`` bounds an
#: n-term accumulation-dtype sum's random-walk error with margin while
#: staying far below any single injected flip at realistic ranks.
SDC_COPY_TOL_FACTOR = 16.0

#: Analytic-invariant tolerance factor (link conservation): the two
#: sides accumulate over different term counts (E edge products vs n
#: vertex terms), so the bound follows the ``ledger_tolerance``
#: idiom over the LARGER count — ``64 * eps * sqrt(max(n, E))``.
SDC_TOL_FACTOR = 64.0

#: Detection floor: a flip whose projection deviation lands below the
#: derived tolerance is indistinguishable from rounding BY
#: CONSTRUCTION (that is what principled tolerances mean); the chaos
#: kinds (mantissa high bit, exponent, sign) all sit orders of
#: magnitude above it at any realistic rank magnitude.

_FLOAT_KINDS = (int, float, np.floating, np.integer)


def copy_tolerance(eps: float, n: int,
                   factor: float = SDC_COPY_TOL_FACTOR) -> float:
    """Relative tolerance for the redundant (copy/dual) invariants of
    an n-vertex state in a dtype with machine epsilon ``eps``."""
    return factor * float(eps) * max(1.0, math.sqrt(max(1, n)))


def sdc_tolerance(eps: float, n: int, num_edges: Optional[int] = None,
                  factor: float = SDC_TOL_FACTOR) -> float:
    """Relative tolerance for the analytic invariants (link
    conservation): dtype epsilon scaled by the square root of the
    LARGER accumulation count — vertex terms or edge products."""
    count = max(1, int(n), int(num_edges or 0))
    return factor * float(eps) * max(1.0, math.sqrt(count))


def fingerprint_vector(seed: int, n_state: int) -> np.ndarray:
    """The seeded random-projection vector ``w``: Rademacher (+-1)
    entries from a counter-based Philox stream, so the SAME (seed,
    length) yields the same vector on every host/process — exactly
    representable in every float dtype (the projection adds no
    quantization of its own)."""
    rng = np.random.Generator(np.random.Philox(key=int(seed)))
    return (rng.integers(0, 2, int(n_state)).astype(np.int8) * 2 - 1
            ).astype(np.float64)


# -- run-scoped summary (the graph_profile publish discipline) --------------

_SUMMARY: Dict[str, object] = {}
_QUARANTINE_HOOK = None


def set_quarantine_hook(fn) -> None:
    """Register the persistence sink convictions flow through AT
    conviction time (before the quarantine error even raises): the CLI
    points this at ``job.quarantine_devices`` so a sticky chip lands
    in job.json no matter which run mode convicted it — a run WITHOUT
    the elastic rescue wired still persists the id before dying, and
    the resumed job excludes the chip from its first mesh. Cleared by
    :func:`reset` (per-run scoping)."""
    global _QUARANTINE_HOOK
    _QUARANTINE_HOOK = fn


def _blank() -> Dict[str, object]:
    return {
        "checks": 0,
        "flips_detected": 0,
        "transient": 0,
        "sticky": 0,
        "redos": 0,
        "quarantined_devices": [],
        "last_breach": None,
    }


def reset() -> None:
    """Drop the run-scoped summary + quarantine hook (cli.main entry
    discipline)."""
    global _SUMMARY, _QUARANTINE_HOOK
    _SUMMARY = {}
    _QUARANTINE_HOOK = None


def _summary() -> Dict[str, object]:
    global _SUMMARY
    if not _SUMMARY:
        _SUMMARY = _blank()
    return _SUMMARY


def report_section() -> Dict[str, object]:
    """The run report's ``sdc`` section — empty on a disarmed run (the
    key still rides every report, null-shaped, like ``lowering``)."""
    return dict(_SUMMARY) if _SUMMARY else {}


# -- invariant evaluation ---------------------------------------------------


class SdcVerdict:
    """One boundary's reconciliation result: ``ok``; the breach
    ``reasons`` (kind, deviation, tol, per-invariant suspect); and the
    consolidated ``suspect`` — a MESH POSITION index (None when the
    breach does not localize from a single pass)."""

    def __init__(self, ok: bool, reasons: List[Dict[str, object]],
                 suspect: Optional[int]):
        self.ok = ok
        self.reasons = reasons
        self.suspect = suspect

    def describe(self) -> str:
        return "; ".join(
            f"{r['kind']} deviation {r['deviation']:.3e} > tol "
            f"{r['tol']:.3e}"
            + (f" (device position {r['suspect']})"
               if r.get("suspect") is not None else "")
            for r in self.reasons
        ) or "ok"


def _vec(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x, np.float64))


def _spread_suspect(v: np.ndarray) -> int:
    return int(np.argmax(np.abs(v - np.median(v))))


def evaluate_check(pre: Dict[str, object], chk: Dict[str, object], *,
                   damping: float, semantics: str, n: int,
                   num_edges: Optional[int], eps: float,
                   stale_slack: float = 0.0) -> SdcVerdict:
    """Reconcile one checked step's ABFT values.

    ``pre`` is the standalone boundary-state dispatch over the INPUT
    rank vector (``JaxTpuEngine.sdc_state_values``: fp/mass/src per
    device); ``chk`` is the checked step's own record (in-step
    fp/mass/src over the input, fp/mass over the output, and the
    ledger sums). Both carry per-device arrays — full-copy values on
    replicated forms, per-shard partials on sharded ones
    (``chk["sharded"]``).

    ``stale_slack`` (mass units): under the asynchronous
    stale-boundary step (config.halo_async) the measured contribution
    total mixes this iteration's own-block mass with LAST iteration's
    boundary mass, so the link-conservation and flow-conservation
    identities hold only up to the previous step's L1 delta. The
    engine passes that delta as the slack; it decays to zero as the
    solve converges, so detection power is recovered exactly where a
    long solve spends its time. The fingerprint/copy duals and the
    ledger identity residual are staleness-free and keep their sharp
    tolerances — a flipped bit in the state still convicts."""
    sharded = bool(chk.get("sharded"))
    scale = float(n) if semantics == "reference" else 1.0
    tol_copy = copy_tolerance(eps, n)
    tol_link = sdc_tolerance(eps, n, num_edges)
    reasons: List[Dict[str, object]] = []

    def breach(kind: str, deviation: float, tol: float,
               suspect: Optional[int]) -> None:
        reasons.append({
            "kind": kind,
            "deviation": float(deviation),
            "tol": float(tol),
            "suspect": suspect,
        })

    # 1. copy consistency (replicated forms): every per-device vector
    # must agree across the copies.
    if not sharded:
        for name in ("fp_in", "fp_out", "mass_in", "mass_out",
                     "src_in"):
            v = chk.get(name)
            if v is None:
                continue
            v = _vec(v)
            if v.size < 2:
                continue
            dev = float(v.max() - v.min()) / max(scale, 1e-30)
            if dev > tol_copy:
                breach(f"copy:{name}", dev, tol_copy,
                       _spread_suspect(v))

    # 2. dual fingerprint / dual mass: the standalone boundary dispatch
    # vs the in-step tail, over the same input buffers. Per-device
    # diffs localize on sharded forms; replicated diffs fold into the
    # copy check above but the total still guards the window between
    # the two dispatches.
    for a_name, b_name, kind in (("fp", "fp_in", "dual:fingerprint"),
                                 ("mass", "mass_in", "dual:mass"),
                                 ("src", "src_in", "dual:src")):
        a, b = pre.get(a_name), chk.get(b_name)
        if a is None or b is None:
            continue
        a, b = _vec(a), _vec(b)
        if a.shape != b.shape:
            continue
        diff = b - a
        dev = float(np.abs(diff).max()) / max(scale, 1e-30)
        if dev > tol_copy:
            breach(kind, dev, tol_copy,
                   int(np.argmax(np.abs(diff))) if sharded else
                   _spread_suspect(b))

    # 3. link conservation: contribution total (through the gather
    # machinery) vs the directly-measured source mass. Forms without a
    # prescale argument (coo) measure no src — the ledger identity
    # below still covers them.
    contrib_total = float(np.sum(_vec(chk["contrib"])))
    src = chk.get("src_in")
    if src is not None:
        src_total = (float(np.sum(_vec(src))) if sharded
                     else float(np.median(_vec(src))))
        dev = abs(contrib_total - src_total) / max(scale, 1e-30)
        tol_link_eff = tol_link + abs(stale_slack) / max(scale, 1e-30)
        if dev > tol_link_eff:
            suspect = None
            if sharded:
                d = _vec(chk["contrib"]) - _vec(src)
                suspect = (int(np.argmax(np.abs(d)))
                           if d.size > 1 else None)
            breach("link_conservation", dev, tol_link_eff, suspect)

    # 4. mass-ledger identity (the ledger vocabulary): the decomposition
    # names the leaking term — the link/teleport/dangling corruption
    # classes, at the SDC tolerance over the larger count.
    from pagerank_tpu_torch.obs import graph_profile

    mass_out = _vec(chk["mass_out"])
    mass = (float(mass_out.sum()) if sharded
            else float(np.median(mass_out)))
    mass_prev = float(np.sum(_vec(chk["mass_prev"])))
    entry = graph_profile.mass_ledger_entry(
        damping=damping, semantics=semantics, n=n, eps=eps,
        mass_prev=mass_prev, mass=mass,
        dangling_mass=float(chk["dangling_mass"]),
        contrib_total=contrib_total,
        retained_total=float(np.sum(_vec(chk["retained"]))),
        tol_factor=SDC_TOL_FACTOR * max(
            1.0, math.sqrt(max(1, num_edges or n) / max(1, n))),
        flow_slack=stale_slack,
    )
    if not entry["ok"]:
        breach(f"mass_ledger:{entry['leak']}",
               abs(entry["residual"])
               if entry["leak"] == "teleport"
               else abs(entry["unaccounted"] or 0.0),
               entry["tol"], None)

    suspects = [r["suspect"] for r in reasons
                if r.get("suspect") is not None]
    suspect = suspects[0] if suspects else None
    return SdcVerdict(not reasons, reasons, suspect)


def localize_diff(bad: Dict[str, object],
                  good: Dict[str, object]) -> Optional[int]:
    """Attribute a breach to a mesh position by diffing the breached
    attempt's per-device check vectors against a clean redo's — the
    deterministic step reproduces every value bit-for-bit absent
    corruption, so the mismatching position IS the suspect."""
    best, best_dev = None, 0.0
    for name in ("fp_in", "fp_out", "mass_in", "mass_out", "src_in",
                 "contrib"):
        a, b = bad.get(name), good.get(name)
        if a is None or b is None:
            continue
        a, b = _vec(a), _vec(b)
        if a.shape != b.shape or a.size < 2:
            continue
        d = np.abs(a - b)
        i = int(np.argmax(d))
        if float(d[i]) > best_dev:
            best, best_dev = i, float(d[i])
    return best


# -- the guard (detect -> redo -> classify -> quarantine) -------------------


class SdcExhaustedError(RuntimeError):
    """A breach survived the redo budget/deadline without attributing
    to one device — the state cannot be trusted and no chip can be
    convicted. Carries the boundary iteration and the last verdict
    text (the 3am-page diagnostic, the SolverHealthError contract)."""

    def __init__(self, message: str, iteration: int, redos: int):
        super().__init__(message)
        self.iteration = iteration
        self.redos = redos


def attach_guard(engine) -> Optional["SdcGuard"]:
    """Build the run's SDC guard, or None when disarmed — the solve
    loop then takes the exact unchecked code path (zero check
    computations, zero retained copies; tests/test_sdc.py
    booby-traps it). Armed on an engine that cannot measure the
    invariants (the CPU oracle; a form without a ledger core) warns
    once and stays off rather than silently degrading coverage."""
    every = int(getattr(engine.config, "sdc_check_every", 0) or 0)
    if every <= 0:
        return None
    if not (hasattr(engine, "step_sdc") and engine.sdc_supported()):
        obs_log.warn(
            "--sdc-check-every is armed but this engine/form cannot "
            "measure the ABFT invariants; SDC checking disabled"
        )
        return None
    return SdcGuard(engine)


class SdcGuard:
    """Per-run SDC state machine around the checked step.

    One instance per ``engine.run`` call (a rescue's fresh engine gets
    a fresh guard; the run-scoped summary and the metrics counters
    accumulate across them). The retained state is a DEVICE-side copy
    taken at clean boundaries only — the double buffer the redo
    restores from."""

    def __init__(self, engine):
        self.engine = engine
        cfg = engine.config
        rb = cfg.robustness
        self.every = int(cfg.sdc_check_every)
        self.redo_deadline_s = float(
            getattr(rb, "sdc_redo_deadline_s", 30.0))
        self.max_redos = int(getattr(rb, "sdc_max_redos", 2))
        self._token = engine.retain_state()
        # Eager registration (the elastic-monitor discipline): a
        # checked solve exposes the sdc instruments through the
        # exporter from step one, not from the first breach.
        for name, help_ in (
            ("sdc.checks", "SDC-checked steps taken this run"),
            ("sdc.flips_detected",
             "checked steps whose ABFT invariants breached"),
            ("sdc.transient_flips",
             "breaches healed by a clean bounded re-execution"),
            ("sdc.sticky_flips",
             "repeat breaches attributed to one device (quarantined)"),
            ("sdc.redos", "bounded re-executions performed"),
            ("sdc.quarantined_devices",
             "devices convicted of sticky corruption and excluded"),
        ):
            obs_metrics.counter(name, help_)
        _summary()  # the run report section exists once armed

    def wants(self, iteration: int) -> bool:
        """Absolute cadence, like probes/snapshots — a resumed run
        checks the same iterations."""
        return (iteration + 1) % self.every == 0

    def note_rollback(self) -> None:
        """The run loop's health check rolled the engine back (NaN /
        mass drift -> snapshot restore): the retained token now points
        PAST the live iteration, and restoring it would jump the solve
        forward onto the very state the health check rejected. Re-base
        the double buffer on the freshly restored state."""
        self._token = self.engine.retain_state()

    # -- internals ---------------------------------------------------------

    def _evaluate(self, pre, chk) -> SdcVerdict:
        eng = self.engine
        ne = (int(eng.graph.num_edges)
              if eng.graph is not None and eng.graph.num_edges else None)
        return evaluate_check(
            pre, chk,
            damping=eng.config.damping,
            semantics=eng.config.semantics,
            n=int(eng.graph.n),
            num_edges=ne,
            eps=eng._ledger_eps(),
            # Prefer the per-attempt stamp (the delta bound of the
            # state THIS chk was measured from); fall back to the
            # engine's live value for engines that don't stamp.
            stale_slack=float(
                chk.get("stale_slack", eng._stale_slack()) or 0.0),
        )

    def _device_id(self, position: Optional[int]) -> Optional[int]:
        if position is None:
            return None
        devs = self.engine.device_ids()
        if 0 <= position < len(devs):
            return int(devs[position])
        return None

    def _commit(self, info: Dict[str, float]) -> Dict[str, float]:
        # Retain AFTER a clean check only: the double buffer must never
        # hold a poisoned iterate.
        self._token = self.engine.retain_state(
            iteration=self.engine.iteration + 1)
        return info

    def _quarantine(self, position: int, iteration: int,
                    detail: str) -> None:
        dev_id = self._device_id(position)
        s = _summary()
        s["sticky"] = int(s["sticky"]) + 1
        if dev_id is not None and dev_id not in s["quarantined_devices"]:
            s["quarantined_devices"].append(dev_id)
        obs_metrics.counter("sdc.sticky_flips").inc()
        obs_metrics.counter("sdc.quarantined_devices").inc()
        if _QUARANTINE_HOOK is not None and dev_id is not None:
            # Persist BEFORE raising: even a run with no rescue wired
            # records the conviction durably before it dies.
            try:
                _QUARANTINE_HOOK([dev_id])
            except Exception as e:  # persistence must not mask the verdict
                obs_log.warn(
                    f"quarantine persistence hook failed ({e!r}); the "
                    f"conviction still raises"
                )
        obs_log.warn(
            f"SDC STICKY at iteration {iteration}: device "
            f"{dev_id} (mesh position {position}) breached the ABFT "
            f"invariants twice across a clean-state re-execution "
            f"({detail}); quarantining it through the elastic rescue "
            f"path"
        )
        raise DeviceQuarantinedError(
            f"sticky silent data corruption on device {dev_id} at "
            f"iteration {iteration} ({detail})",
            device_ids=[dev_id] if dev_id is not None else [],
        )

    # -- the checked step ---------------------------------------------------

    def checked_step(self) -> Dict[str, float]:
        """Run one SDC-checked iteration: standalone boundary-state
        dispatch, the checked step, reconciliation — and on a breach
        the deadline-bounded redo/classify machine. Returns the step
        info (the plain step's scalars plus ``rank_mass`` and a small
        ``sdc`` record); raises
        :class:`~pagerank_tpu_torch.parallel.elastic.DeviceQuarantinedError`
        on a sticky conviction and :class:`SdcExhaustedError` when the
        budget/deadline is spent without one."""
        eng = self.engine
        boundary = eng.iteration
        if self._token[0] > boundary:
            # Defensive twin of :meth:`note_rollback`: a token from the
            # future (the engine was rewound behind our back) must
            # never be restored — re-base on the current state so a
            # redo re-executes THIS boundary only.
            self._token = eng.retain_state()
        s = _summary()
        s["checks"] = int(s["checks"]) + 1
        obs_metrics.counter("sdc.checks").inc()
        pre = eng.sdc_state_values()
        info, chk = eng.step_sdc()
        verdict = self._evaluate(pre, chk)
        if verdict.ok:
            info["sdc"] = {"ok": True}
            return self._commit(info)

        # -- breach: detect, then redo/classify ----------------------------
        s["flips_detected"] = int(s["flips_detected"]) + 1
        s["last_breach"] = {
            "iteration": int(boundary),
            "reasons": list(verdict.reasons),
        }
        obs_metrics.counter("sdc.flips_detected").inc()
        obs_metrics.gauge(
            "sdc.last_breach_iteration",
            "iteration of the latest ABFT invariant breach",
        ).set(int(boundary))
        tracer = obs_trace.get_tracer()
        if tracer.enabled:
            tracer.add_event("sdc/breach", iteration=boundary,
                             detail=verdict.describe())
        obs_log.warn(
            f"SDC breach at iteration {boundary}: "
            f"{verdict.describe()}; re-executing from the retained "
            f"state (iteration {self._token[0]})"
        )
        suspect = verdict.suspect
        bad_chk = chk
        t0 = time.monotonic()
        redos = 0
        while True:
            if redos >= self.max_redos:
                break
            if time.monotonic() - t0 > self.redo_deadline_s:
                obs_log.warn(
                    f"SDC redo deadline ({self.redo_deadline_s:g}s) "
                    f"exceeded at iteration {boundary}"
                )
                break
            redos += 1
            s["redos"] = int(s["redos"]) + 1
            obs_metrics.counter("sdc.redos").inc()
            eng.restore_state(self._token)
            # Replay the window since the last clean boundary with
            # PLAIN steps (the fault shim re-consults its schedule
            # deterministically: one-shot flips stay healed, a sticky
            # chip re-corrupts), then re-run the checked step.
            while eng.iteration < boundary:
                eng.step()
                eng.iteration += 1
            pre = eng.sdc_state_values()
            info, chk = eng.step_sdc()
            v2 = self._evaluate(pre, chk)
            if v2.ok:
                # TRANSIENT: the clean redo's values are the ground
                # truth the breached attempt diffs against — the
                # mismatching device position is the suspect.
                pos = suspect
                if pos is None:
                    pos = localize_diff(bad_chk, chk)
                dev_id = self._device_id(pos)
                s["transient"] = int(s["transient"]) + 1
                s["last_breach"]["classified"] = "transient"
                s["last_breach"]["device"] = dev_id
                obs_metrics.counter("sdc.transient_flips").inc()
                obs_log.warn(
                    f"SDC TRANSIENT at iteration {boundary}: clean "
                    f"re-execution reconciles; suspect device "
                    f"{dev_id} (mesh position {pos}); continuing"
                )
                info["sdc"] = {"ok": True, "transient": True,
                               "redos": redos,
                               "suspect_device": dev_id}
                return self._commit(info)
            # Repeat breach: same attributed device => sticky.
            s2 = v2.suspect
            if s2 is None:
                s2 = suspect
            if s2 is not None and (suspect is None or s2 == suspect):
                s["last_breach"]["classified"] = "sticky"
                s["last_breach"]["device"] = self._device_id(s2)
                self._quarantine(s2, boundary, v2.describe())
            # Attribution moved: keep the newest suspect and spend
            # another redo on it (bounded above).
            suspect = s2 if s2 is not None else suspect
            bad_chk = chk
        if suspect is not None:
            # Budget spent but an attribution stands: convicting the
            # suspect beats solving on state that cannot be trusted.
            s["last_breach"]["classified"] = "sticky"
            s["last_breach"]["device"] = self._device_id(suspect)
            self._quarantine(suspect, boundary, verdict.describe())
        raise SdcExhaustedError(
            f"SDC breach at iteration {boundary} survived {redos} "
            f"re-execution(s) without attributing to a device "
            f"({verdict.describe()}); state cannot be trusted",
            iteration=boundary, redos=redos,
        )
