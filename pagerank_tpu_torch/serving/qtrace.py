"""The query plane: per-query causal timelines for serving.

Copy of ``pagerank_tpu/serving/qtrace.py``.

The solver's five obs planes attribute ITERATION time; this plane
attributes QUERY time. One served query hops threads — ingress ->
admission -> dispatcher -> response — which the classic
:class:`~pagerank_tpu_torch.obs.trace.Tracer` span stack cannot follow.
A :class:`QueryTrace` is the cross-thread handle: call sites record
pre-measured phases (named ``query/<phase>`` on the server's injected
clock), the trace links to its batch-mates, and every settled outcome
carries a W3C-shaped ``trace_id``.

Three consumers hang off :class:`QueryPlane`:

- **tail decomposition** — bounded per-phase samples feed
  :meth:`QueryPlane.phase_p99_ms` (``bench.py --ppr-serve``'s
  admission_wait / batch_wait / dispatch / fetch ledger columns);
- **slow-query log** — settles with latency >= ``slow_query_ms`` write
  one strict-JSON line with the full phase breakdown;
- **flight recorder** — a ring of the last N settled timelines,
  snapshotted on drain / rescue / fatal into the run report's
  ``serving`` section (:func:`report_section`).

Memory discipline: the plane retains NOTHING per settled query beyond
the fixed-size structures above — bounded per-leg sample deques, the
flight ring, counters, and a rolling order-independent structure
digest (each settle folds ``sha256(trace.structure())`` into one
accumulator). A daemon armed for its whole process lifetime
(``python -m pagerank_tpu_torch.serve --slow-query-ms``) stays O(1) in
query count; degrading instead of dying includes not OOMing on
observability state.

Zero-cost discipline (the booby-trap contract): the plane is DISARMED
by default (:func:`get_query_plane` returns None) and every serving
call site gates on ``q.trace is not None`` — a disarmed admitted query
makes zero tracer, plane, or exemplar calls on the hot path
(tests/test_qtrace.py::test_disarmed_booby_trap).

Import discipline: stdlib + ``obs.trace`` only — the run report
(``obs/report.py``, a later slice of the port) imports this module
lazily for its serving section, so it must never pull in the daemon
or torch.

Phase glossary (docs/OBSERVABILITY.md "Query plane"):

==================  =====================================================
phase               measures
==================  =====================================================
query/cache         LRU lookup at admission (attr ``hit``)
query/admission     the typed admission decision (attr ``decision``)
query/batch_wait    admitted -> batch close (attrs ``close_reason``,
                    ``batch_size``; links = batch-mates' trace ids)
query/dispatch      compiled-batch device run (attrs ``rerun``,
                    ``attempts``; covers elastic-rescue re-runs)
query/fetch         on-device top-k -> host copy + cache put
query/serialize     HTTP response body build (ingress only; recorded
                    AFTER the query settles, so it appears in the live
                    Chrome trace but never in the settled record —
                    slow-query log, flight dumps, structure digest)
==================  =====================================================
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

from pagerank_tpu_torch.obs import trace as obs_trace

#: phase name -> bench/history decomposition leg column.
PHASE_TO_LEG = {
    "query/admission": "admission_wait",
    "query/batch_wait": "batch_wait",
    "query/dispatch": "dispatch",
    "query/fetch": "fetch",
}

#: the decomposition columns, in ledger order.
DECOMPOSITION_LEGS = ("admission_wait", "batch_wait", "dispatch", "fetch")

#: keys of one slow-query JSONL record (schema pinned in tests).
SLOW_QUERY_KEYS = ("type", "trace_id", "qid", "source", "outcome",
                   "latency_ms", "phases")


def default_trace_id(qid: int) -> str:
    """Deterministic W3C trace id for query ``qid``: 32 lowercase hex
    digits, never all-zero (the spec's invalid value) — same seed =>
    same qids => same trace ids, the chaos harness's determinism
    contract."""
    return format(int(qid) + 1, "032x")


class QueryTrace:
    """One query's causal timeline — the handle that crosses threads.

    Phases are PRE-MEASURED on the server's injected clock and appended
    in lifecycle order (submit thread, then dispatcher), so no lock is
    needed: every hand-off happens-before via the admission queue's
    condition, and the daemon publishes the query (``resolve``/
    ``reject``, which set the done event) only AFTER :meth:`finish`
    sealed the trace. A phase recorded after the seal — the ingress
    thread's ``query/serialize`` — mirrors into the tracer (its own
    lock) but does NOT touch ``phases``, so the settled record is
    immutable and flight-dump readers never race an append. When the
    process tracer is armed, each phase mirrors immediately into a
    handle-parented span (:meth:`Tracer.start_span`) so the Chrome
    export shows the query as one tree spanning thread lanes.
    """

    __slots__ = ("trace_id", "qid", "source", "phases", "links",
                 "outcome", "attrs", "t_start", "t_admitted",
                 "_tracer", "_root", "_sealed")

    def __init__(self, qid: int, source: int, trace_id: str,
                 start_s: float, tracer=None):
        self.trace_id = trace_id
        self.qid = int(qid)
        self.source = int(source)
        self.phases: List[dict] = []
        self.links: List[str] = []
        self.outcome = ""
        self.attrs: Dict = {}
        self.t_start = float(start_s)
        self.t_admitted: Optional[float] = None
        self._sealed = False
        self._tracer = tracer if tracer is not None else obs_trace.NULL_TRACER
        self._root = self._tracer.start_span(
            "query", trace_id=trace_id, start_s=start_s,
            qid=self.qid, source=self.source,
        )

    def phase(self, name: str, start_s: float, duration_s: float,
              **attrs) -> None:
        """Record one pre-measured phase (server-clock seconds). After
        :meth:`finish` sealed the trace, the phase still lands in the
        live tracer (Chrome lanes) but NOT in ``phases`` — the settled
        record is immutable, so post-settle ingress work
        (``query/serialize``) can never race a flight-dump reader or
        perturb the structure digest."""
        rec = {
            "name": name,
            "start_s": float(start_s),
            "duration_s": max(0.0, float(duration_s)),
            "tid": threading.get_ident(),
        }
        if attrs:
            rec["attrs"] = attrs
        if not self._sealed:
            self.phases.append(rec)
        sp = self._tracer.start_span(
            name, parent=self._root, trace_id=self.trace_id,
            start_s=rec["start_s"], **attrs
        )
        if sp is not None:
            self._tracer.finish_span(
                sp, end_s=rec["start_s"] + rec["duration_s"]
            )

    def link(self, other_trace_id: str) -> None:
        """Link to another trace (batch membership)."""
        self.links.append(other_trace_id)

    def finish(self, outcome: str, end_s: float) -> None:
        """Seal the trace (called once, by :meth:`QueryPlane.settle`):
        ``phases`` is immutable from here on."""
        self.outcome = outcome
        self._sealed = True
        if self._root is not None:
            self._root.attrs["outcome"] = outcome
            if self.links:
                self._root.links = list(self.links)
            self._tracer.finish_span(self._root, end_s=float(end_s))

    def to_json(self) -> dict:
        out = {
            "trace_id": self.trace_id,
            "qid": self.qid,
            "source": self.source,
            "outcome": self.outcome,
            "phases": list(self.phases),
        }
        if self.links:
            out["links"] = list(self.links)
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out

    def structure(self) -> dict:
        """The timestamp-free shape used by the determinism digest:
        identity, outcome, phase names + attrs (close reasons,
        decisions), and links — no clocks, no tids, no span ids."""
        return {
            "trace_id": self.trace_id,
            "qid": self.qid,
            "source": self.source,
            "outcome": self.outcome,
            "phases": [
                {"name": p["name"], "attrs": p.get("attrs", {})}
                for p in self.phases
            ],
            "links": sorted(self.links),
        }


class QueryPlane:
    """The armed query plane: trace factory, settle ledger, tail
    samplers, slow-query log, and the flight-recorder ring.

    Every retained structure is bounded (deques with maxlen, counters,
    one digest accumulator) — an armed plane's memory is O(1) in the
    number of settled queries, so arming it for a daemon's whole
    process lifetime is safe."""

    def __init__(self, ring_size: int = 64,
                 slow_query_ms: Optional[float] = None,
                 slow_query_path: Optional[str] = None,
                 max_samples: int = 8192,
                 max_dumps: int = 8):
        self.slow_query_ms = slow_query_ms
        self.slow_query_path = slow_query_path
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(ring_size)))
        # Rolling structure digest: per-trace sha256 values summed mod
        # 2**256 — order-independent (settle order may differ across
        # threads) and O(1) memory, unlike retaining every trace.
        self._digest_sum = 0
        self._samples: Dict[str, deque] = {
            leg: deque(maxlen=max_samples) for leg in DECOMPOSITION_LEGS
        }
        self._dumps: deque = deque(maxlen=max(1, int(max_dumps)))
        self._settled_count = 0
        self._slow_count = 0
        # O_APPEND fd opened at arm time (still single-threaded): each
        # outlier is then ONE os.write of one full line outside the
        # plane lock, so settles on different threads never tear lines
        # and never serialize on filesystem waits.
        self._slow_fd: Optional[int] = None
        if slow_query_path is not None:
            self._slow_fd = os.open(
                slow_query_path,
                os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644,
            )

    # -- trace lifecycle ----------------------------------------------------

    def new_trace(self, qid: int, source: int, trace_id: str,
                  start_s: float) -> QueryTrace:
        return QueryTrace(qid, source, trace_id, start_s,
                          tracer=obs_trace.get_tracer())

    def settle(self, trace: QueryTrace, outcome: str, end_s: float,
               latency_ms: Optional[float]) -> None:
        """One query reached its typed terminal state: seal the trace,
        feed the tail samplers, ring-buffer the timeline, and (when it
        qualifies) write the slow-query JSONL line."""
        trace.finish(outcome, end_s)
        slow = (self.slow_query_ms is not None
                and latency_ms is not None
                and latency_ms >= self.slow_query_ms)
        shape = hashlib.sha256(
            json.dumps(trace.structure(), sort_keys=True).encode("utf-8")
        ).digest()
        with self._lock:
            self._settled_count += 1
            self._ring.append(trace)
            self._digest_sum = (
                self._digest_sum + int.from_bytes(shape, "big")
            ) % (1 << 256)
            for p in trace.phases:
                leg = PHASE_TO_LEG.get(p["name"])
                if leg is not None:
                    self._samples[leg].append(1000.0 * p["duration_s"])
            if slow:
                self._slow_count += 1
        if slow:
            # Outside the lock: the trace is sealed, and the O_APPEND
            # write is a single syscall — no torn lines, and a slow
            # filesystem never stalls other settling threads.
            self._write_slow(trace, latency_ms)

    def _write_slow(self, trace: QueryTrace, latency_ms: float) -> None:
        """One strict-JSON line per outlier."""
        if self._slow_fd is None:
            return
        rec = {
            "type": "slow_query",
            "trace_id": trace.trace_id,
            "qid": trace.qid,
            "source": trace.source,
            "outcome": trace.outcome,
            "latency_ms": round(float(latency_ms), 3),
            "phases": list(trace.phases),
        }
        line = json.dumps(rec, allow_nan=False, sort_keys=True) + "\n"
        os.write(self._slow_fd, line.encode("utf-8"))

    # -- flight recorder ----------------------------------------------------

    def flight_dump(self, reason: str) -> dict:
        """Snapshot the ring (last-N settled timelines) — the black box
        pulled on drain / rescue / fatal."""
        with self._lock:
            dump = {
                "reason": reason,
                "settled": self._settled_count,
                "traces": [t.to_json() for t in self._ring],
            }
            self._dumps.append(dump)
        return dump

    # -- views --------------------------------------------------------------

    def phase_p99_ms(self) -> Dict[str, float]:
        """p99 milliseconds per decomposition leg (0.0 when a leg has
        no samples — e.g. every query shed at admission)."""
        out = {}
        with self._lock:
            for leg in DECOMPOSITION_LEGS:
                xs = sorted(self._samples[leg])
                out[leg] = (
                    round(xs[int(0.99 * (len(xs) - 1))], 6) if xs else 0.0
                )
        return out

    def structure_digest(self) -> str:
        """Rolling digest over every settled trace's timestamp-free
        structure: the sum (mod 2**256) of per-trace sha256 values,
        folded in at settle time — order-independent, so it is equal
        across same-seed chaos runs regardless of settle interleaving,
        and O(1) memory regardless of query count."""
        with self._lock:
            return format(self._digest_sum, "064x")

    @property
    def settled_count(self) -> int:
        with self._lock:
            return self._settled_count

    @property
    def slow_count(self) -> int:
        with self._lock:
            return self._slow_count

    def report_section(self) -> dict:
        """The run report's ``serving`` section."""
        with self._lock:
            dumps = list(self._dumps)
            settled = self._settled_count
            slow = self._slow_count
        return {
            "enabled": True,
            "settled": settled,
            "slow_queries": slow,
            "slow_query_ms": self.slow_query_ms,
            "phase_p99_ms": self.phase_p99_ms(),
            "flight_dumps": dumps,
        }

    def close(self) -> None:
        with self._lock:
            fd, self._slow_fd = self._slow_fd, None
        if fd is not None:
            os.close(fd)


# -- process-global plane (disarmed by default) -----------------------------

_PLANE: Optional[QueryPlane] = None


def get_query_plane() -> Optional[QueryPlane]:
    """The armed plane, or None (the zero-cost default — call sites
    gate on this / on ``q.trace is not None``)."""
    return _PLANE


def arm_query_plane(ring_size: int = 64,
                    slow_query_ms: Optional[float] = None,
                    slow_query_path: Optional[str] = None,
                    plane: Optional[QueryPlane] = None) -> QueryPlane:
    """Install (and return) a recording query plane."""
    global _PLANE
    _PLANE = plane if plane is not None else QueryPlane(
        ring_size=ring_size, slow_query_ms=slow_query_ms,
        slow_query_path=slow_query_path,
    )
    return _PLANE


def disarm_query_plane() -> Optional[QueryPlane]:
    """Restore the disarmed default; returns the plane that was active
    (so a caller can still read what it recorded)."""
    global _PLANE
    prev = _PLANE
    _PLANE = None
    if prev is not None:
        prev.close()
    return prev


def report_section() -> dict:
    """The run report's ``serving`` section for the CURRENT plane —
    ``{"enabled": False}`` when disarmed (the report stays
    schema-complete either way)."""
    plane = get_query_plane()
    if plane is None:
        return {"enabled": False}
    return plane.report_section()
