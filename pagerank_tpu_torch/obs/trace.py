"""Span tracing — the structural half of the observability layer
(docs/OBSERVABILITY.md).

Copy of ``pagerank_tpu/obs/trace.py``.

The reference's entire observability is one println per iteration
(Sparky.java:188); partition-centric PageRank work (Lakhotia et al.,
arXiv:1709.07122, PAPERS.md) shows per-stage timing ATTRIBUTION is what
drives the next optimisation. This module is the attribution substrate:
a zero-dependency :class:`Tracer` whose nested context-manager spans
(``with tracer.span("build/sort"):``) record wall time, attributes and
parent/child structure, exportable as JSONL or Chrome trace-event JSON
(loadable in Perfetto / ``chrome://tracing``).

Design constraints, in priority order:

  1. **The hot path pays nothing when tracing is off.** The process
     default is :data:`NULL_TRACER` (``enabled`` False); its ``span()``
     returns ONE shared no-op context manager (no allocation, no
     recording), and per-iteration call sites gate on ``.enabled`` so a
     production solve makes zero tracer-induced host calls per
     iteration (tests/test_obs.py::test_noop_tracer_hot_path).
  2. **Thread-correct nesting.** The AsyncRankWriter worker records
     spans concurrently with the solve loop; span stacks are
     thread-local and the finished-span list is lock-protected, so
     parent/child linkage never crosses threads.
  3. **One timebase.** Spans are measured on ``time.perf_counter``
     relative to the tracer's epoch; the epoch's wall-clock
     (``time.time``) is exported once in the trace header so tools can
     anchor absolute time without per-span clock mixing.

Naming scheme (docs/OBSERVABILITY.md): ``layer/stage`` with ``/`` as
the hierarchy separator — ``ingest/edgelist``, ``build/sort``,
``engine/compile``, ``solve/step``, ``snapshot/save``,
``writer/queue_wait``, ``retry/attempt``, ``profile``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from pagerank_tpu_torch.utils import fsio


class Span:
    """One finished (or live) span. ``start``/``duration`` are seconds
    on the owning tracer's perf_counter timebase (relative to its
    epoch); ``attrs`` is a plain JSON-able dict.

    ``trace_id`` / ``links`` are the cross-thread half:
    spans opened by handle (:meth:`Tracer.start_span`) can belong to a
    logical trace that hops threads — one served query's causal
    timeline — and link to spans of OTHER traces (batch membership).
    Both stay None on the classic context-manager path, so the
    existing export shapes are byte-identical for untouched callers.
    """

    __slots__ = ("span_id", "name", "start", "duration", "parent_id",
                 "tid", "attrs", "trace_id", "links")

    def __init__(self, span_id: int, name: str, start: float,
                 parent_id: Optional[int], tid: int, attrs: dict,
                 trace_id: Optional[str] = None,
                 links: Optional[List[str]] = None):
        self.span_id = span_id
        self.name = name
        self.start = start
        self.duration = 0.0
        self.parent_id = parent_id
        self.tid = tid
        self.attrs = attrs
        self.trace_id = trace_id
        self.links = links

    @property
    def end(self) -> float:
        return self.start + self.duration

    def to_json(self) -> dict:
        out = {
            "type": "span",
            "id": self.span_id,
            "name": self.name,
            "start_s": self.start,
            "duration_s": self.duration,
            "parent": self.parent_id,
            "tid": self.tid,
            "attrs": self.attrs,
        }
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.links:
            out["links"] = list(self.links)
        return out


class _SpanCm:
    """The live-span context manager. Yields the :class:`Span` so the
    body can attach attributes (``sp.attrs["bytes"] = n``); records the
    span on exit. On an exception the span is still recorded, with
    ``error`` set to the exception type — a failing stage is exactly
    the one the trace must show."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._push(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._span.attrs["error"] = exc_type.__name__
        self._tracer._pop(self._span)
        return False


class _NullCm:
    """The shared no-op context manager NULL_TRACER.span() returns:
    nothing is allocated or recorded, and the body receives None (call
    sites that attach attributes must gate on ``tracer.enabled``)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CM = _NullCm()


class NullTracer:
    """Disabled tracer — the process default. Every operation is a
    no-op; ``span()`` returns one shared context manager so the
    disabled path allocates nothing."""

    enabled = False

    def span(self, name: str, **attrs):
        return _NULL_CM

    def start_span(self, name: str, parent=None,
                   trace_id: Optional[str] = None,
                   tid: Optional[int] = None,
                   start_s: Optional[float] = None,
                   links: Optional[List[str]] = None, **attrs):
        return None

    def finish_span(self, span, end_s: Optional[float] = None) -> None:
        pass

    def set_thread_label(self, tid: int, label: str) -> None:
        pass

    def add_span(self, name: str, start_pc: float, duration: float,
                 **attrs) -> None:
        pass

    def add_event(self, name: str, **attrs) -> None:
        pass

    def add_counter(self, name: str, values: Dict[str, float],
                    track: Optional[int] = None,
                    track_label: Optional[str] = None) -> None:
        pass

    def spans(self) -> List[Span]:
        return []

    def events(self) -> List[dict]:
        return []

    def counters(self) -> List[dict]:
        return []

    def summary(self) -> Dict[str, dict]:
        return {}


NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer: nested context-manager spans with thread-local
    stacks, instant events, aggregation, and JSONL / Chrome trace-event
    export.

    ``max_spans`` bounds retention: when set, finished spans live in a
    ring (oldest dropped first) instead of an unbounded list — the mode
    long-running captures (the serving daemon's ``--query-trace``) use
    so an armed tracer cannot grow memory without bound with query
    count. Solver runs are finite, so the default stays unbounded and
    exports every span."""

    enabled = True

    def __init__(self, max_spans: Optional[int] = None):
        self.epoch_pc = time.perf_counter()
        self.epoch_unix = time.time()
        self._lock = threading.Lock()
        self._spans = (deque(maxlen=int(max_spans))
                       if max_spans else [])
        self._events: List[dict] = []
        self._counters: List[dict] = []
        self._track_labels: Dict[int, str] = {}
        self._thread_labels: Dict[int, str] = {}
        self._local = threading.local()
        self._next_id = 0

    # -- recording --------------------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def span(self, name: str, **attrs) -> _SpanCm:
        """Open a nested span; use as ``with tracer.span("build/sort",
        edges=m) as sp:``. Parent is the innermost live span on THIS
        thread."""
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        sp = Span(self._new_id(), name,
                  time.perf_counter() - self.epoch_pc, parent,
                  threading.get_ident(), dict(attrs))
        return _SpanCm(self, sp)

    def _push(self, sp: Span) -> None:
        self._stack().append(sp)

    def _pop(self, sp: Span) -> None:
        sp.duration = (time.perf_counter() - self.epoch_pc) - sp.start
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        else:  # defensive: out-of-order exit must not corrupt linkage
            try:
                stack.remove(sp)
            except ValueError:
                pass
        with self._lock:
            self._spans.append(sp)

    # -- explicit span handles (cross-thread traces) -------------------------

    def start_span(self, name: str, parent=None,
                   trace_id: Optional[str] = None,
                   tid: Optional[int] = None,
                   start_s: Optional[float] = None,
                   links: Optional[List[str]] = None, **attrs) -> Span:
        """Open a span BY HANDLE, parented explicitly instead of by the
        thread-local stack — the primitive that lets one logical trace
        cross the ingress -> admission -> dispatch -> response thread
        hops (the serving query plane). ``parent`` is a Span or a span
        id (None = root); ``tid`` pins the Chrome lane (default: the
        calling thread); ``start_s`` is an explicit start on the
        tracer's epoch timebase for pre-measured phases (default: now).
        The handle is NOT pushed on any thread-local stack — nested
        ``span()`` context managers on this thread are unaffected.
        Finish with :meth:`finish_span`."""
        if parent is not None and isinstance(parent, Span):
            parent = parent.span_id
        sp = Span(
            self._new_id(), name,
            (time.perf_counter() - self.epoch_pc
             if start_s is None else float(start_s)),
            parent,
            threading.get_ident() if tid is None else int(tid),
            dict(attrs),
            trace_id=trace_id,
            links=list(links) if links else None,
        )
        return sp

    def finish_span(self, span: Span,
                    end_s: Optional[float] = None) -> None:
        """Record a handle opened by :meth:`start_span`; ``end_s`` is
        an explicit end on the epoch timebase (default: now). Safe from
        any thread — the handle carries its own parentage."""
        end = (time.perf_counter() - self.epoch_pc
               if end_s is None else float(end_s))
        span.duration = max(0.0, end - span.start)
        with self._lock:
            self._spans.append(span)

    def set_thread_label(self, tid: int, label: str) -> None:
        """Name one tid's lane in the Chrome export (a ``thread_name``
        metadata event) — the per-thread lanes of the serving trace
        (ingress / dispatch / harness)."""
        with self._lock:
            self._thread_labels.setdefault(int(tid), label)

    def add_span(self, name: str, start_pc: float, duration: float,
                 **attrs) -> None:
        """Record a PRE-MEASURED span from raw ``time.perf_counter``
        readings — for stages whose timing already exists (the device
        build's fenced stage walls) so the measurement is made once and
        the trace is a faithful view of it, never a second clock."""
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        sp = Span(self._new_id(), name, start_pc - self.epoch_pc, parent,
                  threading.get_ident(), dict(attrs))
        sp.duration = duration
        with self._lock:
            self._spans.append(sp)

    def add_event(self, name: str, **attrs) -> None:
        """Record an instant event (Chrome ``ph: "i"``) — log lines,
        retries, rollbacks."""
        ev = {
            "type": "event",
            "name": name,
            "ts_s": time.perf_counter() - self.epoch_pc,
            "tid": threading.get_ident(),
            "attrs": attrs,
        }
        with self._lock:
            self._events.append(ev)

    def add_counter(self, name: str, values: Dict[str, float],
                    track: Optional[int] = None,
                    track_label: Optional[str] = None) -> None:
        """Record a sampled counter point (Chrome ``ph: "C"``) — the
        per-device HBM tracks (obs/devices.DeviceSampler).
        ``track`` pins the sample to its own pid lane in the Chrome
        export so Perfetto renders one counter track PER DEVICE
        instead of mixing every chip into the process row;
        ``track_label`` names the lane once (a ``process_name``
        metadata event)."""
        rec = {
            "type": "counter",
            "name": name,
            "ts_s": time.perf_counter() - self.epoch_pc,
            "track": track,
            "values": dict(values),
        }
        with self._lock:
            self._counters.append(rec)
            if track is not None and track_label:
                self._track_labels.setdefault(track, track_label)

    # -- views ------------------------------------------------------------

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def counters(self) -> List[dict]:
        with self._lock:
            return list(self._counters)

    def summary(self) -> Dict[str, dict]:
        """Per-name aggregation (count / total / mean / max seconds),
        ordered by total wall descending — the span-tree summary the
        run flight-recorder embeds. Names are hierarchical by the
        ``layer/stage`` convention, so sorting by name prefix recovers
        the tree."""
        agg: Dict[str, dict] = {}
        for sp in self.spans():
            a = agg.setdefault(
                sp.name, {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            a["count"] += 1
            a["total_s"] += sp.duration
            a["max_s"] = max(a["max_s"], sp.duration)
        for a in agg.values():
            a["mean_s"] = a["total_s"] / a["count"]
        return dict(
            sorted(agg.items(), key=lambda kv: -kv[1]["total_s"])
        )

    def timings_view(self, prefix: str = "build/") -> Dict[str, float]:
        """Total seconds per stage under ``prefix``, keyed the
        historical ``{stage}_s`` way — the --build-only breakdown as a
        VIEW over the trace (ops/device_build fills its ``timings``
        dict from the very same fence measurements)."""
        out: Dict[str, float] = {}
        for sp in self.spans():
            if sp.name.startswith(prefix):
                key = sp.name[len(prefix):] + "_s"
                out[key] = out.get(key, 0.0) + sp.duration
        return out

    # -- export -----------------------------------------------------------

    def _header(self) -> dict:
        return {
            "type": "trace_header",
            "schema_version": 1,
            "epoch_unix": self.epoch_unix,
            "pid": os.getpid(),
        }

    def export_jsonl(self, path: str) -> None:
        """One JSON object per line: a trace_header, then every span and
        instant event. Strict JSON (no NaN/Infinity) by construction —
        durations are finite perf_counter differences."""
        with fsio.fopen(path, "w") as f:
            f.write(json.dumps(self._header()) + "\n")
            for sp in self.spans():
                f.write(json.dumps(sp.to_json()) + "\n")
            for ev in self.events():
                f.write(json.dumps(ev) + "\n")
            for c in self.counters():
                f.write(json.dumps(c) + "\n")

    def chrome_events(self) -> List[dict]:
        """Chrome trace-event list: complete ("X") events for spans,
        instant ("i") events for events. ``ts``/``dur`` are MICROSECONDS
        (the format's unit), pid/tid integers."""
        pid = os.getpid()
        out = []
        for sp in self.spans():
            args = sp.attrs
            if sp.trace_id is not None or sp.links:
                args = dict(sp.attrs)
                if sp.trace_id is not None:
                    args["trace_id"] = sp.trace_id
                if sp.links:
                    args["links"] = list(sp.links)
            out.append({
                "name": sp.name,
                "cat": sp.name.split("/", 1)[0],
                "ph": "X",
                "ts": sp.start * 1e6,
                "dur": sp.duration * 1e6,
                "pid": pid,
                "tid": sp.tid,
                "args": args,
            })
        for ev in self.events():
            out.append({
                "name": ev["name"],
                "cat": ev["name"].split("/", 1)[0],
                "ph": "i",
                "ts": ev["ts_s"] * 1e6,
                "pid": pid,
                "tid": ev["tid"],
                "s": "t",
                "args": ev["attrs"],
            })
        # Counter samples: tracked counters (per-device HBM) render on
        # their OWN pid lane, named once by a process_name metadata
        # event, so Perfetto shows one track per device; untracked
        # counters ride the process pid.
        with self._lock:
            labels = dict(self._track_labels)
            thread_labels = dict(self._thread_labels)
        for track, label in sorted(labels.items()):
            out.append({
                "name": "process_name",
                "ph": "M",
                "pid": track,
                "args": {"name": label},
            })
        # Thread lanes: set_thread_label names a tid's row (the serving
        # trace's ingress / dispatch / harness lanes).
        for tid, label in sorted(thread_labels.items()):
            out.append({
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": label},
            })
        for c in self.counters():
            out.append({
                "name": c["name"],
                "cat": c["name"].split("/", 1)[0].split(".", 1)[0],
                "ph": "C",
                "ts": c["ts_s"] * 1e6,
                "pid": c["track"] if c["track"] is not None else pid,
                "args": c["values"],
            })
        return out

    def export_chrome(self, path: str) -> None:
        """Write the Chrome trace-event JSON object form (Perfetto /
        ``chrome://tracing`` load it directly)."""
        doc = {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
            "metadata": {"epoch_unix": self.epoch_unix},
        }
        with fsio.fopen(path, "w") as f:
            json.dump(doc, f)

    def export(self, path: str) -> None:
        """Dispatch on extension: ``.jsonl`` -> JSONL, anything else ->
        Chrome trace-event JSON."""
        if path.endswith(".jsonl"):
            self.export_jsonl(path)
        else:
            self.export_chrome(path)


# -- process-global default tracer -----------------------------------------

_TRACER = NULL_TRACER


def get_tracer():
    """The process-global tracer — NULL_TRACER unless
    :func:`enable_tracing` installed a recording one."""
    return _TRACER


def enable_tracing(tracer: Optional[Tracer] = None) -> Tracer:
    """Install (and return) a recording tracer as the process default.
    Instrumented call sites across the package pick it up on their next
    ``get_tracer()`` read."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer()
    return _TRACER


def disable_tracing():
    """Restore the no-op default; returns the tracer that was active
    (so a caller can still export what it recorded)."""
    global _TRACER
    prev = _TRACER
    _TRACER = NULL_TRACER
    return prev


def span(name: str, **attrs):
    """Convenience: a span on the CURRENT process-global tracer (no-op
    context manager when tracing is disabled)."""
    return _TRACER.span(name, **attrs)
