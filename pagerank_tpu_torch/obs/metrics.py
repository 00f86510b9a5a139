"""Central metrics registry — the counter half of the observability
layer (docs/OBSERVABILITY.md).

Copy of ``pagerank_tpu/obs/metrics.py``.

Before this module the run counters were scattered one-per-subsystem:
S3 request retries in ``S3FileSystem.retry_stats``, health-check
failures and rollbacks in ``engine.health``, dead-letters in
``SinkGuard.dropped``, compile-cache behavior invisible entirely. Each
stayed (they are the subsystems' own API), but every one is now ALSO
registered here, so one ``snapshot()`` captures the whole run and the
flight recorder (obs/report.py) can embed it.

Typed instruments:

  - :class:`Counter` — monotone count (``s3.request.retries``);
  - :class:`Gauge` — last-set value (``engine.num_chips``);
  - :class:`Histogram` — count/sum/min/max plus power-of-two bucket
    counts (``snapshot.bytes_written`` per save).

Naming scheme mirrors the span scheme: ``subsystem.thing[.verb]``,
dot-separated (docs/OBSERVABILITY.md has the full catalogue).

Thread discipline (PTR001, docs/ANALYSIS.md "PTR rules"): the registry
MAP and every histogram's bucket dict are lock-protected — the metrics
HTTP exporter thread renders (`registry.export_view()`) while the
solve loop, the rank-writer, and the watchdog register and record, and
an unguarded dict would let a scrape iterate mid-insert. Counter/Gauge
SCALAR updates stay plain in-GIL arithmetic by design (the same
discipline as ``SinkGuard.retries``, waived in the analysis allowlist
with this reason): a lost update under a hypothetical no-GIL runtime
would cost a count, never a crash — these are telemetry, not ledgers.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple, Union


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "help", "value")

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-written value."""

    __slots__ = ("name", "help", "value")

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: Optional[float] = None

    def set(self, v) -> None:
        self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """Summary stats + power-of-two buckets. ``record(v)`` files ``v``
    under the smallest bucket bound ``2**k >= v`` (one ``+inf`` bucket
    past 2**63); the snapshot keeps only non-empty buckets.

    Lock-protected (PTR001): the bucket dict is mutated on the solve
    loop (``solve.step_seconds_ms`` per iteration) while the exporter
    HTTP thread renders a snapshot — every field access happens under
    ``_lock``, and readers work from a consistent copy taken there.
    The per-record cost is one uncontended acquire, noise next to a
    device dispatch."""

    __slots__ = ("name", "help", "count", "sum", "min", "max", "buckets",
                 "exemplars", "_lock")

    kind = "histogram"

    _MAX_EXP = 63

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.buckets: Dict[str, int] = {}
        # bucket key -> {"value", "trace_id"}: the last exemplar filed
        # per bucket (the OpenMetrics renderer attaches them
        # so a tail bucket names a concrete trace to pull). Populated
        # ONLY by trace-id-carrying records: the plain record(v) path
        # is unchanged, which is the disarmed-tracing zero-cost pin.
        self.exemplars: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def record(self, v: float, trace_id: Optional[str] = None) -> None:
        v = float(v)
        if v <= 0:
            key = "0"
        else:
            e = 0
            while (1 << e) < v and e < self._MAX_EXP:
                e += 1
            key = str(1 << e) if (1 << e) >= v else "+inf"
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.buckets[key] = self.buckets.get(key, 0) + 1
            if trace_id is not None:
                self.exemplars[key] = {"value": v, "trace_id": trace_id}

    #: Fixed quantile summaries published by snapshot() — what the
    #: Prometheus exporter (obs/live.py) and the run report surface as
    #: latency distributions, not just count/sum/max.
    QUANTILES = (0.5, 0.9, 0.99)

    def _state(self) -> Tuple[int, float, Optional[float], Optional[float],
                              Dict[str, int]]:
        """One consistent (count, sum, min, max, buckets-copy) read —
        the only place readers touch the fields."""
        with self._lock:
            return (self.count, self.sum, self.min, self.max,
                    dict(self.buckets))

    def exemplars_view(self) -> Dict[str, dict]:
        """Consistent copy of the per-bucket exemplars (empty unless
        trace-id-carrying records happened — i.e. the query plane was
        armed)."""
        with self._lock:
            return {k: dict(v) for k, v in self.exemplars.items()}

    @staticmethod
    def _estimate(count: int, mn: float, mx: float,
                  buckets: Dict[str, int], q: float) -> float:
        """Upper-bound ``q``-quantile from power-of-two buckets: the
        smallest bucket bound whose cumulative count reaches
        ``q * count``. Exact observed extremes clamp it — the estimate
        is never below ``min`` or above ``max`` (a one-bucket histogram
        answers the true range, not the bucket ceiling)."""
        target = q * count

        def bound(key: str) -> float:
            return float("inf") if key == "+inf" else float(int(key))

        cum = 0
        for key in sorted(buckets, key=bound):
            cum += buckets[key]
            if cum >= target:
                return float(min(max(bound(key), mn), mx))
        return float(mx)  # pragma: no cover - cum always reaches

    def quantile(self, q: float) -> Optional[float]:
        count, _sum, mn, mx, buckets = self._state()
        if not count:
            return None
        return self._estimate(count, mn, mx, buckets, q)

    def snapshot(self):
        count, total, mn, mx, buckets = self._state()
        out = {
            "count": count,
            "sum": total,
            "min": mn,
            "max": mx,
            "mean": (total / count) if count else None,
            # Bucket-estimated (upper-bound) latency quantiles — see
            # quantile(); None when empty, like min/max.
            **{f"p{int(q * 100)}":
               (self._estimate(count, mn, mx, buckets, q)
                if count else None)
               for q in self.QUANTILES},
            "buckets": buckets,
        }
        ex = self.exemplars_view()
        if ex:
            # Key present only when armed: the snapshot shape every
            # existing consumer pins stays byte-identical otherwise.
            out["exemplars"] = ex
        return out


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Get-or-create registry of typed metrics, snapshot-able to a
    plain-JSON dict and renderable as a human table.

    The map is lock-protected (PTR001): get-or-create runs on every
    context that instruments anything (solve loop, rank-writer worker,
    stall watchdog), while the exporter's HTTP thread iterates the map
    per scrape — an unguarded dict would let the iteration race an
    insert. Readers consume :meth:`export_view`/:meth:`snapshot`,
    which copy the map under the lock; lock order is always registry
    -> histogram, never the reverse (PTR002)."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help)
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Drop every metric — one run's counters must not bleed into
        the next in-process run (cli.main resets at entry)."""
        with self._lock:
            self._metrics.clear()

    def _items(self) -> List[Metric]:
        with self._lock:
            return [self._metrics[name] for name in sorted(self._metrics)]

    def export_view(self) -> List[Tuple[str, str, str, object]]:
        """One consistent ``(name, kind, help, snapshot)`` row per
        metric — what the Prometheus renderer (obs/live.py) consumes,
        so a scrape never iterates live registry internals while
        another context registers or records."""
        return [(m.name, m.kind, m.help, m.snapshot())
                for m in self._items()]

    def snapshot(self) -> Dict[str, dict]:
        """``{"counters": {...}, "gauges": {...}, "histograms": {...}}``
        — pure JSON-able values, stable key order."""
        out: Dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for name, kind, _help, snap in self.export_view():
            out[kind + "s"][name] = snap
        return out

    def render_table(self) -> str:
        """Aligned human-readable table of the current values."""
        rows = []
        for name, kind, _help, s in self.export_view():
            if kind == "histogram":
                val = (f"count={s['count']} sum={s['sum']:g} "
                       f"min={s['min']:g} max={s['max']:g}"
                       if s["count"] else "count=0")
            else:
                val = str(s)
            rows.append((name, kind, val))
        if not rows:
            return "(no metrics registered)"
        w_name = max(len(r[0]) for r in rows)
        w_kind = max(len(r[1]) for r in rows)
        return "\n".join(
            f"{n:<{w_name}}  {k:<{w_kind}}  {v}" for n, k, v in rows
        )


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry every instrumented subsystem reports
    into."""
    return _REGISTRY


def counter(name: str, help: str = "") -> Counter:
    """Get-or-create a counter on the global registry (the one-line
    idiom instrumentation sites use)."""
    return _REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "") -> Histogram:
    return _REGISTRY.histogram(name, help)
