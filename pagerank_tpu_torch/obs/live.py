"""Live monitoring: Prometheus text exporter + stall watchdog.

Copy of ``pagerank_tpu/obs/live.py`` with the watchdog's ``warn``,
``raise`` and ``rescue`` actions (``:389-523``: ``rescue_requested``,
``consume_rescue``, ``_classify`` over the solve mesh's devices from
``device_source``; the elastic runner of ``parallel/elastic.py``
consumes the request). The watchdog's device view and liveness echo
read the port's ``parallel/mesh.py``. Over a process group a rank can
echo only its own card: its classification says so, and the runner's
roll call classifies the group's members.

A long solve that hangs dies silently: nothing in the span/report
machinery fires until the run ENDS. This module is the live window
into a run that hasn't:

  - :func:`render_prometheus` — the metrics registry as Prometheus
    text exposition format (zero dependencies: plain string building);
  - :class:`MetricsExporter` — ``--metrics-textfile PATH`` atomically
    rewrites the rendering every iteration (``fsio.atomic_write``, so a
    scraper's node-exporter textfile collector never reads a torn
    file), and ``--metrics-port N`` serves the same snapshot over HTTP
    ``GET /metrics`` from a daemon thread;
  - :class:`StallWatchdog` — a daemon thread fed by solve/step
    completions (``engine.run`` heartbeats it when armed). When no
    step completes within ``--stall-timeout`` seconds it logs a LOUD
    diagnostic — last-completed iteration, seconds since progress, and
    a per-device view — then optionally interrupts the run
    (``--stall-action raise``): a hung step becomes visible instead of
    silent. ``raise`` interrupts the main thread with
    ``_thread.interrupt_main``, which Python delivers only between
    bytecodes: a main thread blocked in a CUDA synchronization (the
    ``float(delta)`` of a step, ``.cpu()``, ``torch.cuda.synchronize``)
    sees it when that call returns, as a JAX ``device_get`` does. Under
    the CLI the interrupt is SIGINT, which its drain handler turns into
    a drain at the next step boundary (exit 75). The clock/sleep are injectable (the
    utils/retry.py discipline) so tests drive fire/no-fire in virtual
    time.

The solve hot path pays one ``is None`` check per iteration when the
watchdog is disarmed (the same discipline as the no-op tracer).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Sequence

from pagerank_tpu_torch.obs import log as obs_log
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.utils import fsio

# -- Prometheus text exposition ---------------------------------------------

_NAME_PREFIX = "pagerank_"


def _prom_name(name: str) -> str:
    """Registry name -> Prometheus metric name: the dotted scheme maps
    onto underscores under one namespace prefix (``s3.request.retries``
    -> ``pagerank_s3_request_retries``)."""
    safe = "".join(
        c if c.isalnum() or c == "_" else "_" for c in name
    )
    return _NAME_PREFIX + safe


def _prom_help(text: str) -> str:
    """HELP line escaping per the exposition format: backslash and
    newline only."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_value(v) -> str:
    if v is None:
        return "NaN"  # Prometheus-legal unset sample value
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        # Exposition-format spellings, NOT Python repr: a diverging
        # solve legitimately puts NaN in a gauge (probe.rank_mass
        # under --no-health-checks), and 'nan'/'-inf' would fail the
        # format's own grammar (the acceptance smoke's strict parse).
        if v != v:
            return "NaN"
        if v == float("inf"):
            return "+Inf"
        if v == float("-inf"):
            return "-Inf"
        return repr(v)
    return str(v)


def render_prometheus(registry: Optional[obs_metrics.MetricsRegistry]
                      = None) -> str:
    """The registry as Prometheus text format (version 0.0.4): one
    ``# HELP`` / ``# TYPE`` pair per metric, counters and gauges as
    single samples, histograms as cumulative ``_bucket{le=...}`` series
    plus ``_sum`` / ``_count`` (quantile estimates stay in the run
    report — the exposition format reserves ``quantile`` labels for
    summaries). Deterministic ordering (registry name order) so the
    output is golden-testable.

    Renders from ``registry.export_view()`` — a consistent snapshot
    copied under the registry/histogram locks — never from live
    internals: this function runs on the exporter's HTTP thread while
    the solve loop registers and records (PTR001; the pre-fix direct
    ``_metrics``/bucket iteration could race a concurrent insert)."""
    registry = registry if registry is not None else obs_metrics.get_registry()
    lines: List[str] = []
    for name, kind, help_text, snap in registry.export_view():
        pname = _prom_name(name)
        lines.append(f"# HELP {pname} {_prom_help(help_text or name)}")
        if kind in ("counter", "gauge"):
            lines.append(f"# TYPE {pname} {kind}")
            if kind == "gauge" and snap is None:
                continue  # unset gauge: publish nothing, not NaN
            lines.append(f"{pname} {_prom_value(snap)}")
        else:  # histogram -> cumulative le-buckets
            lines.append(f"# TYPE {pname} histogram")
            buckets = snap["buckets"]

            def bound(key: str) -> float:
                return float("inf") if key == "+inf" else float(int(key))
            cum = 0
            finite = (k for k in buckets if k != "+inf")
            for key in sorted(finite, key=bound):
                cum += buckets[key]
                lines.append(f'{pname}_bucket{{le="{key}"}} {cum}')
            # The +Inf bucket is total count by definition (covers the
            # registry's own "+inf" overflow bucket too).
            lines.append(f'{pname}_bucket{{le="+Inf"}} {snap["count"]}')
            lines.append(f"{pname}_sum {_prom_value(snap['sum'])}")
            lines.append(f"{pname}_count {snap['count']}")
    return "\n".join(lines) + "\n"


def _exemplar_suffix(ex: Optional[dict]) -> str:
    """OpenMetrics exemplar clause for one bucket line: `` # {labels}
    value``. Empty when the bucket has no exemplar (a series without
    exemplars is valid OpenMetrics)."""
    if not ex:
        return ""
    trace_id = str(ex.get("trace_id", ""))
    safe = trace_id.replace("\\", "\\\\").replace('"', '\\"')
    return f' # {{trace_id="{safe}"}} {_prom_value(ex.get("value"))}'


def render_openmetrics(registry: Optional[obs_metrics.MetricsRegistry]
                       = None) -> str:
    """The registry as OpenMetrics 1.0 text — the exemplar-capable
    sibling of :func:`render_prometheus`. Differences the
    format mandates: counter samples carry the ``_total`` suffix,
    histogram bucket lines may carry ``# {trace_id="..."} value``
    exemplar clauses (the query plane's bucket->trace links), and the
    exposition ends with ``# EOF``. Same deterministic ordering and
    the same NaN/+Inf/-Inf value spellings; scrapers that only speak
    plain Prometheus keep the 0.0.4 renderer (no exemplars) — the
    fallback mode :class:`MetricsExporter` defaults to."""
    registry = registry if registry is not None else obs_metrics.get_registry()
    lines: List[str] = []
    for name, kind, help_text, snap in registry.export_view():
        pname = _prom_name(name)
        lines.append(f"# HELP {pname} {_prom_help(help_text or name)}")
        lines.append(f"# TYPE {pname} {kind}")
        if kind == "counter":
            lines.append(f"{pname}_total {_prom_value(snap)}")
        elif kind == "gauge":
            if snap is None:
                continue  # unset gauge: publish nothing, not NaN
            lines.append(f"{pname} {_prom_value(snap)}")
        else:  # histogram -> cumulative le-buckets (+ exemplars)
            buckets = snap["buckets"]
            exemplars = snap.get("exemplars", {})

            def bound(key: str) -> float:
                return float("inf") if key == "+inf" else float(int(key))
            cum = 0
            finite = (k for k in buckets if k != "+inf")
            for key in sorted(finite, key=bound):
                cum += buckets[key]
                lines.append(
                    f'{pname}_bucket{{le="{key}"}} {cum}'
                    + _exemplar_suffix(exemplars.get(key))
                )
            lines.append(
                f'{pname}_bucket{{le="+Inf"}} {snap["count"]}'
                + _exemplar_suffix(exemplars.get("+inf"))
            )
            lines.append(f"{pname}_sum {_prom_value(snap['sum'])}")
            lines.append(f"{pname}_count {snap['count']}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def update_solve_gauges(iteration: int, info: dict,
                        seconds: Optional[float] = None) -> None:
    """Publish one iteration's headline scalars as registry gauges (the
    live exporter's per-iteration feed) and file the step wall into the
    ``solve.step_seconds`` histogram — whose p50/p90/p99 the exporter
    and run report surface. With a perf-history baseline armed
    (``arm_history_baseline``; CLI ``--history``), also publishes the
    ``history.*`` baseline-delta gauges so a RUNNING solve shows its
    % vs the ledger's baseline, not just absolute rates."""
    obs_metrics.gauge(
        "solve.iteration", "iterations completed by the current solve"
    ).set(iteration + 1)
    for key, help_text in (
        ("l1_delta", "L1 residual of the latest iteration"),
        ("dangling_mass", "dangling mass of the latest iteration"),
        ("rank_mass", "sum(ranks) at the latest probe point"),
    ):
        v = info.get(key)
        if v is not None:
            obs_metrics.gauge("solve." + key, help_text).set(float(v))
    if seconds is not None:
        obs_metrics.histogram(
            "solve.step_seconds_ms",
            "per-iteration wall clock, milliseconds",
        ).record(seconds * 1e3)
        b = _HISTORY_BASELINE
        if b is not None and seconds > 0:
            b.publish(seconds)


# -- perf-history baseline deltas (obs/history.py) ---------------------------


@dataclasses.dataclass
class HistoryBaseline:
    """A ledger-derived throughput baseline armed for the current
    solve: per-step seconds become edges/s/chip against the baseline
    median for this run's leg, published as ``history.*`` gauges every
    iteration. The disarmed hot path pays one ``is None`` check (the
    watchdog/tracer discipline)."""

    leg: str
    baseline_eps: float       # ledger median edges/s/chip for the leg
    num_edges: int
    num_chips: int = 1
    n_baseline: int = 0       # ledger samples behind the median

    def publish(self, seconds: float) -> None:
        eps = self.num_edges / seconds / max(1, self.num_chips)
        obs_metrics.gauge(
            "history.baseline_edges_per_sec_per_chip",
            "perf-ledger baseline (median edges/s/chip) for this "
            "run's leg",
        ).set(self.baseline_eps)
        obs_metrics.gauge(
            "history.edges_per_sec_per_chip",
            "this run's latest per-iteration edges/s/chip",
        ).set(eps)
        if self.baseline_eps > 0:
            obs_metrics.gauge(
                "history.vs_baseline_pct",
                "latest iteration rate vs the perf-ledger baseline, "
                "percent (negative = slower than baseline)",
            ).set((eps / self.baseline_eps - 1.0) * 100.0)


_HISTORY_BASELINE: Optional[HistoryBaseline] = None


def arm_history_baseline(baseline: HistoryBaseline) -> HistoryBaseline:
    """Install the baseline the solve gauges publish deltas against
    (one per process, like the watchdog)."""
    global _HISTORY_BASELINE
    _HISTORY_BASELINE = baseline
    obs_log.info(
        f"perf-history baseline armed: leg '{baseline.leg}' at "
        f"{baseline.baseline_eps:.4g} edges/s/chip "
        f"(median of {baseline.n_baseline} ledger record(s))"
    )
    return baseline


def disarm_history_baseline() -> Optional[HistoryBaseline]:
    global _HISTORY_BASELINE
    prev = _HISTORY_BASELINE
    _HISTORY_BASELINE = None
    return prev


def get_history_baseline() -> Optional[HistoryBaseline]:
    return _HISTORY_BASELINE


class MetricsExporter:
    """Live registry publisher: an atomic textfile rewrite per call
    and/or an HTTP endpoint serving the same rendering. Zero
    dependencies (http.server); the HTTP thread renders on demand, so
    a scrape always sees the current registry."""

    FORMATS = ("prometheus", "openmetrics")
    _CONTENT_TYPES = {
        "prometheus": "text/plain; version=0.0.4",
        "openmetrics":
            "application/openmetrics-text; version=1.0.0; charset=utf-8",
    }

    def __init__(self, textfile: Optional[str] = None,
                 port: Optional[int] = None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 format: str = "prometheus"):
        if format not in self.FORMATS:
            raise ValueError(
                f"format must be one of {self.FORMATS}, got {format!r}")
        self.textfile = textfile
        self.registry = registry
        self.format = format
        self._server = None
        self._thread = None
        self.port = None
        if port is not None:
            self._start_http(port)

    def render(self) -> str:
        if self.format == "openmetrics":
            return render_openmetrics(self.registry)
        return render_prometheus(self.registry)

    def write_textfile(self) -> None:
        """Atomic rewrite (tmp + rename via fsio.atomic_write): a
        concurrent scraper reads the previous complete rendering or
        the new one, never a torn file."""
        if not self.textfile:
            return
        with fsio.atomic_write(self.textfile, "w", suffix=".prom.tmp") as f:
            f.write(self.render())

    def _start_http(self, port: int) -> None:
        import http.server

        exporter = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = exporter.render().encode("utf-8")
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    exporter._CONTENT_TYPES[exporter.format],
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler
        )
        self.port = self._server.server_address[1]  # resolved (port 0 ok)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="pagerank-metrics-http",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        """Final textfile flush + HTTP teardown (idempotent)."""
        try:
            self.write_textfile()
        finally:
            if self._server is not None:
                self._server.shutdown()
                self._server.server_close()
                self._server = None
                if self._thread is not None:
                    self._thread.join(timeout=5)
                    self._thread = None

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


# -- stall watchdog ---------------------------------------------------------


class StallWatchdog:
    """Heartbeat-fed stall detector for long solves.

    ``heartbeat(iteration)`` is called on every solve/step completion
    (engine.run reads the armed watchdog once per run). A daemon
    thread polls; when ``clock() - last_heartbeat > timeout`` it
    emits ONE loud diagnostic per stall episode — last-completed
    iteration, seconds stalled, per-device view — increments the
    ``watchdog.stalls`` counter, and under ``action='raise'``
    interrupts the main thread (KeyboardInterrupt at the next
    bytecode boundary; a stall wedged inside a C call surfaces the
    moment it returns). The episode re-arms on the next heartbeat, so
    a run that stalls twice logs twice.

    ``action='rescue'`` (parallel/elastic.py): the fire additionally
    classifies the stall — a deadline-bounded liveness echo on each
    solve-mesh device (``device_source``; mesh.probe_liveness)
    discriminates *hang* (every device answers) from *device-lost* —
    sets :attr:`rescue_requested`, and interrupts the main thread
    exactly like 'raise'. The elastic runner catches the interrupt,
    calls :meth:`consume_rescue`, and performs the rescue; a plain run
    (no runner) sees an ordinary KeyboardInterrupt. Under the CLI the
    interrupt is a SIGINT, which its drain handler turns back into a
    KeyboardInterrupt while a rescue request is pending (jobs.py).

    ``clock``/``sleep`` are injectable: tests drive :meth:`check` in
    virtual time with no thread (utils/retry.py discipline).
    """

    ACTIONS = ("warn", "raise", "rescue")

    def __init__(self, timeout_s: float, action: str = "warn",
                 poll_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 interrupt: Optional[Callable[[], None]] = None,
                 liveness_timeout_s: float = 2.0,
                 device_source: Optional[Callable[[], Sequence]] = None):
        if timeout_s <= 0:
            raise ValueError(f"stall timeout must be > 0, got {timeout_s}")
        if action not in self.ACTIONS:
            raise ValueError(
                f"action must be one of {self.ACTIONS}, got {action!r}")
        self.timeout_s = float(timeout_s)
        self.action = action
        self.poll_s = poll_s if poll_s is not None else min(
            1.0, self.timeout_s / 4
        )
        self.clock = clock
        self._sleep = sleep
        self._interrupt = interrupt if interrupt is not None else (
            self._default_interrupt
        )
        self.liveness_timeout_s = float(liveness_timeout_s)
        #: Where classification gets its device list: a callable
        #: returning the SOLVE MESH's devices (the CLI wires the current
        #: engine's device — after a rescue it tracks the rebuilt one).
        #: None falls back to every visible device, which can blame a
        #: card the solve never uses.
        self.device_source = device_source
        self._last = self.clock()
        self.last_iteration: Optional[int] = None
        self.stalls = 0
        self._fired = False  # one diagnostic per stall episode
        self.rescue_requested = False
        self.last_classification: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _default_interrupt() -> None:
        import _thread

        _thread.interrupt_main()

    def heartbeat(self, iteration: Optional[int] = None) -> None:
        """Progress signal — one per completed solve step."""
        self._last = self.clock()
        if iteration is not None:
            self.last_iteration = iteration
        self._fired = False  # new progress re-arms the episode

    def consume_rescue(self) -> bool:
        """Whether the latest fire requested a rescue; reading it
        clears the flag (the elastic runner's one-shot handshake — a
        later unrelated KeyboardInterrupt must not rescue)."""
        req = self.rescue_requested
        self.rescue_requested = False
        return req

    def _classify(self) -> str:
        """Hang vs device-lost, best-effort: a deadline-bounded liveness
        echo per SOLVE-MESH device (``device_source``;
        parallel/mesh.probe_liveness). Never raises — classification is
        diagnostic input, and a probe that cannot run still leaves the
        stall loud."""
        try:
            from pagerank_tpu_torch.parallel import distributed
            from pagerank_tpu_torch.parallel import mesh as mesh_lib

            devs = (self.device_source()
                    if self.device_source is not None else None)
            alive = mesh_lib.probe_liveness(
                devs, timeout_s=self.liveness_timeout_s
            )
            dead = sorted(d for d, ok in alive.items() if not ok)
            group = ("" if distributed.process_info()[1] == 1 else
                     " on this rank; the runner's roll call classifies "
                     "the group's members")
            if dead:
                return f"DEVICE-LOST (no liveness echo from {dead}){group}"
            return f"hang (all devices answer liveness probes){group}"
        except Exception as e:
            return f"unclassified (liveness probe failed: {type(e).__name__})"

    def stalled_for(self) -> float:
        return self.clock() - self._last

    def _device_view(self) -> str:
        """Best-effort per-device line for the stall diagnostic (the
        'which chip is wedged' starting point). Never raises — a
        watchdog diagnostic must not die gathering its evidence."""
        try:
            from pagerank_tpu_torch.parallel import mesh as mesh_lib

            return "; ".join(mesh_lib.device_view())
        except Exception as e:
            return f"(device view unavailable: {type(e).__name__})"

    def check(self) -> bool:
        """One poll: declare a stall if the heartbeat is older than the
        timeout. Returns whether THIS call declared one (tests drive
        this directly in virtual time)."""
        stalled = self.stalled_for()
        if stalled <= self.timeout_s or self._fired:
            return False
        self._fired = True
        self.stalls += 1
        obs_metrics.counter(
            "watchdog.stalls",
            "stall episodes declared by the solve watchdog",
        ).inc()
        it = ("none completed" if self.last_iteration is None
              else f"last completed iteration {self.last_iteration}")
        classified = ""
        if self.action == "rescue":
            self.last_classification = self._classify()
            classified = f"; classification: {self.last_classification}"
        obs_log.warn(
            f"STALL WATCHDOG: no solve progress for {stalled:.1f}s "
            f"(timeout {self.timeout_s:g}s); {it}; devices: "
            f"{self._device_view()}{classified}"
        )
        if self.action == "rescue":
            self.rescue_requested = True
            self._interrupt()
        elif self.action == "raise":
            self._interrupt()
        return True

    # -- thread lifecycle --------------------------------------------------

    def start(self) -> "StallWatchdog":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="pagerank-stall-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self._sleep(self.poll_s)
            if self._stop.is_set():
                break
            self.check()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# -- process-global arming (the engine.run hook point) ----------------------

_WATCHDOG: Optional[StallWatchdog] = None


def get_watchdog() -> Optional[StallWatchdog]:
    """The armed watchdog, or None (the default — engine.run reads this
    once per run; the disarmed hot path costs one ``is None`` check per
    iteration)."""
    return _WATCHDOG


def arm_watchdog(wd: StallWatchdog) -> StallWatchdog:
    """Install ``wd`` as the process watchdog and start its thread."""
    global _WATCHDOG
    disarm_watchdog()
    _WATCHDOG = wd
    wd.start()
    return wd


def disarm_watchdog() -> Optional[StallWatchdog]:
    """Stop and remove the armed watchdog (returns it; idempotent)."""
    global _WATCHDOG
    prev = _WATCHDOG
    _WATCHDOG = None
    if prev is not None:
        prev.stop()
    return prev
