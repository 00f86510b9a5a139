"""HTTP query ingress for the PPR daemon (the ``python -m
pagerank_tpu_torch.serve`` entry point's front door).

Copy of ``pagerank_tpu/serving/http.py``.

Mirrors the ``obs/live.py`` ``MetricsExporter`` shape: zero
dependencies (``http.server``), loopback bind, port 0 supported (the
resolved port is published on ``.port``). The typed query outcomes map
onto HTTP statuses so a load balancer can act on them without parsing
bodies:

===========================  ======  ================================
outcome                      status  notes
===========================  ======  ================================
answered / answered_cache /  200     JSON body with ids + scores
answered_degraded
``Overloaded`` (shed)        429     ``Retry-After`` header carries
                                     the hint from admission
``Draining`` (SIGTERM)       503     retry against another replica
``QueryDeadlineExceeded``    504     deadline passed / dispatch bound
===========================  ======  ================================
"""

from __future__ import annotations

import json
import re
import threading
from typing import Optional
from urllib.parse import parse_qs, urlparse

from pagerank_tpu_torch.serving.daemon import PprServer
from pagerank_tpu_torch.serving.query import (Draining, Overloaded,
                                        QueryDeadlineExceeded,
                                        ServeRejected)

_STATUS = {
    "shed_overload": 429,
    "rejected_draining": 503,
    "rejected_deadline": 504,
    "rejected": 500,
}

# W3C trace-context level-1: version-traceid-parentid-flags, lowercase
# hex, all-zero trace/parent ids invalid (the spec's "not a trace").
_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def parse_traceparent(value: Optional[str]) -> Optional[str]:
    """The trace id of a valid ``traceparent`` header, else None
    (malformed headers degrade to a server-assigned id, never a 4xx —
    trace context is best-effort metadata)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    trace_id, parent_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return trace_id


def format_traceparent(trace_id: str, qid: int) -> str:
    """The response ``traceparent``: the query's trace id with the
    server's span id (a deterministic function of the qid, matching
    the trace-id fallback) and the sampled flag. The ONE encoder for
    both helper and header paths, so the span-id scheme cannot
    drift."""
    return "00-%s-%016x-01" % (trace_id, (int(qid) + 1) & (2 ** 64 - 1))


def _query_payload(q, ids, scores) -> dict:
    return {
        "qid": q.qid,
        "source": q.source,
        "k": q.k,
        "outcome": q.outcome,
        "served_from": q.served_from,
        "trace_id": q.trace_id,
        "latency_ms": round(1000.0 * (q.latency_s or 0.0), 3),
        "ids": [int(i) for i in ids],
        "scores": [float(s) for s in scores],
    }


class QueryIngress:
    """Loopback HTTP front door over a started :class:`PprServer`.

    ``GET /ppr?source=<id>[&k=<k>][&deadline_ms=<ms>]`` submits one
    query and blocks the handler thread (ThreadingHTTPServer: one
    thread per connection) until its typed terminal state.
    ``GET /healthz`` reports serving/degraded/draining."""

    def __init__(self, server: PprServer, port: int = 0):
        self.server = server
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        self._start(port)

    def _handle_ppr(self, params: dict, traceparent: Optional[str] = None):
        try:
            source = int(params["source"][0])
        except (KeyError, ValueError, IndexError):
            return 400, {"error": "missing or non-integer 'source'"}
        k = None
        if "k" in params:
            try:
                k = int(params["k"][0])
            except ValueError:
                return 400, {"error": "non-integer 'k'"}
        deadline_s = None
        if "deadline_ms" in params:
            try:
                deadline_s = float(params["deadline_ms"][0]) / 1000.0
            except ValueError:
                return 400, {"error": "non-numeric 'deadline_ms'"}

        srv = self.server
        q = srv.submit(source, k=k, deadline_s=deadline_s,
                       trace_id=parse_traceparent(traceparent))
        if q.trace is not None:
            from pagerank_tpu_torch.obs import trace as obs_trace
            obs_trace.get_tracer().set_thread_label(
                threading.get_ident(), "serve-http"
            )
        # Settlement is guaranteed typed; the bound below only trips if
        # that contract is broken (surfaced as a 500, not a hang).
        settle_bound = (
            (deadline_s or srv.serve_config.deadline_ms / 1000.0)
            + srv.serve_config.dispatch_timeout_s + 1.0
        )
        try:
            ids, scores = q.result(timeout=settle_bound)
        except Overloaded as e:
            return 429, {"error": str(e), "outcome": e.outcome,
                         "qid": q.qid, "trace_id": q.trace_id,
                         "retry_after_s": e.retry_after_s}
        except ServeRejected as e:
            return (_STATUS.get(e.outcome, 500),
                    {"error": str(e), "outcome": e.outcome,
                     "qid": q.qid, "trace_id": q.trace_id})
        except TimeoutError as e:
            return 500, {"error": str(e), "outcome": "unsettled",
                         "qid": q.qid, "trace_id": q.trace_id}
        tr = q.trace
        if tr is not None:
            t0 = srv._clock()
        payload = _query_payload(q, ids, scores)
        if tr is not None:
            # The query settled before resolve() woke this thread, so
            # the trace is sealed: this phase mirrors into the live
            # tracer (the serve-http Chrome lane) but stays out of the
            # settled record — slow-log, flight dumps, digest.
            tr.phase("query/serialize", t0, srv._clock() - t0)
        return 200, payload

    def _handle_healthz(self):
        srv = self.server
        if srv.queue.closed:
            state = "draining"
        elif srv.degraded:
            state = "degraded"
        else:
            state = "serving"
        return (200 if state != "draining" else 503), {
            "status": state,
            "devices": srv.device_count,
            "queue_depth": len(srv.queue),
        }

    def _start(self, port: int) -> None:
        import http.server

        ingress = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                parsed = urlparse(self.path)
                if parsed.path == "/ppr":
                    status, payload = ingress._handle_ppr(
                        parse_qs(parsed.query),
                        traceparent=self.headers.get("traceparent"),
                    )
                elif parsed.path == "/healthz":
                    status, payload = ingress._handle_healthz()
                else:
                    self.send_error(404)
                    return
                body = json.dumps(payload).encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if status == 429 and "retry_after_s" in payload:
                    self.send_header(
                        "Retry-After",
                        str(max(1, int(round(payload["retry_after_s"]))))
                    )
                if "trace_id" in payload:
                    # Every payload that carries trace_id carries qid;
                    # a missing qid is a bug and should fail loudly,
                    # never encode span id 0x1 for the wrong query.
                    self.send_header(
                        "traceparent",
                        format_traceparent(payload["trace_id"],
                                           payload["qid"]),
                    )
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler
        )
        self.port = self._httpd.server_address[1]  # resolved (port 0 ok)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pagerank-serve-http",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._thread is not None:
                self._thread.join(timeout=5)
                self._thread = None

    def __enter__(self) -> "QueryIngress":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
