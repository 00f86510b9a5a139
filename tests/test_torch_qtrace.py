"""The query plane of the port's serving layer (a copy of
``pagerank_tpu/serving/qtrace.py``) on the CPU: the cases of
tests/test_qtrace.py that need neither the run report, the live
exporter nor the chaos harness (later slices of the port), against the
port's copies, under the JAX package's ``VirtualClock``; the rescue's
flight dump through an injected liveness probe and engine factory."""

import glob
import json
import os
import re
import threading
import time
import urllib.request

import pytest
import torch

from pagerank_tpu.testing.schedules import VirtualClock

from pagerank_tpu_torch import PageRankConfig, build_graph
from pagerank_tpu_torch.engines.ppr import PprTorchEngine
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.obs import trace as obs_trace
from pagerank_tpu_torch.parallel import elastic, mesh
from pagerank_tpu_torch.serving import (PprServer, ServeConfig, qtrace)
from pagerank_tpu_torch.serving.admission import (AdmissionQueue,
                                                  BatchWallModel)
from pagerank_tpu_torch.serving.http import (QueryIngress,
                                             format_traceparent,
                                             parse_traceparent)
from pagerank_tpu_torch.serving.query import PendingQuery
from pagerank_tpu_torch.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def graph():
    src, dst = synth.rmat_edges(8, edge_factor=8, seed=3)
    return build_graph(src, dst, n=256)


@pytest.fixture(autouse=True)
def _clean_plane():
    """Every test starts and ends disarmed (the process-global default)."""
    qtrace.disarm_query_plane()
    yield
    qtrace.disarm_query_plane()
    obs_trace.disable_tracing()


def serve_config(**kw):
    base = dict(max_batch=4, queue_depth=16, deadline_ms=400.0, topk=8,
                wall_alpha=0.0, wall_initial_s=0.05, cache_capacity=64,
                batch_margin_s=0.01)
    base.update(kw)
    return ServeConfig(**base)


def make_server(graph, clock, **sc_kw):
    srv = PprServer(graph, config=PageRankConfig(num_iters=5),
                    serve_config=serve_config(**sc_kw), devices=[CPU],
                    clock=clock)
    srv.start(dispatcher=False)
    return srv

# -- the zero-cost pin (the booby trap) -------------------------------------


class BombTracer:
    """Any tracer call on the disarmed hot path is a test failure."""

    enabled = False

    def _bomb(self, *a, **k):  # pragma: no cover - the trap
        raise AssertionError("tracer touched on the disarmed serve path")

    span = add_span = add_event = _bomb
    start_span = finish_span = set_thread_label = _bomb


def test_disarmed_booby_trap(graph, monkeypatch):
    """With the query plane DISARMED, an admitted query makes ZERO
    tracer calls and ZERO exemplar (trace-id-carrying) histogram
    records on the admission/dispatch hot path — the acceptance
    criterion pinning 'observability off' as byte-identical work."""
    assert qtrace.get_query_plane() is None
    orig_record = obs_metrics.Histogram.record

    def guarded_record(self, v, trace_id=None):
        assert trace_id is None, "exemplar recorded while disarmed"
        return orig_record(self, v)

    monkeypatch.setattr(obs_metrics.Histogram, "record", guarded_record)
    monkeypatch.setattr(obs_trace, "_TRACER", BombTracer())
    clock = VirtualClock()
    srv = make_server(graph, clock)
    # Miss -> admitted -> dispatched; then a cache hit; then a shed.
    q1 = srv.submit(7, k=4)
    clock.advance(0.36)
    srv.pump()
    q2 = srv.submit(7, k=4)                      # cache hit path
    assert q1.outcome == "answered"
    assert q2.outcome == "answered_cache"
    assert q1.trace is None and q2.trace is None
    srv.drain()


def test_trace_id_carried_even_disarmed(graph):
    """Every typed outcome carries a W3C-shaped trace id, armed or
    not: the deterministic qid+1 fallback, or the adopted upstream id."""
    clock = VirtualClock()
    srv = make_server(graph, clock)
    q = srv.submit(3, k=4)
    assert re.fullmatch(r"[0-9a-f]{32}", q.trace_id)
    assert q.trace_id == format(q.qid + 1, "032x")
    adopted = "ab" * 16
    q2 = srv.submit(4, k=4, trace_id=adopted)
    assert q2.trace_id == adopted
    srv.drain()


# -- armed trace assembly ----------------------------------------------------


def test_armed_phases_links_and_outcomes(graph):
    """Armed: every settle carries the full phase timeline (admission
    decision, batch close reason, dispatch, fetch), batch-mates are
    span-linked to each other, and the cache path records its hit."""
    qtrace.arm_query_plane()
    plane = qtrace.get_query_plane()
    clock = VirtualClock()
    srv = make_server(graph, clock, max_batch=2)
    qa = srv.submit(11, k=4)
    qb = srv.submit(12, k=4)
    srv.pump()          # closes full (max_batch=2)
    qc = srv.submit(11, k=4)      # cache hit
    assert qa.outcome == "answered" and qc.outcome == "answered_cache"
    assert plane.settled_count == 3

    ta, tb, tc = qa.trace, qb.trace, qc.trace
    names_a = [p["name"] for p in ta.phases]
    assert names_a == ["query/cache", "query/admission",
                       "query/batch_wait", "query/dispatch",
                       "query/fetch"]
    attrs = {p["name"]: p.get("attrs", {}) for p in ta.phases}
    assert attrs["query/cache"] == {"hit": False}
    assert attrs["query/admission"] == {"decision": "admitted"}
    assert attrs["query/batch_wait"]["close_reason"] == "full"
    assert attrs["query/batch_wait"]["batch_size"] == 2
    assert attrs["query/dispatch"]["rerun"] is False
    # Batch membership via links, both directions, never self.
    assert ta.links == [tb.trace_id]
    assert tb.links == [ta.trace_id]
    assert ta.outcome == "answered"
    # Cache path: one query/cache phase with hit=True, nothing else.
    assert [p["name"] for p in tc.phases] == ["query/cache"]
    assert tc.phases[0]["attrs"] == {"hit": True}
    assert tc.outcome == "answered_cache"
    srv.drain()


def test_armed_shed_and_draining_settle_typed(graph):
    """Sheds and drain rejections settle their traces with the typed
    outcome + admission decision attr (no silent trace drops)."""
    qtrace.arm_query_plane()
    plane = qtrace.get_query_plane()
    clock = VirtualClock()
    srv = make_server(graph, clock, queue_depth=1, max_batch=1,
                      cache_capacity=0)
    srv.submit(1, k=4)
    q_shed = srv.submit(2, k=4)     # queue full -> shed
    assert q_shed.outcome == "shed_overload"
    srv.drain()
    q_drain = srv.submit(3, k=4)
    assert q_drain.outcome == "rejected_draining"
    shapes = {t.outcome for t in plane._ring}
    assert {"shed_overload", "rejected_draining"} <= shapes
    tr = q_shed.trace
    assert tr.phases[-1]["attrs"]["decision"] == "shed_overload"


def test_tracer_mirror_cross_thread_tree(graph):
    """With the process tracer armed too, the query's phases land as
    handle-parented spans under one root per query — a single trace
    tree even when phases come from different threads — and the Chrome
    export carries thread_name metadata lanes."""
    tracer = obs_trace.enable_tracing()
    tracer.set_thread_label(threading.get_ident(), "test-main")
    qtrace.arm_query_plane()
    srv = PprServer(graph, config=PageRankConfig(num_iters=5),
                    serve_config=serve_config(), devices=[CPU])
    srv.start()          # REAL dispatcher thread
    try:
        q = srv.submit(9, k=4, deadline_s=5.0)
        ids, scores = q.result(timeout=10.0)
        assert len(ids) == 4
    finally:
        srv.drain()
    obs_trace.disable_tracing()
    spans = tracer.spans()
    roots = [s for s in spans if s.name == "query"]
    assert len(roots) == 1
    root = roots[0]
    children = [s for s in spans if s.parent_id == root.span_id]
    child_names = {s.name for s in children}
    assert "query/batch_wait" in child_names
    assert "query/dispatch" in child_names
    # The dispatch-side phases ran on the dispatcher thread: the tree
    # crosses threads while staying parented to the one root.
    assert {s.tid for s in spans if s.name.startswith("query/")} >= \
        {root.tid} or len({s.tid for s in children}) >= 1
    ev = tracer.chrome_events()
    meta = [e for e in ev if e.get("ph") == "M"
            and e.get("name") == "thread_name"]
    labels = {e["args"]["name"] for e in meta}
    assert {"test-main", "serve-dispatch"} <= labels


def test_closed_batch_reasons():
    """AdmissionQueue batches carry WHY they closed: full at max size,
    deadline at the close margin, drain at shutdown."""
    clock = VirtualClock()

    def q_(qid, deadline_s=10.0):
        now = clock()
        return PendingQuery(qid=qid, source=qid, k=4,
                            deadline=now + deadline_s, t_submit=now)

    aq = AdmissionQueue(max_batch=2, queue_depth=16, batch_margin_s=0.01,
                        wall_model=BatchWallModel(initial_s=0.05, alpha=0.0),
                        clock=clock)
    aq.offer(q_(0))
    aq.offer(q_(1))
    b = aq.try_close_batch()
    assert list(b) == [b[0], b[1]] and b.close_reason == "full"
    aq.batch_done()
    aq.offer(q_(2, deadline_s=1.0))
    clock.advance(0.95)
    b2 = aq.try_close_batch()
    assert b2.close_reason == "deadline"
    aq.batch_done()
    aq.offer(q_(3))
    aq.close()
    b3 = aq.try_close_batch()
    assert b3.close_reason == "drain"


# -- determinism with tracing armed ------------------------------------------


# -- W3C traceparent at the HTTP edge ----------------------------------------


def test_parse_traceparent_grammar():
    tid = "a" * 32
    assert parse_traceparent(f"00-{tid}-{'b' * 16}-01") == tid
    # Uppercase tolerated (lowercased), surrounding whitespace stripped.
    assert parse_traceparent(f" 00-{tid.upper()}-{'B' * 16}-01 ") == tid
    # Invalid: all-zero ids, wrong lengths, garbage, empty, None.
    assert parse_traceparent(f"00-{'0' * 32}-{'b' * 16}-01") is None
    assert parse_traceparent(f"00-{tid}-{'0' * 16}-01") is None
    assert parse_traceparent(f"00-{tid[:-1]}-{'b' * 16}-01") is None
    assert parse_traceparent("not-a-traceparent") is None
    assert parse_traceparent("") is None
    assert parse_traceparent(None) is None


def test_format_traceparent_roundtrips():
    clock = VirtualClock()
    q = PendingQuery(qid=41, source=0, k=4, deadline=10.0,
                     t_submit=clock())
    tp = format_traceparent(q.trace_id, q.qid)
    assert re.fullmatch(r"00-[0-9a-f]{32}-[0-9a-f]{16}-01", tp)
    assert parse_traceparent(tp) == q.trace_id


def test_http_traceparent_roundtrip(graph):
    """`/ppr` accepts an upstream traceparent (the query adopts its
    trace id), returns one on every response, and degrades malformed
    headers to a server-assigned id — never a 4xx."""
    srv = PprServer(graph, config=PageRankConfig(num_iters=5),
                    serve_config=serve_config(), devices=[CPU])
    srv.start()
    try:
        with QueryIngress(srv, port=0) as ing:
            base = f"http://127.0.0.1:{ing.port}/ppr?source=5&k=4"
            sent = "c" * 32
            req = urllib.request.Request(
                base, headers={"traceparent": f"00-{sent}-{'d' * 16}-01"}
            )
            with urllib.request.urlopen(req, timeout=30) as resp:
                body = json.load(resp)
                assert resp.status == 200
                assert body["trace_id"] == sent
                hdr = resp.headers["traceparent"]
            assert parse_traceparent(hdr) == sent
            # Malformed header: served fine, server-assigned id.
            req2 = urllib.request.Request(
                base, headers={"traceparent": "garbage"}
            )
            with urllib.request.urlopen(req2, timeout=30) as resp2:
                body2 = json.load(resp2)
                assert resp2.status == 200
                assert re.fullmatch(r"[0-9a-f]{32}", body2["trace_id"])
                assert body2["trace_id"] != sent
                assert parse_traceparent(resp2.headers["traceparent"]) \
                    == body2["trace_id"]
    finally:
        srv.drain()


# -- monotonic-clock pin (satellite c) ---------------------------------------


def test_no_wall_clock_in_serving_deadline_math():
    """Static pin: no ``time.time(`` anywhere in serving/ — deadline
    arithmetic runs on the injected clock (default ``time.monotonic``),
    so an NTP step can never expire or extend a query."""
    for path in glob.glob(
        os.path.join(REPO, "pagerank_tpu_torch", "serving", "*.py")
    ):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        assert "time.time(" not in src, (
            f"{os.path.basename(path)} uses wall-clock time.time(); "
            "serving deadline math must stay monotonic"
        )


def test_ntp_step_does_not_move_deadlines(graph, monkeypatch):
    """Behavioral pin: a +/-1h wall-clock step mid-flight (time.time
    patched) changes NO admission or settle decision — the daemon
    never consults the wall clock."""
    clock = VirtualClock()
    srv = make_server(graph, clock)
    q1 = srv.submit(21, k=4)
    # The NTP step lands while q1 is queued.
    monkeypatch.setattr(time, "time", lambda: time.monotonic() + 3600.0)
    clock.advance(0.36)
    srv.pump()
    assert q1.outcome == "answered"
    monkeypatch.setattr(time, "time", lambda: time.monotonic() - 3600.0)
    q2 = srv.submit(22, k=4)
    clock.advance(0.36)
    srv.pump()
    assert q2.outcome == "answered"
    srv.drain()


# -- exemplars and the OpenMetrics exporter (satellite d) --------------------

def test_histogram_exemplars_only_with_trace_id():
    reg = obs_metrics.MetricsRegistry()
    h = reg.histogram("t.lat_ms", "test")
    h.record(3.0)
    assert h.exemplars_view() == {}      # plain records never allocate
    h.record(3.0, trace_id="e" * 32)
    h.record(700.0, trace_id="f" * 32)
    ex = h.exemplars_view()
    assert {e["trace_id"] for e in ex.values()} == {"e" * 32, "f" * 32}
    snap = h.snapshot()
    assert snap["exemplars"] == ex
    # Snapshot omits the key entirely when no exemplar was recorded.
    h2 = reg.histogram("t.plain_ms", "test")
    h2.record(1.0)
    assert "exemplars" not in h2.snapshot()


# -- slow-query log and flight recorder --------------------------------------


def test_slow_query_log_strict_jsonl(graph, tmp_path):
    """Settles >= --slow-query-ms write ONE strict-JSON line each with
    the pinned schema; faster settles write nothing."""
    log = str(tmp_path / "slow.jsonl")
    qtrace.arm_query_plane(slow_query_ms=60.0, slow_query_path=log)
    plane = qtrace.get_query_plane()
    clock = VirtualClock()
    srv = make_server(graph, clock)
    q_slow = srv.submit(31, k=4)
    clock.advance(0.36)          # waits ~360ms -> slow
    srv.pump()
    q_fast = srv.submit(31, k=4)  # cache hit, 0ms -> not slow
    srv.drain()
    assert q_slow.outcome == "answered"
    assert q_fast.outcome == "answered_cache"
    assert plane.slow_count == 1
    qtrace.disarm_query_plane()   # closes the file

    def reject(s):
        raise AssertionError(f"non-strict constant {s!r}")

    with open(log, encoding="utf-8") as f:
        recs = [json.loads(line, parse_constant=reject) for line in f]
    assert len(recs) == 1
    rec = recs[0]
    assert set(rec) == set(qtrace.SLOW_QUERY_KEYS)
    assert rec["type"] == "slow_query"
    assert rec["trace_id"] == q_slow.trace_id
    assert rec["latency_ms"] >= 60.0
    assert [p["name"] for p in rec["phases"]][-1] == "query/fetch"


def test_flight_recorder_ring_and_dump_reasons(graph):
    """The ring keeps the last N settled timelines; drain and rescue
    each snapshot it; the report section carries the dumps."""
    qtrace.arm_query_plane(ring_size=4)
    plane = qtrace.get_query_plane()
    clock = VirtualClock()
    srv = make_server(graph, clock, cache_capacity=0)
    for i in range(6):
        srv.submit(40 + i, k=4)
        clock.advance(0.36)
        srv.pump()
    srv.drain()
    assert plane.settled_count == 6
    dump = plane.flight_dump("fatal")
    assert dump["reason"] == "fatal"
    assert len(dump["traces"]) == 4          # ring_size bound
    # drain() already pushed its own dump before ours.
    sec = plane.report_section()
    assert sec["enabled"] is True
    reasons = [d["reason"] for d in sec["flight_dumps"]]
    assert reasons[-2:] == ["drain", "fatal"]
    assert all(
        re.fullmatch(r"[0-9a-f]{32}", t["trace_id"])
        for d in sec["flight_dumps"] for t in d["traces"]
    )


# -- plane internals ---------------------------------------------------------


def test_phase_p99_math_and_empty_legs():
    plane = qtrace.QueryPlane()
    tr = plane.new_trace(0, 5, qtrace.default_trace_id(0), start_s=0.0)
    for i in range(100):
        tr.phases.append({"name": "query/dispatch", "start_s": 0.0,
                          "duration_s": (i + 1) / 1000.0,
                          "tid": 0})
    plane.settle(tr, "answered", 1.0, 100.0)
    p99 = plane.phase_p99_ms()
    assert p99["dispatch"] == pytest.approx(99.0)
    assert p99["admission_wait"] == 0.0     # no samples -> 0.0
    assert p99["batch_wait"] == 0.0 and p99["fetch"] == 0.0


def test_structure_digest_ignores_timestamps_and_tids():
    def build(start, tid):
        plane = qtrace.QueryPlane()
        for qid in (0, 1):
            tr = plane.new_trace(qid, 5, qtrace.default_trace_id(qid),
                                 start_s=start)
            tr.phases.append({"name": "query/dispatch",
                              "start_s": start + qid,
                              "duration_s": 0.5 * (qid + 1), "tid": tid})
            tr.link(qtrace.default_trace_id(1 - qid))
            plane.settle(tr, "answered", start + 2, 100.0)
        return plane.structure_digest()

    assert build(0.0, 111) == build(99.0, 222)
    # ... but a structural change (outcome) moves it.
    plane = qtrace.QueryPlane()
    tr = plane.new_trace(0, 5, qtrace.default_trace_id(0), start_s=0.0)
    plane.settle(tr, "rejected_deadline", 1.0, None)
    tr2 = plane.new_trace(1, 5, qtrace.default_trace_id(1), start_s=0.0)
    plane.settle(tr2, "answered", 1.0, 1.0)
    assert plane.structure_digest() != build(0.0, 111)


def test_default_trace_id_never_all_zero():
    assert qtrace.default_trace_id(0) == "0" * 31 + "1"
    assert all(qtrace.default_trace_id(i) != "0" * 32 for i in range(64))


# -- bounded-memory + publish-last regression pins (review fixes) ------------


def test_structure_digest_order_independent_and_o1_memory():
    """The digest is a rolling per-trace-hash sum folded in at settle:
    settle order must not move it (threads interleave settles), and the
    plane must retain NO per-query list — a lifetime-armed daemon stays
    O(1) in query count."""
    def build(order):
        plane = qtrace.QueryPlane()
        trs = []
        for qid in (0, 1, 2):
            tr = plane.new_trace(qid, qid, qtrace.default_trace_id(qid),
                                 start_s=0.0)
            tr.phases.append({"name": "query/dispatch", "start_s": 0.0,
                              "duration_s": 0.1 * (qid + 1), "tid": 7})
            trs.append(tr)
        for i in order:
            plane.settle(trs[i], "answered", 1.0, 5.0)
        return plane, plane.structure_digest()

    p1, d1 = build([0, 1, 2])
    p2, d2 = build([2, 0, 1])
    assert d1 == d2
    assert not hasattr(p1, "_settled")   # the unbounded ledger is gone
    # Bounded state only: ring + samples are deques with maxlen.
    assert p1._ring.maxlen is not None
    assert all(dq.maxlen is not None for dq in p1._samples.values())


def test_sealed_trace_ignores_post_settle_phase_appends():
    """After settle seals a trace, a late phase (the ingress thread's
    query/serialize) must not mutate the settled record or move the
    digest — it mirrors only into the live tracer."""
    tracer = obs_trace.enable_tracing()
    qtrace.arm_query_plane()
    plane = qtrace.get_query_plane()
    tr = plane.new_trace(0, 1, qtrace.default_trace_id(0), start_s=0.0)
    tr.phase("query/fetch", 0.0, 0.1)
    plane.settle(tr, "answered", 1.0, 100.0)
    digest = plane.structure_digest()
    tr.phase("query/serialize", 1.0, 0.01)
    assert [p["name"] for p in tr.phases] == ["query/fetch"]
    assert plane.structure_digest() == digest
    # ... but the live span tree still shows the serialize lane.
    assert "query/serialize" in {s.name for s in tracer.spans()}


def test_settle_happens_before_resolve_publishes(graph):
    """resolve() is the LAST step of every settle path: when the
    waiting thread wakes, the trace is already sealed and counted, so
    post-wake work can never race the dispatcher on the timeline."""
    qtrace.arm_query_plane()
    plane = qtrace.get_query_plane()
    srv = PprServer(graph, config=PageRankConfig(num_iters=5),
                    serve_config=serve_config(), devices=[CPU])
    srv.start()          # REAL dispatcher thread
    try:
        q = srv.submit(17, k=4, deadline_s=5.0)
        q.result(timeout=10.0)
        assert plane.settled_count == 1
        assert q.trace._sealed is True
    finally:
        srv.drain()


def test_serialize_phase_stays_out_of_settled_record(graph):
    """End-to-end over HTTP: query/serialize shows in the live Chrome
    lanes but never in the flight-recorder ring (the settled record)."""
    tracer = obs_trace.enable_tracing()
    qtrace.arm_query_plane()
    plane = qtrace.get_query_plane()
    srv = PprServer(graph, config=PageRankConfig(num_iters=5),
                    serve_config=serve_config(), devices=[CPU])
    srv.start()
    try:
        with QueryIngress(srv, port=0) as ing:
            url = f"http://127.0.0.1:{ing.port}/ppr?source=6&k=4"
            with urllib.request.urlopen(url, timeout=30) as resp:
                assert resp.status == 200
    finally:
        srv.drain()
    obs_trace.disable_tracing()
    ring_names = {p["name"] for t in plane._ring for p in t.phases}
    assert "query/fetch" in ring_names
    assert "query/serialize" not in ring_names
    assert "query/serialize" in {s.name for s in tracer.spans()}


def test_tracer_max_spans_ring():
    """Tracer(max_spans=N) keeps the most recent N finished spans — the
    bounded mode the daemon's --query-trace capture runs in."""
    tr = obs_trace.Tracer(max_spans=10)
    for i in range(25):
        sp = tr.start_span(f"s{i}")
        tr.finish_span(sp)
    spans = tr.spans()
    assert len(spans) == 10
    assert spans[0].name == "s15" and spans[-1].name == "s24"
    # Default stays unbounded (finite solver captures export it all).
    tr2 = obs_trace.Tracer()
    for i in range(25):
        tr2.finish_span(tr2.start_span(f"t{i}"))
    assert len(tr2.spans()) == 25


def test_serve_cli_rejects_half_slow_query_pair(tmp_path, capsys):
    """--slow-query-ms and --slow-query-log are a pair: half of it is a
    silent no-op, so the CLI refuses it at parse time (exit 2)."""
    from pagerank_tpu_torch.serve.__main__ import main

    with pytest.raises(SystemExit) as e1:
        main(["--slow-query-ms", "5"])
    assert e1.value.code == 2
    with pytest.raises(SystemExit) as e2:
        main(["--slow-query-log", str(tmp_path / "slow.jsonl")])
    assert e2.value.code == 2
    err = capsys.readouterr().err
    assert "must be given together" in err


def test_serve_latency_exemplars_from_armed_queries(graph):
    """Armed queries stamp their trace ids onto the serve.latency_ms
    buckets (the OpenMetrics rendering is the live exporter's, a later
    slice)."""
    reg = obs_metrics.get_registry()
    reg.reset()
    qtrace.arm_query_plane()
    clock = VirtualClock()
    srv = make_server(graph, clock)
    q = srv.submit(13, k=4)
    clock.advance(0.36)
    srv.pump()
    assert q.outcome == "answered"
    h = reg.histogram("serve.latency_ms", "")
    ex = h.exemplars_view()
    assert any(e["trace_id"] == q.trace_id for e in ex.values())
    srv.drain()
    reg.reset()


def test_rescue_triggers_flight_dump(graph):
    """A device loss on the second of two devices: the rescue re-runs
    the batch (attempts 2, rerun True) and dumps the flight recorder."""
    qtrace.arm_query_plane()
    plane = qtrace.get_query_plane()
    clock = VirtualClock()

    def factory(devs):
        return PprTorchEngine(PageRankConfig(num_iters=5),
                              device="cpu").build(graph)

    srv = PprServer(
        graph, config=PageRankConfig(num_iters=5),
        serve_config=serve_config(),
        devices=[torch.device("cuda", 0), torch.device("cuda", 1)],
        engine_factory=factory, clock=clock,
        liveness_probe=lambda devs, timeout_s: {
            mesh.device_id(d): mesh.device_id(d) == 0 for d in devs})
    srv.start(dispatcher=False)
    orig, fired = srv._execute, []

    def shim(sources):
        if not fired:
            fired.append(1)
            raise elastic.DeviceLostError("injected", device_ids=[1])
        return orig(sources)

    srv._execute = shim
    q = srv.submit(8, k=4)
    clock.advance(0.36)
    srv.pump()
    assert q.outcome == "answered_degraded"
    reasons = [d["reason"] for d in plane._dumps]
    assert "rescue" in reasons
    disp = [p for p in q.trace.phases if p["name"] == "query/dispatch"][0]
    assert disp["attrs"]["rerun"] is True
    assert disp["attrs"]["attempts"] == 2
    srv.drain()


def test_report_section_of_the_plane():
    """The run report's ``serving`` section as the plane gives it:
    disarmed {"enabled": False}; armed, the live section."""
    assert qtrace.report_section() == {"enabled": False}
    qtrace.arm_query_plane(slow_query_ms=5.0)
    sec = qtrace.report_section()
    assert sec["enabled"] is True and sec["slow_query_ms"] == 5.0
    assert set(sec["phase_p99_ms"]) == set(qtrace.DECOMPOSITION_LEGS)


def test_query_trace_cli_writes_a_chrome_trace(tmp_path, capsys):
    """``--query-trace`` arms the plane and exports the query spans."""
    from pagerank_tpu_torch.serve.__main__ import main

    out = tmp_path / "q.json"
    slow = tmp_path / "slow.jsonl"
    assert main(["--serve-smoke", "3", "--scale", "6", "--edge-factor", "4",
                 "--iters", "2", "--max-batch", "2", "--device", "cpu",
                 "--query-trace", str(out), "--slow-query-ms", "0",
                 "--slow-query-log", str(slow)]) == 0
    assert '"unsettled": 0' in capsys.readouterr().out
    doc = json.loads(out.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    assert any(e.get("name") == "query" for e in events)
    recs = [json.loads(ln) for ln in slow.read_text().splitlines()]
    assert len(recs) == 3 and set(recs[0]) == set(qtrace.SLOW_QUERY_KEYS)
