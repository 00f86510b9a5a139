"""The port's serving layer on the CPU (tests/test_serving.py:55-255
against the port's classes, under the JAX package's ``VirtualClock``):
admission, the result cache, the daemon in pump and thread mode, the
rescue path through an injected liveness probe and engine factory, the
deadline-bounded dispatch, the HTTP ingress, ``python -m
pagerank_tpu_torch.serve --serve-smoke`` and its refusals, and the
daemon's answers against ``PprTorchEngine.run``."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pagerank_tpu.testing.schedules import VirtualClock

from pagerank_tpu_torch import PageRankConfig, build_graph, jobs, serve
from pagerank_tpu_torch.engines.ppr import PprTorchEngine
from pagerank_tpu_torch.exitcodes import ExitCode, hard_exit_code
from pagerank_tpu_torch.parallel import elastic, mesh
from pagerank_tpu_torch.serving import (AdmissionQueue, BatchWallModel,
                                        Draining, Overloaded, PendingQuery,
                                        PprServer, QueryDeadlineExceeded,
                                        QueryIngress, ResultCache,
                                        ServeConfig, ServeRejected)
from pagerank_tpu_torch.utils import synth

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def graph():
    src, dst = synth.rmat_edges(8, edge_factor=8, seed=3)
    return build_graph(src, dst, n=256)


def frozen_wall(wall_s):
    return BatchWallModel(initial_s=wall_s, alpha=0.0)


def pending(clock, qid=0, source=0, k=4, deadline_s=10.0):
    now = clock()
    return PendingQuery(qid=qid, source=source, k=k,
                        deadline=now + deadline_s, t_submit=now)


def serve_config(**kw):
    base = dict(max_batch=4, queue_depth=16, deadline_ms=400.0, topk=8,
                wall_alpha=0.0, wall_initial_s=0.05, cache_capacity=64,
                batch_margin_s=0.01)
    base.update(kw)
    return ServeConfig(**base)


def make_server(graph, clock, liveness_probe=None, devices=(CPU,),
                engine_factory=None, start=True, **sc_kw):
    srv = PprServer(graph, config=PageRankConfig(num_iters=5),
                    serve_config=serve_config(**sc_kw), devices=devices,
                    liveness_probe=liveness_probe,
                    engine_factory=engine_factory, clock=clock)
    if start:
        srv.start(dispatcher=False)
    return srv


# -- admission / wall model -------------------------------------------------


def test_wall_model_alpha_zero_freezes():
    m = frozen_wall(0.1)
    m.observe(5.0)
    assert m.estimate() == 0.1
    m2 = BatchWallModel(initial_s=0.1, alpha=0.5)
    m2.observe(0.3)
    assert m2.estimate() == pytest.approx(0.2)


def test_admission_rejects_when_queue_full():
    clock = VirtualClock()
    q = AdmissionQueue(max_batch=2, queue_depth=2,
                       wall_model=frozen_wall(0.01), clock=clock)
    q.offer(pending(clock, qid=0))
    q.offer(pending(clock, qid=1))
    with pytest.raises(Overloaded) as e:
        q.offer(pending(clock, qid=2))
    assert "queue full" in str(e.value)
    assert e.value.retry_after_s > 0
    assert e.value.outcome == "shed_overload"


def test_admission_predictive_shed():
    clock = VirtualClock()
    q = AdmissionQueue(max_batch=1, queue_depth=64,
                       wall_model=frozen_wall(0.2), clock=clock)
    q.offer(pending(clock, qid=0, deadline_s=10.0))
    with pytest.raises(Overloaded) as e:
        q.offer(pending(clock, qid=1, deadline_s=0.3))
    assert e.value.retry_after_s >= 0.1 - 1e-9
    q2 = AdmissionQueue(max_batch=1, queue_depth=64,
                        wall_model=frozen_wall(0.2), clock=clock)
    q2.offer(pending(clock, qid=0, deadline_s=0.3))


def test_batch_closes_at_max_size_or_deadline_margin():
    clock = VirtualClock()
    q = AdmissionQueue(max_batch=2, queue_depth=16, batch_margin_s=0.01,
                       wall_model=frozen_wall(0.05), clock=clock)
    assert q.try_close_batch() is None
    q.offer(pending(clock, qid=0))
    q.offer(pending(clock, qid=1))
    batch = q.try_close_batch()
    assert [p.qid for p in batch] == [0, 1]
    q.batch_done()
    q.offer(pending(clock, qid=2, deadline_s=1.0))
    assert q.try_close_batch() is None
    clock.advance(0.95)
    batch = q.try_close_batch()
    assert [p.qid for p in batch] == [2]


def test_drain_closes_admission_and_flushes_typed():
    clock = VirtualClock()
    q = AdmissionQueue(max_batch=4, queue_depth=16,
                       wall_model=frozen_wall(0.05), clock=clock)
    q.offer(pending(clock, qid=0))
    q.offer(pending(clock, qid=1))
    q.close()
    with pytest.raises(Draining):
        q.offer(pending(clock, qid=2))
    batch = q.try_close_batch()
    assert [p.qid for p in batch] == [0, 1]
    q.batch_done()
    p3 = pending(clock, qid=3)
    q._queue.append(p3)  # stage a query the drain deadline strands
    assert q.flush_rejected(lambda _q: Draining("drain deadline")) == 1
    assert p3.outcome == "rejected_draining"


# -- result cache -----------------------------------------------------------


def test_result_cache_lru_eviction_and_disable():
    c = ResultCache(capacity=2)
    k1, k2, k3 = [ResultCache.key("fp", s, ("p",), 4) for s in (1, 2, 3)]
    c.put(k1, np.arange(4), np.ones(4))
    c.put(k2, np.arange(4), np.ones(4))
    assert c.get(k1) is not None
    c.put(k3, np.arange(4), np.ones(4))
    assert c.get(k2) is None
    assert c.get(k1) is not None and c.get(k3) is not None
    off = ResultCache(capacity=0)
    off.put(k1, np.arange(4), np.ones(4))
    assert off.get(k1) is None and len(off) == 0


# -- daemon (pump mode, virtual clock) --------------------------------------


def test_server_answers_and_serves_repeat_from_cache(graph):
    clock = VirtualClock()
    srv = make_server(graph, clock)
    assert srv.warmup_seconds is not None and srv.device_ids() == [0]
    assert srv._engine.layout_info()["width"] == 4  # bound at max_batch
    q1 = srv.submit(7, k=4)
    clock.advance(0.36)  # into the close margin, before expiry
    assert srv.pump() == 1
    assert q1.outcome == "answered"
    ids1, scores1 = q1.result(timeout=0)
    assert ids1.shape == (4,) and scores1.shape == (4,)
    q2 = srv.submit(7, k=4)
    assert q2.outcome == "answered_cache"
    ids2, scores2 = q2.result(timeout=0)
    np.testing.assert_array_equal(ids1, ids2)
    np.testing.assert_array_equal(scores1, scores2)
    assert len(srv.batch_walls) == 1
    srv.drain()


def test_server_answers_equal_the_engine_run(graph):
    """What the daemon answers is ``PprTorchEngine.run`` on the same
    sources, bit for bit, whatever the batch-mates (a batch of 4 and
    a batch of 1 here)."""
    clock = VirtualClock()
    srv = make_server(graph, clock, cache_capacity=0)
    sources = [3, 200, 17, 3, 99]
    qs = [srv.submit(s, k=8) for s in sources]
    while srv.pump():
        pass
    clock.advance(0.36)
    srv.pump()
    eng = PprTorchEngine(PageRankConfig(num_iters=5), device="cpu").build(
        graph)
    want = eng.run(np.array(sources), topk=8)
    for i, q in enumerate(qs):
        assert q.outcome == "answered"
        ids, scores = q.result(timeout=0)
        np.testing.assert_array_equal(ids, want.topk_ids[i])
        np.testing.assert_array_equal(scores, want.topk_scores[i])
    srv.drain()


def test_server_dispatches_only_the_live_sources(graph):
    """A batch runs its live queries only: no padding to max_batch (a
    lone query costs one column, not four), and the warm-up binds the
    launchers at max_batch all the same."""
    clock = VirtualClock()
    srv = make_server(graph, clock, cache_capacity=0)
    assert srv._engine.layout_info()["width"] == 4
    widths = []
    orig = srv._execute

    def spy(sources):
        widths.append(len(sources))
        return orig(sources)

    srv._execute = spy
    q = srv.submit(11, k=4)
    clock.advance(0.36)
    assert srv.pump() == 1
    assert q.outcome == "answered"
    qs = [srv.submit(s, k=4) for s in (1, 2, 3, 4, 5)]
    while srv.pump():
        pass
    clock.advance(0.36)
    srv.pump()
    assert widths == [1, 4, 1]
    assert all(x.outcome == "answered" for x in qs)
    assert srv._engine.layout_info()["width"] == 4
    srv.drain()


def test_server_rejects_expired_in_queue_typed(graph):
    clock = VirtualClock()
    srv = make_server(graph, clock, cache_capacity=0)
    q = srv.submit(3, k=4, deadline_s=0.1)
    clock.advance(0.2)
    srv.pump()
    assert q.outcome == "rejected_deadline"
    with pytest.raises(QueryDeadlineExceeded):
        q.result(timeout=0)
    srv.drain()


def test_server_submit_requires_start(graph):
    srv = make_server(graph, VirtualClock(), start=False)
    with pytest.raises(RuntimeError):
        srv.submit(0)
    srv.start(dispatcher=False)
    with pytest.raises(RuntimeError, match="twice"):
        srv.start(dispatcher=False)
    srv.drain()


def test_stuck_dispatch_fails_the_batch_typed(graph):
    """A dispatch past ``dispatch_timeout_s`` (a hung kernel cannot be
    cancelled) is abandoned by ``run_with_deadline``: the batch fails
    with QueryDeadlineExceeded instead of hanging the queue."""
    clock = VirtualClock()
    srv = make_server(graph, clock, dispatch_timeout_s=0.05,
                      cache_capacity=0)
    release = threading.Event()
    orig = srv._execute

    def stuck(sources):
        release.wait(10)
        return orig(sources)

    srv._execute = stuck
    q = srv.submit(5, k=4)
    clock.advance(0.36)
    srv.pump()
    release.set()
    assert q.outcome == "rejected_deadline"
    with pytest.raises(QueryDeadlineExceeded, match="exceeded"):
        q.result(timeout=0)
    srv.drain()


def _kill_first_attempt(srv, lost_ids):
    """Wrap the server's dispatch seam: the first attempt raises
    DeviceLostError naming ``lost_ids``; later ones dispatch."""
    orig = srv._execute
    state = {"fired": False}

    def shim(sources):
        if not state["fired"]:
            state["fired"] = True
            raise elastic.DeviceLostError("injected device loss",
                                          device_ids=lost_ids)
        return orig(sources)

    srv._execute = shim


def test_server_rescues_and_reruns_inflight_batch(graph):
    """Two devices (the injected factory builds a CPU engine over any
    list): device 1 is lost mid-batch; the liveness probe confirms it,
    the engine is rebuilt over device 0 and the batch re-runs."""
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    built = []

    def factory(devs):
        built.append([mesh.device_id(d) for d in devs])
        return PprTorchEngine(PageRankConfig(num_iters=5),
                              device="cpu").build(graph)

    def probe(devs, timeout_s):
        return {mesh.device_id(d): mesh.device_id(d) != 1 for d in devs}

    clock = VirtualClock()
    srv = make_server(graph, clock, liveness_probe=probe, devices=devices,
                      engine_factory=factory, cache_capacity=0)
    _kill_first_attempt(srv, [1])
    q = srv.submit(9, k=4)
    clock.advance(0.36)
    srv.pump()
    assert q.outcome == "answered_degraded"
    assert srv.degraded and srv.device_count == 1
    assert srv.device_ids() == [0] and srv.rescues_done == 1
    assert built == [[0, 1], [0]]
    srv.drain()


def test_device_loss_on_one_card_is_terminal(graph):
    """On one card nothing survives a loss: ``surviving_devices`` raises
    (the JAX daemon's terminal path), and a loss the probe cannot
    confirm re-raises unchanged."""
    clock = VirtualClock()
    srv = make_server(graph, clock, cache_capacity=0,
                      liveness_probe=lambda devs, timeout_s: {0: False})
    _kill_first_attempt(srv, [0])
    srv.submit(9, k=4)
    clock.advance(0.36)
    with pytest.raises(RuntimeError, match="no surviving devices"):
        srv.pump()
    clock2 = VirtualClock()
    srv2 = make_server(graph, clock2, cache_capacity=0,
                       liveness_probe=lambda devs, timeout_s: {0: True})
    _kill_first_attempt(srv2, [])
    srv2.submit(9, k=4)
    clock2.advance(0.36)
    with pytest.raises(elastic.DeviceLostError):
        srv2.pump()


def test_rescue_budget_spent_rejects_typed(graph):
    devices = [torch.device("cuda", i) for i in range(3)]

    def factory(devs):
        return PprTorchEngine(PageRankConfig(num_iters=5),
                              device="cpu").build(graph)

    clock = VirtualClock()
    srv = make_server(graph, clock, devices=devices, engine_factory=factory,
                      liveness_probe=lambda devs, timeout_s: {
                          mesh.device_id(d): False for d in devs[1:]},
                      cache_capacity=0, max_rescues=0)
    _kill_first_attempt(srv, [2])
    q = srv.submit(9, k=4)
    clock.advance(0.36)
    srv.pump()
    assert q.outcome == "rejected"
    with pytest.raises(ServeRejected, match="serving terminal"):
        q.result(timeout=0)
    assert isinstance(srv.fatal, elastic.ElasticExhaustedError)


def test_server_with_two_devices_by_default_factory_names_slice_6(graph):
    srv = make_server(graph, VirtualClock(), devices=[CPU, CPU], start=False)
    with pytest.raises(ValueError, match="slice 6"):
        srv.start(dispatcher=False)


# -- the dispatcher thread and the HTTP ingress ------------------------------


def test_dispatcher_thread_and_http_ingress(graph):
    srv = PprServer(graph, config=PageRankConfig(num_iters=5),
                    serve_config=serve_config(deadline_ms=1000.0),
                    devices=[CPU])
    srv.start()
    eng = PprTorchEngine(PageRankConfig(num_iters=5), device="cpu").build(
        graph)
    try:
        with QueryIngress(srv, port=0) as ing:
            base = f"http://127.0.0.1:{ing.port}"
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                assert r.status == 200
                assert json.load(r) == {"status": "serving", "devices": 1,
                                        "queue_depth": 0}
            bodies = []
            for s in (11, 250, 11):
                with urllib.request.urlopen(
                        f"{base}/ppr?source={s}&k=6", timeout=30) as r:
                    bodies.append(json.load(r))
            want = eng.run(np.array([11, 250]), topk=6)
            for body, i in zip(bodies, (0, 1, 0)):
                assert body["ids"] == want.topk_ids[i].tolist()
                assert body["scores"] == want.topk_scores[i].tolist()
            assert bodies[0]["outcome"] == "answered"
            assert bodies[2]["outcome"] == "answered_cache"
            assert json.dumps(bodies[2]["ids"]) == json.dumps(bodies[0]["ids"])
            assert json.dumps(bodies[2]["scores"]) == json.dumps(
                bodies[0]["scores"])
            for path, code in (("/ppr?source=x", 400), ("/ppr?source=1&k=y",
                                                        400), ("/nope", 404)):
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(base + path, timeout=30)
                assert e.value.code == code
    finally:
        srv.drain()
    assert srv.queue.closed


# -- the entry point ----------------------------------------------------------


def test_serve_cli_smoke_in_process(capsys):
    rc = serve.main(["--serve-smoke", "6", "--scale", "6",
                     "--edge-factor", "4", "--iters", "3",
                     "--topk", "8", "--max-batch", "4", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert '"unsettled": 0' in out
    doc = json.loads(out.strip().splitlines()[-1])
    assert doc["queries"] == 6 and doc["devices"] == 1
    assert set(doc["outcomes"]) <= {"answered", "answered_cache"}
    assert doc["warmup_s"] > 0 and doc["batches"] >= 1
    assert set(doc["batch_wall_ms"]) == {"first", "p50", "p99"}


@pytest.mark.parametrize("extra,slice_no", [
    (["--metrics-port", "0"], "slice 8"),
    (["--metrics-format", "openmetrics"], "slice 8"),
    (["--run-report", "r.json"], "slice 8"),
])
def test_serve_cli_refuses_the_later_slices(capsys, tmp_path, monkeypatch,
                                            extra, slice_no):
    """The exporter and report flags were slice 8's; they are ported
    now, so the daemon takes them and refuses nothing (the serving
    test of ``tests/test_torch_obs.py`` scrapes and drains them)."""
    monkeypatch.chdir(tmp_path)
    assert serve.main(["--serve-smoke", "1", "--scale", "5", "--iters", "2",
                       "--device", "cpu", *extra]) == 0
    assert slice_no not in capsys.readouterr().err


def test_serve_cli_more_devices_or_no_card_exit_2(capsys, monkeypatch):
    assert serve.main(["--serve-smoke", "1", "--scale", "5", "--device",
                       "cpu", "--num-devices", "2"]) == 2
    assert "slice 6" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.main(["--serve-smoke", "1", "--scale", "5"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_serve_parser_is_the_jax_parser_plus_device():
    from pagerank_tpu import serve as jax_serve

    ours = {a.dest for a in serve.build_parser()._actions}
    theirs = {a.dest for a in jax_serve.build_parser()._actions}
    assert ours == theirs | {"device"}


# -- the device-loss plumbing -------------------------------------------------


@pytest.mark.parametrize("msg", [
    "CUDA error: GPU is lost",
    "ell_contrib kernel launch failed: CUDA error 214 (uncorrectable ECC "
    "error encountered)",
    "CUDA error: unspecified launch failure",
    "CUDA error: the launch timed out and was terminated",
    "CUDA error: uncorrectable NVLink error was detected during the "
    "execution",
    "no CUDA-capable device is detected",
    "CUDA-capable device(s) is/are busy or unavailable",
    "GPU has fallen off the bus",
])
def test_looks_like_device_loss_knows_cuda_strings(msg):
    assert elastic.looks_like_device_loss(RuntimeError(msg))


@pytest.mark.parametrize("msg", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA out of memory. Tried to allocate 2.00 GiB",
    "index 5 is out of bounds",
])
def test_looks_like_device_loss_leaves_other_errors(msg):
    assert not elastic.looks_like_device_loss(RuntimeError(msg))


def test_error_types_match_the_jax_package():
    from pagerank_tpu.parallel import elastic as jax_elastic

    for name in ("DeviceLostError", "DeviceQuarantinedError",
                 "ElasticExhaustedError"):
        ours, theirs = getattr(elastic, name), getattr(jax_elastic, name)
        assert [c.__name__ for c in ours.__mro__] == [
            c.__name__ for c in theirs.__mro__]
    e = elastic.ElasticExhaustedError("x", [1, 2], 3)
    assert e.lost_device_ids == (1, 2) and e.rescues == 3
    assert elastic.looks_like_device_loss(elastic.DeviceLostError("x", [0]))
    for msg in ("device lost", "socket closed", "preempted"):
        assert elastic.looks_like_device_loss(RuntimeError(msg)) == \
            jax_elastic.looks_like_device_loss(RuntimeError(msg))


def test_probe_liveness_and_survivors_on_torch_devices():
    assert mesh.probe_liveness([CPU], timeout_s=5) == {0: True}
    assert mesh.probe_liveness([], timeout_s=5, clock=lambda: 0.0) == {}
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert mesh.surviving_devices({1}, devices=two) == [two[0]]
    with pytest.raises(RuntimeError, match="no surviving devices"):
        mesh.surviving_devices({0}, devices=[CPU])


def test_run_with_deadline_returns_raises_and_expires():
    assert mesh.run_with_deadline(lambda: 7, 5.0) == 7
    with pytest.raises(KeyError):
        mesh.run_with_deadline(lambda: {}["x"], 5.0)
    with pytest.raises(mesh.DeadlineExpired):
        mesh.run_with_deadline(lambda: time.sleep(1.0), 0.05)


def test_graceful_drain_first_signal_drains_second_hard_exits():
    handlers, exits = {}, []
    clock = VirtualClock()
    drain = jobs.GracefulDrain(
        deadline_s=3.0, install=lambda s, h: handlers.setdefault(s, h),
        hard_exit=exits.append, clock=clock)
    with drain:
        drain.check("before")
        (sig, h), = list(handlers.items())[:1]
        h(sig, None)
        with pytest.raises(jobs.DrainInterrupt, match=f"signal {sig}"):
            drain.check("loop")
        clock.advance(1.0)
        assert drain.remaining() == pytest.approx(2.0)
        h(sig, None)
    assert exits == [hard_exit_code(sig)]
    assert drain.finish() == pytest.approx(1.0)
    assert int(ExitCode.INTERRUPTED) == 75
