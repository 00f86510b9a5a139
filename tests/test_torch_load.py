"""The port's serving chaos harness (``pagerank_tpu_torch/testing/load.py``)
on the CPU: the replay of ``tests/test_serving.py:208-237`` over eight
injected device descriptors, and ``chaos_run(seed=7)`` against the JAX
harness's ``chaos_run(seed=7)`` on the 8 fake CPU devices of
``tests/conftest.py``. Every admission decision is a function of the
seed and the virtual clock, so the two harnesses must agree on the
admission log, the outcome counts and the device count; the served
scores agree to f32 rounding (both default configs are f32 over f32
sums: ``rtol`` 1e-5, as ``tests/test_torch_ppr.py::test_topk_ordering_
f32``)."""

import json

import numpy as np
import pytest

from pagerank_tpu.serving import daemon as jax_daemon
from pagerank_tpu.testing import load as jax_load

from pagerank_tpu_torch import PageRankConfig, build_graph
from pagerank_tpu_torch.engines.ppr import PprTorchEngine
from pagerank_tpu_torch.serving import PprServer, ServeConfig
from pagerank_tpu_torch.serving import daemon as torch_daemon
from pagerank_tpu_torch.testing import load
from pagerank_tpu_torch.testing.faults import DeviceFaultSchedule
from pagerank_tpu_torch.testing.schedules import VirtualClock
from pagerank_tpu_torch.utils import synth


@pytest.fixture(scope="module")
def graph():
    src, dst = synth.rmat_edges(8, edge_factor=8, seed=3)
    return build_graph(src, dst, n=256)


def serve_config(**kw):
    base = dict(max_batch=4, queue_depth=16, deadline_ms=400.0, topk=8,
                wall_alpha=0.0, wall_initial_s=0.05, cache_capacity=64,
                batch_margin_s=0.01)
    base.update(kw)
    return ServeConfig(**base)


def test_the_descriptors_are_the_jax_harness_devices():
    import jax

    assert [d.index for d in load.DESCRIPTORS] == [
        d.id for d in jax.devices()]


def test_chaos_load_replays_bit_identical(graph):
    """``tests/test_serving.py:208-237`` over the descriptors: same
    digest and admission log twice, nothing unsettled, degraded to 7."""
    cfg = PageRankConfig(num_iters=5)

    def one_run():
        clock = VirtualClock()
        sched = DeviceFaultSchedule(seed=7, kill={2: 5})
        srv = PprServer(graph, config=cfg, serve_config=serve_config(),
                        devices=load.DESCRIPTORS,
                        engine_factory=lambda devs: PprTorchEngine(
                            cfg, device="cpu").build(graph),
                        liveness_probe=sched.liveness_probe, clock=clock)
        srv.start(dispatcher=False)
        load.install_serve_faults(srv, sched, clock=clock, service_s=0.05)
        plan = load.QueryLoadGenerator(seed=7, num_queries=24, n=256,
                                       mean_gap_s=0.02, k=8).plan()
        return load.run_serve_load(srv, clock, plan, drain_at=20,
                                   drain_deadline_s=1.0)

    r1, r2 = one_run(), one_run()
    assert r1["unsettled"] == 0 and r2["unsettled"] == 0
    assert r1["results_digest"] == r2["results_digest"]
    assert r1["admission_log"] == r2["admission_log"]
    assert r1["degraded"] and r1["device_count"] == 7
    assert r1["outcomes"].get("rejected_draining", 0) >= 1
    answered = sum(v for k, v in r1["outcomes"].items()
                   if k.startswith("answered"))
    assert answered >= 1


def _answers(monkeypatch, server_cls, run):
    """``run()``'s report and each answered query's scores, by qid
    (every handle ``server_cls.submit`` returned)."""
    handles = []
    submit = server_cls.submit

    def recording(self, *a, **kw):
        q = submit(self, *a, **kw)
        handles.append(q)
        return q

    monkeypatch.setattr(server_cls, "submit", recording)
    rep = run()
    monkeypatch.setattr(server_cls, "submit", submit)
    return rep, {q.qid: q.result(timeout=0)[1] for q in handles
                 if (q.outcome or "").startswith("answered")}


def test_chaos_run_matches_the_jax_harness(monkeypatch):
    ours, got = _answers(monkeypatch, torch_daemon.PprServer,
                         lambda: load.chaos_run(seed=7))
    theirs, want = _answers(monkeypatch, jax_daemon.PprServer,
                            lambda: jax_load.chaos_run(seed=7))
    assert ours["unsettled"] == theirs["unsettled"] == 0
    assert [list(e) for e in ours["admission_log"]] == [
        list(e) for e in theirs["admission_log"]]
    assert ours["outcomes"] == theirs["outcomes"]
    assert ours["device_count"] == theirs["device_count"] == 7
    assert ours["degraded"] and theirs["degraded"]
    assert sorted(got) == sorted(want) and got
    for qid in got:
        np.testing.assert_allclose(got[qid], want[qid], rtol=1e-5, atol=0)
    assert load.chaos_run(seed=7)["results_digest"] == ours[
        "results_digest"]


def test_main_prints_the_report_and_exports_the_trace(tmp_path, capsys):
    trace = tmp_path / "t.json"
    assert load.main(["--iters", "3", "--trace", str(trace)]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["unsettled"] == 0 and rep["queries"] == 40
    assert rep["device_count"] == 7 and "trace_digest" in rep
    assert set(rep["phase_p99_ms"]) >= {"batch_wait", "dispatch"}
    assert json.loads(trace.read_text())["traceEvents"]
