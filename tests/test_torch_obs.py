"""The port's run report, live exporter, stall watchdog, tracer and
profiler (``pagerank_tpu_torch/obs/``) and their CLI flags, held
against the JAX package where it has the same output: the exported
Prometheus and OpenMetrics text equal to the JAX renderers' for the
same registry contents, the run report's sections the JAX report's,
the watchdog's fire and interrupt in virtual time, zero calls when
off, the CLI's observability flags in one run, the stall watchdog's
``raise`` ending a run as the JAX CLI's does, the slice-6 refusals,
and the daemon's exporter and drain report."""

import json
import math
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from pagerank_tpu import cli as jax_cli
from pagerank_tpu.obs import live as jax_live
from pagerank_tpu.obs import metrics as jax_metrics
from pagerank_tpu.obs import report as jax_report
from pagerank_tpu_torch import PageRankConfig, build_graph, cli, obs
from pagerank_tpu_torch.engines.torch_engine import TorchEngine
from pagerank_tpu_torch.obs import live, metrics, report
from pagerank_tpu_torch.obs import trace as obs_trace
from pagerank_tpu_torch.testing.faults import (DeviceFaultSchedule,
                                               install_device_faults)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.disable_tracing()
    obs.get_registry().reset()
    obs.disarm_watchdog()
    obs.disarm_sampler()
    yield
    obs.disable_tracing()
    obs.get_registry().reset()
    obs.disarm_watchdog()
    obs.disarm_sampler()


def _fill(reg):
    """The same operations on a registry of either package."""
    reg.counter("s3.request.retries", "retries\nof S3").inc(3)
    reg.counter("engine.rollbacks").inc()
    reg.gauge("probe.rank_mass", "sum(ranks)").set(float("nan"))
    reg.gauge("solve.l1_delta", "l1").set(1.25e-3)
    reg.gauge("neg.inf").set(float("-inf"))
    reg.gauge("unset.gauge", "never set")
    reg.gauge("flag", "a bool").set(True)
    h = reg.histogram("serve.latency_ms", "latency")
    for v, tid in ((0.5, "a"), (3.0, None), (700.0, "q\"1"), (1e9, "big")):
        h.record(v, trace_id=tid)


@pytest.mark.parametrize("fmt", ["prometheus", "openmetrics"])
def test_rendered_text_equals_the_jax_renderers(fmt):
    mine, theirs = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    _fill(mine)
    _fill(theirs)
    render = getattr(live, f"render_{fmt}")
    jrender = getattr(jax_live, f"render_{fmt}")
    assert render(mine) == jrender(theirs)


def test_exporter_textfile_and_http_scrape(tmp_path):
    reg = metrics.MetricsRegistry()
    _fill(reg)
    path = tmp_path / "m.prom"
    with live.MetricsExporter(textfile=str(path), port=0, registry=reg,
                              format="openmetrics") as ex:
        ex.write_textfile()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ex.port}/metrics", timeout=10) as r:
            body = r.read().decode()
            assert "openmetrics" in r.headers["Content-Type"]
    assert body == path.read_text() == live.render_openmetrics(reg)
    assert body.endswith("# EOF\n")


def test_watchdog_fires_once_an_episode_and_interrupts_on_raise():
    now = [0.0]
    hits = []
    wd = live.StallWatchdog(2.0, action="raise", clock=lambda: now[0],
                            interrupt=lambda: hits.append(now[0]))
    wd.heartbeat(0)
    now[0] = 1.5
    assert not wd.check()
    now[0] = 2.5
    assert wd.check() and not wd.check()
    assert hits == [2.5] and wd.stalls == 1
    wd.heartbeat(1)
    now[0] = 5.0
    assert wd.check() and wd.stalls == 2 and len(hits) == 2
    warn = live.StallWatchdog(1.0, clock=lambda: now[0],
                              interrupt=lambda: hits.append("x"))
    now[0] = 9.0
    assert warn.check() and "x" not in hits
    assert obs.get_registry().snapshot()["counters"]["watchdog.stalls"] == 3


def test_tracer_watchdog_and_sampler_off_make_zero_calls(monkeypatch):
    rng = np.random.default_rng(0)
    g = build_graph(rng.integers(0, 512, 4096), rng.integers(0, 512, 4096),
                    n=512)
    eng = TorchEngine(PageRankConfig(num_iters=4), device="cpu").build(g)

    def boom(*a, **k):
        raise AssertionError("observability machinery touched while off")

    monkeypatch.setattr(obs_trace.NullTracer, "span", boom)
    monkeypatch.setattr(obs_trace.NullTracer, "add_event", boom)
    monkeypatch.setattr(live.StallWatchdog, "heartbeat", boom)
    monkeypatch.setattr(obs.DeviceSampler, "on_step", boom)
    monkeypatch.setattr(obs.DeviceSampler, "sample", boom)
    assert np.isfinite(eng.run()).all()


def test_armed_loop_spans_heartbeats_and_samples():
    rng = np.random.default_rng(1)
    g = build_graph(rng.integers(0, 512, 4096), rng.integers(0, 512, 4096),
                    n=512)
    eng = TorchEngine(PageRankConfig(num_iters=5), device="cpu").build(g)
    tr = obs.enable_tracing()
    wd = obs.arm_watchdog(obs.StallWatchdog(600.0))
    sampler = obs.arm_sampler(obs.DeviceSampler(every=2))
    eng.run()
    assert tr.summary()["solve/step"]["count"] == 5
    assert wd.last_iteration == 4
    assert sampler.samples == 1 + 3  # the arming sample, then 0, 2, 4
    wm = sampler.watermark()
    assert wm["hbm_high_water_bytes"] is None
    assert wm["last"][0]["platform"] == "cpu"


def test_profiler_session_writes_a_trace_and_stops_on_failure(tmp_path):
    import torch

    with obs.profiler_session(str(tmp_path / "p")) as on:
        assert on
        torch.ones(8).sum()
    doc = json.loads((tmp_path / "p" / "trace.json").read_text())
    assert "traceEvents" in doc
    with pytest.raises(RuntimeError, match="boom"):
        with obs.profiler_session(str(tmp_path / "q")):
            raise RuntimeError("boom")
    assert (tmp_path / "q" / "trace.json").exists()
    # a new session starts: the failing one was stopped
    with obs.profiler_session(str(tmp_path / "r")):
        pass
    with obs.profiler_session(None) as on:
        assert not on


def _run_report_of_both(tmp_path):
    argv = ["--synthetic", "rmat:8", "--iters", "4", "--probe-every", "2",
            "--log-every", "0"]
    mine = tmp_path / "mine.json"
    cli.run(argv + ["--device", "cpu", "--run-report", str(mine)])
    theirs = tmp_path / "theirs.json"
    assert jax_cli.main(argv + ["--run-report", str(theirs)]) == 0
    return json.loads(mine.read_text()), json.loads(theirs.read_text())


def test_report_sections_are_the_jax_reports(tmp_path):
    mine, theirs = _run_report_of_both(tmp_path)
    assert report.REPORT_KEYS == jax_report.REPORT_KEYS
    assert set(theirs) <= set(mine)
    assert set(mine) - set(theirs) == {"layout"}
    for key in ("summary", "robustness", "graph", "serving", "job"):
        assert set(mine[key]) == set(theirs[key]), key
    assert [sorted(p) for p in mine["probes"]] == \
        [sorted(p) for p in theirs["probes"]]
    assert [sorted(r) for r in mine["iterations"]] == \
        [sorted(r) for r in theirs["iterations"]]
    assert {"torch_version", "cuda_version", "device_kind",
            "power_limit", "git_rev"} <= set(mine["environment"])
    assert mine["costs"]["step"]["model"] == "k1_cost"
    assert mine["costs"]["step"]["bytes_per_edge"] > 0
    # the views work on the port's reports
    assert "torch" in report.render_report(mine)
    assert "environment: identical" in report.diff_reports(mine, mine)


def test_cli_full_observability_run(tmp_path):
    t, r, m = (str(tmp_path / x) for x in ("t.json", "r.json", "m.prom"))
    hist = str(tmp_path / "h.jsonl")
    argv = ["--synthetic", "rmat:9", "--device", "cpu", "--iters", "4",
            "--log-every", "0", "--probe-every", "1", "--probe-topk", "8",
            "--trace", t, "--run-report", r, "--metrics-textfile", m,
            "--metrics-port", "0", "--device-sample-every", "1",
            "--graph-profile", "--history", hist, "--stall-timeout", "600",
            "--stall-action", "warn", "--preflight",
            "--profile-dir", str(tmp_path / "prof")]
    s = cli.run(argv)
    rep = json.loads(Path(r).read_text())
    assert rep == json.loads(json.dumps(s["report"]))
    assert len(rep["probes"]) == 4 and not rep["failed"]
    assert rep["graph"]["profile"]["num_edges"] == s["graph"].num_edges
    assert rep["devices"]["samples"] >= 5
    chrome = json.loads(Path(t).read_text())
    steps = [e for e in chrome["traceEvents"] if e.get("name") ==
             "solve/step" and e.get("ph") == "X"]
    assert len(steps) == 4
    assert any(e.get("name") == "profile" for e in chrome["traceEvents"])
    prom = Path(m).read_text()
    assert "pagerank_probe_points 4" in prom
    assert "pagerank_solve_iteration 4" in prom
    assert (tmp_path / "prof" / "trace.json").exists()
    recs = [json.loads(x) for x in Path(hist).read_text().splitlines()]
    assert list(recs[0]["legs"]) == ["flat_f32"]
    assert recs[0]["env"]["device_kind"] == "cpu"
    # a second run reads the ledger's baseline for its leg and card
    s2 = cli.run(argv[:6] + ["--history", hist, "--metrics-textfile", m])
    assert "pagerank_history_vs_baseline_pct" in Path(m).read_text()
    assert s2["report"] is None
    assert obs.get_watchdog() is None and obs.get_sampler() is None


def test_cli_preflight_refuses_before_any_graph_work(capsys, monkeypatch):
    from pagerank_tpu_torch.ops import device_build

    def boom(*a, **k):
        raise AssertionError("graph work ran after a refused preflight")

    monkeypatch.setattr(cli, "load_graph", boom)
    monkeypatch.setattr(device_build, "rmat_edges_device", boom)
    with pytest.raises(SystemExit) as e:
        cli.run(["--synthetic", "rmat:29", "--device", "cpu",
                 "--device-build", "--preflight"])
    assert e.value.code == 3
    assert "DOES NOT FIT" in capsys.readouterr().err


@pytest.mark.parametrize("action", ["raise", "warn"])
def test_cli_stall_ends_the_run_as_the_jax_cli(tmp_path, capsys,
                                               monkeypatch, action):
    """A step stalled by ``testing/faults.py`` (a 3 s delay at iteration
    1) under a 1 s watchdog: ``raise`` drains and exits 75 with the JAX
    CLI's diagnostic lines; ``warn`` logs and finishes. (On a loaded
    host the watchdog may also fire on a slow early step; either way
    the run ends as asserted.)"""
    build = TorchEngine.build

    def faulty_build(self, graph):
        build(self, graph)
        install_device_faults(self, DeviceFaultSchedule(delay={1: (0, 3.0)}))
        return self

    monkeypatch.setattr(TorchEngine, "build", faulty_build)
    r = str(tmp_path / "r.json")
    rc = cli.main(["--synthetic", "rmat:8", "--device", "cpu", "--iters",
                   "4", "--log-every", "0", "--stall-timeout", "1",
                   "--stall-action", action, "--run-report", r])
    err = capsys.readouterr().err
    assert "STALL WATCHDOG: no solve progress for" in err
    rep = json.loads(Path(r).read_text())
    assert rep["metrics"]["counters"]["watchdog.stalls"] >= 1
    if action == "raise":
        assert rc == 75
        assert "interrupted by SIGINT; drained in" in err
        assert rep["interrupted"] and not rep["failed"]
    else:
        assert rc == 0 and not rep["interrupted"]
        assert len(rep["iterations"]) == 4


def test_cli_failure_writes_a_failure_marked_report(tmp_path, monkeypatch):
    def bad_step(self):
        raise RuntimeError("device fell over")

    monkeypatch.setattr(TorchEngine, "step", bad_step)
    r, t = str(tmp_path / "r.json"), str(tmp_path / "t.jsonl")
    with pytest.raises(RuntimeError, match="fell over"):
        cli.run(["--synthetic", "rmat:7", "--device", "cpu",
                 "--run-report", r, "--trace", t])
    rep = json.loads(Path(r).read_text())
    assert rep["failed"] and "fell over" in rep["error"]
    assert rep["devices"]["samples"] >= 1
    assert Path(t).read_text().strip()
    assert not obs.get_tracer().enabled


def test_daemon_exports_metrics_and_writes_its_report_on_drain(tmp_path):
    """The daemon as a process: /metrics scraped once in OpenMetrics, a
    query answered, then SIGTERM: exit 75 and the run report with the
    serving section."""
    rep = tmp_path / "serve.json"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pagerank_tpu_torch.serve", "--device", "cpu",
         "--scale", "6", "--iters", "3", "--port", "0", "--metrics-port",
         "0", "--metrics-format", "openmetrics", "--run-report", str(rep)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path))
    try:
        line = proc.stdout.readline()
        assert "serving PPR on" in line, proc.stderr.read()
        port = int(line.split("127.0.0.1:")[1].split("/")[0])
        mport = int(line.split("metrics :")[1].split(")")[0])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/ppr?source=3", timeout=30) as r:
            assert json.loads(r.read())["source"] == 3
        with urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/metrics", timeout=30) as r:
            body = r.read().decode()
        assert body.endswith("# EOF\n") and "pagerank_serve_" in body
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 75
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    doc = json.loads(rep.read_text())
    assert set(report.REPORT_KEYS) <= set(doc)
    assert doc["serving"]["enabled"]
    assert math.isfinite(doc["created_unix"])
