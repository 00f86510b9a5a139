"""The port's elastic solve (``pagerank_tpu_torch/parallel/elastic.py``)
against the JAX package's (``pagerank_tpu/parallel/elastic.py``).

Single-process cases port ``tests/test_elastic.py``: the watchdog's
rescue handshake in virtual time, the health monitor's straggler
telemetry (held against the JAX monitor on the same virtual clock),
poison routed to rollback, the fault schedule as a pure function of its
seed (equal to the JAX schedule's log), the narrow loss markers, the
budget config, the CLI's rescue refusals and its clean one-device
rescue run, the idempotent shim, the warm-start scan abandoned at its
deadline, and the async halo's rotation protocol
(``tests/test_halo_async.py:257-299``).

The group cases run in ONE spawned, rescue-armed gloo group of world 3
(``spawn_group(..., rescue=True)``; the rank side is
``pagerank_tpu_torch/testing/elastic.py``), each case in a group
generation of its own, with the JAX ``ElasticRunner`` on 3 of the 8
fake CPU devices of ``tests/conftest.py`` under the same seeded
schedule. The group runs once a session: the first xdist worker to need
it runs it under a file lock, the others read its files. One CLI case
SIGKILLs a real rank (the second spawn).

Bounds: f64 ``atol 1e-12`` against JAX (``tests/test_sharding.py``);
f32 ranks over f64 sums bit-equal to the port's uninterrupted one-device
run (``test_torch_sharded.py::test_f32_ranks_summed_in_f64_are_bit_equal_
across_forms``: a warm start restores the f32 state exactly); f32 runs
that restart from r0 within 1e-4 normalised L1 of the f64 oracle (the
JAX file's gate).
"""

import contextlib
import fcntl
import json
import os

import numpy as np
import pytest

import pagerank_tpu
from pagerank_tpu import JaxTpuEngine
from pagerank_tpu.obs import live as jax_live
from pagerank_tpu.parallel import elastic as jax_elastic
from pagerank_tpu.testing import faults as jax_faults
from pagerank_tpu.testing import schedules as jax_schedules
from pagerank_tpu.utils.snapshot import Snapshotter as JaxSnapshotter

import pagerank_tpu_torch
from pagerank_tpu_torch import cli
from pagerank_tpu_torch.engines.torch_engine import TorchEngine
from pagerank_tpu_torch.obs import live as obs_live
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.parallel import distributed
from pagerank_tpu_torch.parallel import mesh as mesh_lib
from pagerank_tpu_torch.parallel.elastic import (
    DeviceHealthMonitor, DeviceLostError, ElasticExhaustedError,
    ElasticRunner, looks_like_device_loss)
from pagerank_tpu_torch.testing import schedules
from pagerank_tpu_torch.testing.faults import (DeviceFaultSchedule,
                                               install_device_faults)
from pagerank_tpu_torch.utils.config import PageRankConfig, RobustnessConfig
from pagerank_tpu_torch.utils.snapshot import Snapshotter
from pagerank_tpu_torch.utils.synth import rmat_edges

import torch

SCALE, WORLD = 10, 3
F64 = dict(dtype="float64", accum_dtype="float64")
F32W = dict(dtype="float32", accum_dtype="float64")
F32 = dict(dtype="float32", accum_dtype="float32")
VS = dict(vertex_sharded=True)


def _l1(a, b):
    return float(np.abs(a - b).sum() / np.abs(b).sum())


def _graph(seed=7, n=512, e=4096):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return (pagerank_tpu.build_graph(src, dst, n=n),
            pagerank_tpu_torch.build_graph(src, dst, n=n))


def _oracle(gj, iters):
    cfg = pagerank_tpu.PageRankConfig(num_iters=iters, **F64)
    return pagerank_tpu.ReferenceCpuEngine(cfg).build(gj).run()


@contextlib.contextmanager
def _armed(wd):
    """``wd`` as the process watchdog without its poll thread."""
    prev = obs_live._WATCHDOG
    obs_live._WATCHDOG = wd
    try:
        yield wd
    finally:
        obs_live._WATCHDOG = prev


def _fake_mesh(world=2):
    return mesh_lib.Mesh(group=None, rank=0, world=world,
                         device=torch.device("cpu"))


# -- the watchdog's rescue handshake (virtual time) --------------------------


def test_watchdog_rescue_handshake_virtual_time():
    t = {"now": 0.0}
    fired = []
    wd = obs_live.StallWatchdog(
        5.0, action="rescue", clock=lambda: t["now"],
        sleep=lambda s: None, interrupt=lambda: fired.append(1))
    wd.heartbeat(0)
    t["now"] = 3.0
    assert wd.check() is False
    assert not wd.rescue_requested
    t["now"] = 9.0
    assert wd.check() is True
    assert fired == [1]
    assert wd.rescue_requested
    # No card here: nothing to echo, classified hang (JAX: every fake
    # CPU device answers).
    assert "hang" in wd.last_classification
    assert wd.consume_rescue() is True
    assert wd.consume_rescue() is False
    assert wd.check() is False
    wd.heartbeat(1)
    t["now"] = 20.0
    assert wd.check() is True


def test_watchdog_rejects_unknown_action():
    with pytest.raises(ValueError):
        obs_live.StallWatchdog(1.0, action="reboot")
    assert obs_live.StallWatchdog.ACTIONS == jax_live.StallWatchdog.ACTIONS


class _Wedged:
    """An engine whose run is interrupted (the watchdog's interrupt)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def run(self, **kw):
        raise KeyboardInterrupt


def test_watchdog_fire_hands_off_to_runner_rescue():
    sentinel = np.arange(4.0)

    class Good:
        def __init__(self, members):
            self.mesh = mesh_lib.Mesh(group=None, rank=0, world=len(members),
                                      device=torch.device("cpu"),
                                      members=members)

        def run(self, **kw):
            return sentinel

    wd = obs_live.StallWatchdog(1.0, action="rescue", interrupt=lambda: None)
    wd.rescue_requested = True
    with _armed(wd):
        runner = ElasticRunner(
            _Wedged(_fake_mesh()), Good, snapshotter=None, max_rescues=1,
            liveness=lambda members, t: {m: m != 0 for m in members})
        out = runner.run()
    assert out is sentinel
    assert runner.rescues == 1
    assert runner.lost_device_ids == [0]
    assert runner.engine.mesh.members == (1,)
    assert not wd.rescue_requested  # consumed


def test_watchdog_fire_on_live_mesh_is_not_rescued():
    wd = obs_live.StallWatchdog(1.0, action="rescue", interrupt=lambda: None)
    wd.rescue_requested = True
    with _armed(wd):
        runner = ElasticRunner(
            _Wedged(_fake_mesh()), lambda m: None, snapshotter=None,
            liveness=lambda members, t: {m: True for m in members})
        with pytest.raises(RuntimeError, match="hang, not device loss"):
            runner.run()
    assert runner.rescues == 0


def test_plain_keyboard_interrupt_propagates():
    runner = ElasticRunner(_Wedged(_fake_mesh()), lambda m: None,
                           snapshotter=None)
    with pytest.raises(KeyboardInterrupt):
        runner.run()


def test_watchdog_classifies_the_solve_mesh_only(monkeypatch):
    seen = {}

    def fake_probe(devices=None, timeout_s=2.0):
        seen["devices"] = devices
        return {mesh_lib.device_id(d): True for d in (devices or [])}

    monkeypatch.setattr(mesh_lib, "probe_liveness", fake_probe)
    devs = [torch.device("cpu")]
    wd = obs_live.StallWatchdog(1.0, action="rescue", interrupt=lambda: None,
                                device_source=lambda: devs)
    assert "hang" in wd._classify()
    assert seen["devices"] == devs


def test_the_drain_handler_hands_a_rescue_fire_to_the_runner():
    """Under the CLI the watchdog's interrupt is a SIGINT, which the
    drain handler owns: while a rescue request is pending it raises the
    KeyboardInterrupt of the runner's handshake instead of draining."""
    import signal

    from pagerank_tpu_torch import jobs

    drain = jobs.GracefulDrain(install=lambda s, h: None)
    wd = obs_live.StallWatchdog(1.0, action="rescue", interrupt=lambda: None)
    with _armed(wd):
        wd.rescue_requested = True
        with pytest.raises(KeyboardInterrupt):
            drain._handler(signal.SIGINT, None)
        assert not drain.requested
        wd.rescue_requested = False
        drain._handler(signal.SIGINT, None)
        assert drain.requested


# -- the monitor, the schedule, the markers, the config ----------------------


def test_monitor_straggler_telemetry_matches_jax():
    """The same virtual step walls through both monitors: the same slow
    steps and skew, and the eager 1.0 baseline before any."""
    from pagerank_tpu.obs import metrics as jax_metrics

    obs_metrics.get_registry().reset()
    jax_metrics.get_registry().reset()
    walls = [1.0, 1.0, 1.1, 0.9, 12.0, 1.0, 1.0, 9.0, 1.0]
    got = []
    for mod, reg in ((jax_elastic, jax_metrics), (None, obs_metrics)):
        t = {"now": 0.0}
        cls = (mod.DeviceHealthMonitor if mod is not None
               else DeviceHealthMonitor)
        m = cls(straggler_factor=3.0, warmup_steps=1,
                clock=lambda: t["now"])
        snap = reg.get_registry().snapshot()
        assert snap["gauges"]["elastic.straggler_skew"] == 1.0
        for i, w in enumerate(walls):
            m.begin_step()
            t["now"] += w
            m.end_step(i)
        m.record_device_times(3, {0: 1.0, 1: 1.0, 2: 4.0})
        snap = reg.get_registry().snapshot()
        got.append((m.slow_steps, m.last_skew,
                    snap["counters"]["elastic.slow_steps"],
                    snap["gauges"]["elastic.device_skew"]))
    assert got[0] == got[1]
    assert got[1][0] == 2


def test_schedule_is_a_pure_function_of_the_seed_and_matches_jax():
    devs = list(range(8))
    kw = dict(seed=9, kill_rate=0.2, delay_rate=0.1, flip_rate=0.1,
              max_faults=5)
    a, b = DeviceFaultSchedule(**kw), DeviceFaultSchedule(**kw)
    j = jax_faults.DeviceFaultSchedule(**kw)
    for i in range(30):
        assert a.decide(i, devs) == b.decide(i, devs) == j.decide(i, devs)
    assert a.log == b.log == j.log
    assert a.dead == b.dead == j.dead
    before = set(a.dead)
    for i in range(30):
        for act in a.decide(i, devs):
            assert act[0] != "kill"
    assert a.dead == before
    # Member ids and devices both key the liveness stand-in.
    assert a.liveness_probe(devs) == {d: d not in a.dead for d in devs}


@pytest.mark.parametrize("msg,loss", [
    ("DEVICE_LOST: chip 3", True),
    ("CUDA error: unspecified launch failure", True),
    ("[../third_party/gloo/gloo/transport/tcp/pair.cc:553] Connection "
     "closed by peer [127.0.0.1]:5038", True),
    ("[../third_party/gloo/gloo/transport/tcp/pair.cc:537] Read error "
     "[127.0.0.1]:5038: Connection reset by peer", True),
    ("[../third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:78] Timed "
     "out waiting 4000ms for recv operation to complete", True),
    ("NCCL error in: ProcessGroupNCCL.cpp:1970, remote process exited or "
     "there was a network error, NCCL version 2.21.5 ncclRemoteError: A "
     "call failed possibly due to a network error or a remote process "
     "exiting prematurely.", True),
    ("NCCL communicator was aborted on rank 1.", True),
    ("bad shape", False),
    ("divide by zero", False),
    ("Expected all tensors to be on the same device", False),
    ("Timed out after 30 seconds waiting for clients", False),
])
def test_looks_like_device_loss_is_narrow(msg, loss):
    assert looks_like_device_loss(RuntimeError(msg)) is loss
    assert looks_like_device_loss(DeviceLostError("x", [1]))
    if "DEVICE_LOST" in msg or not loss:
        assert jax_elastic.looks_like_device_loss(RuntimeError(msg)) is loss


def test_an_ordinary_error_propagates_with_no_roll_call(monkeypatch):
    """A backend error that is not a loss leaves the group alone: no
    teardown, no roll call, no rescue; the same object re-raises."""
    calls = []
    monkeypatch.setattr(distributed, "abandon_group",
                        lambda: calls.append("abandon"))
    monkeypatch.setattr(distributed, "roll_call",
                        lambda *a, **k: calls.append("roll") or [])
    err = RuntimeError("Expected all tensors to be on the same device")

    class Failing:
        mesh = mesh_lib.Mesh(group=object(), rank=0, world=1,
                             device=torch.device("cpu"))

        def run(self, **kw):
            raise err

    runner = ElasticRunner(Failing(), lambda m: None)
    with pytest.raises(RuntimeError) as ei:
        runner.run()
    assert ei.value is err
    assert calls == [] and runner.rescues == 0


def test_a_group_of_one_losing_its_device_is_exhausted(monkeypatch):
    """Nothing survives the loss of a group's only member: the runner
    raises ElasticExhaustedError naming it, after tearing the group
    down (the roll call of one decides alone)."""
    calls = []
    monkeypatch.setattr(distributed, "abandon_group",
                        lambda: calls.append("abandon"))

    class Lost:
        mesh = mesh_lib.Mesh(group=object(), rank=0, world=1,
                             device=torch.device("cpu"))

        def run(self, **kw):
            raise DeviceLostError("injected", [0])

    runner = ElasticRunner(Lost(), lambda m: None, max_rescues=3)
    with pytest.raises(ElasticExhaustedError) as ei:
        runner.run()
    assert ei.value.lost_device_ids == (0,) and ei.value.rescues == 0
    assert calls == ["abandon"]


def test_rescue_budget_config_matches_jax():
    from pagerank_tpu.utils.config import RobustnessConfig as JaxRobustness

    for kw in ({}, {"max_rescues": 7}, {"max_rollbacks": 5},
               {"max_rescues": 0, "straggler_factor": 2.5}):
        rb, jr = RobustnessConfig(**kw).validate(), \
            JaxRobustness(**kw).validate()
        assert rb.rescue_budget() == jr.rescue_budget()
        assert rb.straggler_factor == jr.straggler_factor
    for bad in ({"max_rescues": -1}, {"straggler_factor": 1.0}):
        with pytest.raises(ValueError) as a:
            RobustnessConfig(**bad).validate()
        with pytest.raises(ValueError) as b:
            JaxRobustness(**bad).validate()
        assert str(a.value) == str(b.value)


# -- the CLI -----------------------------------------------------------------


@pytest.mark.parametrize("argv,say", [
    (["--device-build"], "incompatible with --device-build"),
    (["--ppr-sources", "0"], "incompatible with --ppr-sources"),
    (["--engine", "cpu"], "requires --engine torch"),
], ids=["device-build", "ppr-sources", "engine-cpu"])
def test_cli_rescue_refusals(argv, say, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--synthetic", "rmat:6", "--device", "cpu",
                  "--stall-action", "rescue", *argv])
    assert e.value.code == 2
    assert say in capsys.readouterr().err


def test_cli_rescue_is_refused_under_torchrun(monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv(distributed.STORE_ENV, raising=False)
    with pytest.raises(SystemExit) as e:
        cli.run(["--synthetic", "rmat:6", "--device", "cpu",
                 "--stall-action", "rescue"])
    assert e.value.code == 2
    assert "torchrun" in capsys.readouterr().err


def test_cli_rescue_at_one_device_is_byte_equal_to_the_plain_run(tmp_path):
    """--stall-action rescue with no faults: the runner drives the plain
    solve to the same bytes (JAX ``test_cli_rescue_path_solves_clean``)."""
    base = ["--synthetic", "rmat:8", "--device", "cpu", "--iters", "5",
            "--log-every", "0"]
    a, b = tmp_path / "a.tsv", tmp_path / "b.tsv"
    out = cli.run(base + ["--snapshot-dir", str(tmp_path / "ca"),
                          "--stall-action", "rescue", "--stall-timeout",
                          "600", "--out", str(a)])
    assert cli.main(base + ["--snapshot-dir", str(tmp_path / "cb"),
                            "--out", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()
    assert out["elastic"]["rescues"] == 0
    assert out["elastic"]["members"] == [0]


def test_a_healthy_rescue_run_exports_the_elastic_baseline(tmp_path):
    """The monitor registers its instruments eagerly (JAX
    ``elastic.py:142-157``): a healthy run under --stall-action rescue
    exports the 1.0 straggler-skew baseline and zero slow steps."""
    prom = tmp_path / "m.prom"
    cli.run(["--synthetic", "rmat:7", "--device", "cpu", "--iters", "3",
             "--log-every", "0", "--stall-action", "rescue",
             "--metrics-textfile", str(prom)])
    got = dict(ln.rsplit(" ", 1) for ln in prom.read_text().splitlines()
               if ln.startswith("pagerank_elastic_"))
    assert {k: float(v) for k, v in got.items()} == {
        "pagerank_elastic_straggler_skew": 1.0,
        "pagerank_elastic_slow_steps": 0.0,
        "pagerank_elastic_mesh_devices": 1.0}


# -- one device ---------------------------------------------------------------


def test_install_device_faults_is_idempotent():
    _, g = _graph()
    cfg = PageRankConfig(num_iters=3, **F32)
    eng = TorchEngine(cfg, device="cpu").build(g)
    sched = DeviceFaultSchedule(seed=1)
    install_device_faults(eng, sched)
    install_device_faults(eng, sched)
    eng.run()
    assert len(sched.log) == 3
    ref = DeviceFaultSchedule(seed=1)
    e2 = TorchEngine(cfg, device="cpu").build(g)
    install_device_faults(e2, ref)
    e2.run()
    assert sched.log == ref.log


def test_poison_routes_to_rollback_not_rescue(tmp_path):
    """A poisoned output is the numeric plane's: rollback inside
    engine.run, the rescue path cold — as the JAX runner does on the
    same schedule."""
    gj, g = _graph()
    iters = 10
    out = []
    for jax_side in (True, False):
        if jax_side:
            eng = JaxTpuEngine(pagerank_tpu.PageRankConfig(
                num_iters=iters, **F32)).build(gj)
            snap = JaxSnapshotter(str(tmp_path / "jax"), gj.fingerprint(),
                                  "reference")
            sched = jax_faults.DeviceFaultSchedule(seed=11, poison=[5])
            jax_faults.install_device_faults(eng, sched)
            runner = jax_elastic.ElasticRunner(
                eng, lambda d: None, snapshotter=snap, max_rescues=1,
                liveness=sched.liveness_probe)
        else:
            eng = TorchEngine(PageRankConfig(num_iters=iters, **F32),
                              device="cpu").build(g)
            snap = Snapshotter(str(tmp_path / "torch"), g.fingerprint(),
                               "reference")
            sched = DeviceFaultSchedule(seed=11, poison=[5])
            install_device_faults(eng, sched)
            runner = ElasticRunner(eng, lambda m: None, snapshotter=snap,
                                   max_rescues=1,
                                   liveness=sched.liveness_probe)
        ranks = runner.run(on_iteration=lambda i, info: snap.save(
            i + 1, runner.engine.ranks()))
        assert runner.rescues == 0
        assert runner.engine.health["rollbacks"] >= 1
        out.append(np.asarray(ranks))
    assert _l1(out[1], out[0]) < 1e-5
    assert _l1(out[1], _oracle(gj, iters)) <= 1e-4


def test_rescue_abandons_blocked_warm_start_scan(tmp_path):
    """A warm-start source that cannot answer must not wedge the rescue:
    past resume_timeout_s the scan is abandoned and the solve restarts
    from r0 on the rebuilt engine (JAX :561). Rank 0's share of a world-2
    mesh built in one process loses member 1; the rebuild is the
    one-device engine."""
    import time as _time

    gj, g = _graph()
    iters = 8
    cfg = PageRankConfig(num_iters=iters, **F32)
    inner = Snapshotter(str(tmp_path), g.fingerprint(), "reference")

    class BlockedSnap:
        fingerprint = inner.fingerprint
        semantics = inner.semantics
        mesh_meta = None

        def load_latest_valid(self, **kw):
            _time.sleep(30)
            return inner.load_latest_valid(**kw)

    sched = DeviceFaultSchedule(seed=5, kill={4: 1})
    eng = TorchEngine(cfg, device="cpu", mesh=_fake_mesh()).build(g)
    install_device_faults(eng, sched)
    runner = ElasticRunner(
        eng, lambda m: TorchEngine(cfg, device="cpu").build(g),
        snapshotter=BlockedSnap(), max_rescues=1, resume_timeout_s=0.2,
        liveness=sched.liveness_probe,
        on_rebuild=lambda e2: install_device_faults(e2, sched))
    t0 = _time.monotonic()
    ranks = runner.run()
    assert _time.monotonic() - t0 < 20
    assert runner.rescues == 1 and runner.restarts == 1
    assert runner.lost_device_ids == [1]
    assert _l1(ranks, _oracle(gj, iters)) <= 1e-4


@pytest.mark.parametrize("case", ["clean", "booby_trap", "deterministic"])
def test_rotation_protocol(case):
    """The async halo's boundary rotation across a state replacement
    (``tests/test_halo_async.py:257-299``): the honest protocol holds its
    invariants under every sampled schedule, the one that skips the
    re-prime records a consumed-lag violation under the same seeds, a
    replay is a pure function of its seed — and every log equals the
    JAX package's."""
    if case == "deterministic":
        runs = [schedules.replay(
            7, lambda s: schedules.rotation_actors(s, rescue_after=2)).log
            for _ in range(2)]
        assert runs[0] == runs[1]
        assert runs[0] == jax_schedules.replay(
            7, lambda s: jax_schedules.rotation_actors(
                s, rescue_after=2)).log
        return
    prime = case == "clean"
    for seed in range(25):
        held = {}
        port = schedules.replay(seed, lambda s: held.update(
            st=schedules.rotation_actors(s, steps=6, rescue_after=3,
                                         prime_on_restore=prime)))
        ref = jax_schedules.replay(seed, lambda s: held.update(
            jx=jax_schedules.rotation_actors(s, steps=6, rescue_after=3,
                                             prime_on_restore=prime)))
        assert port.log == ref.log
        st = held["st"]
        assert st["violations"] == held["jx"]["violations"]
        if prime:
            assert st["violations"] == [], (seed, st["violations"])
            assert st["restores"] == 1
        else:
            assert any(v[1] == "consumed-lag" for v in st["violations"])


# -- one spawned group of world 3 ---------------------------------------------

#: The group's cases (``testing/elastic.py``); the letters are the
#: module docstring's.
CASES = {
    # (a) member 1 killed at iteration 6 of 12, a snapshot every iteration
    "kill64": dict(config=dict(F64, **VS), iters=12,
                   schedule=dict(seed=5, kill={6: 1}), snapshots=True),
    "kill32w": dict(config=dict(F32W, **VS), iters=12,
                    schedule=dict(seed=5, kill={6: 1}), snapshots=True),
    "killpart": dict(config=dict(F32, partition_span=256), iters=12,
                     schedule=dict(seed=5, kill={6: 1}), snapshots=True),
    # (b) member 0, then member 1, on a budget of one rescue
    "exhaust": dict(config=dict(F64, **VS), iters=12, max_rescues=1,
                    schedule=dict(seed=5, kill={3: 0, 7: 1}),
                    snapshots=True),
    # (c) no snapshot: a restart from r0
    "restart": dict(config=dict(F32, **VS), iters=10,
                    schedule=dict(seed=5, kill={4: 1})),
    # (d) a straggler: telemetry only
    "straggler": dict(config=dict(F32, **VS), iters=10, virtual_monitor=True,
                      schedule=dict(seed=3, delay={5: (1, 10.0)})),
    "clean32": dict(config=dict(F32, **VS), iters=10),
    # (e) vs_halo loses member 1
    "halo": dict(config=dict(F32, **VS, halo_exchange=True), iters=12,
                 schedule=dict(seed=5, kill={6: 1}), snapshots=True),
    "bounded": dict(config=dict(F64, **VS, vs_bounded=True), iters=12,
                    schedule=dict(seed=5, kill={6: 1}), snapshots=True),
    # (f) a sticky sign flip on member 2, checked every step
    "flip": dict(config=dict(F64, **VS, sdc_check_every=1), iters=10,
                 schedule=dict(seed=5, flip={5: (2, "sign")},
                               sticky_flips=[5]),
                 snapshots=True),
    # (g) two same-seed chaos runs on the async halo form
    "chaos_a": dict(config=dict(F32, **VS, halo_exchange=True,
                                halo_async=True, halo_async_min_gain=0.0),
                    iters=12, snapshots=True,
                    schedule=dict(seed=23, kill={7: 2}, delay={3: (0, 0.0)},
                                  poison=[5])),
}
CASES["chaos_b"] = CASES["chaos_a"]


def _shared_root(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / "torch_elastic"
    root.mkdir(exist_ok=True)
    return root


@contextlib.contextmanager
def _locked(path):
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@pytest.fixture(scope="module")
def edges():
    return rmat_edges(SCALE, edge_factor=8, seed=1)


@pytest.fixture(scope="module")
def graphs(edges):
    src, dst = edges
    n = 1 << SCALE
    return (pagerank_tpu.build_graph(src, dst, n=n),
            pagerank_tpu_torch.build_graph(src, dst, n=n))


@pytest.fixture(scope="module")
def group(tmp_path_factory, edges):
    root = _shared_root(tmp_path_factory)
    d = root / "world3"
    with _locked(root / "world3.lock"):
        if not (d / "done").exists():
            d.mkdir(exist_ok=True)
            src, dst = edges
            np.savez(d / "edges.npz", src=src, dst=dst, n=1 << SCALE)
            cases = [dict(name=k, **v) for k, v in CASES.items()]
            codes = distributed.spawn_group(
                "pagerank_tpu_torch.testing.elastic:run_cases", WORLD,
                dict(edges=str(d / "edges.npz"), out=str(d), device="cpu",
                     cases=cases),
                str(d), backend="gloo", timeout_s=60.0, deadline_s=180.0,
                rescue=True)
            assert list(codes) == [0] * WORLD, f"rank exit codes {codes}"
            (d / "done").write_text("")
    res = {}
    for name in CASES:
        res[name] = {m: dict(np.load(d / f"{name}.m{m}.npz"))
                     for m in range(WORLD)}
    res["dir"] = d
    return res


def _survivors(res, name):
    return {m: r for m, r in res[name].items() if str(r["status"]) == "ok"}


_JAX = {}


def _jax_runner(gj, config, iters, schedule, tmp, max_rescues=2,
                snapshots=True):
    """The JAX ElasticRunner on 3 fake devices under ``schedule`` (the
    shim re-installed on every rebuilt engine, the schedule's liveness
    probe, a snapshot every iteration): (ranks or the exhaustion error,
    runner)."""
    cfg = pagerank_tpu.PageRankConfig(num_iters=iters, num_devices=WORLD,
                                      **config)
    sched = jax_faults.DeviceFaultSchedule(**schedule)
    eng = JaxTpuEngine(cfg).build(gj)
    snap = (JaxSnapshotter(str(tmp), gj.fingerprint(), "reference")
            if snapshots else None)
    jax_faults.install_device_faults(eng, sched)

    def factory(devs):
        return JaxTpuEngine(cfg.replace(num_devices=len(devs)),
                            devices=devs).build(gj)

    runner = jax_elastic.ElasticRunner(
        eng, factory, snapshotter=snap, max_rescues=max_rescues,
        liveness=sched.liveness_probe,
        on_rebuild=lambda e2: jax_faults.install_device_faults(e2, sched))
    try:
        out = runner.run(on_iteration=(
            (lambda i, info: snap.save(i + 1, runner.engine.ranks()))
            if snap is not None else None))
    except jax_elastic.ElasticExhaustedError as e:
        out = e
    return out, runner


def test_a_kill_regroups_the_survivors_and_matches_jax(group, graphs,
                                                       tmp_path):
    """(a) Member 1 dies at iteration 6: every survivor rescues once onto
    members [0, 2], member 1 leaves, the later snapshots name the
    degraded mesh, and the f64 ranks are JAX's rescued ranks (atol
    1e-12)."""
    res = group
    surv = _survivors(res, "kill64")
    assert sorted(surv) == [0, 2]
    assert str(res["kill64"][1]["status"]) == "left"
    for m, r in surv.items():
        assert int(r["rescues"]) == 1 and list(r["lost"]) == [1]
        assert list(r["members"]) == [0, 2]
    np.testing.assert_array_equal(surv[0]["ranks"], surv[2]["ranks"])
    meta = json.loads(str(surv[0]["snap_meta"]))
    assert meta["num_devices"] == 2 and meta["device_ids"] == [0, 2]
    assert list(surv[0]["snap_iterations"]) == list(range(1, 13))
    walls = json.loads(str(surv[0]["walls"]))[0]
    assert walls["world_before"] == 3 and walls["world_after"] == 2
    assert walls["resumed_iteration"] == 6
    for part in ("roll_call", "regroup", "rebuild", "warm_start"):
        assert walls[part] >= 0.0
    want, jr = _jax_runner(graphs[0], dict(F64, **VS), 12,
                           CASES["kill64"]["schedule"], tmp_path)
    assert jr.rescues == 1 and jr.lost_device_ids == [1]
    np.testing.assert_allclose(surv[0]["ranks"], want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name,config", [
    ("kill32w", dict(F32W, **VS)),
    ("killpart", dict(F32, partition_span=256)),
], ids=["vertex_sharded_f32w", "edge_sharded_partitioned"])
def test_a_rescued_f32_run_equals_the_uninterrupted_run(group, graphs, name,
                                                        config):
    """(a) The warm start restores the f32 state exactly: f32 ranks over
    f64 sums are the port's uninterrupted one-device run, bit for bit;
    the edge-sharded partitioned form (K2's path) holds the f32 gate."""
    surv = _survivors(group, name)
    assert sorted(surv) == [0, 2]
    got = surv[0]["ranks"]
    single = TorchEngine(PageRankConfig(num_iters=12, **config),
                         device="cpu").build(graphs[1]).run()
    if config["accum_dtype"] == "float64":
        np.testing.assert_array_equal(got, single)
    else:
        assert _l1(got, single) < 1e-5
    assert _l1(got, _oracle(graphs[0], 12)) < 1e-4


def test_b_a_spent_budget_is_exhausted_on_every_survivor(group, graphs,
                                                         tmp_path):
    """(b) Member 0 dies at iteration 3 (rescue onto [1, 2]: member 1 is
    the new rank 0 and writes the snapshots), then member 1 at 7 on a
    budget of one: the remaining processes raise ElasticExhaustedError
    naming {0, 1}, as the JAX runner does."""
    res = group["exhaust"]
    assert str(res[0]["status"]) == "left"
    for m in (1, 2):
        assert str(res[m]["status"]) == "exhausted"
        assert set(res[m]["lost"]) == {0, 1}
        assert int(res[m]["rescues"]) == 1
    snap = Snapshotter(str(group["dir"] / "exhaust"),
                       graphs[1].fingerprint(), "reference")
    assert snap.iterations() == list(range(1, 8))
    _, meta = snap.load(7)
    assert meta["mesh"]["device_ids"] == [1, 2]
    _, meta = snap.load(3)
    assert meta["mesh"]["device_ids"] == [0, 1, 2]
    err, jr = _jax_runner(graphs[0], dict(F64, **VS), 12,
                          CASES["exhaust"]["schedule"], tmp_path,
                          max_rescues=1)
    assert isinstance(err, jax_elastic.ElasticExhaustedError)
    assert set(err.lost_device_ids) == {0, 1} and err.rescues == 1


def test_c_no_snapshot_restarts_from_r0(group, graphs):
    surv = _survivors(group, "restart")
    assert sorted(surv) == [0, 2]
    for r in surv.values():
        assert int(r["rescues"]) == 1 and int(r["restarts"]) == 1
    assert _l1(surv[0]["ranks"], _oracle(graphs[0], 10)) <= 1e-4


def test_d_a_straggler_is_telemetry_not_a_rescue(group):
    res = group["straggler"]
    for m in range(WORLD):
        assert str(res[m]["status"]) == "ok"
        assert int(res[m]["rescues"]) == 0
        assert int(res[m]["slow_steps"]) >= 1
        assert list(res[m]["members"]) == [0, 1, 2]
        np.testing.assert_array_equal(res[m]["ranks"],
                                      group["clean32"][m]["ranks"])


def test_e_the_rescued_halo_plan_is_a_fresh_world_2_plan(group, graphs):
    """(e) ``tests/test_elastic.py:611-652``: the rescued vs_halo engine's
    plan equals a fresh build's at the surviving world, summary and
    tables; vs_bounded is dealt again and finishes at the f64 bound."""
    surv = _survivors(group, "halo")
    assert sorted(surv) == [0, 2]
    plan = json.loads(str(surv[0]["plan"]))
    assert plan["ndev"] == 2 and plan["n_vs"] % (128 * 2) == 0
    cfg = PageRankConfig(num_iters=12, num_devices=2, **F32, **VS,
                         halo_exchange=True)
    fresh = TorchEngine(cfg, device="cpu", mesh=mesh_lib.Mesh(
        group=None, rank=0, world=2, device=torch.device("cpu"))).build(
        graphs[1])._halo_plan
    assert plan["summary"] == json.loads(json.dumps(fresh.summary()))
    for key in ("send_idx", "recv_ids", "wsend_start", "wrecv_start"):
        assert plan[key] == [a.tolist() for a in getattr(fresh, key)]
    assert _l1(surv[0]["ranks"], _oracle(graphs[0], 12)) <= 1e-4
    bounded = _survivors(group, "bounded")
    assert sorted(bounded) == [0, 2]
    np.testing.assert_allclose(bounded[0]["ranks"], _oracle(graphs[0], 12),
                               rtol=0, atol=1e-12)


def test_f_a_sticky_flip_quarantines_its_member(group, graphs, tmp_path):
    """(f) A sticky sign flip on member 2, checked every step: every rank
    convicts member 2, it leaves, the survivors record the quarantine
    and write it into the snapshots' mesh metadata, and the ranks are
    the JAX runner's under the same schedule."""
    res = group["flip"]
    assert str(res[2]["status"]) == "left"
    surv = _survivors(group, "flip")
    assert sorted(surv) == [0, 1]
    for r in surv.values():
        assert list(r["quarantined"]) == [2]
        assert list(r["members"]) == [0, 1]
    meta = json.loads(str(surv[0]["snap_meta"]))
    assert meta["quarantined_devices"] == [2]
    assert meta["device_ids"] == [0, 1]
    from pagerank_tpu import sdc as jax_sdc

    jax_sdc.reset()
    want, jr = _jax_runner(graphs[0], dict(F64, **VS, sdc_check_every=1), 10,
                           CASES["flip"]["schedule"], tmp_path)
    assert jr.quarantined_device_ids == [2]
    np.testing.assert_allclose(surv[0]["ranks"], want, rtol=0, atol=1e-12)


def test_g_same_seed_chaos_is_bit_for_bit(group):
    """(g) Two same-seed chaos runs (a kill, a delay and a poisoned
    output) on the async halo form: equal fault logs, bit-equal ranks."""
    a, b = _survivors(group, "chaos_a"), _survivors(group, "chaos_b")
    assert sorted(a) == sorted(b) == [0, 1]
    for m in a:
        assert str(a[m]["log"]) == str(b[m]["log"])
        assert int(a[m]["rescues"]) == int(b[m]["rescues"]) == 1
        np.testing.assert_array_equal(a[m]["ranks"], b[m]["ranks"])
    log = json.loads(str(a[0]["log"]))
    assert {e[1] for e in log} >= {"kill", "delay", "poison"}


def test_the_cli_survives_a_sigkilled_rank(tmp_path, monkeypatch, capfd):
    """A real death: rank 1 of a three-rank CLI run SIGKILLs itself at its
    fifth step boundary (a seeded ProcessKillPlan), its peers raise in
    the next step's exchange, agree on the verdict and finish on two
    ranks. ``main`` returns 0, reports the lost rank, and the ranks file
    is the one-device run's (f64, atol 1e-12)."""
    from pagerank_tpu_torch.testing.faults import ProcessKillPlan

    src, dst = rmat_edges(9, edge_factor=8, seed=4)
    np.savez(tmp_path / "edges.npz", src=src, dst=dst, n=1 << 9)
    base = ["--input", str(tmp_path / "edges.npz"), "--device", "cpu",
            "--iters", "12", "--dtype", "float64", "--log-every", "0"]

    def load(path):
        return np.array([float(line.split("\t")[1]) for line in open(path)])

    assert cli.main(base + ["--out", str(tmp_path / "one.tsv")]) == 0
    plan = ProcessKillPlan("solve", iteration=4, signum=9, rank=1)
    for k, v in plan.to_env().items():
        monkeypatch.setenv(k, v)
    capfd.readouterr()
    rc = cli.main(base + [
        "--num-devices", "3", "--vertex-sharded", "--stall-action",
        "rescue", "--stall-timeout", "60", "--sync-io", "--snapshot-dir",
        str(tmp_path / "snap"), "--out", str(tmp_path / "three.tsv")])
    err = capfd.readouterr().err
    assert rc == 0, err[-2000:]
    assert "lost rank(s) [1] (exit codes {1: -9})" in err
    assert "1 elastic rescue(s) (1 device(s) lost)" in err
    np.testing.assert_allclose(load(tmp_path / "three.tsv"),
                               load(tmp_path / "one.tsv"), rtol=0,
                               atol=1e-12)
