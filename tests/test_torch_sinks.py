"""The port's per-iteration sinks and their URI layer, held against the
JAX package on the same seeded inputs: ``utils/retry.py``,
``utils/fsio.py`` (the scheme half, ``mock://``), ``utils/s3.py`` against
``tests/s3stub.py``, ``TextDumper`` (byte-identical to the JAX dumper on
the native and the Python route), ``SinkGuard``, ``AsyncRankWriter``
and the CLI's sink flags (``--dump-text-dir``, ``--sync-io``,
``--write-retries``, ``--on-write-failure``) against the JAX CLI's."""

import hashlib
import json
import os
import threading
import warnings

import numpy as np
import pytest
import torch

from pagerank_tpu import cli as jax_cli
from pagerank_tpu.utils import fsio as jax_fsio
from pagerank_tpu.utils import retry as jax_retry
from pagerank_tpu.utils import snapshot as jax_snap
from pagerank_tpu_torch import cli
from pagerank_tpu_torch.ingest import native
from pagerank_tpu_torch.utils import fsio, retry, s3
from pagerank_tpu_torch.utils import snapshot as snap_mod
from pagerank_tpu_torch.utils.snapshot import (AsyncRankWriter, SinkGuard,
                                               Snapshotter, TextDumper,
                                               WriterSyncedSnapshotter)
from tests.s3stub import S3Stub


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


@pytest.fixture
def edges(tmp_path):
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 60, 400), rng.integers(0, 60, 400)
    p = tmp_path / "edges.txt"
    p.write_text("".join(f"{a} {b}\n" for a, b in zip(src, dst)))
    return str(p)


# -- utils/retry.py ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_retry_schedule_equals_the_jax_policy(seed):
    """Same seed, same jittered backoff sequence, same attempt budget."""
    def schedule(mod):
        slept = []
        pol = mod.RetryPolicy(max_attempts=5, base_delay=0.1, max_delay=1.0,
                              seed=seed, sleep=slept.append,
                              clock=lambda: 0.0)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 5:
                raise ConnectionError("reset")
            return "ok"

        stats = mod.RetryStats()
        assert pol.call(flaky, stats=stats) == "ok"
        return slept, stats.retries

    assert schedule(retry) == schedule(jax_retry)


def test_retry_classifies_like_the_jax_predicate():
    for exc in (FileNotFoundError("x"), PermissionError("x"),
                ConnectionResetError("x"), TimeoutError("x"), OSError("x"),
                ValueError("x")):
        assert (retry.default_retryable(exc)
                == jax_retry.default_retryable(exc)), exc


# -- utils/fsio.py -----------------------------------------------------------

@pytest.mark.parametrize("base,parts", [
    ("mock://", ("a", "b")), ("mock://bucket/", ("/x",)),
    ("s3://b/dir", ("PageRank3", "part-00000")), ("/tmp/x", ("y", "z")),
    ("rel", ("a",))])
def test_join_and_scheme_equal_the_jax_fsio(base, parts):
    assert fsio.join(base, *parts) == jax_fsio.join(base, *parts)
    assert fsio.scheme_of(base) == jax_fsio.scheme_of(base)


def test_memory_filesystem_round_trips_a_snapshot_and_a_dump():
    mem = fsio.MemoryFileSystem()
    fsio.register("mock", mem)
    try:
        snap = Snapshotter("mock://run/snaps", "fp", "reference")
        ranks = np.arange(5, dtype=np.float32)
        snap.save(3, ranks)
        assert snap.iterations() == [3]
        np.testing.assert_array_equal(snap.load(3)[0], ranks)
        TextDumper("mock://run/dumps").dump(0, ranks)
        assert mem.files["mock://run/dumps/PageRank0/part-00000"].startswith(
            b"(0,0.0)\n(1,1.0)")
        assert "mock://run/dumps/PageRank0/_SUCCESS" in mem.files
        # atomic_write publishes nothing when the body raises
        with pytest.raises(RuntimeError):
            with fsio.atomic_write("mock://run/torn", "wb") as f:
                f.write(b"half")
                raise RuntimeError("killed")
        assert not fsio.exists("mock://run/torn")
    finally:
        fsio.unregister("mock")


def test_unknown_scheme_names_the_registration():
    with pytest.raises(ValueError, match="no filesystem registered"):
        fsio.fopen("nope://x/y")
    with pytest.raises(ValueError, match="same-store only"):
        fsio.replace("mock://a", "/tmp/b")


# -- utils/s3.py against tests/s3stub.py --------------------------------------

def test_s3_round_trip_and_listing_against_the_stub():
    with S3Stub() as stub:
        fs = s3.S3FileSystem(endpoint=stub.endpoint)
        with fs.open("s3://bkt/dir/a.txt", "w") as f:
            f.write("hello")
        with fs.open("s3://bkt/dir/sub/b.bin", "wb") as f:
            f.write(b"\x00\x01")
        assert fs.open("s3://bkt/dir/a.txt").read() == "hello"
        assert fs.listdir("s3://bkt/dir") == ["a.txt", "sub"]
        assert fs.isdir("s3://bkt/dir/sub") and fs.isfile("s3://bkt/dir/a.txt")
        fs.replace("s3://bkt/dir/a.txt", "s3://bkt/dir/c.txt")
        assert not fs.exists("s3://bkt/dir/a.txt")
        assert "/bkt/dir/c.txt" in stub.objects


def test_s3_auto_registers_from_the_shared_endpoint_variable(monkeypatch):
    """PAGERANK_TPU_S3_ENDPOINT drives both packages: each registers its
    own S3FileSystem for s3/s3n/s3a at the first s3 path."""
    with S3Stub() as stub:
        monkeypatch.setenv("PAGERANK_TPU_S3_ENDPOINT", stub.endpoint)
        for mod in (fsio, jax_fsio):
            for scheme in ("s3", "s3n", "s3a"):
                mod.unregister(scheme)
        try:
            with fsio.fopen("s3n://bkt/x.txt", "w") as f:
                f.write("port")
            with jax_fsio.fopen("s3n://bkt/x.txt") as f:
                assert f.read() == "port"
            assert isinstance(fsio.get_fs("s3a://bkt/x"), s3.S3FileSystem)
        finally:
            for mod in (fsio, jax_fsio):
                for scheme in ("s3", "s3n", "s3a"):
                    mod.unregister(scheme)


def test_cli_sinks_and_resume_through_s3(edges, monkeypatch):
    """--snapshot-dir and --dump-text-dir as s3:// URIs, then --resume
    from them: bit-equal to an uninterrupted run, the dumps equal to a
    local run's bytes."""
    with S3Stub() as stub:
        monkeypatch.setenv("PAGERANK_TPU_S3_ENDPOINT", stub.endpoint)
        for scheme in ("s3", "s3n", "s3a"):
            fsio.unregister(scheme)
        try:
            base = ["--input", edges, "--device", "cpu", "--log-every", "0"]
            sinks = ["--snapshot-dir", "s3://bkt/snaps",
                     "--dump-text-dir", "s3://bkt/dumps"]
            cli.run(base + ["--iters", "3", *sinks])
            s = cli.run(base + ["--iters", "6", *sinks, "--resume"])
            ctrl = cli.run(base + ["--iters", "6"])
            assert s["resumed_from"] == 3
            np.testing.assert_array_equal(s["ranks"], ctrl["ranks"])
            assert "/bkt/dumps/PageRank5/_SUCCESS" in stub.objects
            want = "".join(f"({i},{float(r)!r})\n"
                           for i, r in enumerate(s["ranks"])).encode()
            assert stub.objects["/bkt/dumps/PageRank5/part-00000"] == want
        finally:
            for scheme in ("s3", "s3n", "s3a"):
                fsio.unregister(scheme)


# -- seeded file and HTTP faults (testing/faults.py) --------------------------

def test_fault_schedule_and_http_injector_replay_the_jax_logs():
    from pagerank_tpu.testing import faults as jax_faults
    from pagerank_tpu_torch.testing import faults

    def drive(mod):
        s = mod.FaultSchedule(seed=11, fail_rate=0.2, truncate_rate=0.1,
                              delay_rate=0.1, max_faults=10)
        h = mod.HttpFaultInjector(seed=4, plan={2: ("reset",)},
                                  fail_rate=0.3, methods=("PUT", "GET"))
        for i in range(50):
            s.decide("open_r" if i % 2 else "commit", f"p{i}")
            h("PUT" if i % 3 else "HEAD", f"/b/k{i}")
        return s.log, h.log

    assert drive(faults) == drive(jax_faults)


def test_a_truncated_snapshot_write_is_caught_by_the_checksum():
    from pagerank_tpu_torch.testing.faults import (FaultInjectingFileSystem,
                                                   FaultSchedule)
    from pagerank_tpu_torch.utils.snapshot import SnapshotCorruptError

    inner = fsio.MemoryFileSystem()
    sched = FaultSchedule(seed=3, truncate_nth=(2,), ops=("commit",))
    fsio.register("chaos", FaultInjectingFileSystem(inner, sched))
    try:
        snap = Snapshotter("chaos://ck", "fp", "reference")
        snap.save(1, np.arange(64, dtype=np.float64))
        assert snap.iterations() == [1]
        with pytest.raises(SnapshotCorruptError):
            snap.load(1)
        assert snap.load_latest_valid() is None
    finally:
        fsio.unregister("chaos")


def test_transient_sink_faults_are_retried_by_the_async_writer():
    """Injected store failures on two commits: the guard's retries
    carry every snapshot through."""
    from pagerank_tpu_torch.testing.faults import (FaultInjectingFileSystem,
                                                   FaultSchedule)

    inner = fsio.MemoryFileSystem()
    sched = FaultSchedule(seed=0, fail_nth=(2, 6), ops=("commit",))
    fsio.register("chaos", FaultInjectingFileSystem(inner, sched))
    try:
        snap = Snapshotter("chaos://ck", "fp", "reference")
        guard = SinkGuard(retry_policy=retry.RetryPolicy(
            max_attempts=4, sleep=lambda s: None))
        w = AsyncRankWriter(lambda p: p, [snap.save], guard=guard)
        for i in range(1, 4):
            w.submit(i, np.full(8, float(i), np.float32))
        w.close()
        assert snap.iterations() == [1, 2, 3]
        assert guard.retries == sched.faults == 2
        np.testing.assert_array_equal(snap.load(2)[0], np.full(8, 2.0))
    finally:
        fsio.unregister("chaos")


def test_s3_writes_retry_through_a_503_and_a_reset():
    from pagerank_tpu_torch.testing.faults import HttpFaultInjector

    with S3Stub() as stub:
        stub.fault_hook = HttpFaultInjector(
            plan={1: ("status", 503, "SlowDown"), 3: ("reset",)})
        fs = s3.S3FileSystem(stub.endpoint, retry_policy=retry.RetryPolicy(
            max_attempts=4, sleep=lambda s: None,
            retryable=s3._s3_retryable))
        with fs.open("s3://b/k", "wb") as f:
            f.write(b"payload")
        with fs.open("s3://b/k", "rb") as f:
            assert f.read() == b"payload"
        assert fs.retry_stats.retries == 2


# -- TextDumper ---------------------------------------------------------------

NAMES = ["http://ex.com/a", "b", "日本語", "x" * 40]


@pytest.mark.parametrize("names", [None, NAMES], ids=["int-keys", "names"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_text_dump_bytes_equal_the_jax_dumper(tmp_path, names, dtype):
    """Same ranks and names, same part-00000 bytes, with _SUCCESS."""
    rng = np.random.default_rng(5)
    n = len(names) if names else 300
    ranks = (rng.random(n) * 10.0 ** rng.integers(-8, 6, n)).astype(dtype)
    ours = TextDumper(str(tmp_path / "port"), names=names)
    theirs = jax_snap.TextDumper(str(tmp_path / "jax"), names=names)
    p1, p2 = ours.dump(7, ranks), theirs.dump(7, ranks)
    assert p1.endswith(os.path.join("PageRank7", "part-00000"))
    assert open(p1, "rb").read() == open(p2, "rb").read()
    assert ours.route == "native"
    assert os.path.exists(os.path.join(os.path.dirname(p1), "_SUCCESS"))


@pytest.mark.parametrize("mod", [snap_mod, jax_snap], ids=["port", "jax"])
def test_a_name_the_native_route_cannot_take_fails_as_in_jax(tmp_path, mod):
    """A name that is not utf-8-encodable takes the Python route, which
    raises as the JAX dumper's does, leaving no part file (the dump is
    atomic)."""
    d = mod.TextDumper(str(tmp_path / "d"), names=["a", "\ud800lone"])
    with pytest.raises(UnicodeEncodeError):
        d.dump(0, np.ones(2))
    assert not os.path.exists(tmp_path / "d" / "PageRank0" / "part-00000")


def test_text_dump_python_route_equals_the_native_route(tmp_path,
                                                         monkeypatch):
    rng = np.random.default_rng(9)
    ranks = rng.random(1000)
    names = [f"http://x/{i}" for i in range(1000)]
    fast = TextDumper(str(tmp_path / "fast"), names=names)
    p1 = fast.dump(0, ranks)
    monkeypatch.setattr(native, "format_rank_lines_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(TextDumper, "CHUNK_ROWS", 37)
    slow = TextDumper(str(tmp_path / "slow"), names=names)
    p2 = slow.dump(0, ranks)
    assert (fast.route, slow.route) == ("native", "python")
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_native_formatter_equals_the_jax_binding():
    from pagerank_tpu.ingest import native as jax_native

    rng = np.random.default_rng(3)
    arr = np.concatenate([rng.standard_normal(500) * 1e300,
                          rng.standard_normal(500),
                          [0.0, -0.0, float("inf"), float("nan"), 5e-324]])
    assert (native.format_rank_lines_native(arr, key_base=11)
            == jax_native.format_rank_lines_native(arr, key_base=11))


# -- SinkGuard ----------------------------------------------------------------

@pytest.mark.parametrize("mod", [snap_mod, jax_snap], ids=["port", "jax"])
def test_sink_guard_drops_into_the_same_dead_letter(tmp_path, mod):
    dead = tmp_path / "dead_letter.json"
    guard = mod.SinkGuard(
        retry_policy=retry.RetryPolicy(max_attempts=2, sleep=lambda s: None),
        on_failure="warn_and_drop", dead_letter_path=str(dead))

    def boom():
        raise OSError("disk full")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert guard(4, boom) is False
        assert guard(5, lambda: None) is True
    assert guard.retries == 1
    assert json.loads(dead.read_text()) == {
        "dropped": [{"iteration": 4, "error": "OSError('disk full')"}]}


def test_sink_guard_fail_mode_raises_and_never_drops_interrupts():
    guard = SinkGuard(on_failure="warn_and_drop")
    with pytest.raises(KeyboardInterrupt):
        guard(0, lambda: (_ for _ in ()).throw(KeyboardInterrupt()))
    with pytest.raises(OSError):
        SinkGuard()(0, lambda: (_ for _ in ()).throw(OSError("x")))
    with pytest.raises(ValueError, match="on_failure"):
        SinkGuard(on_failure="ignore")


# -- AsyncRankWriter ----------------------------------------------------------

def test_async_writer_decodes_cpu_tensor_payloads_in_order(tmp_path):
    got = []
    w = AsyncRankWriter(lambda p: p.numpy().copy(),
                        [lambda i, r: got.append((i, r.sum()))],
                        max_pending=2)
    for i in range(20):
        w.submit(i, torch.full((4,), float(i)))
    w.close()
    assert got == [(i, 4.0 * i) for i in range(20)]
    assert len(w.queue_wait_s) == 20


def test_async_writer_stress_keeps_every_write_in_order():
    """Thousands of submits over a queue of 2 with the interpreter's
    switch interval shortened: every item decoded and written once, in
    order, and each submit's wait recorded."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = []
        w = AsyncRankWriter(lambda p: p, [lambda i, r: got.append((i, r))],
                            max_pending=2)
        for i in range(3000):
            w.submit(i, i * 2)
        w.close(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert got == [(i, i * 2) for i in range(3000)]
    assert len(w.queue_wait_s) == len(w.decode_s) == len(w.item_s) == 3000


def test_async_writer_error_surfaces_at_the_next_submit_or_close():
    def sink(i, r):
        if i == 1:
            raise OSError("late boom")

    w = AsyncRankWriter(lambda p: p, [sink])
    w.submit(0, np.ones(2))
    w.submit(1, np.ones(2))
    with pytest.raises(RuntimeError, match="late boom"):
        w.close()
    with pytest.raises(RuntimeError, match="submit\\(\\) after close"):
        w.submit(2, np.ones(2))


def test_async_writer_close_abandons_a_hanging_sink_at_the_deadline():
    release = threading.Event()
    w = AsyncRankWriter(lambda p: p, [lambda i, r: release.wait(5)])
    w.submit(0, np.ones(1))
    with pytest.warns(RuntimeWarning, match="drain deadline"):
        w.close(timeout=0.2)
    release.set()


def test_writer_synced_snapshotter_flushes_before_the_scan(tmp_path):
    snap = Snapshotter(str(tmp_path), "fp", "reference")
    gate = threading.Event()

    def slow_save(i, r):
        gate.wait(5)
        snap.save(i, r)

    w = AsyncRankWriter(lambda p: p, [slow_save])
    w.submit(2, np.ones(3, np.float32))
    synced = WriterSyncedSnapshotter(snap, w)
    threading.Timer(0.1, gate.set).start()
    it, ranks, _ = synced.load_latest_valid()
    assert it == 2 and ranks.sum() == 3
    w.close()


# -- the CLI's sink flags, against the JAX CLI --------------------------------

def test_cli_async_and_sync_writers_write_the_same_bytes(edges, tmp_path):
    runs = {}
    for label, extra in (("async", []), ("sync", ["--sync-io"])):
        d = tmp_path / label
        runs[label] = cli.run(["--input", edges, "--device", "cpu",
                               "--iters", "4", "--log-every", "0",
                               "--snapshot-dir", str(d / "snaps"),
                               "--dump-text-dir", str(d / "dumps"), *extra])
        assert runs[label]["writer"] == label
        assert runs[label]["dump_route"] == "native"
        assert len(runs[label]["snapshot_seconds"]) == 4
        assert len(runs[label]["dump_seconds"]) == 4
    np.testing.assert_array_equal(runs["async"]["ranks"],
                                  runs["sync"]["ranks"])
    a, b = _digests(tmp_path / "async"), _digests(tmp_path / "sync")
    assert a == b and len(a) == 4 + 4 * 2


def test_cli_text_dumps_equal_the_jax_clis(edges, tmp_path):
    """The same edge list at f64 on the cpu engines: every
    PageRank{i}/part-00000 byte-identical between the two CLIs."""
    argv = ["--input", edges, "--iters", "3", "--engine", "cpu",
            "--log-every", "0"]
    assert cli.main(argv + ["--dump-text-dir", str(tmp_path / "port")]) == 0
    assert jax_cli.main(argv + ["--dump-text-dir",
                                str(tmp_path / "jax")]) == 0
    assert _digests(tmp_path / "port") == _digests(tmp_path / "jax")


def _failing_save(monkeypatch, mod):
    real = mod.Snapshotter.save

    def save(self, iteration, ranks):
        if iteration >= 4:
            raise IOError("disk full")
        return real(self, iteration, ranks)

    monkeypatch.setattr(mod.Snapshotter, "save", save)


def test_cli_warn_and_drop_writes_the_jax_dead_letter(edges, tmp_path,
                                                      monkeypatch):
    """A persistently failing snapshot write under --on-write-failure
    warn_and_drop: both CLIs finish (rc 0), drop the same iterations
    into dead_letter.json and keep the healthy snapshots."""
    _failing_save(monkeypatch, snap_mod)
    _failing_save(monkeypatch, jax_snap)
    dirs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, ["--num-devices", "1"])):
        sd = tmp_path / name
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            assert main(["--input", edges, "--iters", "5", "--log-every",
                         "0", "--snapshot-dir", str(sd), "--on-write-failure",
                         "warn_and_drop", "--write-retries", "1",
                         *extra]) == 0
        dirs[name] = sd
    letters = [json.loads((d / "dead_letter.json").read_text())
               for d in dirs.values()]
    assert [d["iteration"] for d in letters[0]["dropped"]] == [3, 4]
    assert letters[0] == letters[1]
    for d in dirs.values():
        assert sorted(p.name for p in d.iterdir()) == [
            "dead_letter.json", "ranks_iter1.npz", "ranks_iter2.npz",
            "ranks_iter3.npz"]


def test_cli_write_failure_fails_the_run_by_default(edges, tmp_path,
                                                    monkeypatch):
    _failing_save(monkeypatch, snap_mod)
    with pytest.raises(RuntimeError, match="disk full"):
        cli.run(["--input", edges, "--device", "cpu", "--iters", "5",
                 "--log-every", "0", "--snapshot-dir", str(tmp_path / "s"),
                 "--write-retries", "1"])


@pytest.mark.parametrize("flag,value,slice_", [
    ("--max-rescues", "2", "slice 6"), ("--stall-timeout", "60", "slice 6"),
    ("--probe-every", "2", "slice 8"), ("--run-report", "r.json", "slice 8"),
    ("--trace", "t.json", "slice 8")])
def test_cli_later_slice_flags_exit_2_naming_their_slice(edges, capsys, flag,
                                                         value, slice_,
                                                         tmp_path,
                                                         monkeypatch):
    """The flags these cases once refused naming a later slice are ported
    now and run: --max-rescues (the elastic runner's budget) and the
    observability flags (--stall-timeout, --probe-every, --run-report,
    --trace)."""
    monkeypatch.chdir(tmp_path)
    argv = ["--input", edges, "--device", "cpu", "--log-every", "0", flag,
            value]
    assert cli.run(argv)["iterations"] == 10
    assert "slice" not in capsys.readouterr().err


def test_cli_rejects_bad_sink_settings(edges):
    with pytest.raises(SystemExit, match="write_attempts"):
        cli.run(["--input", edges, "--device", "cpu", "--write-retries", "0"])
    with pytest.raises(SystemExit):
        cli.run(["--input", edges, "--device", "cpu", "--on-write-failure",
                 "ignore"])
