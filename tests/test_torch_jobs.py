"""The port's resumable job (``pagerank_tpu_torch/jobs.py`` and the CLI's
``--job-dir``/``--drain-deadline``) and the process-plane chaos of
``testing/faults.py``, held against the JAX package: the artifact
format and digest (an artifact saved by either package loads in the
other), the manifest lifecycle, the seeded kill plan, and the CLI's
kill-and-resume against the JAX CLI's on the same input."""

import json
import os
import signal
import warnings

import numpy as np
import pytest

import pagerank_tpu
from pagerank_tpu import cli as jax_cli
from pagerank_tpu import jobs as jax_jobs
from pagerank_tpu.testing import faults as jax_faults
from pagerank_tpu_torch import build_graph, cli, jobs
from pagerank_tpu_torch.exitcodes import ExitCode
from pagerank_tpu_torch.ops import device_build as db
from pagerank_tpu_torch.testing.faults import (ProcessKillPlan,
                                               run_job_subprocess)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _edges(seed=3, n=200, e=1500):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e), n


@pytest.fixture
def edges_file(tmp_path):
    src, dst, _ = _edges()
    p = tmp_path / "edges.txt"
    p.write_text("".join(f"{a} {b}\n" for a, b in zip(src, dst)))
    return str(p)


# -- the artifact format, across the packages --------------------------------

@pytest.mark.parametrize("writer,reader", [(jobs, jax_jobs), (jax_jobs, jobs)],
                         ids=["port-to-jax", "jax-to-port"])
def test_artifacts_cross_between_the_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(1)
    arrays = {"ranks": rng.random(50).astype(np.float32),
              "ids": np.arange(7, dtype=np.int64)}
    meta = {"stage": "solve", "fingerprint": "abc", "iterations": 4}
    p = str(tmp_path / "a.npz")
    writer.save_artifact(p, arrays, meta)
    got, gmeta = reader.load_artifact(p)
    assert gmeta == meta and set(got) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(got[k], arrays[k])
    assert (jobs._artifact_digest(arrays, json.dumps(meta, sort_keys=True))
            == jax_jobs._artifact_digest(arrays,
                                         json.dumps(meta, sort_keys=True)))


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_host_graph_artifacts_cross_with_names(tmp_path, direction):
    src, dst, n = _edges()
    names = [f"http://x/{i}" for i in range(n)]
    gp = build_graph(src, dst, n=n, vertex_names=names)
    gj = pagerank_tpu.build_graph(src, dst, n=n, vertex_names=names)
    p = str(tmp_path / "ingest.npz")
    if direction == "port-to-jax":
        jobs.save_artifact(p, *jobs.graph_to_arrays(gp))
        arrays, meta = jax_jobs.load_artifact(p)
        back = jax_jobs.graph_from_arrays(arrays, meta)
    else:
        jax_jobs.save_artifact(p, *jax_jobs.graph_to_arrays(gj))
        arrays, meta = jobs.load_artifact(p)
        back = jobs.graph_from_arrays(arrays, meta)
    assert back.fingerprint() == gp.fingerprint() == gj.fingerprint()
    assert list(back.vertex_names) == names
    np.testing.assert_array_equal(back.src, gp.src)


def test_device_build_checkpoint_crosses_into_a_jax_artifact(tmp_path):
    src, dst, n = _edges()
    dg = db.build_ell_device(src.astype(np.int32), dst.astype(np.int32), n,
                             with_weights=False, device="cpu")
    p = str(tmp_path / "build.npz")
    jobs.save_artifact(p, *db.checkpoint_arrays(dg))
    arrays, meta = jax_jobs.load_artifact(p)
    back = db.restore_device_graph(arrays, meta, device="cpu")
    assert back.fingerprint() == dg.fingerprint() == meta["fingerprint"]


def test_artifact_tamper_truncation_and_key_mismatch_are_recomputed(tmp_path):
    sup = jobs.JobSupervisor(str(tmp_path / "job"))
    sup.save_stage_artifact("solve", {"ranks": np.ones(4)}, {"k": 1})
    assert sup.load_stage_artifact("solve", expect={"k": 1}) is not None
    with pytest.warns(RuntimeWarning, match="key mismatch"):
        assert sup.load_stage_artifact("solve", expect={"k": 2}) is None
    path = tmp_path / "job" / "solve.npz"
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])
    with pytest.warns(RuntimeWarning, match="corrupt artifact"):
        assert sup.load_stage_artifact("solve") is None


def test_hashes_and_names_equal_the_jax_helpers():
    key = {"input": "rmat:8", "dtype": "float32", "partition_span": 0}
    assert jobs.key_hash(key) == jax_jobs.key_hash(key)
    names = ["a", "日本語", "http://x/y"]
    enc = jobs.encode_names(names)
    assert jax_jobs.decode_names(enc) == names
    for k, v in jax_jobs.encode_names(names).items():
        np.testing.assert_array_equal(enc[k], v)


# -- the manifest -------------------------------------------------------------

def test_supervisor_manifest_lifecycle_and_quarantine(tmp_path):
    d = str(tmp_path / "job")
    sup = jobs.JobSupervisor(d)
    assert not sup.resumed
    sup.begin("ingest")
    sup.complete("ingest", fingerprint="f")
    sup.begin("build")
    sup.interrupt("build", signal=15)
    sup.quarantine_devices([0])
    man = json.loads((tmp_path / "job" / "job.json").read_text())
    assert man["status"] == "interrupted"
    assert man["stages"]["build"]["status"] == "interrupted"
    sup2 = jobs.JobSupervisor(d)
    assert sup2.resumed and sup2.manifest["resumes"] == 1
    assert sup2.quarantined_devices() == [0]
    sup2.skip("ingest")
    sup2.finish()
    # The JAX supervisor reads the port's manifest and vice versa.
    sup3 = jax_jobs.JobSupervisor(d)
    assert sup3.manifest["resumes"] == 2
    assert sup3.quarantined_devices() == [0]


def test_kill_plan_env_encoding_equals_the_jax_plan():
    plan = ProcessKillPlan("solve", 5, signum=int(signal.SIGKILL), seed=3)
    assert plan.to_env() == jax_faults.ProcessKillPlan(
        "solve", 5, signum=int(signal.SIGKILL), seed=3).to_env()
    back = ProcessKillPlan.from_env(plan.to_env())
    assert (back.stage, back.iteration, back.signum, back.seed) == (
        "solve", 5, int(signal.SIGKILL), 3)


# -- the CLI ------------------------------------------------------------------

def _job(edges, job_dir, out, *extra):
    return ["--input", edges, "--device", "cpu", "--iters", "6",
            "--log-every", "0", "--job-dir", str(job_dir), "--out", str(out),
            *extra]


def test_cli_rerun_skips_every_stage_and_writes_the_same_bytes(edges_file,
                                                              tmp_path,
                                                              capsys):
    j = tmp_path / "job"
    a = cli.run(_job(edges_file, j, tmp_path / "a.tsv"))
    b = cli.run(_job(edges_file, j, tmp_path / "b.tsv"))
    assert "3 stage(s) satisfied by durable artifacts: ingest, build, " \
        "solve" in capsys.readouterr().err
    assert b["engine"] is None and b["job"]["resumes"] == 1
    np.testing.assert_array_equal(a["ranks"], b["ranks"])
    assert (tmp_path / "a.tsv").read_bytes() == (tmp_path / "b.tsv").read_bytes()
    # Another solve config recomputes the solve only (fresh snapshots).
    with pytest.warns(RuntimeWarning, match="key mismatch"):
        c = cli.run(_job(edges_file, j, tmp_path / "c.tsv", "--damping",
                         "0.5"))
    assert c["job"]["stages"]["build"]["skipped"]
    assert not c["job"]["stages"]["solve"]["skipped"]
    assert c["resumed_from"] == 0


def test_cli_job_refusals_exit_2(edges_file, tmp_path):
    for extra in (["--ppr-sources", "1"], ["--drain-deadline", "0"]):
        with pytest.raises(SystemExit) as e:
            cli.run(["--input", edges_file, "--device", "cpu", "--job-dir",
                     str(tmp_path / "j"), *extra])
        assert e.value.code == int(ExitCode.USAGE)


def test_cli_device_build_job_resumes_from_the_build_artifact(tmp_path,
                                                             capsys):
    j = tmp_path / "job"
    argv = ["--synthetic", "rmat:9", "--device-build", "--device", "cpu",
            "--iters", "4", "--log-every", "0", "--job-dir", str(j),
            "--partition-span", "128"]
    a = cli.run(argv)
    assert (j / "build.npz").exists() and not (j / "ingest.npz").exists()
    (j / "solve.npz").unlink()  # a job lost after its build
    b = cli.run(argv)
    err = capsys.readouterr().err
    assert "2 stage(s) satisfied by durable artifacts: ingest, build" in err
    assert b["partition_span"] == a["partition_span"] == 128
    assert b["resumed_from"] == 4
    np.testing.assert_array_equal(a["ranks"], b["ranks"])


def test_cli_sigterm_drain_then_resume_is_bit_equal(edges_file, tmp_path,
                                                    monkeypatch, capsys):
    """The seeded plan delivers a real SIGTERM at solve iteration 3
    under cli.main's drain: exit 75, the manifest interrupted with a
    final snapshot; the rerun resumes and ends bit-equal to an
    uninterrupted job (torch engine on the CPU)."""
    j = tmp_path / "job"
    for k, v in ProcessKillPlan("solve", 3,
                                signum=int(signal.SIGTERM)).to_env().items():
        monkeypatch.setenv(k, v)
    assert cli.main(_job(edges_file, j, tmp_path / "r.tsv")) == int(
        ExitCode.INTERRUPTED)
    err = capsys.readouterr().err
    assert "draining" in err and "interrupted by SIGTERM" in err
    man = json.loads((j / "job.json").read_text())
    assert man["status"] == "interrupted"
    assert man["stages"]["solve"]["status"] == "interrupted"
    monkeypatch.delenv(ProcessKillPlan.ENV)
    s = cli.run(_job(edges_file, j, tmp_path / "r.tsv"))
    assert s["resumed_from"] == 4 and s["iterations"] == 6
    ctrl = cli.run(_job(edges_file, tmp_path / "ctrl", tmp_path / "c.tsv"))
    np.testing.assert_array_equal(s["ranks"], ctrl["ranks"])
    assert (tmp_path / "r.tsv").read_bytes() == (tmp_path / "c.tsv").read_bytes()


def test_cli_kill_and_resume_equals_the_jax_clis(edges_file, tmp_path,
                                                 monkeypatch):
    """The f64 oracle in both CLIs, SIGTERM at solve iteration 2 and a
    rerun: the same exit codes, the same interrupted manifest shape,
    the same resume point and byte-identical --out."""
    outs, mans = {}, {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        j = tmp_path / name
        argv = ["--input", edges_file, "--engine", "cpu", "--iters", "5",
                "--log-every", "0", "--job-dir", str(j), "--out",
                str(tmp_path / f"{name}.tsv")]
        for k, v in ProcessKillPlan("solve", 2, signum=int(
                signal.SIGTERM)).to_env().items():
            monkeypatch.setenv(k, v)
        assert main(argv) == int(ExitCode.INTERRUPTED)
        mans[name] = json.loads((j / "job.json").read_text())
        monkeypatch.delenv(ProcessKillPlan.ENV)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            assert main(argv) == 0
        outs[name] = (tmp_path / f"{name}.tsv").read_bytes()
        done = json.loads((j / "job.json").read_text())
        assert done["status"] == "complete" and done["resumes"] == 1
    assert outs["port"] == outs["jax"]
    for man in mans.values():
        assert man["status"] == "interrupted"
        assert man["stages"]["solve"]["status"] == "interrupted"
        assert man["stages"]["solve"]["iteration"] == 3
    assert ({s: r["status"] for s, r in mans["port"]["stages"].items()}
            == {s: r["status"] for s, r in mans["jax"]["stages"].items()})


def test_cli_sigkill_subprocess_resumes_bit_equal(edges_file, tmp_path):
    """A real subprocess SIGKILLed at solve iteration 3: nothing
    survives beyond the committed artifacts and snapshots; the rerun
    skips ingest and build and ends bit-equal to an uninterrupted
    job."""
    j = tmp_path / "job"
    # --sync-io: the snapshots of iterations 1-4 are on disk when the
    # kill lands (the async writer's queue would die with the process).
    argv = _job(edges_file, j, tmp_path / "r.tsv", "--sync-io")
    env = {"PYTHONPATH": REPO}
    killed = run_job_subprocess(
        argv, kill=ProcessKillPlan("solve", 3, signum=int(signal.SIGKILL)),
        env=env, timeout=120)
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-800:]
    assert (j / "ingest.npz").exists() and not (j / "solve.npz").exists()
    again = run_job_subprocess(argv, env=env, timeout=120)
    assert again.returncode == 0, again.stderr[-800:]
    assert "resumed from iteration 4" in again.stderr
    assert "2 stage(s) satisfied by durable artifacts: ingest, build" \
        in again.stderr
    ctrl = run_job_subprocess(_job(edges_file, tmp_path / "ctrl",
                                   tmp_path / "c.tsv"), env=env, timeout=120)
    assert ctrl.returncode == 0, ctrl.stderr[-800:]
    assert (tmp_path / "r.tsv").read_bytes() == (tmp_path / "c.tsv").read_bytes()
    a, _ = jobs.load_artifact(str(j / "solve.npz"))
    b, _ = jobs.load_artifact(str(tmp_path / "ctrl" / "solve.npz"))
    np.testing.assert_array_equal(a["ranks"], b["ranks"])


@pytest.mark.parametrize("seed", range(4))
def test_drain_replay_equals_the_jax_scheduler(seed):
    """testing/schedules.py: a seeded interleaving of a solve loop that
    checks for a drain at each safe point and a signal delivery replays
    to the same log in both packages."""
    from pagerank_tpu.testing import schedules as jax_schedules
    from pagerank_tpu_torch.testing import schedules

    def replay(sched_mod, jobs_mod):
        sched = sched_mod.InterleavingScheduler(seed=seed)
        drain = jobs_mod.GracefulDrain(install=lambda s, h: None,
                                       hard_exit=lambda code: None,
                                       clock=sched.clock)

        def main():
            for i in range(5):
                yield f"step-{i}"
                try:
                    drain.check("solve")
                except jobs_mod.DrainInterrupt:
                    yield "drained"
                    return

        def deliver():
            yield "armed"
            drain._handler(int(signal.SIGTERM), None)
            yield "delivered"

        sched.spawn("main", main())
        sched.spawn("signal", deliver())
        return sched.run()

    log = replay(schedules, jobs)
    assert log == replay(jax_schedules, jax_jobs)
    labels = [label for _, actor, label in log if actor == "main"]
    assert labels[-1] == "<done>" and labels[-2] in ("drained", "step-4")


def test_an_agreed_drain_check_stops_every_rank_on_any_request():
    """``GracefulDrain.check_agreed``: the ranks' request flags are summed
    (here by a stand-in for the psum); a request on any rank raises on
    every rank at that safe point, a rank asked by another keeps its own
    first signal (a later signal does not hard-exit it), and with no
    request nothing is raised."""
    exits = []

    def drain():
        return jobs.GracefulDrain(install=lambda s, h: None,
                                  hard_exit=exits.append)

    ranks = [drain(), drain()]

    def check_all():
        flags = [int(d.requested) for d in ranks]
        raised = []
        for d in ranks:
            try:
                d.check_agreed(lambda x: sum(flags), "solve")
                raised.append(False)
            except jobs.DrainInterrupt as e:
                raised.append(e.signum)
        return raised

    assert check_all() == [False, False]
    ranks[0]._handler(int(signal.SIGTERM), None)
    assert check_all() == [int(signal.SIGTERM), 0]
    assert not ranks[1].requested and ranks[1].remaining() is not None
    ranks[1]._handler(int(signal.SIGTERM), None)
    assert exits == [] and ranks[1].requested
