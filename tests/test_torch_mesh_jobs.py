"""The resumable job, the async rank writer and the drain during ingest
and build over a process group (the second half of slice 6d): the CLI
at ``--device cpu --num-devices 2`` (two spawned gloo ranks).

One job runs as four launches of the same command, a two-rank
vertex-sharded solve of a device-built graph with probes and snapshots:

1. SIGTERM to rank 1 alone while it loads its input: both ranks agree
   on the drain at the next stage boundary (the build's, after rank 0
   committed the ingest and build artifacts) and exit 75, well inside
   the group's collective timeout;
2. the resume skips ingest and build; SIGTERM to rank 1 at its fifth
   solve step (the seeded kill plan): both exit 75 after that step;
3. the resume skips them again, resumes the solve from the drain's
   snapshot and exits 0;
4. the same job uninterrupted, in a fresh directory, with the async
   writer (1-3 run ``--sync-io``).

The interrupted job's ranks equal the uninterrupted one's bit for bit
and agree with the JAX CLI's at ``--num-devices 2`` within 1e-12 (f64);
each snapshot both wrote is byte-equal; rank 0 alone wrote the
directory, whose ingest artifact loads in the JAX package's
``JobSupervisor``.
"""

import json
import shutil
import time

import numpy as np
import pytest

from pagerank_tpu_torch import cli, jobs
from pagerank_tpu_torch.exitcodes import ExitCode
from pagerank_tpu_torch.parallel import distributed
from pagerank_tpu_torch.utils.synth import rmat_edges

SCALE, ITERS = 9, 8
TIMEOUT_S = 60.0


def _tsv(path):
    return np.array([float(line.split("\t")[1]) for line in open(path)])


def _stages(job_dir):
    doc = json.loads((job_dir / "job.json").read_text())
    return doc, {s: (r["status"], bool(r.get("skipped")))
                 for s, r in doc["stages"].items()}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The four launches (module docstring); returns their directory,
    exit codes, the first launch's wall and stderr of the others."""
    d = tmp_path_factory.mktemp("mesh_job")
    src, dst = rmat_edges(SCALE, edge_factor=8, seed=4)
    np.savez(d / "edges.npz", src=src, dst=dst, n=1 << SCALE)
    base = ["--input", str(d / "edges.npz"), "--device", "cpu",
            "--num-devices", "2", "--vertex-sharded", "--iters", str(ITERS),
            "--dtype", "float64", "--device-build", "--probe-every", "2",
            "--snapshot-every", "2", "--log-every", "0"]
    chain = base + ["--job-dir", str(d / "J"), "--sync-io",
                    "--out", str(d / "chain.tsv")]
    out = {"dir": d, "codes": [], "manifests": []}
    t = time.monotonic()
    codes = distributed.spawn_group(
        "pagerank_tpu_torch.testing.sharded:drain_in_ingest", 2,
        dict(argv=chain, rank=1), str(d), backend="gloo",
        timeout_s=TIMEOUT_S, deadline_s=2 * TIMEOUT_S)
    out["drain_wall"] = time.monotonic() - t
    out["codes"].append(list(codes))
    out["manifests"].append(_stages(d / "J"))
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("PAGERANK_TPU_KILL_PLAN", "stage=solve,iter=4,rank=1")
        out["codes"].append(cli.main(chain))
        out["manifests"].append(_stages(d / "J"))
        mp.delenv("PAGERANK_TPU_KILL_PLAN")
        out["codes"].append(cli.main(chain))
        out["manifests"].append(_stages(d / "J"))
    finally:
        mp.undo()
    out["codes"].append(cli.main(base + ["--job-dir", str(d / "K"),
                                         "--out", str(d / "plain.tsv")]))
    return out


def test_a_drain_asked_of_one_rank_in_ingest_stops_both_at_one_boundary(
        job):
    """SIGTERM to rank 1 during its ingest: both ranks exit 75 at the
    build boundary (a sum of the request flag over the group), none
    waits for the group's timeout; the ingest and build artifacts were
    committed first, so the resume skips them."""
    assert job["codes"][0] == [int(ExitCode.INTERRUPTED)] * 2
    assert job["drain_wall"] < TIMEOUT_S / 2
    doc, stages = job["manifests"][0]
    assert stages["ingest"] == ("done", False)
    assert stages["build"] == ("done", False)
    assert stages["solve"][0] == "pending"
    assert (job["dir"] / "J" / "build.npz").exists()


def test_a_drained_job_resumes_skipping_exactly_the_committed_stages(job):
    """Launch 2 skips ingest and build and drains in the solve (exit 75,
    both ranks stopped after the step of the kill); launch 3 skips them
    again and finishes the solve from the drain's snapshot (exit 0)."""
    assert job["codes"][1:3] == [int(ExitCode.INTERRUPTED), 0]
    doc, stages = job["manifests"][1]
    assert doc["resumes"] == 1 and doc["status"] == "interrupted"
    assert stages["ingest"] == stages["build"] == ("done", True)
    assert stages["solve"] == ("interrupted", False)
    assert doc["stages"]["solve"]["iteration"] == 5
    doc, stages = job["manifests"][2]
    assert doc["resumes"] == 2 and doc["status"] == "complete"
    assert stages["ingest"] == stages["build"] == ("done", True)
    assert stages["solve"] == ("done", False)
    assert stages["output"] == ("done", False)
    snaps = job["dir"] / "J" / "snapshots"
    (solve_dir,) = snaps.iterdir()
    assert sorted(p.name for p in solve_dir.iterdir()) == [
        f"ranks_iter{i}.npz" for i in (2, 4, 5, 6, 8)]


def test_the_resumed_job_equals_the_uninterrupted_run_and_jax(job):
    """Bit-equal ranks to the uninterrupted job, within 1e-12 of the
    JAX CLI's at --num-devices 2 on the same input."""
    from pagerank_tpu import cli as jax_cli

    d = job["dir"]
    assert job["codes"][3] == 0
    chain, plain = _tsv(d / "chain.tsv"), _tsv(d / "plain.tsv")
    assert chain.shape == (1 << SCALE,)
    np.testing.assert_array_equal(chain, plain)
    assert jax_cli.main(["--input", str(d / "edges.npz"), "--num-devices",
                         "2", "--vertex-sharded", "--iters", str(ITERS),
                         "--dtype", "float64", "--accum-dtype", "float64",
                         "--device-build", "--log-every", "0",
                         "--out", str(d / "jax.tsv")]) in (0, None)
    np.testing.assert_allclose(chain, _tsv(d / "jax.tsv"), rtol=0,
                               atol=1e-12)


def test_async_snapshots_are_byte_equal_to_the_sync_writer(job):
    """Rank 0 alone submits to the async writer (the other rank joins
    the gather of the blocks); its files are the --sync-io run's."""
    d = job["dir"]
    (a,) = (d / "J" / "snapshots").iterdir()
    (b,) = (d / "K" / "snapshots").iterdir()
    assert a.name == b.name  # the same solve config
    names = sorted(p.name for p in b.iterdir())
    assert names == [f"ranks_iter{i}.npz" for i in (2, 4, 6, 8)]
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_the_ingest_artifact_loads_in_the_jax_supervisor(job, tmp_path):
    """The raw edges rank 0 committed before the build load in the JAX
    package's JobSupervisor (on a copy: it rewrites the manifest)."""
    from pagerank_tpu import jobs as jax_jobs

    d = job["dir"]
    shutil.copytree(d / "J", tmp_path / "J")
    arrays, meta = jax_jobs.JobSupervisor(
        str(tmp_path / "J")).load_stage_artifact("ingest")
    with np.load(d / "edges.npz") as f:
        np.testing.assert_array_equal(arrays["src"], f["src"])
        np.testing.assert_array_equal(arrays["dst"], f["dst"])
    assert meta["kind"] == "raw_edges" and meta["n"] == 1 << SCALE


def test_a_follower_supervisor_reads_and_writes_nothing(tmp_path):
    """A rank other than rank 0 holds a ``write=False`` supervisor: it
    reads rank 0's manifest without counting a resume, follows the
    stage transitions in memory and writes no manifest or artifact."""
    lead = jobs.JobSupervisor(str(tmp_path))
    lead.begin("ingest")
    before = (tmp_path / "job.json").read_bytes()
    follow = jobs.JobSupervisor(str(tmp_path), write=False)
    assert follow.manifest["resumes"] == 0 and not follow.resumed
    follow.complete("ingest")
    follow.skip("build")
    follow.save_stage_artifact("ingest", {"x": np.zeros(2)}, {})
    follow.quarantine_devices([1])
    follow.save_names(["a"], "k")
    assert (tmp_path / "job.json").read_bytes() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["job.json"]
    assert follow.manifest["stages"]["build"]["skipped"]
    assert follow.quarantined_devices() == [1]


def test_the_stage_drain_of_one_process_is_the_plain_check():
    drain = jobs.GracefulDrain()
    assert cli._stage_drain(drain) == drain.check
