"""A group job whose manifest quarantines a member builds on the others
(``pagerank_tpu/cli.py:1726-1752`` over the port's process groups).

The port's CLI at ``--device cpu --num-devices 3`` (three spawned gloo
ranks, the launcher's store hosted because of ``--job-dir``) on a job
directory whose manifest quarantines member 1: rank 0 decides the set,
member 1 leaves with the elastic path's exit code (1, forgiven by the
launcher: the store's verdict names it), members 0 and 2 regroup, print
the JAX CLI's line and solve. The JAX CLI on a job directory with the
same manifest at ``--num-devices 2`` builds on the same devices, [0,
2], and prints the same line; the ranks agree within 1e-12 at f64, and
with the port's one-device run. A manifest that quarantines member 0,
the owner of every output, hands the job and its outputs to member 1.
Without the launcher's store, and with every member quarantined, the
build exits with the reason.
"""

import numpy as np
import pytest

from pagerank_tpu_torch import cli, jobs
from pagerank_tpu_torch.parallel import distributed
from pagerank_tpu_torch.utils.synth import rmat_edges

SCALE, ITERS = 9, 8
LINE = ("excluding quarantined device(s) [1] (job manifest); building on 2 "
        "device(s)")


def _tsv(path):
    return np.array([float(line.split("\t")[1]) for line in open(path)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's three-rank job, the JAX CLI's job and the port's
    one-device run; returns their directory, codes and stderr."""
    from pagerank_tpu import cli as jax_cli
    from pagerank_tpu import jobs as jax_jobs

    d = tmp_path_factory.mktemp("quarantine_job")
    src, dst = rmat_edges(SCALE, edge_factor=8, seed=4)
    np.savez(d / "edges.npz", src=src, dst=dst, n=1 << SCALE)
    base = ["--input", str(d / "edges.npz"), "--iters", str(ITERS),
            "--dtype", "float64", "--accum-dtype", "float64",
            "--log-every", "0"]
    jobs.JobSupervisor(str(d / "J")).quarantine_devices([1])
    jax_jobs.JobSupervisor(str(d / "K")).quarantine_devices([1])
    out = {"dir": d}
    out["port"] = cli.main(base + ["--device", "cpu", "--num-devices", "3",
                                   "--job-dir", str(d / "J"),
                                   "--run-report", str(d / "report.json"),
                                   "--snapshot-every", "4",
                                   "--out", str(d / "port.tsv")])
    out["jax"] = jax_cli.main(base + ["--num-devices", "2", "--job-dir",
                                      str(d / "K"), "--out",
                                      str(d / "jax.tsv")])
    out["one"] = cli.main(base + ["--device", "cpu",
                                  "--out", str(d / "one.tsv")])
    return out


def test_the_others_build_and_match_jax_and_one_device(runs):
    d = runs["dir"]
    assert runs["port"] == 0 and runs["jax"] in (0, None)
    assert runs["one"] == 0
    port = _tsv(d / "port.tsv")
    assert port.shape == (1 << SCALE,)
    np.testing.assert_allclose(port, _tsv(d / "jax.tsv"), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(port, _tsv(d / "one.tsv"), rtol=0,
                               atol=1e-12)


def test_the_run_report_and_snapshots_name_the_smaller_group(runs):
    import json

    rep = json.loads((runs["dir"] / "report.json").read_text())
    assert rep["config"]["num_devices"] == 2
    assert rep["layout"]["world"] == 2
    doc = json.loads((runs["dir"] / "J" / "job.json").read_text())
    assert doc["quarantined_devices"] == [1]
    assert doc["status"] == "complete"
    snaps = sorted((runs["dir"] / "J" / "snapshots").glob("*/ranks_iter*"))
    assert [p.name for p in snaps] == ["ranks_iter4.npz", "ranks_iter8.npz"]
    with np.load(snaps[-1]) as f:
        meta = json.loads(bytes(f["mesh"]).decode())
    assert meta["num_devices"] == 2 and meta["device_ids"] == [0, 2]


def test_the_stderr_line_is_jaxs_and_member_1_left(tmp_path, capfd):
    """Both CLIs print the same line on the same manifest; the port's
    launcher reports member 1 lost with exit code 1."""
    from pagerank_tpu import cli as jax_cli
    from pagerank_tpu import jobs as jax_jobs

    src, dst = rmat_edges(8, edge_factor=8, seed=4)
    np.savez(tmp_path / "e.npz", src=src, dst=dst, n=1 << 8)
    base = ["--input", str(tmp_path / "e.npz"), "--iters", "2",
            "--log-every", "0"]
    jobs.JobSupervisor(str(tmp_path / "J")).quarantine_devices([1])
    jax_jobs.JobSupervisor(str(tmp_path / "K")).quarantine_devices([1])
    capfd.readouterr()
    assert cli.main(base + ["--device", "cpu", "--num-devices", "3",
                            "--job-dir", str(tmp_path / "J"),
                            "--out", str(tmp_path / "p.tsv")]) == 0
    port_err = capfd.readouterr().err
    assert jax_cli.main(base + ["--num-devices", "2", "--job-dir",
                                str(tmp_path / "K"), "--out",
                                str(tmp_path / "j.tsv")]) in (0, None)
    jax_err = capfd.readouterr().err
    assert LINE in jax_err.splitlines()
    assert LINE in port_err.splitlines()
    assert "lost rank(s) [1] (exit codes {1: 1})" in port_err


def test_a_quarantined_member_0_hands_the_job_to_member_1(tmp_path, capfd):
    """The manifest quarantines member 0, the owner of every output:
    member 1, rank 0 of the smaller group, takes the job and the outputs
    over. Both CLIs print the same line; the ranks agree with JAX's and
    with one device within 1e-12 at f64; member 1 writes ``--out``, the
    run report (with the load and build spans, traced from the start),
    the manifest and the snapshots, whose mesh names [1, 2]."""
    import json

    from pagerank_tpu import cli as jax_cli
    from pagerank_tpu import jobs as jax_jobs

    src, dst = rmat_edges(SCALE, edge_factor=8, seed=4)
    np.savez(tmp_path / "e.npz", src=src, dst=dst, n=1 << SCALE)
    base = ["--input", str(tmp_path / "e.npz"), "--iters", str(ITERS),
            "--dtype", "float64", "--accum-dtype", "float64",
            "--log-every", "0"]
    jobs.JobSupervisor(str(tmp_path / "J")).quarantine_devices([0])
    jax_jobs.JobSupervisor(str(tmp_path / "K")).quarantine_devices([0])
    capfd.readouterr()
    assert cli.main(base + ["--device", "cpu", "--num-devices", "3",
                            "--job-dir", str(tmp_path / "J"),
                            "--run-report", str(tmp_path / "report.json"),
                            "--snapshot-every", "4",
                            "--out", str(tmp_path / "port.tsv")]) == 0
    port_err = capfd.readouterr().err
    assert jax_cli.main(base + ["--num-devices", "2", "--job-dir",
                                str(tmp_path / "K"), "--out",
                                str(tmp_path / "jax.tsv")]) in (0, None)
    jax_err = capfd.readouterr().err
    assert cli.main(base + ["--device", "cpu",
                            "--out", str(tmp_path / "one.tsv")]) == 0
    line = LINE.replace("[1]", "[0]")
    assert line in jax_err.splitlines()
    assert line in port_err.splitlines()
    assert "lost rank(s) [0] (exit codes {0: 1})" in port_err

    port = _tsv(tmp_path / "port.tsv")
    assert port.shape == (1 << SCALE,)
    np.testing.assert_allclose(port, _tsv(tmp_path / "jax.tsv"), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(port, _tsv(tmp_path / "one.tsv"), rtol=0,
                               atol=1e-12)
    rep = json.loads((tmp_path / "report.json").read_text())
    assert rep["config"]["num_devices"] == 2
    assert rep["layout"]["world"] == 2
    spans = set(rep["spans"])
    assert {"load", "engine/build"} <= spans
    doc = json.loads((tmp_path / "J" / "job.json").read_text())
    assert doc["quarantined_devices"] == [0]
    assert doc["status"] == "complete"
    snaps = sorted((tmp_path / "J" / "snapshots").glob("*/ranks_iter*"))
    assert [p.name for p in snaps] == ["ranks_iter4.npz", "ranks_iter8.npz"]
    with np.load(snaps[-1]) as f:
        meta = json.loads(bytes(f["mesh"]).decode())
    assert meta["num_devices"] == 2 and meta["device_ids"] == [1, 2]


def _fake_group(monkeypatch, store):
    monkeypatch.setattr(distributed, "members", lambda: (0, 1, 2))
    monkeypatch.setattr(distributed, "rank0_decides", lambda v: v)
    monkeypatch.setattr(distributed, "launcher_store", lambda: store)


def test_without_the_launchers_store_the_job_exits_naming_why(
        monkeypatch, tmp_path):
    _fake_group(monkeypatch, None)
    job = jobs.JobSupervisor(str(tmp_path))
    with pytest.raises(SystemExit, match="no store to regroup"):
        cli._drop_quarantined(job, {1})


def test_every_member_quarantined_exits_with_jaxs_wording(monkeypatch,
                                                          tmp_path):
    _fake_group(monkeypatch, object())
    job = jobs.JobSupervisor(str(tmp_path))
    with pytest.raises(SystemExit, match=r"no surviving devices: all of "
                                         r"\[0, 1, 2\] reported dead"):
        cli._drop_quarantined(job, {0, 1, 2})


def test_no_quarantined_member_keeps_the_group(monkeypatch, tmp_path):
    _fake_group(monkeypatch, None)
    job = jobs.JobSupervisor(str(tmp_path))
    assert cli._drop_quarantined(job, {5}) == 3
