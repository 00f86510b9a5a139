"""``python -m pagerank_tpu_torch.cli --device cpu`` against the JAX CLI,
and the snapshot state carried across the two packages."""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from pagerank_tpu.cli import main as jax_main
from pagerank_tpu.utils.snapshot import Snapshotter as JaxSnapshotter

from pagerank_tpu_torch import cli
from pagerank_tpu_torch.utils.snapshot import Snapshotter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def edges(tmp_path):
    rng = np.random.default_rng(31)
    p = tmp_path / "e.txt"
    p.write_text("# src dst\n" + "".join(
        f"{s} {d}\n" for s, d in zip(rng.integers(0, 400, 3000),
                                     rng.integers(0, 400, 3000))))
    return str(p)


def _read_tsv(path):
    ids, ranks = np.loadtxt(path, delimiter="\t", unpack=True)
    return ids.astype(np.int64), ranks


def _final(snap_dir, it):
    return np.load(os.path.join(snap_dir, f"ranks_iter{it}.npz"))["ranks"]


def test_out_tsv_matches_the_jax_cli(edges, tmp_path):
    ours, theirs = str(tmp_path / "port.tsv"), str(tmp_path / "jax.tsv")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "pagerank_tpu_torch.cli", "--input", edges,
         "--device", "cpu", "--out", ours],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-800:]
    assert "ell_contrib:reference" in r.stderr
    assert jax_main(["--input", edges, "--num-devices", "1", "--log-every",
                     "0", "--out", theirs]) == 0
    id_a, ra = _read_tsv(ours)
    id_b, rb = _read_tsv(theirs)
    np.testing.assert_array_equal(id_a, id_b)
    np.testing.assert_allclose(ra, rb, rtol=0, atol=5e-4)
    assert np.abs(ra - rb).sum() / len(ra) < 1e-4


def test_resume_is_bit_equal_to_an_uninterrupted_run(edges, tmp_path,
                                                     capsys):
    cut, ctrl = str(tmp_path / "cut"), str(tmp_path / "ctrl")
    base = ["--input", edges, "--device", "cpu"]
    assert cli.main(base + ["--iters", "5", "--snapshot-dir", cut]) == 0
    capsys.readouterr()
    s = cli.run(base + ["--iters", "9", "--snapshot-dir", cut, "--resume"])
    assert "resumed from iteration 5" in capsys.readouterr().err
    assert s["resumed_from"] == 5 and s["iterations"] == 9
    assert len(s["step_seconds"]) == 4
    cli.main(base + ["--iters", "9", "--snapshot-dir", ctrl])
    a, b = _final(cut, 9), _final(ctrl, 9)
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_resume_skips_a_corrupted_newest_snapshot(edges, tmp_path, capsys):
    sd, ctrl = tmp_path / "snaps", str(tmp_path / "ctrl")
    base = ["--input", edges, "--device", "cpu"]
    cli.main(base + ["--iters", "5", "--snapshot-dir", str(sd)])
    raw = (sd / "ranks_iter5.npz").read_bytes()
    (sd / "ranks_iter5.npz").write_bytes(raw[: len(raw) // 2])
    capsys.readouterr()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        cli.main(base + ["--iters", "8", "--snapshot-dir", str(sd),
                         "--resume"])
    assert "resumed from iteration 4" in capsys.readouterr().err
    cli.main(base + ["--iters", "8", "--snapshot-dir", ctrl])
    np.testing.assert_array_equal(_final(str(sd), 8), _final(ctrl, 8))


def test_jax_snapshots_resume_in_the_port(edges, tmp_path, capsys):
    sd, ctrl = str(tmp_path / "jax_snaps"), str(tmp_path / "ctrl")
    assert jax_main(["--input", edges, "--num-devices", "1", "--log-every",
                     "0", "--iters", "4", "--snapshot-dir", sd]) == 0
    capsys.readouterr()
    s = cli.run(["--input", edges, "--device", "cpu", "--iters", "8",
                 "--snapshot-dir", sd, "--resume"])
    assert "resumed from iteration 4" in capsys.readouterr().err
    assert s["resumed_from"] == 4
    cli.main(["--input", edges, "--device", "cpu", "--iters", "8",
              "--snapshot-dir", ctrl])
    np.testing.assert_allclose(_final(sd, 8), _final(ctrl, 8), rtol=0,
                               atol=5e-4)


def test_port_snapshots_verify_under_the_jax_snapshotter(edges, tmp_path):
    sd = str(tmp_path / "port_snaps")
    s = cli.run(["--input", edges, "--device", "cpu", "--iters", "3",
                 "--snapshot-dir", sd])
    fp = s["graph"].fingerprint()
    theirs = JaxSnapshotter(sd, fp, "reference")
    for it in (1, 2, 3):
        ranks, meta = theirs.load(it)  # verifies the checksum
        assert meta["iteration"] == it and meta["fingerprint"] == fp
        assert meta["mesh"]["engine"] == "torch"
    np.testing.assert_array_equal(ranks, s["ranks"])
    mine = Snapshotter(sd, fp, "reference")
    np.testing.assert_array_equal(mine.load(3)[0], ranks)


def test_cli_refuses_what_it_does_not_run(tmp_path, edges, monkeypatch):
    crawl = tmp_path / "c.tsv"
    crawl.write_text("http://a/\t{}\n")
    with pytest.raises(SystemExit, match="slice 3"):
        cli.main(["--input", str(crawl), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--snapshot-dir"):
        cli.main(["--input", edges, "--device", "cpu", "--resume"])
    with pytest.raises(SystemExit, match="unknown synthetic"):
        cli.main(["--synthetic", "powerlaw:3", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--input", edges])  # default device is cuda


@pytest.mark.parametrize("spec,n", [("rmat:9", 512), ("uniform:300:2000", 300)])
def test_synthetic_and_npz_inputs(tmp_path, spec, n):
    s = cli.run(["--synthetic", spec, "--device", "cpu", "--iters", "2"])
    g = s["graph"]
    assert g.n == n and np.isfinite(s["ranks"]).all()
    npz = str(tmp_path / "g.npz")
    np.savez(npz, src=g.src, dst=g.dst, n=np.int64(g.n))
    s2 = cli.run(["--input", npz, "--device", "cpu", "--iters", "2"])
    assert s2["graph"].fingerprint() == g.fingerprint()
    np.testing.assert_array_equal(s2["ranks"], s["ranks"])
