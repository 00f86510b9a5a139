"""``python -m pagerank_tpu_torch.cli --device cpu`` against the JAX CLI,
and the snapshot state carried across the two packages."""

import json
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
    with pytest.raises(SystemExit, match="native ingest"):
        cli.main(["--input", str(crawl), "--device", "cpu",
                  "--host-mem-cap-gb", "1", "--no-native-ingest"])
    with pytest.raises(SystemExit, match="max_rollbacks"):
        cli.main(["--input", edges, "--device", "cpu", "--max-rollbacks",
                  "-1"])
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


# -- the main-path flags and the crawl input, against the JAX CLI ------------

@pytest.fixture
def edges_file(tmp_path):
    """tests/test_cli.py's fixture: 200 edges over 40 vertices, seed 0."""
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    p = tmp_path / "edges.txt"
    p.write_text("\n".join(["# test graph"] + [
        f"{a} {b}" for a, b in zip(src, dst)]) + "\n")
    return str(p), src, dst


def _both(tmp_path, argv, name):
    """The same argv through the JAX CLI and the port's (both with the
    f64 cpu engine unless argv says otherwise); returns the two --out
    texts."""
    ours, theirs = str(tmp_path / f"{name}.port"), str(tmp_path / f"{name}.jax")
    assert jax_main(argv + ["--out", theirs]) == 0
    assert cli.main(argv + ["--out", ours]) == 0
    return open(ours).read(), open(theirs).read()


def crawl_meta(targets):
    return json.dumps({"content": {"links": [
        {"type": "a", "href": t} for t in targets]}})


def test_cli_npz_and_jsonl_metrics(tmp_path, edges_file):
    from pagerank_tpu_torch.ingest import save_binary_edges

    _, src, dst = edges_file
    npz = str(tmp_path / "edges.npz")
    save_binary_edges(npz, src, dst, n=40)
    recs = {}
    for name, run in (("port", cli.main), ("jax", jax_main)):
        jsonl = str(tmp_path / f"{name}.jsonl")
        assert run(["--input", npz, "--iters", "5", "--engine", "cpu",
                    "--jsonl", jsonl, "--log-every", "0"]) == 0
        recs[name] = [json.loads(line) for line in open(jsonl)]
    assert len(recs["port"]) == 5
    assert recs["port"][0]["iter"] == 0 and "l1_delta" in recs["port"][0]
    for a, b in zip(recs["port"], recs["jax"]):  # f64 on both: bit-equal
        assert (a["iter"], a["l1_delta"], a["dangling_mass"]) == (
            b["iter"], b["l1_delta"], b["dangling_mass"])


def test_cli_crawl_autodetect(tmp_path, capsys):
    p = tmp_path / "crawl.tsv"
    p.write_text(f"http://a\t{crawl_meta(['http://b'])}\n"
                 f"http://b\t{json.dumps({})}\n")
    ours, theirs = _both(tmp_path, ["--input", str(p), "--iters", "3",
                                    "--engine", "cpu", "--log-every", "0"],
                         "crawl")
    assert "http://a\t" in ours and "http://b\t" in ours
    assert ours == theirs
    s = cli.run(["--input", str(p), "--iters", "3", "--device", "cpu"])
    assert (s["format"], s["ingest_route"]) == ("crawl", "native")
    assert s["ids"].names == ["http://a", "http://b"]
    assert "crawl input, native ingest" in capsys.readouterr().err


def test_cli_seq_prefixed_text_is_not_seqfile(tmp_path):
    meta = crawl_meta(["http://b"])
    for i, first in enumerate(("SEQ://a", "SEQ")):
        p = tmp_path / f"crawl{i}.tsv"
        p.write_text(f"{first}\t{meta}\nhttp://b\t{json.dumps({})}\n")
        ours, theirs = _both(tmp_path, ["--input", str(p), "--iters", "2",
                                        "--engine", "cpu", "--log-every",
                                        "0"], f"seq{i}")
        assert f"{first}\t" in ours and ours == theirs


def test_cli_top_n_output(tmp_path, edges_file):
    path, _, _ = edges_file
    base = ["--input", path, "--iters", "8", "--engine", "cpu",
            "--log-every", "0"]
    full, _ = _both(tmp_path, base, "full")
    ours, theirs = _both(tmp_path, base + ["--top", "5"], "top")
    assert ours == theirs
    rows = [line.split("\t") for line in ours.splitlines()]
    ranks = {int(k): float(v) for k, v in
             (line.split("\t") for line in full.splitlines())}
    got = [float(v) for _, v in rows]
    assert len(rows) == 5 and got == sorted(got, reverse=True)
    assert sorted(got) == sorted(ranks.values())[-5:]
    assert all(ranks[int(k)] == float(v) for k, v in rows)
    ours, theirs = _both(tmp_path, base + ["--top", "1000"], "all")
    assert ours == theirs and len(ours.splitlines()) == 40
    # the torch engine's --top is the same order over its own ranks
    out = str(tmp_path / "torch.tsv")
    s = cli.run(["--input", path, "--iters", "8", "--device", "cpu",
                 "--top", "5", "--out", out])
    want = np.lexsort((np.arange(40), -s["ranks"]))[:5]
    assert [int(line.split("\t")[0]) for line in open(out)] == want.tolist()


def test_cli_top_boundary_ties_deterministic(tmp_path):
    p = tmp_path / "ring.txt"
    p.write_text("\n".join(f"{i} {(i + 1) % 6}" for i in range(6)) + "\n")
    for engine in (["--engine", "cpu"], ["--device", "cpu"]):
        out = str(tmp_path / "top.tsv")
        assert cli.main(["--input", str(p), "--iters", "3", "--out", out,
                         "--top", "3", "--log-every", "0", *engine]) == 0
        assert [int(line.split("\t")[0]) for line in open(out)] == [0, 1, 2]


def test_cli_stepwise_snapshots_every_two(tmp_path, edges_file):
    path, _, _ = edges_file
    base = ["--input", path, "--iters", "6", "--log-every", "0"]
    dirs = {}
    for name, run, extra in (("port", cli.main, ["--engine", "cpu"]),
                             ("jax", jax_main, ["--engine", "cpu"]),
                             ("torch", cli.main, ["--device", "cpu"]),
                             ("every1", cli.main, ["--device", "cpu"])):
        d = dirs[name] = str(tmp_path / name)
        every = "1" if name == "every1" else "2"
        assert run(base + extra + ["--snapshot-dir", d, "--snapshot-every",
                                   every]) == 0
    names = ["ranks_iter2.npz", "ranks_iter4.npz", "ranks_iter6.npz"]
    for name in ("port", "jax", "torch"):
        assert sorted(f for f in os.listdir(dirs[name])
                      if f.endswith(".npz")) == names
    for f in names:
        a = np.load(os.path.join(dirs["port"], f))["ranks"]
        b = np.load(os.path.join(dirs["jax"], f))["ranks"]
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
        c = np.load(os.path.join(dirs["torch"], f))["ranks"]
        d = np.load(os.path.join(dirs["every1"], f))["ranks"]
        np.testing.assert_array_equal(c, d)


def test_cli_host_mem_cap_external_build(tmp_path, edges_file):
    path, _, _ = edges_file
    base = ["--input", path, "--iters", "4", "--log-every", "0",
            "--dtype", "float64", "--device", "cpu"]
    a, b = str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")
    assert cli.main(base + ["--out", a]) == 0
    s = cli.run(base + ["--host-mem-cap-gb", "1", "--out", b])
    assert s["sort_route"] == "external"
    assert open(a).read() == open(b).read()
    ours, theirs = _both(tmp_path, ["--input", path, "--iters", "4",
                                    "--log-every", "0", "--engine", "cpu",
                                    "--host-mem-cap-gb", "1"], "cap")
    assert ours == theirs


def test_cli_host_mem_cap_incompatible_combos(tmp_path, edges_file):
    path, _, _ = edges_file
    with pytest.raises(SystemExit, match="host-mem-cap-gb"):
        cli.main(["--synthetic", "rmat:8", "--host-mem-cap-gb", "1",
                  "--device", "cpu"])
    crawl = str(tmp_path / "c.tsv")
    open(crawl, "w").write(
        'http://a\t{"content":{"links":[{"type":"a","href":"http://b"}]}}\n')
    with pytest.raises(SystemExit, match="native"):
        cli.main(["--input", crawl, "--host-mem-cap-gb", "1",
                  "--no-native-ingest", "--device", "cpu"])
    s = cli.run(["--input", crawl, "--host-mem-cap-gb", "1", "--log-every",
                 "0", "--device", "cpu"])
    assert (s["sort_route"], s["ingest_route"]) == ("external", "native")
    with pytest.raises(SystemExit, match="128 MiB"):
        cli.main(["--input", crawl, "--host-mem-cap-gb", "0.0625",
                  "--device", "cpu"])


def test_cli_empty_input_host_build_clean_error(tmp_path):
    p = str(tmp_path / "empty.txt")
    open(p, "w").close()
    with pytest.raises(SystemExit, match="empty graph"):
        cli.main(["--input", p, "--log-every", "0", "--device", "cpu"])
    with pytest.raises(SystemExit, match="empty graph"):
        jax_main(["--input", p, "--log-every", "0"])


def test_cli_crawl_linkless_crawled_page_carries_no_dangling_mass(tmp_path):
    """The host half of tests/test_cli.py:149: http://c/ is crawled and
    linkless (no dangling mass), http://d/ never crawled (dangling)."""
    from pagerank_tpu_torch.ingest import write_sequence_file
    from pagerank_tpu_torch.utils.metrics import oracle_l1

    records = [
        ("http://a/", crawl_meta(["http://b/", "http://d/", "http://b/"])),
        ("http://b/", crawl_meta(["http://a/", "http://c/"])),
        ("http://c/", crawl_meta([])),
    ]
    seg = tmp_path / "seg"
    seg.mkdir()
    write_sequence_file(str(seg / "metadata-00000"), records[:2])
    write_sequence_file(str(seg / "metadata-00001"), records[2:],
                        compression="block")
    base = ["--input", str(seg), "--iters", "6", "--log-every", "0"]
    ours, theirs = _both(tmp_path, base + ["--engine", "cpu"], "seg")
    assert ours == theirs
    for extra in ([], ["--no-native-ingest", "--ingest-workers", "1"],
                  ["--ingest-workers", "1"]):
        s = cli.run(base + ["--device", "cpu", *extra])
        g, ids = s["graph"], s["ids"]
        assert s["format"] == "seqfile"
        assert s["ingest_route"] == ("native" if not extra else "python")
        assert ids.names == ["http://a/", "http://b/", "http://d/",
                             "http://c/"]
        assert g.dangling_mask.tolist() == [False, False, True, False]
        assert g.out_degree.tolist() == [2, 2, 0, 0]
        f64 = {line.split("\t")[0]: float(line.split("\t")[1])
               for line in ours.splitlines()}
        want = np.array([f64[u] for u in ids.names])
        # f32 storage against the f64 oracle: the reference's f32 gate
        assert oracle_l1(s["ranks"], want)[2] < 1e-6


def test_cli_robustness_flags_reach_the_solve_loop(tmp_path, edges_file):
    from pagerank_tpu_torch import SolverHealthError

    path, _, _ = edges_file
    base = ["--input", path, "--iters", "4", "--device", "cpu",
            "--log-every", "0"]
    # reference semantics grows the mass ~x per step: a 1e-9 drift bound
    # trips at the second step, with nothing to roll back to
    with pytest.raises(SolverHealthError, match="mass_tol"):
        cli.run(base + ["--mass-tol", "1e-9"])
    s = cli.run(base + ["--mass-tol", "1e-9", "--no-health-checks"])
    assert s["iterations"] == 4
    with pytest.raises(SolverHealthError, match="budget \\(0\\)"):
        cli.run(base + ["--mass-tol", "1e-9", "--max-rollbacks", "0",
                        "--snapshot-dir", str(tmp_path / "sd")])
    assert s["engine"].config.robustness.max_rollbacks == 3


def test_cli_engine_cpu_runs_without_a_card(tmp_path, edges_file,
                                           monkeypatch):
    path, _, _ = edges_file
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = cli.run(["--input", path, "--iters", "3", "--engine", "cpu",
                 "--log-every", "0"])
    assert s["form"] == "cpu_f64" and s["ranks"].dtype == np.float64
    assert s["ingest_route"] == "native" and s["format"] == "edgelist"


def test_cli_directory_without_seq_magic_is_refused(tmp_path):
    d = tmp_path / "notseg"
    d.mkdir()
    (d / "part-0").write_text("0 1\n")
    with pytest.raises(SystemExit, match="no SEQ magic"):
        cli.main(["--input", str(d), "--device", "cpu"])
