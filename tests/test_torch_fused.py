"""The fused run forms of the port (``TorchEngine.run_fast``,
``run_fused``, ``run_fused_chunked``, ``run_fused_tol``,
``prepare_fused``) and the CLI's ``--fused`` on the CPU, against the JAX
package's fused forms and CLI on the same inputs (made from numpy
seeds), and against the port's own stepwise loop.

Tolerances: against the stepwise loop of the port, bit-equal (the same
launch and update queued in the same order; only the host syncs go);
against JAX in f64, ``atol 1e-13`` on the toy graph (the JAX package's
own bound between its stepwise and fused runs,
``tests/test_jax_engine.py:89-110``) and ``1e-12`` on random and R-MAT
graphs (the port's engine tests); f32 against JAX by the mass-normalised
L1 gate (1e-5; bf16 windows 1e-3, ``tests/test_torch_partitioned.py``);
the CLIs in f32 as ``tests/test_torch_cli.py`` holds them (per vertex
5e-4, mean 1e-4).
"""

import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import pagerank_tpu
from pagerank_tpu import JaxTpuEngine
from pagerank_tpu.cli import main as jax_main
from pagerank_tpu.ingest import records_to_graph

import pagerank_tpu_torch
from pagerank_tpu_torch import PageRankConfig, TorchEngine, cli, convert
from pagerank_tpu_torch.ops import ell_spmv, ell_spmv_partitioned
from pagerank_tpu_torch.utils.synth import rmat_edges
from tests.test_cpu_engine import TOY_RECORDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = dict(dtype="float64", accum_dtype="float64")
JAX_FIELDS = ("num_iters", "damping", "semantics", "dtype", "accum_dtype",
              "tol", "partition_span", "stream_dtype", "vertex_sharded",
              "halo_exchange", "vs_bounded")


def _jax(cfg, gj, **kw):
    return JaxTpuEngine(pagerank_tpu.PageRankConfig(
        **{f: getattr(cfg, f) for f in JAX_FIELDS}, num_devices=1,
        **kw)).build(gj)


def _toy():
    gj, _ = records_to_graph(TOY_RECORDS)
    return gj, convert.graph_from_arrays(
        gj.n, gj.src, gj.dst, gj.out_degree, gj.in_degree, gj.dangling_mask,
        gj.zero_in_mask, gj.edge_weight)


def _random(n=2000, e=60000, seed=5):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return (pagerank_tpu.build_graph(src, dst, n=n),
            pagerank_tpu_torch.build_graph(src, dst, n=n))


def _rmat(scale=10, seed=1):
    src, dst = rmat_edges(scale, edge_factor=8, seed=seed)
    n = 1 << scale
    return (pagerank_tpu.build_graph(src, dst, n=n),
            pagerank_tpu_torch.build_graph(src, dst, n=n))


def _eng(cfg, gt):
    return TorchEngine(cfg, device="cpu").build(gt)


def _stepwise(cfg, gt, iters=None):
    """The port's stepwise run, with each step's (delta, mass)."""
    eng, infos = _eng(cfg, gt), []
    r = eng.run(iters, on_iteration=lambda i, info: infos.append(
        (info["l1_delta"], info["dangling_mass"])))
    return r, np.array(infos).reshape(-1, 2), eng


def _traces(eng):
    m = eng.last_run_metrics
    return np.stack([m["l1_delta"].numpy(), m["dangling_mass"].numpy()], 1)


def _l1(a, b):
    return float(np.abs(a - b).sum() / np.abs(b).sum())


# -- the engine against JAX and its own stepwise loop -------------------------


def test_run_fused_equals_stepwise_and_jax():
    gj, gt = _toy()
    cfg = PageRankConfig(num_iters=10, **F64)
    r_step, infos, _ = _stepwise(cfg, gt)
    eng = _eng(cfg, gt)
    r = eng.run_fused()
    np.testing.assert_array_equal(r, r_step)
    assert eng.iteration == 10
    m = eng.last_run_metrics
    assert m["l1_delta"].shape == (10,) and m["dangling_mass"].shape == (10,)
    np.testing.assert_array_equal(_traces(eng), infos)
    jeng = _jax(cfg, gj)
    np.testing.assert_allclose(r, jeng.run_fused(), rtol=0, atol=1e-13)
    jm = jeng.last_run_metrics
    np.testing.assert_allclose(
        _traces(eng), np.stack([np.asarray(jm["l1_delta"]),
                                np.asarray(jm["dangling_mass"])], 1),
        rtol=0, atol=1e-13)
    # run_fast: the same queue, one fence.
    fast = _eng(cfg, gt)
    np.testing.assert_array_equal(fast.run_fast(), r_step)
    assert fast.iteration == 10
    # A run resumed after four steps queues only the remainder.
    resumed = _eng(cfg, gt)
    resumed.run(num_iters=4)
    np.testing.assert_array_equal(resumed.run_fused(), r_step)
    np.testing.assert_array_equal(_traces(resumed), infos[4:])
    # Complete: a no-op that keeps the traces.
    before = _traces(eng)
    np.testing.assert_array_equal(eng.run_fused(), r)
    np.testing.assert_array_equal(_traces(eng), before)


def test_run_fused_zero_iters():
    gj, gt = _toy()
    eng = _eng(PageRankConfig(num_iters=0, **F64), gt)
    assert eng.prepare_fused() == 0
    r = eng.run_fused()
    assert r.shape == (gt.n,)
    assert eng.last_run_metrics["l1_delta"].shape == (0,)
    jeng = _jax(PageRankConfig(num_iters=0, **F64), gj)
    np.testing.assert_array_equal(r, jeng.run_fused())


def test_prepare_fused_leaves_the_state_as_it_was():
    """The throwaway step runs on a copy: the run after it is the plain
    run's, bit for bit, and the count is the remaining iterations."""
    _, gt = _random()
    cfg = PageRankConfig(num_iters=6)
    r_step, _, _ = _stepwise(cfg, gt)
    eng = _eng(cfg, gt)
    eng.run(num_iters=2)
    assert eng.prepare_fused(tol=1e-9, every=3) == 4
    assert eng.iteration == 2
    np.testing.assert_array_equal(eng.run_fused(), r_step)


def test_run_fused_tol_matches_host_early_stop_and_jax():
    gj, gt = _toy()
    cfg = PageRankConfig(num_iters=50, tol=1e-8, **F64)
    r_host, _, host = _stepwise(cfg, gt)
    fused = _eng(cfg, gt)
    r = fused.run_fused_tol()
    assert fused.iteration == host.iteration < 50
    np.testing.assert_array_equal(r, r_host)
    m = fused.last_run_metrics
    assert m["l1_delta"].shape == (1,) and m["dangling_mass"].shape == (1,)
    assert float(m["l1_delta"][0]) <= 1e-8
    jeng = _jax(cfg, gj)
    np.testing.assert_allclose(r, jeng.run_fused_tol(), rtol=0, atol=1e-13)
    assert jeng.iteration == fused.iteration
    np.testing.assert_allclose(m["l1_delta"].numpy(),
                               np.asarray(jeng.last_run_metrics["l1_delta"]),
                               rtol=0, atol=1e-13)
    # Budget exhaustion: a tight tol runs to the budget.
    capped = _eng(cfg.replace(num_iters=3, tol=1e-30), gt)
    capped.run_fused_tol()
    assert capped.iteration == 3


@pytest.mark.parametrize("chunk", [1, 3, 8, 64])
def test_run_fused_tol_stops_at_the_host_iteration_for_any_chunk(
        monkeypatch, chunk):
    """The masked steps after the stop change nothing: the stop
    iteration, the ranks and the final trace are the host-checked run's
    whatever the chunk, and a run continued past the stop is the
    stepwise run continued from it."""
    _, gt = _random(300, 2400, 5)
    cfg = PageRankConfig(num_iters=200, semantics="textbook", tol=1e-9,
                         **F64)
    r_host, infos, host = _stepwise(cfg, gt)
    monkeypatch.setattr(TorchEngine, "FUSED_TOL_CHUNK", chunk)
    eng = _eng(cfg, gt)
    np.testing.assert_array_equal(eng.run_fused_tol(), r_host)
    assert eng.iteration == host.iteration
    np.testing.assert_array_equal(_traces(eng), infos[-1:])
    np.testing.assert_array_equal(eng.run(host.iteration + 3),
                                  host.run(host.iteration + 3))


def test_run_fused_chunked_traces_boundaries_and_thunk():
    gj, gt = _toy()
    cfg = PageRankConfig(num_iters=10, **F64)
    r_step, infos, _ = _stepwise(cfg, gt)
    at = {i: _stepwise(cfg, gt, i)[0] for i in (3, 6, 9)}
    eng = _eng(cfg, gt)
    seen = []

    def on_chunk(done, thunk, traces):
        seen.append((done, len(traces[0])))
        if done in at:
            np.testing.assert_array_equal(eng.decode_ranks(thunk()), at[done])

    np.testing.assert_array_equal(
        eng.run_fused_chunked(every=3, on_chunk=on_chunk), r_step)
    assert seen == [(3, 3), (6, 3), (9, 3), (10, 1)]
    np.testing.assert_array_equal(_traces(eng), infos)
    jeng = _jax(cfg, gj)
    np.testing.assert_allclose(jeng.run_fused_chunked(every=3), r_step,
                               rtol=0, atol=1e-13)
    # Resumed at 4: boundaries on the absolute grid of 3.
    resumed, seen = _eng(cfg, gt), []
    resumed.run(num_iters=4)
    resumed.run_fused_chunked(every=3, on_chunk=on_chunk)
    assert seen == [(6, 2), (9, 3), (10, 1)]
    assert resumed.last_run_metrics["l1_delta"].shape == (6,)
    # every=0: one chunk; a truthy return stops after its boundary.
    one = _eng(cfg, gt)
    one.run_fused_chunked(every=0)
    assert one.last_run_metrics["l1_delta"].shape == (10,)
    stop = _eng(cfg, gt)
    stop.run_fused_chunked(every=4, on_chunk=lambda d, t, tr: d >= 4)
    assert stop.iteration == 4
    with pytest.raises(ValueError, match="every must be >= 0"):
        _eng(cfg, gt).run_fused_chunked(every=-2)


def test_run_fused_chunked_tol_stops_at_a_boundary():
    gj, gt = _toy()
    cfg = PageRankConfig(num_iters=60, **F64)
    eng = _eng(cfg, gt)
    eng.run_fused_chunked(every=5, tol=1e-6)
    d = eng.last_run_metrics["l1_delta"].numpy()
    assert 0 < eng.iteration < 60 and eng.iteration % 5 == 0
    assert len(d) == eng.iteration and d[-1] <= 1e-6 < d[-6]
    jeng = _jax(cfg, gj)
    jeng.run_fused_chunked(every=5, tol=1e-6)
    assert jeng.iteration == eng.iteration


@pytest.mark.parametrize("stream", ["", "bfloat16"])
def test_partitioned_fused_forms(stream):
    """K2's form (f32 and bf16 windows): every fused form bit-equal to
    the stepwise run, and run_fused within the gate of JAX's
    partitioned run_fused (``tests/test_partitioned.py:211``)."""
    gj, gt = _random()
    cfg = PageRankConfig(num_iters=8, partition_span=512,
                         stream_dtype=stream)
    r_step, infos, _ = _stepwise(cfg, gt)
    eng = _eng(cfg, gt)
    assert eng.layout_info()["form"] == "pallas_partitioned"
    np.testing.assert_array_equal(eng.run_fused(), r_step)
    np.testing.assert_array_equal(_traces(eng), infos)
    np.testing.assert_array_equal(
        _eng(cfg.replace(tol=1e-12), gt).run_fused_tol(), r_step)
    np.testing.assert_array_equal(
        _eng(cfg, gt).run_fused_chunked(every=3), r_step)
    np.testing.assert_array_equal(_eng(cfg, gt).run_fast(), r_step)
    jr = _jax(cfg, gj).run_fused()
    assert _l1(r_step, np.asarray(jr)) <= (1e-3 if stream else 1e-5)


@pytest.mark.parametrize("form", [
    dict(vertex_sharded=True),
    dict(vertex_sharded=True, halo_exchange=True),
    dict(vertex_sharded=True, vs_bounded=True),
], ids=["vertex_sharded", "vs_halo", "vs_bounded"])
def test_world1_sharded_fused_forms(form):
    """The vertex-sharded forms at world 1 (no group: every collective
    is the identity): each fused form bit-equal to the stepwise run, and
    run_fused within f64 rounding of JAX's at one device."""
    gj, gt = _rmat()
    cfg = PageRankConfig(num_iters=6, **F64, **form)
    r_step, infos, _ = _stepwise(cfg, gt)
    eng = _eng(cfg, gt)
    np.testing.assert_array_equal(eng.run_fused(), r_step)
    np.testing.assert_array_equal(_traces(eng), infos)
    np.testing.assert_array_equal(
        _eng(cfg.replace(tol=1e-30), gt).run_fused_tol(), r_step)
    np.testing.assert_array_equal(
        _eng(cfg, gt).run_fused_chunked(every=2), r_step)
    np.testing.assert_allclose(r_step, _jax(cfg, gj).run_fused(), rtol=0,
                               atol=1e-12)


_SYNCS = ("item", "__float__", "__int__", "__bool__", "cpu", "numpy",
          "tolist")


@pytest.fixture
def syncs(monkeypatch):
    """Counts every tensor-to-host conversion made while it is armed."""
    count = {"n": 0, "armed": False}
    for name in _SYNCS:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, **k):
            if count["armed"]:
                count["n"] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    orig_nonzero = torch.nonzero

    def nonzero(*a, **k):
        if count["armed"]:
            count["n"] += 1
        return orig_nonzero(*a, **k)

    monkeypatch.setattr(torch, "nonzero", nonzero)
    # On the CPU the kernels' plain versions stand in for the launches
    # (on a card a bound launch is one ctypes call); their own host
    # conversions are not the step's.
    for mod, name in ((ell_spmv, "ell_contrib"),
                      (ell_spmv_partitioned, "ell_contrib_partitioned")):
        def unarmed(*a, _fn=getattr(mod, name), **k):
            armed, count["armed"] = count["armed"], False
            try:
                return _fn(*a, **k)
            finally:
                count["armed"] = armed

        monkeypatch.setattr(mod, name, unarmed)
    return count


@pytest.mark.parametrize("form", [
    dict(), dict(partition_span=512), dict(kernel="coo"),
    dict(vertex_sharded=True), dict(vertex_sharded=True, halo_exchange=True),
    dict(vertex_sharded=True, vs_bounded=True),
], ids=["flat", "partitioned", "coo", "vertex_sharded", "vs_halo",
        "vs_bounded"])
def test_device_step_and_the_fused_queues_make_no_host_sync(syncs, form):
    """``_device_step`` converts nothing to the host on any form; a
    fused run syncs only where it reads: none in run_fused's queue, one
    flag a chunk in run_fused_tol (and the count at the end), one delta
    a boundary in run_fused_chunked with a tol."""
    _, gt = _random()
    eng = _eng(PageRankConfig(num_iters=20, **form), gt)
    eng.ranks = lambda: None  # the final fetch is the caller's
    syncs["armed"] = True
    eng._device_step()
    assert syncs["n"] == 0
    eng.run_fused(10)
    assert syncs["n"] == 0
    # A negative tol never stops (an f32 delta can reach 0).
    eng.run_fused_tol(tol=-1.0, num_iters=20)  # chunks of 8 and 2
    assert syncs["n"] == 2 + 1
    eng.iteration = 0
    eng.run_fused_chunked(every=5, tol=-1.0)
    assert syncs["n"] == 3 + 4


def test_step_is_the_device_step_and_two_fetches():
    _, gt = _random()
    cfg = PageRankConfig(num_iters=5)
    a, b = _eng(cfg, gt), _eng(cfg, gt)
    for _ in range(5):
        info = a.step()
        d, m = b._device_step()
        assert info == {"l1_delta": float(d), "dangling_mass": float(m)}
    np.testing.assert_array_equal(a.ranks(), b.ranks())


# -- the CLI against the JAX CLI ----------------------------------------------


@pytest.fixture
def edges(tmp_path):
    rng = np.random.default_rng(31)
    p = tmp_path / "e.txt"
    p.write_text("# src dst\n" + "".join(
        f"{s} {d}\n" for s, d in zip(rng.integers(0, 400, 3000),
                                     rng.integers(0, 400, 3000))))
    return str(p)


def _port(*argv):
    return cli.run([*argv, "--device", "cpu", "--log-every", "0"])


def _tsv(path):
    ids, ranks = np.loadtxt(path, delimiter="\t", unpack=True)
    return ids.astype(np.int64), ranks


def _jsonl(path):
    return [json.loads(line) for line in open(path)]


def _npz_bytes(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(".npz")}


def test_cli_fused_matches_stepwise_and_the_jax_cli(edges, tmp_path):
    out_s, out_f, out_j = (str(tmp_path / n) for n in ("s.tsv", "f.tsv",
                                                         "j.tsv"))
    jsonl, report = str(tmp_path / "m.jsonl"), str(tmp_path / "r.json")
    _port("--input", edges, "--iters", "8", "--out", out_s)
    s = _port("--input", edges, "--iters", "8", "--fused", "--out", out_f,
              "--jsonl", jsonl, "--run-report", report)
    assert s["iterations"] == 8 and s["step_seconds"] == []
    assert open(out_f).read() == open(out_s).read()
    recs = _jsonl(jsonl)
    assert len(recs) == 8 and all("l1_delta" in r for r in recs)
    assert [r["iter"] for r in recs] == list(range(8))
    rep = json.load(open(report))
    assert rep["fused"] is True and rep["summary"]["iters"] == 8
    assert jax_main(["--input", edges, "--num-devices", "1", "--iters", "8",
                     "--fused", "--log-every", "0", "--out", out_j]) == 0
    id_a, ra = _tsv(out_f)
    id_b, rb = _tsv(out_j)
    np.testing.assert_array_equal(id_a, id_b)
    np.testing.assert_allclose(ra, rb, rtol=0, atol=5e-4)
    assert np.abs(ra - rb).sum() / len(ra) < 1e-4


def test_cli_fused_snapshots_byte_equal_to_stepwise(edges, tmp_path):
    """--snapshot-dir runs fused chunks with a snapshot at each
    boundary, through the async writer and through --sync-io: the same
    files, byte for byte, as the stepwise run; every iteration's trace
    with ``timing == "averaged"``."""
    ck = {k: str(tmp_path / k) for k in ("f", "fsync", "s")}
    jsonl = str(tmp_path / "m.jsonl")
    base = ("--input", edges, "--iters", "6", "--snapshot-every", "2")
    _port(*base, "--fused", "--snapshot-dir", ck["f"], "--jsonl", jsonl)
    _port(*base, "--fused", "--snapshot-dir", ck["fsync"], "--sync-io")
    _port(*base, "--snapshot-dir", ck["s"])
    files = _npz_bytes(ck["s"])
    assert list(files) == ["ranks_iter2.npz", "ranks_iter4.npz",
                           "ranks_iter6.npz"]
    assert _npz_bytes(ck["f"]) == files == _npz_bytes(ck["fsync"])
    recs = _jsonl(jsonl)
    assert len(recs) == 6 and all(r["timing"] == "averaged" for r in recs)


def test_cli_fused_resume_lands_on_the_absolute_grid(edges, tmp_path):
    ck = str(tmp_path / "ck")
    out_f, out_s = str(tmp_path / "f.tsv"), str(tmp_path / "s.tsv")
    _port("--input", edges, "--iters", "3", "--fused", "--snapshot-dir", ck)
    s = _port("--input", edges, "--iters", "7", "--fused", "--snapshot-dir",
              ck, "--resume", "--snapshot-every", "2", "--out", out_f)
    assert s["resumed_from"] == 3
    post = {n for n in os.listdir(ck) if n.endswith(".npz")}
    assert {"ranks_iter4.npz", "ranks_iter6.npz"} <= post
    assert "ranks_iter5.npz" not in post and "ranks_iter7.npz" not in post
    _port("--input", edges, "--iters", "7", "--out", out_s)
    assert open(out_f).read() == open(out_s).read()


def test_cli_fused_remainder_chunk_follows_the_stepwise_cadence(edges,
                                                                tmp_path):
    """An iteration count off the cadence: the final remainder chunk
    writes no off-cadence snapshot; a negative cadence is refused."""
    ck_f, ck_s = str(tmp_path / "f"), str(tmp_path / "s")
    _port("--input", edges, "--iters", "7", "--fused", "--snapshot-dir",
          ck_f, "--snapshot-every", "2")
    _port("--input", edges, "--iters", "7", "--snapshot-dir", ck_s,
          "--snapshot-every", "2")
    files = _npz_bytes(ck_s)
    assert list(files) == ["ranks_iter2.npz", "ranks_iter4.npz",
                           "ranks_iter6.npz"]
    assert _npz_bytes(ck_f) == files
    with pytest.raises(SystemExit, match="snapshot_every"):
        _port("--input", edges, "--iters", "4", "--fused", "--snapshot-dir",
              ck_f, "--snapshot-every", "-2")


def test_cli_fused_chunked_tol_stops_at_a_boundary(edges, tmp_path):
    jsonl = str(tmp_path / "m.jsonl")
    _port("--input", edges, "--iters", "60", "--fused", "--tol", "1e-3",
          "--snapshot-dir", str(tmp_path / "ck"), "--snapshot-every", "5",
          "--jsonl", jsonl)
    recs = _jsonl(jsonl)
    assert 0 < len(recs) < 60 and len(recs) % 5 == 0
    assert recs[-1]["l1_delta"] <= 1e-3


def test_cli_fused_tol_records_the_final_iteration(edges, tmp_path, capsys):
    """The device-tol form: one record (the stop's), the true iteration
    count in the ``done:`` line, and the stop the JAX CLI's."""
    out, jsonl = str(tmp_path / "r.tsv"), str(tmp_path / "m.jsonl")
    argv = ["--input", edges, "--iters", "100", "--fused", "--tol", "1e-7",
            "--dtype", "float64", "--accum-dtype", "float64"]
    _port(*argv, "--out", out, "--jsonl", jsonl)
    recs = _jsonl(jsonl)
    assert len(recs) == 1 and recs[0]["l1_delta"] <= 1e-7
    assert recs[0]["iter"] < 99 and recs[0]["timing"] == "averaged"
    m = re.search(r"done: (\d+) iters", capsys.readouterr().err)
    assert m and 1 < int(m.group(1)) == recs[0]["iter"] + 1
    j_out, j_jsonl = str(tmp_path / "j.tsv"), str(tmp_path / "j.jsonl")
    assert jax_main([*argv, "--num-devices", "1", "--log-every", "0",
                     "--out", j_out, "--jsonl", j_jsonl]) == 0
    assert _jsonl(j_jsonl)[0]["iter"] == recs[0]["iter"]
    np.testing.assert_allclose(_tsv(out)[1], _tsv(j_out)[1], rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("argv,says", [
    (["--fused", "--dump-text-dir", "d"], "--dump-text-dir need host"),
    (["--fused", "--ppr-sources", "0"], "--ppr-sources need host"),
    (["--fused", "--engine", "cpu"], "--fused requires --engine torch"),
    (["--fused", "--stall-action", "rescue", "--stall-timeout", "60"],
     "incompatible with --fused"),
    (["--fused", "--sdc-check-every", "1"], "incompatible with --fused"),
], ids=["dump", "ppr", "engine", "rescue", "sdc"])
def test_cli_fused_refusals_exit_2_before_the_load(argv, says, capsys,
                                                   monkeypatch, tmp_path):
    """Each exits 2 with the JAX CLI's message, before any graph work."""
    monkeypatch.chdir(tmp_path)

    def no_load(*a, **k):
        raise AssertionError("the graph was loaded")

    monkeypatch.setattr(cli, "load_graph", no_load)
    with pytest.raises(SystemExit) as e:
        cli.main(["--synthetic", "rmat:6", "--device", "cpu", *argv])
    assert e.value.code == 2
    assert says in capsys.readouterr().err


def test_cli_fused_sigkill_then_resume(tmp_path):
    """kill -9 during a fused chunked run (``tests/test_hardening.py:60``):
    the process dies at its third snapshot, the atomic snapshots before
    it resume, and the resumed fused run ends on the uninterrupted
    stepwise run's bytes. The kill is delivered by the victim itself
    (its snapshot save raises SIGKILL), so it lands at one point."""
    rng = np.random.default_rng(23)
    edges = tmp_path / "e.txt"
    edges.write_text("".join(f"{s} {d}\n" for s, d in zip(
        rng.integers(0, 3000, 30000), rng.integers(0, 3000, 30000))))
    snaps, ctrl = tmp_path / "snaps", tmp_path / "ctrl"
    base = ["--input", str(edges), "--iters", "12", "--dtype", "float64",
            "--accum-dtype", "float64", "--device", "cpu", "--log-every",
            "0"]
    victim = (
        "import os, signal, sys\n"
        "from pagerank_tpu_torch import cli\n"
        "from pagerank_tpu_torch.utils.snapshot import Snapshotter\n"
        "save = Snapshotter.save\n"
        "def dying(self, it, ranks):\n"
        "    if it == 3:\n"
        "        os.kill(os.getpid(), signal.SIGKILL)\n"
        "    return save(self, it, ranks)\n"
        "Snapshotter.save = dying\n"
        "sys.exit(cli.main(sys.argv[1:]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = [*base, "--fused", "--snapshot-dir", str(snaps)]
    r = subprocess.run([sys.executable, "-c", victim, *run], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == -signal.SIGKILL, r.stderr[-500:]
    assert sorted(os.listdir(snaps)) == ["ranks_iter1.npz", "ranks_iter2.npz"]
    r = subprocess.run(
        [sys.executable, "-m", "pagerank_tpu_torch.cli", *run, "--resume"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-500:]
    assert "resumed from iteration 2" in r.stderr
    cli.run([*base, "--snapshot-dir", str(ctrl)])
    assert (open(snaps / "ranks_iter12.npz", "rb").read()
            == open(ctrl / "ranks_iter12.npz", "rb").read())
