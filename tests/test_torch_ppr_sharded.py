"""PPR and its daemon over gloo process groups on the CPU.

``PprTorchEngine`` at world 1, 2 and 4 (spawned ranks,
``pagerank_tpu_torch/testing/ppr_group.py:run_engine_cases``) against
``PprJaxEngine(num_devices=N)`` on the 8 fake CPU devices of
``tests/conftest.py`` and the f64 oracle, at the gates of
``tests/test_torch_ppr.py:60-62`` (1e-12 at f64/f64, 3e-7 at f32 over
f64 sums; f32 over f32 sums at ``rtol`` 1e-5 against JAX, as
``test_topk_ordering_f32``): both dangling modes, an R-MAT graph whose
slot rows split blocks between the ranks' shares, the dangling-heavy
graph of ``tests/test_ppr.py:132`` and a chunk narrower than the batch.
A group of one runs the mesh path and is ``torch.equal`` to the
one-device engine; every rank returns the same answer, and the solve's
only collective is one ``all_reduce`` an iteration. Then the CLI's
``--ppr-sources --num-devices 2``, a three-rank daemon whose member 2
is SIGKILLed mid-batch (``serve_plan``, ``ProcessKillPlan(rank=2)``),
and ``python -m pagerank_tpu_torch.serve --num-devices 2`` over HTTP to
its SIGTERM drain.

Each world size runs ONE spawned group a session, shared by the xdist
workers under a file lock, as ``tests/test_torch_sharded.py`` does.
"""

import contextlib
import fcntl
import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import pagerank_tpu
from pagerank_tpu.engines import ppr as jax_ppr

import pagerank_tpu_torch
from pagerank_tpu_torch import cli
from pagerank_tpu_torch.engines.ppr import PprTorchEngine
from pagerank_tpu_torch.parallel import distributed
from pagerank_tpu_torch.testing.faults import ProcessKillPlan
from pagerank_tpu_torch.utils.config import PageRankConfig
from pagerank_tpu_torch.utils.synth import rmat_edges

ITERS = 15
F64 = dict(dtype="float64", accum_dtype="float64")
F32W = dict(dtype="float32", accum_dtype="float64")
F32 = dict(dtype="float32", accum_dtype="float32")
SOURCES = [1, 7, 42, 99, 500, 1000, 7]
HEAVY_SOURCES = [4, 57, 119]
#: name: (graph, precision, dangling_to, tolerance against the oracle).
CASES = {
    "rmat64src": ("rmat", F64, "source", 1e-12),
    "rmat64uni": ("rmat", F64, "uniform", 1e-12),
    "rmat32wsrc": ("rmat", F32W, "source", 3e-7),
    "rmat32wuni": ("rmat", F32W, "uniform", 3e-7),
    "heavy64src": ("heavy", F64, "source", 1e-12),
    "heavy64uni": ("heavy", F64, "uniform", 1e-12),
    "rmat32": ("rmat", F32, "source", None),
}
CHUNK = 3  # narrower than the batch: three chunks
WORLDS = [1, 2, 4]


def _edges():
    """The R-MAT graph (387 slot rows with the dangling block: its hub
    block 1 is split between ranks 0 and 1 at worlds 2 and 4, and ranks
    2 and 3 of world 4 hold padding alone) and the dangling-heavy one
    (only vertices 0..9 have out-edges)."""
    src, dst = rmat_edges(10, edge_factor=16, seed=1)
    rng = np.random.default_rng(21)
    return {"rmat": (src, dst, 1 << 10),
            "heavy": (rng.integers(0, 10, 400), rng.integers(0, 120, 400),
                      120)}


@pytest.fixture(scope="module")
def graphs():
    return {k: (pagerank_tpu.build_graph(s, d, n=n),
                pagerank_tpu_torch.build_graph(s, d, n=n))
            for k, (s, d, n) in _edges().items()}


def _sources(kind):
    return SOURCES if kind == "rmat" else HEAVY_SOURCES


def _shared_root(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / "torch_ppr_sharded"
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


def _run_group(tmp_path_factory, world):
    root = _shared_root(tmp_path_factory)
    d = root / f"world{world}"
    with _locked(root / f"world{world}.lock"):
        if not (d / "done").exists():
            d.mkdir(exist_ok=True)
            for kind, (s, t, n) in _edges().items():
                np.savez(d / f"{kind}.npz", src=s, dst=t, n=n)
            cases = [dict(name=name, edges=str(d / f"{kind}.npz"),
                          config=dict(num_iters=ITERS, **prec),
                          sources=_sources(kind), topk=1 << 10,
                          chunk=CHUNK, dangling_to=mode)
                     for name, (kind, prec, mode, _) in CASES.items()]
            codes = distributed.spawn_group(
                "pagerank_tpu_torch.testing.ppr_group:run_engine_cases",
                world, dict(out=str(d), device="cpu", cases=cases),
                str(d), backend="gloo", timeout_s=60.0, deadline_s=120.0)
            assert codes == [0] * world, f"rank exit codes {codes}"
            (d / "done").write_text("")
    return {name: [dict(np.load(d / f"{name}.r{r}.npz"))
                   for r in range(world)] for name in CASES}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def group(request, tmp_path_factory):
    return request.param, _run_group(tmp_path_factory, request.param)


def _full(ids, scores, n):
    out = np.zeros((len(ids), n))
    np.put_along_axis(out, ids.astype(np.int64), scores, axis=1)
    return out


_JAX = {}


def _jax(graphs, name, world):
    key = (name, world)
    if key not in _JAX:
        kind, prec, mode, _ = CASES[name]
        gj = graphs[kind][0]
        eng = jax_ppr.PprJaxEngine(pagerank_tpu.PageRankConfig(
            num_iters=ITERS, num_devices=world, **prec),
            dangling_to=mode).build(gj)
        res = eng.run(np.asarray(_sources(kind)), topk=gj.n, chunk=CHUNK)
        _JAX[key] = _full(res.topk_ids, res.topk_scores, gj.n)
    return _JAX[key]


def _one_device(graphs, name):
    """The one-device engine's answer, on one torch thread: under xdist
    the test process shares the host's cores with the other workers and
    their ranks, and a pool of threads over these small ops is far
    slower than one."""
    kind, prec, mode, _ = CASES[name]
    gt = graphs[kind][1]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return PprTorchEngine(PageRankConfig(num_iters=ITERS, **prec),
                              dangling_to=mode, device="cpu").build(gt).run(
            np.asarray(_sources(kind)), topk=gt.n, chunk=CHUNK)
    finally:
        torch.set_num_threads(threads)


def test_every_rank_returns_the_same_answer(group):
    world, res = group
    for name in CASES:
        for r in range(1, world):
            for key in ("ids", "scores"):
                np.testing.assert_array_equal(res[name][r][key],
                                              res[name][0][key])


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[3]])
def test_matches_jax_and_the_f64_oracle(group, graphs, name):
    world, res = group
    kind, _, mode, tol = CASES[name]
    gj = graphs[kind][0]
    got = _full(res[name][0]["ids"], res[name][0]["scores"], gj.n)
    oracle = jax_ppr.ppr_cpu(gj, np.asarray(_sources(kind)),
                             num_iters=ITERS, dangling_to=mode).T
    np.testing.assert_allclose(got, oracle, rtol=0, atol=tol)
    np.testing.assert_allclose(got, _jax(graphs, name, world), rtol=0,
                               atol=tol)


def test_f32_sums_match_jax(group, graphs):
    world, res = group
    n = graphs["rmat"][0].n
    got = _full(res["rmat32"][0]["ids"], res["rmat32"][0]["scores"], n)
    np.testing.assert_allclose(got, _jax(graphs, "rmat32", world),
                               rtol=1e-5, atol=1e-7)


def test_one_all_reduce_an_iteration_and_nothing_else(group):
    """World 1 calls no ``torch.distributed`` function in its solve;
    a wider group one ``all_reduce`` an iteration a chunk."""
    world, res = group
    for name, (kind, *_rest) in CASES.items():
        chunks = -(-len(_sources(kind)) // CHUNK)
        calls = json.loads(str(res[name][0]["calls"]))
        assert calls == ({} if world == 1
                         else {"all_reduce": ITERS * chunks}), (name, calls)


def test_each_rank_holds_its_share_of_the_rows(group, graphs):
    world, res = group
    lays = [json.loads(str(res["rmat64src"][r]["layout"]))
            for r in range(world)]
    assert [lay["rank"] for lay in lays] == list(range(world))
    assert {lay["world"] for lay in lays} == {world}
    assert {lay["backend"] for lay in lays} == {"gloo"}
    one = _one_device_layout(graphs)
    if world == 1:
        assert lays[0]["num_rows"] == one["num_rows"]
    else:
        assert len({lay["num_rows"] for lay in lays}) == 1
        assert sum(lay["num_rows"] for lay in lays) == lays[0]["slot_rows"]
        assert lays[0]["slot_rows"] % (world * 256) == 0
        assert lays[0]["slot_rows"] >= one["num_rows"] > lays[0]["num_rows"]


def _one_device_layout(graphs):
    return PprTorchEngine(PageRankConfig(num_iters=ITERS, **F64),
                          device="cpu").build(
        graphs["rmat"][1]).layout_info()


def test_a_group_of_one_is_torch_equal_to_one_device(tmp_path_factory,
                                                     graphs):
    res = _run_group(tmp_path_factory, 1)
    for name in CASES:
        want = _one_device(graphs, name)
        np.testing.assert_array_equal(res[name][0]["ids"], want.topk_ids)
        np.testing.assert_array_equal(res[name][0]["scores"],
                                      want.topk_scores)


def test_cli_ppr_sources_over_two_ranks(tmp_path, capfd):
    """Rank 0 alone prints the ``ppr:`` line and writes ``--out``; its
    rows are the one-device run's (f64, 1e-12; ids equal)."""
    def rows(path):
        return [line.rstrip("\n").split("\t") for line in open(path)]

    base = ["--synthetic", "rmat:9", "--device", "cpu", "--iters", "10",
            "--ppr-sources", "random:8", "--ppr-topk", "16", "--dtype",
            "float64", "--log-every", "0"]
    assert cli.main(base + ["--out", str(tmp_path / "one.tsv")]) == 0
    capfd.readouterr()
    assert cli.main(base + ["--num-devices", "2", "--out",
                            str(tmp_path / "two.tsv")]) == 0
    err = capfd.readouterr().err
    assert err.count("ppr: 8 sources") == 1 and err.count("wrote 8x16") == 1
    one, two = rows(tmp_path / "one.tsv"), rows(tmp_path / "two.tsv")
    assert len(one) == len(two) == 8 * 16
    assert [r[:2] for r in one] == [r[:2] for r in two]
    np.testing.assert_allclose([float(r[2]) for r in two],
                               [float(r[2]) for r in one], rtol=0,
                               atol=1e-12)


def test_the_daemon_survives_a_sigkilled_follower(tmp_path):
    """Three gloo ranks serve five batches of four queries; member 2
    SIGKILLs itself on receiving the third batch (dispatch 3; the
    warm-up is 0). The survivors agree on the verdict, regroup as
    [0, 1] and rank 0 re-runs the in-flight batch: it and every later
    answer is ``answered_degraded``, one rescue, nothing unsettled, and
    the answers are the one-process engine's (f64, 1e-12)."""
    src, dst = rmat_edges(10, edge_factor=8, seed=1)
    np.savez(tmp_path / "edges.npz", src=src, dst=dst, n=1 << 10)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 1 << 10, 4).tolist() for _ in range(5)]
    kill = ProcessKillPlan("serve", iteration=3, signum=9, rank=2)
    codes = distributed.spawn_group(
        "pagerank_tpu_torch.testing.ppr_group:serve_plan", 3,
        dict(edges=str(tmp_path / "edges.npz"), out=str(tmp_path),
             device="cpu", config=dict(num_iters=10, **F64),
             serve=dict(max_batch=4, topk=8, deadline_ms=60000.0,
                        cache_capacity=0, probe_timeout_s=30.0),
             batches=batches, kill=kill.to_env()[ProcessKillPlan.ENV]),
        str(tmp_path), backend="gloo", timeout_s=60.0, deadline_s=120.0,
        rescue=True)
    assert list(codes) == [0, 0, -9] and codes.lost == (2,)
    assert str(np.load(tmp_path / "follower.m1.npz")["status"]) == "stopped"
    got = np.load(tmp_path / "serve.npz")
    outcomes = got["outcomes"].tolist()
    assert outcomes == ["answered"] * 8 + ["answered_degraded"] * 12
    assert got["device_ids"].tolist() == [0, 1] and int(got["rescues"]) == 1
    counters = json.loads(str(got["counters"]))
    assert counters["serve.rescues"] == 1
    assert counters["serve.devices_lost"] == 1
    assert counters["serve.batch_reruns"] == 1
    walls = json.loads(str(got["walls"]))
    assert len(walls) == 1 and set(walls[0]) == {"roll_call", "regroup",
                                                 "rebuild", "rerun"}
    graph = pagerank_tpu_torch.build_graph(src, dst, n=1 << 10)
    want = PprTorchEngine(PageRankConfig(num_iters=10, **F64),
                          device="cpu").build(graph).run(
        np.concatenate(batches), topk=8)
    np.testing.assert_allclose(got["scores"], want.topk_scores, rtol=0,
                               atol=1e-12)


def test_serve_over_two_ranks_answers_http_and_drains_on_sigterm():
    """``python -m pagerank_tpu_torch.serve --num-devices 2 --device
    cpu``: rank 0 binds the port and answers ``/ppr`` (f32 sums in
    another order: rtol 1e-5 against the one-device engine) and
    ``/healthz`` with two devices; a SIGTERM to the launcher reaches
    rank 0, which drains, stops its follower and exits 75, the
    launcher's code."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pagerank_tpu_torch.serve", "--num-devices",
         "2", "--device", "cpu", "--port", "0", "--scale", "8", "--iters",
         "3", "--topk", "5", "--max-batch", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline()
        assert "serving PPR on http://" in line, line
        url = line.split("http://")[1].split()[0]
        with urllib.request.urlopen(f"http://{url}?source=3&k=4",
                                    timeout=60) as r:
            body = json.load(r)
        with urllib.request.urlopen(
                f"http://{url.rsplit('/', 1)[0]}/healthz", timeout=60) as r:
            health = json.load(r)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 75, err[-2000:]
    assert "drained: admission closed" in out
    assert health["devices"] == 2 and body["outcome"] == "answered"
    src, dst = rmat_edges(8, edge_factor=16, seed=0)
    want = PprTorchEngine(PageRankConfig(num_iters=3), device="cpu").build(
        pagerank_tpu_torch.build_graph(src, dst, n=1 << 8)).run(
        np.array([3]), topk=4)
    np.testing.assert_allclose(body["scores"], want.topk_scores[0],
                               rtol=1e-5, atol=0)
