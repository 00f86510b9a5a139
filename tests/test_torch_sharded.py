"""The port's sharded forms over gloo process groups of world 1, 2 and 4
on the CPU, against ``JaxTpuEngine(num_devices=N)`` on the 8 fake CPU
devices of ``tests/conftest.py``, and against the port's own
single-device engine: edge-sharded, vertex-sharded (dense), vs_halo,
vs_halo_async and vs_bounded.

Each world size runs ONE spawned group (``parallel/distributed.
spawn_group``; start method spawn, a file rendezvous, a 120 s deadline)
whose ranks import torch and the port only and run every case of
``pagerank_tpu_torch/testing/sharded.py``, writing their results to
``.npz`` files. The group runs once per test session: the first xdist
worker to need a world size runs it under a file lock, the others read
its files. The JAX engine runs here, in the test process.

Bounds are the JAX package's own: f64 ``atol 1e-12`` against one device
(``tests/test_sharding.py:20-27``), ``nulp=8`` vertex-sharded against
edge-sharded (``tests/test_vertex_sharded.py:61-63``), and the first
step from the all-ones r0 bit-equal at world 2
(``test_vertex_sharded.py:66-75``), where a sum of two partials is exact
whatever its order. f32 results are held by the mass-normalised L1 gate
(1e-5; bf16 windows 1e-3, as ``tests/test_torch_partitioned.py``).
What holds bitwise at world 4 is asserted as measured: the first step,
and f32 ranks summed in f64 over whole runs. vs_halo's f32 ranks equal
the dense form's bit for bit (the JAX pin, ``tests/test_halo.py:199``):
K1 reads the same z bits. The async form runs on a second scale-10
graph (edge factor 32, 577 slot rows) whose rows the JAX engine at lane
group 1 (the port's packing) shares over its devices as the port does
over its ranks at every world here (its chunk rule and the port's
256-row unit agree for 512-1024 rows): both build the same halo plan,
stale the same boundary reads, and a lag-1 run agrees with JAX's to f32
rounding (the f32 gate, 1e-5).
"""

import contextlib
import fcntl
import json
import os

import numpy as np
import pytest

import pagerank_tpu
from pagerank_tpu import JaxTpuEngine

import pagerank_tpu_torch
from pagerank_tpu_torch import cli
from pagerank_tpu_torch.engines.torch_engine import TorchEngine
from pagerank_tpu_torch.parallel import comms, distributed
from pagerank_tpu_torch.parallel import mesh as mesh_lib
from pagerank_tpu_torch.utils.config import PageRankConfig
from pagerank_tpu_torch.utils.snapshot import Snapshotter
from pagerank_tpu_torch.utils.synth import rmat_edges

SCALE, ITERS = 10, 8
F64 = dict(dtype="float64", accum_dtype="float64")
CASES = {
    "flat64": F64,
    "vs64": dict(F64, vertex_sharded=True),
    "flat32w": dict(dtype="float32", accum_dtype="float64"),
    "vs32w": dict(dtype="float32", accum_dtype="float64",
                  vertex_sharded=True),
    "part32": dict(partition_span=256),
    "partbf16": dict(partition_span=256, stream_dtype="bfloat16"),
    "flat64sdc": dict(F64, sdc_check_every=1),
    "vs64sdc": dict(F64, vertex_sharded=True, sdc_check_every=1),
    "part32sdc": dict(partition_span=256, sdc_check_every=1),
    "vs64resume": dict(F64, vertex_sharded=True),
    "vs64tb": dict(F64, vertex_sharded=True, semantics="textbook"),
    "vs32": dict(vertex_sharded=True),
    "halo32": dict(vertex_sharded=True, halo_exchange=True),
    "halo32head": dict(vertex_sharded=True, halo_exchange=True,
                       halo_head=256),
    "halo32w": dict(dtype="float32", accum_dtype="float64",
                    vertex_sharded=True, halo_exchange=True),
    "halo64": dict(F64, vertex_sharded=True, halo_exchange=True),
    "halo32b": dict(vertex_sharded=True, halo_exchange=True),
    "async32": dict(vertex_sharded=True, halo_exchange=True, halo_async=True,
                    halo_async_min_gain=0.0),
    "async32sdc": dict(vertex_sharded=True, halo_exchange=True,
                       halo_async=True, halo_async_min_gain=0.0,
                       sdc_check_every=1),
    "lag0": dict(vertex_sharded=True, halo_exchange=True, halo_async=True,
                 stale_max_lag=0),
    "bounded64": dict(F64, vertex_sharded=True, vs_bounded=True),
    "bounded64resume": dict(F64, vertex_sharded=True, vs_bounded=True),
    "bounded64sdc": dict(F64, vertex_sharded=True, vs_bounded=True,
                         sdc_check_every=1),
}
#: A tol the async form reaches before its last step of ITERS in textbook
#: semantics on the second graph at every world: at step 4 on one rank
#: (deltas 0.955, 0.248, 0.052, 0.011), 6 at world 2 (lag 1: ..., 0.034,
#: 0.009), 7 at world 4 (..., 0.033, 0.015). Its fused tol run masks the
#: steps after the stop.
CASES["async32tol"] = dict(CASES["async32"], semantics="textbook",
                           tol=2e-2)
#: The fused cases: each form's stepwise case run by each fused form
#: (``testing/sharded.py``), {name: (stepwise case, fused form)}.
FUSED = {f"{base}_{form}": (base, form)
         for base in ("flat64", "vs64", "async32")
         for form in ("run_fused", "chunked", "tol")}
FUSED["async32tol_tol"] = ("async32tol", "tol")
CASES.update({name: CASES[base] for name, (base, _) in FUSED.items()})
#: The cases on the second graph (module docstring); ``retain`` and
#: ``attribute`` name the cases that run those checks.
GRAPH_B = ("halo32b", "async32", "async32sdc", "lag0", "async32tol",
           *(n for n, (base, _) in FUSED.items()
             if base.startswith("async32")))
RETAIN = ("async32",)
ATTRIBUTE = ("flat64", "vs64", "halo32", "async32", "bounded64")
WORLDS = [1, 2, 4]
#: The cases of the second half of slice 6d, run by the world-2 group
#: only and read by ``tests/test_torch_mesh_probes.py`` and
#: ``tests/test_torch_mesh_build.py``: {name: (config, case options)}.
#: ``vstie64probe`` runs the tie graph (:func:`_edges_tie`), whose every
#: rank ties, with a top k wider than a rank's block.
MESH_CASES = {
    "coo64": (dict(F64, kernel="coo"), {}),
    "flat64probe": (F64, dict(probe=dict(every=1, topk=16))),
    "vs64probe": (dict(F64, vertex_sharded=True),
                  dict(probe=dict(every=1, topk=16))),
    "part32probe": (dict(partition_span=256),
                    dict(probe=dict(every=2, topk=16))),
    "vstie64probe": (dict(F64, vertex_sharded=True),
                     dict(probe=dict(every=2, topk=600))),
    "flat64dev": (F64, dict(device_build=True, planes=True)),
    "vs64dev": (dict(F64, vertex_sharded=True),
                dict(device_build=True, planes=True)),
    "halo64dev": (dict(F64, vertex_sharded=True, halo_exchange=True),
                  dict(device_build=True)),
    "part32dev": (dict(partition_span=256),
                  dict(device_build=True, planes=True)),
}
#: The host-built cases whose planes the world-2 group keeps, for the
#: device-built cases to be held to.
PLANES = ("flat64", "vs64", "part32")


def _l1(a, b):
    return float(np.abs(a - b).sum() / np.abs(b).sum())


@pytest.fixture(scope="module")
def edges():
    return rmat_edges(SCALE, edge_factor=8, seed=1)


@pytest.fixture(scope="module")
def graphs(edges):
    src, dst = edges
    n = 1 << SCALE
    return (pagerank_tpu.build_graph(src, dst, n=n),
            pagerank_tpu_torch.build_graph(src, dst, n=n))


def _edges_b():
    return rmat_edges(SCALE, edge_factor=32, seed=1)


@pytest.fixture(scope="module")
def graphs_b():
    src, dst = _edges_b()
    n = 1 << SCALE
    return (pagerank_tpu.build_graph(src, dst, n=n),
            pagerank_tpu_torch.build_graph(src, dst, n=n))


def _edges_tie():
    """The tie graph: one cycle over the 2^SCALE vertices, so that every
    vertex keeps rank 1 (reference semantics) and every top k is a tie
    broken by id alone."""
    src = np.arange(1 << SCALE, dtype=np.int32)
    return src, np.roll(src, -1)


def _shared_root(tmp_path_factory):
    """A directory every xdist worker of this session shares (the base
    of the session's temporary directories), or this run's own."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / "torch_sharded"
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


def _single(graph, config, iters=ITERS):
    return TorchEngine(PageRankConfig(num_iters=iters, **config),
                       device="cpu").build(graph)


@pytest.fixture(scope="module")
def resume_dir(tmp_path_factory, graphs):
    """A snapshot at iteration 4 by the port's single-device engine,
    which the groups resume from (written once, under the lock)."""
    return _resume_dir(tmp_path_factory, graphs[1])


def _resume_dir(tmp_path_factory, graph):
    root = _shared_root(tmp_path_factory)
    d = root / "single_snap"
    with _locked(root / "single_snap.lock"):
        if not (d / "done").exists():
            eng = _single(graph, CASES["vs64resume"] | dict(
                vertex_sharded=False))
            snap = Snapshotter(str(d), graph.fingerprint(), "reference",
                               mesh_meta=eng.snapshot_meta())
            snap.save(4, eng.run(4))
            (d / "done").write_text("")
    return d


def _run_group(tmp_path_factory, edges, resume_dir, world):
    root = _shared_root(tmp_path_factory)
    d = root / f"world{world}"
    with _locked(root / f"world{world}.lock"):
        if not (d / "done").exists():
            d.mkdir(exist_ok=True)
            src, dst = edges
            np.savez(d / "edges.npz", src=src, dst=dst, n=1 << SCALE)
            np.savez(d / "edges_b.npz", **dict(zip(("src", "dst"),
                                                   _edges_b())),
                     n=1 << SCALE)
            np.savez(d / "edges_tie.npz", **dict(zip(("src", "dst"),
                                                     _edges_tie())),
                     n=1 << SCALE)
            cases = [dict(name=k, config=v, iters=ITERS)
                     for k, v in CASES.items()]
            if world == 2:
                cases += [dict(name=k, config=v, iters=ITERS, **opts)
                          for k, (v, opts) in MESH_CASES.items()]
            by_name = {c["name"]: c for c in cases}
            by_name["flat64"]["save_dir"] = str(d / "snap")
            by_name["vs64resume"]["resume_dir"] = str(resume_dir)
            by_name["bounded64"]["save_dir"] = str(d / "snap_bounded")
            by_name["bounded64resume"]["resume_dir"] = str(resume_dir)
            for name in GRAPH_B:
                by_name[name]["edges"] = str(d / "edges_b.npz")
            for name in RETAIN:
                by_name[name]["retain"] = True
            for name in ATTRIBUTE:
                by_name[name]["attribute"] = True
            for name, (_, form) in FUSED.items():
                by_name[name]["fused"] = form
            for name in ("async32tol", "async32tol_tol"):
                by_name[name]["after"] = True
            if world == 2:
                by_name["vstie64probe"]["edges"] = str(d / "edges_tie.npz")
                for name in PLANES:
                    by_name[name]["planes"] = True
            codes = distributed.spawn_group(
                "pagerank_tpu_torch.testing.sharded:run_cases", world,
                dict(edges=str(d / "edges.npz"), out=str(d), device="cpu",
                     cases=cases),
                str(d), backend="gloo", timeout_s=60.0, deadline_s=120.0)
            assert codes == [0] * world, f"rank exit codes {codes}"
            (d / "done").write_text("")
    names = list(CASES) + (list(MESH_CASES) if world == 2 else [])
    return {name: [dict(np.load(d / f"{name}.r{r}.npz"))
                   for r in range(world)] for name in names} | {"dir": d}


def world_results(tmp_path_factory, world):
    """Every case's per-rank results of the world-``world`` group (run
    once a session, under the lock), for the test modules that read
    the same group."""
    src, dst = rmat_edges(SCALE, edge_factor=8, seed=1)
    n = 1 << SCALE
    graph = pagerank_tpu_torch.build_graph(src, dst, n=n)
    return _run_group(tmp_path_factory, (src, dst),
                      _resume_dir(tmp_path_factory, graph), world)


def _cases(res):
    """The case names of a group's results."""
    return [name for name in res if name != "dir"]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def group(request, tmp_path_factory, edges, resume_dir):
    return request.param, _run_group(tmp_path_factory, edges, resume_dir,
                                     request.param)


_JAX = {}


def _jax(gj, world, **kw):
    key = (id(gj), world, tuple(sorted(kw.items())))
    if key not in _JAX:
        cfg = pagerank_tpu.PageRankConfig(num_iters=ITERS, num_devices=world,
                                          **kw)
        _JAX[key] = JaxTpuEngine(cfg).build(gj).run()
    return _JAX[key]


def test_every_rank_holds_the_whole_vector(group):
    world, res = group
    for name in _cases(res):
        for r in range(1, world):
            np.testing.assert_array_equal(res[name][r]["ranks"],
                                          res[name][0]["ranks"])


def test_edge_sharded_flat_f64_matches_jax(group, graphs):
    world, res = group
    got = res["flat64"][0]["ranks"]
    np.testing.assert_allclose(got, _jax(graphs[0], world, **F64),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, _single(graphs[1], F64).run(),
                               rtol=0, atol=1e-12)


def test_vertex_sharded_f64_matches_jax_and_edge_sharded(group, graphs):
    world, res = group
    got = res["vs64"][0]["ranks"]
    np.testing.assert_allclose(
        got, _jax(graphs[0], world, vertex_sharded=True, **F64), rtol=0,
        atol=1e-12)
    if world == 1:  # no regrouping at all
        np.testing.assert_array_equal(got, _single(graphs[1], F64).run())
        np.testing.assert_array_equal(got, res["flat64"][0]["ranks"])
    else:
        np.testing.assert_array_almost_equal_nulp(
            got, res["flat64"][0]["ranks"], nulp=8)


def test_vertex_sharded_textbook_matches_jax(group, graphs):
    """Textbook semantics start every vertex at 1/n of the whole graph
    (``jax_engine.py:2105``), whatever block a rank holds."""
    world, res = group
    cfg = dict(F64, semantics="textbook")
    got = res["vs64tb"][0]["ranks"]
    np.testing.assert_allclose(
        got, _jax(graphs[0], world, vertex_sharded=True, **cfg), rtol=0,
        atol=1e-12)
    np.testing.assert_allclose(got, _single(graphs[1], cfg).run(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(res["vs64tb"][0]["first"].sum(), 1.0,
                               rtol=1e-12)


def test_first_step_is_bit_equal_across_forms(group):
    """From the all-ones r0 the dangling mass is an exact count, and at
    world 2 the merge adds two partials (exact in any order): one step
    of the vertex-sharded form equals the edge-sharded form's bits. At
    world 4 gloo's reduce-scatter and all-reduce group the four partials
    alike (measured; asserted)."""
    _, res = group
    np.testing.assert_array_equal(res["vs64"][0]["first"],
                                  res["flat64"][0]["first"])


def test_f32_ranks_summed_in_f64_are_bit_equal_across_forms(group):
    """The JAX pin for f32 storage over wide sums (test_vertex_sharded.py:
    test_vertex_sharded_striped_pair_bitequal): the f32 round absorbs the
    scalar reductions' regrouping over whole runs."""
    _, res = group
    np.testing.assert_array_equal(res["vs32w"][0]["ranks"],
                                  res["flat32w"][0]["ranks"])


def test_edge_sharded_partitioned_matches_jax(group, graphs):
    world, res = group
    oracle = pagerank_tpu.ReferenceCpuEngine(pagerank_tpu.PageRankConfig(
        num_iters=ITERS, **F64)).build(graphs[0]).run()
    f32 = res["part32"][0]["ranks"]
    assert _l1(f32, _jax(graphs[0], world, kernel="ell",
                         partition_span=256)) < 1e-5
    assert _l1(f32, oracle) < 1e-5
    bf16 = res["partbf16"][0]["ranks"]
    jbf = _jax(graphs[0], world, kernel="ell", partition_span=256,
               stream_dtype="bfloat16")
    assert _l1(bf16, jbf) <= 1e-3
    assert 1e-7 < _l1(bf16, oracle) < 5e-3  # really streamed bf16
    lay = json.loads(str(res["part32"][0]["layout"]))
    assert lay["form"] == "pallas_partitioned"
    assert lay.get("world", 1) == world  # world 1: the one-device form


def test_each_rank_holds_its_block_of_the_state(group):
    world, res = group
    n_vs = -(-(1 << SCALE) // (128 * world)) * 128 * world
    for r in range(world):
        assert int(res["vs64"][r]["local"]) == n_vs // world
        assert int(res["flat64"][r]["local"]) == 1 << SCALE
        lay = json.loads(str(res["vs64"][r]["layout"]))
        assert (lay["rank"], lay["world"], lay["n_vs"]) == (r, world, n_vs)
        assert lay["form"] == "vertex_sharded"
        assert lay["backend"] == "gloo"
        assert lay["comms"]["bytes_per_iter"] == comms.dense_exchange_bytes(
            world, n_vs // world, 8, 8)


def test_step_sdc_runs_sharded(group):
    """The checked step on every sharded form: the same bits as the
    unchecked run, one check an iteration, no breach."""
    _, res = group
    for checked, plain in (("flat64sdc", "flat64"), ("vs64sdc", "vs64"),
                           ("part32sdc", "part32"),
                           ("bounded64sdc", "bounded64")):
        np.testing.assert_array_equal(res[checked][0]["ranks"],
                                      res[plain][0]["ranks"])
        sec = json.loads(str(res[checked][0]["sdc"]))
        assert sec["checks"] == ITERS and sec["flips_detected"] == 0


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_forms_are_bit_equal_to_the_stepwise_run(group, name):
    """Each fused form queues the step's collectives in line on every
    rank: after 1, 4 and ITERS steps every rank holds the stepwise
    case's bits (``tests/test_vertex_sharded.py:118``), and each counts
    the steps it ran. The tol form that stops before ITERS (the async
    form) stops at the stepwise run's step, and the step after it, which
    reads the boundary slot its masked steps kept, is the stepwise run's
    too."""
    world, res = group
    base, _ = FUSED[name]
    keys = ("first", "at4", "ranks", *(("after",) if "after" in res[base][0]
                                       else ()))
    for r in range(world):
        for key in keys:
            np.testing.assert_array_equal(res[name][r][key],
                                          res[base][0][key])
        assert json.loads(str(res[name][r]["layout"]))["form"] == \
            json.loads(str(res[base][r]["layout"]))["form"]
        steps = int(res[name][r]["steps"])
        if base == "async32tol":
            assert steps == int(res[base][r]["steps"]) < ITERS
        else:
            assert steps == ITERS


def test_set_ranks_round_trips(group):
    world, res = group
    want = np.random.default_rng(7).random(1 << SCALE)
    for name in _cases(res):
        for r in range(world):
            got = res[name][r]["roundtrip"]
            np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_snapshots_resume_across_world_sizes(group, graphs, resume_dir):
    """A one-device snapshot resumes on the mesh, and the mesh's
    snapshot (rank 0's) resumes on one device; each finishes within
    f64 rounding of the uninterrupted run."""
    from pagerank_tpu_torch.utils.snapshot import resume_engine

    _, res = group
    uninterrupted = res["vs64"][0]["ranks"]
    assert int(res["vs64resume"][0]["resumed"]) == 4
    np.testing.assert_allclose(res["vs64resume"][0]["ranks"], uninterrupted,
                               rtol=0, atol=1e-12)
    eng = _single(graphs[1], F64)
    snap = Snapshotter(str(res["dir"] / "snap"), graphs[1].fingerprint(),
                       "reference")
    assert resume_engine(eng, snap) == 4
    np.testing.assert_allclose(eng.run(), uninterrupted, rtol=0, atol=1e-12)


# -- vs_halo, vs_halo_async, vs_bounded ---------------------------------------


def test_halo_f32_ranks_equal_the_dense_forms(group):
    """K1 reads the same z bits through the halo image as through the
    dense all_gather, with or without a replicated head, f32 or f64
    sums (``tests/test_halo.py:199``)."""
    _, res = group
    for halo, dense in (("halo32", "vs32"), ("halo32head", "vs32"),
                        ("halo32w", "vs32w")):
        np.testing.assert_array_equal(res[halo][0]["ranks"],
                                      res[dense][0]["ranks"])
        np.testing.assert_array_equal(res[halo][0]["first"],
                                      res[dense][0]["first"])


def test_halo_f64_matches_jax_and_the_dense_form(group, graphs):
    world, res = group
    got = res["halo64"][0]["ranks"]
    np.testing.assert_allclose(
        got, _jax(graphs[0], world, vertex_sharded=True, halo_exchange=True,
                  **F64), rtol=0, atol=1e-12)
    # Only the merge regroups (test_halo.py: nulp=8).
    np.testing.assert_array_almost_equal_nulp(got, res["vs64"][0]["ranks"],
                                              nulp=8)


def test_halo_layout_and_comms(group):
    """``layout_info`` names the form and carries the plan's summary;
    ``comms.bytes_exchanged`` is the steps times the model's bytes a
    step, on every form with a model."""
    world, res = group
    for name in ("halo32", "halo32head", "halo64", "async32", "lag0"):
        for r in range(world):
            lay = json.loads(str(res[name][r]["layout"]))
            want = ("vs_halo_async" if name == "async32" and world > 1
                    else "vs_halo")
            assert lay["form"] == want, (name, lay["form"])
            assert lay["halo"]["head_k"] == (256 if name == "halo32head"
                                             else lay["halo"]["head_k"])
            assert lay["comms"]["mode"] == ("sparse_async"
                                            if want == "vs_halo_async"
                                            else "sparse")
    for name in _cases(res):
        for r in range(world):
            x = res[name][r]
            assert int(x["bytes"]) == int(x["steps"]) * int(x["bpi"]), name
    halo = json.loads(str(res["halo32"][0]["layout"]))["halo"]
    if world == 1:
        assert halo["read_rounds"] == halo["write_rounds"] == 0
        assert int(res["halo32"][0]["bpi"]) == 0
    else:
        assert 0 < int(res["halo32"][0]["bpi"]) == \
            halo["sparse_bytes_per_iter"] < halo["dense_bytes_per_iter"]


def test_async_lag1_matches_jax(group, graphs_b):
    """Lag 1 against JAX's lag-1 run on the same graph and world: both
    stale the same reads (module docstring), so they agree to f32
    rounding. At world 1 the gate refuses (single_device): both run the
    synchronous form."""
    world, res = group
    lay = json.loads(str(res["async32"][0]["layout"]))
    if world == 1:
        assert lay["halo_async"] == "off:single_device"
    else:
        assert lay["halo_async"] == "on:lag1"
        assert lay["halo_buffer_width"] == lay["halo"]["head_k"] + \
            lay["halo"]["read_width_total"]
        # The JAX engine's rows a device on this graph (module docstring).
        assert lay["num_rows"] == {2: 512, 4: 256}[world]
    jax_r = _jax(graphs_b[0], world, vertex_sharded=True,
                 halo_exchange=True, halo_async=True,
                 halo_async_min_gain=0.0, lane_group=1)
    assert _l1(res["async32"][0]["ranks"], jax_r) < 1e-5


def test_async_first_steps_are_lag0_exact(group):
    """The slot is primed at build and at ``set_ranks``: the first step
    after either is the synchronous step, bit for bit
    (``tests/test_halo_async.py:66-104, :191``); ``stale_max_lag=0``
    runs vs_halo itself."""
    _, res = group
    for key in ("first", "stepped"):
        np.testing.assert_array_equal(res["async32"][0][key],
                                      res["halo32b"][0][key])
    np.testing.assert_array_equal(res["lag0"][0]["ranks"],
                                  res["halo32b"][0]["ranks"])
    lay = json.loads(str(res["lag0"][0]["layout"]))
    assert (lay["form"], lay["halo_async"]) == ("vs_halo",
                                                "off:stale_max_lag=0")
    assert "halo_buffer_width" not in lay


def test_async_retain_restore_and_checked_run(group):
    """``retain_state``/``restore_state`` carry the boundary slot and
    the slack, so a restored run repeats its steps bit for bit and ends
    where an uninterrupted one does (``tests/test_halo_async.py:155``);
    the checked async run equals the unchecked one, no breach
    (``:214``)."""
    world, res = group
    for r in range(world):
        x = res["async32"][r]
        np.testing.assert_array_equal(x["retain_a"], x["retain_b"])
    np.testing.assert_array_equal(res["async32"][0]["ranks"],
                                  res["async32sdc"][0]["ranks"])
    sec = json.loads(str(res["async32sdc"][0]["sdc"]))
    assert sec["checks"] == ITERS and sec["flips_detected"] == 0


def test_bounded_matches_jax_and_holds_its_own_rows(group, graphs):
    """vs_bounded against JAX's at the same world (f64; bit-equal to the
    one-device run at world 1), each rank's rows all of its own dst
    range, renumbered to nbd local blocks and a trash block
    (``tests/test_vertex_sharded.py:224``)."""
    world, res = group
    got = res["bounded64"][0]["ranks"]
    np.testing.assert_allclose(
        got, _jax(graphs[0], world, vertex_sharded=True, vs_bounded=True,
                  **F64), rtol=0, atol=1e-12)
    if world == 1:
        np.testing.assert_array_equal(got, _single(graphs[1], F64).run())
    n_vs = -(-(1 << SCALE) // (128 * world)) * 128 * world
    rows = set()
    for r in range(world):
        lay = json.loads(str(res["bounded64"][r]["layout"]))
        assert lay["form"] == "vs_bounded" and lay["comms"] is None
        assert lay["local_blocks"] == n_vs // world // 128
        assert lay["trash_blocks"] == 1 and lay["num_rows"] % 256 == 0
        assert int(res["bounded64"][r]["local"]) == n_vs // world
        rows.add(lay["num_rows"])
    assert len(rows) == 1  # every rank padded to one row count


def test_bounded_snapshots_resume_across_world_sizes(group, graphs):
    """The one-device snapshot resumes into vs_bounded, and vs_bounded's
    (rank 0's) resumes on one device, each within f64 rounding of the
    uninterrupted run."""
    from pagerank_tpu_torch.utils.snapshot import resume_engine

    _, res = group
    uninterrupted = res["bounded64"][0]["ranks"]
    assert int(res["bounded64resume"][0]["resumed"]) == 4
    np.testing.assert_allclose(res["bounded64resume"][0]["ranks"],
                               uninterrupted, rtol=0, atol=1e-12)
    eng = _single(graphs[1], F64)
    snap = Snapshotter(str(res["dir"] / "snap_bounded"),
                       graphs[1].fingerprint(), "reference")
    assert resume_engine(eng, snap) == 4
    np.testing.assert_allclose(eng.run(), uninterrupted, rtol=0, atol=1e-12)


def test_attribution_splits_the_exchanging_forms_only(group):
    """``attribute_exchange`` is None for a form with no exchange
    program (the flat form, vs_bounded) and a split for the
    dense form and both vs_halo forms; the ranks are the same after
    it."""
    world, res = group
    for name in ATTRIBUTE:
        for r in range(world):
            x = res[name][r]
            att = json.loads(str(x["attribution"]))
            np.testing.assert_array_equal(x["attributed"], x["ranks"])
            if name in ("flat64", "bounded64"):
                assert att is None, name
                continue
            assert att["iters"] == 2 and att["step_s"] > 0
            assert 0 <= att["exchange_fraction"] <= 1
            assert att["compute_s"] == max(0.0, att["step_s"]
                                           - att["exchange_s"])
            assert att["mode"] == json.loads(str(x["layout"]))["comms"][
                "mode"]


# -- the CLI over a mesh ------------------------------------------------------


def test_cli_two_ranks_vertex_sharded_matches_one_device(tmp_path, capfd):
    """``--device cpu --num-devices 2 --vertex-sharded``: two spawned
    ranks, one ranks file (rank 0's), within the gate of the one-device
    CLI."""
    def load(path):
        return np.array([float(line.split("\t")[1]) for line in open(path)])

    base = ["--synthetic", "rmat:9", "--device", "cpu", "--iters", "6",
            "--log-every", "0"]
    one, two = tmp_path / "one.tsv", tmp_path / "two.tsv"
    assert cli.main(base + ["--out", str(one)]) == 0
    assert cli.main(base + ["--num-devices", "2", "--vertex-sharded",
                            "--out", str(two)]) == 0
    a, b = load(one), load(two)
    assert a.shape == b.shape == (1 << 9,)
    assert _l1(b, a) < 1e-5
    assert "engine: vertex_sharded" in capfd.readouterr().err  # rank 0's


@pytest.mark.parametrize("argv", [
    ["--num-devices", "2", "--probe-every", "2"],
    ["--num-devices", "2", "--device-build"],
    ["--vertex-sharded", "--ppr-sources", "0"],
    ["--num-devices", "2", "--job-dir", "j"],
], ids=lambda a: a[-1] if a[-1].startswith("-") else a[-2])
def test_cli_slice_6b_flags_exit_2_naming_it(argv, capsys, tmp_path,
                                             monkeypatch):
    """What slice 6c left refused over a mesh is ported (the second half
    of slice 6d): --probe-every, --device-build and --job-dir pass the
    argument checks at --num-devices 2, with nothing printed (their runs
    are held in tests/test_torch_mesh_*.py). --ppr-sources runs over a
    mesh (tests/test_torch_ppr_sharded.py); with --vertex-sharded it is
    refused with the JAX CLI's ``reject_ppr_incompatible_flags``
    message."""
    monkeypatch.chdir(tmp_path)
    full = ["--synthetic", "rmat:6", "--device", "cpu", *argv]
    if "--ppr-sources" in argv:
        with pytest.raises(SystemExit) as e:
            cli.main(full)
        from pagerank_tpu import cli as jax_cli

        with pytest.raises(SystemExit) as want:
            jax_cli.reject_ppr_incompatible_flags(
                jax_cli.build_parser().parse_args(["--synthetic", "rmat:6",
                                                   *argv]))
        assert e.value.code == want.value.code
        assert "ppr mode does not support: --vertex-sharded" in str(
            e.value.code)
        return
    cli._check_args(cli.build_parser().parse_args(full))
    assert capsys.readouterr().err == ""


_HALO_FLAGS = {
    "--vs-bounded": ["--vertex-sharded", "--vs-bounded"],
    "--halo-exchange": ["--vertex-sharded", "--halo-exchange"],
    "--halo-head": ["--vertex-sharded", "--halo-exchange", "--halo-head",
                    "128"],
    "--halo-async": ["--vertex-sharded", "--halo-exchange", "--halo-async",
                     "--halo-async-min-gain", "0"],
    "--halo-async-min-gain": ["--vertex-sharded", "--halo-exchange",
                              "--halo-async", "--halo-async-min-gain",
                              "0.5"],
    "--stale-max-lag": ["--vertex-sharded", "--halo-exchange",
                        "--halo-async", "--stale-max-lag", "0"],
}


def _cli_ranks(tmp_path, name, argv):
    out = tmp_path / f"{name}.tsv"
    assert cli.main(["--synthetic", "rmat:9", "--device", "cpu", "--iters",
                     "6", "--log-every", "0", *argv, "--out", str(out)]) == 0
    return np.array([float(line.split("\t")[1]) for line in open(out)])


@pytest.fixture(scope="module")
def cli_one(tmp_path_factory):
    """The one-device CLI's ranks (no mesh) of the runs below."""
    return _cli_ranks(tmp_path_factory.mktemp("cli_one"), "one", [])


@pytest.mark.parametrize("flag", list(_HALO_FLAGS))
def test_cli_halo_and_bounded_flags_run_at_world_1(flag, tmp_path, capfd,
                                                   cli_one):
    """Each flag of the vertex-sharded forms runs (exit 0) in a group of
    one; the form is the layout line's, and the ranks are the one-device
    run's (at world 1 every form's sums are the flat form's, bit for
    bit)."""
    one = cli_one
    got = _cli_ranks(tmp_path, "got", ["--num-devices", "1",
                                       *_HALO_FLAGS[flag]])
    np.testing.assert_array_equal(got, one)
    form = "vs_bounded" if flag == "--vs-bounded" else "vs_halo"
    assert f"engine: {form} on cpu" in capfd.readouterr().err


@pytest.mark.parametrize("form", ["vs_halo_async", "vs_bounded"])
def test_cli_halo_and_bounded_forms_run_at_world_2(form, tmp_path, capfd,
                                                   cli_one):
    """Two spawned ranks: every halo flag at once (the async form, gate
    open), and --vs-bounded; within the f32 gate of the one-device CLI,
    rank 0's layout line naming the form."""
    argv = (["--vertex-sharded", "--halo-exchange", "--halo-head", "128",
             "--halo-async", "--halo-async-min-gain", "0",
             "--stale-max-lag", "1"] if form == "vs_halo_async"
            else ["--vertex-sharded", "--vs-bounded"])
    one = cli_one
    got = _cli_ranks(tmp_path, "got", ["--num-devices", "2", *argv])
    # The async run reads a one-step-stale boundary: the gate is the
    # staleness, not rounding.
    assert _l1(got, one) < (0.1 if form == "vs_halo_async" else 1e-5)
    assert f"engine: {form} on cpu" in capfd.readouterr().err


@pytest.mark.parametrize("argv,message", [
    (["--halo-exchange"], "halo_exchange requires vertex_sharded"),
    (["--vs-bounded"], "vs_bounded requires vertex_sharded"),
    (["--vertex-sharded", "--vs-bounded", "--halo-exchange"],
     "halo_exchange targets the plain vertex-sharded exchange"),
    (["--vertex-sharded", "--halo-async"],
     "halo_async overlaps the sparse boundary exchange"),
    (["--vertex-sharded", "--halo-exchange", "--halo-head", "-2"],
     "halo_head must be -1 (auto), 0 (off), or positive"),
    (["--vertex-sharded", "--halo-exchange", "--halo-async",
      "--halo-async-min-gain", "-1"], "halo_async_min_gain must be >= 0"),
], ids=["halo-no-vs", "bounded-no-vs", "bounded-and-halo", "async-no-halo",
        "head", "min-gain"])
def test_cli_halo_flags_keep_the_jax_refusals(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--synthetic", "rmat:6", "--device", "cpu", *argv])
    assert message in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        cli.main(["--synthetic", "rmat:6", "--device", "cpu",
                  "--stale-max-lag", "2"])
    assert e.value.code == 2


def test_cli_mesh_needs_the_sync_writer(capsys, tmp_path):
    """The async rank writer runs over a mesh (the second half of slice
    6d): --snapshot-dir at --num-devices 2 passes the argument checks
    without --sync-io (its files are held byte-equal to --sync-io's in
    tests/test_torch_mesh_jobs.py)."""
    args = cli.build_parser().parse_args([
        "--synthetic", "rmat:6", "--device", "cpu", "--num-devices", "2",
        "--snapshot-dir", str(tmp_path)])
    cli._check_args(args)
    assert not args.sync_io
    assert capsys.readouterr().err == ""


def test_cli_num_devices_must_match_torchruns_world(monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit) as e:
        cli.main(["--synthetic", "rmat:6", "--device", "cpu",
                  "--num-devices", "2"])
    assert e.value.code == 2
    assert "WORLD_SIZE 3" in capsys.readouterr().err


# -- the mesh and the bring-up ------------------------------------------------


def test_make_mesh_keeps_the_jax_errors(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 "
                       "visible"):
        mesh_lib.make_mesh(2, device="cuda")
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        mesh_lib.make_mesh(2, device="cpu")
    m = mesh_lib.make_mesh(1, device="cpu")
    assert (m.rank, m.world, m.group, m.axis_name) == (0, 1, None, "data")


def test_shardings_are_row_and_vertex_ranges():
    m = mesh_lib.Mesh(group=None, rank=2, world=4, device=None)
    assert mesh_lib.edge_sharding(m, 1024) == slice(512, 768)
    assert mesh_lib.vertex_sharding(m, 512) == slice(256, 384)
    assert mesh_lib.replicated(m, 300) == slice(0, 300)
    with pytest.raises(ValueError):
        mesh_lib.edge_sharding(m, 1023)


def test_init_retries_a_rendezvous_race_and_counts_it():
    from pagerank_tpu_torch.obs import metrics as obs_metrics
    from pagerank_tpu_torch.utils.retry import RetryPolicy

    obs_metrics.get_registry().reset()
    calls = []

    def init(**kw):
        calls.append(kw)
        if len(calls) == 1:
            raise ConnectionError("connection refused")

    policy = RetryPolicy(max_attempts=3, base_delay=0.0, sleep=lambda s: None)
    assert distributed.maybe_initialize_distributed(
        "gloo", init_method="tcp://localhost:1", world_size=2, rank=1,
        timeout_s=5.0, retry_policy=policy, _initialize=init)
    assert len(calls) == 2 and calls[1]["backend"] == "gloo"
    assert calls[1]["timeout"].total_seconds() == 5.0
    snap = obs_metrics.get_registry().snapshot()["counters"]
    assert snap["distributed.init_retries"] == 1
    # No world size from the arguments or the environment: nothing runs.
    assert not distributed.maybe_initialize_distributed(
        "gloo", _initialize=init)
    assert distributed.default_backend("cuda") == "nccl"
    assert distributed.default_backend("cpu") == "gloo"


def test_a_drain_asked_of_one_rank_stops_every_rank_at_one_step(tmp_path):
    """SIGTERM to rank 0 alone, inside its third step of a two-rank
    vertex-sharded CLI run: both ranks drain after that step (exit 75),
    and the drain's snapshot (rank 0's, from a gather every rank joins)
    holds the ranks of three steps, not another step's gathered z."""
    from pagerank_tpu_torch.exitcodes import ExitCode

    src, dst = rmat_edges(9, edge_factor=8, seed=4)
    np.savez(tmp_path / "edges.npz", src=src, dst=dst, n=1 << 9)
    snap_dir = tmp_path / "snap"
    argv = ["--input", str(tmp_path / "edges.npz"), "--device", "cpu",
            "--num-devices", "2", "--vertex-sharded", "--iters", "12",
            "--dtype", "float64", "--snapshot-dir", str(snap_dir),
            "--snapshot-every", "0", "--sync-io", "--log-every", "0"]
    codes = distributed.spawn_group(
        "pagerank_tpu_torch.testing.sharded:drain_one_rank", 2,
        dict(argv=argv, rank=0, at=3), str(tmp_path), backend="gloo",
        timeout_s=20.0, deadline_s=90.0)
    assert codes == [int(ExitCode.INTERRUPTED)] * 2
    g = pagerank_tpu_torch.build_graph(src, dst, n=1 << 9)
    snap = Snapshotter(str(snap_dir), g.fingerprint(), "reference")
    assert snap.iterations() == [3]
    ranks, meta = snap.load(3)
    assert meta["fingerprint"] == g.fingerprint()
    np.testing.assert_allclose(ranks, _single(g, F64, iters=3).run(),
                               rtol=0, atol=1e-12)


def test_a_failed_rank_does_not_hang_the_group(tmp_path):
    """Rank 1 raises before a collective that rank 0 waits in: the
    group's timeout ends rank 0, and the launcher reports both."""
    codes = distributed.spawn_group(
        "pagerank_tpu_torch.testing.sharded:fail_on_rank_1", 2, None,
        str(tmp_path), backend="gloo", timeout_s=5.0, deadline_s=60.0)
    assert codes[1] != 0 and codes[0] != 0


@pytest.mark.parametrize("span", [0, 256])
@pytest.mark.parametrize("world", [2, 3])
def test_kernel_plain_versions_take_a_shard(span, world):
    """K1's and K2's plain versions over each rank's share of the padded
    slot rows (a share may start inside a dst block and end in inert
    rows): the shares' sums add up to the whole table's. Built in one
    process over meshes without a group, where ``psum`` is the
    identity."""
    import torch

    src, dst = rmat_edges(SCALE, edge_factor=8, seed=3)
    g = pagerank_tpu_torch.build_graph(src, dst, n=1 << SCALE)
    cfg = PageRankConfig(partition_span=span, dtype="float32",
                         accum_dtype="float32" if span else "float64")
    whole = TorchEngine(cfg, device="cpu").build(g)
    want = whole._contrib().double()
    parts, rows = [], 0
    for r in range(world):
        m = mesh_lib.Mesh(group=None, rank=r, world=world,
                          device=torch.device("cpu"))
        eng = TorchEngine(cfg, device="cpu", mesh=m).build(g)
        rows += eng.layout_info()["num_rows"]
        assert eng.layout_info()["num_rows"] % 256 == 0
        parts.append(eng._contrib().double())
    assert rows >= whole.layout_info()["num_rows"]
    assert np.array_equal(eng.device_edges().sum(), g.num_edges)
    np.testing.assert_allclose(sum(parts).numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-9)
