"""The coo form (``kernel="coo"``: the dst-sorted edge list summed per
dst in a fixed order) on the CPU against the JAX package's coo engine
and the f64 oracle, at the gates of tests/test_ell.py and
tests/test_torch_engine.py; ``edge_contrib_segment_sum`` against the
JAX op; resume bit-identity; the config's refusals with the JAX
messages."""

import numpy as np
import pytest
import torch

import pagerank_tpu
from pagerank_tpu.ops import spmv as jax_spmv

import pagerank_tpu_torch
from pagerank_tpu_torch import PageRankConfig, TorchEngine
from pagerank_tpu_torch.ops import spmv
from pagerank_tpu_torch.utils import synth
from pagerank_tpu_torch.utils.snapshot import Snapshotter, resume_engine

CFG_FIELDS = ("num_iters", "damping", "semantics", "dtype", "accum_dtype")


def _graphs(seed, n, e):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return (pagerank_tpu.build_graph(src, dst, n=n),
            pagerank_tpu_torch.build_graph(src, dst, n=n))


def _jax(gj, cfg, **kw):
    jc = pagerank_tpu.PageRankConfig(
        **{f: getattr(cfg, f) for f in CFG_FIELDS}, num_devices=1, **kw)
    return pagerank_tpu.JaxTpuEngine(jc).build(gj)


@pytest.mark.parametrize("semantics", ["reference", "textbook"])
def test_coo_f64_matches_the_jax_coo_engine_and_the_oracle(semantics):
    gj, gt = _graphs(9, 700, 6000)
    cfg = PageRankConfig(num_iters=10, dtype="float64",
                         accum_dtype="float64", semantics=semantics,
                         kernel="coo")
    eng = TorchEngine(cfg, device="cpu").build(gt)
    info = eng.layout_info()
    assert info["form"] == "coo" and info["kernel"] == "segment_reduce"
    assert info["num_edges"] == gt.num_edges and eng._r.shape == (gt.n,)
    r = eng.run()
    jeng = _jax(gj, cfg, kernel="coo")
    assert jeng.layout_info()["form"] == "coo"
    oracle = pagerank_tpu.ReferenceCpuEngine(
        pagerank_tpu.PageRankConfig(num_iters=10, semantics=semantics)
    ).build(gj).run()
    np.testing.assert_allclose(r, np.asarray(jeng.run()), rtol=0, atol=1e-12)
    np.testing.assert_allclose(r, oracle, rtol=0, atol=1e-12)
    # ... and the port's ELL form (tests/test_ell.py:84's pin).
    r_ell = TorchEngine(cfg.replace(kernel="ell"), device="cpu").build(
        gt).run()
    np.testing.assert_allclose(r, r_ell, rtol=0, atol=1e-12)


@pytest.mark.parametrize("semantics", ["reference", "textbook"])
@pytest.mark.parametrize("accum", ["float32", "float64"])
def test_coo_f32_within_the_f32_gates(semantics, accum):
    gj, gt = _graphs(3, 500, 4000)
    cfg = PageRankConfig(num_iters=10, dtype="float32", accum_dtype=accum,
                         semantics=semantics, kernel="coo")
    r = TorchEngine(cfg, device="cpu").build(gt).run()
    assert r.dtype == np.float32
    oracle = pagerank_tpu.ReferenceCpuEngine(
        pagerank_tpu.PageRankConfig(num_iters=10, semantics=semantics)
    ).build(gj).run()
    rj = np.asarray(_jax(gj, cfg, kernel="coo").run())
    assert np.abs(r - oracle).sum() / np.abs(oracle).sum() < 1e-6
    np.testing.assert_allclose(r, rj, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dtype,acc", [(np.float32, np.float32),
                                       (np.float32, np.float64),
                                       (np.float64, np.float64)])
def test_edge_contrib_segment_sum_matches_the_jax_op(batched, dtype, acc):
    import jax.numpy as jnp

    _, g = _graphs(5, 300, 2500)
    rng = np.random.default_rng(1)
    r = rng.random((g.n, 3) if batched else g.n).astype(dtype)
    w = g.edge_weight.astype(dtype)
    want = np.asarray(jax_spmv.edge_contrib_segment_sum(
        jnp.asarray(r), jnp.asarray(g.src), jnp.asarray(g.dst),
        jnp.asarray(w), g.n, accum_dtype=acc))
    got = spmv.edge_contrib_segment_sum(
        torch.from_numpy(r), torch.from_numpy(g.src.astype(np.int64)),
        torch.from_numpy(np.bincount(g.dst, minlength=g.n)),
        torch.from_numpy(w), accum_dtype=torch.from_numpy(
            np.zeros(0, acc)).dtype)
    assert got.shape == r.shape
    tol = 1e-12 if acc == np.float64 else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_edge_contrib_segment_sum_without_edges_is_zero():
    got = spmv.edge_contrib_segment_sum(
        torch.ones(4), torch.zeros(0, dtype=torch.int64),
        torch.zeros(4, dtype=torch.int64), torch.zeros(0))
    assert torch.equal(got, torch.zeros(4))


def test_coo_resume_midway_is_bit_equal(tmp_path):
    """6 iterations + a resume to 10 through the snapshot API equal an
    uninterrupted 10, bit for bit (chip_smoke.py phase 8's check)."""
    src, dst = synth.rmat_edges(10)
    g = pagerank_tpu_torch.build_graph(src, dst, n=1 << 10)

    def solve(iters, directory, resume=False):
        cfg = PageRankConfig(num_iters=iters, dtype="float32",
                             accum_dtype="float32", kernel="coo")
        eng = TorchEngine(cfg, device="cpu").build(g)
        snap = Snapshotter(str(directory), g.fingerprint(), cfg.semantics,
                           mesh_meta=eng.snapshot_meta())
        resumed = resume_engine(eng, snap) if resume else 0
        eng.run(on_iteration=lambda i, info: snap.save(i + 1, eng.ranks()),
                snapshotter=snap)
        assert eng.layout_info()["form"] == "coo" and eng.iteration == iters
        return resumed

    solve(6, tmp_path / "cut")
    assert solve(10, tmp_path / "cut", resume=True) == 6
    solve(10, tmp_path / "ctrl")
    a = np.load(str(tmp_path / "cut" / "ranks_iter10.npz"))["ranks"]
    b = np.load(str(tmp_path / "ctrl" / "ranks_iter10.npz"))["ranks"]
    np.testing.assert_array_equal(a, b)


def test_coo_runs_twice_bit_equal_and_set_ranks_roundtrips():
    _, gt = _graphs(4, 300, 2000)
    cfg = PageRankConfig(num_iters=7, kernel="coo")
    a = TorchEngine(cfg, device="cpu").build(gt).run()
    b = TorchEngine(cfg, device="cpu").build(gt).run()
    np.testing.assert_array_equal(a, b)
    eng = TorchEngine(cfg, device="cpu").build(gt)
    r = np.random.default_rng(0).random(gt.n).astype(np.float32)
    eng.set_ranks(r, iteration=5)
    np.testing.assert_array_equal(eng.ranks(), r)
    assert eng.iteration == 5 and eng.snapshot_meta()["form"] == "coo"


@pytest.mark.parametrize("kw", [
    dict(kernel="coo", partition_span=512),
    dict(kernel="coo", vertex_sharded=True),
    dict(kernel="coo", vertex_sharded=True, partition_span=512),
    dict(kernel="nope"),
])
def test_coo_refusals_carry_the_jax_messages(kw):
    with pytest.raises(ValueError) as theirs:
        pagerank_tpu.PageRankConfig(**kw).validate()
    with pytest.raises(ValueError) as ours:
        PageRankConfig(**kw).validate()
    assert str(ours.value) == str(theirs.value)


def test_coo_refuses_a_device_graph():
    from pagerank_tpu_torch.ops import device_build as db

    src, dst = np.array([0, 1, 2]), np.array([1, 2, 0])
    dg = db.build_ell_device(torch.from_numpy(src.astype(np.int32)),
                             torch.from_numpy(dst.astype(np.int32)), 3,
                             device="cpu")
    with pytest.raises(ValueError, match="ell/pallas kernels only"):
        TorchEngine(PageRankConfig(kernel="coo"), device="cpu"
                    ).build_device(dg)
