"""TorchEngine (device="cpu") against the JAX package's f64 oracle and
its JaxTpuEngine running K1 in interpret mode, at the gates of
tests/test_jax_engine.py, plus the solve loop's contracts."""

import numpy as np
import pytest
import torch

import pagerank_tpu
from pagerank_tpu.ingest import records_to_graph

import pagerank_tpu_torch
from pagerank_tpu_torch import PageRankConfig, TorchEngine, convert
from pagerank_tpu_torch.engine import SolverHealthError
from pagerank_tpu_torch.utils.snapshot import Snapshotter
from tests.oracle_rdd import sparky_pagerank
from tests.test_cpu_engine import TOY_RECORDS

CFG_FIELDS = ("num_iters", "damping", "semantics", "dtype", "accum_dtype",
              "tol")


def _jax_cfg(cfg, **kw):
    return pagerank_tpu.PageRankConfig(
        **{f: getattr(cfg, f) for f in CFG_FIELDS}, **kw)


def _cross(gj):
    """The port's Graph from a JAX Graph (state carried across)."""
    return convert.graph_from_arrays(
        gj.n, gj.src, gj.dst, gj.out_degree, gj.in_degree, gj.dangling_mask,
        gj.zero_in_mask, gj.edge_weight)


def _random_graphs(seed, n, e):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return (pagerank_tpu.build_graph(src, dst, n=n),
            pagerank_tpu_torch.build_graph(src, dst, n=n))


def _jax_runs(gj, cfg):
    oracle = pagerank_tpu.ReferenceCpuEngine(_jax_cfg(cfg)).build(gj).run()
    pallas = pagerank_tpu.JaxTpuEngine(
        _jax_cfg(cfg, kernel="pallas", num_devices=1)).build(gj)
    assert pallas._kernel.startswith("pallas")
    return oracle, pallas.run()


def test_toy_matches_oracle_and_pallas_f64():
    gj, _ = records_to_graph(TOY_RECORDS)
    cfg = PageRankConfig(num_iters=10, dtype="float64", accum_dtype="float64")
    r = TorchEngine(cfg, device="cpu").build(_cross(gj)).run()
    oracle, pallas = _jax_runs(gj, cfg)
    np.testing.assert_allclose(r, oracle, rtol=0, atol=1e-13)
    np.testing.assert_allclose(r, pallas, rtol=0, atol=1e-13)


@pytest.mark.parametrize("semantics", ["reference", "textbook"])
def test_random_graph_matches_oracle_and_pallas_f64(semantics):
    gj, gt = _random_graphs(7, 200, 1500)
    cfg = PageRankConfig(num_iters=15, semantics=semantics, dtype="float64",
                         accum_dtype="float64")
    r = TorchEngine(cfg, device="cpu").build(gt).run()
    oracle, pallas = _jax_runs(gj, cfg)
    np.testing.assert_allclose(r, oracle, rtol=0, atol=1e-12)
    np.testing.assert_allclose(r, pallas, rtol=0, atol=1e-12)


@pytest.mark.parametrize("semantics", ["reference", "textbook"])
@pytest.mark.parametrize("accum", ["float32", "float64"])
def test_float32_within_gate(semantics, accum):
    gj, gt = _random_graphs(3, 500, 4000)
    cfg = PageRankConfig(num_iters=20, semantics=semantics,
                         accum_dtype=accum)
    r = TorchEngine(cfg, device="cpu").build(gt).run()
    assert r.dtype == np.float32
    oracle, pallas = _jax_runs(gj, cfg)
    scale = 1.0 if semantics == "reference" else 1.0 / gt.n
    for want in (oracle, pallas):
        np.testing.assert_allclose(r, want, rtol=0, atol=5e-4 * scale)
        assert np.abs(r - want).sum() / gt.n < 1e-4 * scale


def test_toy_iterate_by_iterate_matches_rdd_transliteration():
    """PARITY C16: every iterate of the toy run, against tests/oracle_rdd.py."""
    gj, ids = records_to_graph(TOY_RECORDS)
    _, history, all_urls, _ = sparky_pagerank(TOY_RECORDS, 10)
    cfg = PageRankConfig(num_iters=10, dtype="float64", accum_dtype="float64")
    eng = TorchEngine(cfg, device="cpu").build(_cross(gj))
    mine = []
    eng.run(on_iteration=lambda i, info: mine.append(eng.ranks().copy()))
    assert gj.n == len(all_urls) and len(mine) == len(history) == 10
    for it, (got, ref) in enumerate(zip(mine, history)):
        for url, rank in ref.items():
            assert got[ids.get(url)] == pytest.approx(rank, abs=1e-12), (
                it, url)


def test_tol_stops_at_the_jax_engines_iteration():
    gj, gt = _random_graphs(5, 300, 2400)
    cfg = PageRankConfig(num_iters=200, semantics="textbook",
                         dtype="float64", accum_dtype="float64", tol=1e-9)
    eng = TorchEngine(cfg, device="cpu").build(gt)
    eng.run()
    jeng = pagerank_tpu.JaxTpuEngine(
        _jax_cfg(cfg, kernel="pallas", num_devices=1)).build(gj)
    jeng.run()
    assert 0 < eng.iteration < 200
    assert eng.iteration == jeng.iteration


@pytest.mark.parametrize("semantics", ["reference", "textbook"])
def test_port_oracle_bit_equal_to_jax_oracle(semantics):
    gj, gt = _random_graphs(9, 400, 3000)
    cfg = PageRankConfig(num_iters=12, semantics=semantics)
    a = pagerank_tpu_torch.ReferenceCpuEngine(cfg).build(gt).run()
    b = pagerank_tpu.ReferenceCpuEngine(_jax_cfg(cfg)).build(gj).run()
    np.testing.assert_array_equal(a, b)


def test_make_engine_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pagerank_tpu_torch.make_engine("torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEngine(PageRankConfig())
    eng = pagerank_tpu_torch.make_engine("torch", device="cpu")
    assert eng.device.type == "cpu"
    assert isinstance(pagerank_tpu_torch.make_engine("cpu"),
                      pagerank_tpu_torch.ReferenceCpuEngine)
    with pytest.raises(ValueError, match="unknown engine"):
        pagerank_tpu_torch.make_engine("jax")


@pytest.mark.parametrize("kw,slice_no", [
    # Slice 2 is ported: these two still raise, under its rules.
    (dict(partition_span=512, dtype="float64", accum_dtype="float64"),
     "32-bit accumulation only"),
    (dict(stream_dtype="bfloat16"), "set partition_span"),
    (dict(vertex_sharded=True), "slice 6"),
    (dict(num_devices=4), "slice 6"),
])
def test_later_slice_fields_name_their_slice(kw, slice_no):
    with pytest.raises(ValueError, match=slice_no):
        PageRankConfig(**kw).validate()


@pytest.mark.parametrize("semantics", ["reference", "textbook"])
def test_kernel_coo_runs_the_coo_form(semantics):
    """kernel="coo" (slice 4's last form) builds and runs: the COO
    segment sum, no padding, within 1e-12 of the f64 oracle."""
    gj, gt = _random_graphs(2, 200, 1500)
    cfg = PageRankConfig(num_iters=10, dtype="float64",
                         accum_dtype="float64", semantics=semantics,
                         kernel="coo")
    eng = TorchEngine(cfg, device="cpu").build(gt)
    assert eng.layout_info()["form"] == "coo"
    assert eng._r.shape == (gt.n,)
    oracle, _ = _jax_runs(gj, cfg)
    np.testing.assert_allclose(eng.run(), oracle, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kernel", ["auto", "ell", "pallas"])
def test_every_ell_kernel_name_runs_the_hand_kernel_form(kernel):
    _, gt = _random_graphs(1, 150, 900)
    eng = TorchEngine(PageRankConfig(kernel=kernel), device="cpu").build(gt)
    info = eng.layout_info()
    assert info["form"] == "flat_ell" and info["group"] == 1
    assert info["kernel"] == "ell_contrib:reference"  # the CPU twin


def test_set_ranks_resume_midway_is_bit_equal():
    _, gt = _random_graphs(4, 300, 2000)
    cfg = PageRankConfig(num_iters=10)
    full = TorchEngine(cfg, device="cpu").build(gt).run()
    first = TorchEngine(cfg, device="cpu").build(gt)
    first.run(num_iters=4)
    resumed = TorchEngine(cfg, device="cpu").build(gt)
    resumed.set_ranks(first.ranks(), iteration=4)
    np.testing.assert_array_equal(resumed.run(), full)


def test_ranks_from_jax_seeds_the_port():
    gj, gt = _random_graphs(6, 250, 1800)
    cfg = PageRankConfig(num_iters=8, dtype="float64", accum_dtype="float64")
    jeng = pagerank_tpu.JaxTpuEngine(
        _jax_cfg(cfg, kernel="pallas", num_devices=1)).build(gj)
    jeng.run(num_iters=3)
    eng = TorchEngine(cfg, device="cpu").build(gt)
    convert.ranks_from_jax(jeng.ranks(), eng, iteration=3)
    assert eng.iteration == 3
    r = eng.run()
    np.testing.assert_allclose(r, jeng.run(), rtol=0, atol=1e-12)


def _poison_once(eng, at):
    """Make the step at iteration ``at`` produce NaN ranks, once."""
    real = eng.step
    fired = []

    def step():
        if eng.iteration == at and not fired:
            fired.append(at)
            eng._r = eng._r * float("nan")
        return real()

    eng.step = step
    return fired


def test_unhealthy_step_rolls_back_to_a_snapshot(tmp_path):
    _, gt = _random_graphs(8, 200, 1500)
    cfg = PageRankConfig(num_iters=6, dtype="float64", accum_dtype="float64")
    clean = TorchEngine(cfg, device="cpu").build(gt).run()
    eng = TorchEngine(cfg, device="cpu").build(gt)
    snap = Snapshotter(str(tmp_path), gt.fingerprint(), cfg.semantics)
    fired = _poison_once(eng, 3)
    r = eng.run(on_iteration=lambda i, info: snap.save(i + 1, eng.ranks()),
                snapshotter=snap)
    assert fired == [3]
    assert eng.health == {"rollbacks": 1, "first_bad_iteration": 3}
    np.testing.assert_array_equal(r, clean)


def test_unhealthy_step_without_snapshots_raises():
    _, gt = _random_graphs(8, 200, 1500)
    eng = TorchEngine(PageRankConfig(num_iters=5), device="cpu").build(gt)
    _poison_once(eng, 2)
    with pytest.raises(SolverHealthError, match="iteration 2") as ei:
        eng.run()
    assert ei.value.first_bad_iteration == 2
