"""The port's convergence probes (``pagerank_tpu_torch/obs/probes.py``,
``TorchEngine.step_probed``/``probe_values``, ``engine.run(probes=)``)
held against the JAX package on the same seeded input: the top-k ids
(engine space and original space) and the churn exactly, the rank mass
and the top-k mass within the f32 gate, the mass-ledger fields within
``ledger_tolerance``, flat (K1's plain version against the JAX pallas
kernel in interpret mode), partitioned (K2) and coo; a graph whose k-th
rank ties across many vertices; probed ranks bit-equal to unprobed ones;
one host transfer a probed step; zero probe calls when off; and the
rebuild repair of the engine's per-graph state."""

import numpy as np
import pytest
import torch

import pagerank_tpu
from pagerank_tpu import obs as jax_obs
from pagerank_tpu_torch import PageRankConfig, build_graph
from pagerank_tpu_torch import engine as engine_mod
from pagerank_tpu_torch.engines.torch_engine import TorchEngine
from pagerank_tpu_torch.obs import graph_profile
from pagerank_tpu_torch.obs.probes import ConvergenceProbes

FORMS = {"flat": {}, "partitioned": {"partition_span": 256},
         "coo": {"kernel": "coo"}}
JAX_FORMS = {"flat": {"kernel": "pallas"},
             "partitioned": {"kernel": "pallas", "partition_span": 256},
             "coo": {"kernel": "coo"}}
#: The f32 gate of the probe scalars (relative): the main path's f32
#: limit against the f64 oracle, here between two f32 reduction orders.
F32_GATE = 1e-4


def _edges(seed=7, n=1024, e=8192):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e), n


def _tied_edges(n=256, hubs=6):
    """Hubs 0..hubs-1 are fed by every other vertex; the rest have no
    in-edge, so they share one rank exactly: with k > hubs the k-th rank
    ties across n - hubs vertices."""
    others = np.arange(hubs, n)
    src = np.repeat(others, hubs)
    dst = np.tile(np.arange(hubs), n - hubs)
    # the hubs point at each other, so none is dangling
    src = np.concatenate([src, np.arange(hubs)])
    dst = np.concatenate([dst, (np.arange(hubs) + 1) % hubs])
    return src, dst, n


def _pair(form, edges, **kw):
    src, dst, n = edges
    port = TorchEngine(PageRankConfig(**FORMS[form], **kw),
                       device="cpu").build(build_graph(src, dst, n=n))
    jax_eng = pagerank_tpu.JaxTpuEngine(pagerank_tpu.PageRankConfig(
        num_devices=1, **JAX_FORMS[form], **kw)).build(
        pagerank_tpu.build_graph(src, dst, n=n))
    return port, jax_eng


def _probe_both(port, jax_eng, steps, k):
    pp, jp = ConvergenceProbes(1, topk=k), jax_obs.ConvergenceProbes(1, topk=k)
    out = []
    for i in range(steps):
        a, (ae, ao) = port.step_probed(pp)
        pp.commit(i, a, ae, ao)
        b, (be, bo) = jax_eng.step_probed(jp)
        jp.commit(i, b, be, bo)
        out.append((a, ae.numpy(), ao, b, np.asarray(be), np.asarray(bo)))
    return out


def _assert_probe_equal(a, ae, ao, b, be, bo, n):
    np.testing.assert_array_equal(ae, be)
    np.testing.assert_array_equal(ao, bo)
    assert a["topk_churn"] == b["topk_churn"]
    for key in ("rank_mass", "topk_mass", "l1_delta", "dangling_mass"):
        assert a[key] == pytest.approx(b[key], rel=F32_GATE), key
    la, lb = a["mass_ledger"], b["mass_ledger"]
    tol = graph_profile.ledger_tolerance(float(np.finfo(np.float32).eps), n)
    for key in ("normalized_mass", "teleport_mass", "link_mass",
                "retained_mass", "dangling_mass", "residual"):
        assert abs(la[key] - lb[key]) <= tol, key
    assert la["leak"] is None and lb["leak"] is None


@pytest.mark.parametrize("form", sorted(FORMS))
def test_step_probed_matches_the_jax_step_probed(form):
    edges = _edges()
    port, jax_eng = _pair(form, edges, num_iters=6)
    for rec in _probe_both(port, jax_eng, 5, 16):
        _assert_probe_equal(*rec, n=edges[2])


def test_tied_kth_rank_gives_the_jax_ids():
    edges = _tied_edges()
    port, jax_eng = _pair("flat", edges, num_iters=3)
    recs = _probe_both(port, jax_eng, 3, 16)
    r = port.ranks()
    # the k-th rank is shared by every non-hub vertex
    top = np.sort(r)[::-1]
    assert top[15] == top[16] == top[-1] and (r == top[-1]).sum() == 250
    for rec in recs:
        _assert_probe_equal(*rec, n=edges[2])
    # and the plain host version over the engine-space vector
    eng_r = port._r[: edges[2]].numpy().astype(np.float64)
    want = np.argsort(-eng_r, kind="stable")[:16]
    np.testing.assert_array_equal(recs[-1][1], want)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_probed_run_is_bit_identical_to_the_unprobed_run(form):
    src, dst, n = _edges(seed=3)
    g = build_graph(src, dst, n=n)
    cfg = PageRankConfig(num_iters=7, **FORMS[form])
    plain = TorchEngine(cfg, device="cpu").build(g).run()
    probes = ConvergenceProbes(2, topk=8)
    probed = TorchEngine(cfg, device="cpu").build(g).run(probes=probes)
    np.testing.assert_array_equal(plain, probed)
    assert [p["iteration"] for p in probes.history] == [1, 3, 5]
    assert not probes.ledger_violations


def test_probe_values_is_the_tail_of_the_state():
    src, dst, n = _edges(seed=5)
    eng = TorchEngine(PageRankConfig(num_iters=3), device="cpu").build(
        build_graph(src, dst, n=n))
    eng.run()
    mass, entered, ids_e, ids_o, tmass = eng.probe_values(10, None)
    r = eng.ranks().astype(np.float64)
    assert entered == 10 and mass == pytest.approx(r.sum(), rel=F32_GATE)
    np.testing.assert_array_equal(ids_o, eng._perm[ids_e.numpy()])
    assert tmass == pytest.approx(r[ids_o].sum(), rel=F32_GATE)
    assert eng.probe_values(10, ids_e)[1] == 0


def test_probed_step_makes_one_host_transfer(monkeypatch):
    """Every host read of a tensor outside the contribution (whose CPU
    plain version reads its plan on the host; on a card the bound
    kernel reads none) is counted: the probed step makes one, the plain
    step its two."""
    src, dst, n = _edges(seed=2)
    eng = TorchEngine(PageRankConfig(num_iters=3), device="cpu").build(
        build_graph(src, dst, n=n))
    calls, counting = [], [True]
    for name in ("cpu", "item", "tolist", "__float__", "__int__",
                 "__bool__"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **k):
            if counting[0]:
                calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    contrib = eng._contrib

    def quiet_contrib():
        counting[0] = False
        try:
            return contrib()
        finally:
            counting[0] = True

    monkeypatch.setattr(eng, "_contrib", quiet_contrib)
    probes = ConvergenceProbes(1, topk=8)
    info, ids = eng.step_probed(probes)
    assert calls == ["cpu"]
    probes.commit(0, info, *ids)
    calls.clear()
    eng.step_probed(probes)  # against the previous ids: still one
    assert calls == ["cpu"]
    calls.clear()
    eng.step()
    assert calls == ["__float__", "__float__"]


def test_probes_off_make_zero_probe_calls(monkeypatch):
    src, dst, n = _edges(seed=4)
    eng = TorchEngine(PageRankConfig(num_iters=4), device="cpu").build(
        build_graph(src, dst, n=n))

    def boom(*a, **k):
        raise AssertionError("probe machinery touched with probing off")

    for name in ("step_probed", "probe_values", "_probe_tail"):
        monkeypatch.setattr(TorchEngine, name, boom)
    for name in ("wants", "commit", "probe_boundary"):
        monkeypatch.setattr(ConvergenceProbes, name, boom)
    assert np.isfinite(eng.run()).all()
    assert np.isfinite(eng.run(num_iters=6, probes=ConvergenceProbes(0))).all()


def test_stop_tol_stops_at_a_probe_point():
    src, dst, n = _edges(seed=1)
    eng = TorchEngine(PageRankConfig(num_iters=50, semantics="textbook"),
                      device="cpu").build(build_graph(src, dst, n=n))
    probes = ConvergenceProbes(3, topk=4, stop_tol=1e-3)
    eng.run(probes=probes)
    assert eng.iteration % 3 == 0 and eng.iteration < 50
    assert probes.history[-1]["l1_residual"] <= 1e-3


def test_base_engine_probe_is_the_oracles(monkeypatch):
    """The base class's host probe (the CPU oracle's) with its ledger."""
    src, dst, n = _edges(seed=6)
    g = build_graph(src, dst, n=n)
    eng = engine_mod.make_engine("cpu", PageRankConfig(num_iters=2)).build(g)
    info, (ids_e, ids_o) = eng.step_probed(ConvergenceProbes(1, topk=5))
    assert info["mass_ledger"]["ok"] and info["topk_churn"] == 0
    r = eng.ranks()
    np.testing.assert_array_equal(ids_o, np.argsort(-r, kind="stable")[:5])


# -- the rebuild repair: every build starts from clean per-graph state -----


def _graph_of(n, seed):
    rng = np.random.default_rng(seed)
    e = 8 * n
    return rng.integers(0, n, e), rng.integers(0, n, e), n


def test_rebuild_on_a_larger_graph_checks_like_the_jax_engine():
    cfg = PageRankConfig(sdc_check_every=1, num_iters=3)
    port = TorchEngine(cfg, device="cpu")
    jax_eng = pagerank_tpu.JaxTpuEngine(pagerank_tpu.PageRankConfig(
        sdc_check_every=1, num_iters=3, num_devices=1, kernel="pallas"))
    for n, seed in ((300, 1), (700, 2)):
        src, dst, _ = _graph_of(n, seed)
        port.build(build_graph(src, dst, n=n))
        jax_eng.build(pagerank_tpu.build_graph(src, dst, n=n))
        port.run()
        jax_eng.run()
        a, ca = port.step_sdc()
        b, cb = jax_eng.step_sdc()
        for key in ("l1_delta", "dangling_mass", "rank_mass"):
            assert a[key] == pytest.approx(b[key], rel=F32_GATE), (n, key)
        for key in ("fp_in", "mass_in", "fp_out", "mass_out", "contrib",
                    "retained", "mass_prev"):
            np.testing.assert_allclose(float(ca[key].sum()),
                                       float(np.asarray(cb[key]).sum()),
                                       rtol=F32_GATE, err_msg=f"{n} {key}")


def test_same_n_rebuild_decodes_the_new_graphs_ranks():
    eng = TorchEngine(PageRankConfig(num_iters=3), device="cpu")
    for seed in (1, 2):
        src, dst, n = _graph_of(400, seed)
        eng.build(build_graph(src, dst, n=n))
        eng.run()
        np.testing.assert_array_equal(eng.decode_ranks(eng.device_ranks()),
                                      eng.ranks())
        assert eng.ledger_values() is None
