"""Convergence probes over a process group (the second half of slice
6d): ``TorchEngine.step_probed`` at gloo world 2 on the CPU, against
``JaxTpuEngine(num_devices=2)``'s probed run on the fake CPU devices of
``tests/conftest.py`` (``tests/test_telemetry.py:280-318``).

The ranks run as cases of the world-2 group that
``tests/test_torch_sharded.py`` spawns once a session
(``MESH_CASES``): the edge-sharded flat form (K1's plain version), the
edge-sharded partitioned form (K2's) and the vertex-sharded form, each
probed and beside its unprobed case, and the vertex-sharded form on the
tie graph, where every vertex ties and the top k (600) is wider than a
rank's block (512). Bounds: f64 ``rank_mass`` within 1e-12 relative of
JAX's, churn and top-k ids equal, probed ranks bit-equal to unprobed.
"""

import json

import numpy as np
import pytest

import pagerank_tpu
from pagerank_tpu import obs as jax_obs
from pagerank_tpu.engines.jax_engine import JaxTpuEngine

from tests.test_torch_sharded import (F64, ITERS, MESH_CASES, SCALE,
                                      _edges_tie, world_results)
from pagerank_tpu_torch.utils.synth import rmat_edges

WORLD = 2


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return world_results(tmp_path_factory, WORLD)


def _probes(res, name, rank=0):
    return json.loads(str(res[name][rank]["probes"]))


class _JaxRecorded(jax_obs.ConvergenceProbes):
    """The JAX package's probes, keeping each probe's top-k ids."""

    def __init__(self, every, topk):
        super().__init__(every, topk=topk)
        self.ids = []

    def commit(self, iteration, info, ids_engine, ids_original):
        self.ids.append([int(i) for i in ids_original])
        return super().commit(iteration, info, ids_engine, ids_original)


def _jax_probed(edges, config, probe):
    src, dst = edges
    g = pagerank_tpu.build_graph(src, dst, n=1 << SCALE)
    probes = _JaxRecorded(probe["every"], probe["topk"])
    eng = JaxTpuEngine(pagerank_tpu.PageRankConfig(
        num_iters=ITERS, num_devices=WORLD, **config)).build(g)
    ranks = eng.run(probes=probes)
    return ranks, probes


@pytest.mark.parametrize("probed,plain", [
    ("flat64probe", "flat64"), ("vs64probe", "vs64"),
    ("part32probe", "part32")])
def test_probed_ranks_are_bit_equal_to_unprobed(res, probed, plain):
    """Probing does not perturb the solve, on any form or rank: every
    stage of the run (1, 4 and 8 steps) and the step after set_ranks."""
    for r in range(WORLD):
        for key in ("first", "at4", "ranks", "stepped"):
            np.testing.assert_array_equal(res[probed][r][key],
                                          res[plain][r][key])


@pytest.mark.parametrize("name", ["flat64probe", "vs64probe",
                                  "part32probe", "vstie64probe"])
def test_every_rank_takes_the_same_probe(res, name):
    """The history (residual, mass, churn, concentration, ids) is the
    same on every rank: a ``--stop-tol`` stops every rank at one probe."""
    first = _probes(res, name)
    assert len(first) == ITERS // MESH_CASES[name][1]["probe"]["every"]
    for r in range(1, WORLD):
        assert _probes(res, name, r) == first


@pytest.mark.parametrize("name", ["flat64probe", "vs64probe"])
def test_probe_history_matches_jax(res, name):
    """Each probe's rank mass within 1e-12 relative of JAX's at
    num_devices=2, its churn and its top-k ids (original order) equal."""
    config, opts = MESH_CASES[name]
    ranks, probes = _jax_probed(rmat_edges(SCALE, edge_factor=8, seed=1),
                                config, opts["probe"])
    got = _probes(res, name)
    assert len(got) == len(probes.history) == ITERS
    for mine, theirs, ids in zip(got, probes.history, probes.ids):
        assert mine["iteration"] == theirs["iteration"]
        assert mine["rank_mass"] == pytest.approx(theirs["rank_mass"],
                                                  rel=1e-12)
        assert mine["topk_churn"] == theirs["topk_churn"]
        assert mine["ids"] == ids
    assert any(p["topk_churn"] for p in got[1:])  # the ids do move
    np.testing.assert_allclose(res[name][0]["ranks"], ranks, rtol=0,
                               atol=1e-12)


def test_tied_top_k_across_the_blocks_matches_jax(res):
    """Every vertex of the tie graph holds rank 1, so the top 600 is a
    tie broken by id alone, across both ranks' blocks of 512: the merge
    of the ranks' own top k orders by value, then id, as ``lax.top_k``
    over the whole vector does."""
    config, opts = MESH_CASES["vstie64probe"]
    _, probes = _jax_probed(_edges_tie(), config, opts["probe"])
    got = _probes(res, "vstie64probe")
    assert [p["ids"] for p in got] == probes.ids
    assert got[0]["ids"] == list(range(600))  # rank 1's block joins in
    assert all(p["topk_churn"] == 0 for p in got)
    for mine, theirs in zip(got, probes.history):
        assert mine["rank_mass"] == pytest.approx(theirs["rank_mass"],
                                                  rel=1e-12)
