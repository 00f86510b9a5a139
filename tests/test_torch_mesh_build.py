"""The device build and the coo form over a process group (the second
half of slice 6d), at gloo world 2 on the CPU: ``TorchEngine.
build_device`` of a graph that every rank built on its own device, and
``TorchEngine(kernel="coo")`` edge-sharded, against the JAX package at
``num_devices=2`` on the fake CPU devices of ``tests/conftest.py``
(``tests/test_device_build.py:98-110``; ``jax_engine.py:666-694``).

The ranks run as cases of the world-2 group that
``tests/test_torch_sharded.py`` spawns once a session (``MESH_CASES``):
each device-built form (edge-sharded flat, vertex-sharded, vs_halo,
edge-sharded partitioned) beside its host-built case. The device build
takes the graph's deduplicated edges, so its planes are the host
pack's: a rank's share is held equal to the host-built rank's and its
ranks bit-equal. f64 bounds against JAX: ``atol 1e-12``.
"""

import json

import numpy as np
import pytest
import torch

import pagerank_tpu
from pagerank_tpu import JaxTpuEngine
from pagerank_tpu.ops import device_build as jax_db

import pagerank_tpu_torch
from pagerank_tpu_torch.engines.torch_engine import TorchEngine
from pagerank_tpu_torch.ops import device_build as db
from pagerank_tpu_torch.parallel import mesh as mesh_lib
from pagerank_tpu_torch.utils.config import PageRankConfig
from pagerank_tpu_torch.utils.synth import rmat_edges

from tests.test_torch_sharded import (F64, ITERS, MESH_CASES, SCALE,
                                      world_results)

WORLD = 2
DEVICE_BUILT = {"flat64dev": "flat64", "vs64dev": "vs64",
                "halo64dev": "halo64", "part32dev": "part32"}


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return world_results(tmp_path_factory, WORLD)


@pytest.fixture(scope="module")
def graph_j():
    src, dst = rmat_edges(SCALE, edge_factor=8, seed=1)
    return pagerank_tpu.build_graph(src, dst, n=1 << SCALE)


@pytest.mark.parametrize("dev,host", sorted(DEVICE_BUILT.items()))
def test_device_built_ranks_are_the_host_built_ranks(res, dev, host):
    """Same planes, same shares, same kernel: bit-equal on every rank,
    at every stage of the run."""
    for r in range(WORLD):
        for key in ("first", "at4", "ranks", "stepped"):
            np.testing.assert_array_equal(res[dev][r][key],
                                          res[host][r][key])
        lay = json.loads(str(res[dev][r]["layout"]))
        assert lay["build"] == "device" and lay["world"] == WORLD
        assert lay["form"] == json.loads(str(res[host][r]["layout"]))["form"]


@pytest.mark.parametrize("dev", ["flat64dev", "vs64dev", "part32dev"])
def test_a_rank_keeps_its_share_of_the_host_pack(res, dev):
    """A rank's slot words and row groups are its share of the host
    pack's, as ``build`` slices them: the ranks' shares differ."""
    host = DEVICE_BUILT[dev]
    for r in range(WORLD):
        for key in ("planes_src", "planes_rows"):
            np.testing.assert_array_equal(res[dev][r][key],
                                          res[host][r][key])
    assert not np.array_equal(res[dev][0]["planes_src"],
                              res[dev][1]["planes_src"])


@pytest.mark.parametrize("name", ["flat64dev", "vs64dev"])
def test_device_build_matches_jax_at_two_devices(res, graph_j, name):
    """JAX's ``build_device`` at num_devices=2 from the same
    deduplicated edges, f64: within 1e-12."""
    config, _ = MESH_CASES[name]
    dg = jax_db.build_ell_device(graph_j.src, graph_j.dst, graph_j.n,
                                 weight_dtype=np.float64)
    want = JaxTpuEngine(pagerank_tpu.PageRankConfig(
        num_iters=ITERS, num_devices=WORLD, **config)).build_device(dg).run()
    np.testing.assert_allclose(res[name][0]["ranks"], want, rtol=0,
                               atol=1e-12)


def test_coo_form_matches_jax_at_two_devices(res, graph_j):
    """The edge-sharded coo form (each rank's chunk of the dst-sorted
    edges, one psum of the [n] sums) within 1e-12 of JAX's at
    num_devices=2, and of the port's own one-device coo run."""
    got = res["coo64"][0]["ranks"]
    want = JaxTpuEngine(pagerank_tpu.PageRankConfig(
        num_iters=ITERS, num_devices=WORLD, kernel="coo", **F64)).build(
            graph_j).run()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    src, dst = rmat_edges(SCALE, edge_factor=8, seed=1)
    one = TorchEngine(PageRankConfig(num_iters=ITERS, kernel="coo", **F64),
                      device="cpu").build(pagerank_tpu_torch.build_graph(
                          src, dst, n=1 << SCALE)).run()
    np.testing.assert_allclose(got, one, rtol=0, atol=1e-12)
    for r in range(WORLD):
        lay = json.loads(str(res["coo64"][r]["layout"]))
        assert (lay["form"], lay["world"], lay["rank"]) == ("coo", WORLD, r)
        # partition_edges: equal chunks of the edges, the tail padded
        assert lay["edges_per_rank"] == -(-lay["num_edges"] // WORLD)


def test_ranks_that_built_different_graphs_refuse_to_run(monkeypatch):
    """The ranks agree on the device graph before any share is kept: a
    gathered fingerprint that is not this rank's raises, naming every
    rank's (a mesh of two with its gather replaced, in one process)."""
    src, dst = rmat_edges(8, edge_factor=4, seed=2)
    dg = db.build_ell_device(torch.from_numpy(src), torch.from_numpy(dst),
                             1 << 8, with_weights=False, device="cpu")

    def gather(mesh, out, x):
        out.copy_(torch.cat([x, x + 1]))
        return out

    monkeypatch.setattr(mesh_lib, "all_gather", gather)
    mesh = mesh_lib.Mesh(group=object(), rank=0, world=2,
                         device=torch.device("cpu"))
    eng = TorchEngine(PageRankConfig(num_devices=2), device="cpu",
                      mesh=mesh)
    with pytest.raises(ValueError, match="different device graphs"):
        eng.build_device(dg)
