"""``parallel/comms.py``: the dense exchange byte model, its
publication, and the load prediction from a graph profile, against the
JAX package's functions on the same inputs and the same profile."""

import numpy as np
import pytest

import pagerank_tpu
from pagerank_tpu.obs import graph_profile as jax_profile
from pagerank_tpu.parallel import comms as jax_comms

import pagerank_tpu_torch
from pagerank_tpu_torch.engines.torch_engine import TorchEngine
from pagerank_tpu_torch.obs import graph_profile
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.parallel import comms
from pagerank_tpu_torch.parallel import mesh as mesh_lib
from pagerank_tpu_torch.utils.config import PageRankConfig
from pagerank_tpu_torch.utils.synth import rmat_edges


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("items", [(4, 4), (8, 8), (4, 8)])
@pytest.mark.parametrize("rs", [True, False])
def test_dense_model_equals_the_jax_model(ndev, items, rs):
    blk = 4096 // ndev
    assert comms.dense_exchange_bytes(ndev, blk, *items, rs) == \
        jax_comms.dense_exchange_bytes(ndev, blk, *items, rs)
    assert comms.model_dense(ndev, blk, *items, rs) == \
        jax_comms.model_dense(ndev, blk, *items, rs)


def test_register_publishes_the_gauges_and_the_counter():
    reg = obs_metrics.get_registry()
    reg.reset()
    assert comms.register(comms.model_dense(1, 1024, 4, 4)) is None
    counter = comms.register(comms.model_dense(4, 1024, 4, 8))
    counter.inc(7)
    snap = reg.snapshot()
    want = comms.dense_exchange_bytes(4, 1024, 4, 8)
    assert snap["gauges"]["comms.bytes_per_iter"] == want
    assert snap["gauges"]["comms.dense_bytes_per_iter"] == want
    assert snap["counters"]["comms.bytes_exchanged"] == 7
    assert "comms.halo_fraction" not in snap["gauges"]


@pytest.fixture(scope="module")
def graphs():
    src, dst = rmat_edges(11, edge_factor=8, seed=4)
    return (pagerank_tpu.build_graph(src, dst, n=1 << 11),
            pagerank_tpu_torch.build_graph(src, dst, n=1 << 11))


@pytest.mark.parametrize("span", [0, 512])
@pytest.mark.parametrize("ndev", [1, 2, 3, 8])
def test_load_prediction_equals_the_jax_prediction(graphs, span, ndev):
    theirs = jax_profile.profile_graph(graphs[0], partition_span=span)
    ours = graph_profile.profile_graph(graphs[1], partition_span=span)
    assert comms.predict_device_load(ours, ndev) == \
        jax_comms.predict_device_load(theirs, ndev)
    pred = comms.predict_from_profile(ours, ndev)
    jpred = jax_comms.predict_from_profile(theirs, ndev)
    for key in ("ndev", "predicted_straggler_skew", "predicted_device_edges"):
        assert pred[key] == jpred[key], key
    # The halo head-K prediction comes with the halo forms (slice 6b).
    assert pred["predicted_halo_head_k"] is None
    assert comms.predict_from_profile(None, ndev) is None


def test_publish_prediction_sets_the_graph_gauges(graphs):
    reg = obs_metrics.get_registry()
    reg.reset()
    pred = comms.predict_from_profile(
        graph_profile.profile_graph(graphs[1]), 4)
    comms.publish_prediction(pred)
    gauges = reg.snapshot()["gauges"]
    assert gauges["graph.predicted_straggler_skew"] == \
        pred["predicted_straggler_skew"]
    assert "graph.predicted_halo_head_k" not in gauges


@pytest.mark.parametrize("world", [2, 4])
def test_measured_device_edges_of_a_sharded_build(graphs, world):
    """Each rank's real slots in its share of the padded rows: they add
    up to the deduplicated edges."""
    import torch

    g = graphs[1]
    m = mesh_lib.Mesh(group=None, rank=0, world=world,
                      device=torch.device("cpu"))
    eng = TorchEngine(PageRankConfig(), device="cpu", mesh=m).build(g)
    got = comms.measured_device_edges(eng)
    assert got.shape == (world,) and got.sum() == g.num_edges
    assert comms.measured_device_edges(eng, world + 1) is None
    one = TorchEngine(PageRankConfig(), device="cpu").build(g)
    assert comms.measured_device_edges(one) is None
