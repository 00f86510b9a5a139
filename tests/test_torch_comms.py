"""``parallel/comms.py``: the dense, sparse and asynchronous exchange
byte models, the async gate's overlap gain, their publication, and the
load and halo head-K prediction from a graph profile, against the JAX
package's functions on the same inputs, plans and profiles."""

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
    for key in ("ndev", "predicted_straggler_skew", "predicted_device_edges",
                "predicted_halo_head_k"):
        assert pred[key] == jpred[key], key
    assert comms.predict_halo_head_k(ours, ndev) == \
        jax_comms.predict_halo_head_k(theirs, ndev)
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
    assert gauges["graph.predicted_halo_head_k"] == \
        pred["predicted_halo_head_k"]


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


def _plans(g, world, head_k, items):
    """The port's and JAX's ``build_halo_plan`` on the same tables (the
    port's padded flat pack, as the engine shares it)."""
    from pagerank_tpu.parallel import partition as jax_partition

    from pagerank_tpu_torch.ops import ell
    from pagerank_tpu_torch.parallel import partition

    pack = ell.ell_pack(g)
    src, rows = ell.sentinel_slots(pack), pack.num_rows
    pad = -(-rows // (256 * world)) * 256 * world - rows
    src = np.concatenate([src, np.full((pad, 128), pack.n_padded,
                                       np.int32)])
    rb = np.concatenate([pack.row_block, np.full(pad, pack.row_block[-1],
                                                 np.int32)])
    ranks, ids, _, _ = ell.dense_block_ranks(rb, pack.num_blocks)
    kw = dict(ndev=world, n_vs=-(-pack.n_padded // (128 * world)) * 128
              * world, sz=pack.n_padded, group=1, head_k=head_k,
              z_item=items[0], accum_item=items[1])
    return (partition.build_halo_plan([src], [ranks], [ids], **kw),
            jax_partition.build_halo_plan([src], [ranks], [ids], **kw))


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("head_k", [-1, 0, 256])
@pytest.mark.parametrize("items", [(4, 4), (8, 8)])
def test_sparse_models_and_gain_equal_the_jax_functions(graphs, world,
                                                        head_k, items):
    ours, theirs = _plans(graphs[1], world, head_k, items)
    assert comms.model_sparse(ours) == jax_comms.model_sparse(theirs)
    assert comms.model_async(ours) == jax_comms.model_async(theirs)
    for ef in (0.0, 0.3, 0.5, 2.0):
        assert comms.predict_overlap_gain(ours, ef) == \
            jax_comms.predict_overlap_gain(theirs, ef)
    obs_metrics.get_registry().reset()
    # No measured exchange fraction: the standing assumption.
    assert comms.predict_overlap_gain(ours) == \
        jax_comms.predict_overlap_gain(theirs, comms.DEFAULT_EXCHANGE_FRACTION)
    obs_metrics.gauge("comms.exchange_fraction", "").set(0.5)
    assert comms.predict_overlap_gain(ours) == \
        comms.predict_overlap_gain(ours, 0.5)
    comms.publish_overlap_gain(0.25)
    snap = obs_metrics.get_registry().snapshot()["gauges"]
    assert snap["comms.predicted_overlap_gain"] == 0.25
    if world == 1:
        assert comms.model_sparse(ours)["bytes_per_iter"] == 0
        assert comms.predict_overlap_gain(ours) == 0.0


def test_register_publishes_the_sparse_gauges(graphs):
    reg = obs_metrics.get_registry()
    reg.reset()
    plan, _ = _plans(graphs[1], 4, 256, (4, 4))
    comms.register(comms.model_async(plan))
    gauges = reg.snapshot()["gauges"]
    assert gauges["comms.bytes_per_iter"] == plan.sparse_bytes_per_iter()
    assert gauges["comms.halo_fraction"] == plan.halo_fraction
    assert gauges["comms.head_k"] == 256


def test_expected_remote_readers_equal_the_jax_function():
    d = np.array([0.0, 1.0, 3.0, 48.0, 1e4])
    for ndev in (2, 4, 8):
        np.testing.assert_array_equal(
            comms._expected_remote_readers(d, ndev),
            jax_comms._expected_remote_readers(d, ndev))
