"""``parallel/partition.py``: ``partition_edges`` against the JAX
package's on the same graphs — shapes, inert padding and per-chunk dst
order (``tests/test_sharding.py:30-61``), bit for bit."""

import numpy as np
import pytest

import pagerank_tpu
from pagerank_tpu.parallel import partition as jax_partition

import pagerank_tpu_torch
from pagerank_tpu_torch.parallel import partition


def _graphs(seed, n, e):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return (pagerank_tpu.build_graph(src, dst, n=n),
            pagerank_tpu_torch.build_graph(src, dst, n=n))


@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("n,e", [(50, 103), (64, 777), (16, 0)])
@pytest.mark.parametrize("wdt", [np.float32, np.float64])
def test_partition_edges_equals_the_jax_function(shards, n, e, wdt):
    gj, gt = _graphs(n + e, n, e)
    theirs = jax_partition.partition_edges(gj, shards, weight_dtype=wdt)
    ours = partition.partition_edges(gt, shards, weight_dtype=wdt)
    for name in ("src", "dst", "weight"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (ours.num_shards, ours.num_real_edges, ours.edges_per_shard) == (
        theirs.num_shards, theirs.num_real_edges, theirs.edges_per_shard)


def test_partition_shapes_padding_and_chunk_order():
    _, g = _graphs(0, 50, 103)  # 103 is not divisible by 8
    shards = partition.partition_edges(g, 8)
    assert shards.src.shape[0] % 8 == 0
    assert shards.num_real_edges == g.num_edges
    # padding is inert: weight 0, valid dst
    assert np.all(shards.weight[g.num_edges:] == 0)
    assert np.all(shards.dst[g.num_edges:] == g.n - 1)
    per = shards.edges_per_shard
    for i in range(8):  # per-chunk dst-sortedness
        chunk = shards.dst[i * per:(i + 1) * per]
        assert np.all(np.diff(chunk.astype(np.int64)) >= 0)


def test_partition_preserves_the_contribution_sum():
    _, g = _graphs(5, 64, 777)
    r = np.random.default_rng(5).random(g.n)
    dense = np.zeros(g.n)
    np.add.at(dense, g.dst, g.edge_weight * r[g.src])
    shards = partition.partition_edges(g, 8, weight_dtype=np.float64)
    acc = np.zeros(g.n)
    per = shards.edges_per_shard
    for i in range(8):
        sl = slice(i * per, (i + 1) * per)
        np.add.at(acc, shards.dst[sl], shards.weight[sl] * r[shards.src[sl]])
    np.testing.assert_allclose(acc, dense, rtol=1e-12)
    with pytest.raises(ValueError):
        partition.partition_edges(g, 0)
