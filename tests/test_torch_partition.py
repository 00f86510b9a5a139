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


# -- the halo plan (pagerank_tpu/parallel/partition.py:62-414) ---------------


def _random_graphs(n=512, e=4096, seed=0):
    return _graphs(seed, n, e)


def _rmat_graphs(scale=11, ef=8, seed=1):
    from pagerank_tpu_torch.utils.synth import rmat_edges

    src, dst = rmat_edges(scale, edge_factor=ef, seed=seed)
    return (pagerank_tpu.build_graph(src, dst, n=1 << scale),
            pagerank_tpu_torch.build_graph(src, dst, n=1 << scale))


def port_tables(g, world):
    """The port's flat pack as the vertex-sharded engine shares it: the
    sentinel table padded with inert rows to a multiple of world x 256,
    the padding rows' blocks the last real row's (as the engine hands
    ``build_halo_plan``), their dense ranks and present ids, and n_vs."""
    from pagerank_tpu_torch.ops import ell

    pack = ell.ell_pack(g)
    src, rows = ell.sentinel_slots(pack), pack.num_rows
    mult = world * 256
    pad = -(-rows // mult) * mult - rows
    src = np.concatenate([src, np.full((pad, 128), pack.n_padded,
                                       np.int32)])
    rb = np.concatenate([pack.row_block, np.full(pad, pack.row_block[-1],
                                                 np.int32)])
    ranks, ids, _, _ = ell.dense_block_ranks(rb, pack.num_blocks)
    unit = 128 * world
    return src, ranks, ids, -(-pack.n_padded // unit) * unit, pack.n_padded


def _plans(g, world, head_k):
    src, ranks, ids, n_vs, sz = port_tables(g, world)
    kw = dict(ndev=world, n_vs=n_vs, sz=sz, group=1, head_k=head_k)
    return (partition.build_halo_plan([src], [ranks], [ids], **kw),
            jax_partition.build_halo_plan([src], [ranks], [ids], **kw))


@pytest.mark.parametrize("graph_fn", [_random_graphs, _rmat_graphs])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("head_k", [-1, 0, 256])
def test_halo_plan_equals_the_jax_plan(graph_fn, world, head_k):
    """Every table, round and count of the port's plan equals the JAX
    ``build_halo_plan``'s on the port's slot tables."""
    ours, theirs = _plans(graph_fn()[1], world, head_k)
    for name in ("ndev", "n_vs", "blk", "head_k", "z_item", "accum_item",
                 "rs_merge", "boundary_entries"):
        assert getattr(ours, name) == getattr(theirs, name), name
    for name in ("read_rounds", "write_rounds"):
        assert [(r.offset, r.width, r.perm) for r in getattr(ours, name)] \
            == [(r.offset, r.width, r.perm) for r in getattr(theirs, name)]
    for name in ("send_idx", "recv_ids", "wsend_start", "wrecv_start"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    np.testing.assert_array_equal(ours.reads_per_pair, theirs.reads_per_pair)
    assert ours.summary() == theirs.summary()
    assert ours.overlappable_bytes_per_iter() == \
        theirs.overlappable_bytes_per_iter()


def _reference_read_sets(src, ndev, sz):
    """Each rank's read set decoded slot by slot in a plain loop (the
    oracle of ``tests/test_halo.py:62``)."""
    rpd = src.shape[0] // ndev
    out = [set() for _ in range(ndev)]
    for d in range(ndev):
        for w in src[d * rpd:(d + 1) * rpd].reshape(-1):
            if int(w) < sz:
                out[d].add(int(w))
    return [np.array(sorted(x), np.int64) for x in out]


@pytest.mark.parametrize("graph_fn", [_random_graphs, _rmat_graphs])
def test_read_sets_match_a_plain_loop(graph_fn):
    src, _, _, _, sz = port_tables(graph_fn()[1], 4)
    got = partition.device_read_sets([src], ndev=4, sz=sz, group=1)
    for a, b in zip(got, _reference_read_sets(src, 4, sz)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("graph_fn", [_random_graphs, _rmat_graphs])
def test_halo_tables_cover_every_remote_read_exactly_once(graph_fn):
    """Every remote read is in the head or lands in exactly one round;
    the sender's local indices are the receiver's global ids; pads are
    inert (``tests/test_halo.py:97``)."""
    g = graph_fn()[1]
    plan, _ = _plans(g, 4, 256)
    src, _, _, _, sz = port_tables(g, 4)
    ndev, blk, n_vs, K = plan.ndev, plan.blk, plan.n_vs, plan.head_k
    reads = partition.device_read_sets([src], ndev=ndev, sz=sz, group=1)
    got = [[] for _ in range(ndev)]
    for rnd, send, recv in zip(plan.read_rounds, plan.send_idx,
                               plan.recv_ids):
        assert send.shape == recv.shape == (ndev, rnd.width)
        senders = dict(rnd.perm)
        for d in range(ndev):
            row = recv[d][recv[d] < n_vs]
            s = (d - rnd.offset) % ndev
            if senders.get(s) != d:
                assert row.size == 0
                continue
            srow = send[s][send[s] < blk]
            np.testing.assert_array_equal(row, srow.astype(np.int64)
                                          + s * blk)
            assert np.all(row // blk == s) and s != d and np.all(row >= K)
            got[d].append(row)
    for d in range(ndev):
        have = np.concatenate(got[d]) if got[d] else np.zeros(0, np.int64)
        assert np.unique(have).size == have.size
        want = reads[d][(reads[d] // blk != d) & (reads[d] >= K)]
        np.testing.assert_array_equal(np.sort(have), want)


def test_write_windows_cover_every_band_overlap():
    """Each (writer, owner) overlap of a rank's band is one round's
    window: starting at the overlap, as wide, landing at the owner's
    matching offset (``tests/test_halo.py:145``)."""
    g = _rmat_graphs()[1]
    plan, _ = _plans(g, 4, -1)
    _, ranks, ids, n_vs, _ = port_tables(g, 4)
    blk = plan.blk
    bands = partition.device_write_bands([ranks], [ids], ndev=4, n_vs=n_vs)
    rounds = {r.offset: (r, ws, wr) for r, ws, wr in
              zip(plan.write_rounds, plan.wsend_start, plan.wrecv_start)}
    seen = 0
    for d, (lo, hi) in enumerate(bands):
        for p in range(4):
            s_lo, s_hi = max(lo, p * blk), min(hi, (p + 1) * blk)
            if p == d or s_lo >= s_hi:
                continue
            rnd, ws, wr = rounds[p - d]
            assert (d, p) in rnd.perm and ws[d] == s_lo
            assert rnd.width >= s_hi - s_lo and wr[p] == s_lo - p * blk
            seen += 1
    assert seen


def test_auto_head_k_minimizes_the_model():
    """The auto K's modelled bytes are at most the no-head plan's and an
    explicit K's (``tests/test_halo.py:177``)."""
    g = _rmat_graphs(scale=12, seed=2)[1]
    auto = _plans(g, 4, -1)[0].sparse_bytes_per_iter()
    assert auto <= _plans(g, 4, 0)[0].sparse_bytes_per_iter()
    assert auto <= _plans(g, 4, 4096)[0].sparse_bytes_per_iter()
