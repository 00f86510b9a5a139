"""The vertex-sharded forms' parts that need no process group: the dealt
ELL pack of vs_bounded against the JAX package's
(``pagerank_tpu/ops/ell.py:155-235``), the halo plan the engine builds,
the async gate's refusals (``jax_engine.py:2445-2480``), the write
windows' exactly-once delivery across three owners, the mesh's
collectives over one rank (no ``torch.distributed`` call) and without a
group, and vs_bounded's refusal of a card-built graph."""

import numpy as np
import pytest
import torch

import pagerank_tpu
from pagerank_tpu.ops import ell as jax_ell

import pagerank_tpu_torch
from pagerank_tpu_torch.engines.torch_engine import TorchEngine
from pagerank_tpu_torch.ops import ell
from pagerank_tpu_torch.parallel import mesh as mesh_lib
from pagerank_tpu_torch.parallel import partition
from pagerank_tpu_torch.utils.config import PageRankConfig
from pagerank_tpu_torch.utils.synth import rmat_edges

CPU = torch.device("cpu")


def _rmat(scale=10, ef=8, seed=1):
    src, dst = rmat_edges(scale, edge_factor=ef, seed=seed)
    return (pagerank_tpu.build_graph(src, dst, n=1 << scale),
            pagerank_tpu_torch.build_graph(src, dst, n=1 << scale))


def _odd(n=1000, e=6000, seed=3):
    """A graph whose n is not a multiple of 128 (a partial block)."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return (pagerank_tpu.build_graph(src, dst, n=n),
            pagerank_tpu_torch.build_graph(src, dst, n=n))


def _mesh(world, rank=0, group=None):
    return mesh_lib.Mesh(group=group, rank=rank, world=world, device=CPU)


# -- the block deal (vs_bounded's pack) ---------------------------------------


@pytest.mark.parametrize("graph_fn", [_rmat, _odd])
@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_dealt_pack_equals_the_jax_pack(graph_fn, world):
    """``deal_block_order``, ``block_row_weights`` and the dealt
    ``ell_pack`` / ``ell_pack_striped`` bit for bit against the JAX
    package's, relabel included."""
    gj, gt = graph_fn()
    order = np.argsort(-gt.in_degree.astype(np.int64), kind="stable")
    n_pad = -(-gt.n // 128) * 128
    w = ell.block_row_weights(gt.in_degree[order], n_pad)
    np.testing.assert_array_equal(
        w, jax_ell.block_row_weights(gj.in_degree[order], n_pad, 1))
    np.testing.assert_array_equal(
        ell.deal_block_order(gt.n, n_pad, world, weights=w),
        jax_ell.deal_block_order(gj.n, n_pad, world, weights=w))
    ours, theirs = ell.ell_pack(gt, block_deal=world), jax_ell.ell_pack(
        gj, block_deal=world)
    for name in ("src", "weight", "row_block", "perm", "inv_perm"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name), err_msg=name)
    if world < 8:  # at 8 ranges of one block each nothing moves
        assert not np.array_equal(ours.perm, ell.ell_pack(gt).perm)
    sp, sj = (ell.ell_pack_striped(gt, 256, block_deal=world),
              jax_ell.ell_pack_striped(gj, 256, block_deal=world))
    for a, b in zip(sp.src + sp.row_block, sj.src + sj.row_block):
        np.testing.assert_array_equal(a, b)


# -- the halo forms' gate, windows and plan -----------------------------------


def _halo_cfg(**kw):
    return PageRankConfig(num_iters=4, vertex_sharded=True,
                          halo_exchange=True, **kw)


def test_async_gate_refuses_four_ways():
    """``off:stale_max_lag=0`` (the synchronous form, no buffer),
    ``off:single_device``, ``off:no_boundary`` and ``off:gain g <
    floor``; each engine runs vs_halo. Built as one rank's share
    without a group, which is all the gate reads."""
    _, g = _rmat()
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 100, 2000), rng.integers(0, 100, 2000)
    inner = pagerank_tpu_torch.build_graph(src, dst, n=512)
    cases = [
        (_halo_cfg(halo_async=True, stale_max_lag=0), g, 2,
         "off:stale_max_lag=0"),
        (_halo_cfg(halo_async=True, halo_async_min_gain=0.0), g, 1,
         "off:single_device"),
        # Edges among 100 vertices: every read of rank 0's rows is its
        # own block and rank 1 holds padding only.
        (_halo_cfg(halo_async=True, halo_async_min_gain=0.0), inner, 2,
         "off:no_boundary"),
        (_halo_cfg(halo_async=True, halo_async_min_gain=1.0), g, 2,
         "off:gain "),
    ]
    for cfg, graph, world, want in cases:
        eng = TorchEngine(cfg, device="cpu", mesh=_mesh(world)).build(graph)
        lay = eng.layout_info()
        assert lay["form"] == "vs_halo" and eng._carry is None
        assert lay["halo_async"].startswith(want), lay["halo_async"]
        assert "halo_buffer_width" not in lay
    assert lay["halo_async"].endswith(" < 1")
    on = TorchEngine(_halo_cfg(halo_async=True, halo_async_min_gain=0.0),
                     device="cpu", mesh=_mesh(2)).build(g)
    assert on.layout_info()["halo_async"] == "on:lag1"
    assert on.comms_model()["mode"] == "sparse_async"


def test_engine_plan_is_build_halo_plan_of_its_padded_table():
    """The engine hands ``build_halo_plan`` its whole padded table, the
    padding rows' blocks the last real row's, at the engine's dtypes."""
    from test_torch_partition import port_tables

    _, g = _rmat(scale=11)
    for world in (2, 4):
        src, ranks, ids, n_vs, sz = port_tables(g, world)
        want = partition.build_halo_plan(
            [src], [ranks], [ids], ndev=world, n_vs=n_vs, sz=sz, group=1,
            head_k=256, z_item=8, accum_item=8)
        eng = TorchEngine(_halo_cfg(halo_head=256, dtype="float64",
                                    accum_dtype="float64"), device="cpu",
                          mesh=_mesh(world, rank=world - 1)).build(g)
        assert eng._halo_plan.summary() == want.summary()
        for a, b in zip(eng._halo_plan.send_idx + eng._halo_plan.recv_ids,
                        want.send_idx + want.recv_ids):
            np.testing.assert_array_equal(a, b)
        assert eng.layout_info()["halo"] == want.summary()


def test_write_windows_deliver_each_partial_once_across_three_owners():
    """At world 4 one rank's band spans three owners and a window runs
    past its owner's block into the trash band; the engine's merge rule
    (own block + each received window at its landing, summed in round
    order) still gives every owner each rank's partial exactly once.
    Partials are integers, so every sum is exact."""
    from test_torch_partition import port_tables

    _, g = _rmat(scale=11)
    src, ranks, ids, n_vs, sz = port_tables(g, 4)
    plan = partition.build_halo_plan([src], [ranks], [ids], ndev=4,
                                     n_vs=n_vs, sz=sz, group=1)
    blk = plan.blk
    bands = partition.device_write_bands([ranks], [ids], ndev=4, n_vs=n_vs)
    assert max((hi - 1) // blk - lo // blk + 1 for lo, hi in bands) >= 3
    wmax = max(r.width for r in plan.write_rounds)
    assert any(wr[t] + r.width > blk for r, wr in
               zip(plan.write_rounds, plan.wrecv_start) for _, t in r.perm)
    rng = np.random.default_rng(1)
    flats = []
    for lo, hi in bands:
        f = np.zeros(n_vs + wmax)
        f[lo:hi] = rng.integers(1, 1000, hi - lo)
        flats.append(f)
    for p in range(4):
        buf = np.zeros(blk + wmax)
        for rnd, ws, wr in zip(plan.write_rounds, plan.wsend_start,
                               plan.wrecv_start):
            for d, t in rnd.perm:
                if t == p:
                    buf[wr[p]:wr[p] + rnd.width] += \
                        flats[d][ws[d]:ws[d] + rnd.width]
        got = flats[p][p * blk:(p + 1) * blk] + buf[:blk]
        want = sum(f[p * blk:(p + 1) * blk] for f in flats)
        np.testing.assert_array_equal(got, want)


# -- the mesh -----------------------------------------------------------------


def test_one_rank_calls_no_collective(monkeypatch):
    """A group of one calls no ``torch.distributed`` function: every
    collective is the identity (a one-device ``shard_map``), and every
    vertex-sharded form steps over such a mesh, its ranks the
    one-device flat run's bits."""
    import torch.distributed as dist

    def called(*a, **kw):
        raise AssertionError("torch.distributed called over one rank")

    for name in ("all_reduce", "all_gather_into_tensor", "all_gather_single",
                 "reduce_scatter_tensor", "reduce_scatter_single",
                 "batch_isend_irecv", "isend", "irecv", "send", "recv",
                 "barrier", "broadcast"):
        if hasattr(dist, name):
            monkeypatch.setattr(dist, name, called)
    m = mesh_lib.Mesh(group=object(), rank=0, world=1, device=CPU,
                      backend="gloo")
    assert not m.collective
    x = torch.arange(4.0)
    assert mesh_lib.psum(m, x) is x
    mesh_lib.psum(m, x, async_op=True).wait()
    out = torch.empty(4)
    assert torch.equal(mesh_lib.all_gather(m, out, x), x)
    assert torch.equal(mesh_lib.psum_scatter(m, out, x), x)
    assert torch.equal(mesh_lib.ppermute(m, out, x, ((0, 0),)), x)
    assert torch.equal(mesh_lib.ppermute(m, out, x, ()), torch.zeros(4))
    _, g = _rmat()
    one = TorchEngine(PageRankConfig(num_iters=4), device="cpu").build(g).run()
    for kw in (dict(), dict(halo_exchange=True, halo_head=256),
               dict(halo_exchange=True, halo_async=True,
                    halo_async_min_gain=0.0), dict(vs_bounded=True)):
        eng = TorchEngine(PageRankConfig(num_iters=4, vertex_sharded=True,
                                         **kw), device="cpu", mesh=m)
        np.testing.assert_array_equal(eng.build(g).run(), one)
        if eng.has_exchange_program():
            eng.time_exchange_split(iters=1, warmup=0)
            np.testing.assert_array_equal(eng.ranks(), one)


def test_ppermute_without_a_group_receives_only_from_itself():
    m = _mesh(2)
    x, out = torch.arange(3.0), torch.full((3,), 7.0)
    assert torch.equal(mesh_lib.ppermute(m, out, x, ((0, 1), (1, 0))),
                       torch.zeros(3))
    assert m.stage_p2p is False
    assert mesh_lib.make_mesh(1, device="cpu").stage_p2p is False


def test_bounded_refuses_a_card_built_graph():
    from pagerank_tpu_torch.ops import device_build

    src, dst = rmat_edges(6, edge_factor=8, seed=1)
    dg = device_build.build_ell_device(src, dst, 64, device="cpu")
    eng = TorchEngine(PageRankConfig(vertex_sharded=True, vs_bounded=True),
                      device="cpu", mesh=_mesh(1))
    with pytest.raises(ValueError, match="vs_bounded requires a host-built "
                       "graph"):
        eng.build_device(dg)
