"""The partition-centric layout of the port (slice 2) against the JAX
package's: the striped pack, dense pair ranks, 3-byte words and the
pair expansion bit for bit; the span rule, the CLI's resolver and the
config rules; K2's plain twins against the interpret-mode Pallas kernel
(``ell_contrib_pallas_partitioned``); and the engine and the CLI against
``JaxTpuEngine(kernel="pallas", partition_span=...)`` and the f64
oracle. Inputs are made from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pagerank_tpu
from pagerank_tpu.engines.jax_engine import JaxTpuEngine
from pagerank_tpu.ingest import records_to_graph
from pagerank_tpu.ops import ell as jax_ell
from pagerank_tpu.ops import pallas_spmv
from pagerank_tpu.ops import spmv as jax_spmv
from pagerank_tpu.ops.device_build import plan_build
from pagerank_tpu.utils import synth as jax_synth

import pagerank_tpu_torch
from pagerank_tpu_torch import PageRankConfig, TorchEngine, cli
from pagerank_tpu_torch.ops import ell as torch_ell
from pagerank_tpu_torch.ops import ell_spmv, ell_spmv_partitioned
from pagerank_tpu_torch.ops import spmv as torch_spmv
from tests.test_cpu_engine import TOY_RECORDS

LANES = 128


# -- packing, bit-equal -----------------------------------------------------


def _edges(case):
    rng = np.random.default_rng(11)
    if case == "toy":
        g, _ = records_to_graph(TOY_RECORDS)
        return g.src, g.dst, {"n": g.n, "dangling_mask": g.dangling_mask}
    if case.startswith("rmat"):
        src, dst = jax_synth.rmat_edges(int(case[4:]), seed=3)
        return src, dst, {"n": 1 << int(case[4:])}
    # duplicates, self-loops, isolated vertices (ids 300..999)
    src, dst = rng.integers(0, 300, 2000), rng.integers(0, 300, 2000)
    src = np.concatenate([src, src[:500], np.arange(50)])
    dst = np.concatenate([dst, dst[:500], np.arange(50)])
    return src, dst, {"n": 1000}


def _both(case, **kw):
    src, dst, gkw = _edges(case)
    return (pagerank_tpu.build_graph(src, dst, **gkw, **kw),
            pagerank_tpu_torch.build_graph(src, dst, **gkw, **kw))


@pytest.mark.parametrize("span", [128, 256, 512])
@pytest.mark.parametrize("case", ["toy", "rmat10", "rmat12", "dups"])
def test_ell_pack_striped_bit_equal(case, span):
    gj, gt = _both(case)
    pj = jax_ell.ell_pack_striped(gj, stripe_size=span)
    pt = torch_ell.ell_pack_striped(gt, stripe_size=span)
    assert (pt.n, pt.n_padded, pt.num_blocks, pt.stripe_size,
            pt.num_real_edges, pt.n_stripes, pt.num_rows) == (
        pj.n, pj.n_padded, pj.num_blocks, pj.stripe_size,
        pj.num_real_edges, pj.n_stripes, pj.num_rows)
    for name in ("perm", "inv_perm"):
        a, b = getattr(pj, name), getattr(pt, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a, err_msg=name)
    for s in range(pj.n_stripes):
        for name in ("src", "weight", "row_block"):
            a, b = getattr(pj, name)[s], getattr(pt, name)[s]
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=f"{name}[{s}]")


def test_ell_pack_striped_keeps_duplicate_order():
    """With dedup off, duplicate edges tie in the sort key: the stable
    composite-key sort keeps them in input order, as the JAX lexsort."""
    gj, gt = _both("dups", dedup=False)
    pj = jax_ell.ell_pack_striped(gj, stripe_size=256)
    pt = torch_ell.ell_pack_striped(gt, stripe_size=256)
    for s in range(pj.n_stripes):
        np.testing.assert_array_equal(pt.src[s], pj.src[s])
        np.testing.assert_array_equal(pt.weight[s], pj.weight[s])


def test_dense_block_ranks_bit_equal():
    gj, gt = _both("rmat12")
    pt = torch_ell.ell_pack_striped(gt, stripe_size=512)
    cases = list(pt.row_block) + [
        np.zeros(0, np.int32),
        np.array([0, 0, 1, 2, 2, 2], np.int32),  # a prefix
        np.array([3, 3, 7, 9, 9], np.int32),  # not a prefix
    ]
    for rb in cases:
        got = torch_ell.dense_block_ranks(rb, pt.num_blocks)
        want = jax_ell.dense_block_ranks(rb, pt.num_blocks)
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[2:] == want[2:]


def test_pack_words24_matches_jax_and_round_trips():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 1 << 24, (9, LANES)).astype(np.int32)
    w[0, :4] = [0, 127, 128, (1 << 24) - 1]  # sign-bit bytes, the edges
    want = np.asarray(jax_spmv.pack_words24(w, np))
    got_np = torch_spmv.pack_words24(w)
    got_t = torch_spmv.pack_words24(torch.from_numpy(w))
    assert got_np.dtype == np.int8 and got_t.dtype == torch.int8
    assert got_np.shape == (9, 3 * LANES)
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(torch_spmv.unpack_words24(got_np), w)
    back = torch_spmv.unpack_words24(got_t)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), w)


@pytest.mark.parametrize("prefix", [True, False])
def test_scatter_block_sums_matches_jax(prefix):
    rng = np.random.default_rng(4)
    total = rng.random((12, LANES)).astype(np.float32)
    part = rng.random((5, LANES)).astype(np.float32)
    ids = np.arange(5) if prefix else np.array([0, 2, 3, 7, 11])
    want = np.asarray(jax_spmv.scatter_block_sums(
        jnp.asarray(total), jnp.asarray(part), jnp.asarray(ids), prefix))
    got_np = torch_spmv.scatter_block_sums(total.copy(), part, ids, prefix)
    got_t = torch_spmv.scatter_block_sums(
        torch.from_numpy(total.copy()), torch.from_numpy(part),
        torch.from_numpy(ids), prefix)
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)


# -- span rule, resolver, config --------------------------------------------


SPAN_CASES = [(1 << 23, 16 << 23), (1 << 16, 64 << 16), (1 << 24, 1 << 35),
              (1 << 12, 16 << 12), (1 << 23, 1 << 23), (0, 0),
              (1 << 23, None)]


def test_partition_span_rule_matches_jax():
    # tests/test_partitioned.py:301-317, then a sweep.
    cases = SPAN_CASES + [(1 << s, ef << s) for s in range(14, 27)
                          for ef in (1, 4, 8, 16, 32, 64, 256)]
    cases += [(1 << 22, 65_241_817), (1 << 22, 67_108_864),
              (1 << 18, 4_100_000), (3 << 20, 50_000_000)]
    for n_padded, e in cases:
        for z_item in (2, 4, 8):
            assert TorchEngine.partition_span(n_padded, e, z_item) == \
                JaxTpuEngine.partition_span(n_padded, e, z_item), (
                    n_padded, e, z_item)
    assert TorchEngine.partition_span(1 << 23, 16 << 23) == 1 << 21
    assert (TorchEngine.PART_MIN_CELL_EDGES, TorchEngine.PART_MAX_WINDOW_BYTES,
            TorchEngine.MAX_PARTITIONS) == (
        JaxTpuEngine.PART_MIN_CELL_EDGES, JaxTpuEngine.PART_MAX_WINDOW_BYTES,
        JaxTpuEngine.MAX_PARTITIONS)


@pytest.mark.parametrize("n,edges,span", [
    (1 << 16, 1 << 22, -1), (1 << 18, 4_100_000, -1), (1 << 22, 65_241_817, -1),
    (1 << 12, 1 << 16, -1), (5000, 40000, 512), (5000, 40000, 700),
    (5000, 40000, 100), (300, 4000, 4096), (1 << 20, 1 << 24, 3000),
])
@pytest.mark.parametrize("accum", ["float32", "float64"])
def test_cli_resolver_matches_plan_build(n, edges, span, accum):
    kw = dict(dtype=accum, accum_dtype=accum)
    want = plan_build(pagerank_tpu.PageRankConfig(**kw), n, host=True,
                      num_edges=edges, partition_span=span)[2]
    got = cli.plan_partition_span(PageRankConfig(**kw), n, edges, span)
    assert got == want
    if accum == "float64":
        assert got == 0


@pytest.mark.parametrize("kw,match", [
    # tests/test_partitioned.py:320-336
    (dict(partition_span=100), "multiple of 128"),
    (dict(partition_span=256, dtype="float64", accum_dtype="float64"),
     "32-bit"),
    (dict(partition_span=256, vertex_sharded=True), "vertex_sharded"),
    (dict(partition_span=256, kernel="coo"), "ell or pallas kernel"),
    (dict(stream_dtype="float16", partition_span=256), "stream_dtype"),
    (dict(stream_dtype="bfloat16"), "partition_span"),
])
def test_config_partition_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        PageRankConfig(**kw).validate()
    with pytest.raises(ValueError, match=match):
        pagerank_tpu.PageRankConfig(**kw).validate()


def test_valid_partition_configs_validate():
    for kernel in ("auto", "ell", "pallas"):
        PageRankConfig(partition_span=256, kernel=kernel,
                       stream_dtype="bfloat16").validate()


# -- K2's twins against the interpret-mode Pallas kernel ---------------------


def _partitioned_form(rng, *, K=2, psz=256, chunk=128, width=16,
                      rows_per_part=256, gw=128):
    """Copy of tests/test_pallas_spmv.py:_partitioned_form: a random toy
    partition-centric layout in the JAX engine's form (partition-local
    slot words with sentinel ``psz``, dense chunk-local pair ranks,
    per-chunk (partition, first-rank) bases), the window table, and an
    f64 numpy oracle."""
    rows = K * rows_per_part
    nc = rows // chunk
    pairs = nc * (width // 2)
    src = rng.integers(0, psz + 1, (rows, 128)).astype(np.int32)
    rk_g = ((np.arange(rows) * pairs) // rows).astype(np.int32)
    rb0 = rk_g[::chunk].copy()
    rk_loc = (rk_g - np.repeat(rb0, chunk)).astype(np.int32)
    part_ids = np.repeat(np.arange(K, dtype=np.int32),
                         rows_per_part // chunk)
    bases = np.stack([part_ids, rb0], 1).astype(np.int32)
    win_rows = (psz + gw) // 128
    zt = np.zeros((K, win_rows * 128), np.float32)
    zt[:, :psz] = rng.random((K, psz)).astype(np.float32)

    y64 = np.zeros((pairs, 128))
    for r in range(rows):
        p = part_ids[r // chunk]
        y64[rk_g[r]] += zt[p].astype(np.float64)[src[r]]
    return dict(src=src, rk_loc=rk_loc, bases=bases, zt=zt,
                win_rows=win_rows, pairs=pairs, chunk=chunk,
                width=width, oracle=y64.reshape(-1), part_ids=part_ids)


def _adversarial_form(rng, psz=256, chunk=128):
    """A layout with a pair deeper than SEG_ROWS (150 rows), an empty
    middle partition (one sentinel pair with no rows) and all-sentinel
    rows, in the same JAX form. Every partition's rows fill whole
    chunks."""
    pair_rows = [[150, 3, 40, 63], [], [1, 64, 65, 126]]
    K = len(pair_rows)
    src_parts, rk_parts, part_of_chunk = [], [], []
    pair_off = 0
    for p, counts in enumerate(pair_rows):
        pc = max(1, len(counts))
        rk = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
        s = rng.integers(0, psz + 1, (rk.size, 128)).astype(np.int32)
        src_parts.append(s)
        rk_parts.append(rk + pair_off)
        part_of_chunk += [p] * (rk.size // chunk)
        pair_off += pc
    src = np.concatenate(src_parts)
    src[150 + 3 + 20: 150 + 3 + 40] = psz  # 20 all-sentinel rows of pair 2
    src[256] = psz  # pair 5 (one row) is all sentinels
    rk_g = np.concatenate(rk_parts)
    rb0 = rk_g[::chunk].copy()
    rk_loc = rk_g - np.repeat(rb0, chunk)
    width = int(-(-(rk_loc.max() + 1) // 8) * 8)
    part_ids = np.asarray(part_of_chunk, np.int32)
    zt = np.zeros((K, 2 * psz), np.float32)
    zt[:, :psz] = rng.random((K, psz)).astype(np.float32)
    y64 = np.zeros((pair_off, 128))
    for r in range(rk_g.size):
        y64[rk_g[r]] += zt[part_ids[r // chunk]].astype(np.float64)[src[r]]
    return dict(src=src, rk_loc=rk_loc.astype(np.int32),
                bases=np.stack([part_ids, rb0], 1).astype(np.int32), zt=zt,
                win_rows=zt.shape[1] // 128, pairs=pair_off, chunk=chunk,
                width=width, oracle=y64.reshape(-1), part_ids=part_ids)


def _port_inputs(f):
    """The JAX form in the port's terms: global pair ranks per row and
    the partition of each pair (a pair with no rows keeps -1 until the
    empty partition's id is filled in)."""
    chunk = f["chunk"]
    rk_g = f["rk_loc"] + np.repeat(f["bases"][:, 1], chunk)
    part_of_row = np.repeat(f["part_ids"], chunk)
    pair_part = np.full(f["pairs"], -1, np.int32)
    pair_part[rk_g] = part_of_row
    # A pair never straddles partitions.
    assert np.array_equal(pair_part[rk_g], part_of_row)
    missing = np.flatnonzero(pair_part < 0)  # empty partitions' pairs
    for p in missing:
        pair_part[p] = pair_part[p - 1] + 1
    return rk_g.astype(np.int32), pair_part


def _jax_kernel(f, src, table):
    K = table.shape[0]
    return np.asarray(pallas_spmv.ell_contrib_pallas_partitioned(
        table.reshape(K, f["win_rows"], 128), src,
        jnp.asarray(f["rk_loc"].reshape(-1, 128)), jnp.asarray(f["bases"]),
        f["pairs"], chunk=f["chunk"], width=f["width"], gather="take",
        interpret=True,
    ))


def _pair_blocks(pair_part):
    """Blocks for the JAX form's pairs: a partition's pairs feed blocks
    0, 1, ... in order (the form has no blocks of its own)."""
    first = np.searchsorted(pair_part, pair_part)
    return np.arange(pair_part.size) - first, int((np.arange(
        pair_part.size) - first).max()) + 1


def _port_twins(f, words24, table):
    """The pair twins (atomic-order and segmented) and the block sums in
    the kernel's order, which a CPU tensor runs through the wrapper and
    which equal the segmented twin expanded in partition order, bit for
    bit; also the JAX kernel's pairs expanded the same way."""
    row_pair, pair_part = _port_inputs(f)
    src = torch.from_numpy(f["src"])
    if words24:
        src = torch_spmv.pack_words24(src)
    rp, pp = torch.from_numpy(row_pair), torch.from_numpy(pair_part)
    pair_block, nb = _pair_blocks(pair_part)
    plan = torch_ell.pair_plan(row_pair, f["pairs"], pair_block, nb,
                               sentinel=256)
    twin = ell_spmv_partitioned.ell_contrib_partitioned_reference(
        table, src, rp, pp, f["pairs"])
    seg = ell_spmv_partitioned.ell_contrib_partitioned_segmented_reference(
        table, src, pp, f["pairs"], plan=plan)
    blocks = ell_spmv_partitioned.ell_contrib_partitioned_plan_reference(
        table, src, pp, plan=plan)
    via = ell_spmv_partitioned.ell_contrib_partitioned(
        table, src, rp, pp, f["pairs"], plan=ell_spmv.plan_to(plan, "cpu"))
    assert torch.equal(via, blocks)  # a CPU tensor runs the plain version
    assert torch.equal(blocks, ell_spmv_partitioned.expand_pairs(
        seg, pp, pair_block, nb))
    return twin, seg, plan, blocks


def _expanded(y, f, plan):
    """JAX pair sums expanded into the port's blocks in partition order,
    in f64."""
    return ell_spmv_partitioned.expand_pairs(
        torch.from_numpy(np.asarray(y, np.float64)), _port_inputs(f)[1],
        plan.pair_block, plan.num_blocks).numpy()


FORMS = {"random": _partitioned_form, "adversarial": _adversarial_form}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("words24", [False, True])
def test_twins_match_interpret_pallas_f32(form, words24):
    f = FORMS[form](np.random.default_rng(5))
    src = jnp.asarray(f["src"])
    if words24:
        src = jax_spmv.pack_words24(src, jnp)
    want = _jax_kernel(f, src, jnp.asarray(f["zt"]))
    twin, seg, plan, blocks = _port_twins(f, words24,
                                          torch.from_numpy(f["zt"]))
    for got in (twin, seg):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-7)
        np.testing.assert_allclose(got.numpy(), f["oracle"], rtol=2e-6,
                                   atol=2e-7)
    assert blocks.dtype == torch.float32
    np.testing.assert_allclose(blocks.numpy(), _expanded(want, f, plan),
                               rtol=2e-6, atol=2e-7)
    if form == "adversarial":
        counts = np.diff(plan.block_seg_start)
        assert counts.max() >= 3 and (counts == 0).any()
        for p in (4, 5):  # the empty partition's pair, an all-sentinel pair
            assert not twin.view(-1, 128)[p].any()
            assert not seg.view(-1, 128)[p].any()


@pytest.mark.parametrize("form", sorted(FORMS))
def test_twins_match_interpret_pallas_bf16(form):
    f = FORMS[form](np.random.default_rng(13))
    tb = jnp.asarray(f["zt"], jnp.bfloat16)
    want = _jax_kernel(f, jnp.asarray(f["src"]), tb)
    table = torch.from_numpy(f["zt"]).to(torch.bfloat16)
    # Both sides round the same f32 table to bf16 (nearest even).
    np.testing.assert_array_equal(
        table.float().numpy(), np.asarray(tb.astype(jnp.float32)))
    twin, seg, plan, blocks = _port_twins(f, True, table)
    scale = np.abs(want).max()
    np.testing.assert_allclose(blocks.numpy(), _expanded(want, f, plan),
                               rtol=1e-5, atol=1e-6 * scale)
    for got in (twin, seg):
        assert got.dtype == torch.float32
        # Same bf16 values, f32 sums in another order: sum-order noise.
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * scale)
        # And the bf16 bound of tests/test_pallas_spmv.py:229-231.
        np.testing.assert_allclose(got.numpy(), f["oracle"], rtol=2**-7,
                                   atol=2**-8 * np.abs(f["oracle"]).max())


@pytest.mark.parametrize("seg_rows", [1, 7, 64])
def test_segmented_twin_tiles_pairs(seg_rows):
    f = _adversarial_form(np.random.default_rng(2))
    row_pair, pair_part = _port_inputs(f)
    plan = torch_ell.segment_plan(row_pair, f["pairs"], seg_rows)
    table = torch.from_numpy(f["zt"]).double()
    src = torch.from_numpy(f["src"])
    got = ell_spmv_partitioned.ell_contrib_partitioned_segmented_reference(
        table, src, torch.from_numpy(pair_part), f["pairs"], plan=plan)
    assert got.dtype == torch.float64  # an f64 table sums in f64
    np.testing.assert_allclose(got.numpy(), f["oracle"], rtol=1e-13,
                               atol=1e-13)


def _wrapper_args():
    return (torch.zeros(2, 384), torch.full((3, 384), 0, dtype=torch.int8),
            torch.zeros(3, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("bad,exc", [
    (dict(z=torch.zeros(2, 384, dtype=torch.float16)), TypeError),
    (dict(z=torch.zeros(768)), ValueError),
    (dict(src=torch.zeros(3, 384, dtype=torch.int64)), TypeError),
    (dict(src=torch.zeros(3, 128, dtype=torch.int8)), ValueError),
    (dict(src=torch.zeros(3, 384, dtype=torch.int32)), ValueError),
    (dict(rp=torch.zeros(2, dtype=torch.int32)), ValueError),
    (dict(rp=torch.zeros(3, dtype=torch.int64)), TypeError),
    (dict(pp=torch.zeros(2, dtype=torch.int32)), ValueError),
    (dict(src=torch.zeros(384, 3, dtype=torch.int8).t()), ValueError),
    (dict(z=torch.zeros(2, 384, device="meta")), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    z, src, rp, pp = _wrapper_args()
    with pytest.raises(exc):
        ell_spmv_partitioned.ell_contrib_partitioned(
            bad.get("z", z), bad.get("src", src), bad.get("rp", rp),
            bad.get("pp", pp), 1, plan=None)


# -- the engine ---------------------------------------------------------------


def _graphs(n=2000, e=60000, seed=5):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return (pagerank_tpu.build_graph(src, dst, n=n),
            pagerank_tpu_torch.build_graph(src, dst, n=n))


def _jax_pallas(gj, iters, span, stream=""):
    eng = JaxTpuEngine(pagerank_tpu.PageRankConfig(
        num_iters=iters, kernel="pallas", partition_span=span,
        stream_dtype=stream, num_devices=1)).build(gj)
    assert eng.layout_info()["form"] == "pallas_partitioned"
    return eng


def _oracle(gj, iters):
    return pagerank_tpu.ReferenceCpuEngine(pagerank_tpu.PageRankConfig(
        num_iters=iters, dtype="float64", accum_dtype="float64")).build(
        gj).run()


def _l1(a, b):
    return float(np.abs(a - b).sum() / np.abs(b).sum())


@pytest.mark.parametrize("span", [256, 512])
def test_engine_matches_jax_pallas_oracle_and_flat(span):
    gj, gt = _graphs()
    eng = TorchEngine(PageRankConfig(num_iters=10, partition_span=span),
                      device="cpu").build(gt)
    li = eng.layout_info()
    assert li["form"] == "pallas_partitioned"
    assert li["kernel"] == "ell_contrib_partitioned:reference"
    assert li["partition_span"] == span and li["words24"]
    r = eng.run()
    jeng = _jax_pallas(gj, 10, span)
    jli = jeng.layout_info()
    assert (li["partitions"], li["pairs"]) == (jli["partitions"], jli["pairs"])
    np.testing.assert_allclose(r, jeng.run(), rtol=1e-5, atol=1e-7)
    assert _l1(r, _oracle(gj, 10)) < 1e-5
    flat = TorchEngine(PageRankConfig(num_iters=10), device="cpu").build(gt)
    np.testing.assert_allclose(r, flat.run(), rtol=1e-5, atol=1e-7)
    # Slot rows: the JAX form pads each partition's rows to whole TPU
    # chunks with all-sentinel rows; the port keeps the packed rows.
    assert li["slot_rows"] == torch_ell.ell_pack_striped(
        gt, stripe_size=span).num_rows <= jli["slot_rows"]


@pytest.mark.parametrize("semantics", ["reference", "textbook"])
def test_engine_bf16_stream_within_its_bound(semantics):
    gj, gt = _graphs()
    cfg = PageRankConfig(num_iters=10, partition_span=512,
                         stream_dtype="bfloat16", semantics=semantics)
    eng = TorchEngine(cfg, device="cpu").build(gt)
    assert eng.layout_info()["z_dtype"] == "bfloat16"
    r = eng.run()
    oracle = pagerank_tpu.ReferenceCpuEngine(pagerank_tpu.PageRankConfig(
        num_iters=10, dtype="float64", accum_dtype="float64",
        semantics=semantics)).build(gj).run()
    # A REAL bf16 run: worse than f32 rounding, inside quantization
    # grade (tests/test_partitioned.py:298).
    assert 1e-7 < _l1(r, oracle) < 5e-3
    if semantics == "reference":
        jr = _jax_pallas(gj, 10, 512, "bfloat16").run()
        # A last-bit difference in an f32 sum can flip the bf16 rounding
        # of z in the next step.
        assert _l1(r, jr) <= 1e-3


def test_engine_resume_through_the_partitioned_form_is_bit_equal():
    _, gt = _graphs(seed=4)
    cfg = PageRankConfig(num_iters=10, partition_span=256)
    full = TorchEngine(cfg, device="cpu").build(gt).run()
    first = TorchEngine(cfg, device="cpu").build(gt)
    first.run(num_iters=4)
    resumed = TorchEngine(cfg, device="cpu").build(gt)
    resumed.set_ranks(first.ranks(), iteration=4)
    np.testing.assert_array_equal(resumed.run(), full)
    assert first.snapshot_meta()["partition_span"] == 256


def test_engine_explicit_span_larger_than_the_graph_is_one_partition():
    gj, gt = _graphs(n=300, e=4000)
    eng = TorchEngine(PageRankConfig(num_iters=5, partition_span=4096),
                      device="cpu").build(gt)
    li = eng.layout_info()
    assert li["partitions"] == 1 and li["partition_span"] == 384
    np.testing.assert_allclose(eng.run(), _jax_pallas(gj, 5, 4096).run(),
                               rtol=1e-5, atol=1e-7)


def test_partition_count_guard_raises():
    _, gt = _graphs(n=40000, e=80000)
    cfg = PageRankConfig(num_iters=1, partition_span=128)
    with pytest.raises(ValueError, match="partitions"):
        TorchEngine(cfg, device="cpu").build(gt)


# -- the CLI ----------------------------------------------------------------


def _final(snap_dir, it):
    return np.load(f"{snap_dir}/ranks_iter{it}.npz")["ranks"]


@pytest.mark.parametrize("spec,span,stream,want_span", [
    ("rmat:16", "-1", "", 1 << 15),
    ("rmat:11", "512", "bfloat16", 512),
])
def test_cli_partitioned_runs_and_resumes_bit_equal(tmp_path, capsys, spec,
                                                    span, stream, want_span):
    cut, ctrl, out = (str(tmp_path / d) for d in ("cut", "ctrl", "r.tsv"))
    base = ["--synthetic", spec, "--device", "cpu", "--partition-span", span]
    if stream:
        base += ["--stream-dtype", stream]
    s = cli.run(base + ["--iters", "3", "--snapshot-dir", cut])
    assert (s["form"], s["partition_span"]) == ("pallas_partitioned",
                                                want_span)
    assert s["partitions"] == -(-s["graph"].n // want_span)
    err = capsys.readouterr().err
    assert f"span {want_span:,}, K={s['partitions']} partitions" in err
    s = cli.run(base + ["--iters", "5", "--snapshot-dir", cut, "--resume",
                        "--out", out])
    assert s["resumed_from"] == 3
    cli.run(base + ["--iters", "5", "--snapshot-dir", ctrl])
    np.testing.assert_array_equal(_final(cut, 5), _final(ctrl, 5))
    ranks = np.loadtxt(out, delimiter="\t")[:, 1]
    np.testing.assert_array_equal(ranks.astype(np.float32), s["ranks"])


def test_cli_stream_without_span_notes_and_runs_flat(capsys):
    s = cli.run(["--synthetic", "rmat:9", "--device", "cpu", "--iters", "2",
                 "--stream-dtype", "bfloat16"])
    assert "--stream-dtype needs the partitioned layout" in \
        capsys.readouterr().err
    assert s["form"] == "flat_ell" and s["partition_span"] == 0


def test_cli_rounds_an_explicit_span_and_refuses_one_under_f64(capsys):
    s = cli.run(["--synthetic", "rmat:11", "--device", "cpu", "--iters", "2",
                 "--partition-span", "700"])
    assert "partition_span rounded 700 -> 640" in capsys.readouterr().err
    assert s["partition_span"] == 640 and s["partitions"] == 4
    with pytest.raises(SystemExit, match="32-bit"):
        cli.run(["--synthetic", "rmat:9", "--device", "cpu",
                 "--dtype", "float64", "--partition-span", "256"])
