"""The host side of the one-launch K1 and K2 (csrc/ell_contrib.cu,
csrc/ell_contrib_partitioned.cu), on the CPU:

- the new host tables bit-exact: the empty-block lists, K2's pair ->
  block and block -> pairs tables, the head each CTA stages, the
  workspace shapes, and the kernels' constants as the sources declare
  them;
- the plain versions in the kernels' order (``ell_contrib_plan_reference``,
  ``ell_contrib_partitioned_plan_reference``) sum in plan order: bit-equal
  to an explicit row-by-row numpy loop at toy size, chunked finisher of
  the deep groups included, and to the first kernels' composition (the
  segmented twins, then ``expand_pairs``) wherever a group has at most
  ``CHUNK`` segments (everywhere, with the chunk taken past the deepest
  group; a block's pair sums are added in one run however many pairs
  feed it) — the card's check of each kernel leans on that order;
- the library path covers the shared header.
"""

import numpy as np
import pytest
import torch

import pagerank_tpu_torch as pt
from pagerank_tpu_torch.analysis import kernels as K
from pagerank_tpu_torch.kernels import build
from pagerank_tpu_torch.ops import ell as torch_ell
from pagerank_tpu_torch.ops import ell_spmv, ell_spmv_partitioned
from pagerank_tpu_torch.ops import spmv as torch_spmv
from pagerank_tpu_torch.utils import synth

LANES = 128


def _adversarial_graph(seed=5, n=6000, hub_in=5000, extra=4000):
    """A hub block many segments deep, empty dst blocks, isolated
    vertices (ids >= n // 2 relabeled last)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(1, hub_in + 1),
                          rng.integers(0, n // 2, extra)])
    dst = np.concatenate([np.zeros(hub_in, np.int64),
                          rng.integers(0, n // 5, extra)])
    return pt.build_graph(src, dst, n=n)


@pytest.fixture(scope="module")
def rmat12():
    src, dst = synth.rmat_edges(12, seed=4)
    return pt.build_graph(src, dst, n=1 << 12)


def _flat(graph, dtype=torch.float32, seed=0, sentinel_rows=0):
    eng = pt.TorchEngine(pt.PageRankConfig(), device="cpu").build(graph)
    eng.set_ranks(np.random.default_rng(seed).random(graph.n)
                  .astype(np.float32))
    z, src, rb, nb, _ = eng.contrib_inputs()
    if sentinel_rows:  # rows of sentinels only, appended to the last block
        src = torch.cat([src, torch.full((sentinel_rows, LANES),
                                         z.shape[0] - 8, dtype=torch.int32)])
        rb = torch.cat([rb, torch.full((sentinel_rows,), nb - 1,
                                       dtype=torch.int32)])
    plan = torch_ell.segment_plan(rb.numpy(), nb)
    return z.to(dtype), src, rb, nb, plan


def _partitioned(graph, span, stream="", seed=1):
    eng = pt.TorchEngine(pt.PageRankConfig(partition_span=span,
                                           stream_dtype=stream),
                         device="cpu").build(graph)
    eng.set_ranks(np.random.default_rng(seed).random(graph.n)
                  .astype(np.float32))
    return eng, eng.contrib_inputs()


# -- the host tables --------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_segment_plan_lists_the_empty_blocks(seed):
    rng = np.random.default_rng(seed)
    nb = 50
    counts = rng.integers(0, 3, nb) * rng.integers(0, 90, nb)
    rb = np.repeat(np.arange(nb, dtype=np.int32), counts)
    plan = torch_ell.segment_plan(rb, nb)
    assert plan.empty_groups.dtype == np.int32
    np.testing.assert_array_equal(plan.empty_groups,
                                  [b for b in range(nb) if counts[b] == 0])


def _pair_tables_by_loop(row_pair, num_pairs, pair_block, num_blocks):
    """The pair plan's block tables, built the slow way."""
    has_rows = np.zeros(num_pairs, bool)
    has_rows[row_pair] = True
    lists = [[p for p in range(num_pairs)
              if pair_block[p] == b and has_rows[p]]
             for b in range(num_blocks)]
    start = np.cumsum([0] + [len(x) for x in lists])
    return (start, [p for x in lists for p in x],
            [b for b in range(num_blocks) if not lists[b]])


@pytest.mark.parametrize("span", [512, 1024, 4096])
def test_pair_plan_tables_are_bit_exact(rmat12, span):
    eng, (zw, src, rp, pp, npairs, plan) = _partitioned(rmat12, span)
    assert isinstance(plan, torch_ell.PairPlan)
    assert plan.sentinel == eng.layout_info()["partition_span"]
    nb = plan.num_blocks
    assert nb == -(-rmat12.n // LANES)
    # pair_block: each partition's present blocks, in order
    pb = plan.pair_block.numpy()
    part = pp.numpy()
    for k in range(zw.shape[0]):
        mine = pb[part == k]
        assert (np.diff(mine) > 0).all()
    start, pairs, empty = _pair_tables_by_loop(rp.numpy(), npairs, pb, nb)
    np.testing.assert_array_equal(plan.block_pair_start.numpy(), start)
    np.testing.assert_array_equal(plan.block_pairs.numpy(), pairs)
    np.testing.assert_array_equal(plan.empty_blocks.numpy(), empty)
    for t in (plan.pair_block, plan.block_pair_start, plan.block_pairs,
              plan.empty_blocks, plan.empty_groups):
        assert t.dtype == torch.int32


def _items_by_loop(block_segs, seg_row_start,
                   whole=torch_ell.WHOLE * torch_ell.SEG_ROWS):
    def deep(segs):
        return sum(seg_row_start[s + 1] - seg_row_start[s]
                   for s in segs) > whole

    split = [[s] for segs in block_segs if deep(segs) for s in segs]
    return split + [list(segs) for segs in block_segs if not deep(segs)]


def _items(plan):
    st, segs = plan.item_start, plan.item_segs
    return [list(segs[st[i]:st[i + 1]]) for i in range(len(st) - 1)]


@pytest.mark.parametrize("seed", range(3))
def test_work_items_split_deep_blocks_and_keep_the_rest_whole(seed):
    rng = np.random.default_rng(seed)
    nb = 60
    counts = rng.integers(0, 3, nb) * rng.integers(0, 200, nb)
    rb = np.repeat(np.arange(nb, dtype=np.int32), counts)
    plan = torch_ell.segment_plan(rb, nb)
    bss = plan.block_seg_start
    block_segs = [list(range(bss[b], bss[b + 1])) for b in range(nb)
                  if bss[b + 1] > bss[b]]
    want = _items_by_loop(block_segs, plan.seg_row_start)
    assert _items(plan) == want
    # K1's segments are SEG_ROWS rows but a block's last: its rows pass
    # WHOLE x SEG_ROWS exactly when it has more than WHOLE segments
    assert plan.num_split == sum(len(x) for x in block_segs
                                 if len(x) > torch_ell.WHOLE)
    assert sorted(plan.item_segs) == list(range(plan.num_segments))
    assert plan.item_start.dtype == plan.item_segs.dtype == np.int32


@pytest.mark.parametrize("span", [512, 1024])
def test_pair_plan_items_are_whole_blocks_in_partition_order(rmat12, span):
    _, (zw, src, rp, pp, npairs, plan) = _partitioned(rmat12, span)
    pss = plan.block_seg_start.numpy()
    bps, bp = plan.block_pair_start.numpy(), plan.block_pairs.numpy()
    block_segs = [[s for p in bp[bps[b]:bps[b + 1]]
                   for s in range(pss[p], pss[p + 1])]
                  for b in range(plan.num_blocks) if bps[b + 1] > bps[b]]
    host = torch_ell.pair_plan(rp.numpy(), npairs, plan.pair_block.numpy(),
                               plan.num_blocks, plan.sentinel)
    assert _items(host) == _items_by_loop(block_segs, host.seg_row_start)
    # blocks of many short pairs stay whole: more than WHOLE segments in
    # one item, and no pair sum handed on
    nsegs = np.diff(host.item_start)[host.num_split:]
    assert host.num_split > 0 and (nsegs > torch_ell.WHOLE).any()


def test_pair_plan_leaves_out_a_pair_with_no_rows():
    """An empty partition keeps one sentinel pair with no row; it feeds
    no block's list, and a block no pair with rows feeds is empty."""
    plan = torch_ell.pair_plan(np.array([0, 0, 2, 2, 2], np.int32), 3,
                               np.array([1, 3, 1]), 4, sentinel=128)
    np.testing.assert_array_equal(plan.empty_groups, [1])
    np.testing.assert_array_equal(plan.block_pair_start, [0, 0, 2, 2, 2])
    np.testing.assert_array_equal(plan.block_pairs, [0, 2])
    np.testing.assert_array_equal(plan.empty_blocks, [0, 2, 3])
    with pytest.raises(ValueError, match="pair_block"):
        torch_ell.pair_plan(np.array([0], np.int32), 1, np.array([5]), 4,
                            sentinel=128)


def test_kernel_constants_are_the_sources():
    k1 = K.read_source("ell_contrib")
    k2 = K.read_source("ell_contrib_partitioned")
    for src in (k1, k2):
        assert src.const("kThreads") == ell_spmv.THREADS
        assert src.const("kGroups") == ell_spmv.GROUPS
        assert src.const("kBatch") == ell_spmv.BATCH
        assert src.const("kChunk") == ell_spmv.CHUNK
        assert src.const("kWhole") == torch_ell.WHOLE
    assert k1.kernels["ell_contrib_kernel"].static_smem \
        == k2.kernels["ell_contrib_part_kernel"].static_smem \
        == ell_spmv.STATIC_SMEM


@pytest.mark.parametrize("name,item,want", [
    ("ell_contrib", 4, 58_104),   # (232,448 - 32) // 4
    ("ell_contrib", 8, 29_052),
    ("ell_contrib_partitioned", 4, 58_104),
    ("ell_contrib_partitioned", 2, 116_208),
])
def test_head_is_what_fits_after_the_tickets(name, item, want):
    assert ell_spmv.head_capacity(item) == want
    sym = {"ell_contrib": "ell_contrib_kernel",
           "ell_contrib_partitioned": "ell_contrib_part_kernel"}[name]
    assert K.head_capacity(K.read_source(name), sym, item) == want
    assert ell_spmv.dynamic_smem(want, item) \
        <= 232_448 - ell_spmv.STATIC_SMEM
    assert ell_spmv.check_head(None, item, 10 ** 9) == want
    assert ell_spmv.check_head(None, item, 1000) == 1000
    assert ell_spmv.check_head(0, item, 1000) == 0
    with pytest.raises(ValueError, match="head"):
        ell_spmv.check_head(want + 1, item, 10 ** 9)


@pytest.mark.parametrize("items,grid", [(0, 1), (1, 1), (8, 1), (9, 2),
                                        (1056, 132), (10 ** 6, 132)])
def test_persistent_grid_is_one_cta_an_sm_at_most(items, grid):
    assert ell_spmv.persistent_grid(items) == grid


def test_workspace_shapes(rmat12):
    z, src, rb, nb, plan = _flat(rmat12)
    for acc in (torch.float32, torch.float64):
        w = ell_spmv.workspace(plan, acc, "cpu")
        assert w.partial.shape == w.chunk_sum.shape \
            == (plan.num_segments, LANES)
        assert w.partial.dtype == w.chunk_sum.dtype == acc
        assert w.counter.shape == (nb + plan.num_segments,)
        assert w.counter.dtype == torch.int32
        assert not w.counter.any()
    _, (zw, _, _, _, npairs, pplan) = _partitioned(rmat12, 1024)
    w = ell_spmv_partitioned.workspace(pplan, "cpu")
    assert w.partial.shape == w.chunk_sum.shape \
        == (pplan.num_segments, LANES)
    assert w.pair_sum.shape == (npairs, LANES)
    assert w.counter.shape == (npairs + pplan.num_blocks
                               + pplan.num_segments,)
    assert w.partial.dtype == w.chunk_sum.dtype == w.pair_sum.dtype \
        == torch.float32
    assert w.counter.dtype == torch.int32 and not w.counter.any()


# -- the plain versions sum in plan order -------------------------------------


def _finish_loop(part, s0, s1, acc, chunk=ell_spmv.CHUNK):
    """A group's partials [s0, s1) in the kernels' order, in numpy."""
    if s1 - s0 == 1:
        return part[s0]
    if s1 - s0 <= chunk:
        t = np.zeros(LANES, acc)
        for s in range(s0, s1):
            t = t + part[s]
        return t
    t = np.zeros(LANES, acc)
    for c0 in range(s0, s1, chunk):
        c = np.zeros(LANES, acc)
        for s in range(c0, min(c0 + chunk, s1)):
            c = c + part[s]
        t = t + c
    return t


def _k1_loop(z, src, plan, acc):
    """K1 in plan order, row by row, in numpy."""
    z, src = z.numpy(), src.numpy()
    rs, bss = plan.seg_row_start, plan.block_seg_start
    part = np.zeros((plan.num_segments, LANES), acc)
    for s in range(plan.num_segments):
        a = np.zeros(LANES, acc)
        for r in range(rs[s], rs[s + 1]):
            a = a + z[src[r]].astype(acc)
        part[s] = a
    out = np.zeros((len(bss) - 1, LANES), acc)
    for b in range(len(bss) - 1):
        if bss[b + 1] > bss[b]:
            out[b] = _finish_loop(part, bss[b], bss[b + 1], acc)
    return out.reshape(-1).astype(z.dtype)


K1_DTYPES = [(torch.float32, torch.float32, np.float32),
             (torch.float32, torch.float64, np.float64),
             (torch.float64, torch.float64, np.float64)]


@pytest.mark.parametrize("z_dtype,acc,np_acc", K1_DTYPES)
def test_k1_plan_reference_is_the_row_by_row_loop(z_dtype, acc, np_acc):
    g = _adversarial_graph(n=3000, hub_in=2500, extra=2000)
    z, src, rb, nb, plan = _flat(g, z_dtype, sentinel_rows=9)
    assert np.diff(plan.block_seg_start).max() > ell_spmv.CHUNK  # chunked
    assert plan.empty_groups.size > 0
    got = ell_spmv.ell_contrib_plan_reference(z, src, accum_dtype=acc,
                                              plan=plan)
    want = _k1_loop(z, src, plan, np_acc)
    assert got.dtype == z_dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("z_dtype,acc,np_acc", K1_DTYPES)
@pytest.mark.parametrize("graph", ["rmat12", "adversarial"])
def test_k1_plan_reference_equals_the_two_pass_composition(
        rmat12, graph, z_dtype, acc, np_acc):
    """Bit-equal to the first kernel's two passes on every block of at
    most CHUNK segments; a deeper block (the adversarial hub) is summed
    chunk by chunk, which the two passes reproduce bit for bit when the
    chunk is taken past the deepest block."""
    g = rmat12 if graph == "rmat12" else _adversarial_graph()
    z, src, rb, nb, plan = _flat(g, z_dtype, sentinel_rows=20)
    a = ell_spmv.ell_contrib_plan_reference(z, src, accum_dtype=acc,
                                            plan=plan)
    b = ell_spmv.ell_contrib_segmented_reference(z, src, nb, accum_dtype=acc,
                                                 plan=plan)
    shallow = np.repeat(np.diff(plan.block_seg_start) <= ell_spmv.CHUNK,
                        LANES)
    assert torch.equal(a[shallow], b[shallow])
    assert graph == "rmat12" or not shallow.all()
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= 1e-5 * scale
    v = z[src.long()].to(acc)
    flat = ell_spmv.group_sums(ell_spmv.row_partials(v, plan),
                               plan.block_seg_start, chunk=10 ** 9)
    assert torch.equal(flat.reshape(-1).to(z_dtype), b)
    tp = ell_spmv.plan_to(plan, "cpu")
    assert torch.equal(a, ell_spmv.ell_contrib(z, src, rb, nb,
                                               accum_dtype=acc, plan=tp))


def _k2_loop(zw, src, pair_part, plan):
    """K2 in plan order, row by row, in numpy: pair sums, then each
    block's pairs in partition order."""
    acc = np.float64 if zw.dtype == torch.float64 else np.float32
    table = zw.to(torch.float64 if acc == np.float64 else torch.float32)
    table = table.numpy()
    words = (torch_spmv.unpack_words24(src) if src.dtype == torch.int8
             else src).numpy()
    rs, sp, pss = plan.seg_row_start, plan.seg_block, plan.block_seg_start
    part = np.zeros((plan.num_segments, LANES), acc)
    for s in range(plan.num_segments):
        a = np.zeros(LANES, acc)
        for r in range(rs[s], rs[s + 1]):
            a = a + table[pair_part[sp[s]]][words[r]]
        part[s] = a
    pairs = np.zeros((len(pss) - 1, LANES), acc)
    for p in range(len(pss) - 1):
        if pss[p + 1] > pss[p]:
            pairs[p] = _finish_loop(part, pss[p], pss[p + 1], acc)
    out = np.zeros((plan.num_blocks, LANES), acc)
    bps, bp = plan.block_pair_start, plan.block_pairs
    for b in range(plan.num_blocks):
        if bps[b + 1] - bps[b] == 1:
            out[b] = pairs[bp[bps[b]]]
            continue
        t = np.zeros(LANES, acc)
        for q in range(bps[b], bps[b + 1]):
            t = t + pairs[bp[q]]
        out[b] = t
    return out.reshape(-1)


def _k2_inputs(graph, span, table, words):
    eng, (zw, src, rp, pp, npairs, plan) = _partitioned(
        graph, span, "bfloat16" if table == torch.bfloat16 else "")
    if table == torch.float64:
        zw = zw.double()
    if words == "int32":
        src = torch_spmv.unpack_words24(src).contiguous()
    host = torch_ell.pair_plan(rp.numpy(), npairs, plan.pair_block.numpy(),
                               plan.num_blocks, plan.sentinel)
    return zw, src, rp, pp, npairs, host


K2_FORMS = [(torch.float32, "words24"), (torch.float32, "int32"),
            (torch.bfloat16, "words24"), (torch.bfloat16, "int32"),
            (torch.float64, "words24")]


@pytest.mark.parametrize("table,words", K2_FORMS)
def test_k2_plan_reference_is_the_row_by_row_loop(table, words):
    g = _adversarial_graph(n=8000, hub_in=2900, extra=2000)
    zw, src, rp, pp, npairs, plan = _k2_inputs(g, 2560, table, words)
    assert np.diff(plan.block_seg_start).max() > ell_spmv.CHUNK  # chunked
    assert (np.diff(plan.block_pair_start) > 1).any()
    assert plan.empty_blocks.size > 0 and plan.empty_groups.size > 0
    got = ell_spmv_partitioned.ell_contrib_partitioned_plan_reference(
        zw, src, pp, plan=plan)
    want = _k2_loop(zw, src, pp.numpy(), plan)
    assert got.dtype == (torch.float64 if table == torch.float64
                         else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("table,words", K2_FORMS)
@pytest.mark.parametrize("graph,span", [("rmat12", 1024),
                                        ("adversarial", 512)])
def test_k2_plan_reference_equals_segmented_then_expand(rmat12, graph, span,
                                                        table, words):
    """Bit-equal to the first kernel's pair sums expanded in partition
    order, here where no pair has more than CHUNK segments."""
    g = rmat12 if graph == "rmat12" else _adversarial_graph()
    zw, src, rp, pp, npairs, plan = _k2_inputs(g, span, table, words)
    assert np.diff(plan.block_seg_start).max() <= ell_spmv.CHUNK
    a = ell_spmv_partitioned.ell_contrib_partitioned_plan_reference(
        zw, src, pp, plan=plan)
    pairs = ell_spmv_partitioned.ell_contrib_partitioned_segmented_reference(
        zw, src, pp, npairs, plan=plan)
    b = ell_spmv_partitioned.expand_pairs(pairs, pp, plan.pair_block,
                                          plan.num_blocks)
    assert torch.equal(a, b)
    if table != torch.float64:
        assert torch.equal(a, ell_spmv_partitioned.ell_contrib_partitioned(
            zw, src, rp, pp, npairs, plan=ell_spmv.plan_to(plan, "cpu")))


def _hub_over_partitions_graph(seed=7, n=8192, hub_in=6000, extra=4000):
    """A hub vertex fed from sources all over the id range: at a span of
    128 (64 partitions) its block has a pair in every partition."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.permutation(np.arange(1, n))[:hub_in],
                          rng.integers(0, n, extra)])
    dst = np.concatenate([np.zeros(hub_in, np.int64),
                          rng.integers(0, n // 4, extra)])
    return pt.build_graph(src, dst, n=n)


@pytest.mark.parametrize("table,words", K2_FORMS)
def test_k2_block_of_more_than_chunk_pairs_sums_them_in_one_run(table,
                                                                words):
    """A split block fed by more than CHUNK pairs: the plan-order sums
    add its pair sums in one run from 0, in partition order (the
    kernel's block finisher), which is the row-by-row loop and the first
    kernel's pair sums expanded by expand_pairs, bit for bit."""
    g = _hub_over_partitions_graph()
    zw, src, rp, pp, npairs, plan = _k2_inputs(g, 128, table, words)
    assert zw.shape[0] == 64
    per_block = np.diff(plan.block_pair_start)
    split = np.zeros(plan.num_blocks, bool)
    split[plan.pair_block[plan.seg_block[plan.item_segs[:plan.num_split]]]] \
        = True
    assert (per_block[split] > ell_spmv.CHUNK).any()
    assert np.diff(plan.block_seg_start).max() <= ell_spmv.CHUNK
    got = ell_spmv_partitioned.ell_contrib_partitioned_plan_reference(
        zw, src, pp, plan=plan)
    np.testing.assert_array_equal(got.numpy(),
                                  _k2_loop(zw, src, pp.numpy(), plan))
    pairs = ell_spmv_partitioned.ell_contrib_partitioned_segmented_reference(
        zw, src, pp, npairs, plan=plan)
    assert torch.equal(got, ell_spmv_partitioned.expand_pairs(
        pairs, pp, plan.pair_block, plan.num_blocks))


def test_expand_pairs_equals_the_slice_and_index_adds(rmat12):
    """The ops-level expansion is the JAX engine's per-partition
    scatter_block_sums sequence (prefix slice adds where a partition's
    blocks are 0..P-1)."""
    _, (zw, src, rp, pp, npairs, plan) = _partitioned(rmat12, 1024)
    pairs = torch.from_numpy(np.random.default_rng(3).random(
        (npairs, LANES)).astype(np.float32))
    got = ell_spmv_partitioned.expand_pairs(pairs, pp, plan.pair_block,
                                            plan.num_blocks)
    total = torch.zeros((plan.num_blocks, LANES))
    part, pb = pp.numpy(), plan.pair_block.numpy()
    for k in range(zw.shape[0]):
        ids = pb[part == k]
        prefix = bool(np.array_equal(ids, np.arange(len(ids))))
        torch_spmv.scatter_block_sums(total, pairs[part == k],
                                      torch.from_numpy(ids).long(), prefix)
    assert torch.equal(got, total.reshape(-1))


# -- the build ----------------------------------------------------------------


def test_library_path_covers_the_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in build.CSRC_DIR.iterdir():
        if p.suffix in (".cu", ".cuh"):
            (csrc / p.name).write_bytes(p.read_bytes())
    assert (csrc / "ell_persistent.cuh").is_file()
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = build.library_path("ell_contrib")
    (csrc / "ell_persistent.cuh").write_text(
        (csrc / "ell_persistent.cuh").read_text() + "\n// edited\n")
    after = build.library_path("ell_contrib")
    assert before != after
    assert after.parent == build.BUILD_DIR


def test_layout_counts_script(capsys):
    """The script behind PERF.md's head shares and partition counts: its
    numbers equal the engine's own pack at a toy scale."""
    import json

    from pagerank_tpu_torch.scripts import layout_counts

    assert layout_counts.main(["--scale", "10", "--heads", "64", "512",
                               "--parts", "2", "4"]) == 0
    doc = json.loads(capsys.readouterr().out)
    src, dst = synth.rmat_edges(10, seed=0)
    g = pt.build_graph(src, dst, n=1 << 10)
    pack = torch_ell.ell_pack(g)
    real = pack.weight != 0
    assert doc["flat_rows"] == pack.num_rows
    assert doc["head"]["64"] == float((pack.src[real] < 64).mean())
    assert doc["sentinel_share"] == pytest.approx(1 - real.mean())
    for k, span in (("2", 512), ("4", 256)):
        eng = pt.TorchEngine(pt.PageRankConfig(partition_span=span),
                             device="cpu").build(g)
        lay = eng.layout_info()
        assert doc["partitions"][k] == {"span": span,
                                        "rows": lay["slot_rows"],
                                        "pairs": lay["pairs"]}
