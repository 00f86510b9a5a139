"""K1w, the k-column contribution SpMM of the PPR path
(``ops/ell_spmm.py``, ``csrc/ell_contrib_spmm.cu``), on the CPU:

- its row-major plain version, tile by tile, bit-equal to K1's plain
  plan-order version run column by column
  (``ell_spmv.ell_contrib_spmm_reference`` on the transposed columns)
  for every tile the source builds, and within tolerance of the JAX op
  (``pagerank_tpu/ops/spmv.py:ell_contrib_spmm``) on the same pack;
- its fold of block 0's lanes (the PPR engine's dangling mass) against
  ``fold_rows`` of the column reference's lanes;
- the wrapper's tile rule, layout and refusals, the workspace sized to
  the split blocks, the ``.cu`` constants against the wrapper's;
- the launch case (``analysis/kernels.py:k1w_case``) PTK001-005 clean
  on a real plan, and seeded defects in its geometry, workspace and
  fold caught;
- ``PprTorchEngine`` on the row-major layout: answers the same bits
  alone and in any batch.

The kernel itself runs only on the card: tests/test_torch_cuda.py."""

import re

import numpy as np
import pytest
import torch

import pagerank_tpu
import pagerank_tpu_torch
from pagerank_tpu.ops import ell as jax_ell
from pagerank_tpu.ops import spmv as jax_spmv
from pagerank_tpu_torch.analysis import kernels as K
from pagerank_tpu_torch.engines.ppr import PprTorchEngine
from pagerank_tpu_torch.ops import ell as torch_ell
from pagerank_tpu_torch.ops import ell_spmm, ell_spmv
from pagerank_tpu_torch.utils import synth

LANES = 128
PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.float64),
         (torch.float64, torch.float64)]


def _pack(scale=12, seed=3):
    src, dst = synth.rmat_edges(scale, seed=seed)
    g = pagerank_tpu_torch.build_graph(src, dst, n=1 << scale)
    pack = torch_ell.ell_pack(g)
    plan = torch_ell.segment_plan(pack.row_block, pack.num_blocks)
    return g, pack, plan, torch.from_numpy(torch_ell.sentinel_slots(pack))


@pytest.fixture(scope="module")
def packed():
    return _pack()


def _z2(pack, k, dtype, seed=0):
    z2 = torch.zeros((pack.n_padded + 8, k), dtype=torch.float64)
    z2[: pack.n] = torch.from_numpy(
        np.random.default_rng(seed).random((pack.n, k)))
    return z2.to(dtype)


@pytest.fixture(scope="module")
def column_sums(packed):
    """K1's plain plan-order version, column by column, of 64 columns in
    each dtype pair."""
    _, pack, plan, src = packed
    out = {}
    for zd, acc in PAIRS:
        z2 = _z2(pack, 64, zd)
        out[zd, acc] = (z2, ell_spmv.ell_contrib_spmm_reference(
            z2.T.contiguous(), src, accum_dtype=acc, plan=plan))
    return out


# -- the plain version -----------------------------------------------------------

@pytest.mark.parametrize("zd,acc", PAIRS)
@pytest.mark.parametrize("kt", ell_spmm.TILES)
@pytest.mark.parametrize("k", [1, 3, 8, 64])
def test_plain_version_equals_the_column_reference(packed, column_sums, zd,
                                                   acc, kt, k):
    _, pack, plan, src = packed
    z2, cols = column_sums[zd, acc]
    got = ell_spmm.ell_contrib_spmm_rows_reference(
        z2, src, accum_dtype=acc, plan=plan, k=k, kt=kt)
    assert got.shape == (pack.num_blocks * LANES, k) and got.dtype == zd
    assert torch.equal(got, cols[:k].T)


@pytest.mark.parametrize("zd,acc", PAIRS)
@pytest.mark.parametrize("kt", ell_spmm.TILES)
def test_mass_reference_folds_block_0s_lanes(packed, column_sums, zd, acc,
                                             kt):
    """What K1w leaves in ``mass``: block 0's 128 lane sums, in the sum's
    dtype, folded by ``fold_rows``; with z2 in the sum's dtype, the
    column reference's lanes folded bit for bit (the engine's CPU path),
    and each column the same bits at any width."""
    from pagerank_tpu_torch.ops import spmv as torch_spmv

    _, pack, plan, src = packed
    z2, cols = column_sums[zd, acc]
    got = ell_spmm.mass_reference(z2, src, accum_dtype=acc, plan=plan, k=64,
                                  kt=kt)
    assert got.shape == (64,) and got.dtype == acc
    if zd == acc:
        assert torch.equal(got, torch_spmv.fold_rows(cols[:, :LANES].T))
    exact = z2.double()[src[pack.row_block == 0].long()].sum((0, 1))
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(),
                               rtol=1e-6 if acc == torch.float32 else 1e-13)
    for k in (1, 3):
        assert torch.equal(ell_spmm.mass_reference(
            z2, src, accum_dtype=acc, plan=plan, k=k, kt=kt), got[:k])


@pytest.mark.parametrize("zd,acc,tol", [
    (torch.float64, torch.float64, 1e-12),
    (torch.float32, torch.float64, 1e-7),
    (torch.float32, torch.float32, 1e-5),
])
def test_plain_version_matches_the_jax_op_on_the_same_pack(zd, acc, tol):
    """The tolerances of tests/test_torch_ppr.py's
    test_spmm_plain_version_matches_the_jax_op_on_the_same_pack: the JAX
    op sums each block by segment_sum, in another order."""
    import jax.numpy as jnp

    src, dst = synth.rmat_edges(10, seed=2)
    gj = pagerank_tpu.build_graph(src, dst, n=1 << 10)
    gt = pagerank_tpu_torch.build_graph(src, dst, n=1 << 10)
    pj, pt = jax_ell.ell_pack(gj), torch_ell.ell_pack(gt)
    np.testing.assert_array_equal(pj.src, pt.src)
    k = 5
    z2 = torch.zeros((pt.n_padded + 8, ell_spmm.row_width(k, zd.itemsize)),
                     dtype=zd)
    z2[: pt.n, :k] = _z2(pt, k, zd)[: pt.n]
    slots = torch_ell.sentinel_slots(pt)
    plan = torch_ell.segment_plan(pt.row_block, pt.num_blocks)
    got = ell_spmm.ell_contrib_spmm_rows(
        z2, torch.from_numpy(slots), torch.from_numpy(pt.row_block),
        pt.num_blocks, accum_dtype=acc, plan=plan, k=k)
    assert got.shape == (pt.num_blocks * LANES, k) and got.dtype == zd
    # The JAX op: the batch is the row, sentinel row n_pad is zero.
    want = np.asarray(jax_spmv.ell_contrib_spmm(
        jnp.asarray(z2[: pt.n_padded + 1, :k].numpy()), jnp.asarray(slots),
        jnp.asarray(pj.row_block), pj.num_blocks,
        accum_dtype=jnp.float64 if acc == torch.float64 else jnp.float32))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * scale)


def test_wrapper_refuses_what_the_kernel_does_not_take(packed):
    _, pack, plan, src = packed
    rb = torch.from_numpy(pack.row_block)
    nb = pack.num_blocks
    z2 = torch.zeros((pack.n_padded + 8, 8))
    kw = {"accum_dtype": torch.float32, "plan": plan}
    with pytest.raises(ValueError, match="whole 16-byte vectors"):
        ell_spmm.ell_contrib_spmm_rows(z2[:, :6].contiguous(), src, rb, nb,
                                       k=6, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ell_spmm.ell_contrib_spmm_rows(
            torch.zeros((8, pack.n_padded + 8)).T, src, rb, nb, k=8, **kw)
    with pytest.raises(TypeError, match="no K1w entry"):
        ell_spmm.ell_contrib_spmm_rows(z2.double(), src, rb, nb, k=8, **kw)
    with pytest.raises(ValueError, match="outside"):
        ell_spmm.ell_contrib_spmm_rows(z2, src, rb, nb, k=9, **kw)
    with pytest.raises(ValueError, match="on cuda"):
        ell_spmm.bind_spmm(z2, src, nb, **kw)
    with pytest.raises(ValueError, match="not built"):
        ell_spmm.tile_width(3, 12)
    empty = ell_spmm.ell_contrib_spmm_rows(z2, src, rb, nb, k=0, **kw)
    assert empty.shape == (nb * LANES, 0)


# -- tiles, layout, workspace ------------------------------------------------------

@pytest.mark.parametrize("kc,kt,want", [
    (1, 8, 4), (3, 8, 4), (4, 8, 4), (5, 8, 8), (8, 8, 8), (64, 8, 8),
    (1, 64, 4), (9, 64, 16), (33, 64, 64), (64, 64, 64), (2, 4, 4)])
def test_a_call_runs_the_narrowest_tile_that_holds_its_columns(kc, kt, want):
    assert ell_spmm.tile_width(kc, kt) == want


@pytest.mark.parametrize("kt", ell_spmm.TILES)
@pytest.mark.parametrize("item", [4, 8])
def test_tile_geometry_fills_a_cta(kt, item):
    g = ell_spmm.geometry(kt, item)
    assert g.vec * g.threads_per_lane * g.vectors_per_thread == kt
    assert g.groups * g.group_threads == ell_spmm.THREADS
    assert g.threads_per_lane <= ell_spmm.THREADS // LANES
    assert g.batch * g.loads == ell_spmm.IN_FLIGHT
    assert g.vectors_per_thread % g.loads == 0


@pytest.mark.parametrize("width,item,kp", [(1, 4, 4), (3, 4, 4), (8, 4, 8),
                                           (64, 4, 64), (3, 8, 4),
                                           (5, 8, 6)])
def test_rows_are_whole_16_byte_vectors(width, item, kp):
    assert ell_spmm.row_width(width, item) == kp
    dtype = torch.float32 if item == 4 else torch.float64
    assert ell_spmm.z2_buffer(256, width, dtype, "cpu").shape == (264, kp)


def test_workspace_holds_the_split_blocks_only(packed):
    """Only a split block's segments write partials, and the relabel puts
    those blocks first: the workspace holds that prefix of the segments,
    one share a tile."""
    _, pack, plan, _ = packed
    extent = ell_spmm.split_extent(plan)
    split = plan.item_segs[: plan.num_split]
    assert plan.num_split and extent == split.max() + 1 == len(split)
    assert extent < plan.num_segments
    w = ell_spmm.workspace(plan, torch.float32, 64, 8, "cpu")
    assert (w.seg_stride, w.tiles, w.columns) == (extent, 8, 64)
    assert w.partial.numel() == w.chunk_sum.numel() == extent * LANES * 64
    assert w.counter.numel() == 8 * (pack.num_blocks + extent)
    assert not w.counter.any()
    assert ell_spmm.workspace(plan, torch.float32, 3, 64,
                              "cpu").columns == 64


def _defines(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_cu_constants_equal_the_wrapper():
    src = K.read_source("ell_contrib_spmm")
    assert src.const("kThreads") == ell_spmm.THREADS
    assert src.const("kLanes") == LANES
    assert src.const("kVecBytes") == ell_spmm.VECTOR_BYTES
    assert src.const("kInFlight") == ell_spmm.IN_FLIGHT
    assert src.const("kChunk") == ell_spmv.CHUNK
    assert src.const("kWhole") == torch_ell.WHOLE
    tiles = sorted({int(t) for t in re.findall(
        r"K1W_ENTRY\(Z, ACC, Z_T, ACC_T, (\d+)\)", src.text)})
    assert tuple(tiles) == ell_spmm.TILES and ell_spmm.KT in tiles
    k = src.kernels["ell_contrib_spmm_kernel"]
    # the tickets only: no head is staged, no dynamic shared memory
    assert k.static_smem == 4 * (ell_spmm.THREADS // LANES)
    assert not k.opt_in
    assert k.launch_bounds == ell_spmm.THREADS
    assert "Params" in src.text and "fold" in src.text


# -- the launch case ---------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_inputs():
    g, _, _, _ = _pack(14, seed=0)
    eng = PprTorchEngine(pagerank_tpu_torch.PageRankConfig(),
                         device="cpu").build(g).bind(64)
    return eng


@pytest.mark.parametrize("k", [1, 3, 8, 64])
@pytest.mark.parametrize("kt", [4, ell_spmm.KT, 64])
def test_launch_case_is_clean_on_a_real_plan(engine_inputs, k, kt):
    eng = engine_inputs
    case = K.k1w_case_from_inputs(
        "k1w", eng._z2, eng._src, eng._row_block, eng._num_blocks,
        eng._plan, k=k, kt=kt)
    assert K.check_kernel_case(case) == []
    t = ell_spmm.tile_width(k, kt)
    ln = case.launches[0]
    assert ln.key == f"ell_contrib_spmm_kernel<float,float,{t}>"
    assert ln.entry == ell_spmm.entry(torch.float32, torch.float32, t)
    assert case.operands["src"].passes == -(-k // t)
    got = K.derived_cost(case)
    for key in ("flops", "bytes"):
        assert abs(got[key] / case.cost_model[key] - 1) <= 0.25


def test_launch_case_of_one_tile_moves_the_bound():
    """At one tile K1w's traffic formula is the bound of the SpMM
    (k1_cost(columns=k)); each further tile reads the slots and plan
    once more."""
    args = (159_670, 1 << 20, 8_192, 6_198, 3, 4)
    assert K.k1w_cost(*args, 64) == K.k1_cost(*args, columns=64)
    slots_and_plan = 159_670 * 128 * 4 + (2 * 6_198 + 1 + 8_192 + 1 + 3) * 4
    assert K.k1w_cost(*args, 64, tiles=8)["bytes"] \
        == K.k1_cost(*args, columns=64)["bytes"] + 7 * slots_and_plan


@pytest.mark.parametrize("zd,acc", [("float32", "float64"),
                                    ("float64", "float64")])
def test_launch_case_of_each_entry_is_clean(engine_inputs, zd, acc):
    eng = engine_inputs
    z2 = torch.zeros((eng._n_state + 8, 64), dtype=getattr(torch, zd))
    case = K.k1w_case_from_inputs("k1w", z2, eng._src, eng._row_block,
                                  eng._num_blocks, eng._plan, k=64,
                                  accum_dtype=acc)
    assert K.check_kernel_case(case) == []
    assert case.launches[0].instance.startswith(
        {"float32": "float", "float64": "double"}[zd])


def _plan_kw(eng):
    plan = eng._plan
    return dict(seg_row_start=plan.seg_row_start.numpy(),
                block_seg_start=plan.block_seg_start.numpy(),
                seg_block=plan.seg_block.numpy(),
                item_start=plan.item_start.numpy(),
                item_segs=plan.item_segs.numpy(), num_split=plan.num_split,
                row_block=eng._row_block.numpy(), n_state=eng._n_state)


@pytest.mark.parametrize("short", [1, 2])
def test_a_workspace_segments_short_is_caught(engine_inputs, short):
    """Tiles share the workspace at a stride of split_extent segments:
    short of it, a tile's last partial rows land on the next tile's
    (a race where that tile writes them) and the last tile's run past
    the workspace."""
    kw = _plan_kw(engine_inputs)
    extent = ell_spmm.split_extent(engine_inputs._plan)
    found = K.check_kernel_case(K.k1w_case("k1w", k=64, kt=8,
                                           seg_stride=extent - short, **kw))
    msgs = [f.message for f in found if f.rule == "PTK003"]
    assert any("partial" in m and "outside its" in m for m in msgs), msgs
    if short == 2:
        assert any("partial" in m and "two CTAs" in m for m in msgs), msgs


def test_a_tile_that_skips_the_slots_is_caught(engine_inputs):
    """The slot rows must be read once a tile: a case whose src operand
    claims one pass more than its tiles make is short of a pass."""
    case = K.k1w_case("k1w", k=16, kt=8, **_plan_kw(engine_inputs))
    case.operands["src"].passes += 1
    msgs = [f.message for f in K.check_kernel_case(case)]
    assert any("src" in m and "fewer than 3 times" in m for m in msgs)


@pytest.mark.parametrize("defect", ["dropped", "doubled"])
def test_a_fold_not_written_once_a_tile_is_caught(engine_inputs, defect):
    """The lane group that finishes block 0 writes the fold's columns of
    its tile, once: a tile that skips it leaves a gap, a tile that
    writes another's columns races it."""
    case = K.k1w_case("k1w", k=16, kt=8, **_plan_kw(engine_inputs))
    ln = case.launches[0]
    folds = [a for a in ln.accesses if a.operand == "fold"]
    assert len(folds) == 2  # one a tile
    if defect == "dropped":
        ln.accesses.remove(folds[1])
        want = "never written"
    else:
        folds[1].lo, folds[1].hi = folds[0].lo, folds[0].hi
        want = "two CTAs"
    msgs = [f.message for f in K.check_kernel_case(case)
            if f.rule == "PTK003"]
    assert any("fold" in m and want in m for m in msgs), msgs


def test_a_block_that_is_not_whole_warps_trips_ptk002(engine_inputs,
                                                      tmp_path):
    from pathlib import Path

    csrc = Path(K.CSRC_DIR)
    text = (csrc / "ell_contrib_spmm.cu").read_text().replace(
        "constexpr int kThreads = 1024;", "constexpr int kThreads = 1000;")
    (tmp_path / "ell_contrib_spmm.cu").write_text(text)
    case = K.k1w_case("k1w", k=8, kt=8, csrc_dir=tmp_path,
                      **_plan_kw(engine_inputs))
    assert "PTK002" in {f.rule for f in K.check_kernel_case(
        case, csrc_dir=tmp_path)}


# -- the engine on the row-major layout ----------------------------------------------

def test_engine_keeps_the_chunk_row_major():
    g, _, _, _ = _pack(10, seed=1)
    eng = PprTorchEngine(pagerank_tpu_torch.PageRankConfig(
        num_iters=5, dtype="float32", accum_dtype="float32"),
        device="cpu").build(g)
    r = eng.solve_chunk(np.array([3, 9, 3]), 5)
    n_state = eng.layout_info()["n_state"]
    assert r.shape == (n_state, 3)
    assert eng._z2.shape == (n_state + 8, ell_spmm.row_width(3, 4))
    assert not eng._z2[n_state:].any()  # the sentinel rows stay zero
    assert torch.equal(r[:, 0], r[:, 2])  # a repeated source
    ids, vals = eng.topk(r, 7)
    assert ids.shape == vals.shape == (3, 7)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_a_source_alone_is_the_same_bits_as_in_its_batch(dtype):
    g, _, _, _ = _pack(12, seed=5)
    cfg = pagerank_tpu_torch.PageRankConfig(num_iters=8, dtype=dtype,
                                            accum_dtype=dtype)
    eng = PprTorchEngine(cfg, device="cpu").build(g)
    batch = np.array([0, 17, 999, 4095, 17, 5])
    together = eng.solve_chunk(batch, 8)
    for j in (1, 3):
        alone = eng.solve_chunk(batch[j: j + 1], 8)
        assert torch.equal(alone[:, 0], together[:, j])


@pytest.mark.parametrize("m", [0, 1, 2, 3, 7, 128, 1000])
def test_fold_rows_sums_each_column_the_same_in_any_batch(m):
    from pagerank_tpu_torch.ops import spmv as torch_spmv

    x = torch.from_numpy(np.random.default_rng(m).random((m, 6)))
    got = torch_spmv.fold_rows(x)
    assert got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), x.numpy().sum(0), rtol=1e-13,
                               atol=0)
    for j in range(6):
        assert torch.equal(torch_spmv.fold_rows(x[:, j:j + 1].clone())[0],
                           got[j])


@pytest.mark.parametrize("dtype,accum,tol", [("float64", "float64", 1e-13),
                                             ("float32", "float32", 1e-6)])
def test_dangling_block_gives_the_jax_mass(dtype, accum, tol):
    """The engine's extra dangling block: K1w sums each column's
    dangling entries (their z2 rows hold r itself) into 128 lanes, and
    the fold adds the lanes; within rounding of the JAX op's 2-D
    ``dangling_mass``, the contributions unchanged, and each column the
    same bits alone as in its batch."""
    g, _, _, _ = _pack(12, seed=7)
    eng = PprTorchEngine(pagerank_tpu_torch.PageRankConfig(
        dtype=dtype, accum_dtype=accum), device="cpu").build(g).bind(5)
    n_state, dt = eng._n_state, getattr(torch, dtype)
    dang = np.zeros(n_state, bool)
    dang[: g.n] = (g.out_degree == 0)[eng._perm]
    assert dang.any() and eng.layout_info()["dangling_rows"] == -(
        -int(dang.sum()) // LANES)
    r = torch.zeros((n_state, 5), dtype=dt)
    r[: g.n] = torch.from_numpy(np.random.default_rng(1).random((g.n, 5)))
    torch.mul(r, eng._inv_out[:, None], out=eng._z2[:n_state, :5])
    contrib, mass = eng._contrib(5)
    want = np.asarray(jax_spmv.dangling_mass(r.numpy(), dang, np.float64))
    np.testing.assert_allclose(mass.numpy(), want, rtol=tol, atol=0)
    z = r.double() * torch.from_numpy(np.where(dang, 0.0, 1.0))[:, None] \
        * eng._inv_out.double()[:, None]
    exact = ell_spmv.ell_contrib_spmm_reference(
        torch.cat([z, torch.zeros((8, 5), dtype=torch.float64)]).T
        .contiguous(), eng._src, accum_dtype=torch.float64, plan=eng._plan)
    np.testing.assert_allclose(contrib.double().numpy(),
                               exact.T[LANES: LANES + n_state].numpy(), rtol=0,
                               atol=tol * float(exact.abs().max()))
    for j in (0, 3):
        eng._z2[:n_state, :1] = eng._z2[:n_state, j:j + 1].clone()
        alone = eng._contrib(1)
        assert torch.equal(alone[1][0], mass[j])
        assert torch.equal(alone[0][:, 0], contrib[:, j])
        torch.mul(r, eng._inv_out[:, None], out=eng._z2[:n_state, :5])


def test_a_workspace_of_other_tiles_is_refused(packed):
    """A workspace made for fewer tiles than a binding needs is refused
    before anything launches (the tiles' counters would run past it)."""
    _, _, plan, _ = packed
    w = ell_spmm.workspace(plan, torch.float32, 64, 64, "cpu")
    assert (w.tiles, w.columns) == (1, 64)
    ell_spmm.check_workspace(w, plan, 64, 64, torch.float32, "cpu")
    for args in ((64, 8, torch.float32), (64, 64, torch.float64)):
        with pytest.raises(ValueError, match="workspace does not fit"):
            ell_spmm.check_workspace(w, plan, *args, "cpu")
