"""K1's plain twin and the host segment plan against the JAX package's
interpret-mode Pallas kernel (ops/pallas_spmv.ell_contrib_pallas), on
identical sentinel-form inputs made from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pagerank_tpu
from pagerank_tpu.ops import pallas_spmv
from pagerank_tpu.utils import synth as jax_synth

import pagerank_tpu_torch
from pagerank_tpu_torch.ops import ell as torch_ell
from pagerank_tpu_torch.ops import ell_spmv
from pagerank_tpu_torch.ops import spmv as torch_spmv

CHUNK = 16


def _graph(case):
    rng = np.random.default_rng(3)
    if case == "random":
        n, e = 600, 5000
        return rng.integers(0, n, e), rng.integers(0, n, e), n
    src, dst = jax_synth.rmat_edges(10, seed=8)
    return src, dst, 1 << 10


def _sentinel_inputs(case, dtype):
    """(port inputs, padded JAX inputs, num_blocks) for one graph: the
    port's pack is unpadded, the JAX side pads rows to the 16-row chunk
    with all-sentinel rows, as tests/test_pallas_spmv.py does."""
    src, dst, n = _graph(case)
    pack = torch_ell.ell_pack(pagerank_tpu_torch.build_graph(src, dst, n=n))
    slots = torch_ell.sentinel_slots(pack)
    z = np.zeros(pack.n_padded + 8, dtype)
    z[:n] = np.random.default_rng(9).random(n).astype(dtype)
    rows = slots.shape[0]
    pad = -(-rows // CHUNK) * CHUNK - rows
    j_src = np.concatenate(
        [slots, np.full((pad, 128), pack.n_padded, np.int32)])
    j_rb = np.concatenate(
        [pack.row_block, np.full(pad, pack.num_blocks - 1, np.int32)])
    return ((torch.from_numpy(z), torch.from_numpy(slots),
             torch.from_numpy(pack.row_block), pack),
            (z, j_src, j_rb, j_rb[::CHUNK].copy()), pack.num_blocks)


@pytest.mark.parametrize("case", ["random", "rmat10"])
@pytest.mark.parametrize("dtype,tol", [
    (np.float32, dict(rtol=1e-6, atol=1e-7)),  # test_pallas_spmv.py:86
    (np.float64, dict(rtol=0, atol=1e-12)),
])
def test_twin_matches_interpret_pallas(case, dtype, tol):
    (z, src, rb, pack), (jz, jsrc, jrb, jrb0), nb = _sentinel_inputs(
        case, dtype)
    want = np.asarray(pallas_spmv.ell_contrib_pallas(
        jnp.asarray(jz), jnp.asarray(jsrc), jnp.asarray(jrb),
        jnp.asarray(jrb0), nb, chunk=CHUNK, accum_dtype=jnp.dtype(dtype),
        interpret=True,
    ))
    acc = torch.float32 if dtype == np.float32 else torch.float64
    got = ell_spmv.ell_contrib_reference(z, src, rb, nb, accum_dtype=acc)
    assert got.dtype == acc and got.shape == (nb * 128,)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    # The wrapper takes the plain version in the kernel's order for CPU
    # tensors — and only it; that version sits at the same gate.
    plan = ell_spmv.plan_to(
        torch_ell.segment_plan(pack.row_block, nb), "cpu")
    via = ell_spmv.ell_contrib(z, src, rb, nb, accum_dtype=acc, plan=plan)
    ordered = ell_spmv.ell_contrib_plan_reference(z, src, accum_dtype=acc,
                                                  plan=plan)
    assert torch.equal(via, ordered)
    np.testing.assert_allclose(ordered.numpy(), want, **tol)


def test_twin_matches_csr_oracle():
    """The twin on the engine-style prescaled z equals Aᵀ_norm r."""
    src, dst, n = _graph("rmat10")
    g = pagerank_tpu_torch.build_graph(src, dst, n=n)
    pack = torch_ell.ell_pack(g)
    r = np.random.default_rng(2).random(n)
    inv = pagerank_tpu_torch.graph.inv_out_degree(g.out_degree)
    z = np.zeros(pack.n_padded + 8)
    z[:n] = (r * inv)[pack.perm]
    y = ell_spmv.ell_contrib_reference(
        torch.from_numpy(z), torch.from_numpy(torch_ell.sentinel_slots(pack)),
        torch.from_numpy(pack.row_block), pack.num_blocks,
        accum_dtype=torch.float64).numpy()
    got = np.empty(n)
    got[pack.perm] = y[:n]
    want = pagerank_tpu.graph.to_csr_transpose(
        pagerank_tpu.build_graph(src, dst, n=n)) @ r
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _adversarial(seed=5, n=6000, hub_in=5000, extra=4000, sentinel_rows=40):
    """A pack with a hub block many segments deep, empty dst blocks, and
    appended all-sentinel rows (the JAX engine's row padding form)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(1, hub_in + 1),
                          rng.integers(0, n, extra)])
    dst = np.concatenate([np.zeros(hub_in, np.int64),
                          rng.integers(0, n // 5, extra)])
    pack = torch_ell.ell_pack(pagerank_tpu_torch.build_graph(src, dst, n=n))
    slots = np.concatenate([
        torch_ell.sentinel_slots(pack),
        np.full((sentinel_rows, 128), pack.n_padded, np.int32)])
    rb = np.concatenate([pack.row_block,
                         np.full(sentinel_rows, pack.num_blocks - 1,
                                 np.int32)])
    z = np.zeros(pack.n_padded + 8)
    z[:n] = rng.random(n)
    return z, slots, rb, pack.num_blocks


@pytest.mark.parametrize("dtype,acc,rtol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.float32, torch.float64, 1e-7),
    (torch.float64, torch.float64, 1e-12),
])
@pytest.mark.parametrize("seg_rows", [1, 7, torch_ell.SEG_ROWS])
def test_segmented_twin_matches_twin(dtype, acc, rtol, seg_rows):
    z, slots, rb, nb = _adversarial()
    plan = torch_ell.segment_plan(rb, nb, seg_rows)
    counts = np.diff(plan.block_seg_start)
    assert counts[0] >= 5000 // seg_rows  # hub block: many segments deep
    assert (counts == 0).any()  # empty blocks
    zt = torch.from_numpy(z).to(dtype)
    st, rt = torch.from_numpy(slots), torch.from_numpy(rb)
    got = ell_spmv.ell_contrib_segmented_reference(
        zt, st, nb, accum_dtype=acc, plan=plan)
    want = ell_spmv.ell_contrib_reference(zt, st, rt, nb, accum_dtype=acc)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rtol * scale
    # Blocks that only hold sentinel rows sum to exactly zero.
    assert torch.count_nonzero(got.reshape(nb, 128)[nb - 1]) == 0


def _random_row_block(rng, num_blocks):
    counts = rng.integers(0, 4, num_blocks) * rng.integers(0, 50, num_blocks)
    counts[rng.integers(0, num_blocks)] = 1000  # one deep block
    return np.repeat(np.arange(num_blocks, dtype=np.int32), counts)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("seg_rows", [1, 3, 64])
def test_segment_plan_tiles_every_block(seed, seg_rows):
    rng = np.random.default_rng(seed)
    nb = 40
    rb = _random_row_block(rng, nb)
    plan = torch_ell.segment_plan(rb, nb, seg_rows)
    rs, sb, bs = plan.seg_row_start, plan.seg_block, plan.block_seg_start
    assert rs.dtype == sb.dtype == bs.dtype == np.int32
    assert rs.shape == (plan.num_segments + 1,) and bs.shape == (nb + 1,)
    assert rs[0] == 0 and rs[-1] == rb.size == plan.num_rows
    lengths = np.diff(rs)
    assert (lengths >= 1).all() and (lengths <= seg_rows).all()
    assert (np.diff(sb) >= 0).all()
    for b in range(nb):
        rows = np.flatnonzero(rb == b)
        segs = np.arange(bs[b], bs[b + 1])
        assert (sb[segs] == b).all()
        covered = np.concatenate(
            [np.arange(rs[s], rs[s + 1]) for s in segs]) if segs.size else \
            np.zeros(0, np.int64)
        np.testing.assert_array_equal(covered, rows)


def test_segment_plan_empty_and_invalid():
    plan = torch_ell.segment_plan(np.zeros(0, np.int32), 3)
    assert plan.num_segments == 0
    np.testing.assert_array_equal(plan.block_seg_start, [0, 0, 0, 0])
    np.testing.assert_array_equal(plan.seg_row_start, [0])
    with pytest.raises(ValueError, match="ascending"):
        torch_ell.segment_plan(np.array([1, 0], np.int32), 2)
    with pytest.raises(ValueError, match="ascending"):
        torch_ell.segment_plan(np.array([0, 2], np.int32), 2)
    with pytest.raises(ValueError, match="seg_rows"):
        torch_ell.segment_plan(np.array([0], np.int32), 1, 0)


def _wrapper_args():
    z = torch.zeros(136)
    src = torch.full((3, 128), 128, dtype=torch.int32)
    rb = torch.zeros(3, dtype=torch.int32)
    return z, src, rb


@pytest.mark.parametrize("bad,exc", [
    (dict(z=torch.zeros(136, dtype=torch.float16)), TypeError),
    (dict(src=torch.full((3, 128), 128, dtype=torch.int64)), TypeError),
    (dict(src=torch.full((3, 64), 128, dtype=torch.int32)), ValueError),
    (dict(rb=torch.zeros(2, dtype=torch.int32)), ValueError),
    (dict(src=torch.full((128, 3), 128, dtype=torch.int32).t()), ValueError),
    (dict(acc=torch.float16), TypeError),
    (dict(z=torch.zeros(136, dtype=torch.float64), acc=torch.float32),
     TypeError),
    (dict(z=torch.zeros(136, device="meta")), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    z, src, rb = _wrapper_args()
    z, src, rb = bad.get("z", z), bad.get("src", src), bad.get("rb", rb)
    with pytest.raises(exc):
        ell_spmv.ell_contrib(z, src, rb, 1,
                             accum_dtype=bad.get("acc", torch.float32),
                             plan=None)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dangling_mass_matches_jax(dtype):
    from pagerank_tpu.ops import spmv as jax_spmv

    rng = np.random.default_rng(1)
    r = rng.random(1000).astype(dtype)
    mask = rng.random(1000) < 0.3
    want = float(jax_spmv.dangling_mass(jnp.asarray(r), jnp.asarray(mask),
                                        jnp.float64))
    got = torch_spmv.dangling_mass(torch.from_numpy(r),
                                   torch.from_numpy(mask), torch.float64)
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(want, rel=1e-14)
