"""The port's host graph build and ELL pack against the JAX package's:
deterministic integer work, so every array must be bit-equal."""

import numpy as np
import pytest

import pagerank_tpu
from pagerank_tpu.ingest import records_to_graph
from pagerank_tpu.ops import ell as jax_ell
from pagerank_tpu.utils import synth as jax_synth

import pagerank_tpu_torch
from pagerank_tpu_torch import convert
from pagerank_tpu_torch.ops import ell as torch_ell
from pagerank_tpu_torch.utils import synth as torch_synth
from tests.test_cpu_engine import TOY_RECORDS

GRAPH_FIELDS = ("src", "dst", "out_degree", "in_degree", "dangling_mask",
                "zero_in_mask", "edge_weight")


def _edges(case):
    """(src, dst, kwargs) of one build_graph input, from a numpy seed."""
    rng = np.random.default_rng(11)
    if case == "toy":
        g, _ = records_to_graph(TOY_RECORDS)
        return g.src, g.dst, {"n": g.n,
                              "dangling_mask": g.dangling_mask}
    if case.startswith("rmat"):
        src, dst = jax_synth.rmat_edges(int(case[4:]), seed=3)
        return src, dst, {"n": 1 << int(case[4:])}
    if case == "dups_loops_isolated":  # PARITY C7, C9, C12
        src = rng.integers(0, 300, 2000)
        dst = rng.integers(0, 300, 2000)
        src = np.concatenate([src, src[:500], np.arange(50)])  # duplicates
        dst = np.concatenate([dst, dst[:500], np.arange(50)])  # self-loops
        return src, dst, {"n": 400}  # ids 300..399 isolated
    raise ValueError(case)


CASES = ["toy", "rmat10", "rmat12", "dups_loops_isolated"]


def _both(case):
    src, dst, kw = _edges(case)
    return (pagerank_tpu.build_graph(src, dst, **kw),
            pagerank_tpu_torch.build_graph(src, dst, **kw))


@pytest.mark.parametrize("case", CASES)
def test_build_graph_bit_equal(case):
    gj, gt = _both(case)
    assert gt.n == gj.n
    for name in GRAPH_FIELDS:
        a, b = getattr(gj, name), getattr(gt, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert gt.fingerprint() == gj.fingerprint()


@pytest.mark.parametrize("case", CASES)
def test_ell_pack_bit_equal(case):
    gj, gt = _both(case)
    pj, pt = jax_ell.ell_pack(gj), torch_ell.ell_pack(gt)
    assert (pt.n, pt.n_padded, pt.num_blocks, pt.num_real_edges) == (
        pj.n, pj.n_padded, pj.num_blocks, pj.num_real_edges)
    for name in ("src", "weight", "row_block", "perm", "inv_perm"):
        a, b = getattr(pj, name), getattr(pt, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("scale,seed", [(8, 0), (10, 5), (12, 1)])
def test_rmat_edges_bit_equal(scale, seed):
    for a, b in zip(jax_synth.rmat_edges(scale, seed=seed),
                    torch_synth.rmat_edges(scale, seed=seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def test_uniform_edges_bit_equal():
    for a, b in zip(jax_synth.uniform_edges(500, 4000, seed=2),
                    torch_synth.uniform_edges(500, 4000, seed=2)):
        np.testing.assert_array_equal(b, a)


def test_ell_spmv_reference_matches_csr():
    _, gt = _both("rmat10")
    pack = torch_ell.ell_pack(gt)
    r = np.random.default_rng(4).random(gt.n)
    y = torch_ell.ell_spmv_reference(pack, r[pack.perm])
    got = np.empty(gt.n)
    got[pack.perm] = y
    want = pagerank_tpu_torch.graph.to_csr_transpose(gt) @ r
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_graph_from_arrays_round_trips(case):
    gj, gt = _both(case)
    g = convert.graph_from_arrays(
        gj.n, gj.src, gj.dst, gj.out_degree, gj.in_degree,
        gj.dangling_mask, gj.zero_in_mask, gj.edge_weight,
    )
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(g, name), getattr(gt, name))
        assert getattr(g, name).dtype == getattr(gj, name).dtype
    assert g.fingerprint() == gj.fingerprint()


def test_graph_from_arrays_rejects_bad_shapes():
    gj, _ = _both("toy")
    with pytest.raises(ValueError, match="out_degree"):
        convert.graph_from_arrays(
            gj.n, gj.src, gj.dst, gj.out_degree[:-1], gj.in_degree,
            gj.dangling_mask, gj.zero_in_mask, gj.edge_weight,
        )
