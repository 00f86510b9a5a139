"""K1, K2 and the engine on the card. These need an NVIDIA GPU and nvcc:
on any other host each test skips with a reason. Run them on the card
with ``python -m pytest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import pagerank_tpu_torch
from pagerank_tpu_torch import PageRankConfig, TorchEngine
from pagerank_tpu_torch.ops import ell as torch_ell
from pagerank_tpu_torch.ops import ell_spmv, ell_spmv_partitioned
from pagerank_tpu_torch.ops import spmv as torch_spmv
from pagerank_tpu_torch.utils import synth

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(device, dtype):
    src, dst = synth.rmat_edges(12, seed=4)
    pack = torch_ell.ell_pack(pagerank_tpu_torch.build_graph(src, dst,
                                                             n=1 << 12))
    z = np.zeros(pack.n_padded + 8)
    z[: pack.n] = np.random.default_rng(0).random(pack.n)
    plan = torch_ell.segment_plan(pack.row_block, pack.num_blocks)
    return (torch.from_numpy(z).to(device=device, dtype=dtype),
            torch.from_numpy(torch_ell.sentinel_slots(pack)).to(device),
            torch.from_numpy(pack.row_block).to(device), pack.num_blocks,
            ell_spmv.plan_to(plan, device))


@pytest.mark.parametrize("dtype,acc,tol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.float32, torch.float64, 1e-6),
    (torch.float64, torch.float64, 1e-12),
])
def test_kernel_matches_twin_and_repeats_bitwise(cuda, dtype, acc, tol):
    z, src, rb, nb, plan = _inputs(cuda, dtype)
    before = ell_spmv.launches
    a = ell_spmv.ell_contrib(z, src, rb, nb, accum_dtype=acc, plan=plan)
    b = ell_spmv.ell_contrib(z, src, rb, nb, accum_dtype=acc, plan=plan)
    torch.cuda.synchronize()
    assert ell_spmv.launches == before + 2
    assert torch.equal(a, b)
    ref = ell_spmv.ell_contrib_reference(z, src, rb, nb, accum_dtype=acc)
    err = float((a.double() - ref.double()).abs().max())
    assert err <= tol * float(ref.double().abs().max())


@pytest.mark.parametrize("stream", ["", "bfloat16"])
@pytest.mark.parametrize("words", ["words24", "int32"])
def test_k2_matches_twin_and_repeats_bitwise(cuda, stream, words):
    src, dst = synth.rmat_edges(12, seed=4)
    g = pagerank_tpu_torch.build_graph(src, dst, n=1 << 12)
    eng = TorchEngine(PageRankConfig(partition_span=512,
                                     stream_dtype=stream)).build(g)
    assert eng.layout_info()["kernel"] == "ell_contrib_partitioned:cuda"
    eng.set_ranks(np.random.default_rng(1).random(g.n).astype(np.float32))
    zw, slots, rp, pp, npairs, plan = eng.contrib_inputs()
    if words == "int32":
        slots = torch_spmv.unpack_words24(slots).contiguous()
    before = ell_spmv_partitioned.launches
    a = ell_spmv_partitioned.ell_contrib_partitioned(zw, slots, rp, pp,
                                                     npairs, plan=plan)
    b = ell_spmv_partitioned.ell_contrib_partitioned(zw, slots, rp, pp,
                                                     npairs, plan=plan)
    torch.cuda.synchronize()
    assert ell_spmv_partitioned.launches == before + 2
    assert a.dtype == torch.float32 and torch.equal(a, b)
    exact = ell_spmv_partitioned.ell_contrib_partitioned_reference(
        zw.double(), slots, rp, pp, npairs)
    err = float((a.double() - exact).abs().max())
    assert err <= 1e-5 * float(exact.abs().max())


def test_engine_on_the_card_matches_the_cpu_twin(cuda):
    src, dst = synth.rmat_edges(12, seed=6)
    g = pagerank_tpu_torch.build_graph(src, dst, n=1 << 12)
    cfg = PageRankConfig(num_iters=10, dtype="float64",
                         accum_dtype="float64")
    on_card = TorchEngine(cfg).build(g)
    assert on_card.layout_info()["kernel"] == "ell_contrib:cuda"
    r_card = on_card.run()
    r_cpu = TorchEngine(cfg, device="cpu").build(g).run()
    np.testing.assert_allclose(r_card, r_cpu, rtol=0, atol=1e-12)


def test_partitioned_engine_on_the_card_matches_the_cpu_twin(cuda):
    src, dst = synth.rmat_edges(12, seed=6)
    g = pagerank_tpu_torch.build_graph(src, dst, n=1 << 12)
    cfg = PageRankConfig(num_iters=10, partition_span=256)
    before = ell_spmv_partitioned.launches
    r_card = TorchEngine(cfg).build(g).run()
    assert ell_spmv_partitioned.launches == before + 10
    r_cpu = TorchEngine(cfg, device="cpu").build(g).run()
    np.testing.assert_allclose(r_card, r_cpu, rtol=1e-5, atol=1e-7)
