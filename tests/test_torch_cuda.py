"""K1, K2, K1w, the gather probe's P1-P3, the defect fixtures F1-F6 and
the engine on the card. These need an NVIDIA GPU and nvcc:
on any other host each test skips with a reason. Run them on the card
with ``python -m pytest -m cuda tests/test_torch_cuda.py``."""

import json

import numpy as np
import pytest
import torch

import pagerank_tpu_torch
from pagerank_tpu_torch import PageRankConfig, TorchEngine
from pagerank_tpu_torch.ops import ell as torch_ell
from pagerank_tpu_torch.ops import ell_spmm, ell_spmv, ell_spmv_partitioned
from pagerank_tpu_torch.ops import defect_fixtures, gather_probe
from pagerank_tpu_torch.ops import spmv as torch_spmv
from pagerank_tpu_torch.scripts import probe_gather
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
    """K1 equals its plain version in plan order computed on the CPU, bit
    for bit; two launches on one workspace are bit-identical; a head of 0
    changes no bit; one launch a call."""
    z, src, rb, nb, plan = _inputs(cuda, dtype)
    work = ell_spmv.workspace(plan, acc, cuda)
    before = ell_spmv.launches
    a = ell_spmv.ell_contrib(z, src, rb, nb, accum_dtype=acc, plan=plan,
                             work=work)
    b = ell_spmv.ell_contrib(z, src, rb, nb, accum_dtype=acc, plan=plan,
                             work=work)
    c = ell_spmv.ell_contrib(z, src, rb, nb, accum_dtype=acc, plan=plan,
                             work=work, head=0)
    torch.cuda.synchronize()
    assert ell_spmv.launches == before + 3
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not work.counter.any()  # each launch leaves its counters zero
    cpu = ell_spmv.plan_to(plan, "cpu")
    assert torch.equal(a.cpu(), ell_spmv.ell_contrib_plan_reference(
        z.cpu(), src.cpu(), accum_dtype=acc, plan=cpu))
    ref = ell_spmv.ell_contrib_reference(z, src, rb, nb, accum_dtype=acc)
    err = float((a.double() - ref.double()).abs().max())
    assert err <= tol * float(ref.double().abs().max())


def test_the_largest_head_fills_shared_memory(cuda):
    """At rmat:17 the head is the most shared memory allows (58,104 f32
    vertices, or 116,208 bf16 of partition 0): the launch is accepted and
    its output still equals the CPU plan-order sums."""
    src, dst = synth.rmat_edges(17, seed=2)
    g = pagerank_tpu_torch.build_graph(src, dst, n=1 << 17)
    eng = TorchEngine(PageRankConfig(), device="cpu").build(g)
    eng.set_ranks(np.random.default_rng(3).random(g.n).astype(np.float32))
    z, slots, rb, nb, plan = (t.to(cuda) if isinstance(t, torch.Tensor)
                              else t for t in eng.contrib_inputs())
    plan = ell_spmv.plan_to(plan, cuda)
    launch = ell_spmv.bind(z, slots, nb, accum_dtype=torch.float32,
                           plan=plan)
    assert launch.head == ell_spmv.head_capacity(4)
    assert launch.smem == 232_448 - ell_spmv.STATIC_SMEM
    got = launch()
    want = ell_spmv.ell_contrib_plan_reference(
        z.cpu(), slots.cpu(), accum_dtype=torch.float32,
        plan=ell_spmv.plan_to(plan, "cpu"))
    assert torch.equal(got.cpu(), want)
    eng = TorchEngine(PageRankConfig(partition_span=1 << 17,
                                     stream_dtype="bfloat16"),
                      device="cuda").build(g)
    eng.set_ranks(np.random.default_rng(3).random(g.n).astype(np.float32))
    zw, words, rp, pp, npairs, pplan = eng.contrib_inputs()
    launch = ell_spmv_partitioned.bind(zw, words, pp, npairs, plan=pplan)
    assert launch.head == min(ell_spmv.head_capacity(2), pplan.sentinel)
    got = launch()
    want = ell_spmv_partitioned.ell_contrib_partitioned_plan_reference(
        zw.cpu(), words.cpu(), pp.cpu(), plan=ell_spmv.plan_to(pplan, "cpu"))
    assert torch.equal(got.cpu(), want)


def test_bound_launcher_launches_once_a_call(cuda):
    z, src, rb, nb, plan = _inputs(cuda, torch.float32)
    launch = ell_spmv.bind(z, src, nb, accum_dtype=torch.float32, plan=plan)
    assert launch.head == min(ell_spmv.head_capacity(4), z.shape[0] - 8)
    before = ell_spmv.launches
    outs = [launch().clone() for _ in range(3)]
    torch.cuda.synchronize()
    assert ell_spmv.launches == before + 3
    assert all(torch.equal(outs[0], o) for o in outs)
    with pytest.raises(ValueError, match="head"):
        ell_spmv.bind(z, src, nb, accum_dtype=torch.float32, plan=plan,
                      head=launch.head + 1)


@pytest.mark.parametrize("stream", ["", "bfloat16"])
@pytest.mark.parametrize("words", ["words24", "int32"])
def test_k2_matches_twin_and_repeats_bitwise(cuda, stream, words):
    """K2's block sums equal its plain version in plan order computed on
    the CPU, bit for bit; repeat bit-identical on one workspace; a head
    of 0 changes no bit."""
    src, dst = synth.rmat_edges(12, seed=4)
    g = pagerank_tpu_torch.build_graph(src, dst, n=1 << 12)
    eng = TorchEngine(PageRankConfig(partition_span=512,
                                     stream_dtype=stream)).build(g)
    assert eng.layout_info()["kernel"] == "ell_contrib_partitioned:cuda"
    eng.set_ranks(np.random.default_rng(1).random(g.n).astype(np.float32))
    zw, slots, rp, pp, npairs, plan = eng.contrib_inputs()
    if words == "int32":
        slots = torch_spmv.unpack_words24(slots).contiguous()
    work = ell_spmv_partitioned.workspace(plan, cuda)
    before = ell_spmv_partitioned.launches
    a, b, c = (ell_spmv_partitioned.ell_contrib_partitioned(
        zw, slots, rp, pp, npairs, plan=plan, work=work, head=h)
        for h in (None, None, 0))
    torch.cuda.synchronize()
    assert ell_spmv_partitioned.launches == before + 3
    assert a.dtype == torch.float32 and a.shape == (plan.num_blocks * 128,)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not work.counter.any()
    cpu = ell_spmv.plan_to(plan, "cpu")
    assert torch.equal(
        a.cpu(), ell_spmv_partitioned.ell_contrib_partitioned_plan_reference(
            zw.cpu(), slots.cpu(), pp.cpu(), plan=cpu))
    exact = ell_spmv_partitioned.expand_pairs(
        ell_spmv_partitioned.ell_contrib_partitioned_reference(
            zw.double(), slots, rp, pp, npairs), pp, plan.pair_block,
        plan.num_blocks)
    err = float((a.double() - exact).abs().max())
    assert err <= 1e-5 * float(exact.abs().max())


@pytest.mark.parametrize("stream", ["", "bfloat16"])
def test_k2_block_of_more_than_chunk_pairs_is_bitwise(cuda, stream):
    """At 64 partitions a hub block is fed by more than CHUNK pairs and
    split over lane groups: its finisher sums the pair sums in one run in
    partition order, as the CPU plan-order sums (and expand_pairs) do."""
    rng = np.random.default_rng(7)
    n, hub_in = 8192, 6000
    src = np.concatenate([rng.permutation(np.arange(1, n))[:hub_in],
                          rng.integers(0, n, 4000)])
    dst = np.concatenate([np.zeros(hub_in, np.int64),
                          rng.integers(0, n // 4, 4000)])
    g = pagerank_tpu_torch.build_graph(src, dst, n=n)
    eng = TorchEngine(PageRankConfig(partition_span=128,
                                     stream_dtype=stream)).build(g)
    assert eng.layout_info()["partitions"] == 64
    eng.set_ranks(rng.random(g.n).astype(np.float32))
    zw, slots, rp, pp, npairs, plan = eng.contrib_inputs()
    cpu = ell_spmv.plan_to(plan, "cpu")
    per_block = np.diff(cpu.block_pair_start.numpy())
    split = np.zeros(plan.num_blocks, bool)
    split[cpu.pair_block.numpy()[cpu.seg_block.numpy()[
        cpu.item_segs.numpy()[:plan.num_split]]]] = True
    assert (per_block[split] > ell_spmv.CHUNK).any()
    work = ell_spmv_partitioned.workspace(plan, cuda)
    a, b = (ell_spmv_partitioned.ell_contrib_partitioned(
        zw, slots, rp, pp, npairs, plan=plan, work=work) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b) and not work.counter.any()
    assert torch.equal(
        a.cpu(), ell_spmv_partitioned.ell_contrib_partitioned_plan_reference(
            zw.cpu(), slots.cpu(), pp.cpu(), plan=cpu))


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


PROBE = {"gather_take": (gather_probe.gather_take,
                         gather_probe.gather_take_reference),
         "gather_group8": (gather_probe.gather_group8,
                           gather_probe.gather_group_reference),
         "gather_rowsel": (gather_probe.gather_rowsel,
                           gather_probe.gather_rowsel_reference)}


@pytest.mark.parametrize("n", [1 << 15, "limit"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", sorted(PROBE))
def test_probe_kernels_equal_their_plain_versions(cuda, kernel, dtype, n):
    """At n = 2^15 and at P3's shared-memory limit (58,112 f32, 116,224
    bf16), on a ragged row count."""
    if n == "limit":
        n = gather_probe.SMEM_LIMIT // dtype.itemsize
    z, src, w = probe_gather.make_inputs(999, n, dtype, 3, cuda)
    fn, ref = PROBE[kernel]
    before = gather_probe.launches[kernel]
    a = fn(z, src, w)
    b = fn(z, src, w)
    torch.cuda.synchronize()
    assert gather_probe.launches[kernel] == before + 2
    assert a.dtype == dtype and torch.equal(a, b)
    assert torch.equal(a, ref(z, src, w))


def test_group8_refuses_a_misaligned_z(cuda):
    z, src, w = probe_gather.make_inputs(4, 1 << 12, torch.float32, 0, cuda)
    z = torch.cat([z, z[:4]])[4:]  # n % 8 == 0, 16 bytes off the group
    before = dict(gather_probe.launches)
    with pytest.raises(ValueError, match="aligned"):
        gather_probe.gather_group8(z, src, w)
    assert gather_probe.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rowsel_refuses_a_z_past_shared_memory(cuda, dtype):
    n = gather_probe.SMEM_LIMIT // dtype.itemsize + 128
    z, src, w = probe_gather.make_inputs(4, n, dtype, 0, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        gather_probe.gather_rowsel(z, src, w)


FIXTURE_INPUTS = {"misaligned_tile": [(200, 128)], "index_gap": [(16, 128)],
                  "index_overlap": [(32, 128)], "f64_scratch": [(16, 128)],
                  "cost_mismatch": [(256, 128), (128, 128)]}


@pytest.mark.parametrize("name", sorted(FIXTURE_INPUTS))
def test_defect_fixture_kernels_against_their_plain_versions(cuda, name):
    """F2-F6 at the JAX fixtures' shapes: F2, F3 (NaN included) and F5
    equal their plain versions, F4 holds one of its two writers in every
    element, F6 is within 1e-5 of an f64 matmul."""
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    args = [torch.rand(s, generator=g, device=cuda)
            for s in FIXTURE_INPUTS[name]]
    before = defect_fixtures.launches[name]
    got = getattr(defect_fixtures, name)(*args)
    torch.cuda.synchronize()
    assert defect_fixtures.launches[name] == before + 1
    ref = getattr(defect_fixtures, f"{name}_reference")(*args)
    if name == "cost_mismatch":
        exact = args[0].double() @ args[1].double()
        err = float((got.double() - exact).abs().max())
        assert err <= 1e-5 * float(exact.abs().max())
    elif name == "index_overlap":
        x = args[0]
        for t in range(2):
            o = got[t * 8:(t + 1) * 8]
            assert bool(((o == x[t * 8:(t + 1) * 8])
                         | (o == x[(t + 2) * 8:(t + 3) * 8])).all())
    else:
        assert torch.equal(got.isnan(), ref.isnan())
        assert torch.equal(got.nan_to_num(-1.0), ref.nan_to_num(-1.0))


def test_vmem_overflow_is_refused_and_leaves_no_error(cuda):
    before = defect_fixtures.launches["vmem_overflow"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        defect_fixtures.vmem_overflow(
            torch.zeros(defect_fixtures.OVERFLOW_N, device=cuda))
    torch.cuda.synchronize()
    assert defect_fixtures.last_error() == 0
    assert defect_fixtures.launches["vmem_overflow"] == before
    x = torch.rand(1 << 15, device=cuda)
    assert torch.equal(defect_fixtures.vmem_overflow(x), x)
    assert defect_fixtures.launches["vmem_overflow"] == before + 1


def test_compiled_check_is_clean_on_the_shipped_registry(cuda):
    from pagerank_tpu_torch.analysis import kernels

    assert kernels.check_kernel_plane(compiled=True) == []


@pytest.mark.parametrize("span", ["0", "4096"])
def test_toy_crawl_job_on_cuda_matches_the_cpu_run(cuda, tmp_path, span):
    """A toy crawl segment through cli.run on the card (K1 flat, K2 at
    a 4096 span) against the same run on the CPU: within 1e-5 of it,
    mass-normalised, and the same graph and --top order."""
    from pagerank_tpu_torch import cli
    from pagerank_tpu_torch.utils.metrics import oracle_l1
    from pagerank_tpu_torch.utils.synth import crawl_segment

    seg = str(tmp_path / "seg")
    crawl_segment(seg, files=4, per_file=3000, seed=9)
    runs = {}
    for dev in ("cuda", "cpu"):
        k1, k2 = ell_spmv.launches, ell_spmv_partitioned.launches
        runs[dev] = cli.run(["--input", seg, "--iters", "10", "--device", dev,
                             "--partition-span", span, "--log-every", "0"])
        launched = (ell_spmv.launches - k1,
                    ell_spmv_partitioned.launches - k2)
        if dev == "cuda":
            assert launched == ((10, 0) if span == "0" else (0, 10))
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu["ingest_route"] == "native" and gpu["form"] == cpu["form"]
    assert gpu["graph"].fingerprint() == cpu["graph"].fingerprint()
    assert oracle_l1(gpu["ranks"], cpu["ranks"])[2] <= 1e-5


@pytest.mark.parametrize("stripe", [0, 1024])
@pytest.mark.parametrize("weights", [False, True])
def test_device_build_on_the_card_equals_the_cpu_build(cuda, stripe,
                                                       weights):
    """build_ell_device on the card, from the same uploaded raw edges
    (duplicates in) and a crawl-style mask, is torch.equal plane by
    plane to the CPU build, with the same fingerprint; the engine built
    from it runs K1 (flat) or K2 (striped) within 1e-5 of the CPU run."""
    from pagerank_tpu_torch.ops import device_build as db

    src, dst = synth.rmat_edges(12, seed=4)
    mask = np.zeros(1 << 12, bool)
    mask[np.setdiff1d(np.arange(1 << 12), src)[::2]] = True
    builds = {d: db.build_ell_device(src, dst, 1 << 12, stripe_size=stripe,
                                     with_weights=weights, dangling_mask=mask,
                                     device=d) for d in (cuda, "cpu")}
    gpu, cpu = builds[cuda], builds["cpu"]
    assert gpu.src[0].is_cuda if stripe else gpu.src.is_cuda
    for f in ("src", "weight", "row_block"):
        for a, b in zip(db._as_list(getattr(gpu, f)),
                        db._as_list(getattr(cpu, f))):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a.cpu(), b), f
    for f in ("perm", "dangling_mask", "zero_in_mask", "out_degree"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    assert gpu.num_edges == cpu.num_edges and gpu.num_rows == cpu.num_rows
    assert gpu.fingerprint() == cpu.fingerprint()
    cfg = PageRankConfig(num_iters=10, partition_span=stripe)
    k1, k2 = ell_spmv.launches, ell_spmv_partitioned.launches
    r_gpu = TorchEngine(cfg, device=cuda).build_device(gpu).run()
    assert (ell_spmv.launches - k1, ell_spmv_partitioned.launches - k2) == (
        (10, 0) if not stripe else (0, 10))
    r_cpu = TorchEngine(cfg, device="cpu").build_device(cpu).run()
    assert np.abs(r_gpu - r_cpu).sum() / np.abs(r_cpu).sum() <= 1e-5


# -- personalized PageRank: K1 column by column --------------------------------

@pytest.mark.parametrize("dtype,acc", [(torch.float32, torch.float32),
                                       (torch.float32, torch.float64),
                                       (torch.float64, torch.float64)])
def test_column_launchers_equal_the_plain_version_per_column(cuda, dtype,
                                                             acc):
    """bind_columns: one K1 launch a column (k launches), each column
    torch.equal to its plain plan-order version on the CPU; the batch
    launched twice is bit-identical."""
    z, src, rb, nb, plan = _inputs(cuda, dtype)
    k = 6
    z_cols = torch.zeros((k, z.shape[0]), dtype=dtype, device=cuda)
    for j in range(k):
        z_cols[j] = z.roll(37 * j) * (z != 0)  # zero tail stays zero
    before = ell_spmv.launches
    launchers = ell_spmv.bind_columns(z_cols, src, nb, accum_dtype=acc,
                                      plan=plan)
    for ln in launchers:
        ln()
    a = launchers[0].out_cols.clone()
    for ln in launchers:
        ln()
    torch.cuda.synchronize()
    assert ell_spmv.launches == before + 2 * k
    assert torch.equal(a, launchers[0].out_cols)
    cpu_plan = torch_ell.segment_plan(rb.cpu().numpy(), nb)
    want = ell_spmv.ell_contrib_spmm_reference(
        z_cols.cpu(), src.cpu(), accum_dtype=acc, plan=cpu_plan)
    assert torch.equal(a.cpu(), want)
    got = ell_spmv.ell_contrib_spmm(z_cols, src, rb, nb, accum_dtype=acc,
                                    plan=plan)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-6)])
def test_ppr_on_the_card_matches_the_cpu_run_and_repeats(cuda, dtype, tol):
    """PprTorchEngine on cuda: K1w launched once an iteration a chunk
    (K1 not at all), within tol of the CPU run (its plain version), the
    same batch twice bit-identical, a source alone equal in ids to the
    source in a batch."""
    from pagerank_tpu_torch.engines.ppr import PprTorchEngine

    src, dst = synth.rmat_edges(12, seed=6)
    g = pagerank_tpu_torch.build_graph(src, dst, n=1 << 12)
    cfg = PageRankConfig(num_iters=10, dtype=dtype, accum_dtype=dtype)
    sources = np.array([0, 17, 999, 4095, 17])
    eng = PprTorchEngine(cfg).build(g)
    before, k1 = ell_spmm.launches, ell_spmv.launches
    a = eng.run(sources, topk=50, chunk=4)
    assert ell_spmm.launches == before + 10 * 2  # 2 chunks
    assert ell_spmv.launches == k1
    assert eng.layout_info()["kernel"] == "ell_contrib_spmm:cuda"
    b = eng.run(sources, topk=50, chunk=4)
    np.testing.assert_array_equal(a.topk_ids, b.topk_ids)
    np.testing.assert_array_equal(a.topk_scores, b.topk_scores)
    c = PprTorchEngine(cfg, device="cpu").build(g).run(sources, topk=50,
                                                       chunk=4)
    np.testing.assert_allclose(a.topk_scores, c.topk_scores, rtol=0,
                               atol=tol)
    solo = eng.run(sources[1:2], topk=50)
    np.testing.assert_array_equal(solo.topk_ids[0], a.topk_ids[1])
    np.testing.assert_allclose(solo.topk_scores[0], a.topk_scores[1],
                               rtol=1e-6, atol=0)


# -- personalized PageRank: K1w, all columns in one launch ----------------------

def _z2_columns(z, k):
    """k columns of z, rolled, as a row-major z2 whose zero tail stays
    zero."""
    item = z.element_size()
    z2 = torch.zeros((z.shape[0], ell_spmm.row_width(k, item)),
                     dtype=z.dtype, device=z.device)
    for j in range(k):
        z2[:, j] = z.roll(37 * j) * (z != 0)
    return z2


@pytest.mark.parametrize("dtype,acc", [(torch.float32, torch.float32),
                                       (torch.float32, torch.float64),
                                       (torch.float64, torch.float64)])
def test_k1w_equals_its_plain_version_and_the_column_launchers(cuda, dtype,
                                                              acc):
    """K1w at every built tile is torch.equal to its plain version on
    the CPU and to K1 launched once a column (bind_columns), and repeats
    itself bit for bit; its fold of block 0's lanes equals the plain
    version's."""
    z, src, rb, nb, plan = _inputs(cuda, dtype)
    k = 64
    z2 = _z2_columns(z, k)
    cpu_plan = torch_ell.segment_plan(rb.cpu().numpy(), nb)
    want = ell_spmm.ell_contrib_spmm_rows_reference(
        z2.cpu(), src.cpu(), accum_dtype=acc, plan=cpu_plan, k=k)
    mass = ell_spmm.mass_reference(z2.cpu(), src.cpu(), accum_dtype=acc,
                                   plan=cpu_plan, k=k)
    cols = ell_spmv.bind_columns(z2.T.contiguous(), src, nb,
                                 accum_dtype=acc, plan=plan)
    for ln in cols:
        ln()
    assert torch.equal(cols[0].out_cols.cpu().T, want)
    for kt in ell_spmm.TILES:
        before = ell_spmm.launches
        ln = ell_spmm.bind_spmm(z2, src, nb, accum_dtype=acc, plan=plan,
                                kt=kt)
        a = ln(k).cpu()
        b = ln(k).cpu()
        assert ell_spmm.launches == before + 2
        assert torch.equal(a, want) and torch.equal(a, b), kt
        assert ln.mass.dtype == acc
        assert torch.equal(ln.mass[:k].cpu(), mass), kt
    got = ell_spmm.ell_contrib_spmm_rows(z2, src, rb, nb, accum_dtype=acc,
                                         plan=plan, k=5)
    assert torch.equal(got.cpu(), want[:, :5])


def test_k1w_launcher_runs_only_its_live_columns(cuda):
    """A launcher bound at 8 columns, called at kc = 1, 3 and 8: the
    first kc columns (and of the folded mass) equal the plain version's,
    one launch a call, each
    at the narrowest tile that holds kc columns, and the columns past
    kc are left as they were."""
    z, src, rb, nb, plan = _inputs(cuda, torch.float32)
    z2 = _z2_columns(z, 8)
    cpu_plan = torch_ell.segment_plan(rb.cpu().numpy(), nb)
    want = ell_spmm.ell_contrib_spmm_rows_reference(
        z2.cpu(), src.cpu(), accum_dtype=torch.float32, plan=cpu_plan, k=8)
    mass = ell_spmm.mass_reference(z2.cpu(), src.cpu(),
                                   accum_dtype=torch.float32, plan=cpu_plan,
                                   k=8)
    ln = ell_spmm.bind_spmm(z2, src, nb, accum_dtype=torch.float32,
                            plan=plan, width=8)
    ln.out.fill_(float("nan"))
    for kc, tile in ((1, 4), (3, 4), (8, 8)):
        before = ell_spmm.launches
        out = ln(kc)
        assert ell_spmm.launches == before + 1 and ln.last_tile == tile
        assert torch.equal(out[:, :kc].cpu(), want[:, :kc])
        assert torch.equal(ln.mass[:kc].cpu(), mass[:kc])
        if kc == 1:
            assert torch.isnan(out[:, 4:]).all()
    with pytest.raises(ValueError, match="outside"):
        ln(9)


def test_coo_on_the_card_repeats_bitwise_and_matches_the_cpu(cuda):
    src, dst = synth.rmat_edges(12, seed=6)
    g = pagerank_tpu_torch.build_graph(src, dst, n=1 << 12)
    cfg = PageRankConfig(num_iters=10, kernel="coo")
    k1 = ell_spmv.launches
    a = TorchEngine(cfg).build(g)
    assert a.layout_info()["device"].startswith("cuda")
    ra = a.run()
    rb = TorchEngine(cfg).build(g).run()
    assert ell_spmv.launches == k1
    np.testing.assert_array_equal(ra, rb)
    rc = TorchEngine(cfg, device="cpu").build(g).run()
    assert np.abs(ra - rc).sum() / np.abs(rc).sum() <= 1e-6


def test_serve_smoke_on_the_card(cuda, capsys):
    from pagerank_tpu_torch import serve

    assert serve.main(["--serve-smoke", "8", "--scale", "10", "--iters",
                       "5", "--max-batch", "4"]) == 0
    doc = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert doc["unsettled"] == 0
    assert set(doc["outcomes"]) <= {"answered", "answered_cache"}
