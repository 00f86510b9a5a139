"""The port's kernel-plane check (pagerank_tpu_torch/analysis/) against
the JAX package's PTK plane, on the CPU:

- the shipped registry (K1, K2 at toy and bench scales, P1-P3) is clean
  on the host rules, and K1 and K2 are clean on a real rmat:14 pack;
- each seeded-defect fixture F1-F6 trips exactly its rule, carries the
  JAX fixture's label, grid and block shapes (read from the JAX
  ``pallas_call`` with ``jax.make_jaxpr``), and its plain version equals
  the JAX fixture rebuilt with ``interpret=True`` from the JAX bodies;
- mutations of real plans and geometries trip the rule that names them;
- the CLI's exit codes and JSON keys; the cuobjdump parser on dumps
  recorded on the H100; the registry against the ``.cu`` constants.
"""

import json
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import pagerank_tpu_torch as pt
from pagerank_tpu.analysis import kernels as JK
from pagerank_tpu_torch.analysis import kernels as K
from pagerank_tpu_torch.analysis import resources
from pagerank_tpu_torch.analysis.__main__ import main as analysis_main
from pagerank_tpu_torch.obs import costs
from pagerank_tpu_torch.ops import defect_fixtures as fx
from pagerank_tpu_torch.utils import synth

DATA = Path(__file__).resolve().parent / "data" / "cuobjdump"
LANES = 128

# fixture label -> the ONE rule it must trip
# (tests/test_kernel_analysis.py:37-43 pins the same map for the JAX plane).
FIXTURE_RULES = {
    "fixture:vmem_overflow": "PTK001",
    "fixture:misaligned_tile": "PTK002",
    "fixture:index_gap": "PTK003",
    "fixture:index_overlap": "PTK003",
    "fixture:f64_scratch": "PTK004",
    "fixture:cost_mismatch": "PTK005",
}


def _rules(case):
    return sorted({f.rule for f in K.check_kernel_case(case)})


@pytest.fixture(scope="module")
def shipped():
    return K.shipped_cases()


@pytest.fixture(scope="module")
def defects():
    return {c.label: c for c in K.defect_cases()}


@pytest.fixture(scope="module")
def rmat14():
    src, dst = synth.rmat_edges(14, seed=0)
    return pt.build_graph(src, dst, n=1 << 14)


@pytest.fixture(scope="module")
def k1_real(rmat14):
    eng = pt.TorchEngine(pt.PageRankConfig(), device="cpu").build(rmat14)
    return eng.contrib_inputs()


@pytest.fixture(scope="module")
def k2_real(rmat14):
    eng = pt.TorchEngine(pt.PageRankConfig(partition_span=2048),
                         device="cpu").build(rmat14)
    assert eng.layout_info()["partitions"] == 8
    return eng.contrib_inputs()


# -- the shipped registry ------------------------------------------------------


def test_shipped_registry_is_clean_on_the_host_rules(shipped):
    findings = K.check_kernel_plane(shipped)
    assert findings == [], [f.render() for f in findings]


def test_shipped_registry_holds_every_kernel_at_every_scale(shipped):
    labels = [c.label for c in shipped]
    assert len(labels) == len(set(labels)) == 22
    for s in K.BENCH_SCALES:
        assert f"ell_contrib@scale{s}" in labels
        assert f"ell_contrib_partitioned@scale{s}" in labels
    assert {"ell_contrib@toy", "ell_contrib_partitioned@toy-span",
            "ell_contrib@scale22-f32-f64", "ell_contrib@scale22-f64-f64",
            "ell_contrib_partitioned@scale24-bf16",
            "probe_rowsel_smem@rows2^19-n58112-limit-f32",
            "probe_rowsel_smem@rows2^19-n116224-limit-bf16"} <= set(labels)
    keys = {ln.key for c in shipped for ln in c.launches}
    # every instantiation an entry point runs: K1 3 x 2 passes, K2 4 + 1,
    # P1-P3 in f32 and bf16
    assert keys == {
        "segment_partials<float,float>", "block_sums<float,float>",
        "segment_partials<float,double>", "block_sums<float,double>",
        "segment_partials<double,double>", "block_sums<double,double>",
        "pair_segment_partials<float,true>",
        "pair_segment_partials<float,false>",
        "pair_segment_partials<unsignedshort,true>",
        "pair_segment_partials<unsignedshort,false>", "pair_sums",
        "probe_take<F32>", "probe_take<BF16>", "probe_group8<F32>",
        "probe_group8<BF16>", "probe_rowsel_smem<F32>",
        "probe_rowsel_smem<BF16>"}


@pytest.mark.parametrize("label", [f"ell_contrib@scale{s}"
                                   for s in K.BENCH_SCALES]
                         + [f"ell_contrib_partitioned@scale{s}"
                            for s in K.BENCH_SCALES])
def test_bench_scale_costs_hold_the_bound_formula(shipped, label):
    case = next(c for c in shipped if c.label == label)
    got = K.derived_cost(case)
    for key in ("flops", "bytes"):
        assert abs(got[key] / case.cost_model[key] - 1) <= 0.25


def test_bound_formulas_reproduce_the_pr3_bounds():
    """The registry's formulas give PERF.md's bytes for K1's and K2's
    rmat:22 shapes (chip_smoke.py's old formulas, moved here)."""
    assert K.k1_cost(592_595, 4_194_304, 32_768, 22_421, 4)["bytes"] \
        == 337_183_836
    assert K.k2_cost(614_545, 384, 2 * 2_097_280, 4, 28_632,
                     35_343)["bytes"] == 267_934_912
    assert K.probe_cost(1 << 19, 1 << 15, 4)["bytes"] == 805_437_440


def test_real_rmat14_plans_are_clean(k1_real, k2_real):
    for case in (K.k1_case_from_inputs("k1@rmat14", *k1_real),
                 K.k2_case_from_inputs("k2@rmat14", *k2_real)):
        assert K.check_kernel_case(case) == []


# -- the defect fixtures --------------------------------------------------------


def test_every_defect_fixture_is_pinned(defects):
    assert set(defects) == set(FIXTURE_RULES)


@pytest.mark.parametrize("label,rule", sorted(FIXTURE_RULES.items()))
def test_defect_fixture_trips_exactly_its_rule(defects, label, rule):
    assert _rules(defects[label]) == [rule]


def test_fixture_labels_equal_the_jax_labels():
    assert [c.label for c in K.defect_cases()] == \
        [c.label for c in JK.defect_cases()]


def _jax_grid_mapping(label):
    case = next(c for c in JK.defect_cases() if c.label == label)
    jx = jax.make_jaxpr(case.fn)(*case.args)
    eq = next(e for e in jx.jaxpr.eqns if e.primitive.name == "pallas_call")
    gm = eq.params["grid_mapping"]
    blocks = [tuple(int(getattr(b, "block_size", b)) for b in bm.block_shape)
              for bm in gm.block_mappings]
    arrays = [tuple(bm.array_aval.shape) for bm in gm.block_mappings]
    return tuple(int(g) for g in gm.grid), blocks, arrays


@pytest.mark.parametrize("label", sorted(FIXTURE_RULES))
def test_fixture_geometry_equals_the_jax_grid_mapping(defects, label):
    grid, blocks, arrays = _jax_grid_mapping(label)
    (ln,) = defects[label].launches
    assert ln.grid[:len(grid)] == grid and set(ln.grid[len(grid):]) == {1}
    names = list(defects[label].operands)  # inputs, then out
    assert [ln.tiles[n] for n in names] == blocks
    assert [defects[label].operands[n].numel for n in names] == \
        [int(np.prod(a)) for a in arrays]


# The JAX fixtures rebuilt with interpret=True from the JAX bodies; the
# specs are pagerank_tpu/analysis/kernels.py:358-442 (built there without
# interpret, inside defect_cases).
def _jax_fixture(label):
    L = LANES
    f32 = jnp.float32
    row = lambda i: (i, 0)  # noqa: E731
    specs = {
        "vmem_overflow": (JK._fx_copy, (1,),
                          [pl.BlockSpec(memory_space=pltpu.VMEM)],
                          pl.BlockSpec(memory_space=pltpu.VMEM),
                          (fx.OVERFLOW_N,), [(fx.OVERFLOW_N,)], []),
        "misaligned_tile": (JK._fx_copy, (2, 2),
                            [pl.BlockSpec((100, 64), lambda i, j: (i, j))],
                            pl.BlockSpec((100, 64), lambda i, j: (i, j)),
                            (200, L), [(200, L)], []),
        "index_gap": (JK._fx_copy, (2,), [pl.BlockSpec((8, L), row)],
                      pl.BlockSpec((8, L), lambda i: (2 * i, 0)),
                      (32, L), [(16, L)], []),
        "index_overlap": (JK._fx_copy, (4,), [pl.BlockSpec((8, L), row)],
                          pl.BlockSpec((8, L), lambda i: (i % 2, 0)),
                          (16, L), [(32, L)], []),
        "f64_scratch": (JK._fx_scratch, (2,), [pl.BlockSpec((8, L), row)],
                        pl.BlockSpec((8, L), row), (16, L), [(16, L)],
                        [pltpu.VMEM((8, L), jnp.float64)]),
        "cost_mismatch": (JK._fx_matmul, (2,),
                          [pl.BlockSpec((L, L), row),
                           pl.BlockSpec((L, L), lambda i: (0, 0))],
                          pl.BlockSpec((L, L), row), (2 * L, L),
                          [(2 * L, L), (L, L)], []),
    }
    body, grid, in_specs, out_spec, out_shape, in_shapes, scratch = \
        specs[label]
    fn = pl.pallas_call(body, grid=grid, in_specs=in_specs,
                        out_specs=out_spec,
                        out_shape=jax.ShapeDtypeStruct(out_shape, f32),
                        scratch_shapes=scratch, interpret=True)
    return fn, in_shapes


PLAIN = {"vmem_overflow": fx.vmem_overflow,
         "misaligned_tile": fx.misaligned_tile, "index_gap": fx.index_gap,
         "index_overlap": fx.index_overlap, "f64_scratch": fx.f64_scratch,
         "cost_mismatch": fx.cost_mismatch}


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_plain_version_equals_the_jax_fixture_in_interpret_mode(name):
    fn, shapes = _jax_fixture(name)
    rng = np.random.default_rng(7)
    args = [rng.random(s, np.float32) for s in shapes]
    want = np.asarray(fn(*args))
    got = PLAIN[name](*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "cost_mismatch":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    else:  # bitwise; NaN where neither writes (index_gap)
        np.testing.assert_array_equal(got, want)
        assert np.array_equal(np.isnan(got), np.isnan(want))


def test_interpret_mode_leaves_unwritten_output_nan(defects):
    """The NaN fill the plain index_gap copies is what interpret mode
    does, at exactly the tiles PTK003 names."""
    fn, shapes = _jax_fixture("index_gap")
    out = np.asarray(fn(np.zeros(shapes[0], np.float32))).reshape(-1)
    gaps = K.write_gaps(defects["fixture:index_gap"], "out")
    assert gaps == [(1024, 2048), (3072, 4096)]
    nan = np.zeros(out.shape, bool)
    for a, b in gaps:
        nan[a:b] = True
    assert np.array_equal(np.isnan(out), nan)


def test_index_overlap_plain_version_keeps_the_last_writer():
    x = torch.arange(32 * LANES, dtype=torch.float32).view(32, LANES)
    out = fx.index_overlap(x)
    assert torch.equal(out[:8], x[16:24]) and torch.equal(out[8:], x[24:])


@pytest.mark.parametrize("call,err", [
    (lambda: fx.index_gap(torch.zeros(12, LANES)), ValueError),
    (lambda: fx.misaligned_tile(torch.zeros(200, 100)), ValueError),
    (lambda: fx.f64_scratch(torch.zeros(16, LANES, dtype=torch.float64)),
     TypeError),
    (lambda: fx.cost_mismatch(torch.zeros(256, 128), torch.zeros(64, 128)),
     ValueError),
    (lambda: fx.vmem_overflow(torch.zeros(4, 4)), ValueError),
])
def test_fixture_wrappers_refuse_what_the_kernels_do_not_take(call, err):
    with pytest.raises(err):
        call()


# -- mutations of real plans and geometries ------------------------------------


def _plan_arrays(plan):
    return (plan.seg_row_start.numpy().astype(np.int64),
            plan.block_seg_start.numpy().astype(np.int64))


def test_k1_dropped_segment_is_a_gap(k1_real):
    z, src, rb, nb, plan = k1_real
    rs, bss = _plan_arrays(plan)
    case = K.k1_case("k1@drop", seg_row_start=rs[1:],
                     block_seg_start=np.maximum(bss - 1, 0), row_block=rb,
                     n_state=z.shape[0] - 8)
    msgs = [f.message for f in K.check_kernel_case(case)]
    assert _rules(case) == ["PTK003"]
    assert any("src: elements [0, " in m and "never read" in m for m in msgs)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_duplicated_segment_is_an_overlap(k1_real, k2_real, kernel):
    """Segment 3 repeated: its rows are summed twice (pass 1 reads them
    in two CTAs)."""
    s = 3
    if kernel == "K1":
        z, src, rb, nb, plan = k1_real
        rs, bss = _plan_arrays(plan)
    else:
        zw, slots, rp, pp, npairs, plan = k2_real
        rs, bss = _plan_arrays(plan)
    rs2 = np.insert(rs, s + 2, [rs[s], rs[s + 1]])
    g = np.searchsorted(bss, s, side="right") - 1
    bss2 = bss + np.where(np.arange(len(bss)) > g, 2, 0)
    if kernel == "K1":
        case = K.k1_case("k1@dup", seg_row_start=rs2, block_seg_start=bss2,
                         row_block=rb, n_state=z.shape[0] - 8)
    else:
        sp = plan.seg_block.numpy().astype(np.int64)
        case = K.k2_case("k2@dup", seg_row_start=rs2,
                         seg_pair=np.insert(sp, s + 1, [sp[s], sp[s]]),
                         pair_seg_start=bss2, row_pair=rp.numpy(),
                         pair_part=pp.numpy(), num_windows=zw.shape[0],
                         window=zw.shape[1])
    msgs = [f.message for f in K.check_kernel_case(case)]
    assert _rules(case) == ["PTK003"]
    assert any("src: element" in m and "read by two CTAs" in m for m in msgs)


def test_segment_summed_by_the_wrong_block_is_named(k1_real):
    z, src, rb, nb, plan = k1_real
    rs, bss = _plan_arrays(plan)
    bss2 = bss.copy()
    b = int(np.flatnonzero(np.diff(bss) >= 2)[0])  # a block of 2+ segments
    bss2[b + 1] -= 1  # its last segment moves to block b + 1
    case = K.k1_case("k1@owner", seg_row_start=rs, block_seg_start=bss2,
                     row_block=rb, n_state=z.shape[0] - 8)
    msgs = [f.message for f in K.check_kernel_case(case)]
    assert _rules(case) == ["PTK003"]
    assert any("is summed by group" in m for m in msgs)


@pytest.mark.parametrize("dtype,item", [("float32", 4), ("bfloat16", 2)])
def test_rowsel_one_vertex_past_its_limit_trips_ptk001(dtype, item):
    limit = costs.device_spec().smem_per_block // item
    at = K.probe_case("gather_rowsel", "p3@limit", rows=K.PROBE_ROWS, n=limit,
                      dtype=dtype)
    past = K.probe_case("gather_rowsel", "p3@past", rows=K.PROBE_ROWS,
                        n=limit + 1,
                        dtype=dtype)
    assert _rules(at) == [] and _rules(past) == ["PTK001"]


def test_rowsel_fits_reads_the_device_table():
    from pagerank_tpu_torch.ops import gather_probe as gp

    assert gp.SMEM_LIMIT == costs.device_spec().smem_per_block == 232_448


def _edited_csrc(tmp_path, name, old, new):
    d = tmp_path / "csrc"
    shutil.copytree(K.CSRC_DIR, d)
    p = d / f"{name}.cu"
    text = p.read_text()
    assert old in text
    p.write_text(text.replace(old, new))
    return d


def test_a_100_thread_block_trips_ptk002(tmp_path):
    d = _edited_csrc(tmp_path, "ell_contrib", "const int threads = 256;",
                     "const int threads = 100;")
    case = K._synth_k1("k1@100", n_pad=1 << 14, rows=1 << 11, csrc_dir=d)
    assert case.launches[1].block == 100
    findings = [f for f in K.check_kernel_case(case, csrc_dir=d)]
    assert sorted({f.rule for f in findings}) == ["PTK002"]


def test_k1_f32_f64_entry_under_an_f32_config_trips_ptk004(k1_real):
    z, src, rb, nb, plan = k1_real
    case = K.k1_case_from_inputs("k1@f32f64", *k1_real,
                                 accum_dtype="float64")
    assert _rules(case) == []  # clean under its own config
    case.config = {"z": "float32", "accum": "float32"}
    assert _rules(case) == ["PTK004"]


def test_a_bound_formula_off_by_two_trips_ptk005(k1_real, k2_real):
    for case in (K.k1_case_from_inputs("k1", *k1_real),
                 K.k2_case_from_inputs("k2", *k2_real)):
        case.cost_model = {**case.cost_model,
                           "bytes": 2 * case.cost_model["bytes"]}
        assert _rules(case) == ["PTK005"]


def test_misaligned_vector_operand_trips_ptk002():
    case = K.probe_case("gather_group8", "p2@misaligned", rows=64,
                        n=1 << 12, z_align=16)
    assert _rules(case) == ["PTK002"]


# -- the registry against the .cu -----------------------------------------------


def test_registry_block_sizes_are_the_launch_sites_constants(shipped,
                                                             defects):
    """Every launch's block size is read from the named constant of its
    source, and that constant is what reaches the symbol's <<<>>> site
    (directly, or through the launcher its entry point calls)."""
    for case in list(shipped) + list(defects.values()):
        for ln in case.launches:
            src = K.read_source(ln.source)
            assert ln.block == src.const(ln.block_const), ln
            reaching = src.block_reaching(ln.symbol, ln.entry)
            assert reaching and set(reaching) == {ln.block_const}, (
                ln.symbol, ln.entry, reaching)


def test_block_reaching_sees_a_launcher_argument_change(tmp_path):
    d = _edited_csrc(tmp_path, "defect_fixtures",
                     "kMisTileRows, cols, cols, kMisTileRows",
                     "kLanes, cols, cols, kMisTileRows")
    src = K.read_source("defect_fixtures", d)
    assert src.block_reaching("fx_copy", "fx_misaligned_tile") == ["kLanes"]
    assert src.block_reaching("fx_copy", "fx_index_gap") == ["kLanes"]


def test_registry_follows_an_edited_source(tmp_path):
    d = _edited_csrc(tmp_path, "gather_probe",
                     "constexpr int kThreads = 256;",
                     "constexpr int kThreads = 512;")
    case = K.probe_case("gather_take", "p1", rows=64, n=1 << 12, csrc_dir=d)
    assert case.launches[0].block == 512
    assert K.probe_case("gather_take", "p1", rows=64,
                        n=1 << 12).launches[0].block == 256


def test_source_facts():
    src = K.read_source("gather_probe")
    p3 = src.kernels["probe_rowsel_smem"]
    assert p3.opt_in and p3.launch_bounds == 1024 and p3.static_smem == 0
    assert [d.dynamic for d in p3.shared] == [True]
    assert not src.kernels["probe_take"].opt_in
    fxs = K.read_source("defect_fixtures")
    assert fxs.kernels["fx_scratch"].static_smem == 8 * 128 * 8
    assert fxs.kernels["fx_matmul"].static_smem == 2 * 128 * 32 * 4
    assert K.read_source("ell_contrib").kernels[
        "block_sums"].launch_bounds is None


# -- the CLI --------------------------------------------------------------------


def test_cli_select_ptk_is_clean(capsys):
    assert analysis_main(["--select", "PTK"]) == 0
    err = capsys.readouterr().err
    assert "0 finding(s)" in err and "compile facts not checked" in err


@pytest.mark.parametrize("fixture", sorted(
    label.split(":")[1] for label in FIXTURE_RULES))
def test_cli_fixture_exits_1_with_exactly_its_rule(capsys, fixture):
    assert analysis_main(["--select", "PTK", "--kernel-fixture", fixture,
                          "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in doc["findings"]} == {
        FIXTURE_RULES[f"fixture:{fixture}"]}


@pytest.mark.parametrize("argv", [["--kernel-fixture", "nope"],
                                  ["--select", "PTL"],
                                  ["--select", "PTK,PTC"],
                                  ["--allowlist", "/nonexistent/x.txt"]])
def test_cli_usage_errors_exit_2(capsys, argv):
    assert analysis_main(argv) == 2


def test_cli_names_slice_8_for_later_families(capsys):
    analysis_main(["--select", "PTR"])
    assert "slice 8" in capsys.readouterr().err


def test_cli_json_keys(capsys):
    assert analysis_main(["--json", "--allowlist", "none"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert set(doc) == {"version", "ok", "compiled", "counts", "findings",
                        "waived"}
    assert doc["ok"] is True and doc["compiled"] is False
    assert doc["counts"] == {"active": 0, "waived": 0}


def test_cli_fixture_all_json_finding_keys(capsys):
    assert analysis_main(["--kernel-fixture", "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert len(doc["findings"]) == 7  # F6 trips flops and bytes
    for f in doc["findings"]:
        assert set(f) == {"rule", "path", "line", "col", "message",
                          "snippet"}
        assert f["path"] == "csrc/defect_fixtures.cu" and f["line"] > 0


def test_cli_list_rules(capsys):
    assert analysis_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert [ln.split()[0] for ln in out.splitlines()] == [
        "PTK001", "PTK002", "PTK003", "PTK004", "PTK005"]


def test_cli_compiled_without_the_toolkit_exits_2(capsys, monkeypatch):
    def missing():
        raise resources.ToolchainMissing("cuobjdump not found")

    monkeypatch.setattr(resources, "find_tools", missing)
    assert analysis_main(["--compiled"]) == 2
    assert "cuobjdump" in capsys.readouterr().err


def test_find_tools_names_what_is_missing(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/cuobjdump").is_file():  # a CUDA host
        assert "cuobjdump" in resources.find_tools()
    else:
        with pytest.raises(resources.ToolchainMissing, match="cuobjdump"):
            resources.find_tools()


# -- compile facts, parsed from dumps recorded on the H100 ------------------------
# tests/data/cuobjdump/<lib>.{res,res.demangled,elf,sass}.txt: cuobjdump
# --dump-resource-usage (and the same piped through cu++filt), -elf and
# -sass of the libraries nvcc built for sm_90a on an NVIDIA H100 machine.


def _recorded_facts(lib):
    def read(kind):
        return (DATA / f"{lib}.{kind}.txt").read_text()

    mangled = list(resources.parse_resource_usage(read("res")))
    demangled = list(resources.parse_resource_usage(read("res.demangled")))
    assert len(mangled) == len(demangled)
    return resources.facts_from_dumps(read("res"), read("elf"), read("sass"),
                                      dict(zip(mangled, demangled)))


def test_cuobjdump_parser_on_recorded_dumps():
    facts = _recorded_facts("defect_fixtures")
    assert set(facts) == {"fx_copy", "fx_scratch", "fx_matmul"}
    src = K.read_source("defect_fixtures")
    reserved = costs.device_spec().smem_reserved
    for sym, f in facts.items():
        assert f.shared == src.kernels[sym].static_smem + reserved
        assert f.max_threads == src.kernels[sym].launch_bounds
        assert f.regs > 0 and f.local == 0
    assert facts["fx_matmul"].regs == 128
    assert facts["fx_copy"].f64_ops == () == facts["fx_matmul"].f64_ops
    k1 = _recorded_facts("ell_contrib")
    assert set(k1) == {f"{p}<{a}>" for p in ("segment_partials", "block_sums")
                       for a in ("float,float", "float,double",
                                 "double,double")}
    assert k1["segment_partials<float,float>"].max_threads == 128
    assert k1["block_sums<float,float>"].max_threads is None
    assert k1["segment_partials<float,float>"].f64_ops == ()
    assert "DADD" in k1["segment_partials<float,double>"].f64_ops
    assert k1["block_sums<float,float>"].shared == 0


def test_shipped_registry_is_clean_with_recorded_compile_facts(shipped):
    """Every shipped launch has compile facts under its key (cu++filt
    spells K2's bool argument ``(bool)1``) and none trips a compiled
    clause: the 1 KB reservation shows on P1 and P2, which declare no
    shared memory, because P3 in the same library does."""
    facts = {}
    for lib in ("ell_contrib", "ell_contrib_partitioned", "gather_probe",
                "defect_fixtures"):
        facts.update(_recorded_facts(lib))
    keys = {ln.key for c in shipped for ln in c.launches}
    assert keys <= set(facts), sorted(keys - set(facts))
    assert facts["probe_take<F32>"].shared == 1024
    assert facts["pair_segment_partials<unsignedshort,true>"].max_threads \
        == 128
    found = [f for c in shipped for f in
             K.check_kernel_case(c, facts=facts)]
    assert found == [], [f.render() for f in found[:5]]


def test_compiled_rules_on_recorded_facts(defects, k1_real):
    """With the recorded facts each fixture still trips exactly its rule,
    K1 is clean, K1's f32/f64 entry under an f32 config shows its f64
    SASS, and a drifted declaration is named."""
    import dataclasses

    facts = {**_recorded_facts("defect_fixtures"),
             **_recorded_facts("ell_contrib")}
    for label, rule in FIXTURE_RULES.items():
        found = K.check_kernel_case(defects[label], facts=facts)
        assert {f.rule for f in found} == {rule}, label
    k1 = K.k1_case_from_inputs("k1", *k1_real)
    assert K.check_kernel_case(k1, facts=facts) == []
    wide = K.k1_case_from_inputs("k1", *k1_real, accum_dtype="float64")
    wide.config = {"z": "float32", "accum": "float32"}
    msgs = [f.message for f in K.check_kernel_case(wide, facts=facts)]
    assert any("f64 instructions in the SASS" in m and "DADD" in m
               for m in msgs)
    drift = dict(facts, fx_copy=dataclasses.replace(
        facts["fx_copy"], shared=4096, regs=200, local=16, max_threads=256))
    found = K.check_kernel_case(defects["fixture:index_gap"], facts=drift)
    assert {f.rule for f in found} == {"PTK001", "PTK002", "PTK003"}
    assert sum(f.rule == "PTK002" for f in found) == 2  # bounds, spill
    found = K.check_kernel_case(defects["fixture:vmem_overflow"],
                                facts=drift)  # 200 regs x 1024 threads
    assert any(f.rule == "PTK002" and "registers" in f.message
               for f in found)
    with pytest.raises(LookupError, match="no compile facts"):
        K.check_kernel_case(K.shipped_cases()[-1], facts=facts)


@pytest.fixture(scope="module")
def recorded():
    facts = {}
    for lib in ("ell_contrib", "ell_contrib_partitioned", "gather_probe",
                "defect_fixtures"):
        facts.update(_recorded_facts(lib))
    return facts


@pytest.mark.parametrize("fixture", [None] + sorted(
    label.split(":")[1] for label in FIXTURE_RULES))
def test_cli_compiled_on_recorded_facts(capsys, monkeypatch, recorded,
                                        fixture):
    """What chip_smoke.py's phase 9 asks of ``--compiled``: the shipped
    registry exits 0, each fixture 1 with exactly its rule, and the JSON
    carries every shipped symbol's facts."""
    monkeypatch.setattr(resources, "built_facts", lambda sources: recorded)
    argv = ["--select", "PTK", "--compiled", "--json"]
    if fixture:
        argv += ["--kernel-fixture", fixture]
    assert analysis_main(argv) == (1 if fixture else 0)
    doc = json.loads(capsys.readouterr().out)
    assert doc["compiled"] is True
    if fixture:
        assert {f["rule"] for f in doc["findings"]} == {
            FIXTURE_RULES[f"fixture:{fixture}"]}
    else:
        assert len(doc["compile_facts"]) == 17


def test_symbol_key():
    assert resources.symbol_key(
        "void <unnamed>::segment_partials<float, double>(const T1 *, const "
        "int *, const int *, T2 *)") == "segment_partials<float,double>"
    assert resources.symbol_key(
        "void <unnamed>::probe_take<<unnamed>::F32>(const T1::elem *, "
        "const int4 *, const T1::wvec *, T1::wvec *, long)") == \
        "probe_take<F32>"
    assert resources.symbol_key(
        "<unnamed>::fx_copy(const float *, float *, long)") == "fx_copy"
    assert resources.symbol_key(
        "void <unnamed>::pair_segment_partials<unsigned short, (bool)1>("
        "const T1 *, long)") == "pair_segment_partials<unsignedshort,true>"
