"""The port's standing acceptance runs
(``pagerank_tpu_torch/scripts/acceptance.py``) held against the JAX
package's (``scripts/acceptance.py``, loaded by path, unedited) on the
CPU at small sizes: ``CONFIGS`` of both are overridden through
``monkeypatch``. The f64 runs (reference, textbook, vertex-sharded and
vs_bounded forms) pass in both and agree on the graph and its mass
growth, and the port's ranks are within 1e-12 of the JAX engine's; PPR
passes in both with equal top-k ids off ties; the literal job's dumps
parse to the same ranks; every in-process smoke passes under a CPU
budget with the JAX record's keys (less the ones the port drops or
renames); smoke L runs over three gloo ranks; the bench smokes D and N
pass, and AA's dry run over two gloo ranks passes every gate with a
multichip record of the JAX keys whose exchanged bytes are the JAX comms
model's; the refused key Q and a host without a card exit non-zero."""

import ast
import importlib.util
import inspect
import itertools
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest

from pagerank_tpu_torch.scripts import acceptance as port

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "scripts" / "acceptance.py"

#: The wall budget the smokes are held to here (seconds): a loaded CPU
#: host under xdist, not the card (the card's budgets are the module's).
CPU_BUDGET_S = 120.0

#: Record keys the port drops (the JAX checks that have no counterpart:
#: the jaxpr contract sweep) or renames, by the runner's name.
DROPPED = {
    "run_partitioned_smoke": {"contract_forms_covered", "contracts_ran",
                              "contract_findings"},
    "run_halo_async_smoke": {"contract_findings"},
    "run_one": {"tpu_seconds"},
    "run_ppr": {"tpu_seconds"},
}
ADDED = {
    "run_partitioned_smoke": {"ptk_forms_covered"},
    "run_one": {"device_seconds", "form", "k1_launches", "k1_entry",
                "host_stages_s"},
    "run_ppr": {"device_seconds", "k1w_launches", "host_stages_s"},
    "run_e2e": {"k1_launches", "gen_s", "oracle_s"},
    "run_elastic_smoke": {"k1_launches"},
    "run_history_smoke": {"bench_seconds"},
    "run_campaign_smoke": {"devices", "launches"},
}


@pytest.fixture(scope="module")
def jax_acc():
    spec = importlib.util.spec_from_file_location("jax_acceptance",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _override(monkeypatch, jax_acc, key, **kw):
    for mod in (jax_acc, port):
        monkeypatch.setitem(mod.CONFIGS, key, dict(mod.CONFIGS[key], **kw))


def _record_keys(path: Path):
    """{function name: keys of its ``rec = {...}`` literal}."""
    tree = ast.parse(path.read_text())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and getattr(node.targets[0], "id", None) == "rec"
                    and isinstance(node.value, ast.Dict)):
                out[fn.name] = {k.value for k in node.value.keys
                                if isinstance(k, ast.Constant)}
    return out


# -- the skeleton --------------------------------------------------------


def test_configs_and_default_keys_are_the_jax_scripts(jax_acc):
    assert set(port.CONFIGS) == set(jax_acc.CONFIGS)
    for key, spec in jax_acc.CONFIGS.items():
        ours = dict(port.CONFIGS[key])
        if key == "O":  # a v5e's refused scale; rmat:26 fits 80 GB
            assert spec["fit_bad_scale"] == 26 and ours["fit_bad_scale"] == 30
            ours["fit_bad_scale"] = 26
        if key == "AA":  # 8 fake CPU devices there, 2 gloo ranks here
            assert ours.pop("fake_devices") == 2
        assert ours == spec, key
    assert port.DEFAULT_KEYS == [k for k in jax_acc.DEFAULT_KEYS
                                 if k != "Q"]
    assert set(port.REFUSED) == {"Q"}
    assert port.GATE == jax_acc.GATE
    for name in ("PPR_TIE_EPS", "PPR_OVERLAP_GATE", "PPR_SCORE_L1_GATE",
                 "ELASTIC_F32_GATE", "GRAPH_SKEW_GATE",
                 "KERNELS_FIXTURE_RULES", "SERVE_OUTCOMES"):
        assert getattr(port, name) == getattr(jax_acc, name), name


def test_every_runner_keeps_the_jax_record_keys(jax_acc):
    theirs, ours = _record_keys(JAX_SCRIPT), _record_keys(
        Path(port.__file__))
    ported = {f.__name__ for f in port.RUNNERS.values()} | {"run_one"}
    assert ported == set(ours)
    for name in sorted(ported):
        want = (theirs[name] - DROPPED.get(name, set())) | ADDED.get(
            name, set())
        assert ours[name] == want, name


@pytest.mark.parametrize("key", ["D", "N", "Q", "AA"])
def test_refused_keys_exit_2_naming_the_queue_item(key, capsys):
    """Q alone is refused; D, N and AA, refused until the port had its
    bench, now run in the JAX order through their own runners."""
    if key != "Q":
        assert key not in port.REFUSED and key in port.DEFAULT_KEYS
        assert port.runner_of(key).__name__ == {
            "D": "run_build_smoke", "N": "run_history_smoke",
            "AA": "run_campaign_smoke"}[key]
        return
    assert port.main(["--only", key, "--no-append", "--no-analysis"]) == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md queue 1" in err


def test_no_card_and_no_device_cpu_exits_nonzero(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert port.main(["--only", "U", "--no-append", "--no-analysis"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_main_on_the_cpu_keeps_one_row_a_key(tmp_path, monkeypatch, capsys):
    perf = tmp_path / "PERF.md"
    perf.write_text("# PERF\n\n## 7. Open questions\n\n- q\n")
    monkeypatch.setattr(port, "REPO", str(tmp_path))
    (tmp_path / "pagerank_tpu_torch" / "analysis").mkdir(parents=True)
    shutil.copy(REPO / "pagerank_tpu_torch" / "analysis" / "allowlist.txt",
                tmp_path / "pagerank_tpu_torch" / "analysis")
    monkeypatch.setattr(port, "CONCURRENCY_SMOKE_BUDGET_S", CPU_BUDGET_S)
    assert port.main(["--only", "U", "--device", "cpu",
                      "--no-analysis"]) == 0
    recs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["config"] for r in recs] == ["U"] and recs[0]["card"] == "cpu"
    text = perf.read_text()
    assert text.count(port.PERF_HEADER) == 1
    assert "| U | cpu | PASS |" in text
    # A later run replaces U's row and adds a row for a new key; the
    # table stays the last section, the ones before it untouched.
    later = dict(recs[0], card="card X", wall_s=9.5)
    other = dict(recs[0], config="W", card="card X")
    port.append_perf([later, other], path=str(perf))
    text = perf.read_text()
    assert "| U | cpu |" not in text
    rows = [ln for ln in text.splitlines() if ln.startswith("| ")
            and ln.split("|")[1].strip() in ("U", "W")]
    assert rows == [port.perf_row(later).rstrip("\n"),
                    port.perf_row(other).rstrip("\n")]
    assert text.startswith("# PERF\n\n## 7. Open questions\n\n- q\n")
    # A table with a section after it: the rows stay inside the table.
    perf.write_text(text + "\n## 8. After\n\n- a\n")
    port.append_perf([dict(later, wall_s=1.25)], path=str(perf))
    text = perf.read_text()
    assert text.count("| U |") == 1 and "| 1.2 |" in text
    assert text.endswith("\n## 8. After\n\n- a\n")
    assert text.index("| U |") < text.index("## 8. After")


# -- the f64 oracle runs -------------------------------------------------

FORMS = {
    "reference": {},
    "textbook": {"semantics": "textbook"},
    "vertex_sharded": {"vertex_sharded": True},
    "vs_bounded": {"vertex_sharded": True, "vs_bounded": True},
}


def _capture_l1(monkeypatch, module):
    """Wrap ``module.oracle_l1`` so the device ranks it is given are
    kept."""
    seen = []
    orig = module.oracle_l1

    def wrapped(r, r_ref):
        seen.append(np.asarray(r, dtype=np.float64))
        return orig(r, r_ref)

    monkeypatch.setattr(module, "oracle_l1", wrapped)
    return seen


@pytest.mark.parametrize("form", sorted(FORMS))
def test_run_one_agrees_with_the_jax_script(form, jax_acc, monkeypatch):
    from pagerank_tpu.utils import metrics as jax_metrics

    from pagerank_tpu_torch.utils import metrics as port_metrics

    _override(monkeypatch, jax_acc, "A", scale=12, iters=5, **FORMS[form])
    monkeypatch.setattr(port, "_GRAPHS", {})
    monkeypatch.setattr(port, "_ORACLES", {})
    got_jax = _capture_l1(monkeypatch, jax_metrics)
    got_port = _capture_l1(monkeypatch, port_metrics)
    theirs = jax_acc.run_one("A")
    ours = port.run_one("A", device="cpu")
    assert theirs["passed"] and ours["passed"]
    assert ours["num_edges"] == theirs["num_edges"]
    assert ours["mass_growth"] == pytest.approx(theirs["mass_growth"],
                                                rel=1e-12)
    assert ours["form"] == ("flat_ell" if form in ("reference", "textbook")
                            else form)
    r_port, r_jax = got_port[-1], got_jax[-1]
    assert np.abs(r_port - r_jax).sum() / np.abs(r_jax).sum() <= 1e-12


def test_run_ppr_agrees_with_the_jax_script(jax_acc, monkeypatch):
    from pagerank_tpu.engines import ppr as jax_ppr

    from pagerank_tpu_torch.engines import ppr as port_ppr

    _override(monkeypatch, jax_acc, "P", scale=10, sources=16, topk=10)
    monkeypatch.setattr(port, "_GRAPHS", {})
    results = {}
    for name, cls in (("jax", jax_ppr.PprJaxEngine),
                      ("port", port_ppr.PprTorchEngine)):
        orig = cls.run

        def run(self, sources, *a, _orig=orig, _name=name, **kw):
            res = _orig(self, sources, *a, **kw)
            if len(sources) == 16:
                results[_name] = res
            return res

        monkeypatch.setattr(cls, "run", run)
    theirs = jax_acc.run_ppr("P")
    ours = port.run_ppr("P", device="cpu")
    assert theirs["passed"] and ours["passed"]
    assert ours["num_edges"] == theirs["num_edges"]
    a, b = results["port"], results["jax"]
    np.testing.assert_array_equal(a.sources, b.sources)
    eps = port.PPR_TIE_EPS
    for s in range(16):
        sc = a.topk_scores[s].astype(np.float64)
        gap = np.minimum(np.abs(np.diff(sc, prepend=np.inf)),
                         np.abs(np.diff(sc, append=-np.inf)))
        untied = gap > eps
        assert untied.any()
        np.testing.assert_array_equal(a.topk_ids[s][untied],
                                      b.topk_ids[s][untied])


def _parse_dump(path):
    ranks = {}
    with open(path) as f:
        for line in f:
            k, v = line.strip()[1:-1].rsplit(",", 1)
            ranks[k] = float(v)
    return ranks


def test_run_e2e_dumps_the_jax_scripts_ranks(jax_acc, monkeypatch,
                                             tmp_path):
    _override(monkeypatch, jax_acc, "E", files=3, records=40, iters=3)
    dirs = []
    count = itertools.count()

    def mkdtemp(prefix="", **kw):
        d = tmp_path / f"{prefix}{next(count)}"
        d.mkdir()
        dirs.append(d)
        return str(d)

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    monkeypatch.setattr(shutil, "rmtree", lambda *a, **kw: None)
    theirs = jax_acc.run_e2e("E")
    ours = port.run_e2e("E", device="cpu")
    assert theirs["passed"] and ours["passed"]
    assert (ours["n"], ours["num_edges"]) == (theirs["n"],
                                              theirs["num_edges"])
    jax_dir, port_dir = dirs
    for it in range(3):
        part = Path("out") / f"PageRank{it}" / "part-00000"
        want, got = _parse_dump(jax_dir / part), _parse_dump(port_dir / part)
        assert sorted(got) == sorted(want) and len(got) == ours["n"]
        w = np.array([want[k] for k in sorted(want)])
        g = np.array([got[k] for k in sorted(want)])
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


# -- the smokes ----------------------------------------------------------


@pytest.mark.parametrize("key", ["F", "G", "H", "K", "R", "S", "U", "W"])
def test_in_process_smoke_passes_with_the_jax_keys(key):
    runner = port.runner_of(key)
    budget = ({"budget_s": CPU_BUDGET_S}
              if "budget_s" in inspect.signature(runner).parameters else {})
    rec = runner(key, "cpu", **budget)
    assert rec["passed"], rec
    assert rec["config"] == key
    theirs = _record_keys(JAX_SCRIPT)[port.runner_of(key).__name__]
    name = port.runner_of(key).__name__
    assert set(rec) == (theirs - DROPPED.get(name, set())) | ADDED.get(
        name, set())


def test_group_smoke_l_over_three_gloo_ranks():
    rec = port.run_elastic_smoke("L", "cpu", budget_s=CPU_BUDGET_S)
    assert rec["passed"], rec
    assert rec["devices"] == 3 and rec["surviving_devices"] == 2
    assert rec["rescues"] == 1 and rec["kill"]["device"] == 2
    # The CPU runs K1's plain version: no member counts a launch.
    assert rec["k1_launches"] == {0: 0, 1: 0, 2: 0}


def _keep_ranks(monkeypatch, cls, seen):
    """Wrap ``cls.run`` so the ranks of each snapshotted run are kept."""
    orig = cls.run

    def run(self, *a, **kw):
        r = orig(self, *a, **kw)
        if kw.get("snapshotter") is not None:
            seen.append(np.array(r, dtype=np.float64))
        return r

    monkeypatch.setattr(cls, "run", run)


def test_fault_smoke_f_replays_the_jax_scripts_chaos(jax_acc, monkeypatch):
    """F on one seed in both scripts: the same faults, retries and
    rollbacks, and both chaos runs' ranks within 1e-12 of the JAX
    script's (f64 both)."""
    from pagerank_tpu import ReferenceCpuEngine as JaxCpu

    from pagerank_tpu_torch import TorchEngine

    seen_jax, seen_port = [], []
    _keep_ranks(monkeypatch, JaxCpu, seen_jax)
    _keep_ranks(monkeypatch, TorchEngine, seen_port)
    theirs = jax_acc.run_fault_smoke("F")
    ours = port.run_fault_smoke("F", "cpu")
    assert theirs["passed"] and ours["passed"]
    for k in ("faults_injected", "write_retries", "rollbacks",
              "schedule_reproducible"):
        assert ours[k] == theirs[k], k
    assert len(seen_jax) == len(seen_port) == 2
    for a, b in zip(seen_port, seen_jax):
        assert np.abs(a - b).sum() / np.abs(b).sum() <= 1e-12


def test_jobs_smoke_r_replays_the_jax_scripts_job(jax_acc, monkeypatch,
                                                  tmp_path):
    """R on one kill plan in both scripts: the same exit codes, drain,
    resumes and skipped stages, and the resumed job's ranks within 1e-12
    of the JAX script's. JAX's job runs its f64 CPU engine; the port's
    job runs here with ``--dtype float64`` added to its CLI calls, so
    the two hold the same solve."""
    from pagerank_tpu_torch import cli as port_cli

    dirs = []
    count = itertools.count()

    def mkdtemp(prefix="", **kw):
        d = tmp_path / f"{prefix}{next(count)}"
        d.mkdir()
        dirs.append(d)
        return str(d)

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    monkeypatch.setattr(shutil, "rmtree", lambda *a, **kw: None)
    orig_main = port_cli.main
    monkeypatch.setattr(port_cli, "main",
                        lambda argv: orig_main(argv + ["--dtype", "float64"]))
    monkeypatch.setattr(port, "R_SMOKE_BUDGET_S", CPU_BUDGET_S)
    monkeypatch.setattr(jax_acc, "R_SMOKE_BUDGET_S", CPU_BUDGET_S)
    theirs = jax_acc.run_jobs_smoke("R")
    ours = port.run_jobs_smoke("R", "cpu")
    assert theirs["passed"] and ours["passed"]
    for k in ("kill_exit_code", "resume_exit_code", "drained",
              "job_resumes", "stages_skipped"):
        assert ours[k] == theirs[k], k

    def ranks(d):
        n = 1 << ours["scale"]
        r = np.zeros(n)
        for line in open(d / "ranks.tsv"):
            k, v = line.split("\t")
            r[int(k)] = float(v)
        return r

    jax_dir, port_dir = dirs
    a, b = ranks(port_dir), ranks(jax_dir)
    assert np.abs(a - b).sum() / np.abs(b).sum() <= 1e-12


# -- the bench smokes --------------------------------------------------------


def _jax_keys(name):
    return (_record_keys(JAX_SCRIPT)[name] - DROPPED.get(name, set())) | \
        ADDED.get(name, set())


def test_build_smoke_d_on_the_cpu(monkeypatch):
    from pagerank_tpu_torch import bench

    monkeypatch.setitem(port.CONFIGS, "D", dict(port.CONFIGS["D"], scale=12))
    rec = port.run_build_smoke("D", "cpu", budget_s=CPU_BUDGET_S)
    assert rec["passed"], rec
    assert set(rec) == _jax_keys("run_build_smoke")
    assert set(rec["stages"]) == set(bench.BUILD_STAGE_KEYS)
    assert rec["missing_stage_keys"] == [] and rec["ops_lint_ok"]


def test_history_smoke_n_on_the_cpu():
    rec = port.run_history_smoke("N", "cpu", budget_s=CPU_BUDGET_S)
    assert rec["passed"], rec
    assert set(rec) == _jax_keys("run_history_smoke")
    assert rec["fresh_record_ingested"] and rec["fresh_gate_rc"] == 0
    assert rec["env_drift_warns_and_passes"] and rec["program_change_fails"]


#: The JAX --multichip record's keys (tests/test_bench_contract.py:359-366).
MULTICHIP_KEYS = {"metric", "value", "unit", "n_devices", "scale", "iters",
                  "single_chip", "dense_exchange", "sparse_exchange",
                  "sparse_async", "pallas_partitioned", "exchange_overlap",
                  "staleness_sweep", "scaling_efficiency",
                  "scaling_efficiency_dense", "exchanged_bytes",
                  "device_view", "accuracy", "env", "edge_factor",
                  "schema_version"}


def test_campaign_smoke_aa_over_two_gloo_ranks(monkeypatch, tmp_path):
    """AA's dry run: one campaign, its multichip leg one group of two
    gloo ranks. Every AA gate passes, and the multichip document has the
    JAX record's keys, its legs' blocks, and exchanged bytes equal to the
    JAX comms model of the same graph over two devices."""
    from pagerank_tpu import build_graph as jax_build_graph
    from pagerank_tpu.ops import ell as jax_ell
    from pagerank_tpu.parallel import comms as jax_comms
    from pagerank_tpu.parallel import partition as jax_partition
    from pagerank_tpu.utils.synth import rmat_edges as jax_rmat

    from pagerank_tpu_torch.obs import campaign

    dirs = []
    count = itertools.count()

    def mkdtemp(prefix="", **kw):
        d = tmp_path / f"{prefix}{next(count)}"
        d.mkdir()
        dirs.append(d)
        return str(d)

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    monkeypatch.setattr(shutil, "rmtree", lambda *a, **kw: None)
    rec = port.run_campaign_smoke("AA", "cpu", budget_s=CPU_BUDGET_S)
    assert rec["passed"], rec
    assert set(rec) == _jax_keys("run_campaign_smoke")
    assert rec["devices"] == 2 and rec["legs_done"] == rec["legs_total"] == 6
    assert rec["verdicts"] == sorted(campaign.VERDICTS)
    assert rec["all_nonbinding_defer"] and rec["report_rerender_identical"]
    # The CPU runs the kernels' plain versions: each leg names its kernel
    # and counts no launch.
    assert {leg: got["kernel"] for leg, got in rec["launches"].items()} == {
        "bench_couple/f64": "K1", "bench_couple/fast_f32": "K1",
        "bench_couple/partitioned_f32": "K2", "bench_couple/fast_bf16": "K2",
        "bench_multichip/single_chip": "K1",
        "bench_multichip/dense_exchange": "K1",
        "bench_multichip/sparse_exchange": "K1",
        "bench_multichip/sparse_async": "K1",
        "bench_multichip/pallas_partitioned": "K2", "ppr_serve": "K1w"}
    assert all(got["launches"] == 0 and not any(got["counts"].values())
               for got in rec["launches"].values())
    # Each leg's steps, one launch a step on the card (phase 22(d)).
    assert {leg: (got["kernel"], got["steps"])
            for leg, got in rec["launches"].items()
            if leg != "ppr_serve"} == {
        leg: want for leg, want in port.AA_LEGS.items()
        if leg != "ppr_serve"}

    _spec, _m, docs, _metas = campaign.load_campaign(str(dirs[0]))
    serve = docs["ppr_serve"]["output"]
    assert rec["launches"]["ppr_serve"]["steps"] == \
        serve["iters"] * (serve["layout"]["batches"] + 1) > 0
    mc = docs["bench_multichip"]["output"]
    assert set(mc) == MULTICHIP_KEYS
    assert mc["n_devices"] == 2 and len(mc["device_view"]) == 2
    assert mc["single_chip"]["n_devices"] == 1
    for leg in ("single_chip", "dense_exchange", "sparse_exchange",
                "sparse_async", "pallas_partitioned"):
        got = mc[leg]
        assert got["value"] > 0 and got["ms_per_iter"] > 0
        assert got["lowering"] is None and "step" in got["costs"]
        assert got["graph"]["prediction"]["ndev"] == got["n_devices"]
    for leg in ("single_chip", "dense_exchange", "sparse_exchange",
                "sparse_async"):
        att = mc[leg]["attribution"]
        assert att["exchange_s"] > 0 and att["step_s"] > 0
    assert mc["dense_exchange"]["layout"]["form"] == "vertex_sharded"
    assert mc["sparse_exchange"]["layout"]["form"] == "vs_halo"
    assert mc["sparse_async"]["layout"]["form"] == "vs_halo_async"
    pl = mc["pallas_partitioned"]
    assert pl["layout"]["form"] == "pallas_partitioned"
    assert pl["comms"] is None and pl["attribution"] is None
    assert pl["bytes_exchanged"] == 0
    cm = mc["sparse_exchange"]["comms"]
    assert mc["sparse_exchange"]["bytes_exchanged"] == \
        mc["iters"] * cm["bytes_per_iter"]
    assert mc["sparse_async"]["bytes_exchanged"] == \
        mc["iters"] * mc["sparse_async"]["comms"]["bytes_per_iter"]
    sw = mc["staleness_sweep"]["legs"]
    assert sw["async_lag0"]["iters_to_tol"] == sw["sync"]["iters_to_tol"]
    assert mc["accuracy"]["normalized_l1_vs_f64_oracle"] < 1e-3
    # The exchanged bytes are the JAX comms model's on the same graph at
    # two devices: the JAX package's pack, halo plan and byte model over
    # the table as the JAX pallas forms pad it for a mesh (world x 256
    # rows, jax_engine.py:1146-1157), the padding the port's sharded
    # forms take. (The JAX XLA form pads to a smaller power of two; at
    # this toy size its plan splits the rows otherwise.)
    src, dst = jax_rmat(mc["scale"], mc["edge_factor"], seed=0)
    pack = jax_ell.ell_pack(jax_build_graph(src, dst, n=1 << mc["scale"]))
    slots = np.where(pack.weight != 0, pack.src, np.int32(pack.n_padded))
    real = slots.shape[0]
    pad = -(-real // 512) * 512 - real
    slots = np.concatenate([slots, np.full((pad, 128), pack.n_padded,
                                           slots.dtype)])
    rb = np.concatenate([pack.row_block,
                         np.full(pad, pack.row_block[real - 1],
                                 pack.row_block.dtype)])
    ranks, ids, _, _ = jax_ell.dense_block_ranks(rb, pack.num_blocks)
    n_vs = -(-pack.n_padded // 256) * 256
    plan = jax_partition.build_halo_plan(
        [slots], [ranks], [ids], ndev=2, n_vs=n_vs, sz=pack.n_padded,
        group=1, head_k=-1, z_item=4, accum_item=4, rs_merge=True)
    jm = jax_comms.model_sparse(plan)
    assert mc["exchanged_bytes"] == {
        "sparse_model_per_iter": jm["sparse_bytes_per_iter"],
        "dense_model_per_iter": jm["dense_bytes_per_iter"],
        "sparse_below_dense": bool(jm["sparse_bytes_per_iter"]
                                   < jm["dense_bytes_per_iter"]),
        "halo_fraction": jm["halo_fraction"],
        "head_k": jm["head_k"]}
    assert jm["dense_bytes_per_iter"] == jax_comms.model_dense(
        2, n_vs // 2, 4, 4, True)["bytes_per_iter"]
