"""The port's bench CLI (``python -m pagerank_tpu_torch.bench``) held to
the JAX tool's output contract (``tests/test_bench_contract.py``) on the
CPU, in process: single mode's keys (``lowering`` null) with the graph
block's integer profile bit-equal to the JAX package's
``obs/graph_profile.py`` on the same host graph; couple mode's keys (less
``pallas_partitioned``) with the f64 headline and the bf16 leg against
the f64 oracle, its ``--out`` artifact and its ledger record; every
``--build-only`` stage; the ``--ppr-serve`` record and its accounting;
``--history`` and ``--sdc-check-every`` into the ledger; and
``--preflight`` refusing a scale no device holds with exit 3. Every run
builds on host ``rmat_edges`` (seed 0), the same graph in both
packages. On the card (the ``cuda`` marker; skipped elsewhere) a
single-mode leg launches K1 once a step and records it in its layout."""

import contextlib
import io
import json

import pytest

from pagerank_tpu_torch import bench

COSTS_KEYS = ("flops", "bytes_accessed", "peak_bytes", "bytes_per_edge",
              "roofline_fraction")
SINGLE_KEYS = {"metric", "value", "unit", "vs_baseline", "build_s", "costs",
               "layout", "lowering", "graph", "sdc_check_overhead_pct", "env",
               "scale", "iters", "edge_factor", "schema_version"}
#: The JAX couple record's keys (tests/test_bench_contract.py:162-168)
#: less the pallas_partitioned leg the port's couple does not run.
COUPLE_KEYS = {"metric", "value", "unit", "vs_baseline", "build_s", "costs",
               "layout", "lowering", "graph", "sdc_check_overhead_pct",
               "fast_f32", "partitioned_f32", "fast_bf16", "accuracy", "env",
               "scale", "iters", "edge_factor", "schema_version"}
#: The JAX --ppr-serve record's keys (tests/test_bench_contract.py:
#: 479-484); the port adds the daemon's ``layout`` (its K1w launches).
SERVE_KEYS = {"metric", "value", "unit", "p50_ms", "p99_ms", "phase_p99_ms",
              "shed_fraction", "rescues", "queries", "answered", "outcomes",
              "elapsed_s", "offered_qps", "scale", "iters", "edge_factor",
              "max_batch", "deadline_ms", "queue_depth", "topk", "env",
              "schema_version"}
PROFILE_INTS = ("n", "num_edges", "in_hist", "out_hist", "top_hub_ids",
                "partition_edges")


def _bench(*argv):
    """``bench.main`` on the CPU; (record, the one stdout line parsed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rec = bench.main([*argv, "--device", "cpu"])
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out.getvalue()
    return rec, json.loads(lines[0])


def _ledger(path):
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln]


def _assert_costs(costs):
    assert set(costs) == {"step"}
    c = costs["step"]
    for key in COSTS_KEYS:
        assert key in c, key
        assert c[key] is None or c[key] >= 0, (key, c[key])
    assert c["seconds_per_iter"] > 0 and c["bytes_per_edge"] > 0
    assert c["peak_bytes"] is None  # the CPU has no allocator peak


def _assert_graph(graph, ndev=1):
    prof = graph["profile"]
    for key in ("n", "num_edges", "dangling_fraction", "in_hist", "out_hist",
                "top_hub_ids", "partition_edges", "partition_skew",
                "powerlaw_alpha", "fingerprint", "source"):
        assert key in prof, key
    assert sum(prof["in_hist"]) == prof["n"]
    assert graph["prediction"]["ndev"] == ndev


def test_single_mode_keys_and_profile_equal_the_jax_profile():
    from pagerank_tpu import build_graph as jax_build_graph
    from pagerank_tpu.obs import graph_profile as jax_profile
    from pagerank_tpu.utils.synth import rmat_edges as jax_rmat

    rec, line = _bench("--host-build", "--dtype", "float32", "--scale", "10",
                       "--iters", "3", "--warmup", "1", "--no-accuracy")
    assert set(line) == SINGLE_KEYS
    assert line["schema_version"] == bench.BENCH_SCHEMA_VERSION == 2
    assert line["lowering"] is None and line["sdc_check_overhead_pct"] is None
    assert line["value"] == rec["value"] > 0 and line["vs_baseline"] > 0
    assert line["env"]["backend"] == "cpu" and line["env"]["torch_version"]
    _assert_costs(line["costs"])
    lay = line["layout"]
    assert lay["form"] == "flat_ell" and lay["build"] == "host"
    assert lay["pair"] is False and lay["steps"] == 4
    assert lay["launches"] == {"K1": 0, "K2": 0, "K1w": 0}  # the CPU twin
    _assert_graph(line["graph"])
    src, dst = jax_rmat(10, 16, seed=0)
    want = jax_profile.profile_graph(jax_build_graph(src, dst, n=1 << 10),
                                     group=1, partition_span=0).summary()
    got = line["graph"]["profile"]
    for key in PROFILE_INTS:
        assert got[key] == want[key], key


def test_couple_mode_keys_accuracy_out_and_ledger(tmp_path):
    out_path, ledger = tmp_path / "BENCH_fresh.json", tmp_path / "l.jsonl"
    _rec, line = _bench("--host-build", "--scale", "9", "--iters", "2",
                        "--warmup", "1", "--accuracy-scale", "8",
                        "--out", str(out_path), "--history", str(ledger))
    assert set(line) == COUPLE_KEYS
    assert json.loads(out_path.read_text()) == line
    acc = line["accuracy"]
    assert acc["config"] == "f64" and acc["scale"] == 8 and acc["iters"] == 2
    assert 0 <= acc["normalized_l1_vs_f64_oracle"] <= 1e-10
    assert 0 <= acc["mass_normalized_l1"] <= 1e-10
    assert 0 < acc["fast_bf16"]["normalized_l1_vs_f64_oracle"] <= 5e-3
    assert line["layout"]["pair"] is False
    assert line["layout"]["dtype"] == line["layout"]["accum_dtype"] == \
        "float64"
    _assert_costs(line["costs"])
    _assert_graph(line["graph"])
    for leg in ("fast_f32", "partitioned_f32", "fast_bf16"):
        _assert_costs(line[leg]["costs"])
        _assert_graph(line[leg]["graph"])
        assert line[leg]["lowering"] is None
        assert line[leg]["value"] > 0 and line[leg]["vs_baseline"] > 0
    assert line["fast_f32"]["layout"]["form"] == "flat_ell"
    for leg in ("partitioned_f32", "fast_bf16"):
        lay, prof = line[leg]["layout"], line[leg]["graph"]["profile"]
        assert lay["form"] == "pallas_partitioned"
        assert lay["partition_span"] > 0 and lay["window_rows"] > 0
        assert prof["stripe_span"] == lay["partition_span"]
        assert len(prof["partition_edges"]) >= 2
        assert prof["partition_skew"] >= 1.0
    assert line["fast_bf16"]["layout"]["stream_dtype"] == "bfloat16"
    assert line["partitioned_f32"]["layout"]["stream_dtype"] is None
    (rec,) = _ledger(ledger)
    assert set(rec["legs"]) == {"f64", "fast_f32", "partitioned_f32",
                                "fast_bf16"}
    assert rec["legs"]["f64"]["edges_per_sec_per_chip"] == line["value"]
    assert rec["legs"]["f64"]["accuracy_l1"] == \
        acc["normalized_l1_vs_f64_oracle"]


def test_build_only_reports_every_stage():
    _rec, line = _bench("--scale", "9", "--build-only")
    assert set(line) == {"metric", "value", "unit", "scale", "f64", "f32",
                         "f64_warm", "f64_over_f32", "f64_warm_over_f32",
                         "env", "schema_version"}
    assert line["metric"] == "build_s" and line["unit"] == "s"
    assert line["value"] == line["f64"]["build_s"] > 0
    for leg in ("f64", "f32", "f64_warm"):
        stages = line[leg]["stages"]
        assert set(stages) == set(bench.BUILD_STAGE_KEYS), stages
        assert all(v >= 0 for v in stages.values())
        assert stages["autotune_s"] == 0.0 and stages["compile_s"] == 0.0
        assert line[leg]["num_edges"] > 0


def test_ppr_serve_record_accounts_for_every_query(tmp_path):
    ledger = tmp_path / "l.jsonl"
    _rec, line = _bench("--ppr-serve", "--scale", "8", "--iters", "2",
                        "--serve-queries", "24", "--serve-qps", "500",
                        "--serve-topk", "8", "--history", str(ledger))
    assert set(line) == SERVE_KEYS | {"layout"}
    assert line["metric"] == "ppr_serve_queries_per_sec"
    assert line["queries"] == 24 and line["answered"] > 0
    shed = line["outcomes"].get("shed_overload", 0)
    assert sum(line["outcomes"].values()) == 24
    assert line["answered"] + shed == 24
    assert set(line["phase_p99_ms"]) == {"admission_wait", "batch_wait",
                                         "dispatch", "fetch"}
    assert line["phase_p99_ms"]["dispatch"] > 0
    assert line["layout"]["batches"] > 0
    (rec,) = _ledger(ledger)
    leg = rec["legs"]["ppr_serve"]
    assert leg["queries_per_sec"] == line["value"]
    for short, v in line["phase_p99_ms"].items():
        assert leg[short + "_p99_ms"] == v


def test_history_files_a_single_f32_run_under_fast_f32(tmp_path):
    ledger = tmp_path / "l.jsonl"
    _rec, line = _bench("--host-build", "--dtype", "float32", "--scale", "9",
                        "--iters", "2", "--warmup", "1", "--no-accuracy",
                        "--history", str(ledger))
    (rec,) = _ledger(ledger)
    assert rec["kind"] == "bench_single" and list(rec["legs"]) == ["fast_f32"]
    assert rec["legs"]["fast_f32"]["edges_per_sec_per_chip"] == line["value"]
    assert rec["env"]["backend"] == "cpu"
    # A second append of the same record dedupes.
    from pagerank_tpu_torch.obs import history

    assert not history.append_record(str(ledger), rec)


def test_sdc_overhead_leg_rides_the_record_and_the_ledger(tmp_path):
    ledger = tmp_path / "l.jsonl"
    _rec, line = _bench("--host-build", "--dtype", "float32", "--scale", "9",
                        "--iters", "2", "--warmup", "1", "--no-accuracy",
                        "--sdc-check-every", "1", "--history", str(ledger))
    ov = line["sdc_check_overhead_pct"]
    assert isinstance(ov, float) and ov >= 0.0
    assert line["layout"]["steps"] == 1 + 2 + 3  # warm-up, timed, checked
    (rec,) = _ledger(ledger)
    assert rec["legs"]["fast_f32"]["sdc_check_overhead_pct"] == ov


def test_preflight_refuses_a_scale_no_device_holds(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["--scale", "30", "--preflight", "--device", "cpu"])
    assert e.value.code == 3
    assert "DOES NOT FIT" in capsys.readouterr().err.upper()


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the bench's legs launch the "
                    "kernels, which have no CPU mode)")


@pytest.mark.cuda
def test_single_mode_on_the_card_launches_k1_once_a_step(cuda):
    from pagerank_tpu_torch.ops import ell_spmv

    before = ell_spmv.launches
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rec = bench.main(["--dtype", "float32", "--scale", "14", "--iters",
                          "5", "--warmup", "2", "--no-accuracy"])
    lay, step = rec["layout"], rec["costs"]["step"]
    assert lay["launches"] == {"K1": 7, "K2": 0, "K1w": 0}
    assert ell_spmv.launches - before == 7
    assert lay["kernel"] == "ell_contrib:cuda" and lay["build"] == "device"
    assert 0 < step["roofline_fraction"] <= 1.0 and step["peak_bytes"] > 0
