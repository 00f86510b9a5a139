"""The port's perf-history ledger (``pagerank_tpu_torch/obs/history.py``,
a copy of the JAX module): ``normalize_result`` gives the JAX package's
records on the repo's own result files, a port run report's leg is
named from its engine's layout and its environment class is the card,
and the ledger round trip dedupes as the JAX one does."""

import glob
import json
from pathlib import Path

import pytest

from pagerank_tpu.obs import history as jax_history
from pagerank_tpu_torch.obs import history

REPO = Path(__file__).resolve().parent.parent
FILES = sorted(
    glob.glob(str(REPO / "BENCH_r0*.json"))
    + glob.glob(str(REPO / "MULTICHIP_*.json"))
    + [str(REPO / "BASELINE.json")])


def test_the_repo_has_result_files():
    assert len(FILES) >= 11


@pytest.mark.parametrize("path", FILES, ids=lambda p: Path(p).name)
def test_normalize_result_equals_the_jax_record(path):
    doc = json.loads(Path(path).read_text())
    src = Path(path).name
    try:
        want = jax_history.normalize_result(doc, source=src)
    except ValueError as e:
        with pytest.raises(ValueError, match="unrecognized"):
            history.normalize_result(doc, source=src)
        assert "unrecognized" in str(e)
        return
    got = history.normalize_result(doc, source=src)
    assert got == want
    assert history.content_hash(got) == jax_history.content_hash(want)


@pytest.mark.parametrize("layout,leg", [
    ({"form": "flat_ell", "dtype": "float32", "accum_dtype": "float32"},
     "flat_f32"),
    ({"form": "flat_ell", "dtype": "float32", "accum_dtype": "float64"},
     "flat_f32_acc64"),
    ({"form": "flat_ell", "dtype": "float64", "accum_dtype": "float64"},
     "flat_f64"),
    ({"form": "pallas_partitioned", "dtype": "float32",
      "stream_dtype": None}, "partitioned_f32"),
    ({"form": "pallas_partitioned", "dtype": "float32",
      "stream_dtype": "bfloat16"}, "partitioned_bf16"),
    ({"form": "coo", "dtype": "float32"}, "coo_f32"),
    ({"form": "cpu_f64"}, "cpu_f64"),
])
def test_leg_names_come_from_the_layout(layout, leg):
    assert history.leg_name_for_layout(layout) == leg


def _port_report(eps, kind="NVIDIA H100 80GB HBM3", bpe=5.2, rev="abc"):
    return {
        "schema_version": 1, "created_unix": 1.0, "spans": {},
        "environment": {"backend": "cuda", "device_kind": kind,
                        "torch_version": "2.5", "git_rev": rev},
        "config": {"dtype": "float32", "num_iters": 10,
                   "partition_span": 1 << 21},
        "summary": {"edges_per_sec_per_chip": eps,
                    "mean_iter_seconds": 1e-3},
        "costs": {"step": {"bytes_per_edge": bpe}},
        "layout": {"form": "pallas_partitioned", "dtype": "float32",
                   "stream_dtype": "bfloat16"},
    }


def test_port_run_report_record_and_ledger(tmp_path):
    rec = history.normalize_result(_port_report(1e11), source="cli")
    assert rec["kind"] == "run_report"
    assert list(rec["legs"]) == ["partitioned_bf16"]
    assert history.env_class(rec) == ("cuda", "NVIDIA H100 80GB HBM3")
    ledger = str(tmp_path / "h.jsonl")
    assert history.append_record(ledger, rec)
    assert not history.append_record(ledger, rec)  # deduped
    for i in range(4):
        history.append_record(ledger, history.normalize_result(
            _port_report(1e11 * (1 + 0.001 * i), rev=f"r{i}"), source="cli"))
    recs = history.read_ledger(ledger)
    assert len(recs) == 5
    pts = history.series(recs, "partitioned_bf16", "edges_per_sec_per_chip",
                         klass=("cuda", "NVIDIA H100 80GB HBM3"))
    assert len(pts) == 5
    assert not history.series(recs, "partitioned_bf16",
                              "edges_per_sec_per_chip",
                              klass=("cuda", "NVIDIA H200"))
    slow = history.normalize_result(_port_report(5e10, bpe=9.0, rev="x"),
                                    source="cli")
    changes = history.detect_changes(recs + [slow])
    assert any(c.leg == "partitioned_bf16" and c.direction == "regression"
               for c in changes)


def _couple(layout, l1=2.9e-14):
    return {"metric": "edges_per_sec_per_chip", "value": 3.0e10,
            "unit": "edges/s/chip", "layout": layout,
            "fast_f32": {"value": 8.0e10}, "build_warm_s": 1.5,
            "accuracy": {"config": "f64" if layout else "pair-f64",
                         "normalized_l1_vs_f64_oracle": l1}}


def test_a_bench_r05_couple_record_normalizes_as_the_jax_one():
    doc = json.loads((REPO / "BENCH_r05.json").read_text())
    got = history.normalize_result(doc, source="BENCH_r05.json")
    want = jax_history.normalize_result(doc, source="BENCH_r05.json")
    assert got == want
    # No layout (the r01-r05 rounds): the headline was pair-f64.
    assert got["kind"] == "bench_couple"
    assert "pair_f64" in got["legs"] and "f64" not in got["legs"]
    assert got["legs"]["pair_f64"]["accuracy_l1"] > 0


def test_a_port_couple_record_files_its_headline_under_f64():
    rec = history.normalize_result(_couple({"form": "flat_ell",
                                            "pair": False}), source="p")
    assert set(rec["legs"]) == {"f64", "fast_f32"}
    head = rec["legs"]["f64"]
    assert head["edges_per_sec_per_chip"] == 3.0e10
    assert head["build_warm_s"] == 1.5 and head["accuracy_l1"] == 2.9e-14
    # A couple whose layout ran pair sums keeps the JAX leg name.
    pair = _couple({"pair": True})
    got = history.normalize_result(pair, source="j")
    assert "pair_f64" in got["legs"] and "f64" not in got["legs"]
    assert got == jax_history.normalize_result(pair, source="j")
