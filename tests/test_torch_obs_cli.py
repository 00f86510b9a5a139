"""``python -m pagerank_tpu_torch.obs`` against the JAX package's
``python -m pagerank_tpu.obs`` (``pagerank_tpu/obs/__main__.py``) on
the same inputs.

The run reports are two of the port's own CLI runs (``--run-report``,
rmat:8 on the CPU) and every ledger is made in ``tmp_path``: no test
here reads a results file of the repo. ``report`` and ``history``
give JAX's exit codes and ``--json`` documents, apart from the
environment block (the port fingerprints torch, not jax) and the
ledger's leg names: the port files a run under its engine's layout
(``flat_f32``, ``obs/history.leg_name_for_layout``) where the JAX tool,
which cannot read a port layout, falls back to its config's
(``fast_f32``). ``graph`` gives the same integer profile of the same
R-MAT edges; ``fit`` the same keys and verdict at a scale that fits
and at one that cannot (its byte counts differ by design: JAX asks
XLA, the port reckons). ``hlo`` exits 2; ``campaign status`` of a
directory that holds no campaign exits 2, as JAX's does (the campaign
itself: ``tests/test_torch_campaign.py``).
"""

import contextlib
import io
import json

import pytest

from pagerank_tpu.obs.__main__ import main as jax_main

from pagerank_tpu_torch import cli
from pagerank_tpu_torch.obs.__main__ import main as port_main

PORT_LEG, JAX_LEG = "flat_f32", "fast_f32"


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(argv_jax, argv_port=None):
    return _run(jax_main, argv_jax), _run(port_main, argv_port or argv_jax)


def _scrub(doc):
    """The document without its environment blocks, with the JAX leg
    name read as the port's."""
    if isinstance(doc, dict):
        return {(PORT_LEG if k == JAX_LEG else k): _scrub(v)
                for k, v in doc.items()
                if k not in ("environment", "env", "ingested_unix",
                             "content_hash")}
    if isinstance(doc, list):
        return [_scrub(v) for v in doc]
    if isinstance(doc, str):
        return doc.replace(JAX_LEG, PORT_LEG)
    return doc


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs_cli")
    for name in ("a", "b"):
        assert cli.main(["--synthetic", "rmat:8", "--device", "cpu",
                         "--iters", "3", "--log-every", "0",
                         "--run-report", str(d / f"{name}.json")]) == 0
    return d


@pytest.fixture(scope="module")
def ledgers(reports):
    """Each tool's ledger of the two reports, and its ingest answer."""
    out = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        led = reports / f"{name}.jsonl"
        out[name] = (led, _run(main, ["history", "ingest", str(led),
                                      str(reports / "a.json"),
                                      str(reports / "b.json"), "--json"]))
    return out


@pytest.mark.parametrize("argv", [["a", "--json"], ["a", "b", "--json"],
                                  ["a"], ["a", "b"]],
                         ids=["one-json", "two-json", "one", "two"])
def test_report_matches_jax(reports, argv):
    paths = [str(reports / f"{a}.json") if len(a) == 1 else a for a in argv]
    (jrc, jout, _), (prc, pout, _) = _both(["report"] + paths)
    assert jrc == prc == 0
    if "--json" in argv:
        assert json.loads(pout) == json.loads(jout)
    else:
        # The same rendering below the environment line.
        assert pout.splitlines()[1:] == jout.splitlines()[1:]


@pytest.mark.parametrize("argv,rc", [(["x.json"], 2), (["a", "b", "c"], 2),
                                     (["a", "b", "--against-history",
                                       "l.jsonl"], 2)])
def test_report_usage_errors_are_jaxs(reports, argv, rc):
    paths = [str(reports / f"{a}.json") if len(a) == 1 else a for a in argv]
    (jrc, _, _), (prc, _, _) = _both(["report"] + paths)
    assert jrc == prc == rc


def test_report_against_history_matches_jax(reports, ledgers):
    a = str(reports / "a.json")
    (jrc, jout, _), (prc, pout, _) = _both(
        ["report", a, "--against-history", str(ledgers["jax"][0]), "--json"],
        ["report", a, "--against-history", str(ledgers["port"][0]),
         "--json"])
    assert jrc == prc == 0
    assert _scrub(json.loads(pout)) == _scrub(json.loads(jout))


def test_history_ingest_matches_jax(ledgers):
    (jrc, jout, _), (prc, pout, _) = ledgers["jax"][1], ledgers["port"][1]
    assert jrc == prc == 0
    assert json.loads(pout) == json.loads(jout) == {"added": 2,
                                                    "deduped": 0}


def test_history_reingest_dedupes_as_jax_does(reports, ledgers, tmp_path):
    for name, main in (("jax", jax_main), ("port", port_main)):
        led = tmp_path / f"{name}.jsonl"
        led.write_text(ledgers[name][0].read_text())
        rc, out, _ = _run(main, ["history", "ingest", str(led),
                                 str(reports / "a.json"), "--json"])
        assert rc == 0 and json.loads(out) == {"added": 0, "deduped": 1}


def test_history_trend_matches_jax(ledgers):
    (jrc, jout, _), (prc, pout, _) = _both(
        ["history", "trend", str(ledgers["jax"][0]), "--json"],
        ["history", "trend", str(ledgers["port"][0]), "--json"])
    assert jrc == prc == 0
    assert _scrub(json.loads(pout)) == _scrub(json.loads(jout))
    assert all(PORT_LEG in r["legs"] for r in json.loads(pout))


def _budgets(tmp_path, floor):
    """A budgets file for each tool, on its own leg name."""
    out = {}
    for name, leg in (("jax", JAX_LEG), ("port", PORT_LEG)):
        path = tmp_path / f"budgets.{name}.json"
        path.write_text(json.dumps({"schema_version": 1, "budgets": [
            {"leg": leg, "metric": "edges_per_sec_per_chip",
             "min": floor}]}))
        out[name] = str(path)
    return out


@pytest.mark.parametrize("floor,rc", [(1.0, 0), (1e15, 1)],
                         ids=["pass", "violation"])
def test_history_gate_matches_jax(ledgers, reports, tmp_path, floor, rc):
    budgets = _budgets(tmp_path, floor)
    for extra in ([], ["--record", str(reports / "a.json")]):
        (jrc, jout, _), (prc, pout, _) = _both(
            ["history", "gate", str(ledgers["jax"][0]), "--budgets",
             budgets["jax"], "--json"] + extra,
            ["history", "gate", str(ledgers["port"][0]), "--budgets",
             budgets["port"], "--json"] + extra)
        assert jrc == prc == rc
        assert _scrub(json.loads(pout)) == _scrub(json.loads(jout))


def test_history_gate_propose_budgets_matches_jax(ledgers, tmp_path):
    budgets = _budgets(tmp_path, 1.0)
    docs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / f"proposal.{name}.json"
        rc, doc, _ = _run(main, ["history", "gate", str(ledgers[name][0]),
                                 "--budgets", budgets[name],
                                 "--propose-budgets", str(out), "--json"])
        assert rc == 0 and out.exists()
        docs[name] = json.loads(doc)
        docs[name]["proposal"].pop("out")
    assert _scrub(docs["port"]) == _scrub(docs["jax"])


@pytest.mark.parametrize("argv", [
    ["history", "trend", "missing.jsonl"],
    ["history", "gate", "missing.jsonl"],
])
def test_history_missing_ledger_is_a_usage_error(tmp_path, argv):
    argv = argv[:2] + [str(tmp_path / argv[2])]
    (jrc, _, _), (prc, _, _) = _both(argv)
    assert jrc == prc == 2


def test_history_propose_without_budgets_is_a_usage_error(ledgers,
                                                          tmp_path):
    (jrc, _, _), (prc, _, _) = _both(
        ["history", "gate", str(ledgers["jax"][0]), "--propose-budgets",
         str(tmp_path / "p.json")],
        ["history", "gate", str(ledgers["port"][0]), "--propose-budgets",
         str(tmp_path / "p.json")])
    assert jrc == prc == 2


@pytest.mark.parametrize("argv,fits", [
    (["--scale", "10"], True),
    (["--scale", "26", "--hbm-gb", "16"], False),
], ids=["fits", "cannot"])
def test_fit_keys_and_verdict_match_jax(argv, fits):
    (jrc, jout, _), (prc, pout, _) = _both(["fit"] + argv + ["--json"])
    assert jrc == prc == (0 if fits else 1)
    jd, pd = json.loads(jout), json.loads(pout)
    assert set(pd) == set(jd)
    assert pd["fits"] is jd["fits"] is fits
    for key in ("n", "num_edges", "ndev", "dtype", "accum_dtype", "scale"):
        assert pd[key] == jd[key]
    assert {s["stage"] for s in pd["stages"]} >= {"build/sort",
                                                  "solve/step"}


@pytest.mark.parametrize("argv", [["--hbm-gb", "0"], ["--headroom", "2"]])
def test_fit_usage_errors_are_jaxs(argv):
    (jrc, _, _), (prc, _, _) = _both(["fit", "--scale", "10"] + argv)
    assert jrc == prc == 2


def test_graph_profile_matches_jax():
    """The same R-MAT scale-10 edges (seed 0): the integer profile and
    the mass ledger's verdict are JAX's."""
    (jrc, jout, _), (prc, pout, _) = _both(
        ["graph", "--scale", "10", "--json"],
        ["graph", "--scale", "10", "--json", "--device", "cpu"])
    assert jrc == prc == 0
    jp, pp = json.loads(jout)["profile"], json.loads(pout)["profile"]
    for key in ("n", "num_edges", "raw_edges", "duplicate_edges",
                "self_loops", "dangling_count", "zero_in_count", "in_hist",
                "out_hist", "top_hub_ids", "top_hub_in_degrees"):
        assert pp[key] == jp[key], key
    pl = json.loads(pout)["ledger"]
    assert pl["ok"] is json.loads(jout)["ledger"]["ok"] is True
    assert pl["entries"] == pl["probes"] == 4


def test_graph_without_a_card_is_a_usage_error():
    rc, _, err = _run(port_main, ["graph", "--scale", "6"])
    assert rc == 2 and "cuda" in err.lower()


@pytest.mark.parametrize("argv", [["hlo"], ["hlo", "--form", "all"],
                                  ["campaign", "status", "--campaign-dir",
                                   "x"]])
def test_hlo_and_campaign_exit_2_naming_why(argv):
    rc, _, err = _run(port_main, argv)
    assert rc == 2
    if argv[0] == "hlo":
        assert "not applicable" in err
    else:
        assert "no campaign in x" in err
        assert _run(jax_main, argv)[0] == 2
