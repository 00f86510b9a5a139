"""The port's campaign plane (``pagerank_tpu_torch/obs/campaign.py``) held
to the JAX package's (``pagerank_tpu/obs/campaign.py``) on the CPU: each
of the four verdicts gives the JAX ``extract_verdict``'s decision and
evidence on ``tests/test_campaign.py``'s documents; ``build_spec``'s legs
are the JAX legs less ``hlo`` (and its ``gather_native`` precondition
and the ``pallas_keep_or_delete`` verdict); and the runner, driven
through stub entrypoints, completes and resumes to a byte-identical
report, drains at a leg boundary (exit 75 through the CLI), recomputes a
corrupt artifact, blocks a binding leg on a failed precondition, gives
the CLI's status and report exit codes, and writes a stable report
byte-identical to JAX's ``build_report`` of the same manifest. The whole
dry run over two gloo ranks is acceptance key AA
(``tests/test_torch_acceptance.py``)."""

import json
import os

import pytest

from pagerank_tpu.obs import campaign as jax_campaign
from pagerank_tpu.obs import history as jax_history
from pagerank_tpu.obs import report as jax_report
from test_campaign import couple_output, multichip_output, serve_output

from pagerank_tpu_torch import jobs
from pagerank_tpu_torch.obs import campaign
from pagerank_tpu_torch.obs import history
from pagerank_tpu_torch.obs.__main__ import main as obs_main


@pytest.fixture(scope="module")
def budgets():
    return (history.load_budgets(campaign.default_budgets_path()),
            jax_history.load_budgets(jax_campaign.default_budgets_path()))


def _no_values():
    out = couple_output()
    out["fast_f32"]["value"] = None
    return out


def _no_overlap():
    out = multichip_output()
    del out["exchange_overlap"]
    return out


#: (verdict, leg, leg output) — tests/test_campaign.py's documents.
CASES = {
    "part_flip": ("partitioned_vs_default", "bench_couple",
                  couple_output(part=4.2e8, f32=3.5e8)),
    "part_keep": ("partitioned_vs_default", "bench_couple",
                  couple_output(part=3.6e8, f32=3.5e8)),
    "part_no_lowering": ("partitioned_vs_default", "bench_couple",
                         couple_output(with_lowering=False)),
    "part_none_values": ("partitioned_vs_default", "bench_couple",
                         _no_values()),
    "halo_keep": ("halo_vs_dense", "bench_multichip",
                  multichip_output(sparse=2.0e8, dense=1.6e8)),
    "halo_dense": ("halo_vs_dense", "bench_multichip",
                   multichip_output(sparse=1.4e8, dense=1.6e8)),
    "halo_empty": ("halo_vs_dense", "bench_multichip", {}),
    "async_flip": ("async_overlap", "bench_multichip",
                   multichip_output(gain=0.12, below=True)),
    "async_small_gain": ("async_overlap", "bench_multichip",
                         multichip_output(gain=0.02, below=True)),
    "async_penalty": ("async_overlap", "bench_multichip",
                      multichip_output(gain=0.2, sync_iters=10,
                                       async_iters=40)),
    "async_diverged": ("async_overlap", "bench_multichip",
                       multichip_output(gain=0.2, converged=False)),
    "async_no_block": ("async_overlap", "bench_multichip", _no_overlap()),
    "serve_tighten": ("ppr_serve_floors", "ppr_serve",
                      serve_output(qps=150.0)),
    "serve_keep": ("ppr_serve_floors", "ppr_serve", serve_output(qps=105.0)),
    "serve_violated": ("ppr_serve_floors", "ppr_serve",
                       serve_output(qps=50.0, p99=700.0)),
    "serve_none": ("ppr_serve_floors", "ppr_serve", serve_output(qps=None)),
}


def test_the_port_keeps_four_verdicts_of_the_jax_five():
    assert set(campaign.VERDICTS) == set(jax_campaign.VERDICTS) - {
        "pallas_keep_or_delete"}
    for d, text in campaign.ACTION_TEXT.items():
        assert jax_campaign.ACTION_TEXT[d] == text
    assert set(jax_campaign.ACTION_TEXT) - set(campaign.ACTION_TEXT) == {
        "keep_pallas_kernel", "delete_pallas_kernel"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_verdict_equals_the_jax_extract_verdict(case, budgets):
    vname, leg, out = CASES[case]
    ours_b, theirs_b = budgets
    for doc in ({"output": out}, None):
        for binding in (True, False):
            for over in (False, True):
                got = campaign.extract_verdict(vname, leg, doc, ours_b,
                                               binding, over)
                want = jax_campaign.extract_verdict(vname, leg, doc,
                                                    theirs_b, binding, over)
                assert got == want, (doc is None, binding, over)
    # A budgets file without serving floors adjudicates the same way.
    assert campaign.extract_verdict(vname, leg, {"output": out},
                                    {"budgets": []}, True, False) == \
        jax_campaign.extract_verdict(vname, leg, {"output": out},
                                     {"budgets": []}, True, False)


@pytest.mark.parametrize("part, f32, decision", [
    (4.2e8, 3.5e8, "flip_partitioned_to_default"),
    (3.6e8, 3.5e8, "keep_step_default")])
def test_partitioned_verdict_adds_the_ports_byte_model(part, f32, decision,
                                                       budgets):
    """On a port record (each leg's ``costs.step.bytes_per_edge``) the
    verdict keeps the JAX decision and evidence and adds the port's own
    byte model beside them; a flip's reason quotes the port's ratio."""
    out = couple_output(part=part, f32=f32)
    out["fast_f32"]["costs"] = {"step": {"bytes_per_edge": 24.0}}
    out["partitioned_f32"]["costs"] = {"step": {"bytes_per_edge": 16.0}}
    got = campaign.extract_verdict("partitioned_vs_default", "bench_couple",
                                   {"output": out}, budgets[0], True, False)
    want = jax_campaign.extract_verdict("partitioned_vs_default",
                                        "bench_couple", {"output": out},
                                        budgets[1], True, False)
    port = {k: got["evidence"].pop(k)
            for k in ("port_bytes_per_edge", "port_model_ratio")}
    assert port == {"port_bytes_per_edge": {"fast_f32": 24.0,
                                            "partitioned_f32": 16.0},
                    "port_model_ratio": 1.5}
    assert got["decision"] == want["decision"] == decision
    assert got["evidence"] == want["evidence"]
    if decision == "flip_partitioned_to_default":
        assert "the port's model headroom 1.50x" in got["reason"]
        assert "3.55x" not in got["reason"]
    else:
        assert got["reason"] == want["reason"]


def _without_hlo(spec):
    legs = []
    for leg in spec.legs:
        if leg.name == "hlo":
            continue
        doc = leg.to_doc()
        doc["preconditions"] = [p for p in doc["preconditions"]
                                if p != "gather_native"]
        doc["verdicts"] = [v for v in doc["verdicts"]
                           if v != "pallas_keep_or_delete"]
        legs.append(doc)
    return legs


@pytest.mark.parametrize("profile", ["roadmap", "smoke"])
@pytest.mark.parametrize("ndev", [2, 8])
def test_build_spec_is_the_jax_spec_less_hlo(profile, ndev):
    ours = campaign.build_spec(profile, ndev=ndev)
    theirs = jax_campaign.build_spec(profile, ndev=ndev)
    assert ours.name == theirs.name
    assert [leg.to_doc() for leg in ours.legs] == _without_hlo(theirs)
    for leg in ours.legs:
        assert leg.entrypoint in campaign.ENTRYPOINTS
        assert all(p in campaign.PRECONDITIONS for p in leg.preconditions)
        assert all(v in campaign.VERDICTS for v in leg.verdicts)
    assert {v for leg in ours.legs for v in leg.verdicts} == \
        set(campaign.VERDICTS)
    assert campaign.CampaignSpec.from_doc(ours.to_doc()) == ours
    # --device rides the legs that take it, and no other.
    on = campaign.build_spec(profile, ndev=ndev, device="cpu")
    for a, b in zip(on.legs, ours.legs):
        argv = list(b.params.get("argv", []))
        if b.name in ("graph", "bench_couple", "bench_multichip",
                      "ppr_serve"):
            argv += ["--device", "cpu"]
        assert a.params.get("argv", []) == argv, a.name


# -- the runner, through stub entrypoints ------------------------------------


def _leg(name, out, verdicts=(), preconditions=(), **params):
    return campaign.LegSpec(
        name, "stub", {"doc": {"command": [name], "exit_code": 0,
                               "output": out}, **params},
        budget_s=60.0, preconditions=preconditions, verdicts=verdicts)


def stub_spec(**couple_params):
    return campaign.CampaignSpec(name="stub", legs=(
        _leg("fit", {"fits": True}),
        _leg("bench_couple", couple_output(),
             verdicts=("partitioned_vs_default",), **couple_params),
        _leg("ppr_serve", serve_output(), verdicts=("ppr_serve_floors",)),
    ))


@pytest.fixture
def stub_entry(monkeypatch):
    calls = []

    def _stub(params, ctx):
        calls.append(params)
        if params.get("raise"):
            raise RuntimeError("leg exploded")
        return params["doc"]

    monkeypatch.setitem(campaign.ENTRYPOINTS, "stub", _stub)
    return calls


class _DrainAt:
    """A drain whose check fires at one leg boundary."""

    def __init__(self, where):
        self.where = where

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def check(self, where=""):
        if where == self.where:
            raise jobs.DrainInterrupt(f"drain at {where}")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_complete_then_resume_report_byte_identical(tmp_path, stub_entry):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    r1 = campaign.CampaignRunner(d1, stub_spec(), fake_devices=2)
    r1.run()
    assert r1.manifest["status"] == "complete"
    r1.write_report()
    r2 = campaign.CampaignRunner(d2, stub_spec(**{"raise": True}),
                                 fake_devices=2)
    r2.run()
    assert r2.manifest["status"] == "failed"
    assert "leg exploded" in r2.manifest["legs"]["bench_couple"]["error"]
    del stub_entry[:]
    r3 = campaign.CampaignRunner(d2, stub_spec(), fake_devices=2)
    r3.run()
    assert r3.manifest["status"] == "complete"
    assert r3.manifest["legs"]["fit"]["skipped"] is True
    assert r3.manifest["legs"]["bench_couple"]["skipped"] is False
    assert [p["doc"]["command"] for p in stub_entry] == [["bench_couple"]]
    r3.write_report()
    a = _read(os.path.join(d1, campaign.REPORT_NAME))
    assert a == _read(os.path.join(d2, campaign.REPORT_NAME))
    rep = json.loads(a)
    assert rep["complete"] is True and rep["binding"] is False
    assert all(v["decision"] == "defer" for v in rep["verdicts"].values())
    assert len(rep["decision_ledger"]) == 2
    assert "resumes" not in rep and "evidence" not in rep


def test_drain_at_a_leg_boundary_then_resume(tmp_path, stub_entry):
    d = str(tmp_path / "c")
    r = campaign.CampaignRunner(d, stub_spec(), fake_devices=2)
    with pytest.raises(jobs.DrainInterrupt):
        r.run(drain=_DrainAt("campaign/ppr_serve"))
    r.interrupt("campaign/ppr_serve")
    with open(os.path.join(d, campaign.MANIFEST_NAME)) as f:
        m = json.load(f)
    assert m["status"] == "interrupted"
    assert m["legs"]["bench_couple"]["status"] == "done"
    assert "ppr_serve" not in m["legs"]
    del stub_entry[:]
    r2 = campaign.CampaignRunner(d, stub_spec(), fake_devices=2)
    r2.run()
    assert r2.manifest["status"] == "complete"
    assert r2.manifest["resumes"] == 1 and len(stub_entry) == 1


def test_cli_run_drains_to_75_and_resumes(tmp_path, stub_entry,
                                          monkeypatch, capsys):
    d = str(tmp_path / "cli")
    monkeypatch.setattr(campaign, "build_spec",
                        lambda profile, ndev, device: stub_spec())
    monkeypatch.setattr(jobs, "GracefulDrain",
                        lambda deadline_s: _DrainAt("campaign/ppr_serve"))
    argv = ["campaign", "run", "--campaign-dir", d, "--fake-devices", "2",
            "--device", "cpu", "--json"]
    assert obs_main(argv) == 75
    assert "drained on signal" in capsys.readouterr().err
    monkeypatch.setattr(jobs, "GracefulDrain",
                        lambda deadline_s: _DrainAt("nowhere"))
    assert obs_main(argv) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["complete"] is True and rep["fake_devices"] == 2


def test_corrupt_artifact_recomputes(tmp_path, stub_entry):
    d = str(tmp_path / "corrupt")
    r = campaign.CampaignRunner(d, stub_spec(), fake_devices=2)
    r.run()
    with open(r.artifact_path(0, stub_spec().legs[0]), "r+b") as f:
        f.seek(60)
        f.write(b"\xff\xff\xff\xff")
    del stub_entry[:]
    r2 = campaign.CampaignRunner(d, stub_spec(), fake_devices=2)
    r2.run()
    assert r2.manifest["legs"]["fit"]["skipped"] is False
    assert r2.manifest["legs"]["bench_couple"]["skipped"] is True
    assert [p["doc"]["command"] for p in stub_entry] == [["fit"]]


def test_binding_precondition_blocks_and_dry_run_warns(tmp_path,
                                                       stub_entry):
    spec = campaign.CampaignSpec(name="stub", legs=(
        _leg("fit", {"fits": False}),
        _leg("bench_multichip", multichip_output(),
             verdicts=("halo_vs_dense",), preconditions=("fits",)),
    ))
    rb = campaign.CampaignRunner(str(tmp_path / "bind"), spec)
    rb.run()
    assert rb.manifest["legs"]["bench_multichip"]["status"] == "blocked"
    assert rb.write_report()["verdicts"]["halo_vs_dense"]["decision"] == \
        "inconclusive"
    rf = campaign.CampaignRunner(str(tmp_path / "fake"), spec,
                                 fake_devices=2)
    rf.run()
    assert rf.manifest["status"] == "complete"
    assert any("non-binding dry run" in w for w in
               rf.manifest["legs"]["bench_multichip"]["warnings"])


def test_cli_status_and_report_exit_codes(tmp_path, stub_entry, capsys):
    assert obs_main(["campaign", "status", "--campaign-dir",
                     str(tmp_path / "nope")]) == 2
    assert obs_main(["campaign", "report", "--campaign-dir",
                     str(tmp_path / "nope")]) == 2
    capsys.readouterr()
    d = str(tmp_path / "partial")
    r = campaign.CampaignRunner(d, stub_spec(), fake_devices=2)
    with pytest.raises(jobs.DrainInterrupt):
        r.run(drain=_DrainAt("campaign/ppr_serve"))
    r.interrupt("campaign/ppr_serve")
    assert obs_main(["campaign", "status", "--campaign-dir", d]) == 0
    assert "interrupted" in capsys.readouterr().out
    assert obs_main(["campaign", "report", "--campaign-dir", d,
                     "--json"]) == 1
    rep = json.loads(capsys.readouterr().out)
    assert [e["status"] for e in rep["legs"]] == ["done", "done", "pending"]
    assert obs_main(["campaign", "report", "--campaign-dir", d, "--json",
                     "--full"]) == 1
    full = json.loads(capsys.readouterr().out)
    assert "evidence" in full and "leg_docs" in full


def test_stable_report_equals_the_jax_build_report(tmp_path, stub_entry,
                                                   budgets):
    for fake, name in ((2, "dry"), (0, "binding")):
        d = str(tmp_path / name)
        r = campaign.CampaignRunner(d, stub_spec(), fake_devices=fake)
        r.run()
        r.write_report()
        spec, manifest, docs, metas = campaign.load_campaign(d)
        jspec = jax_campaign.CampaignSpec.from_doc(manifest["spec"])
        want = jax_campaign.build_report(jspec, manifest, docs, metas,
                                         budgets[1])
        with open(os.path.join(d, campaign.REPORT_NAME)) as f:
            assert f.read() == jax_report.canonical_json(want)
        ours = campaign.build_report(spec, manifest, docs, metas,
                                     budgets[0], full=True)
        theirs = jax_campaign.build_report(jspec, manifest, docs, metas,
                                           budgets[1], full=True)
        assert ours == theirs
        assert campaign.render_report(ours) == \
            jax_campaign.render_report(theirs)
        assert campaign.render_status(manifest) == \
            jax_campaign.render_status(manifest)
