"""The port's SDC-checked step (``pagerank_tpu_torch/sdc.py``,
``TorchEngine.step_sdc``) and the device-plane chaos of
``testing/faults.py``, held against the JAX package on the same seeded
input: the check values of the flat (K1), partitioned (K2) and coo forms
against ``JaxTpuEngine.step_sdc`` at one device (K1/K2 in interpret
mode) and a numpy oracle, ``evaluate_check``'s verdicts, the same
``DeviceFaultSchedule`` seed firing the same (iteration, kind, bit) with
the same transient/sticky outcome and ``sdc.*`` counters, the
zero-computation contract of ``sdc_check_every=0``, and the CLI's
``--sdc-check-every`` against the JAX CLI's."""

import json
import warnings

import numpy as np
import pytest
import torch

import pagerank_tpu
from pagerank_tpu import cli as jax_cli
from pagerank_tpu import sdc as jax_sdc
from pagerank_tpu.testing import faults as jax_faults
from pagerank_tpu_torch import PageRankConfig, build_graph, cli, jobs, sdc
from pagerank_tpu_torch.engines.torch_engine import TorchEngine
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.parallel.elastic import DeviceQuarantinedError
from pagerank_tpu_torch.testing.faults import (DeviceFaultSchedule,
                                               flip_element, flip_rank_bit,
                                               install_device_faults)

EPS32 = float(np.finfo(np.float32).eps)
FORMS = {"flat": {}, "partitioned": {"partition_span": 256},
         "coo": {"kernel": "coo"}}
JAX_FORMS = {"flat": {"kernel": "pallas"},
             "partitioned": {"kernel": "pallas", "partition_span": 256},
             "coo": {"kernel": "coo"}}


def _edges(seed=7, n=1024, e=8192):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e), n


def _port(form, **kw):
    src, dst, n = _edges()
    kw.setdefault("num_iters", 12)
    return TorchEngine(PageRankConfig(**FORMS[form], **kw),
                       device="cpu").build(build_graph(src, dst, n=n))


def _jax(form, **kw):
    src, dst, n = _edges()
    kw.setdefault("num_iters", 12)
    cfg = pagerank_tpu.PageRankConfig(num_devices=1, **JAX_FORMS[form], **kw)
    return pagerank_tpu.JaxTpuEngine(cfg).build(
        pagerank_tpu.build_graph(src, dst, n=n))


def _evaluate(mod, eng, pre, chk):
    return mod.evaluate_check(
        pre, chk, damping=eng.config.damping,
        semantics=eng.config.semantics, n=int(eng.graph.n),
        num_edges=int(eng.graph.num_edges), eps=EPS32)


def _steps(eng, k):
    for _ in range(k):
        eng.step()
        eng.iteration += 1


# -- the check values ---------------------------------------------------------

@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("semantics", ["reference", "textbook"])
def test_checked_step_matches_the_jax_step_sdc(form, semantics):
    """Two plain steps, then the boundary check and one checked step in
    both packages: every check value within 1e-6 relative (f32), the
    same verdict, and the step info's rank mass."""
    port, jx = _port(form, semantics=semantics), _jax(form,
                                                      semantics=semantics)
    assert port.sdc_supported() and jx.sdc_supported()
    _steps(port, 2)
    _steps(jx, 2)
    pre_p, pre_j = port.sdc_state_values(), jx.sdc_state_values()
    (info_p, chk_p), (info_j, chk_j) = port.step_sdc(), jx.step_sdc()
    for k in ("fp", "mass", "src"):
        if pre_j[k] is None:
            assert pre_p[k] is None
            continue
        np.testing.assert_allclose(pre_p[k], pre_j[k], rtol=1e-6)
    for k in ("fp_in", "mass_in", "src_in", "fp_out", "mass_out",
              "contrib", "retained", "mass_prev"):
        if chk_j[k] is None:
            assert chk_p[k] is None, k
            continue
        np.testing.assert_allclose(chk_p[k], chk_j[k], rtol=1e-6,
                                   err_msg=k)
    assert chk_p["dangling_mass"] == pytest.approx(chk_j["dangling_mass"],
                                                   rel=1e-6)
    vp, vj = _evaluate(sdc, port, pre_p, chk_p), _evaluate(jax_sdc, jx,
                                                          pre_j, chk_j)
    assert vp.ok and vj.ok, (vp.describe(), vj.describe())
    assert info_p["rank_mass"] == pytest.approx(info_j["rank_mass"],
                                                rel=1e-6)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_check_values_match_a_numpy_oracle(form):
    eng = _port(form, semantics="textbook", sdc_check_every=1)
    _steps(eng, 2)
    r = eng._r.numpy().astype(np.float64)
    w = sdc.fingerprint_vector(0, eng._n_state)
    pre = eng.sdc_state_values()
    info, chk = eng.step_sdc()
    r2 = eng._r.numpy().astype(np.float64)
    assert pre["fp"][0] == pytest.approx(w @ r, rel=1e-5, abs=1e-7)
    assert chk["fp_in"][0] == pre["fp"][0]
    assert chk["mass_prev"][0] == pytest.approx(r.sum(), rel=1e-6)
    assert chk["mass_out"][0] == pytest.approx(r2.sum(), rel=1e-6)
    assert chk["fp_out"][0] == pytest.approx(w @ r2, rel=1e-5, abs=1e-7)
    if form != "coo":
        inv = eng._inv_out.numpy()
        src = r[: inv.shape[0]][inv != 0].sum()
        assert chk["src_in"][0] == pytest.approx(src, rel=1e-6)
        assert float(chk["contrib"][0]) == pytest.approx(src, rel=1e-5)
    assert _evaluate(sdc, eng, pre, chk).ok


@pytest.mark.parametrize("field,delta", [("fp_in", 0.0), ("fp_in", 50.0),
                                         ("contrib", 50.0),
                                         ("mass_out", 50.0)])
def test_evaluate_check_gives_the_jax_verdict(field, delta):
    eng = _port("flat")
    _steps(eng, 3)
    pre = eng.sdc_state_values()
    _info, chk = eng.step_sdc()
    chk = dict(chk)
    chk[field] = chk[field] + delta
    vp, vj = (_evaluate(mod, eng, pre, chk) for mod in (sdc, jax_sdc))
    assert vp.ok == vj.ok == (delta == 0.0)
    assert vp.describe() == vj.describe()
    assert vp.suspect == vj.suspect


def test_tolerances_and_fingerprint_equal_the_jax_module():
    for n, e in ((1, None), (1024, 8192), (1 << 22, 1 << 26)):
        assert sdc.copy_tolerance(EPS32, n) == jax_sdc.copy_tolerance(EPS32, n)
        assert sdc.sdc_tolerance(EPS32, n, e) == jax_sdc.sdc_tolerance(
            EPS32, n, e)
    np.testing.assert_array_equal(sdc.fingerprint_vector(3, 4096),
                                  jax_sdc.fingerprint_vector(3, 4096))


# -- the flips: same seed, same bit, same outcome -----------------------------

@pytest.mark.parametrize("kind", ["mantissa", "exponent", "sign"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_flip_rank_bit_flips_the_jax_element_and_bit(kind, dtype):
    port = _port("flat", dtype=dtype, accum_dtype=dtype)
    jx = _jax("flat", dtype=dtype, accum_dtype=dtype)
    _steps(port, 2)
    _steps(jx, 2)
    before = port._r.clone()
    got = flip_rank_bit(port, 0, kind, 0.41)
    assert got == jax_faults.flip_rank_bit(jx, 0, kind, 0.41)
    changed = torch.nonzero(port._r != before).flatten().tolist()
    assert changed == [got[0]]
    # The mutated tensor is a copy: a buffer handed out earlier keeps
    # its bits.
    assert torch.equal(before, before.clone())


def _flip_seed(eng, n, iteration=4):
    """The first seed whose exponent flip at ``iteration`` moves w·r
    past twice the copy tolerance (so detection does not hang on
    rounding)."""
    ref = eng.__class__(eng.config.replace(sdc_check_every=0),
                        device="cpu").build(eng.graph)
    ref.run(num_iters=iteration)
    r = ref._r.numpy()[:n].astype(np.float64)
    floor = sdc.copy_tolerance(EPS32, n) * n
    for seed in range(100000):
        frac = DeviceFaultSchedule(seed=seed).flip_fraction(iteration)
        e = flip_element(frac, n, ref._r.numel())
        half = np.float32(r[e]).view(np.int32) & (1 << 23)
        if (r[e] / 2 if half else r[e]) > 2 * floor:
            return seed
    raise AssertionError("no seed")


@pytest.mark.parametrize("sticky", [False, True], ids=["one-shot", "sticky"])
def test_a_seeded_flip_has_the_jax_outcome(sticky):
    """The same DeviceFaultSchedule seed in both packages: the same
    fired (iteration, kind, element fraction), the same classification
    and sdc counters; a one-shot flip is redone to the clean bits, a
    sticky one quarantines device 0."""
    port = _port("flat", sdc_check_every=1)
    seed = _flip_seed(port, port.graph.n)
    plan = dict(seed=seed, flip={4: (0, "exponent")},
                sticky_flips=[4] if sticky else [])
    clean = _port("flat").run()
    outcomes = {}
    for name, eng, mod, fmod in (
            ("port", port, sdc, None),
            ("jax", _jax("flat", sdc_check_every=1), jax_sdc, jax_faults)):
        mod.reset()
        sched = (DeviceFaultSchedule(**plan) if fmod is None
                 else fmod.DeviceFaultSchedule(**plan))
        (install_device_faults if fmod is None
         else fmod.install_device_faults)(eng, sched)
        try:
            ranks = eng.run()
            err = None
        except Exception as e:  # the JAX package's own error type
            ranks, err = None, e
        rep = mod.report_section()
        outcomes[name] = (sched.log[4], rep["flips_detected"],
                          rep["transient"], rep["sticky"], rep["redos"],
                          rep["quarantined_devices"],
                          type(err).__name__ if err else None)
        if name == "port":
            if sticky:
                assert isinstance(err, DeviceQuarantinedError)
                assert err.device_ids == (0,)
            else:
                np.testing.assert_array_equal(ranks, clean)
        mod.reset()
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][1:4] == ((1, 0, 1) if sticky else (1, 1, 0))


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_flip_fraction_is_the_element_the_jax_schedule_flips(seed):
    """flip_fraction(i) is the element fraction a planned flip at i
    carries in both packages' schedules, and flip_element maps it to
    the element flip_rank_bit hits."""
    plan = dict(seed=seed, flip={i: (0, "sign") for i in range(6)})
    port = DeviceFaultSchedule(**plan)
    jx = jax_faults.DeviceFaultSchedule(**plan)
    for i in range(6):
        action = port.decide(i, [0])[0]
        assert action == tuple(jx.decide(i, [0])[0])
        assert action[3] == port.flip_fraction(i)
    eng = _port("flat")
    _steps(eng, 2)
    before = eng._r.clone()
    elem, _bit = flip_rank_bit(eng, 0, "sign", port.flip_fraction(5))
    assert elem == flip_element(port.flip_fraction(5), eng.graph.n,
                                before.numel())
    assert torch.equal(eng._r[elem], -before[elem])


def test_an_aimed_sign_flip_of_the_largest_rank_is_redone():
    """A plan entry (device, kind, frac) flips the element frac picks:
    the sign of the largest rank at iteration 4, which moves w·r by
    twice that rank, is detected, classified transient and redone to
    the clean bits; the log records the aimed fraction."""
    clean = _port("flat")
    clean.run(num_iters=4)
    n = clean.graph.n
    hub = int(torch.argmax(clean._r[:n]))
    frac = (hub + 0.5) / n
    want = _port("flat").run()
    sdc.reset()
    eng = _port("flat", sdc_check_every=1)
    sched = DeviceFaultSchedule(seed=0, flip={4: (0, "sign", frac)})
    install_device_faults(eng, sched)
    got = eng.run()
    rep = sdc.report_section()
    sdc.reset()
    assert (rep["flips_detected"], rep["transient"], rep["redos"]) == (1, 1, 1)
    np.testing.assert_array_equal(got, want)
    assert sched.log[4] == (4, "flip",
                            f"device 0 sign bit, element frac {frac:.6f}")
    assert flip_element(frac, n, clean._r.numel()) == hub


def test_sticky_conviction_persists_through_the_job_hook(tmp_path):
    job = jobs.JobSupervisor(str(tmp_path / "job"))
    port = _port("flat", sdc_check_every=1)
    seed = _flip_seed(port, port.graph.n)
    sdc.reset()
    sdc.set_quarantine_hook(job.quarantine_devices)
    install_device_faults(port, DeviceFaultSchedule(
        seed=seed, flip={4: (0, "exponent")}, sticky_flips=[4]))
    with pytest.raises(DeviceQuarantinedError):
        port.run()
    sdc.reset()
    man = json.loads((tmp_path / "job" / "job.json").read_text())
    assert man["quarantined_devices"] == [0]
    # A resumed job on that device refuses to build on it.
    with pytest.raises(SystemExit, match="quarantined"):
        cli.run(["--synthetic", "rmat:8", "--device", "cpu", "--iters", "2",
                 "--log-every", "0", "--job-dir", str(tmp_path / "job")])


# -- off means off; on changes nothing ----------------------------------------

@pytest.mark.parametrize("form", sorted(FORMS))
def test_check_every_zero_is_bit_identical_and_computation_free(form,
                                                               monkeypatch):
    baseline = _port(form).run()

    def boom(*a, **k):
        raise AssertionError("an SDC computation ran with checking off")

    for name in ("_sdc_w", "_sdc_sums", "sdc_state_values", "step_sdc",
                 "retain_state", "restore_state"):
        monkeypatch.setattr(TorchEngine, name, boom)
    monkeypatch.setattr(sdc, "attach_guard", boom)
    np.testing.assert_array_equal(_port(form, sdc_check_every=0).run(),
                                  baseline)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_checked_solve_is_bit_identical_to_the_unchecked(form):
    plain = _port(form).run()
    sdc.reset()
    obs_metrics.get_registry().reset()
    checked = _port(form, sdc_check_every=3).run()
    np.testing.assert_array_equal(plain, checked)
    rep = sdc.report_section()
    assert rep["checks"] == 4 and rep["flips_detected"] == 0
    assert obs_metrics.get_registry().snapshot()["counters"]["sdc.checks"] == 4
    sdc.reset()


def test_guard_token_follows_a_rollback():
    eng = _port("flat", sdc_check_every=1)
    guard = sdc.SdcGuard(eng)
    _steps(eng, 3)
    guard._token = eng.retain_state()
    eng.set_ranks(eng.ranks(), iteration=1)  # a rollback behind its back
    info = guard.checked_step()
    assert info["sdc"]["ok"] and eng.iteration == 1
    assert guard._token[0] == 2


# -- the CLI, against the JAX CLI ---------------------------------------------

def test_cli_sdc_run_matches_the_jax_clis(tmp_path):
    src, dst, n = _edges()
    edges = tmp_path / "e.txt"
    edges.write_text("".join(f"{a} {b}\n" for a, b in zip(src, dst)))
    argv = ["--input", str(edges), "--iters", "6", "--sdc-check-every", "2",
            "--log-every", "0"]
    s = cli.run(argv + ["--device", "cpu"])
    report = tmp_path / "r.json"
    assert jax_cli.main(argv + ["--num-devices", "1", "--run-report",
                                str(report)]) == 0
    theirs = json.loads(report.read_text())["sdc"]
    assert s["sdc"] == theirs
    assert s["sdc"]["checks"] == 3 and s["sdc"]["flips_detected"] == 0
    plain = cli.run(["--input", str(edges), "--iters", "6", "--log-every",
                     "0", "--device", "cpu"])
    np.testing.assert_array_equal(s["ranks"], plain["ranks"])


def test_cli_sdc_refusals_exit_2_as_the_jax_clis(tmp_path, capsys):
    edges = tmp_path / "e.txt"
    edges.write_text("0 1\n1 2\n2 0\n")
    for extra in (["--sdc-check-every", "-1"],
                  ["--sdc-check-every", "2", "--engine", "cpu"]):
        with pytest.raises(SystemExit) as e:
            cli.run(["--input", str(edges), "--device", "cpu", *extra])
        assert e.value.code == 2
        assert jax_cli.main(["--input", str(edges), *extra]) == 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        capsys.readouterr()
