"""The PPR daemon over three gloo ranks on the CPU when member 0 loses
its device, its process, or first its device and then a survivor.

``pagerank_tpu_torch/testing/ppr_group.py:serve_plan`` serves four
batches of four queries. JAX's own test of the loss of device 0,
``tests/test_serving.py::test_server_rescues_and_reruns_inflight_batch``,
kills it with ``DeviceFaultSchedule(seed=11, kill={0: 1})`` and expects
the in-flight batch ``answered_degraded`` on ``ndev - 1`` devices after
one rescue; the same schedule goes through the same shim on member 0
here. Member 0 then serves on as the front: it launches nothing (its
engine runs stay flat after the loss) and the survivors [1, 2] answer,
within the f32 tolerance of ``tests/test_torch_ppr_sharded.py`` (rtol
1e-5 at f32 over f32 sums) of ``PprJaxEngine`` on the same graph and
sources. A SIGKILL of member 0's process is terminal: both followers
exit 1 and nothing hangs. A later SIGKILL of member 2 after the front
took over leaves member 1 serving alone. A loss found by member 0's
echo alone, which answers only after the followers' roll call ended,
still leaves member 0 serving as the front: its presence went up
before the echo.

Each scenario runs ONE spawned group a session, shared by the xdist
workers under a file lock, as ``tests/test_torch_ppr_sharded.py`` does.
"""

import contextlib
import fcntl
import json
import os

import numpy as np
import pytest

import pagerank_tpu
from pagerank_tpu.engines import ppr as jax_ppr

from pagerank_tpu_torch.parallel import distributed
from pagerank_tpu_torch.testing.faults import ProcessKillPlan
from pagerank_tpu_torch.utils.synth import rmat_edges

ITERS = 10
TOPK = 8
F32 = dict(dtype="float32", accum_dtype="float32")
BATCHES = 4
BATCH = 4
#: scenario: the payload's faults.
SCENARIOS = {
    "device0": dict(device_kill={1: 0}),
    "process0": dict(kill=ProcessKillPlan(
        "serve", iteration=2, signum=9, rank=0).to_env()[ProcessKillPlan.ENV]),
    # After the front took over, member 2 is rank 1 of the survivors'
    # group (the kill plan reads RANK), killed on dispatch 3.
    "device0_then_member2": dict(device_kill={1: 0}, kill=ProcessKillPlan(
        "serve", iteration=3, signum=9, rank=1).to_env()[ProcessKillPlan.ENV]),
    # A loss naming no one on batch 1, found by member 0's echo alone,
    # which answers only after the followers' roll call has ended.
    "echo0_hangs": dict(echo_hang={"batch": 1, "seconds": 4.0},
                        probe_timeout_s=2.0),
}


def _batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 1 << 10, BATCH).tolist() for _ in range(BATCHES)]


def _shared_root(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / "torch_serve_front"
    root.mkdir(exist_ok=True)
    return root


@contextlib.contextmanager
def _locked(path):
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _run(tmp_path_factory, name):
    root = _shared_root(tmp_path_factory)
    d = root / name
    with _locked(root / f"{name}.lock"):
        if not (d / "done.json").exists():
            d.mkdir(exist_ok=True)
            src, dst = rmat_edges(10, edge_factor=8, seed=1)
            np.savez(d / "edges.npz", src=src, dst=dst, n=1 << 10)
            faults = dict(SCENARIOS[name])
            probe_timeout_s = faults.pop("probe_timeout_s", 30.0)
            codes = distributed.spawn_group(
                "pagerank_tpu_torch.testing.ppr_group:serve_plan", 3,
                dict(edges=str(d / "edges.npz"), out=str(d), device="cpu",
                     config=dict(num_iters=ITERS, **F32),
                     serve=dict(max_batch=BATCH, topk=TOPK,
                                deadline_ms=60000.0, cache_capacity=0,
                                probe_timeout_s=probe_timeout_s),
                     batches=_batches(), **faults),
                str(d), backend="gloo", timeout_s=60.0, deadline_s=120.0,
                rescue=True)
            (d / "done.json").write_text(json.dumps(
                {"codes": list(codes), "lost": list(codes.lost),
                 "hosts": list(codes.hosts)}))
    done = json.loads((d / "done.json").read_text())
    files = {f[:-4]: dict(np.load(d / f)) for f in os.listdir(d)
             if f.endswith(".npz") and f != "edges.npz"}
    return done, files


@pytest.fixture(scope="module")
def jax_answer():
    src, dst = rmat_edges(10, edge_factor=8, seed=1)
    g = pagerank_tpu.build_graph(src, dst, n=1 << 10)
    res = jax_ppr.PprJaxEngine(pagerank_tpu.PageRankConfig(
        num_iters=ITERS, **F32)).build(g).run(
        np.concatenate(_batches()), topk=TOPK)
    return res.topk_ids, res.topk_scores


def _held_to_jax(got, want):
    ids, scores = got["ids"], got["scores"]
    np.testing.assert_allclose(scores, want[1], rtol=1e-5, atol=0)
    # ids where the scores are untied at that tolerance
    s = want[1]
    gap = np.ones_like(s, bool)
    gap[:, 1:] &= np.abs(np.diff(s, axis=1)) > 1e-5 * np.abs(s[:, 1:])
    gap[:, :-1] &= gap[:, 1:]
    np.testing.assert_array_equal(ids[gap], want[0][gap])


def test_member_0s_device_loss_reruns_degraded_over_the_survivors(
        tmp_path_factory, jax_answer):
    """JAX's ``kill={0: 1}``: batch 0 answered over three ranks, the
    in-flight batch 1 and every later one ``answered_degraded`` over
    members [1, 2], one rescue, and every process exits 0 (the launcher
    records member 0's device lost and its process among the hosts)."""
    done, files = _run(tmp_path_factory, "device0")
    assert done == {"codes": [0, 0, 0], "lost": [0], "hosts": [0]}
    got = files["serve"]
    assert got["outcomes"].tolist() == (["answered"] * BATCH
                                        + ["answered_degraded"]
                                        * (BATCH * (BATCHES - 1)))
    assert int(got["device_count"]) == 2 and bool(got["degraded"])
    assert got["device_ids"].tolist() == [1, 2]
    assert int(got["rescues"]) == 1 and str(got["fatal"]) == ""
    counters = json.loads(str(got["counters"]))
    assert counters["serve.rescues"] == 1
    assert counters["serve.devices_lost"] == 1
    assert counters["serve.batch_reruns"] == 1
    assert counters["serve.answered_degraded"] == BATCH * (BATCHES - 1)
    walls = json.loads(str(got["walls"]))
    assert len(walls) == 1 and set(walls[0]) == {"roll_call", "rerun"}
    for m in (1, 2):
        assert str(files[f"follower.m{m}"]["status"]) == "stopped"
    _held_to_jax(got, jax_answer)


def test_member_0_launches_nothing_after_its_device_is_lost(
        tmp_path_factory):
    """Member 0 ran the warm-up and batch 0 (two engine runs) and not
    one after the loss; each survivor ran the warm-up, batch 0, the
    re-run and the two later batches."""
    _, files = _run(tmp_path_factory, "device0")
    assert files["serve"]["runs"].tolist() == [1, 2, 2, 2, 2]
    for m in (1, 2):
        assert int(files[f"follower.m{m}"]["runs"]) == 2 + BATCHES - 1


def test_sigkill_of_member_0s_process_ends_every_follower_nonzero(
        tmp_path_factory):
    """Member 0 SIGKILLs itself before dispatch 2: the followers' roll
    call finds its process ended (no host lives on), both raise
    ``ElasticExhaustedError`` and exit 1, within the spawn's deadline."""
    done, files = _run(tmp_path_factory, "process0")
    assert done["codes"] == [-9, 1, 1]
    assert done["lost"] == [0] and done["hosts"] == []
    for m in (1, 2):
        assert str(files[f"follower.m{m}"]["status"]) == "terminal"
    assert "serve" not in files


def test_a_later_survivor_loss_keeps_the_front(tmp_path_factory,
                                              jax_answer):
    """After the front took over, member 2 dies on dispatch 3: member 1
    regroups alone, the front adopts the verdict from the store and
    re-sends the batch; two rescues in the budget of two, everything
    answered, ``device_count`` 1."""
    done, files = _run(tmp_path_factory, "device0_then_member2")
    assert done == {"codes": [0, 0, -9], "lost": [0, 2], "hosts": [0]}
    got = files["serve"]
    assert got["outcomes"].tolist() == (["answered"] * BATCH
                                        + ["answered_degraded"]
                                        * (BATCH * (BATCHES - 1)))
    assert got["device_ids"].tolist() == [1]
    assert int(got["device_count"]) == 1 and int(got["rescues"]) == 2
    counters = json.loads(str(got["counters"]))
    assert counters["serve.devices_lost"] == 2
    assert counters["serve.batch_reruns"] == 2
    assert str(files["follower.m1"]["status"]) == "stopped"
    _held_to_jax(got, jax_answer)


def test_a_hung_echo_on_member_0_still_rescues_onto_the_front(
        tmp_path_factory, jax_answer):
    """Batch 1 fails with a loss that names no one, and member 0's echo
    answers false only after 4 s, past the followers' roll call of 2 s.
    Member 0 posted its presence before the echo, so the followers'
    verdict names it dead and among the hosts: the group rescues onto
    the front as under ``kill={0: 1}``, and no process is terminal."""
    done, files = _run(tmp_path_factory, "echo0_hangs")
    assert done == {"codes": [0, 0, 0], "lost": [0], "hosts": [0]}
    got = files["serve"]
    assert got["outcomes"].tolist() == (["answered"] * BATCH
                                        + ["answered_degraded"]
                                        * (BATCH * (BATCHES - 1)))
    assert got["device_ids"].tolist() == [1, 2]
    assert int(got["device_count"]) == 2 and int(got["rescues"]) == 1
    assert str(got["fatal"]) == ""
    walls = json.loads(str(got["walls"]))
    assert walls[0]["roll_call"] >= 4.0
    for m in (1, 2):
        assert str(files[f"follower.m{m}"]["status"]) == "stopped"
    _held_to_jax(got, jax_answer)
