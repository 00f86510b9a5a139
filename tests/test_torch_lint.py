"""The port's AST lint (PTL) and concurrency pass (PTR):
``pagerank_tpu_torch/analysis/lint.py``, ``concurrency.py`` and
``roots.py`` against the JAX package's own passes.

Each rule's seeded-defect fixture (the JAX tests' fixtures of
``tests/test_analysis.py`` and ``tests/test_concurrency_analysis.py``,
restated for torch where the JAX rule named a jax spelling: PTL002 and
PTL003) exits 1 under ``python -m pagerank_tpu_torch.analysis`` with
exactly its rule within its family. On the fixtures the rules share
with JAX unchanged, the port's findings are JAX's, line for line. The
port's own tree is clean under ``--select PTL,PTR`` with its allowlist,
and every waiver there matches a live finding.
"""

import ast
import json
import os
import textwrap

import pytest

from pagerank_tpu.analysis import concurrency as jax_conc
from pagerank_tpu.analysis import lint as jax_lint

from pagerank_tpu_torch.analysis import concurrency as conc_mod
from pagerank_tpu_torch.analysis import kernels as kernels_mod
from pagerank_tpu_torch.analysis import lint as lint_mod
from pagerank_tpu_torch.analysis import load_allowlist, split_allowlisted
from pagerank_tpu_torch.analysis import roots as roots_mod
from pagerank_tpu_torch.analysis.__main__ import main as analysis_main


def _write(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


def _rules_of(findings):
    return {f.rule for f in findings}


#: The JAX fixtures; PTL002 and PTL003 restated for torch.
PTL_FIXTURES = {
    "PTL001": """
        def f(ids, table):
            return (table[ids >> 7] << 7) | (ids & 127)
    """,
    "PTL002": """
        import torch

        def f(n):
            return torch.zeros(n)
    """,
    "PTL003": """
        import torch

        class Engine:
            def _device_step(self):
                d = torch.sum(self._r)
                torch.cuda.synchronize()
                return d.item(), self._r.cpu()
    """,
    "PTL004": """
        def f(x, acc=[]):
            acc.append(x)
            return acc
    """,
    "PTL005": """
        import numpy as np

        def f(x):
            return np.asarray(x, dtype=np.float64)
    """,
    "PTL006": """
        def f(x):
            try:
                return x()
            except Exception:
                pass
    """,
    "PTL007": """
        import sys

        def f(msg):
            print(msg)
            sys.stderr.write(msg)
    """,
    "PTL008": """
        import atexit
        import signal

        def f(handler):
            signal.signal(signal.SIGTERM, handler)
            atexit.register(handler)
    """,
}

#: The JAX fixtures of tests/test_concurrency_analysis.py, unchanged.
PTR_FIXTURES = {
    "PTR001": """
        import threading

        class Worker:
            def __init__(self):
                self.total = 0
                self._thread = threading.Thread(
                    target=self._run, name="acc", daemon=True)
                self._thread.start()

            def _run(self):
                self.total += 1   # written on the 'acc' thread

            def read(self):
                return self.total  # read on the main thread, no lock

            def stop(self):
                self._thread.join()
    """,
    "PTR002": """
        import threading

        class Pair:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def ab(self):
                with self._a:
                    with self._b:
                        return 1

            def ba(self):
                with self._b:
                    with self._a:
                        return 2
    """,
    "PTR003": """
        import signal
        import threading

        class Server:
            def __init__(self):
                self._lock = threading.Lock()
                self.flag = False
                signal.signal(signal.SIGTERM, self._on_term)

            def _on_term(self, signum, frame):
                print("terminating")   # I/O in handler context
                with self._lock:       # lock acquire in handler context
                    self.flag = True
    """,
    "PTR004": """
        import threading
        import time

        class Cache:
            def __init__(self):
                self._lock = threading.Lock()
                self.data = {}

            def refresh(self):
                with self._lock:
                    time.sleep(0.1)    # blocking while holding the lock
                    self.data["k"] = 1
    """,
    "PTR005": """
        import json
        import threading

        def _work():
            with open("/tmp/x.json", "w") as f:
                json.dump({}, f)       # durable write on a daemon thread

        def spawn():
            t = threading.Thread(target=_work, name="bg", daemon=True)
            t.start()                  # never joined anywhere

        def spawn_forever(handler):
            u = threading.Thread(target=handler, name="fg")
            u.start()                  # non-daemon, never joined
    """,
    "PTR006": """
        import threading
        import time

        class Poller:
            def __init__(self):
                self._last = 0.0
                self._thread = threading.Thread(
                    target=self._run, name="poller", daemon=True)
                self._thread.start()

            def _run(self):
                self._last = time.monotonic()  # raw clock in thread code

            def stop(self):
                self._thread.join()
    """,
}

FIXTURES = {**PTL_FIXTURES, **PTR_FIXTURES}


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_seeded_fixture_exits_1_with_exactly_its_rule(tmp_path, capsys,
                                                      rule):
    path = _write(tmp_path, f"bad_{rule.lower()}.py", FIXTURES[rule])
    rc = analysis_main([path, "--select", rule[:3], "--allowlist", "none",
                        "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and doc["ok"] is False
    assert {f["rule"] for f in doc["findings"]} == {rule}


@pytest.mark.parametrize("rule", sorted(
    set(PTL_FIXTURES) - {"PTL002", "PTL003"}))
def test_shared_lint_rules_find_what_jax_finds(tmp_path, rule):
    path = _write(tmp_path, f"bad_{rule.lower()}.py", FIXTURES[rule])

    def key(findings):
        return sorted((f.rule, f.line, f.col, f.snippet) for f in findings)

    assert key(lint_mod.lint_file(path)) == key(jax_lint.lint_file(path))


@pytest.mark.parametrize("rule", sorted(PTR_FIXTURES))
def test_ptr_finds_what_jax_finds(tmp_path, rule):
    path = _write(tmp_path, f"bad_{rule.lower()}.py", FIXTURES[rule])

    def key(findings):
        return sorted((f.rule, f.line, f.col, f.snippet) for f in findings)

    assert key(conc_mod.analyze_file(path)) == key(
        jax_conc.analyze_file(path))


def test_jax_spellings_do_not_fire_the_torch_rules(tmp_path):
    """PTL002 and PTL003 read torch's constructors and the queued
    bodies: JAX's fixtures (a jnp constructor, a jit-decorated print)
    are not the port's defect."""
    jnp_ctor = _write(tmp_path, "jnp.py", """
        import jax.numpy as jnp

        def f(n):
            return jnp.zeros(n)
    """)
    assert "PTL002" not in _rules_of(lint_mod.lint_file(jnp_ctor))
    pinned = _write(tmp_path, "pinned.py", """
        import torch

        def f(n, dev):
            return (torch.zeros(n, dtype=torch.float32, device=dev),
                    torch.arange(n, dtype=torch.int64))
    """)
    assert lint_mod.lint_file(pinned) == []
    host_step = _write(tmp_path, "host_step.py", """
        class Engine:
            def step(self):
                d, m = self._device_step()
                return float(d), float(m)
    """)
    assert lint_mod.lint_file(host_step) == []


def test_fixed_variants_stay_quiet(tmp_path):
    """The same structure with the discipline applied (a common lock;
    the injectable clock) gives no PTR finding."""
    locked = _write(tmp_path, "locked.py", """
        import threading

        class Worker:
            def __init__(self):
                self.total = 0
                self._lock = threading.Lock()
                self._thread = threading.Thread(
                    target=self._run, name="acc", daemon=True)
                self._thread.start()

            def _run(self):
                with self._lock:
                    self.total += 1

            def read(self):
                with self._lock:
                    return self.total

            def stop(self):
                self._thread.join()
    """)
    assert conc_mod.analyze_file(locked) == []
    injectable = _write(tmp_path, "injectable.py", """
        import threading
        import time

        class Poller:
            def __init__(self, clock=time.monotonic):
                self._clock = clock
                self._last = 0.0
                self._thread = threading.Thread(
                    target=self._run, name="poller", daemon=True)
                self._thread.start()

            def _run(self):
                self._last = self._clock()

            def stop(self):
                self._thread.join()
    """)
    assert [f for f in conc_mod.analyze_file(injectable)
            if f.rule == "PTR006"] == []


def test_scopes_exempt_entry_points_and_supervisors(tmp_path):
    prints = _write(tmp_path, "prints.py", PTL_FIXTURES["PTL007"])
    handlers = _write(tmp_path, "handlers.py", PTL_FIXTURES["PTL008"])

    def rule(path, rid, rel):
        return [f for f in lint_mod.lint_file(path, rel) if f.rule == rid]

    assert len(rule(prints, "PTL007", "utils/foo.py")) == 2
    assert rule(prints, "PTL007", "cli.py") == []
    assert rule(prints, "PTL007", "obs/__main__.py") == []
    assert len(rule(handlers, "PTL008", "serving/daemon.py")) == 2
    assert rule(handlers, "PTL008", "jobs.py") == []
    assert rule(handlers, "PTL008", "cli.py") == []
    step = _write(tmp_path, "step.py", PTL_FIXTURES["PTL003"])
    assert len(rule(step, "PTL003", "engines/torch_engine.py")) == 3
    assert rule(step, "PTL003", "serving/daemon.py") == []


def test_handler_roots_shared_source_of_truth():
    """PTL008's scope and PTR003's root discovery read one tuple; the
    port's GracefulDrain install is discovered by the shared walker."""
    assert roots_mod.HANDLER_OWNER_MODULES == ("jobs.py", "cli.py")
    for rel in roots_mod.HANDLER_OWNER_MODULES:
        assert lint_mod._scope_match("handler_free", rel) is False
    path = os.path.join(lint_mod.package_root(), "jobs.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    installs = list(roots_mod.iter_handler_installs(tree))
    assert any(cls == "GracefulDrain" for _call, _h, cls in installs)


@pytest.fixture(scope="module")
def program():
    return conc_mod.build_package_program()


def test_the_ports_thread_roots_are_discovered(program):
    labels = {ts.label for ts in program.thread_sites}
    assert {"rank-writer", "pagerank-stall-watchdog",
            "pagerank-serve-dispatch", "pagerank-serve-keepalive",
            "pagerank-serve-http"} <= labels
    assert ("signal:GracefulDrain._handler",
            "jobs.py::GracefulDrain._handler") in program.signal_roots


def test_the_daemons_rescue_runs_in_the_dispatcher(program):
    """The rescue (and the front's channel) run in the dispatcher
    thread: what the daemon's lock discipline and its PTR006 waivers
    serve."""
    ctx = program.contexts
    for fn in ("_group_rescue", "_front_dispatch", "_become_front"):
        assert "pagerank-serve-dispatch" in \
            ctx[f"serving/daemon.py::PprServer.{fn}"]


@pytest.fixture(scope="module")
def tree_findings():
    return lint_mod.lint_tree() + conc_mod.analyze_package()


def test_the_ports_tree_is_clean_with_its_allowlist(tree_findings):
    allow = os.path.join(lint_mod.package_root(), "analysis",
                         "allowlist.txt")
    active, waived = split_allowlisted(tree_findings, load_allowlist(allow))
    assert [f.render() for f in active] == []
    assert not any(f.rule in ("PTR003", "PTL001", "PTL002", "PTL003")
                   for f in tree_findings)
    # The real-clock sites are the daemon's group timing and the rank
    # writer's measurements, each waived with its reason.
    assert {f.path for f in tree_findings if f.rule == "PTR006"} == {
        "serving/daemon.py", "utils/snapshot.py"}


def test_every_waiver_has_a_reason_and_matches_a_live_finding(
        tree_findings):
    allow = os.path.join(lint_mod.package_root(), "analysis",
                         "allowlist.txt")
    waivers = load_allowlist(allow)
    assert all(len(w.reason) > 20 for w in waivers)
    findings = tree_findings + [
        f for c in kernels_mod.shipped_cases()
        for f in kernels_mod.check_kernel_case(c)]
    _active, waived = split_allowlisted(findings, waivers)
    used = {id(w) for _f, w in waived}
    assert [w for w in waivers if id(w) not in used] == []


def test_cli_select_ptl_ptr_is_clean(capsys):
    assert analysis_main(["--select", "PTL,PTR", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True and doc["counts"]["active"] == 0
    assert doc["counts"]["waived"] > 0
    assert set(doc) == {"version", "ok", "compiled", "counts", "findings",
                        "waived"}


def test_cli_in_package_file_keeps_scoping_and_allowlist(capsys):
    target = os.path.join(lint_mod.package_root(), "ops", "ell.py")
    assert analysis_main([target, "--select", "PTL", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["counts"]["waived"] == 3  # the host weight-plane waivers


def test_cli_list_rules_names_every_family(capsys):
    assert analysis_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in list(FIXTURES) + ["PTK001"]:
        assert rid in out
    assert "PTC" not in out and "PTH" not in out
