"""The port stands alone: no file of pagerank_tpu_torch/, and not
chip_smoke.py or chip_rehearse.py, imports jax, jaxlib, pagerank_tpu or
the root bench.py (the JAX tool; the port's is pagerank_tpu_torch.bench);
importing the package loads no jax; and it imports with no triton and no
nvcc, since the kernels are built lazily, at first launch."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "pagerank_tpu", "bench")


def _port_files():
    files = sorted((REPO / "pagerank_tpu_torch").rglob("*.py"))
    assert len(files) > 10
    return files + [REPO / "chip_smoke.py", REPO / "chip_rehearse.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_package_import(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _run(code, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300, cwd=str(REPO))


def test_importing_the_port_loads_no_jax():
    r = _run(
        "import sys, pagerank_tpu_torch, pagerank_tpu_torch.cli, "
        "pagerank_tpu_torch.convert, pagerank_tpu_torch.kernels.build, "
        "pagerank_tpu_torch.ops.ell_spmv, "
        "pagerank_tpu_torch.ops.ell_spmv_partitioned, "
        "pagerank_tpu_torch.ops.device_build, "
        "pagerank_tpu_torch.ops.gather_probe, "
        "pagerank_tpu_torch.scripts.probe_gather, "
        "pagerank_tpu_torch.scripts.acceptance, "
        "pagerank_tpu_torch.ops.defect_fixtures, "
        "pagerank_tpu_torch.analysis.kernels, "
        "pagerank_tpu_torch.analysis.resources, "
        "pagerank_tpu_torch.analysis.__main__, "
        "pagerank_tpu_torch.analysis.lint, "
        "pagerank_tpu_torch.analysis.concurrency, "
        "pagerank_tpu_torch.analysis.roots, "
        "pagerank_tpu_torch.obs.__main__, "
        "pagerank_tpu_torch.obs.costs, pagerank_tpu_torch.ingest, "
        "pagerank_tpu_torch.ingest.native, "
        "pagerank_tpu_torch.ingest.external, "
        "pagerank_tpu_torch.utils.metrics, "
        "pagerank_tpu_torch.scripts.host_ingest_bench, "
        "pagerank_tpu_torch.jobs, pagerank_tpu_torch.sdc, "
        "pagerank_tpu_torch.testing, pagerank_tpu_torch.testing.faults, "
        "pagerank_tpu_torch.testing.schedules, "
        "pagerank_tpu_torch.obs.graph_profile, "
        "pagerank_tpu_torch.utils.retry, pagerank_tpu_torch.utils.s3, "
        "pagerank_tpu_torch.utils.fsio, pagerank_tpu_torch.utils.snapshot, "
        "pagerank_tpu_torch.obs, pagerank_tpu_torch.obs.probes, "
        "pagerank_tpu_torch.obs.live, pagerank_tpu_torch.obs.devices, "
        "pagerank_tpu_torch.obs.report, pagerank_tpu_torch.obs.history, "
        "pagerank_tpu_torch.obs.profiler, pagerank_tpu_torch.serve.__main__, "
        "pagerank_tpu_torch.parallel.mesh, "
        "pagerank_tpu_torch.parallel.distributed, "
        "pagerank_tpu_torch.parallel.partition, "
        "pagerank_tpu_torch.parallel.comms, "
        "pagerank_tpu_torch.parallel.elastic, "
        "pagerank_tpu_torch.testing.sharded, "
        "pagerank_tpu_torch.testing.elastic, "
        "pagerank_tpu_torch.testing.load, "
        "pagerank_tpu_torch.testing.ppr_group, "
        "pagerank_tpu_torch.utils.config, pagerank_tpu_torch.bench, "
        "pagerank_tpu_torch.obs.campaign\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    assert r.returncode == 0, r.stdout + r.stderr[-800:]


def test_imports_without_triton_or_nvcc(tmp_path):
    """No nvcc on PATH or under CUDA_HOME, and triton unimportable: the
    package still imports and runs on the CPU; only a build raises."""
    blocker = tmp_path / "triton.py"
    blocker.write_text("raise ImportError('no triton here')\n")
    r = _run(
        "import sys; sys.path.insert(0, %r)\n"
        "import pagerank_tpu_torch as pt\n"
        "from pagerank_tpu_torch.kernels import build\n"
        "from pagerank_tpu_torch.utils import synth\n"
        "import numpy as np\n"
        "assert 'triton' not in sys.modules\n"
        "s, d = synth.rmat_edges(8)\n"
        "g = pt.build_graph(s, d, n=256)\n"
        "r = pt.TorchEngine(pt.PageRankConfig(num_iters=2), device='cpu')"
        ".build(g).run()\n"
        "assert np.isfinite(r).all()\n"
        "assert build.sources() == ['defect_fixtures', 'ell_contrib', "
        "'ell_contrib_partitioned', 'ell_contrib_spmm', 'gather_probe']\n"
        "r = pt.TorchEngine(pt.PageRankConfig(num_iters=2, "
        "partition_span=128), device='cpu').build(g).run()\n"
        "assert np.isfinite(r).all()\n"
        "try:\n"
        "    build.find_nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('nvcc:', e)\n" % str(tmp_path),
        {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path / "none")},
    )
    assert r.returncode == 0, r.stdout + r.stderr[-800:]
    if not Path("/usr/local/cuda/bin/nvcc").is_file():  # a CUDA host has one
        assert "nvcc not found" in r.stdout
