"""Build and load the port's CUDA kernels.

Each ``pagerank_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C
interface, at first use, under ``build/kernels/`` at the root of the
checkout, and loaded with ``ctypes``. The output name carries a hash of
the source and the flags, so an edited source rebuilds and a stale
library is never loaded (the hash covers the shared headers,
``csrc/*.cuh``, as well). :func:`build_all` starts one ``nvcc`` per
source at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module on a
host with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}

#: Seconds :func:`build_all` has spent compiling in this process (0.0
#: while every library was already built): a caller reads it before and
#: after a call to learn what that call paid to ``nvcc``.
build_seconds = 0.0


def sources() -> List[str]:
    """Names of every kernel source under csrc/ (without ``.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built on this host"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: keyed by a hash
    of the source text, every header under csrc/ (``*.cuh``) and the
    compiler flags, so a header edit rebuilds too."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc_command(nvcc: str, name: str, out: Path,
                  extra: Iterable[str] = ()) -> List[str]:
    return [nvcc, *NVCC_FLAGS, *extra, "-o", str(out),
            str(CSRC_DIR / f"{name}.cu")]


def build_all(names: Optional[Iterable[str]] = None,
              extra_flags: Iterable[str] = ()) -> Dict[str, str]:
    """Compile every named source (default: all of csrc/) whose library
    is missing, one ``nvcc`` process per source, all started together.
    Returns ``{name: compiler output}`` for the sources it compiled
    (``extra_flags=("-Xptxas", "-v")`` makes that output the register
    and shared-memory report). Raises with the compiler's output on any
    failure."""
    global build_seconds
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[name] = (tmp, out, subprocess.Popen(
            _nvcc_command(nvcc, name, tmp, extra_flags),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = {}, []
    for name, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    build_seconds += time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first when
    it is missing. Loaded once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.is_file():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
