"""Compile facts of the port's kernels, read from the built libraries.

Registers, static shared memory, local memory (spills), the compiled
thread limit and f64 instructions exist only after ``nvcc``. This
module reads them from each built ``build/kernels/lib<name>-<hash>.so``
(kernels/build.py) with the CUDA toolkit's ``cuobjdump``:
``--dump-resource-usage`` for REG/SHARED/LOCAL, ``-elf`` for each
function's EIATTR_MAX_THREADS (its ``__launch_bounds__``), ``-sass``
for the instructions; ``cu++filt`` demangles the names. A cached
library has no build log, so the binary is the one source. The SHARED
that cuobjdump reports includes the 1 KB the card reserves for a block
on every kernel of a library in which any kernel uses shared memory
(``obs/costs.py:smem_reserved``).

Keys are demangled names cut to ``symbol<template args>``, without
spaces or ``(anonymous namespace)::`` — what ``kernels.Launch.key``
spells. Runs only under ``--compiled``; a host without the toolkit
raises :class:`ToolchainMissing`.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple


class ToolchainMissing(RuntimeError):
    """A CUDA toolkit program the compile facts need is not installed."""


@dataclasses.dataclass(frozen=True)
class SymbolFacts:
    """What the compiler made of one kernel."""

    demangled: str
    regs: int
    shared: int
    local: int
    stack: int
    max_threads: Optional[int]
    f64_ops: Tuple[str, ...]

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


#: SASS opcodes that compute on f64 (the conversions to and from f64
#: included).
_F64_OP = re.compile(r"^(?:DADD|DMUL|DFMA|DSETP|DMNMX|DSET|DMMA|DRCP|"
                     r"[FI]2[FI]\S*\.F64\S*|F2F\S*F64\S*)$")


def find_tools() -> Dict[str, str]:
    """Paths of cuobjdump and cu++filt: beside nvcc ($CUDA_HOME/bin,
    /usr/local/cuda/bin), then PATH."""
    dirs = []
    if os.environ.get("CUDA_HOME"):
        dirs.append(Path(os.environ["CUDA_HOME"]) / "bin")
    dirs.append(Path("/usr/local/cuda/bin"))
    tools, missing = {}, []
    for tool in ("cuobjdump", "cu++filt"):
        found = next((str(d / tool) for d in dirs if (d / tool).is_file()),
                     None) or shutil.which(tool)
        if found is None:
            missing.append(tool)
        else:
            tools[tool] = found
    if missing:
        raise ToolchainMissing(
            f"{' and '.join(missing)} not found (looked in $CUDA_HOME/bin, "
            f"/usr/local/cuda/bin and PATH): the compile facts need the "
            f"CUDA toolkit")
    return tools


def symbol_key(demangled: str) -> str:
    """``void <unnamed>::segment_partials<float, float>(const T1 *,
    ...)`` (cu++filt's spelling) -> ``segment_partials<float,float>``;
    a bool argument ``(bool)1`` reads ``true``, an int ``(int)64``
    reads ``64``."""
    s = re.sub(r"<unnamed>::|\(anonymous namespace\)::", "", demangled)
    s = re.sub(r"^\s*void\s+", "", s)
    s = s.replace("(bool)1", "true").replace("(bool)0", "false")
    s = re.sub(r"\(int\)(-?\d+)", r"\1", s)
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return re.sub(r"\s+", "", s[:cut])


def parse_resource_usage(text: str) -> Dict[str, Dict[str, int]]:
    """{mangled function: {REG, SHARED, LOCAL, STACK}} from
    ``cuobjdump --dump-resource-usage``."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for ln in text.splitlines():
        m = re.match(r"\s*Function\s+(.+?):\s*$", ln)
        if m:
            name = m.group(1)
            continue
        if name and "REG:" in ln:
            vals = dict(re.findall(r"\b(REG|SHARED|LOCAL|STACK):(\d+)", ln))
            out[name] = {k: int(v) for k, v in vals.items()}
            name = None
    return out


def parse_max_threads(text: str) -> Dict[str, int]:
    """{mangled function: EIATTR_MAX_THREADS x*y*z} from ``cuobjdump
    -elf`` (the ``.nv.info.<function>`` sections)."""
    out: Dict[str, int] = {}
    for sec in re.split(r"(?=^\s*\.section\s|\n\.nv\.info\.)", text,
                        flags=re.M):
        m = re.search(r"\.nv\.info\.(\S+)", sec)
        if not m:
            continue
        a = re.search(r"EIATTR_MAX_THREADS\s*\n?\s*Format:\s*\S+\s*\n?\s*"
                      r"Value:\s*((?:0x[0-9a-fA-F]+\s*)+)", sec)
        if a:
            dims = [int(v, 16) for v in a.group(1).split()]
            total = 1
            for d in dims[:3]:
                total *= d
            out[m.group(1)] = total
    return out


def parse_sass_f64(text: str) -> Dict[str, Tuple[str, ...]]:
    """{mangled function: sorted f64 opcodes} from ``cuobjdump -sass``."""
    out: Dict[str, set] = {}
    name = None
    for ln in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, set())
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     ln)
        if name and m and _F64_OP.match(m.group(1)):
            out[name].add(m.group(1))
    return {k: tuple(sorted(v)) for k, v in out.items()}


def demangle(names: Iterable[str], cufilt: str) -> Dict[str, str]:
    names = list(names)
    if not names:
        return {}
    r = subprocess.run([cufilt], input="\n".join(names) + "\n",
                       capture_output=True, text=True, check=True,
                       timeout=60)
    lines = r.stdout.splitlines()
    if len(lines) != len(names):
        raise RuntimeError(f"cu++filt returned {len(lines)} names for "
                           f"{len(names)}")
    return dict(zip(names, lines))


def facts_from_dumps(res: str, elf: str, sass: str,
                     demangled: Dict[str, str]) -> Dict[str, SymbolFacts]:
    """Join the three dumps of one library into {key: SymbolFacts};
    ``demangled`` maps each mangled name to its demangled form."""
    usage = parse_resource_usage(res)
    bounds = parse_max_threads(elf)
    f64 = parse_sass_f64(sass)
    out = {}
    for mangled, u in usage.items():
        dm = demangled.get(mangled, mangled)
        out[symbol_key(dm)] = SymbolFacts(
            demangled=dm, regs=u.get("REG", 0), shared=u.get("SHARED", 0),
            local=u.get("LOCAL", 0), stack=u.get("STACK", 0),
            max_threads=bounds.get(mangled), f64_ops=f64.get(mangled, ()))
    return out


def _dumps(path: str, tools: Dict[str, str]) -> Tuple[str, str, str]:
    """cuobjdump's resource usage, ELF and SASS dumps of one library."""
    def dump(flag):
        return subprocess.run([tools["cuobjdump"], flag, str(path)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout

    return dump("--dump-resource-usage"), dump("-elf"), dump("-sass")


def library_facts(path: str, tools: Dict[str, str]) -> Dict[str, SymbolFacts]:
    """The compile facts of every kernel of one built library."""
    res, elf, sass = _dumps(path, tools)
    mangled = [n for n in parse_resource_usage(res) if n.startswith("_Z")]
    return facts_from_dumps(res, elf, sass,
                            demangle(mangled, tools["cu++filt"]))


def record_dumps(name: str, out_dir: str) -> List[str]:
    """Write the whole dumps of csrc/<name>.cu's library (built where
    missing) into ``out_dir`` as the CPU tests read them
    (``tests/data/cuobjdump/``): ``<name>.res.txt``, the same through
    ``cu++filt`` as ``<name>.res.demangled.txt``, ``<name>.elf.txt``
    and ``<name>.sass.txt``. Returns the paths written."""
    from pagerank_tpu_torch.kernels import build

    tools = find_tools()
    build.build_all([name])
    res, elf, sass = _dumps(str(build.library_path(name)), tools)
    demangled = subprocess.run([tools["cu++filt"]], input=res,
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for kind, text in (("res", res), ("res.demangled", demangled),
                       ("elf", elf), ("sass", sass)):
        path = out / f"{name}.{kind}.txt"
        path.write_text(text)
        written.append(str(path))
    return written


def built_facts(sources: List[str]) -> Dict[str, SymbolFacts]:
    """The compile facts of the named csrc/ sources' libraries, building
    any that is missing (one nvcc per source, all at once)."""
    from pagerank_tpu_torch.kernels import build

    tools = find_tools()
    try:
        build.find_nvcc()
    except RuntimeError as e:
        if not all(build.library_path(s).is_file() for s in sources):
            raise ToolchainMissing(str(e)) from e
    build.build_all(sources)
    out: Dict[str, SymbolFacts] = {}
    for s in sources:
        out.update(library_facts(str(build.library_path(s)), tools))
    return out
