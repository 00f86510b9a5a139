"""Kernel-plane static analysis of the port: the PTK rules restated for
Hopper, checked over every launch of the port's CUDA kernels before the
card runs it.

Port of ``pagerank_tpu/analysis/kernels.py``. There a case was a
``pl.pallas_call`` traced abstractly and its BlockSpecs evaluated over
the grid. Here a **launch case** is one ``__global__`` symbol of
``pagerank_tpu_torch/csrc/`` at one instantiated geometry
(:class:`Launch`): grid and block, dynamic shared bytes, and a read and
a write model per operand — the element intervals its CTAs (or, in a
persistent kernel, its lane groups' work items) read, write or update
atomically, evaluated over the whole grid. One wrapper call is a
:class:`KernelCase`: its launches (K1 and K2 are one persistent launch
each), the operands they share, the config dtypes and an analytic cost
model.

What the source says is read from the source: each symbol's
``__launch_bounds__``, its ``__shared__`` declarations, whether the
file opts in above 48 KB of dynamic shared memory for it, and the
named constants that set its block size and tiles (:func:`read_source`).
The grids come from the wrappers' plan functions (``ops/ell.py:
segment_plan``, the pair ranks) evaluated on synthetic arrays, or on a
real pack's plan; nothing of the geometry is restated by hand.

  PTK001  shared memory: static + dynamic <= 232,448 B a block; static
          <= 48 KB; dynamic above 48 KB only where the source opts in
          with cudaFuncSetAttribute(<symbol>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, ...).
  PTK002  launch geometry: threads a block a multiple of 32, at most the
          symbol's __launch_bounds__ and 1024; grid.x <= 2^31-1, grid.y
          and grid.z <= 65,535; each vector-loaded operand aligned as
          its widest load needs.
  PTK003  CTA coverage: every read in bounds; every output element
          written by exactly one CTA (CTAs run in no order, so any
          double write is a race: the TPU's ordered revisit has no
          counterpart); a plain store to an element that another work
          item stores to or updates atomically is a race too, while
          atomic updates (the finishers' tickets on their counters) may
          meet; a scratch buffer is read exactly where it was written;
          an input a kernel must partition (K1's and K2's slot rows) is
          read exactly once; and every segment's rows belong to the
          block (pair) whose finisher sums it.
  PTK004  f64 discipline: no f64 template argument, shared buffer or
          operand in a case whose config is f32. The TPU rule's third
          clause (HBM refs touched only by DMA) has no Hopper
          counterpart: a CUDA kernel reads device memory directly.
  PTK005  cost sanity: FLOPs and bytes derived from the launches' models
          (each interval's bytes as often as CTAs touch it, a gathered
          table once) against the case's analytic model within 25%. The
          analytic model is the byte formula PERF.md's bounds use
          (:func:`k1_cost`, :func:`k2_cost`, :func:`probe_cost`; K1w's
          :func:`k1w_cost` adds the slot passes of its column tiles, its
          partials and its fold to the bound).

With compile facts (``--compiled``, :mod:`.resources`, read from the
built libraries), PTK001 also holds the declared static shared bytes
against the compiler's, PTK002 the declared __launch_bounds__ against
the compiler's and registers x threads against the SM's 65,536, and
local memory and the stack frame (a spill, or an array kept in memory)
against 0, or against the bytes :data:`STACK_EXCEPTIONS` records for a
named instance; PTK004 looks for f64
instructions in the SASS of a symbol registered under an f32 config.

Verdicts are deterministic and run on the CPU; the CLI is ``python -m
pagerank_tpu_torch.analysis --select PTK``. The shipped registry
(:func:`shipped_cases`) holds K1 and K2 at a toy geometry and at the
JAX campaign's bench scales 22-25, K1w at the PPR path's scale, and
P1-P3 at the probe's 2^19 rows;
the seeded-defect fixtures F1-F6 (:func:`defect_cases`) each trip
exactly their rule.
"""

from __future__ import annotations

import ast
import dataclasses
import operator
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pagerank_tpu_torch.analysis.findings import Finding
from pagerank_tpu_torch.obs import costs

LANES = 128

#: rule id -> one-line description (the CLI --list-rules catalogue).
RULES: Dict[str, str] = {
    "PTK001": "shared memory: static + dynamic <= 232,448 B a block, "
              "static <= 48 KB, dynamic > 48 KB only with the source's "
              "cudaFuncSetAttribute opt-in",
    "PTK002": "launch geometry: threads a multiple of 32 within "
              "__launch_bounds__ and 1024, grid limits, vector-load "
              "alignment; compiled: registers x threads, no local memory "
              "or stack frame (spills)",
    "PTK003": "CTA coverage: reads in bounds; every output element "
              "written by exactly one CTA (gaps AND races); segments "
              "partition the slot rows",
    "PTK004": "f64 discipline: no f64 argument, shared buffer or operand "
              "(compiled: no f64 SASS) under an f32 config",
    "PTK005": "cost sanity: FLOPs + bytes from the launch models vs the "
              "analytic bound formula within 25%",
}

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"

#: Bytes of the element types the sources declare.
_CTYPE_BYTES = {"float": 4, "double": 8, "int": 4, "int32_t": 4,
                "int64_t": 8, "uint32_t": 4, "uint64_t": 8, "uint16_t": 2,
                "uint8_t": 1, "unsigned char": 1, "char": 1,
                "unsigned short": 2}
_DTYPE_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2, "int32": 4,
                "int8": 1}


# ---------------------------------------------------------------------------
# The CUDA sources
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SharedDecl:
    """One ``__shared__`` declaration of a kernel body."""

    name: str
    ctype: str
    shape: Tuple[int, ...]  # () for the dynamic (extern) buffer
    dynamic: bool

    @property
    def nbytes(self) -> int:
        return 0 if self.dynamic else int(
            np.prod(self.shape)) * _CTYPE_BYTES[self.ctype]


@dataclasses.dataclass(frozen=True)
class CuKernel:
    """What the source declares about one ``__global__`` symbol."""

    symbol: str
    line: int
    launch_bounds: Optional[int]
    shared: Tuple[SharedDecl, ...]
    opt_in: bool  # cudaFuncSetAttribute(MaxDynamicSharedMemorySize)

    @property
    def static_smem(self) -> int:
        """The declarations' bytes as the compiler lays them out: in
        whole 16-byte units (cuobjdump's SHARED on sm_90a, e.g. F1's
        8-byte mbarrier takes 16)."""
        return -(-sum(d.nbytes for d in self.shared) // 16) * 16


@dataclasses.dataclass
class CuSource:
    """The parsed facts of one ``csrc/<name>.cu``."""

    name: str
    text: str  # comments blanked, line numbers kept
    constants: Dict[str, int]
    kernels: Dict[str, CuKernel]

    def const(self, name: str) -> int:
        if name not in self.constants:
            raise KeyError(f"csrc/{self.name}.cu declares no constant "
                           f"{name!r}")
        return self.constants[name]

    def _sites(self, symbol):
        pat = rf"\b{symbol}\s*(?:<[^;{{}}()]*>)?\s*<<<(.*?)>>>"
        return re.finditer(pat, self.text, re.S)

    def block_reaching(self, symbol: str, entry: str) -> List[str]:
        """What reaches the block slot of each ``symbol<<<>>>`` site when
        the C entry point ``entry`` runs: the site's argument, or, where
        that is a parameter of the launcher the site is in, the argument
        ``entry`` passes to the launcher in that place."""
        funcs = _functions(self.text)
        out = []
        for m in self._sites(symbol):
            arg = _split_args(m.group(1))[1].strip()
            host = min((f for f in funcs if f[2] <= m.start() < f[3]),
                       key=lambda f: f[3] - f[2], default=None)
            if host is None or arg not in host[1]:
                out.append(arg)
                continue
            callers = [f for f in funcs if f[0] == entry]
            if not callers:
                raise KeyError(f"csrc/{self.name}.cu: no function {entry}")
            body = self.text[callers[0][2]:callers[0][3]]
            call = re.search(rf"\b{host[0]}\s*\(", body)
            if call is None:
                continue  # this entry does not reach the site
            args = _split_args(_parened(body, call.end() - 1)[1:-1])
            out.append(args[host[1].index(arg)].strip())
        return out


def _functions(text: str):
    """(name, parameter names, body start, body end) of every function
    definition of a source."""
    out = []
    for m in re.finditer(r"\b(\w+)\s*\(([^;{}()]*)\)\s*\{", text):
        if m.group(1) in ("if", "for", "while", "switch"):
            continue
        params = [re.findall(r"\w+", p)[-1] for p in
                  _split_args(m.group(2)) if re.findall(r"\w+", p)]
        body = _braced(text, m.end() - 1)
        out.append((m.group(1), params, m.end() - 1,
                    m.end() - 1 + len(body)))
    return out


def _parened(text: str, start: int) -> str:
    """``text[start:]`` up to the parenthesis matching the one at
    ``start``."""
    depth = 0
    for i in range(start, len(text)):
        depth += {"(": 1, ")": -1}.get(text[i], 0)
        if depth == 0:
            return text[start:i + 1]
    raise ValueError("unbalanced parentheses")


def _blank_comments(text: str) -> str:
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))

    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, text, flags=re.S)


def _split_args(s: str) -> List[str]:
    """Split a call's argument text at its top-level commas."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "(<[":
            depth += 1
        elif ch in ")>]":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def _braced(text: str, start: int) -> str:
    """``text[start:]`` up to the brace matching the one at ``start``."""
    depth = 0
    for i in range(start, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return text[start:i + 1]
    raise ValueError("unbalanced braces")


_OPS = {ast.Add: operator.add, ast.Sub: operator.sub,
        ast.Mult: operator.mul, ast.Div: operator.floordiv}


def _eval_int(expr: str, consts: Dict[str, int]) -> int:
    """An integer constant expression of literals (C suffixes dropped),
    known constants and + - * / ( ), with C's integer division (the
    operands here are non-negative); ValueError for anything else."""
    def ev(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name) and node.id in consts:
            return consts[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -ev(node.operand)
        raise ValueError(f"not a constant expression: {expr!r}")

    try:
        tree = ast.parse(re.sub(r"\b(\d+)[uUlL]+\b", r"\1", expr.strip()),
                         mode="eval")
    except SyntaxError as e:
        raise ValueError(f"not a constant expression: {expr!r}") from e
    return int(ev(tree.body))


_SOURCES: Dict[Tuple[str, str], CuSource] = {}


def read_source(name: str, csrc_dir: Optional[Path] = None) -> CuSource:
    """Parse ``csrc/<name>.cu`` (``csrc_dir`` overrides the package's):
    its integer constants, and per ``__global__`` symbol its line,
    ``__launch_bounds__``, ``__shared__`` declarations and opt-in."""
    path = Path(csrc_dir or CSRC_DIR) / f"{name}.cu"
    raw = path.read_text()
    key = (str(path), raw)
    if key in _SOURCES:
        return _SOURCES[key]
    text = _blank_comments(raw)
    consts: Dict[str, int] = {}
    for m in re.finditer(
            r"\b(?:constexpr|const)\s+(?:int|int64_t|unsigned|size_t)\s+"
            r"(\w+)\s*=\s*([^;]+);", text):
        try:
            val = _eval_int(m.group(2), consts)
        except ValueError:
            continue  # a runtime value, not a constant
        if consts.get(m.group(1), val) != val:
            raise ValueError(f"csrc/{name}.cu: {m.group(1)} has two values")
        consts[m.group(1)] = val
    opt_in = set()
    funcs = _functions(text)
    for m in re.finditer(r"cudaFuncSetAttribute\s*\(\s*(\w+)", text):
        call = text[m.start():text.index(";", m.start())]
        if "cudaFuncAttributeMaxDynamicSharedMemorySize" not in call:
            continue
        opt_in.add(m.group(1))
        # Through a helper: the kernels its callers pass in that place.
        host = min((f for f in funcs if f[2] <= m.start() < f[3]),
                   key=lambda f: f[3] - f[2], default=None)
        if host is not None and m.group(1) in host[1]:
            at = host[1].index(m.group(1))
            for c in re.finditer(rf"\b{host[0]}\s*\(", text):
                args = _split_args(_parened(text, c.end() - 1)[1:-1])
                if len(args) > at:
                    opt_in.add(args[at].strip())
    kernels = {}
    for m in re.finditer(
            r"__global__\s+void\s+(?:__launch_bounds__\s*\(([^)]*)\)\s*)?"
            r"(\w+)\s*\(", text):
        symbol = m.group(2)
        bounds = (_eval_int(_split_args(m.group(1))[0], consts)
                  if m.group(1) else None)
        body = _braced(text, text.index("{", m.end()))
        shared = []
        for d in re.finditer(
                r"(extern\s+)?(?:volatile\s+)?__shared__\s+"
                r"(?:__align__\s*\(\s*\d+\s*\)\s+)?(?:volatile\s+)?"
                r"((?:unsigned\s+)?\w+)\s+(\w+)\s*((?:\[[^\]]*\])*)\s*;",
                body):
            dims = tuple(_eval_int(x, consts) for x in
                         re.findall(r"\[([^\]]*)\]", d.group(4)) if x.strip())
            shared.append(SharedDecl(d.group(3), d.group(2), dims,
                                     bool(d.group(1))))
        kernels[symbol] = CuKernel(
            symbol=symbol, line=text.count("\n", 0, m.start(2)) + 1,
            launch_bounds=bounds, shared=tuple(shared),
            opt_in=symbol in opt_in)
    src = CuSource(name=name, text=text, constants=consts, kernels=kernels)
    _SOURCES[key] = src
    return src


# ---------------------------------------------------------------------------
# Launch cases
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Operand:
    """A device buffer of a case. ``role``: "in", "out" (every element
    written exactly once over the case's launches), "scratch" (written,
    then read by a later work item: read exactly where written) or
    "counter" (ticket counters, updated atomically).
    ``align``: the byte alignment of its base that the wrapper
    guarantees (the caching allocator's 256 B for a fresh tensor).
    ``partition``: its reads must cover it exactly ``passes`` times
    (once, or once a column tile of K1w)."""

    dtype: str
    numel: int
    role: str = "in"
    align: int = 256
    partition: bool = False
    passes: int = 1

    @property
    def itemsize(self) -> int:
        return _DTYPE_BYTES[self.dtype]


@dataclasses.dataclass
class Access:
    """One launch's reads, writes or atomic updates of one operand:
    element intervals [lo, hi), one per CTA touch (or work item of a
    persistent kernel; an interval read by g of them appears g times).
    A ``gather`` reads data-dependent indices in
    [0, index_max]; it counts the operand's bytes once (the table the
    CTAs share through L2). ``vector_bytes``: the widest load or store
    the kernel issues on the operand (its base must be aligned to it)."""

    operand: str
    mode: str  # "read" | "write" | "atomic" | "gather"
    lo: Optional[np.ndarray] = None
    hi: Optional[np.ndarray] = None
    index_max: int = 0
    vector_bytes: int = 0


@dataclasses.dataclass
class Launch:
    """One ``__global__`` symbol at one geometry. ``block_const`` names
    the source constant the block size was read from (the constants test
    holds it against the launch site); ``instance`` is the template
    argument list as the demangled name spells it (for compile facts);
    ``tiles`` the per-CTA tile of each operand, where the kernel tiles."""

    source: str
    symbol: str
    instance: str
    entry: str
    grid: Tuple[int, int, int]
    block: int
    block_const: str
    dynamic_smem: int = 0
    accesses: List[Access] = dataclasses.field(default_factory=list)
    flops: float = 0.0
    tiles: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)

    @property
    def key(self) -> str:
        """The compile-fact key: ``symbol<instance>`` without spaces."""
        inst = f"<{self.instance}>" if self.instance else ""
        return re.sub(r"\s+", "", self.symbol + inst)


@dataclasses.dataclass
class KernelCase:
    """One wrapper call: its launches in order, the operands they share,
    the config dtypes, and the analytic {"flops", "bytes"} model (None
    skips PTK005). ``segments``: (seg_row_start, group_seg_start,
    row_group) of a segment plan, for the ownership clause of PTK003."""

    label: str
    config: Dict[str, str]
    operands: Dict[str, Operand]
    launches: List[Launch]
    cost_model: Optional[Dict[str, float]] = None
    segments: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None


def _cta_spans(total: int, per_cta: int) -> Tuple[np.ndarray, np.ndarray]:
    """[lo, hi) of each CTA over a flat range of ``total`` items cut
    ``per_cta`` a CTA."""
    lo = np.arange(0, total, per_cta, dtype=np.int64)
    return lo, np.minimum(lo + per_cta, total)


def _grid1(n: int) -> Tuple[int, int, int]:
    return (int(n), 1, 1)


def _ceil(a: int, b: int) -> int:
    return -(-int(a) // int(b))


# -- analytic cost models: the byte bounds PERF.md cites --------------------


def k1_cost(rows: int, n_state: int, num_blocks: int, num_segs: int,
            num_empty: int, z_item: int, columns: int = 1) -> Dict[str, float]:
    """K1's bound: the slot table once (rows x 128 int32), z and the
    output once (n_state and num_blocks x 128 elements of z's type) and
    the plan (seg_row_start, seg_block, block_seg_start and the empty
    blocks); one add a slot. With ``columns`` > 1, the bound of the
    ``columns``-wide SpMM over the same slots (the PPR path): the slots
    and the plan once, each column's z and output once, one add a slot
    a column."""
    plan = (num_segs + 1 + num_segs + num_blocks + 1 + num_empty) * 4
    per_column = n_state * z_item + num_blocks * LANES * z_item
    return {"flops": float(rows * LANES * columns),
            "bytes": float(rows * LANES * 4 + columns * per_column + plan)}


def k1w_cost(rows: int, n_state: int, num_blocks: int, num_segs: int,
             num_empty: int, z_item: int, columns: int, tiles: int = 1,
             partials: int = 0, fold: int = 0,
             acc_item: int = 4) -> Dict[str, float]:
    """What K1w (``csrc/ell_contrib_spmm.cu``) moves for a
    ``columns``-wide SpMM cut into ``tiles`` column tiles: the bound
    :func:`k1_cost` of that width, plus the slot table and the plan once
    more for each tile after the first, plus ``partials`` elements of
    ``acc_item`` bytes that the deep blocks' segments write and their
    finishers read back, plus the ``fold`` elements block 0's lanes are
    folded in (written once). At one tile, no partials and no fold it is
    the bound."""
    cost = k1_cost(rows, n_state, num_blocks, num_segs, num_empty, z_item,
                   columns)
    plan = (num_segs + 1 + num_segs + num_blocks + 1 + num_empty) * 4
    cost["bytes"] += ((tiles - 1) * (rows * LANES * 4 + plan)
                      + 2 * partials * acc_item + fold * acc_item)
    return cost


def k2_cost(rows: int, word_bytes: int, table_numel: int, table_item: int,
            num_pairs: int, num_segs: int, num_blocks: int, num_live: int,
            num_empty: int) -> Dict[str, float]:
    """K2's bound: the slot words once (``word_bytes`` a row: 384 for
    words24, 512 for int32), the windows once, the f32 block output, and
    the plan (seg_row_start, seg_pair, pair_seg_start, pair_part,
    pair_block, block_pair_start, the ``num_live`` block_pairs and the
    empty blocks); one add a slot, and one a lane of each pair that has
    rows (the block sums)."""
    plan = ((num_segs + 1) + num_segs + (num_pairs + 1) + 2 * num_pairs
            + (num_blocks + 1) + num_live + num_empty) * 4
    return {"flops": float((rows + num_live) * LANES),
            "bytes": float(rows * word_bytes + table_numel * table_item
                           + num_blocks * LANES * 4 + plan)}


def probe_cost(rows: int, n: int, item: int) -> Dict[str, float]:
    """P1-P3's bound: src (4 B), w and out (itemsize each) once per
    slot, z once; one multiply a slot."""
    return {"flops": float(rows * LANES),
            "bytes": float(rows * LANES * (4 + 2 * item) + n * item)}


# -- K1 and K2: one persistent launch ------------------------------------------


def head_capacity(src: CuSource, symbol: str, item: int,
                  device_kind: Optional[str] = None) -> int:
    """The head (table elements of ``item`` bytes) a CTA of ``symbol``
    can stage: the block's shared memory less the symbol's static
    shared bytes, whole 16-byte vectors."""
    free = (costs.device_spec(device_kind).smem_per_block
            - src.kernels[symbol].static_smem)
    return free // 16 * 16 // item


def _persistent_grid(items: int, device_kind: Optional[str]) -> int:
    """The wrapper's grid (``ops/ell_spmv.py:persistent_grid``)."""
    from pagerank_tpu_torch.ops.ell_spmv import persistent_grid

    return persistent_grid(items, device_kind)


def _runs(starts, stops):
    """The concatenated ranges [starts[i], stops[i])."""
    n = np.maximum(stops - starts, 0)
    return (np.repeat(starts, n) + np.arange(int(n.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(n) - n, n))


def _rows_of(idx, width: int = LANES):
    """Element intervals of the ``width``-wide (default 128) rows
    ``idx``."""
    idx = np.asarray(idx, np.int64)
    return idx * width, idx * width + width


def _finishers(gss, group_of_seg, chunk: int, counter: str, active=None,
               width: int = LANES):
    """The finishers' accesses of groups (blocks or pairs) cut into
    segments [gss[g], gss[g+1]) (``ell_persistent.cuh:finish_group``):
    a segment of a group of 2+ writes its partial; a group of up to
    ``chunk`` segments draws tickets on ``counter`` and its finisher
    reads the partials; a deeper group's chunks of ``chunk`` segments
    draw tickets on chunk_counter (at their first segment), each chunk's
    finisher reads the chunk's partials and writes chunk_sum at its
    first segment, and the chunks draw tickets on ``counter`` for the
    finisher that reads the chunk sums. Every counter is reset by its
    finisher. Only the ``active`` groups (default all) are finished so:
    the others are summed whole by one lane group. ``width``: the
    elements of a partial row (128 lanes, x the columns of a K1w tile).
    Returns (accesses, adds, finished groups of 2+ segments)."""
    nseg = np.maximum(gss[1:] - gss[:-1], 0)
    if active is not None:
        nseg = np.where(active, nseg, 0)
    seg = np.arange(len(group_of_seg), dtype=np.int64)
    multi = nseg[group_of_seg] > 1
    deep = nseg[group_of_seg] > chunk
    shallow_g = np.flatnonzero((nseg > 1) & (nseg <= chunk))
    deep_g = np.flatnonzero(nseg > chunk)
    nch = -(-nseg[deep_g] // chunk)  # chunks of each deep group
    ordinal = (np.arange(int(nch.sum()), dtype=np.int64)
               - np.repeat(np.cumsum(nch) - nch, nch))
    c0 = np.repeat(gss[deep_g], nch) + ordinal * chunk  # first segments
    c1 = np.minimum(c0 + chunk, np.repeat(gss[deep_g + 1], nch))
    chunk_of = (gss[group_of_seg] + (seg - gss[group_of_seg]) // chunk
                * chunk)[deep]
    lanes = width
    accesses = [
        Access("partial", "write", *_rows_of(seg[multi], width)),
        Access("partial", "read", gss[shallow_g] * lanes,
               gss[shallow_g + 1] * lanes),
        Access("partial", "read", c0 * lanes, c1 * lanes),
        Access("chunk_sum", "write", *_rows_of(c0, width)),
        Access("chunk_sum", "read", *_rows_of(c0, width)),
        Access(counter, "atomic", group_of_seg[multi & ~deep],
               group_of_seg[multi & ~deep] + 1),
        Access(counter, "atomic", shallow_g, shallow_g + 1),  # the reset
        Access("chunk_counter", "atomic", chunk_of, chunk_of + 1),
        Access("chunk_counter", "atomic", c0, c0 + 1),  # the reset
        Access(counter, "atomic", np.repeat(deep_g, nch),
               np.repeat(deep_g, nch) + 1),
        Access(counter, "atomic", deep_g, deep_g + 1),  # the reset
    ]
    adds = (nseg[shallow_g].sum() + nseg[deep_g].sum() + len(c0)) * lanes
    return accesses, float(adds), np.flatnonzero(nseg > 1)




def _items(item_start, item_segs, num_split, groups_segs, seg_row_start):
    """The work items of a case: the given table, or ``ops/ell.py:
    work_items`` over ``groups_segs`` (each non-empty group's segments
    in sum order) at the default segment length. Returns (item_start,
    item_segs, num_split) as int64 arrays and an int."""
    if item_start is None:
        from pagerank_tpu_torch.ops.ell import SEG_ROWS, WHOLE, work_items

        it = work_items(groups_segs, seg_row_start, WHOLE * SEG_ROWS)
        item_start, item_segs, num_split = (it["item_start"],
                                            it["item_segs"], it["num_split"])
    return (np.asarray(item_start, np.int64), np.asarray(item_segs, np.int64),
            int(num_split))


def _item_reads(ist):
    """The work items' table reads: each item reads its two bounds and
    its segment ids."""
    it = np.arange(len(ist) - 1, dtype=np.int64)
    return [Access("item_start", "read", it, it + 2),
            Access("item_segs", "read", ist[:-1], ist[1:])]


_K1_INSTANCE = {"float32": "float", "float64": "double"}


def k1_case(label: str, *, seg_row_start, block_seg_start, row_block,
            n_state: int, seg_block=None, item_start=None, item_segs=None,
            num_split: Optional[int] = None, z_dtype: str = "float32",
            accum_dtype: str = "float32", src_max: Optional[int] = None,
            head: Optional[int] = None, device_kind: Optional[str] = None,
            csrc_dir=None) -> KernelCase:
    """K1 (``csrc/ell_contrib.cu``) on a segment plan: one persistent
    launch of ``ell_contrib_kernel``, the wrapper's grid, the block and
    the dynamic shared bytes (the head) from the source. Each
    interval is one lane group's work item (the plan's, by default
    ``ops/ell.py:work_items`` of the blocks): a whole block (its
    segments' rows, its block), one segment of a deep block (its rows,
    its partial), a finisher (the block's partials or chunk sums, its
    counters, its block; see :func:`_finishers`) or an empty block.
    ``seg_block`` defaults to the blocks ``block_seg_start`` gives;
    ``src_max``: the largest slot index (the sentinel n_state when
    None); ``head``: default the most that fits."""
    src = read_source("ell_contrib", csrc_dir)
    symbol = "ell_contrib_kernel"
    lanes, threads = src.const("kLanes"), src.const("kThreads")
    rs = np.asarray(seg_row_start, np.int64)
    bss = np.asarray(block_seg_start, np.int64)
    num_segs, nb = len(rs) - 1, len(bss) - 1
    nseg = np.maximum(bss[1:] - bss[:-1], 0)
    sb = (np.repeat(np.arange(nb, dtype=np.int64), nseg) if seg_block is None
          else np.asarray(seg_block, np.int64))
    ist, isegs, num_split = _items(
        item_start, item_segs, num_split,
        [np.arange(bss[b], bss[b + 1]) for b in np.flatnonzero(nseg)], rs)
    rows = int(np.asarray(row_block).shape[0])
    z_item = _DTYPE_BYTES[z_dtype]
    if head is None:
        head = min(head_capacity(src, symbol, z_item, device_kind), n_state)
    empty = np.flatnonzero(nseg == 0)
    split = np.zeros(nb, bool)
    split[sb[isegs[:num_split]]] = True
    fin_acc, fin_adds, fin = _finishers(bss, sb, src.const("kChunk"),
                                        "counter", active=split)
    item_acc = _item_reads(ist)
    whole_first = isegs[ist[num_split:-1]]  # each whole item's first segment
    r1 = np.maximum(rs[1:], rs[:-1])  # the loop reads nothing past r1
    short = {"float32": "f32", "float64": "f64"}
    ops = {
        "z_ext": Operand(z_dtype, n_state + 8),
        "src": Operand("int32", rows * lanes, partition=True),
        "seg_row_start": Operand("int32", num_segs + 1),
        "seg_block": Operand("int32", num_segs),
        "block_seg_start": Operand("int32", nb + 1),
        "item_start": Operand("int32", len(ist)),
        "item_segs": Operand("int32", len(isegs)),
        "empty_blocks": Operand("int32", len(empty)),
        "partial": Operand(accum_dtype, num_segs * lanes, role="scratch"),
        "chunk_sum": Operand(accum_dtype, num_segs * lanes, role="scratch"),
        "counter": Operand("int32", nb, role="counter"),
        "chunk_counter": Operand("int32", num_segs, role="counter"),
        "out": Operand(z_dtype, nb * lanes, role="out"),
    }
    written = np.concatenate([sb[whole_first], fin, empty])
    e = np.arange(len(empty), dtype=np.int64)
    ssplit = isegs[:num_split]
    launch = Launch(
        source="ell_contrib", symbol=symbol,
        instance=f"{_K1_INSTANCE[z_dtype]},{_K1_INSTANCE[accum_dtype]}",
        entry=f"ell_contrib_{short[z_dtype]}_{short[accum_dtype]}",
        grid=_grid1(_persistent_grid(len(ist) - 1 + len(empty), device_kind)),
        block=threads, block_const="kThreads",
        dynamic_smem=_ceil(head * z_item, 16) * 16,
        flops=float(((r1 - rs[:-1])[isegs].sum() + len(isegs)) * lanes)
        + fin_adds,
        accesses=[
            Access("src", "read", rs[isegs] * lanes, r1[isegs] * lanes),
            Access("z_ext", "gather",
                   index_max=max(n_state if src_max is None else int(src_max),
                                 head - 1), vector_bytes=16),
            *item_acc,
            Access("seg_row_start", "read", isegs, isegs + 2),
            Access("seg_block", "read", isegs[ist[:-1]], isegs[ist[:-1]] + 1),
            Access("block_seg_start", "read", sb[ssplit], sb[ssplit] + 2),
            Access("empty_blocks", "read", e, e + 1),
            *fin_acc,
            Access("out", "write", *_rows_of(written)),
        ])
    return KernelCase(
        label=label, config={"z": z_dtype, "accum": accum_dtype},
        operands=ops, launches=[launch],
        cost_model=k1_cost(rows, n_state, nb, num_segs, len(empty), z_item),
        segments=(rs, bss, np.asarray(row_block, np.int64)))


def _shifted(accesses, offsets):
    """The accesses with each interval of operand ``name`` moved by
    ``offsets[name]`` elements (one tile's share of a K1w workspace)."""
    return [dataclasses.replace(a, lo=a.lo + offsets[a.operand],
                                hi=a.hi + offsets[a.operand])
            for a in accesses]


def k1w_case(label: str, *, seg_row_start, block_seg_start, row_block,
             n_state: int, k: int, kt: Optional[int] = None, seg_block=None,
             item_start=None, item_segs=None, num_split: Optional[int] = None,
             z_dtype: str = "float32", accum_dtype: str = "float32",
             src_max: Optional[int] = None,
             seg_stride: Optional[int] = None,
             device_kind: Optional[str] = None, csrc_dir=None) -> KernelCase:
    """K1w (``csrc/ell_contrib_spmm.cu``) on a segment plan over ``k``
    live columns: one persistent launch of ``ell_contrib_spmm_kernel``
    at the tile ``ops/ell_spmm.py:tile_width(k, kt)`` picks (``kt``
    default the engine's, ``default_tile``), the wrapper's grid and the block from the
    source. Each tile runs K1's work items (see :func:`k1_case`)
    over its columns: the slot rows once a tile (``src`` is partitioned
    once per tile), the tile's partials, chunk sums and counters in the
    tile's share of the workspace (``seg_stride`` segments a tile,
    default ``ops/ell_spmm.py:split_extent``). ``out`` [blocks x 128,
    kp] is modelled in tile-major element order, a bijection of its
    elements: tile t's columns of row r at t x tw x rows + r x w_t (w_t
    the tile's live columns rounded up to whole vectors), so one block's
    write in a tile is one interval; ``fold`` [128, kp] (block 0's lanes
    folded, written by the lane group that finishes block 0) likewise,
    one interval a tile. The analytic model is :func:`k1w_cost` at kp
    columns, the case's tiles, its partials (each split segment's
    tile-wide row, once a tile) and the fold."""
    import torch

    from pagerank_tpu_torch.ops import ell_spmm

    src = read_source("ell_contrib_spmm", csrc_dir)
    symbol = "ell_contrib_spmm_kernel"
    lanes, threads = src.const("kLanes"), src.const("kThreads")
    z_item = _DTYPE_BYTES[z_dtype]
    vec = src.const("kVecBytes") // z_item
    if kt is None:
        kt = ell_spmm.default_tile(getattr(torch, accum_dtype))
    tw = ell_spmm.tile_width(k, kt)
    kp = _ceil(k, vec) * vec
    tiles = _ceil(k, tw)
    tpl = min(tw // vec, threads // lanes)
    groups = threads // (lanes * tpl)
    rs = np.asarray(seg_row_start, np.int64)
    bss = np.asarray(block_seg_start, np.int64)
    num_segs, nb = len(rs) - 1, len(bss) - 1
    nseg = np.maximum(bss[1:] - bss[:-1], 0)
    sb = (np.repeat(np.arange(nb, dtype=np.int64), nseg) if seg_block is None
          else np.asarray(seg_block, np.int64))
    ist, isegs, num_split = _items(
        item_start, item_segs, num_split,
        [np.arange(bss[b], bss[b + 1]) for b in np.flatnonzero(nseg)], rs)
    if seg_stride is None:
        seg_stride = int(isegs[:num_split].max()) + 1 if num_split else 0
    rows = int(np.asarray(row_block).shape[0])
    empty = np.flatnonzero(nseg == 0)
    split = np.zeros(nb, bool)
    split[sb[isegs[:num_split]]] = True
    whole_first = isegs[ist[num_split:-1]]
    r1 = np.maximum(rs[1:], rs[:-1])
    e = np.arange(len(empty), dtype=np.int64)
    ssplit = isegs[:num_split]
    width = lanes * tw
    accesses, flops = [], 0.0
    written = None
    for t in range(tiles):
        live = min(kp - t * tw, tw)  # the tile's columns, whole vectors
        fin_acc, fin_adds, fin = _finishers(bss, sb, src.const("kChunk"),
                                            "counter", active=split,
                                            width=width)
        accesses += _shifted(fin_acc, {
            "partial": t * seg_stride * width,
            "chunk_sum": t * seg_stride * width,
            "counter": t * nb, "chunk_counter": t * seg_stride})
        written = np.concatenate([sb[whole_first], fin, empty])
        base = t * tw * nb * lanes
        accesses += [
            Access("src", "read", rs[isegs] * lanes, r1[isegs] * lanes),
            *_item_reads(ist),
            Access("seg_row_start", "read", isegs, isegs + 2),
            Access("seg_block", "read", isegs[ist[:-1]],
                   isegs[ist[:-1]] + 1),
            Access("block_seg_start", "read", sb[ssplit], sb[ssplit] + 2),
            Access("empty_blocks", "read", e, e + 1),
            Access("out", "write", base + written * lanes * live,
                   base + (written + 1) * lanes * live),
            Access("fold", "write", np.array([t * tw * lanes]),
                   np.array([t * tw * lanes + lanes * live])),
        ]
        # one add a slot a live column, one a segment (its sum into the
        # block's), and the finishers' (counted over the whole tile)
        flops += float(((r1 - rs[:-1])[isegs].sum() + len(isegs)) * lanes
                       * live) + fin_adds * live / tw
    smax = n_state if src_max is None else int(src_max)
    accesses.append(Access("z2", "gather", index_max=(smax + 1) * kp - 1,
                           vector_bytes=src.const("kVecBytes")))
    short = {"float32": "f32", "float64": "f64"}
    work = seg_stride * lanes * tiles * tw
    ops = {
        "z2": Operand(z_dtype, (n_state + 8) * kp),
        "src": Operand("int32", rows * lanes, partition=True, passes=tiles),
        "seg_row_start": Operand("int32", num_segs + 1),
        "seg_block": Operand("int32", num_segs),
        "block_seg_start": Operand("int32", nb + 1),
        "item_start": Operand("int32", len(ist)),
        "item_segs": Operand("int32", len(isegs)),
        "empty_blocks": Operand("int32", len(empty)),
        "partial": Operand(accum_dtype, work, role="scratch"),
        "chunk_sum": Operand(accum_dtype, work, role="scratch"),
        "counter": Operand("int32", tiles * nb, role="counter"),
        "chunk_counter": Operand("int32", tiles * seg_stride,
                                 role="counter"),
        "out": Operand(z_dtype, nb * lanes * kp, role="out"),
        "fold": Operand(accum_dtype, lanes * kp, role="out"),
    }
    grid = max(1, min(costs.device_spec(device_kind).sms,
                      _ceil((len(ist) - 1 + len(empty)) * tiles, groups)))
    launch = Launch(
        source="ell_contrib_spmm", symbol=symbol,
        instance=f"{_K1_INSTANCE[z_dtype]},{_K1_INSTANCE[accum_dtype]},{tw}",
        entry=f"ell_contrib_spmm_{short[z_dtype]}_{short[accum_dtype]}_kt{tw}",
        grid=_grid1(grid), block=threads, block_const="kThreads",
        flops=flops, accesses=accesses)
    return KernelCase(
        label=label, config={"z": z_dtype, "accum": accum_dtype},
        operands=ops, launches=[launch],
        cost_model=k1w_cost(rows, n_state, nb, num_segs, len(empty), z_item,
                            kp, tiles, partials=num_split * width * tiles,
                            fold=lanes * kp,
                            acc_item=_DTYPE_BYTES[accum_dtype]),
        segments=(rs, bss, np.asarray(row_block, np.int64)))


def k2_case(label: str, *, seg_row_start, seg_pair, pair_seg_start,
            row_pair, pair_part, pair_block, num_blocks: int,
            num_windows: int, window: int, item_start=None, item_segs=None,
            num_split: Optional[int] = None, table_dtype: str = "float32",
            words24: bool = True, gather_max: Optional[int] = None,
            sentinel: Optional[int] = None, head: Optional[int] = None,
            device_kind: Optional[str] = None, csrc_dir=None) -> KernelCase:
    """K2 (``csrc/ell_contrib_partitioned.cu``) on a pair plan: one
    persistent launch of ``ell_contrib_part_kernel``. A lane group's
    work item (the plan's, by default ``ops/ell.py:work_items`` of the
    blocks' pairs) is a whole block (the rows of its pairs' segments,
    its block), or one segment of a split block (its rows, its partial
    or its pair), a pair finisher (the pair's partials or chunk sums, its
    counters; see :func:`_finishers`), a pair's hand-off (its pair sum
    and block ticket, or its block), a block finisher (the block's pair
    sums in partition order, its counter, its block); or an empty block.
    ``gather_max``: the largest flat window index a slot reads (the last
    window's sentinel when None); ``sentinel``: the local sentinel
    (default ``window - 128``)."""
    src = read_source("ell_contrib_partitioned", csrc_dir)
    symbol = "ell_contrib_part_kernel"
    lanes, threads = src.const("kLanes"), src.const("kThreads")
    rs = np.asarray(seg_row_start, np.int64)
    sp = np.asarray(seg_pair, np.int64)
    pss = np.asarray(pair_seg_start, np.int64)
    pb = np.asarray(pair_block, np.int64)
    num_segs, npairs, nb = len(rs) - 1, len(pss) - 1, int(num_blocks)
    rows = int(np.asarray(row_pair).shape[0])
    row_elems, wdt = (3 * lanes, "int8") if words24 else (lanes, "int32")
    t_item = _DTYPE_BYTES[table_dtype]
    sentinel = window - lanes if sentinel is None else int(sentinel)
    if head is None:
        head = min(head_capacity(src, symbol, t_item, device_kind), sentinel)
    nseg = np.maximum(pss[1:] - pss[:-1], 0)  # per pair
    live = np.flatnonzero(nseg > 0)
    per_block = np.bincount(pb[live], minlength=nb)
    bps = np.concatenate([[0], np.cumsum(per_block)])
    block_pairs = live[np.argsort(pb[live], kind="stable")]
    empty = np.flatnonzero(per_block == 0)
    ist, isegs, num_split = _items(
        item_start, item_segs, num_split,
        [np.concatenate([np.arange(pss[p], pss[p + 1])
                         for p in block_pairs[bps[b]:bps[b + 1]]])
         for b in np.flatnonzero(per_block)], rs)
    ssplit = isegs[:num_split]
    split_b = np.zeros(nb, bool)
    split_b[pb[sp[ssplit]]] = True
    fin_acc, fin_adds, _ = _finishers(pss, sp, src.const("kChunk"),
                                      "pair_counter", active=split_b[pb])
    item_acc = _item_reads(ist)
    lp = live[split_b[pb[live]]]  # the split blocks' pairs with rows
    bfin = np.flatnonzero(split_b & (per_block > 1))  # blocks a finisher sums
    shared = lp[per_block[pb[lp]] > 1]  # pairs that hand a pair sum on
    handed = _runs(bps[bfin], bps[bfin + 1])  # block_pairs entries read
    whole_last = sp[isegs[ist[num_split + 1:] - 1]]  # a whole item's last pair
    r1 = np.maximum(rs[1:], rs[:-1])
    inst = ("unsigned short" if table_dtype == "bfloat16" else "float") \
        + f",{'true' if words24 else 'false'}"
    entry = ("ell_contrib_part_" + ("bf16" if table_dtype == "bfloat16"
                                    else "f32")
             + ("_w24" if words24 else "_w32"))
    ops = {
        "z_windows": Operand(table_dtype, num_windows * window),
        "src": Operand(wdt, rows * row_elems, partition=True),
        "seg_row_start": Operand("int32", num_segs + 1),
        "seg_pair": Operand("int32", num_segs),
        "pair_seg_start": Operand("int32", npairs + 1),
        "pair_part": Operand("int32", npairs),
        "pair_block": Operand("int32", npairs),
        "block_pair_start": Operand("int32", nb + 1),
        "block_pairs": Operand("int32", len(block_pairs)),
        "item_start": Operand("int32", len(ist)),
        "item_segs": Operand("int32", len(isegs)),
        "empty_blocks": Operand("int32", len(empty)),
        "partial": Operand("float32", num_segs * lanes, role="scratch"),
        "chunk_sum": Operand("float32", num_segs * lanes, role="scratch"),
        "pair_sum": Operand("float32", npairs * lanes, role="scratch"),
        "pair_counter": Operand("int32", npairs, role="counter"),
        "block_counter": Operand("int32", nb, role="counter"),
        "chunk_counter": Operand("int32", num_segs, role="counter"),
        "out": Operand("float32", nb * lanes, role="out"),
    }
    written = np.concatenate([pb[whole_last],
                              pb[lp[per_block[pb[lp]] == 1]], bfin, empty])
    e = np.arange(len(empty), dtype=np.int64)
    launch = Launch(
        source="ell_contrib_partitioned", symbol=symbol, instance=inst,
        entry=entry,
        grid=_grid1(_persistent_grid(len(ist) - 1 + len(empty), device_kind)),
        block=threads, block_const="kThreads",
        dynamic_smem=_ceil(head * t_item, 16) * 16,
        flops=float(((r1 - rs[:-1])[isegs].sum() + len(isegs)
                     + per_block[bfin].sum()) * lanes) + fin_adds,
        accesses=[
            Access("src", "read", rs[isegs] * row_elems,
                   r1[isegs] * row_elems),
            Access("z_windows", "gather",
                   index_max=max((num_windows - 1) * window + sentinel
                                 if gather_max is None else int(gather_max),
                                 head - 1), vector_bytes=16),
            *item_acc,
            Access("seg_row_start", "read", isegs, isegs + 2),
            Access("seg_pair", "read", isegs, isegs + 1),
            Access("pair_part", "read", sp[isegs], sp[isegs] + 1),
            Access("pair_seg_start", "read", sp[ssplit], sp[ssplit] + 2),
            *fin_acc,
            Access("pair_block", "read", whole_last, whole_last + 1),
            Access("pair_block", "read", lp, lp + 1),
            Access("block_pair_start", "read", pb[lp], pb[lp] + 2),
            Access("pair_sum", "write", *_rows_of(shared)),
            Access("block_counter", "atomic", pb[shared], pb[shared] + 1),
            Access("block_pairs", "read", bps[bfin], bps[bfin + 1]),
            Access("pair_sum", "read", *_rows_of(block_pairs[handed])),
            Access("block_counter", "atomic", bfin, bfin + 1),  # the reset
            Access("empty_blocks", "read", e, e + 1),
            Access("out", "write", *_rows_of(written)),
        ])
    return KernelCase(
        label=label,
        config={"table": table_dtype, "sum": "float32",
                "words": "words24" if words24 else "int32"},
        operands=ops, launches=[launch],
        cost_model=k2_cost(rows, row_elems * _DTYPE_BYTES[wdt],
                           num_windows * window, t_item, npairs, num_segs,
                           nb, len(live), len(empty)),
        segments=(rs, pss, np.asarray(row_pair, np.int64)))


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else \
        np.asarray(t)


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def k1_case_from_inputs(label: str, z_ext, src, row_block, num_blocks,
                        plan, *, accum_dtype: str = "float32",
                        head: Optional[int] = None,
                        device_kind: Optional[str] = None,
                        csrc_dir=None) -> KernelCase:
    """K1's case on the tensors a path feeds it (``TorchEngine.
    contrib_inputs()`` of the flat form), the largest slot index read
    from the slots."""
    if int(num_blocks) + 1 != len(plan.block_seg_start):
        raise ValueError("the plan does not fit num_blocks")
    return k1_case(label, seg_row_start=_np(plan.seg_row_start),
                   block_seg_start=_np(plan.block_seg_start),
                   seg_block=_np(plan.seg_block),
                   item_start=_np(plan.item_start),
                   item_segs=_np(plan.item_segs), num_split=plan.num_split,
                   row_block=_np(row_block), n_state=int(z_ext.shape[0]) - 8,
                   z_dtype=_dtype_name(z_ext), accum_dtype=accum_dtype,
                   src_max=int(src.max()) if src.numel() else 0, head=head, device_kind=device_kind, csrc_dir=csrc_dir)


def k2_case_from_inputs(label: str, z_windows, src, row_pair, pair_part,
                        num_pairs, plan, *, head: Optional[int] = None,
                        device_kind: Optional[str] = None,
                        csrc_dir=None) -> KernelCase:
    """K2's case on the tensors a path feeds it (``TorchEngine.
    contrib_inputs()`` of the partitioned form, its plan a ``PairPlan``):
    the largest flat window index from the words and each row's
    partition."""
    import torch

    from pagerank_tpu_torch.ops.spmv import unpack_words24

    words24 = src.dtype == torch.int8
    words = unpack_words24(src) if words24 else src
    base = pair_part.long()[row_pair.long()] * z_windows.shape[1]
    gmax = int((base + words.long().max(dim=1).values).max()) \
        if words.numel() else 0
    if int(num_pairs) != pair_part.shape[0]:
        raise ValueError("pair_part does not fit num_pairs")
    return k2_case(label, seg_row_start=_np(plan.seg_row_start),
                   seg_pair=_np(plan.seg_block),
                   pair_seg_start=_np(plan.block_seg_start),
                   row_pair=_np(row_pair), pair_part=_np(pair_part),
                   pair_block=_np(plan.pair_block),
                   num_blocks=plan.num_blocks,
                   item_start=_np(plan.item_start),
                   item_segs=_np(plan.item_segs), num_split=plan.num_split,
                   num_windows=int(z_windows.shape[0]),
                   window=int(z_windows.shape[1]),
                   table_dtype=_dtype_name(z_windows), words24=words24,
                   gather_max=gmax, sentinel=plan.sentinel, head=head, device_kind=device_kind, csrc_dir=csrc_dir)


# -- P1-P3 ---------------------------------------------------------------------


#: Probe wrapper -> its kernel symbol.
PROBE_SYMBOLS = {"gather_take": "probe_take",
                 "gather_group8": "probe_group8",
                 "gather_rowsel": "probe_rowsel_smem"}


def probe_case(wrapper: str, label: str, *, rows: int, n: int,
               dtype: str = "float32", z_align: int = 256,
               device_kind: Optional[str] = None,
               csrc_dir=None) -> KernelCase:
    """P1-P3 (``csrc/gather_probe.cu``) at ``rows`` x 128 slots and z
    [n]: P1 and P2 one thread per slot quad; P3 one persistent CTA per
    SM, each staging the whole of z in dynamic shared memory, walking
    the quads grid-stride."""
    src = read_source("gather_probe", csrc_dir)
    symbol = PROBE_SYMBOLS[wrapper]
    spt = src.const("kSlotsPerThread")
    item = _DTYPE_BYTES[dtype]
    quads = rows * src.const("kQuadsPerRow")
    ops = {"z": Operand(dtype, n, align=z_align),
           "src": Operand("int32", rows * LANES),
           "w": Operand(dtype, rows * LANES),
           "out": Operand(dtype, rows * LANES, role="out")}
    vec = {"src": 16, "w": spt * item, "out": spt * item}
    if wrapper == "gather_rowsel":
        block, block_const = src.const("kSmemThreads"), "kSmemThreads"
        grid = min(_ceil(quads, block), costs.device_spec(device_kind).sms)
        stride = grid * block
        # CTA c takes quads [c*block + k*stride, +block) for k = 0, 1, ...
        starts = (np.arange(0, quads, stride, dtype=np.int64)[:, None]
                  + np.arange(grid, dtype=np.int64)[None, :] * block)
        lo = starts[starts < quads].reshape(-1)
        q_lo, q_hi = lo, np.minimum(lo + block, quads)
        dynamic = _ceil(n * item, 16) * 16
        z_acc = Access("z", "read", np.zeros(grid, np.int64),
                       np.full(grid, n, np.int64))
    else:
        block, block_const = src.const("kThreads"), "kThreads"
        grid = _ceil(quads, block)
        q_lo, q_hi = _cta_spans(quads, block)
        dynamic = 0
        z_acc = Access("z", "gather", index_max=n - 1,
                       vector_bytes=8 * item if wrapper == "gather_group8"
                       else 0)
    accesses = [z_acc] + [
        Access(name, "write" if name == "out" else "read", q_lo * spt,
               q_hi * spt, vector_bytes=vec[name])
        for name in ("src", "w", "out")]
    d_inst = {"float32": "F32", "bfloat16": "BF16"}[dtype]
    launch = Launch(
        source="gather_probe", symbol=symbol, instance=d_inst,
        entry=f"{wrapper}_{'f32' if dtype == 'float32' else 'bf16'}",
        grid=_grid1(grid), block=block, block_const=block_const,
        dynamic_smem=dynamic, accesses=accesses, flops=float(quads * spt))
    return KernelCase(label=label, config={"z": dtype}, operands=ops,
                      launches=[launch],
                      cost_model=probe_cost(rows, n, item))


# -- the shipped registry --------------------------------------------------------


#: The JAX campaign's bench scales (``pagerank_tpu/analysis/kernels.py:
#: BENCH_SCALES``), R-MAT edge factor 16.
def k1w_case_from_inputs(label: str, z2, src, row_block, num_blocks, plan,
                         *, k: int, kt: Optional[int] = None,
                         accum_dtype: str = "float32",
                         device_kind: Optional[str] = None,
                         csrc_dir=None) -> KernelCase:
    """K1w's case on the tensors a path feeds it (``PprTorchEngine``'s
    z2, slots, row blocks and plan) at ``k`` live columns, the largest
    slot index read from the slots."""
    if int(num_blocks) + 1 != len(plan.block_seg_start):
        raise ValueError("the plan does not fit num_blocks")
    return k1w_case(label, seg_row_start=_np(plan.seg_row_start),
                    block_seg_start=_np(plan.block_seg_start),
                    seg_block=_np(plan.seg_block),
                    item_start=_np(plan.item_start),
                    item_segs=_np(plan.item_segs), num_split=plan.num_split,
                    row_block=_np(row_block), n_state=int(z2.shape[0]) - 8,
                    k=k, kt=kt, z_dtype=_dtype_name(z2),
                    accum_dtype=accum_dtype,
                    src_max=int(src.max()) if src.numel() else 0,
                    device_kind=device_kind, csrc_dir=csrc_dir)


BENCH_SCALES = (22, 23, 24, 25)
EDGE_FACTOR = 16
#: The R-MAT scale of the PPR path's launches (BASELINE.md:154-160).
PPR_SCALE = 20
#: The probe's rows (the rmat:22 slot count at 2^19 x 128).
PROBE_ROWS = 1 << 19


def _synth_ranks(rows: int, groups: int) -> np.ndarray:
    """Ascending group ids spread evenly over ``rows`` (increment <= 1
    per row): the dense-rank invariant at synthetic fidelity, as
    ``pagerank_tpu/analysis/kernels.py:_synth_ranks``."""
    return ((np.arange(rows, dtype=np.int64) * groups) // rows).astype(
        np.int32)


def _synth_k1(label, scale=None, *, n_pad=None, rows=None, **kw):
    from pagerank_tpu_torch.ops.ell import segment_plan

    n_pad = n_pad or 1 << scale
    rows = rows or EDGE_FACTOR * n_pad // LANES
    nb = n_pad // LANES
    rb = _synth_ranks(rows, nb)
    plan = segment_plan(rb, nb)
    return k1_case(label, seg_row_start=plan.seg_row_start,
                   block_seg_start=plan.block_seg_start,
                   seg_block=plan.seg_block, row_block=rb, n_state=n_pad,
                   **kw)


def _synth_k1_rank(label, scale, world, *, bounded, **kw):
    """K1 at one rank's geometry of a vertex-sharded form at ``world``
    ranks. vs_halo (and the dense form): the last rank's share of the
    whole table's rows — a share that starts inside a block — over every
    block, z the rank's image of n_pad entries. vs_bounded: the rank's
    own rows renumbered to its nbd = n_pad / 128 / world local blocks,
    then inert rows up to a multiple of 256 writing one trash block
    (local block nbd), z the whole gathered vector."""
    from pagerank_tpu_torch.ops.ell import segment_plan

    n_pad = 1 << scale
    rows = EDGE_FACTOR * n_pad // LANES
    nb = n_pad // LANES
    if bounded:
        nbd = nb // world
        real = rows // world - 100
        rb = np.concatenate([_synth_ranks(real, nbd),
                             np.full(_ceil(real, 256) * 256 - real, nbd,
                                     np.int32)])
        nb = nbd + 1
    else:
        rb = _synth_ranks(rows + 100, nb)[-(rows // world):]
    plan = segment_plan(rb, nb)
    return k1_case(label, seg_row_start=plan.seg_row_start,
                   block_seg_start=plan.block_seg_start,
                   seg_block=plan.seg_block, row_block=rb, n_state=n_pad,
                   **kw)


def _synth_k1w(label, scale=None, *, n_pad=None, rows=None, **kw):
    from pagerank_tpu_torch.ops.ell import segment_plan

    n_pad = n_pad or 1 << scale
    rows = rows or EDGE_FACTOR * n_pad // LANES
    nb = n_pad // LANES
    rb = _synth_ranks(rows, nb)
    plan = segment_plan(rb, nb)
    return k1w_case(label, seg_row_start=plan.seg_row_start,
                    block_seg_start=plan.block_seg_start,
                    seg_block=plan.seg_block, row_block=rb, n_state=n_pad,
                    **kw)


def campaign_span(n_pad: int, edges: int, item: int) -> int:
    """The partition span a campaign case pins: the port's auto rule
    (``TorchEngine.partition_span``), else — where the rule turns the
    form off for a window past its 12 MB cap — the largest power-of-two
    span under that cap with at least two partitions (the JAX
    registry's fallback, ``pagerank_tpu/analysis/kernels.py:197-224``,
    with the port's window cap in place of the VMEM budget)."""
    from pagerank_tpu_torch.engines.torch_engine import TorchEngine

    span = TorchEngine.partition_span(n_pad, edges, item)
    if span:
        return span
    span = 1 << 15
    while span * 2 * item <= TorchEngine.PART_MAX_WINDOW_BYTES \
            and span * 4 <= n_pad:
        span *= 2
    return span


def _synth_k2(label, scale, table_dtype="float32", words=None, **kw):
    from pagerank_tpu_torch.engines.torch_engine import TorchEngine
    from pagerank_tpu_torch.ops.ell import segment_plan

    n_pad = 1 << scale
    item = _DTYPE_BYTES[table_dtype]
    psz = campaign_span(n_pad, EDGE_FACTOR * n_pad, item)
    K = _ceil(n_pad, psz)
    nb = n_pad // LANES
    rows_per_part = EDGE_FACTOR * n_pad // LANES // K
    # About 16 slot rows a pair, at most every block in every partition;
    # a partition's pairs spread evenly over the blocks.
    per_part = max(1, min(nb, rows_per_part // 16))
    row_pair = np.concatenate([
        k * per_part + _synth_ranks(rows_per_part, per_part)
        for k in range(K)]).astype(np.int32)
    npairs = K * per_part
    plan = segment_plan(row_pair, npairs)
    words24 = TorchEngine.partition_words24(psz) if words is None else words
    return k2_case(label, seg_row_start=plan.seg_row_start,
                   seg_pair=plan.seg_block,
                   pair_seg_start=plan.block_seg_start, row_pair=row_pair,
                   pair_part=np.repeat(np.arange(K, dtype=np.int32),
                                       per_part),
                   pair_block=np.tile(
                       np.arange(per_part, dtype=np.int64) * nb // per_part,
                       K),
                   num_blocks=nb, num_windows=K, window=psz + LANES,
                   sentinel=psz, table_dtype=table_dtype, words24=words24,
                   **kw)


def shipped_cases(csrc_dir=None) -> List[KernelCase]:
    """Every kernel of the port's paths at the geometries it runs:
    K1 (f32/f32) at a toy geometry, at the bench scales, at the PPR
    path's scale (one launch a column, the yardstick) and at a rank's
    geometry of the vertex-sharded forms (vs_halo's share, vs_bounded's
    local blocks and trash block), K1's
    f32/f64 and f64/f64 entries under their own configs; K1w at the PPR
    path's scale (64, 8 and 1 columns) and its f32/f64 and f64/f64
    entries at a toy geometry; K2 at scale 18
    (toy span), at the bench scales, in bf16 at scale 24, and with int32
    words; P1 and P2 at 2^19 rows (n = 2^22, f32 and bf16); P3 at
    2^19 rows at n = 2^15 and at its shared-memory limit in f32 and
    bf16."""
    kw = {"csrc_dir": csrc_dir}
    cases = [_synth_k1("ell_contrib@toy", n_pad=1 << 20, rows=1 << 16, **kw)]
    cases += [_synth_k1(f"ell_contrib@scale{s}", s, **kw)
              for s in BENCH_SCALES]
    # The PPR path: one launch a column of each chunk, every column at
    # this geometry (R-MAT 20, the PPR acceptance runs' size).
    cases.append(_synth_k1(f"ell_contrib@ppr-scale{PPR_SCALE}", PPR_SCALE,
                           **kw))
    # The vertex-sharded forms at two ranks: a rank's share of the rows
    # (the dense form and vs_halo, K1 over the halo image), and
    # vs_bounded's own rows over its local blocks and the trash block.
    cases.append(_synth_k1_rank("ell_contrib@vs-halo-share-scale22-world2",
                                22, 2, bounded=False, **kw))
    cases.append(_synth_k1_rank("ell_contrib@vs-bounded-scale22-world2", 22,
                                2, bounded=True, **kw))
    k1_dtypes = {"f32-f32": {}, "f32-f64": {"accum_dtype": "float64"},
                 "f64-f64": {"z_dtype": "float64", "accum_dtype": "float64"}}
    for tag, dt in k1_dtypes.items():
        if tag != "f32-f32":
            cases.append(_synth_k1(f"ell_contrib@scale22-{tag}", 22, **dt,
                                   **kw))
    # K1w on the PPR path at R-MAT 20: a 64-column chunk, the daemon's
    # batch of 8 and a lone query (a 4-column tile); its other entries at
    # a toy geometry.
    for k in (64, 8, 1):
        cases.append(_synth_k1w(f"ell_contrib_spmm@ppr-scale{PPR_SCALE}-k{k}",
                                PPR_SCALE, k=k, **kw))
    for tag, dt in k1_dtypes.items():
        if tag != "f32-f32":
            cases.append(_synth_k1w(f"ell_contrib_spmm@toy-k64-{tag}",
                                    n_pad=1 << 16, rows=1 << 13, k=64, **dt,
                                    **kw))
    cases += [_synth_k2("ell_contrib_partitioned@toy-span", 18, **kw)]
    cases += [_synth_k2(f"ell_contrib_partitioned@scale{s}", s, **kw)
              for s in BENCH_SCALES]
    cases += [
        _synth_k2("ell_contrib_partitioned@scale24-bf16", 24, "bfloat16",
                  **kw),
        _synth_k2("ell_contrib_partitioned@scale22-int32", 22, words=False,
                  **kw),
        _synth_k2("ell_contrib_partitioned@scale22-bf16-int32", 22,
                  "bfloat16", words=False, **kw)]
    smem = costs.device_spec().smem_per_block
    for dtype in ("float32", "bfloat16"):
        short = "f32" if dtype == "float32" else "bf16"
        for wrapper in ("gather_take", "gather_group8"):
            cases.append(probe_case(
                wrapper, f"{PROBE_SYMBOLS[wrapper]}@rows2^19-n2^22-{short}",
                rows=PROBE_ROWS, n=1 << 22, dtype=dtype, **kw))
        limit = smem // _DTYPE_BYTES[dtype]
        for n, tag in (((1 << 15), "n2^15"), (limit, f"n{limit}-limit")):
            if tag == "n2^15" and dtype != "float32":
                continue
            cases.append(probe_case(
                "gather_rowsel", f"probe_rowsel_smem@rows2^19-{tag}-{short}",
                rows=PROBE_ROWS, n=n, dtype=dtype, **kw))
    return cases


# ---------------------------------------------------------------------------
# Seeded-defect fixtures: one per rule, each trips exactly its rule.
# ---------------------------------------------------------------------------


def _tile_rows(shape, tile, grid, tile_of):
    """Per-CTA element intervals of a row-major ``shape`` (1-D: one row)
    cut into ``tile`` tiles, CTA (i, j) touching tile ``tile_of(i, j)``:
    one interval per tile row."""
    if len(shape) == 1:
        shape, tile = (1,) + tuple(shape), (1,) + tuple(tile)
    tr, tc = tile
    lo = []
    for i in range(grid[0]):
        for j in range(grid[1]):
            ti, tj = tile_of(i, j)
            r = np.arange(ti * tr, (ti + 1) * tr, dtype=np.int64)
            lo.append(r * shape[1] + tj * tc)
    lo = np.concatenate(lo)
    return lo, lo + tc


def _copy_case(label, source, *, x_shape, out_shape, tile, grid, out_tile,
               block, block_const, entry, symbol, dynamic=True,
               vector_bytes=0) -> KernelCase:
    x_lo, x_hi = _tile_rows(x_shape, tile, grid, lambda i, j: (i, j))
    o_lo, o_hi = _tile_rows(out_shape, tile, grid, out_tile)
    return KernelCase(
        label=label, config={"x": "float32"},
        operands={"x": Operand("float32", int(np.prod(x_shape))),
                  "out": Operand("float32", int(np.prod(out_shape)),
                                 role="out")},
        launches=[Launch(
            source=source.name, symbol=symbol, instance="", entry=entry,
            grid=(grid[0], grid[1], 1), block=block, block_const=block_const,
            dynamic_smem=int(np.prod(tile)) * 4 if dynamic else 0,
            tiles={"x": tuple(tile), "out": tuple(tile)},
            accesses=[Access("x", "read", x_lo, x_hi,
                             vector_bytes=vector_bytes),
                      Access("out", "write", o_lo, o_hi,
                             vector_bytes=vector_bytes)])])


def defect_case(name: str, *shapes, csrc_dir=None) -> KernelCase:
    """The launch case of fixture ``name``'s wrapper on inputs of
    ``shapes`` (default: the JAX fixture's, ``ops.defect_fixtures.
    SHAPES``), labelled as the JAX package labels the fixture."""
    from pagerank_tpu_torch.ops import defect_fixtures as fx

    src = read_source("defect_fixtures", csrc_dir)
    lanes, tr = src.const("kLanes"), src.const("kTileRows")
    label = f"fixture:{name}"
    x_shape = (shapes or fx.SHAPES[name])[0]
    rows, cols = x_shape[0], x_shape[-1]
    if name == "vmem_overflow":
        # PTK001 at the fixture's n: 32 MiB staged whole in one CTA's
        # shared memory, moved by 16-byte bulk copies.
        return _copy_case(label, src, x_shape=(rows,), out_shape=(rows,),
                          tile=(rows,), grid=(1, 1),
                          out_tile=lambda i, j: (i, j),
                          block=src.const("kWholeThreads"),
                          block_const="kWholeThreads",
                          entry="fx_vmem_overflow", symbol="fx_copy_bulk",
                          vector_bytes=16)
    if name == "misaligned_tile":
        # PTK002: (100, 64) tiles, one thread per tile row, each row a
        # 256-byte bulk copy in and out: 100-thread blocks.
        mis = (src.const("kMisTileRows"), src.const("kMisTileCols"))
        return _copy_case(label, src, x_shape=(rows, cols),
                          out_shape=(rows, cols), tile=mis,
                          grid=(rows // mis[0], cols // mis[1]),
                          out_tile=lambda i, j: (i, j), block=mis[0],
                          block_const="kMisTileRows",
                          entry="fx_misaligned_tile", symbol="fx_copy_rows",
                          vector_bytes=16)
    if name == "index_gap":
        # PTK003 (gap): out tile 2i, each tile one 4 KiB bulk copy in and
        # out; the odd out tiles never written (the entry's NaN fill is
        # no launch).
        return _copy_case(label, src, x_shape=(rows, lanes),
                          out_shape=(2 * rows, lanes), tile=(tr, lanes),
                          grid=(rows // tr, 1),
                          out_tile=lambda i, j: (2 * i, 0), block=lanes,
                          block_const="kLanes", entry="fx_index_gap",
                          symbol="fx_copy_rows", vector_bytes=16)
    if name == "index_overlap":
        # PTK003 (overlap): out tile i % 2, each tile one 4 KiB bulk copy
        # in and out; two CTAs write each of tiles 0 and 1 (and tiles
        # past 1, where x has more than 32 rows, stay unwritten: the
        # entry's NaN fill is no launch).
        return _copy_case(label, src, x_shape=(rows, lanes),
                          out_shape=(rows // 2, lanes), tile=(tr, lanes),
                          grid=(rows // tr, 1),
                          out_tile=lambda i, j: (i % 2, 0), block=lanes,
                          block_const="kLanes", entry="fx_index_overlap",
                          symbol="fx_copy_rows", vector_bytes=16)
    if name == "f64_scratch":
        # PTK004: an f64 shared scratch in an f32 case.
        return _copy_case(label, src, x_shape=(rows, lanes),
                          out_shape=(rows, lanes), tile=(tr, lanes),
                          grid=(rows // tr, 1),
                          out_tile=lambda i, j: (i, j), block=lanes,
                          block_const="kLanes", entry="fx_f64_scratch",
                          symbol="fx_scratch", dynamic=False,
                          vector_bytes=16)
    if name != "cost_mismatch":
        raise KeyError(f"no defect fixture {name!r}")
    # PTK005: a correct matmul with a deliberately wrong analytic model.
    # CTA (i, j) reads x's rows [tm i, tm i + tm) whole (one span), y's
    # columns [tn j, tn j + tn) of every row (k spans) by 16-byte
    # copies, and writes out's (tm, tn) tile (i, j) as float2.
    tm, tn, m, k = src.const("kMatTileM"), src.const("kMatTileN"), rows, cols
    grid = (m // tm, lanes // tn)
    ci = np.repeat(np.arange(grid[0], dtype=np.int64), grid[1])
    cj = np.tile(np.arange(grid[1], dtype=np.int64), grid[0])
    x_lo = ci * tm * k
    y_lo = (np.arange(k, dtype=np.int64)[None, :] * lanes
            + cj[:, None] * tn).ravel()
    o_lo = ((ci[:, None] * tm + np.arange(tm)[None, :]) * lanes
            + cj[:, None] * tn).ravel()
    return KernelCase(
        label=label, config={"x": "float32"},
        operands={"x": Operand("float32", m * k),
                  "y": Operand("float32", k * lanes),
                  "out": Operand("float32", m * lanes, role="out")},
        launches=[Launch(
            source="defect_fixtures", symbol="fx_matmul_3xtf32",
            instance="", entry="fx_cost_mismatch", grid=(*grid, 1),
            block=src.const("kMatThreads"), block_const="kMatThreads",
            dynamic_smem=src.const("kMatStages")
            * src.const("kMatStageFloats") * 4,
            flops=2.0 * m * k * lanes,
            tiles={"x": (tm, k), "y": (k, tn), "out": (tm, tn)},
            accesses=[
                Access("x", "read", x_lo, x_lo + tm * k, vector_bytes=16),
                Access("y", "read", y_lo, y_lo + tn, vector_bytes=16),
                Access("out", "write", o_lo, o_lo + tn, vector_bytes=8),
            ])],
        cost_model={"flops": 1.0, "bytes": 1.0})


def defect_cases(csrc_dir=None) -> List[KernelCase]:
    """F1-F6 (``csrc/defect_fixtures.cu``) at the JAX fixtures' shapes,
    labelled as the JAX package labels them."""
    from pagerank_tpu_torch.ops import defect_fixtures as fx

    return [defect_case(name, csrc_dir=csrc_dir) for name in fx.SHAPES]


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def _f(case: KernelCase, launch: Optional[Launch], rule: str,
       msg: str) -> Finding:
    launch = launch or case.launches[0]
    kern = read_source(launch.source).kernels.get(launch.symbol)
    return Finding(rule=rule, path=f"csrc/{launch.source}.cu",
                   line=kern.line if kern else 0,
                   message=f"{launch.symbol}: {msg}",
                   snippet=f"kernel={case.label}")


def _kernel(launch: Launch, csrc_dir) -> CuKernel:
    src = read_source(launch.source, csrc_dir)
    if launch.symbol not in src.kernels:
        raise KeyError(f"csrc/{launch.source}.cu has no __global__ "
                       f"{launch.symbol}")
    return src.kernels[launch.symbol]


def check_shared_memory(case, spec, csrc_dir=None) -> List[Finding]:
    """PTK001."""
    out = []
    for ln in case.launches:
        k = _kernel(ln, csrc_dir)
        static, dyn = k.static_smem, ln.dynamic_smem
        if static + dyn > spec.smem_per_block:
            out.append(_f(case, ln, "PTK001",
                          f"shared memory {static} B static + {dyn} B "
                          f"dynamic = {static + dyn} B exceeds the "
                          f"{spec.smem_per_block} B a block may use on "
                          f"{spec.name}"))
        elif static > spec.smem_default:
            out.append(_f(case, ln, "PTK001",
                          f"{static} B of static shared memory: past "
                          f"{spec.smem_default} B only dynamic shared "
                          f"memory is allowed"))
        elif dyn > spec.smem_default and not k.opt_in:
            out.append(_f(case, ln, "PTK001",
                          f"{dyn} B of dynamic shared memory without the "
                          f"source's cudaFuncSetAttribute(MaxDynamicShared"
                          f"MemorySize) opt-in: the launch is refused above "
                          f"{spec.smem_default} B"))
    return out


def check_launch_geometry(case, spec, csrc_dir=None) -> List[Finding]:
    """PTK002."""
    out = []
    for ln in case.launches:
        k = _kernel(ln, csrc_dir)
        cap = min(spec.max_threads_per_block, k.launch_bounds or 1 << 30)
        if ln.block % 32:
            out.append(_f(case, ln, "PTK002",
                          f"{ln.block} threads a block is not a whole "
                          f"number of warps ({_ceil(ln.block, 32)} warps, "
                          f"{_ceil(ln.block, 32) * 32 - ln.block} lanes "
                          f"idle)"))
        if ln.block > cap or ln.block < 1:
            out.append(_f(case, ln, "PTK002",
                          f"{ln.block} threads a block against a limit of "
                          f"{cap} (__launch_bounds__ "
                          f"{k.launch_bounds}, card "
                          f"{spec.max_threads_per_block})"))
        gx, gy, gz = ln.grid
        if not (1 <= gx <= 2 ** 31 - 1 and 1 <= gy <= 65535
                and 1 <= gz <= 65535):
            out.append(_f(case, ln, "PTK002",
                          f"grid {ln.grid} outside (2^31-1, 65535, 65535) "
                          f"or empty"))
        for a in ln.accesses:
            op = case.operands[a.operand]
            if a.vector_bytes and op.align % a.vector_bytes:
                out.append(_f(case, ln, "PTK002",
                              f"{a.operand} is {op.align}-byte aligned but "
                              f"the kernel loads it {a.vector_bytes} bytes "
                              f"at a time"))
    return out


def _merged(lo, hi):
    """Sort intervals (empty ones dropped); return (lo, hi, running end
    before each) for overlap and gap tests."""
    keep = hi > lo
    lo, hi = lo[keep], hi[keep]
    if len(lo) > 1 and np.any(np.diff(lo) < 0):
        order = np.argsort(lo, kind="stable")
        lo, hi = lo[order], hi[order]
    ends = np.maximum.accumulate(hi) if len(hi) else hi
    prev = np.concatenate([[0], ends[:-1]]) if len(hi) else hi
    return lo, hi, prev


def _cover(lo, hi, numel):
    """(first overlap start or None, every gap [a, b)) of intervals that
    should cover [0, numel) exactly once."""
    lo, hi, prev = _merged(lo, hi)
    over = np.flatnonzero(lo[1:] < prev[1:]) + 1
    overlap = int(lo[over[0]]) if len(over) else None
    if not len(lo):
        return overlap, [(0, numel)] if numel else []
    g = np.flatnonzero(lo[1:] > prev[1:]) + 1
    gaps = [(int(prev[i]), int(lo[i])) for i in g]
    if lo[0] > 0:
        gaps.insert(0, (0, int(lo[0])))
    end = int(hi.max())
    if end < numel:
        gaps.append((end, numel))
    return overlap, gaps


def _cover_n(lo, hi, numel, n):
    """:func:`_cover` for intervals that should cover [0, numel) exactly
    ``n`` times: (first element covered more often or None, the ranges
    covered less often)."""
    keep = hi > lo
    if not keep.any():
        return None, [(0, numel)] if numel else []
    pts = np.concatenate([lo[keep], hi[keep]])
    delta = np.concatenate([np.ones(int(keep.sum()), np.int64),
                            -np.ones(int(keep.sum()), np.int64)])
    order = np.argsort(pts, kind="stable")
    pts, delta = pts[order], delta[order]
    at, first = np.unique(pts, return_index=True)
    depth = np.cumsum(np.add.reduceat(delta, first))  # on [at[i], at[i+1])
    over = np.flatnonzero(depth[:-1] > n)
    overlap = int(at[over[0]]) if len(over) else None
    gaps = [(0, int(at[0]))] if at[0] > 0 else []
    gaps += [(int(at[i]), int(at[i + 1]))
             for i in np.flatnonzero(depth[:-1] < n)]
    if at[-1] < numel:
        gaps.append((int(at[-1]), numel))
    return overlap, gaps


def write_gaps(case: KernelCase, operand: str) -> List[Tuple[int, int]]:
    """The element ranges [a, b) of an output that no launch of the case
    writes: where PTK003 names a gap (and where F3's output stays NaN)."""
    acc = [a for ln in case.launches for a in ln.accesses
           if a.operand == operand and a.mode == "write"]
    lo = np.concatenate([a.lo for a in acc]) if acc else np.zeros(0, np.int64)
    hi = np.concatenate([a.hi for a in acc]) if acc else np.zeros(0, np.int64)
    return _cover(lo, hi, case.operands[operand].numel)[1]


def _union(lo, hi):
    lo, hi, _ = _merged(lo, hi)
    if not len(lo):
        return []
    out = [[int(lo[0]), int(hi[0])]]
    for a, b in zip(lo[1:].tolist(), hi[1:].tolist()):
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def check_coverage(case, spec=None, csrc_dir=None) -> List[Finding]:
    """PTK003."""
    out = []
    per_op: Dict[str, Dict[str, list]] = {}
    for ln in case.launches:
        for a in ln.accesses:
            op = case.operands[a.operand]
            if a.mode == "gather":
                if a.index_max >= op.numel:
                    out.append(_f(case, ln, "PTK003",
                                  f"{a.operand}: gathered index up to "
                                  f"{a.index_max} past its {op.numel} "
                                  f"elements: read out of bounds"))
                continue
            bad = (a.lo < 0) | (a.hi > op.numel)
            if np.any(bad):
                i = int(np.flatnonzero(bad)[0])
                out.append(_f(case, ln, "PTK003",
                              f"{a.operand}: {a.mode} of [{int(a.lo[i])}, "
                              f"{int(a.hi[i])}) outside its {op.numel} "
                              f"elements"))
            d = per_op.setdefault(a.operand,
                                  {"read": [], "write": [], "atomic": []})
            d[a.mode].append((a.lo, a.hi, ln))
    for name, d in per_op.items():
        op = case.operands[name]
        for mode in ("read", "write"):
            if not d[mode]:
                continue
            lo = np.concatenate([x[0] for x in d[mode]])
            hi = np.concatenate([x[1] for x in d[mode]])
            ln = d[mode][0][2]
            exact = (mode == "write" and op.role == "out") or (
                mode == "read" and op.partition)
            if op.role in ("scratch", "counter") or exact:
                passes = op.passes if mode == "read" else 1
                overlap, gaps = (_cover_n(lo, hi, op.numel, passes)
                                 if passes > 1 else _cover(lo, hi, op.numel))
                if overlap is not None:
                    what = ("written by two CTAs (a race: CTAs run in no "
                            "order)" if mode == "write"
                            else "read by two CTAs (counted twice)"
                            if passes == 1 else
                            f"read more than {passes} times (counted twice)")
                    out.append(_f(case, ln, "PTK003",
                                  f"{name}: element {overlap} {what}"))
                if exact and gaps:
                    what = ("never written" if mode == "write"
                            else "never read (those rows never reach the "
                                 "output)" if passes == 1 else
                            f"read fewer than {passes} times (those rows "
                            f"miss a tile of the output)")
                    shown = ", ".join(f"[{a}, {b})" for a, b in gaps[:8])
                    more = f" and {len(gaps) - 8} more" if len(gaps) > 8 \
                        else ""
                    out.append(_f(case, ln, "PTK003",
                                  f"{name}: elements {shown}{more} of "
                                  f"{op.numel} {what}"))
        if d["write"] and d["atomic"]:
            out += _plain_meets_atomic(case, name, d)
        if op.role == "scratch":
            w = _union(*(np.concatenate([x[i] for x in d["write"]])
                         for i in (0, 1))) if d["write"] else []
            r = _union(*(np.concatenate([x[i] for x in d["read"]])
                         for i in (0, 1))) if d["read"] else []
            if w != r:
                ln = (d["read"] or d["write"])[0][2]
                out.append(_f(case, ln, "PTK003",
                              f"{name}: scratch written over {_span(w)} but "
                              f"read over {_span(r)}: a partial is lost or "
                              f"read unwritten"))
    if case.segments is not None:
        out += _segment_ownership(case)
    return out


def _plain_meets_atomic(case, name, d) -> List[Finding]:
    """A plain store to an element that some work item updates
    atomically: the store and the atomics race."""
    atomic = _union(*(np.concatenate([x[i] for x in d["atomic"]])
                      for i in (0, 1)))
    if not atomic:
        return []
    a_lo = np.array([a for a, _ in atomic], np.int64)
    a_hi = np.array([b for _, b in atomic], np.int64)
    for lo, hi, ln in d["write"]:
        keep = hi > lo
        lo, hi = lo[keep], hi[keep]
        # the last atomic run starting before each store's end
        k = np.searchsorted(a_lo, hi, side="left") - 1
        hit = (k >= 0) & (a_hi[np.maximum(k, 0)] > lo)
        if np.any(hit):
            i = int(np.flatnonzero(hit)[0])
            return [_f(case, ln, "PTK003",
                       f"{name}: element {max(int(lo[i]), int(a_lo[k[i]]))} "
                       f"is stored plainly and updated atomically by other "
                       f"work items (a race: CTAs run in no order)")]
    return []


def _span(iv):
    n = sum(b - a for a, b in iv)
    return f"{n} elements in {len(iv)} run(s)"


def _segment_ownership(case) -> List[Finding]:
    """Every row of segment s belongs to the group (block or pair) whose
    pass-2 range [group_seg_start[g], group_seg_start[g+1]) holds s."""
    rs, gss, row_group = case.segments
    num_segs = len(rs) - 1
    seg = np.arange(num_segs, dtype=np.int64)
    owner = np.searchsorted(gss, seg, side="right") - 1
    lens = np.maximum(rs[1:] - rs[:-1], 0)
    if not lens.sum():
        return []
    seg_of_row = np.repeat(seg, lens)
    rows = (np.arange(int(lens.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(lens) - lens, lens) + np.repeat(rs[:-1],
                                                                  lens))
    ok_rows = rows < len(row_group)
    bad = np.flatnonzero(~ok_rows | (row_group[np.minimum(
        rows, len(row_group) - 1)] != owner[seg_of_row]))
    if not len(bad):
        return []
    s = int(seg_of_row[bad[0]])
    return [_f(case, case.launches[-1], "PTK003",
               f"segment {s} (rows [{int(rs[s])}, {int(rs[s + 1])})) is "
               f"summed by group {int(owner[s])} but its row "
               f"{int(rows[bad[0]])} belongs to group "
               f"{int(row_group[min(rows[bad[0]], len(row_group) - 1)])}")]


def check_f64(case, spec=None, csrc_dir=None) -> List[Finding]:
    """PTK004."""
    if "float64" in case.config.values():
        return []
    out = []
    for ln in case.launches:
        k = _kernel(ln, csrc_dir)
        why = []
        if re.search(r"\bdouble\b", ln.instance):
            why.append(f"template arguments <{ln.instance}>")
        why += [f"__shared__ {d.ctype} {d.name}" for d in k.shared
                if d.ctype == "double"]
        why += [f"operand {a.operand}" for a in ln.accesses
                if case.operands[a.operand].dtype == "float64"]
        if why:
            out.append(_f(case, ln, "PTK004",
                          f"float64 in a case whose config is "
                          f"{case.config}: {', '.join(why)}"))
    return out


def derived_cost(case) -> Dict[str, float]:
    """FLOPs and bytes from the launches' models: each interval's bytes
    as often as CTAs touch it, a gathered operand once."""
    flops = sum(ln.flops for ln in case.launches)
    nbytes = 0.0
    for ln in case.launches:
        for a in ln.accesses:
            op = case.operands[a.operand]
            span = op.numel if a.mode == "gather" else int(
                np.maximum(a.hi - a.lo, 0).sum())
            nbytes += span * op.itemsize
    return {"flops": float(flops), "bytes": nbytes}


def check_cost(case, spec=None, csrc_dir=None) -> List[Finding]:
    """PTK005."""
    if case.cost_model is None:
        return []
    got = derived_cost(case)
    out = []
    for name in ("flops", "bytes"):
        want = float(case.cost_model[name])
        if abs(got[name] - want) / max(abs(want), 1.0) > 0.25:
            out.append(_f(case, None, "PTK005",
                          f"{name} {got[name]:.6g} from the launch models "
                          f"vs the analytic model's {want:.6g} (>25% "
                          f"apart): the geometry and the bound formula "
                          f"have drifted"))
    return out


#: Compiled instances with a stack frame that is known and accepted, by
#: launch key: (the frame's bytes a thread, why). PTK002 flags any other
#: frame, and these once they grow.
STACK_EXCEPTIONS = {
    "ell_contrib_part_kernel<unsignedshort,false>": (
        16, "K2 with bf16 windows and int32 slot words (PR 5): 16 B of "
            "spill at 64 registers, off every main path (the bf16 form "
            "runs 3-byte words, a frame of 0)"),
    "ell_contrib_spmm_kernel<float,float,64>": (
        64, "K1w's PPR tile over f32 sums (PR 9): 64 B of spill at 64 "
            "registers a thread (1024 threads); tile 32 has none and ran "
            "the 64-column SpMM slower in chip_smoke.py's tile sweep on "
            "the H100 (PERF.md)"),
    "ell_contrib_spmm_kernel<float,double,16>": (
        8, "K1w's f32/f64 entry at the f64-sum tile: 8 B of spill, off "
           "every path (the PPR engine prescales z in the sum's dtype)"),
}


def check_compiled(case, facts, spec) -> List[Finding]:
    """The compile-fact clauses of PTK001, PTK002 and PTK004. ``facts``:
    {launch key: resources.SymbolFacts} of the built libraries; a
    launch the libraries lack raises (the registry names a kernel that
    was not built)."""
    out = []
    f32 = "float64" not in case.config.values()
    for ln in case.launches:
        if ln.key not in facts:
            raise LookupError(f"{case.label}: no compile facts for "
                              f"{ln.key} in lib{ln.source}")
        fc = facts[ln.key]
        k = _kernel(ln, None)
        # The 1 KB reservation shows on every kernel of a library in
        # which any kernel uses shared memory.
        reserved = spec.smem_reserved if any(
            kk.shared for kk in read_source(ln.source).kernels.values()) \
            else 0
        if fc.shared != k.static_smem + reserved:
            out.append(_f(case, ln, "PTK001",
                          f"declares {k.static_smem} B of static shared "
                          f"memory (+{reserved} B reserved), the compiler "
                          f"reports {fc.shared} B"))
        elif fc.shared - reserved + ln.dynamic_smem > spec.smem_per_block:
            out.append(_f(case, ln, "PTK001",
                          f"compiled shared memory {fc.shared - reserved} B "
                          f"+ {ln.dynamic_smem} B dynamic exceeds "
                          f"{spec.smem_per_block} B"))
        if fc.max_threads != k.launch_bounds:
            out.append(_f(case, ln, "PTK002",
                          f"__launch_bounds__ {k.launch_bounds} in the "
                          f"source, {fc.max_threads} in the binary"))
        if fc.regs * ln.block > spec.regs_per_sm:
            out.append(_f(case, ln, "PTK002",
                          f"{fc.regs} registers x {ln.block} threads = "
                          f"{fc.regs * ln.block} > the SM's "
                          f"{spec.regs_per_sm}: the launch is refused"))
        allowed = STACK_EXCEPTIONS.get(ln.key, (0, ""))[0]
        if fc.local or fc.stack > allowed:
            out.append(_f(case, ln, "PTK002",
                          f"{fc.local} B of local memory and {fc.stack} B "
                          f"of stack frame a thread (accepted: {allowed}): "
                          f"registers spill, or an array lives in memory"))
        if f32 and fc.f64_ops:
            out.append(_f(case, ln, "PTK004",
                          f"f64 instructions in the SASS under config "
                          f"{case.config}: {', '.join(fc.f64_ops)}"))
    return out


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def check_kernel_case(case: KernelCase, device_kind: Optional[str] = None,
                      facts=None, csrc_dir=None) -> List[Finding]:
    spec = costs.device_spec(device_kind)
    out: List[Finding] = []
    for rule in (check_shared_memory, check_launch_geometry, check_coverage,
                 check_f64, check_cost):
        out += rule(case, spec, csrc_dir)
    if facts is not None:
        out += check_compiled(case, facts, spec)
    return out


def check_kernel_plane(cases: Optional[Sequence[KernelCase]] = None,
                       compiled: bool = False,
                       device_kind: Optional[str] = None) -> List[Finding]:
    """Run PTK001-005 over the launch cases (default: the shipped
    registry). ``compiled`` adds the compile facts of the built
    libraries (:mod:`.resources`; needs the CUDA toolkit's cuobjdump)."""
    if cases is None:
        cases = shipped_cases()
    facts = None
    if compiled:
        from pagerank_tpu_torch.analysis import resources

        facts = resources.built_facts(sorted({ln.source for c in cases
                                              for ln in c.launches}))
    findings: List[Finding] = []
    for case in cases:
        findings.extend(check_kernel_case(case, device_kind, facts))
    return findings
