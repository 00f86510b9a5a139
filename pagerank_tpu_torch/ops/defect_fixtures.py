"""F1-F6: the seeded-defect fixtures of the kernel-plane check.

Replaces the fixtures of ``pagerank_tpu/analysis/kernels.py:
defect_cases`` (bodies ``_fx_copy``, ``_fx_scratch``, ``_fx_matmul``):
the kernels are ``pagerank_tpu_torch/csrc/defect_fixtures.cu``, built
for ``sm_90a`` at first use (kernels/build.py) and called through
ctypes. Each fixture computes the JAX fixture's function at a launch
geometry that trips exactly one rule of
:mod:`pagerank_tpu_torch.analysis.kernels` (the source note lists
which). What bounds them on the H100: device-memory bytes; at the
fixtures' KiB shapes a call is its launch, so each C entry is bound
once (:func:`_entry`) and a call does no more on the host than its
launch needs.

The plain versions follow the JAX fixtures as interpret mode runs them:
the tile maps are applied in grid order, so where two steps write one
output tile the last one wins (F4), and output that no tile writes is
NaN (F3). On the card an output is NaN before the launch only where
the launch leaves elements unwritten (:func:`leaves_gaps`: PTK003's
gaps), so an unwritten tile reads the same there: F3's C entry sets
its odd tiles, and F4's past k = 2 its out tiles from 2 on, to 0xFF
bytes on the stream before its launch, at the geometry :func:`gap_fill`
gives; every wrapper allocates its output with ``torch.empty``. F4's
two writers race there, in no order.

Each wrapper launches its kernel for CUDA tensors, or raises; it takes
its plain version only for tensors on the CPU. F1 at its fixture's size
(8,388,608 f32) must raise: its 32 MiB of shared memory is refused. F1
to F4 move bulk copies, F5 16-byte vectors and F6 16-byte cp.async
copies of x and y, so they raise on an x (or F6's y) that is not
16-byte aligned.
``launches`` counts the launches of each kernel by fixture name.
"""

from __future__ import annotations

import ctypes

import torch

from pagerank_tpu_torch.ops import LANES

#: Kernel launches made by each wrapper in this process.
launches = {"vmem_overflow": 0, "misaligned_tile": 0, "index_gap": 0,
            "index_overlap": 0, "f64_scratch": 0, "cost_mismatch": 0}

#: The JAX fixtures' tile shapes (rows, cols) and F1's size.
TILE = (8, LANES)
MIS_TILE = (100, 64)
OVERFLOW_N = 8 << 20

#: The fixtures whose kernels move 16-byte units (bulk copies, float4,
#: cp.async).
VECTOR = ("vmem_overflow", "misaligned_tile", "index_gap", "index_overlap",
          "f64_scratch", "cost_mismatch")

#: The JAX fixtures' input shapes, in their order.
SHAPES = {"vmem_overflow": [(OVERFLOW_N,)],
          "misaligned_tile": [(200, LANES)], "index_gap": [(16, LANES)],
          "index_overlap": [(32, LANES)], "f64_scratch": [(16, LANES)],
          "cost_mismatch": [(2 * LANES, LANES), (LANES, LANES)]}

_P, _I = ctypes.c_void_p, ctypes.c_int64
#: Each fixture's C entry and its arguments before the stream.
_ENTRIES = {"vmem_overflow": ("fx_vmem_overflow", (_P, _P, _I)),
            "misaligned_tile": ("fx_misaligned_tile", (_P, _P, _I, _I)),
            "index_gap": ("fx_index_gap", (_P, _P, _I, _I, _I, _I, _I)),
            "index_overlap": ("fx_index_overlap", (_P, _P, _I, _I, _I)),
            "f64_scratch": ("fx_f64_scratch", (_P, _P, _I)),
            "cost_mismatch": ("fx_cost_mismatch", (_P, _P, _P, _I, _I)),
            "last_error": ("defect_fixtures_last_error", ()),
            "error_string": ("defect_fixtures_error_string", (ctypes.c_int,))}
_BOUND = {}


def _entry(name):
    """The C entry of ``name`` in the library, its ctypes signature set
    once (the stream last; returns the CUDA error)."""
    fn = _BOUND.get(name)
    if fn is None:
        from pagerank_tpu_torch.kernels import build

        symbol, args = _ENTRIES[name]
        fn = getattr(build.load("defect_fixtures"), symbol)
        if name == "error_string":
            fn.argtypes, fn.restype = list(args), ctypes.c_char_p
        else:
            fn.argtypes = list(args) + ([_P] if args else [])
            fn.restype = ctypes.c_int
        _BOUND[name] = fn
    return fn


def _check(name, *ts, ndim=2):
    x = ts[0]
    for t in ts:
        if t.dtype is not torch.float32:
            raise TypeError(f"{name}: want float32, got {t.dtype}")
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {ndim}-D tensor, "
                             f"got {tuple(t.shape)}")
    for t in ts[1:]:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{x.device}")
    if not (x.is_cuda or x.is_cpu):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def _rows_of(name, x, tile_rows, cols=LANES, least=1):
    rows = x.shape[0]
    if rows % tile_rows or rows < least * tile_rows or x.shape[1] != cols:
        raise ValueError(f"{name}: want x [k*{tile_rows}, {cols}] with k >= "
                         f"{least}, got {tuple(x.shape)}")
    return rows


def gap_fill(name, rows):
    """The NaN fill of fixture ``name`` (F3 or F4) on an x of ``rows``
    rows, in bytes of out: the elements its launch leaves unwritten (the
    gaps PTK003 names), as its C entry takes them. F3: out's odd (8,
    128) tiles, (offset, pitch, width, count) for cudaMemset2DAsync.
    F4: its out tiles from 2 on, one span at the tail of out, (offset,
    bytes) for cudaMemsetAsync (0 bytes at the fixture's 32 rows)."""
    tile = TILE[0] * TILE[1] * 4
    if name == "index_gap":
        return tile, 2 * tile, tile, rows // TILE[0]
    if name == "index_overlap":
        return 2 * tile, (rows // 2) * LANES * 4 - 2 * tile
    raise KeyError(f"fixture {name!r} has no NaN fill")


def leaves_gaps(name, rows):
    """Whether fixture ``name``'s launch on an x of ``rows`` rows leaves
    elements of its output unwritten (the gaps PTK003 names): F3 always
    (its odd out tiles), F4 once x has more than its fixture's 32 rows
    (out tiles past 1). Only those outputs are NaN before the launch."""
    if name == "index_overlap":
        return gap_fill(name, rows)[1] > 0
    return name == "index_gap"


def _launch_args(name, x, y=None):
    """(out, the C entry's arguments before the stream, tensors as
    addresses) of fixture ``name`` on inputs its wrapper took: out is
    ``torch.empty`` (F3's and F4's entries fill their gaps,
    :func:`gap_fill`). Raises on an x (or F6's y) that a kernel of
    :data:`VECTOR` cannot move in 16-byte units."""
    rows = x.shape[0]
    if name in VECTOR:
        for label, t in (("x", x), ("y", y)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(
                    f"{name}: {label} must be 16-byte aligned (its kernel "
                    f"moves 16-byte units), got address {t.data_ptr():#x}")
    if name in ("index_gap", "index_overlap"):
        out_rows = 2 * rows if name == "index_gap" else rows // 2
        out = torch.empty((out_rows, LANES), dtype=torch.float32,
                          device=x.device)
        return out, (x.data_ptr(), out.data_ptr(), rows,
                     *gap_fill(name, rows))
    if name == "cost_mismatch":
        out = torch.empty((rows, LANES), dtype=torch.float32,
                          device=x.device)
        return out, (x.data_ptr(), y.data_ptr(), out.data_ptr(), rows,
                     x.shape[1])
    out = torch.empty_like(x)
    if name == "misaligned_tile":
        return out, (x.data_ptr(), out.data_ptr(), rows, x.shape[1])
    return out, (x.data_ptr(), out.data_ptr(), rows)


def _failure(name, rc):
    msg = _entry("error_string")(rc).decode()
    return RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                        f"({msg})")


def _stream_of(index):
    """The handle of device ``index``'s current CUDA stream, from
    PyTorch's raw getter (``torch.cuda.current_stream`` builds a Stream
    object a call)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(name, *inputs):
    """Launch fixture ``name`` on ``inputs`` on the current stream of
    their device, entering that device only when it is not the current
    one; raise on a CUDA error, else count the launch and return out."""
    out, args = _launch_args(name, *inputs)
    fn = _entry(name)
    index = out.get_device()
    if index == torch.cuda.current_device():
        rc = fn(*args, _stream_of(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _stream_of(index))
    if rc != 0:
        raise _failure(name, rc)
    launches[name] += 1
    return out


def bind(name, *inputs):
    """Fixture ``name``'s bare launch on CUDA ``inputs`` that its
    wrapper takes: the output allocated and the bound C entry's
    arguments and stream (the current one) fixed once; each call of the
    returned function launches the kernel once into that output (its
    device must be the current one), counts it and returns the output."""
    out, args = _launch_args(name, *inputs)
    fn = _entry(name)
    args += (_stream_of(out.get_device()),)

    def launch():
        rc = fn(*args)
        if rc != 0:
            raise _failure(name, rc)
        launches[name] += 1
        return out

    return launch


def _nan(shape, like):
    return torch.full(shape, float("nan"), dtype=like.dtype,
                      device=like.device)


def tile_copy_reference(x, out_shape, tile, grid, out_tile):
    """The JAX ``_fx_copy`` under its BlockSpecs, in grid order: step
    (i, j) copies x's tile (i, j) into out's tile ``out_tile(i, j)``;
    the last writer of a tile wins and unwritten output stays NaN."""
    tr, tc = tile
    out = _nan(out_shape, x)
    for i in range(grid[0]):
        for j in range(grid[1]):
            oi, oj = out_tile(i, j)
            out[oi * tr:(oi + 1) * tr, oj * tc:(oj + 1) * tc] = \
                x[i * tr:(i + 1) * tr, j * tc:(j + 1) * tc]
    return out


def vmem_overflow_reference(x):
    return x.clone()


def misaligned_tile_reference(x):
    rows, cols = x.shape
    return tile_copy_reference(
        x, x.shape, MIS_TILE, (rows // MIS_TILE[0], cols // MIS_TILE[1]),
        lambda i, j: (i, j))


def index_gap_reference(x):
    rows = x.shape[0]
    return tile_copy_reference(x, (2 * rows, LANES), TILE,
                               (rows // TILE[0], 1), lambda i, j: (2 * i, 0))


def index_overlap_reference(x):
    rows = x.shape[0]
    return tile_copy_reference(x, (rows // 2, LANES), TILE,
                               (rows // TILE[0], 1), lambda i, j: (i % 2, 0))


def f64_scratch_reference(x):
    return x.clone()


def cost_mismatch_reference(x, y):
    return x @ y


def vmem_overflow(x):
    """F1: out = x for x f32 [n], staged whole in one CTA's shared
    memory. Launches only where n * 4 fits a block (n <= 58,112); at the
    fixture's n it raises with the CUDA error."""
    _check("vmem_overflow", x, ndim=1)
    if x.is_cpu:
        return vmem_overflow_reference(x)
    return _launch("vmem_overflow", x)


def misaligned_tile(x):
    """F2: out = x over (100, 64) tiles, grid (rows/100, cols/64)."""
    _check("misaligned_tile", x)
    rows, cols = x.shape
    if rows % MIS_TILE[0] or cols % MIS_TILE[1] or rows == 0:
        raise ValueError(f"misaligned_tile: want x [k*100, m*64], got "
                         f"{tuple(x.shape)}")
    if x.is_cpu:
        return misaligned_tile_reference(x)
    return _launch("misaligned_tile", x)


def index_gap(x):
    """F3: x [k*8, 128] -> out [2k*8, 128], x tile i into out tile 2i;
    the odd out tiles stay NaN (on the card its entry sets them before
    the launch)."""
    _check("index_gap", x)
    _rows_of("index_gap", x, TILE[0])
    if x.is_cpu:
        return index_gap_reference(x)
    return _launch("index_gap", x)


def index_overlap(x):
    """F4: x [k*16, 128] -> out [k*8, 128], k >= 2, x tile i into out
    tile i % 2 (the fixture: k = 2, two out tiles with two writers each;
    past it the out tiles from 2 on stay NaN, on the card by its entry's
    fill; at k = 1 out has no tile 1). The plain version keeps the last
    writer; on the card each element holds one of its writers', in no
    order."""
    _check("index_overlap", x)
    _rows_of("index_overlap", x, 2 * TILE[0], least=2)
    if x.is_cpu:
        return index_overlap_reference(x)
    return _launch("index_overlap", x)


def f64_scratch(x):
    """F5: out = x over (8, 128) tiles, beside an f64 shared scratch
    negated in place (its values never reach out)."""
    _check("f64_scratch", x)
    _rows_of("f64_scratch", x, TILE[0])
    if x.is_cpu:
        return f64_scratch_reference(x)
    return _launch("f64_scratch", x)


def cost_mismatch(x, y):
    """F6: out = x @ y in f32; x [m, k] (m % 128 == 0, k % 32 == 0),
    y [k, 128]; on the card 3xTF32 on the tensor cores, within 1e-5 of
    the exact product's largest element. The plain version is one f32
    matmul."""
    _check("cost_mismatch", x, y)
    m, k = x.shape
    if m % LANES or m == 0 or k % 32 or k == 0 or y.shape != (k, LANES):
        raise ValueError(f"cost_mismatch: want x [128i, 32j] and y [32j, "
                         f"128], got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.is_cpu:
        return cost_mismatch_reference(x, y)
    return _launch("cost_mismatch", x, y)


def last_error() -> int:
    """``cudaGetLastError()`` on the card now (0: no error is pending);
    shows that F1's refused launch left nothing for the next launch."""
    return _entry("last_error")()
