"""F1-F6: the seeded-defect fixtures of the kernel-plane check.

Replaces the fixtures of ``pagerank_tpu/analysis/kernels.py:
defect_cases`` (bodies ``_fx_copy``, ``_fx_scratch``, ``_fx_matmul``):
the kernels are ``pagerank_tpu_torch/csrc/defect_fixtures.cu``, built
for ``sm_90a`` at first use (kernels/build.py) and called through
ctypes. Each fixture computes the JAX fixture's function at a launch
geometry that trips exactly one rule of
:mod:`pagerank_tpu_torch.analysis.kernels` (the source note lists
which). What bounds them on the H100: device-memory bytes; they exist
to be checked, not to be fast.

The plain versions follow the JAX fixtures as interpret mode runs them:
the tile maps are applied in grid order, so where two steps write one
output tile the last one wins (F4), and output that no tile writes is
NaN (F3). The CUDA wrappers fill the output with NaN before the launch,
so an unwritten tile reads the same on the card; F4's two writers race
there, in no order.

Each wrapper launches its kernel for CUDA tensors, or raises; it takes
its plain version only for tensors on the CPU. F1 at its fixture's size
(8,388,608 f32) must raise: its 32 MiB of shared memory is refused.
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


def _check(name, *ts, ndim=2):
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: want float32, got {t.dtype}")
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {ndim}-D tensor, "
                             f"got {tuple(t.shape)}")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{ts[0].device}")
    if ts[0].device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {ts[0].device}")


def _rows_of(name, x, tile_rows, cols=LANES):
    rows = x.shape[0]
    if rows % tile_rows or rows == 0 or x.shape[1] != cols:
        raise ValueError(f"{name}: want x [k*{tile_rows}, {cols}], got "
                         f"{tuple(x.shape)}")
    return rows


def _launch(name, entry, out, *args):
    """Call ``entry`` of the library on ``args`` (tensors as pointers,
    ints as int64) and the stream; raise on a CUDA error, else count the
    launch and return ``out``."""
    from pagerank_tpu_torch.kernels import build

    lib = build.load("defect_fixtures")
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p if isinstance(a, torch.Tensor)
                   else ctypes.c_int64 for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    if rc != 0:
        lib.defect_fixtures_error_string.restype = ctypes.c_char_p
        lib.defect_fixtures_error_string.argtypes = [ctypes.c_int]
        msg = lib.defect_fixtures_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
    launches[name] += 1
    return out


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
    if x.device.type == "cpu":
        return vmem_overflow_reference(x)
    out = _nan(x.shape, x)
    return _launch("vmem_overflow", "fx_vmem_overflow", out, x, out,
                   x.shape[0])


def misaligned_tile(x):
    """F2: out = x over (100, 64) tiles, grid (rows/100, cols/64)."""
    _check("misaligned_tile", x)
    rows, cols = x.shape
    if rows % MIS_TILE[0] or cols % MIS_TILE[1] or rows == 0:
        raise ValueError(f"misaligned_tile: want x [k*100, m*64], got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return misaligned_tile_reference(x)
    out = _nan(x.shape, x)
    return _launch("misaligned_tile", "fx_misaligned_tile", out, x, out,
                   rows, cols)


def index_gap(x):
    """F3: x [k*8, 128] -> out [2k*8, 128], x tile i into out tile 2i;
    the odd out tiles stay NaN."""
    _check("index_gap", x)
    rows = _rows_of("index_gap", x, TILE[0])
    if x.device.type == "cpu":
        return index_gap_reference(x)
    out = _nan((2 * rows, LANES), x)
    return _launch("index_gap", "fx_index_gap", out, x, out, rows)


def index_overlap(x):
    """F4: x [k*16, 128] -> out [k*8, 128], x tile i into out tile
    i % 2 (the fixture: k = 2, two out tiles with two writers each). The
    plain version keeps the last writer; on the card each element holds
    one of its writers', in no order."""
    _check("index_overlap", x)
    rows = _rows_of("index_overlap", x, 2 * TILE[0])
    if x.device.type == "cpu":
        return index_overlap_reference(x)
    out = _nan((rows // 2, LANES), x)
    return _launch("index_overlap", "fx_index_overlap", out, x, out, rows)


def f64_scratch(x):
    """F5: out = x over (8, 128) tiles, beside an f64 shared scratch
    negated in place (its values never reach out)."""
    _check("f64_scratch", x)
    rows = _rows_of("f64_scratch", x, TILE[0])
    if x.device.type == "cpu":
        return f64_scratch_reference(x)
    out = _nan(x.shape, x)
    return _launch("f64_scratch", "fx_f64_scratch", out, x, out, rows)


def cost_mismatch(x, y):
    """F6: out = x @ y in f32; x [m, k] (m % 128 == 0, k % 32 == 0),
    y [k, 128]. The plain version is one f32 matmul."""
    _check("cost_mismatch", x, y)
    m, k = x.shape
    if m % LANES or m == 0 or k % 32 or k == 0 or y.shape != (k, LANES):
        raise ValueError(f"cost_mismatch: want x [128i, 32j] and y [32j, "
                         f"128], got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.device.type == "cpu":
        return cost_mismatch_reference(x, y)
    out = _nan((m, LANES), x)
    return _launch("cost_mismatch", "fx_cost_mismatch", out, x, y, out, m, k)


def last_error() -> int:
    """``cudaGetLastError()`` on the card now (0: no error is pending);
    shows that F1's refused launch left nothing for the next launch."""
    from pagerank_tpu_torch.kernels import build

    lib = build.load("defect_fixtures")
    lib.defect_fixtures_last_error.argtypes = []
    lib.defect_fixtures_last_error.restype = ctypes.c_int
    return lib.defect_fixtures_last_error()
