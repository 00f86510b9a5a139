"""P1-P3: the gather probe's kernels, out = z[src]·w.

Replaces the Pallas forms of ``scripts/probe_gather.py:probe_pallas``
(bodies ``k_take``, ``k_onehot8``, ``k_taa``): the kernels are
``pagerank_tpu_torch/csrc/gather_probe.cu``, built for ``sm_90a`` at
first use (kernels/build.py) and called through ctypes. They compute
one function three ways, to measure what a random gather costs on the
card in each form:

- :func:`gather_take` (P1): a direct gather, ``z[src]``.
- :func:`gather_group8` (P2): the aligned group of 8 holding ``z[s]``,
  read whole, then lane ``s & 7`` selected in registers.
- :func:`gather_rowsel` (P3): z staged whole in shared memory, the
  gather served from there.

What bounds them on the H100: device-memory bytes
(``analysis/kernels.py:probe_cost``), but the random gathers of z keep
them off it: each pulls a 32-byte sector for 4 (or 2) useful bytes.

Inputs: z [n], src int32 [rows, 128], w [rows, 128]; z and w both
float32 or both bfloat16. Precondition: every src value lies in
[0, n) — the kernels do not check indices (the TPU forms clamped). The
product is taken in float32 and rounded to nearest even in bf16, as
torch's bf16 multiply does, so each kernel is bit-equal to its plain
version.

Each wrapper launches its kernel for CUDA tensors, or raises; it takes
its plain version only for tensors on the CPU. ``launches`` counts the
launches of each kernel by wrapper name.
"""

from __future__ import annotations

import ctypes

import torch

from pagerank_tpu_torch.obs import costs
from pagerank_tpu_torch.ops import LANES

#: Kernel launches made by each wrapper in this process.
launches = {"gather_take": 0, "gather_group8": 0, "gather_rowsel": 0}

#: Shared memory one block can use on the H100 (227 KB, the device
#: table's, which the PTK001 check reads too): the most of z that
#: :func:`gather_rowsel` can stage.
SMEM_LIMIT = costs.device_spec().smem_per_block

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# Bytes of one gathered intermediate of a plain version's row chunk.
_CHUNK_BYTES = 1 << 28


def rowsel_fits(n: int, dtype: torch.dtype) -> bool:
    """Whether z [n] of ``dtype`` fits one block's shared memory."""
    return n * dtype.itemsize <= SMEM_LIMIT


def _check(name, z, src, w):
    if z.dtype not in _DTYPES or w.dtype != z.dtype:
        raise TypeError(f"{name}: z and w must be both float32 or both "
                        f"bfloat16, got {z.dtype} and {w.dtype}")
    if src.dtype != torch.int32:
        raise TypeError(f"{name}: src must be int32, got {src.dtype}")
    if (z.dim() != 1 or src.dim() != 2 or src.shape[1] != LANES
            or w.shape != src.shape):
        raise ValueError(
            f"{name}: want z [n], src and w [rows, {LANES}], got "
            f"{tuple(z.shape)}, {tuple(src.shape)} and {tuple(w.shape)}")
    for arg, t in (("z", z), ("src", src), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.device != z.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, z on "
                             f"{z.device}")
    if z.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {z.device}")
    if z.device.type == "cuda":
        # The kernels move src as 16-byte and w as 16-byte (f32) or
        # 8-byte (bf16) vectors.
        for arg, t, align in (("src", src, 16), ("w", w, 4 * w.itemsize)):
            if t.data_ptr() % align:
                raise ValueError(f"{name}: {arg} must be {align}-byte "
                                 f"aligned on the card")


def gather_take(z, src, w):
    """P1: out = z[src] * w by a direct gather. See the module note."""
    _check("gather_take", z, src, w)
    if z.device.type == "cpu":
        return gather_take_reference(z, src, w)
    return _launch("gather_take", z, src, w)


def gather_group8(z, src, w):
    """P2: out = z[src] * w, each slot reading its aligned group of 8.
    Needs n % 8 == 0 and, on the card, z aligned to the group (32 bytes
    in f32, 16 in bf16)."""
    _check("gather_group8", z, src, w)
    if z.shape[0] % 8:
        raise ValueError(f"gather_group8: n = {z.shape[0]} is not a "
                         f"multiple of 8")
    if z.device.type == "cpu":
        return gather_group_reference(z, src, w, 8)
    align = 8 * z.itemsize
    if z.data_ptr() % align:
        raise ValueError(f"gather_group8: z must be {align}-byte aligned "
                         f"on the card (a sliced view can break that)")
    return _launch("gather_group8", z, src, w)


def gather_rowsel(z, src, w):
    """P3: out = z[src] * w, gathered from a copy of z in shared memory.
    Needs n % 128 == 0 (the TPU form's ``reshape(-1, 128)``) and
    n * itemsize <= SMEM_LIMIT (:func:`rowsel_fits`)."""
    _check("gather_rowsel", z, src, w)
    n = z.shape[0]
    if n % LANES:
        raise ValueError(f"gather_rowsel: n = {n} is not a multiple of "
                         f"{LANES}")
    if not rowsel_fits(n, z.dtype):
        raise ValueError(
            f"gather_rowsel: z [{n}] {z.dtype} takes {n * z.itemsize} bytes, "
            f"more than the {SMEM_LIMIT} bytes of shared memory a block can "
            f"use (n <= {SMEM_LIMIT // z.itemsize})")
    if z.device.type == "cpu":
        return gather_rowsel_reference(z, src, w)
    return _launch("gather_rowsel", z, src, w)


def _launch(name, z, src, w):
    out = torch.empty_like(w)
    if src.shape[0] == 0:
        return out
    from pagerank_tpu_torch.kernels import build

    lib = build.load("gather_probe")
    fn = getattr(lib, f"{name}_{_DTYPES[z.dtype]}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), z.shape[0], src.data_ptr(), w.data_ptr(),
                out.data_ptr(), src.shape[0], stream)
    if rc != 0:
        lib.gather_probe_error_string.restype = ctypes.c_char_p
        lib.gather_probe_error_string.argtypes = [ctypes.c_int]
        msg = lib.gather_probe_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
    launches[name] += 1
    return out


def _row_chunks(rows, width, itemsize):
    """Row ranges of a plain version's loop: the (chunk, 128, width)
    gather stays near 256 MB, so no intermediate passes ~1 GiB."""
    step = max(1, _CHUNK_BYTES // (LANES * width * itemsize))
    return ((r, min(r + step, rows)) for r in range(0, rows, step))


def gather_take_reference(z, src, w):
    """P1's plain version, and the torch form of the script's
    ``take1d``: ``z[src] * w``."""
    return z[src.long()] * w


def gather_group_reference(z, src, w, width=8):
    """P2's plain version (``k_onehot8``) at ``width`` 8, and the torch
    form of the script's ``onehot{8,16,32}``: the ``width``-row of
    ``z.view(-1, width)`` at ``src >> log2(width)``, a one-hot select of
    lane ``src & (width - 1)``, times w. Equal to ``z[src] * w`` for
    finite z. Needs n % width == 0."""
    shift = width.bit_length() - 1
    zw = z.view(-1, width)
    lanes = torch.arange(width, device=z.device)
    out = torch.empty_like(w)
    for a, b in _row_chunks(src.shape[0], width, z.itemsize):
        s = src[a:b]
        rows_g = zw[(s >> shift).long()]
        sel = ((s & (width - 1)).long()[..., None] == lanes).to(z.dtype)
        out[a:b] = (rows_g * sel).sum(-1) * w[a:b]
    return out


def gather_rowsel_reference(z, src, w):
    """P3's plain version (``k_taa``), and the torch form of the
    script's ``onehot128mxu``: the 128-row of ``z.view(-1, 128)`` at
    ``src >> 7``, then ``take_along_dim`` of lane ``src & 127``, times
    w. Needs n % 128 == 0."""
    zw = z.view(-1, LANES)
    out = torch.empty_like(w)
    for a, b in _row_chunks(src.shape[0], LANES, z.itemsize):
        s = src[a:b]
        rows_g = zw[(s >> 7).long()]
        out[a:b] = torch.take_along_dim(
            rows_g, (s & (LANES - 1)).long()[..., None], dim=-1)[..., 0] \
            * w[a:b]
    return out
