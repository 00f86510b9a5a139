"""Elementwise reductions of the step, the 3-byte slot words and the
pair -> block expansion of the partition-centric layout.

Port of ``pagerank_tpu/ops/spmv.py:437`` (``dangling_mass``),
``:178-198`` (``unpack_words24`` / ``pack_words24``) and ``:425-434``
(``scatter_block_sums``). The word and expansion helpers take numpy
arrays and torch tensors alike.
"""

from __future__ import annotations

import numpy as np
import torch

from pagerank_tpu_torch.ops import LANES


def dangling_mass(r: torch.Tensor, dangling: torch.Tensor,
                  accum_dtype: torch.dtype) -> torch.Tensor:
    """m = Σ_dangling r — the reference's ``danglingContrib`` loop
    (Sparky.java:219-222) as one masked sum in ``accum_dtype``: a
    multiply + sum, never a dot, like the JAX op's 64-bit path."""
    return torch.sum(dangling.to(accum_dtype) * r.to(accum_dtype))


def unpack_words24(slots8):
    """Decode a 3-byte PLANAR slot-word array — int8 [rows, 3*LANES]
    with byte plane k of slot (r, l) at column k*LANES + l — back to
    int32 [rows, LANES] words. Partition-local source ids fit 24 bits,
    so the per-slot stream is 3 bytes instead of 4; planar (not
    interleaved) so each byte plane is one contiguous 128-byte row."""
    if isinstance(slots8, torch.Tensor):
        b = slots8.to(torch.int32) & 0xFF  # int8 sign-extends; mask it off
    else:
        b = slots8.astype(np.int32) & 0xFF
    return b[..., :LANES] | (b[..., LANES:2 * LANES] << 8) \
        | (b[..., 2 * LANES:] << 16)


def pack_words24(words):
    """Inverse of :func:`unpack_words24`: int32 [rows, LANES] words
    < 2**24 to the int8 [rows, 3*LANES] planar form (bytes wrap into
    int8 two's complement, as numpy's ``astype(int8)`` does)."""
    planes = [words & 0xFF, (words >> 8) & 0xFF, (words >> 16) & 0xFF]
    if isinstance(words, torch.Tensor):
        return torch.cat(planes, dim=-1).to(torch.uint8).view(torch.int8)
    return np.concatenate(planes, axis=-1).astype(np.int8)


def scatter_block_sums(total, part, ids, is_prefix):
    """Add compact per-present-block sums ``part`` ([P, 128, ...]) into
    the global block array ``total`` ([num_blocks, 128, ...]) in place,
    and return it: a prefix-slice add when the present blocks are
    0..P-1, else an add at ``ids`` (sorted, unique). The ids being
    unique, each element of ``total`` receives at most one add, so on
    CUDA ``index_add_`` is deterministic: its atomics never race."""
    if is_prefix:
        total[: part.shape[0]] += part
    elif isinstance(total, torch.Tensor):
        total.index_add_(0, ids, part)
    else:
        total[ids] += part
    return total
