"""The COO contribution sum, elementwise reductions of the step, the
3-byte slot words and the pair -> block expansion of the
partition-centric layout.

Port of ``pagerank_tpu/ops/spmv.py:25-49``
(``edge_contrib_segment_sum``, the ``kernel="coo"`` form), ``:437``
(``dangling_mass``; its 2-D PPR batch form is K1w's dangling block
and :func:`fold_rows`),
``:178-198``
(``unpack_words24`` / ``pack_words24``) and ``:425-434``
(``scatter_block_sums``). The word and expansion helpers take numpy
arrays and torch tensors alike.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pagerank_tpu_torch.ops import LANES


def edge_contrib_segment_sum(r: torch.Tensor, src: torch.Tensor,
                             lengths: torch.Tensor, w: torch.Tensor,
                             accum_dtype: Optional[torch.dtype] = None
                             ) -> torch.Tensor:
    """contrib = Aᵀ_norm r over a dst-sorted COO edge list.

    Args:
      r: [n] rank vector, or [n, k] for a batch of columns.
      src: int64 [e] edge sources, the edges sorted by dst.
      lengths: int64 [n] edges per dst (the in-degree of the edge list;
        ``sum(lengths) == e``): the dst of edge i is implied by the
        sorted order, so no dst array is read.
      w: [e] per-edge weight 1/out_degree[src].
      accum_dtype: the products' and sums' dtype; default r's.

    Returns:
      [n] (or [n, k]) sums in ``accum_dtype``. Each dst's in-edges are
      summed by ``torch.segment_reduce`` in a fixed order — not by
      ``index_add_``, whose CUDA atomics add in no set order — so a run
      repeats itself bit for bit on the card, as a resumed run must.
    """
    acc = accum_dtype or r.dtype
    wa = w.to(acc)
    vals = r[src].to(acc) * (wa[:, None] if r.dim() == 2 else wa)
    if vals.shape[0] == 0:  # segment_reduce needs data; no edges sum to 0
        return torch.zeros((lengths.shape[0],) + tuple(r.shape[1:]),
                           dtype=acc, device=r.device)
    return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0)


def dangling_mass(r: torch.Tensor, dangling: torch.Tensor,
                  accum_dtype: torch.dtype) -> torch.Tensor:
    """m = Σ_dangling r — the reference's ``danglingContrib`` loop
    (Sparky.java:219-222) as one masked sum in ``accum_dtype``: a
    multiply + sum, never a dot, like the JAX op's 64-bit path."""
    return torch.sum(dangling.to(accum_dtype) * r.to(accum_dtype))


def fold_rows(x: torch.Tensor) -> torch.Tensor:
    """[m, ...] -> [...]: the rows summed by a fixed pairwise fold, row
    i plus row i + h, halving, in elementwise adds. An elementwise add
    is exact IEEE whatever the tensor's shape, so each column's sum is
    the same bits alone or in any batch (a reduction kernel picks its
    order by the shape). The JAX op's 2-D (PPR batch) mass form sums
    the dangling rows this way in the port (``engines/ppr.py``)."""
    while x.shape[0] > 1:
        m = x.shape[0]
        h = (m + 1) // 2
        y = torch.empty((h,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
        torch.add(x[: m - h], x[h:], out=y[: m - h])
        y[m - h:] = x[m - h: h]  # the middle row of an odd count
        x = y
    return x[0] if x.shape[0] else x.new_zeros(x.shape[1:])


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
