"""Elementwise reductions of the step.

Port of ``pagerank_tpu/ops/spmv.py:437`` (``dangling_mass``).
"""

from __future__ import annotations

import torch


def dangling_mass(r: torch.Tensor, dangling: torch.Tensor,
                  accum_dtype: torch.dtype) -> torch.Tensor:
    """m = Σ_dangling r — the reference's ``danglingContrib`` loop
    (Sparky.java:219-222) as one masked sum in ``accum_dtype``: a
    multiply + sum, never a dot, like the JAX op's 64-bit path."""
    return torch.sum(dangling.to(accum_dtype) * r.to(accum_dtype))
