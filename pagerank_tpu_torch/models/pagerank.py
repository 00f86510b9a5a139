"""The PageRank update rules on torch tensors.

Port of ``pagerank_tpu/models/pagerank.py`` (SURVEY.md §2a has the two
semantics modes).

**reference** — what ``Sparky.java``'s local-mode run computes:
    r0 = 1
    r' = 0.15 + d * (Aᵀ_norm r  +  z ⊙ r  +  (mᵀ r)/N · 1)
  with z = (in_degree == 0) (the ``subtractByKey`` retention) and m the
  post-repair dangling set. Ranks sum to about N.

**textbook** — standard normalized PageRank:
    r0 = 1/N
    r' = (1-d)/N + d * (Aᵀ_norm r + (mᵀ r)/N · 1)
"""

from __future__ import annotations

import torch


def apply_update(contrib_sum, r_old, zero_in_mask, dangling_mass, n, damping,
                 semantics):
    """Combine the per-vertex contribution sum into the next rank vector.

    Args:
      contrib_sum: [n] tensor — Aᵀ_norm r.
      r_old: previous rank vector, same shape.
      zero_in_mask: [n] float mask, 1.0 where in_degree == 0.
      dangling_mass: scalar tensor (or float) — Σ_dangling r_old.
      n: vertex count.
      damping: d in (0,1).
      semantics: "reference" | "textbook".
    """
    if semantics == "reference":
        s = contrib_sum + zero_in_mask * r_old
        return (1.0 - damping) + damping * (s + dangling_mass / n)
    if semantics == "textbook":
        return (1.0 - damping) / n + damping * (contrib_sum + dangling_mass / n)
    raise ValueError(f"unknown semantics: {semantics!r}")


def initial_rank(n, semantics, dtype, device="cpu"):
    """r0 = 1.0 per vertex in reference mode (Sparky.java:165-170); 1/N
    in textbook mode."""
    v = 1.0 if semantics == "reference" else 1.0 / n
    return torch.full((n,), v, dtype=dtype, device=device)
