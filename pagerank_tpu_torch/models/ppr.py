"""Personalized PageRank (BASELINE.md config 5).

Copy of ``pagerank_tpu/models/ppr.py``; the update takes torch tensors
(``xp=torch``) or numpy arrays (``xp=np``, the f64 oracle) alike.

The reference computes only global PageRank; PPR is the natural model
extension the north star asks for: a *batch* of source-personalized rank
vectors, so the per-iteration SpMV becomes an SpMM (rank matrix [n, k])
— exactly the arithmetic-intensity upgrade TPUs want (more FLOPs per
byte of edge data).

Update (textbook formulation, batch columns independent):

    R' = (1-d) P + d (Aᵀ_norm R + dangling_redistribution)

where P[:, j] is the personalization distribution of source j (one-hot
e_{s_j} here) and dangling mass is redistributed either to the
personalization vector (standard PPR; keeps each column a probability
distribution) or uniformly.
"""

from __future__ import annotations


DANGLING_TO_SOURCE = "source"
DANGLING_TO_UNIFORM = "uniform"


def apply_ppr_update(contrib, p_onehot, dangling_mass, n, damping, dangling_to, xp):
    """One batched PPR update.

    Args:
      contrib: [n, k] — Aᵀ_norm R.
      p_onehot: [n, k] personalization distributions (columns sum to 1).
      dangling_mass: [k] — per-column Σ_dangling R.
      dangling_to: "source" (mass re-enters via P) or "uniform" (/n).
    """
    if dangling_to == DANGLING_TO_SOURCE:
        redistributed = contrib + p_onehot * dangling_mass[None, :]
    elif dangling_to == DANGLING_TO_UNIFORM:
        redistributed = contrib + dangling_mass[None, :] / n
    else:
        raise ValueError(f"unknown dangling_to: {dangling_to!r}")
    return (1.0 - damping) * p_onehot + damping * redistributed
