"""Static analysis of the port — the kernel plane.

Only the kernel plane of ``pagerank_tpu/analysis/`` is ported:
:mod:`pagerank_tpu_torch.analysis.kernels` checks every launch of the
port's hand-written CUDA kernels against the five PTK rules restated
for Hopper (shared memory, launch geometry, CTA coverage, f64
discipline, cost sanity) before the card runs it, and
:mod:`pagerank_tpu_torch.analysis.resources` reads the compiler's facts
(registers, shared and local memory, f64 instructions) from the built
libraries. The CLI is ``python -m pagerank_tpu_torch.analysis --select
PTK``. The AST lint (PTL), the concurrency pass (PTR) and the contracts
(PTC/PTH) wait for slice 8.
"""

from pagerank_tpu_torch.analysis.findings import (  # noqa: F401
    Finding,
    load_allowlist,
    split_allowlisted,
)
