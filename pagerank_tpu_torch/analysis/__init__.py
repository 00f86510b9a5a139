"""Static analysis of the port: the AST lint, the concurrency pass and
the kernel plane.

:mod:`pagerank_tpu_torch.analysis.lint` (PTL) and
:mod:`pagerank_tpu_torch.analysis.concurrency` (PTR) are the JAX
package's passes over the port's source, with
:mod:`pagerank_tpu_torch.analysis.roots` the handler-ownership table
both read. :mod:`pagerank_tpu_torch.analysis.kernels` (PTK) checks
every launch of the port's hand-written CUDA kernels against the five
PTK rules restated for Hopper (shared memory, launch geometry, CTA
coverage, f64 discipline, cost sanity) before the card runs it, and
:mod:`pagerank_tpu_torch.analysis.resources` reads the compiler's facts
(registers, shared and local memory, f64 instructions) from the built
libraries. The CLI is ``python -m pagerank_tpu_torch.analysis``. The
jaxpr and HLO contracts (PTC, PTH) do not apply (ROADMAP.md).
"""

from pagerank_tpu_torch.analysis.findings import (  # noqa: F401
    Finding,
    load_allowlist,
    split_allowlisted,
)
