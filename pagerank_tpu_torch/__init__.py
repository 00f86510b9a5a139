"""pagerank_tpu_torch — the PyTorch/CUDA port of pagerank_tpu.

The same PageRank job as the JAX package (the reference is
``Sparky.java``): read an edge list or an R-MAT graph, build it with the
reference semantics, pack it into blocked-ELL slot rows, run the power
iteration and write the ranks and per-iteration snapshots. Here the
step runs in PyTorch on an NVIDIA GPU, and its hot op, the contribution
SpMV, is a hand-written CUDA kernel (``csrc/ell_contrib.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(CLI: ``--device cpu``); without a card they raise. The package imports
torch, numpy and scipy, never jax or pagerank_tpu.

Layer map:
  L1 ingestion             -> ingest/ (integer edge lists)
  L2 graph construction    -> graph.py
  L3 iterative solver      -> models/, engines/, ops/ (+ csrc/, kernels/)
  L4 output/persistence    -> utils/snapshot.py, cli.py
"""

from pagerank_tpu_torch.graph import Graph, build_graph
from pagerank_tpu_torch.utils.config import PageRankConfig, RobustnessConfig
from pagerank_tpu_torch.engine import (
    PageRankEngine,
    SolverHealthError,
    make_engine,
)
from pagerank_tpu_torch.engines.cpu import ReferenceCpuEngine
from pagerank_tpu_torch.engines.torch_engine import TorchEngine

__all__ = [
    "Graph",
    "build_graph",
    "PageRankConfig",
    "RobustnessConfig",
    "PageRankEngine",
    "SolverHealthError",
    "make_engine",
    "ReferenceCpuEngine",
    "TorchEngine",
]
