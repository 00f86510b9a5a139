"""Graph ingestion of the port (integer edge lists; the crawl formats
come with ROADMAP slice 3)."""

from pagerank_tpu_torch.ingest.edgelist import (
    load_binary_edges,
    load_edgelist,
    load_edges_any,
)

__all__ = ["load_binary_edges", "load_edgelist", "load_edges_any"]
