"""PageRank update rules (port of ``pagerank_tpu/models``)."""
