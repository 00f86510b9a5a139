"""Device plumbing of the port: the serving subset of
``pagerank_tpu/parallel/mesh.py`` and the error types of
``pagerank_tpu/parallel/elastic.py`` (more than one GPU is ROADMAP
slice 6)."""
