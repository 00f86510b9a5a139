"""Measurement scripts of the port, run as modules
(``python -m pagerank_tpu_torch.scripts.<name>``)."""
