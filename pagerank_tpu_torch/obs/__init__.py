"""Observability of the port: the Hopper device table
(``obs/costs.py``, from ``pagerank_tpu/obs/costs.py``), and for the
serving layer copies of the tracer (``obs/trace.py``), the metrics
registry (``obs/metrics.py``) and the diagnostic channel
(``obs/log.py``). Reports, the live exporter, history, probes and the
rest come with ROADMAP slice 8."""
