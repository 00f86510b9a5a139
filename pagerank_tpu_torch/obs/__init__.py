"""Observability of the port. Only the device table of
``pagerank_tpu/obs/costs.py`` is ported so far (``obs/costs.py``); the
tracer, metrics, reports and history come with slice 8."""
