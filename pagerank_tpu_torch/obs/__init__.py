"""pagerank_tpu_torch.obs — the port's observability layer.

Port of ``pagerank_tpu/obs`` on one card, with the JAX package's
exports (``pagerank_tpu/obs/__init__.py``) except the compiler plane
(``obs/hlo.py``, no counterpart for hand-written kernels):

  - span tracing (``obs/trace.py``) and the metrics registry
    (``obs/metrics.py``);
  - the run report (``obs/report.py``);
  - the kernel cost ledger and the Hopper device table
    (``obs/costs.py``);
  - convergence probes (``obs/probes.py``), computed on the card in the
    step's own tail;
  - the live exporter and the stall watchdog (``obs/live.py``);
  - the device memory sampler and the OOM preflight
    (``obs/devices.py``);
  - the graph profile and the rank-mass ledger
    (``obs/graph_profile.py``);
  - the perf-history ledger (``obs/history.py``) and the measurement
    campaign over the port's bench (``obs/campaign.py``, loaded by
    ``obs campaign``);
  - :func:`profiler_session` over ``torch.profiler``
    (``obs/profiler.py``) and :mod:`obs.log`, the diagnostic channel.

Import cost: stdlib + numpy (torch is imported lazily inside the
functions that need it).
"""

from pagerank_tpu_torch.obs import costs, devices, graph_profile, history
from pagerank_tpu_torch.obs.devices import (
    DeviceSampler,
    arm_sampler,
    disarm_sampler,
    get_sampler,
)
from pagerank_tpu_torch.obs.live import (
    HistoryBaseline,
    MetricsExporter,
    StallWatchdog,
    arm_history_baseline,
    arm_watchdog,
    disarm_history_baseline,
    disarm_watchdog,
    get_history_baseline,
    get_watchdog,
    render_openmetrics,
    render_prometheus,
)
from pagerank_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from pagerank_tpu_torch.obs.probes import ConvergenceProbes
from pagerank_tpu_torch.obs.profiler import profiler_session
from pagerank_tpu_torch.obs.report import (
    build_run_report,
    diff_reports,
    environment_fingerprint,
    load_report,
    render_report,
    write_run_report,
)
from pagerank_tpu_torch.obs.trace import (
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    disable_tracing,
    enable_tracing,
    get_tracer,
    span,
)

__all__ = [
    "costs",
    "devices",
    "graph_profile",
    "history",
    "DeviceSampler",
    "arm_sampler",
    "disarm_sampler",
    "get_sampler",
    "HistoryBaseline",
    "MetricsExporter",
    "StallWatchdog",
    "arm_history_baseline",
    "arm_watchdog",
    "disarm_history_baseline",
    "disarm_watchdog",
    "get_history_baseline",
    "get_watchdog",
    "render_openmetrics",
    "render_prometheus",
    "ConvergenceProbes",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "profiler_session",
    "build_run_report",
    "diff_reports",
    "environment_fingerprint",
    "load_report",
    "render_report",
    "write_run_report",
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "Tracer",
    "disable_tracing",
    "enable_tracing",
    "get_tracer",
    "span",
]
