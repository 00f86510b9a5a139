"""Production PPR serving: a deadline-honest query daemon.

Copy of ``pagerank_tpu/serving/__init__.py``. The serving layer turns
:class:`~pagerank_tpu_torch.engines.ppr.PprTorchEngine` into a resident
query path: one engine warmed at the serving shapes over a resident
graph, a bounded admission queue with dynamic micro-batching,
per-query deadlines with predictive load shedding, an LRU result cache,
and on-device top-k so only ``[batch, k]`` ever leaves the chip.

The robustness spine maps every failure mode the repo defends against
offline to a *typed, bounded, observable* outcome for an in-flight
query (docs/ROBUSTNESS.md "Serving"):

- overload        -> typed :class:`Overloaded` rejection with a
                     retry-after hint, decided AT ADMISSION (never
                     accept work that cannot finish);
- device loss / SDC quarantine -> the elastic rescue: rebuild onto
                     the survivors and RE-RUN the in-flight batch
                     (counted, never silently dropped; on one card
                     nothing survives and the error leaves the
                     dispatch);
- SIGTERM         -> the drain: admission closes with typed
                     :class:`Draining` rejections, in-flight batches
                     finish inside the drain deadline, exit 75;
- stuck dispatch  -> bounded by ``mesh.run_with_deadline``; the batch
                     fails typed (:class:`QueryDeadlineExceeded`)
                     instead of hanging the queue.

Telemetry: ``serve.*`` counters/gauges and the ``serve.latency_ms``
histogram in the metrics registry (``obs/metrics.py``; the exporter is
ROADMAP slice 8).

The **query plane** (:mod:`pagerank_tpu_torch.serving.qtrace`) is
the serving-side observability sibling: one cross-thread trace per
query (W3C ``traceparent`` in/out over HTTP), exemplar trace ids on the
latency histogram's tail buckets, a slow-query JSONL log, and a
flight-recorder ring dumped into the run report on drain/rescue/crash.
It is DISARMED by default — the hot admission/dispatch path then makes
zero tracer or exemplar calls.
"""

from pagerank_tpu_torch.serving.admission import (
    AdmissionQueue,
    BatchWallModel,
    ClosedBatch,
)
from pagerank_tpu_torch.serving.cache import ResultCache
from pagerank_tpu_torch.serving.daemon import PprServer, ServeConfig
from pagerank_tpu_torch.serving.http import QueryIngress
from pagerank_tpu_torch.serving.qtrace import (
    QueryPlane,
    QueryTrace,
    arm_query_plane,
    disarm_query_plane,
    get_query_plane,
)
from pagerank_tpu_torch.serving.query import (
    Draining,
    Overloaded,
    PendingQuery,
    QueryDeadlineExceeded,
    ServeRejected,
)

__all__ = [
    "AdmissionQueue",
    "BatchWallModel",
    "ClosedBatch",
    "Draining",
    "Overloaded",
    "PendingQuery",
    "PprServer",
    "QueryDeadlineExceeded",
    "QueryIngress",
    "QueryPlane",
    "QueryTrace",
    "ResultCache",
    "ServeConfig",
    "ServeRejected",
    "arm_query_plane",
    "disarm_query_plane",
    "get_query_plane",
]
