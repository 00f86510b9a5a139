"""Test-support subpackage: deterministic fault injection
(:mod:`pagerank_tpu_torch.testing.faults`) and seed-deterministic
interleaving replay (:mod:`pagerank_tpu_torch.testing.schedules`). Shipped
inside the package — not under tests/ — so downstream users can
chaos-test their own deployments against the same schedules
(docs/ROBUSTNESS.md, docs/ANALYSIS.md "Concurrency rules").

Copy of ``pagerank_tpu/testing/__init__.py``.
"""

from pagerank_tpu_torch.testing.faults import (  # noqa: F401
    FaultInjectedError,
    FaultInjectingFileSystem,
    FaultSchedule,
    HttpFaultInjector,
)
from pagerank_tpu_torch.testing.schedules import (  # noqa: F401
    DeadlockDetected,
    InterleavingScheduler,
    TrackedLock,
    VirtualClock,
)
