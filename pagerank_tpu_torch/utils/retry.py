"""Bounded retry with exponential backoff and full jitter (the
substrate half of the reference's fault story).

The reference inherits ALL of its fault tolerance from Spark — task
retry, lineage recovery, straggler re-execution (SURVEY.md §5); its own
code has none. This build replaced that substrate with direct I/O
(utils/fsio, utils/s3), so the retry discipline has to live here: a
:class:`RetryPolicy` owns the attempt budget, the backoff curve
(exponential, capped, FULL jitter — delay is uniform in ``[0, cap]``,
the AWS-recommended variant that decorrelates a thundering herd of
writers hitting a throttled store), an optional wall-clock deadline,
and the retryable-predicate. Every time source is injectable
(``clock``/``sleep``/``seed``) so tests run the whole schedule in
virtual time and a given seed reproduces the same jitter sequence
bit-for-bit (tests/test_faults.py).

Consumers: ``S3FileSystem._request`` (5xx / SlowDown / connection
reset / timeout), the snapshot sink guard
(utils/snapshot.SinkGuard / AsyncRankWriter), and anything else with a
transient failure mode. The full retry matrix — which errors retry
where — is the table in docs/ROBUSTNESS.md.

Copy of ``pagerank_tpu/utils/retry.py``.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from pagerank_tpu_torch.obs import trace as obs_trace


def default_retryable(exc: BaseException) -> bool:
    """Transient-I/O default: network/socket/timeout errors retry;
    *semantic* filesystem errors (missing key, existing file, permission)
    never do — retrying those only hides a real bug."""
    if isinstance(exc, (FileNotFoundError, FileExistsError, IsADirectoryError,
                        NotADirectoryError, PermissionError)):
        return False
    return isinstance(exc, (ConnectionError, TimeoutError, OSError))


@dataclass
class RetryStats:
    """Mutable counters a caller threads through :meth:`RetryPolicy.call`
    (the CLI surfaces them in the run summary)."""

    attempts: int = 0  # total call attempts (successes included)
    retries: int = 0   # re-attempts after a retryable failure
    slept: float = 0.0  # total backoff seconds requested

    def add(self, other: "RetryStats") -> None:
        self.attempts += other.attempts
        self.retries += other.retries
        self.slept += other.slept


@dataclass
class RetryPolicy:
    """Attempt budget + backoff curve for one class of transient failure.

    ``max_attempts`` counts TOTAL attempts (1 = no retry). The delay
    before re-attempt ``k`` (1-based failure count) is drawn uniformly
    from ``[0, min(max_delay, base_delay * 2**(k-1))]`` — full jitter.
    ``deadline`` (seconds, measured on ``clock``) bounds the whole
    sequence: a retry whose backoff would land past it re-raises
    instead. ``seed`` pins the jitter stream; ``clock``/``sleep`` are
    injectable so tests run in virtual time.
    """

    max_attempts: int = 5
    base_delay: float = 0.05
    max_delay: float = 2.0
    deadline: Optional[float] = None
    retryable: Callable[[BaseException], bool] = default_retryable
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    seed: Optional[int] = None
    _rng: random.Random = field(init=False, repr=False, compare=False,
                                default=None)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay < 0 or self.max_delay < 0:
            raise ValueError("backoff delays must be >= 0")
        self._rng = random.Random(self.seed)

    def backoff(self, failure: int) -> float:
        """Full-jitter delay before the retry that follows the
        ``failure``-th (1-based) failed attempt. Consumes the jitter
        stream — deterministic per ``seed``."""
        cap = min(self.max_delay, self.base_delay * (2 ** (failure - 1)))
        return self._rng.uniform(0.0, cap)

    def call(self, fn: Callable[[], object], *,
             stats: Optional[RetryStats] = None,
             on_retry: Optional[Callable[[int, float, BaseException], None]] = None,
             retryable: Optional[Callable[[BaseException], bool]] = None):
        """Run ``fn()`` under this policy; returns its result. The final
        failure re-raises the ORIGINAL exception (never a wrapper — the
        caller's except clauses keep working). ``on_retry(failure,
        delay, exc)`` fires before each backoff sleep."""
        is_retryable = retryable if retryable is not None else self.retryable
        # Tracer read once per call(): each attempt becomes a
        # ``retry/attempt`` span (with the failure count and backoff as
        # attributes) when tracing is on; the disabled path touches the
        # tracer zero times per attempt.
        tracer = obs_trace.get_tracer()
        traced = tracer.enabled
        start = self.clock()
        failures = 0
        while True:
            if stats is not None:
                stats.attempts += 1
            try:
                if traced:
                    with tracer.span("retry/attempt", attempt=failures + 1):
                        return fn()
                return fn()
            except BaseException as e:
                failures += 1
                if failures >= self.max_attempts or not is_retryable(e):
                    raise
                delay = self.backoff(failures)
                if (self.deadline is not None
                        and (self.clock() - start) + delay > self.deadline):
                    raise
                if on_retry is not None:
                    on_retry(failures, delay, e)
                if stats is not None:
                    stats.retries += 1
                    stats.slept += delay
                if traced:
                    tracer.add_event(
                        "retry/backoff", failure=failures,
                        delay_s=delay, error=type(e).__name__,
                    )
                self.sleep(delay)
