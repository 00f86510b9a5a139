"""Seed-deterministic interleaving replay (the
concurrency rules).

The PTR static pass (analysis/concurrency.py) PROVES structural
discipline; this module lets tests *replay* the interleavings those
rules reason about, deterministically. The model is cooperative: each
concurrent actor (the solve loop, the rank-writer, the watchdog, a
signal delivery) is a GENERATOR that yields at its interaction points
— exactly the seams where the real threads interleave — and a seeded
scheduler picks which runnable actor advances next. Everything runs on
ONE real thread, so a schedule is a pure function of (seed, spawn
sequence): the same seed yields the same schedule bit-for-bit
(:attr:`InterleavingScheduler.log` — the testing/faults.py
reproducibility convention), and an "impossible" interleaving a stress
test might hit once a month is pinned as a one-seed regression.

Uses (tests/test_concurrency_analysis.py):

- **reproduce a fixed race**: the pre-fix ``GracefulDrain._handler``
  performed telemetry in signal context — delivered while the main
  thread held the tracer's lock, it re-acquired that lock on the same
  OS thread and self-deadlocked. :class:`TrackedLock` substitutes for
  the real lock and turns that re-acquisition into a loud
  :class:`DeadlockDetected` instead of a hung test; the fixed handler
  replays clean under the very same schedules.
- **demonstrate a waived race is benign**: the watchdog's
  ``rescue_requested`` handshake (a PTR001 allowlist entry) holds its
  invariants under every sampled schedule.

Virtual time rides the same discipline: :class:`VirtualClock` is an
injectable ``clock`` (the utils/retry.py idiom) the actors advance
explicitly, so timeout logic replays without wall-clock sleeps.

Copy of ``pagerank_tpu/testing/schedules.py``, ``rotation_actors``
(``:184-270``) included: the boundary double-buffer rotation of the
async halo form (``engines/torch_engine.py``: ``_stale_image``, the
slot swap, ``_prime_carry`` on ``set_ranks``/``restore_state``) across a
rescue's or a redo's state replacement.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Iterator, List, Optional, Tuple


class DeadlockDetected(RuntimeError):
    """A cooperative replay acquired a lock its own schedule already
    holds. Everything runs on one real thread, so the blocking acquire
    the real program would perform can never be released — the exact
    self-deadlock a signal handler risks when it takes a lock the
    interrupted main thread holds (PTR003)."""


class VirtualClock:
    """Monotonic virtual time, advanced explicitly by the replay —
    inject as the ``clock`` of any component built on the
    utils/retry.py idiom (watchdog, drain, retry policies)."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        self._t += float(dt)
        return self._t


class TrackedLock:
    """A non-blocking stand-in for a ``threading.Lock`` inside a
    cooperative replay. Acquiring while held raises
    :class:`DeadlockDetected` naming holder and acquirer — on the
    replay's single real thread a blocking acquire of a held lock
    could never return, and for the signal-handler scenario that IS
    the modelled bug, not an artifact. Every acquisition is logged as
    ``(actor, "acquire"|"release")`` for assertions about WHICH
    context touched the lock."""

    def __init__(self, name: str = "lock",
                 scheduler: Optional["InterleavingScheduler"] = None):
        self.name = name
        self.scheduler = scheduler
        self.holder: Optional[str] = None
        self.events: List[Tuple[str, str]] = []

    def _actor(self) -> str:
        if self.scheduler is not None and self.scheduler.current:
            return self.scheduler.current
        return "<unscheduled>"

    def acquire(self) -> bool:
        actor = self._actor()
        if self.holder is not None:
            raise DeadlockDetected(
                f"{actor} acquired lock '{self.name}' already held by "
                f"{self.holder}: on one OS thread this blocks forever "
                f"(the PTR003 signal-handler hazard)"
            )
        self.holder = actor
        self.events.append((actor, "acquire"))
        return True

    def release(self) -> None:
        self.events.append((self._actor(), "release"))
        self.holder = None

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def acquirers(self) -> List[str]:
        return [actor for actor, ev in self.events if ev == "acquire"]


Task = Iterator  # an actor: a generator yielding at interaction points


class InterleavingScheduler:
    """Seeded cooperative scheduler over generator actors.

    ``spawn(name, gen)`` registers an actor; ``run()`` repeatedly picks
    a runnable actor with the seeded RNG and advances it to its next
    ``yield``. The yielded value (any str, e.g. ``"in-span"``) labels
    the point in :attr:`log` as ``(step, actor, label)`` — the
    bit-for-bit reproducibility record (same seed + same spawn sequence
    => identical log; the testing/faults.py convention). An exception
    raised by an actor aborts the run and propagates to the caller —
    a replayed deadlock/violation must fail the test loudly."""

    def __init__(self, seed: int = 0,
                 clock: Optional[VirtualClock] = None):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self.clock = clock if clock is not None else VirtualClock()
        self._tasks: Dict[str, Task] = {}
        self._order: List[str] = []
        self.current: Optional[str] = None
        self.steps = 0
        #: (step, actor, label) per scheduling decision — the record
        #: two same-seed runs must reproduce bit-for-bit.
        self.log: List[Tuple[int, str, str]] = []

    def spawn(self, name: str, gen: Task) -> None:
        if name in self._tasks:
            raise ValueError(f"duplicate actor name {name!r}")
        self._tasks[name] = gen
        self._order.append(name)

    def run(self, max_steps: int = 100_000) -> List[Tuple[int, str, str]]:
        runnable = list(self._order)
        while runnable:
            self.steps += 1
            if self.steps > max_steps:
                raise RuntimeError(
                    f"schedule exceeded {max_steps} steps (livelocked "
                    f"actors?)"
                )
            name = runnable[self._rng.randrange(len(runnable))]
            self.current = name
            try:
                label = next(self._tasks[name])
            except StopIteration:
                runnable.remove(name)
                self.log.append((self.steps, name, "<done>"))
                continue
            finally:
                self.current = None
            self.log.append((self.steps, name, str(label)))
        return self.log


def replay(seed: int,
           build: Callable[["InterleavingScheduler"], None],
           max_steps: int = 100_000) -> InterleavingScheduler:
    """One seeded replay: construct a scheduler, let ``build`` spawn
    the actors against it (and wire TrackedLocks/VirtualClocks), run to
    completion, return the scheduler for log/invariant assertions."""
    sched = InterleavingScheduler(seed=seed)
    build(sched)
    sched.run(max_steps=max_steps)
    return sched


def rotation_actors(sched: InterleavingScheduler, *, steps: int = 6,
                    lag_cap: int = 1, prime_on_restore: bool = True,
                    rescue_after: Optional[int] = None,
                    reader_polls: int = 8) -> dict:
    """Spawn the boundary double-buffer ROTATION-PROTOCOL
    actors and return their shared state for invariant assertions.

    Models the host-side state the async halo engine rotates per step
    (engines/torch_engine.py): ``r`` is the version of the adopted rank
    plane, ``buf`` the rank version whose boundary the stale buffer
    holds. The protocol under test:

    - **adopt order**: the step assigns the rank plane FIRST
      and the carry (buffer) second, so a concurrent reader (watchdog
      telemetry, a signal-context probe) can never observe a buffer
      NEWER than the ranks (``buf <= r`` always). Mid-adoption a reader
      may transiently see lag ``2`` — benign, because nothing CONSUMES
      the buffer between the two assignments; only the solve loop
      consumes, and only at a step boundary.
    - **consumed-lag bound**: every step's boundary read lags the rank
      plane by at most ``lag_cap`` (= config.stale_max_lag).
    - **prime on state replacement**: a rescue/restore that replaces
      the rank plane must re-prime the buffer from the NEW ranks
      (engines' ``_prime_carry``), or the next step consumes a boundary
      of unbounded staleness. ``prime_on_restore=False`` is the
      booby-trapped protocol — tests assert it RECORDS a violation
      under the same seeds the honest protocol survives.

    The rescue rides the watchdog's ``rescue_requested`` handshake
    (the PTR001-allowlisted flag idiom): the watchdog actor only SETS
    the flag; the solve actor notices it at its own step boundary and
    performs the restore itself — mutation stays on one logical
    context, exactly the discipline the PTR pass certifies.

    Violations are RECORDED into ``state["violations"]`` rather than
    raised, so a test can assert the honest protocol yields none while
    the booby trap yields some, over the same seed set."""
    state: Dict[str, object] = {
        "r": 0, "buf": 0, "restores": 0,
        "violations": [], "observed": [],
    }

    def solver() -> Task:
        for _ in range(steps):
            if state.pop("rescue_requested", False):
                # Replacement ranks adopted (restore_state/set_ranks):
                # a version far from the buffer's, so a missing prime
                # is unmistakably a staleness violation.
                state["r"] = int(state["r"]) + 100
                yield "restore-r"
                if prime_on_restore:
                    state["buf"] = state["r"]
                    yield "restore-prime"
                state["restores"] = int(state["restores"]) + 1
            lag = int(state["r"]) - int(state["buf"])
            if not (0 <= lag <= lag_cap):
                state["violations"].append(
                    ("solver", "consumed-lag", lag)
                )
            yield f"consume:lag{lag}"
            cur = int(state["r"])
            state["r"] = cur + 1        # rank plane adopted FIRST...
            yield "adopt-r"
            state["buf"] = cur          # ...then the boundary carry
            yield "adopt-buf"

    def watchdog() -> Task:
        if rescue_after is None:
            return
        for _ in range(rescue_after):
            yield "tick"
        state["rescue_requested"] = True
        yield "request-rescue"

    def reader() -> Task:
        for _ in range(reader_polls):
            r, b = int(state["r"]), int(state["buf"])
            state["observed"].append((r, b))
            if b > r:
                state["violations"].append(("reader", "buf-ahead", r, b))
            yield "poll"

    sched.spawn("solver", solver())
    if rescue_after is not None:
        sched.spawn("watchdog", watchdog())
    sched.spawn("reader", reader())
    return state
