"""Elastic multi-device solve: a port of
``pagerank_tpu/parallel/elastic.py`` — the error types (``:55-110``),
``DeviceHealthMonitor`` (``:112-218``, its clock injectable) and
``ElasticRunner`` (``:221-487``) — over the port's process groups.

The JAX runner lives in one controller over N devices: a rescue builds
a new engine over fewer devices in the same process. Here one process
drives each rank (``parallel/distributed.py``, ``parallel/mesh.py``),
so a rescue is done by every surviving process together:

  1. detect — as in JAX: a :class:`DeviceLostError`, a backend error
     for which :func:`looks_like_device_loss` holds (gloo's and NCCL's
     strings of a peer that has gone are among the markers), or a
     stall-watchdog fire whose ``consume_rescue()`` holds;
  2. classify across ranks — a rank cannot probe another rank's card,
     so the group's form of ``probe_liveness`` is a ROLL CALL
     (``distributed.roll_call``): the rank tears its group down first
     (``distributed.abandon_group``: a peer still blocked in a
     collective with it then raises and joins), echoes its own device,
     and posts itself in the launcher's store under this generation; a
     member that did not post within ``liveness_timeout_s`` is dead,
     and so is each id an error carried. Every survivor adopts the
     one verdict the first decider published;
  3. leave and regroup — a rank that finds itself in the verdict raises
     :class:`RankLeftError` (its process ends); the others form the
     next generation's group of ``len(survivors)`` ranks, numbered in
     the order of their original member ids (``distributed.regroup``;
     a survivor on a card keeps its card);
  4. rebuild — ``engine_factory(survivors)`` builds a fresh engine from
     the host graph at the new world size (halo plan rebuilt,
     vs_bounded dealt again; the new group's rank 0 owns the outputs);
  5. warm-start — the deadline-bounded scan of ``:338-400`` as it is,
     then (over a group) the ranks agree on the newest iteration every
     one of them found, so that none resumes alone; nothing agreed
     restarts from r0 (``elastic.restarts``). Snapshots hold the
     canonical host-order vector, so they restore at any world size;
  6. bound — ``rescue_budget()``; past it, or with nothing left to
     rescue onto (a group of one losing its device), every remaining
     process raises :class:`ElasticExhaustedError` with all lost ids.

Without a group (one device), the runner wraps the plain run as in JAX:
a loss there is terminal. Each rescue's wall, by part (roll call,
regroup, rebuild, warm start), is kept in ``rescue_walls``.

Stragglers are not rescued: a slow step that completes is telemetry
(:class:`DeviceHealthMonitor`), never a teardown.

Everything is testable on the CPU: ``testing/faults.DeviceFaultSchedule``
(keyed on member ids; every rank consults the same seeded schedule)
kills, delays, poisons and flips through a shim over the engine's step,
and a spawned gloo group (``spawn_group(..., rescue=True)``) runs the
whole detect -> roll call -> regroup -> rebuild -> warm-start path.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from pagerank_tpu_torch.obs import live as obs_live
from pagerank_tpu_torch.obs import log as obs_log
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.obs import trace as obs_trace
from pagerank_tpu_torch.parallel import distributed
from pagerank_tpu_torch.parallel import mesh as mesh_lib


class DeviceLostError(RuntimeError):
    """A mesh device is gone (preempted, detached, or wedged past the
    liveness deadline). Carries the lost device ids so the rescue path
    can rebuild over the survivors. Raised by the fault-injection shim
    on CPU and mapped from backend runtime errors (confirmed by a
    liveness probe) on real hardware."""

    def __init__(self, message: str, device_ids: Sequence[int] = ()):
        super().__init__(message)
        self.device_ids = tuple(device_ids)


class DeviceQuarantinedError(DeviceLostError):
    """A device is ALIVE but LYING: the SDC plane (``pagerank_tpu/sdc.py``)
    convicted it of sticky silent data corruption — repeat
    ABFT-invariant breaches across a clean-state re-execution, both
    attributing to the same chip. The rescue path treats the carried
    ids as lost (teardown -> re-shard over the remaining devices) even
    though every liveness probe answers, and records them in
    ``ElasticRunner.quarantined_device_ids`` (the ``on_quarantine``
    hook fires for runner-side consumers). Durable persistence
    (job.json) happens AT conviction time via the sdc quarantine hook
    — before this error even raises — so a resumed job never
    re-adopts a known-bad chip."""


class RankLeftError(DeviceLostError):
    """This process's member was declared lost by the group's roll call
    (killed by the fault shim, convicted by the SDC plane, or late past
    the roll call's deadline): it leaves the solve and its process
    ends, while the survivors regroup without it."""


class ElasticExhaustedError(RuntimeError):
    """The rescue budget is spent (or no devices survive). Carries the
    full casualty list and the rescue count — the 3am-page diagnostic,
    same contract as engine.SolverHealthError."""

    def __init__(self, message: str, lost_device_ids: Sequence[int],
                 rescues: int):
        super().__init__(message)
        self.lost_device_ids = tuple(lost_device_ids)
        self.rescues = rescues


# Substrings that mark a backend runtime error as PLAUSIBLY a device
# loss (worth a liveness probe before rescuing). Deliberately narrow:
# an unrelated XLA error must re-raise, not trigger a teardown.
_DEVICE_LOSS_MARKERS = (
    "device_lost", "device lost", "deadline_exceeded", "data_loss",
    "failed to connect", "socket closed", "unavailable",
    "device or resource busy", "halted", "preempt",
    # CUDA runtime strings (cudaGetErrorString, as the kernel wrappers
    # and torch report them) of a card that is gone or failing.
    "gpu is lost", "fallen off the bus", "uncorrectable ecc error",
    "uncorrectable nvlink error", "no cuda-capable device is detected",
    "launch timed out", "unspecified launch failure",
    "cuda-capable device(s) is/are busy",
    # gloo's strings of a collective whose peer process has gone (its
    # sockets closed or reset) or is wedged past the group's timeout,
    # and NCCL's remote-error and aborted-communicator strings.
    "connection closed by peer", "connection reset by peer",
    "for recv operation to complete", "for send operation to complete",
    "ncclremoteerror", "remote process exiting prematurely",
    "communicator was aborted",
)


def looks_like_device_loss(exc: BaseException) -> bool:
    """Whether a step failure is worth a liveness probe (vs a plain
    programming/numerics error that must surface unchanged)."""
    if isinstance(exc, DeviceLostError):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _DEVICE_LOSS_MARKERS)


def snapshot_meta_after(engine, runner=None) -> Dict[str, object]:
    """The snapshot ``mesh_meta`` of a (rebuilt) engine, with the
    runner's quarantined members as ``quarantined_devices`` — what the
    JAX CLI's rebind writes (``pagerank_tpu/cli.py:2110-2118``)."""
    meta = engine.snapshot_meta()
    if runner is not None and runner.quarantined_device_ids:
        meta["quarantined_devices"] = sorted(runner.quarantined_device_ids)
    return meta


class DeviceHealthMonitor:
    """Per-step health telemetry: straggler detection by step-time
    skew. A step that takes more than ``straggler_factor`` times the
    EWMA of previous steps — but COMPLETES — is a slow step, not a
    stall: it increments ``elastic.slow_steps``, publishes the skew in
    the ``elastic.straggler_skew`` gauge (the live exporter picks both
    up), and logs once per episode. Per-device attribution, when the
    caller has it (the fault shim does), lands in
    ``elastic.device_skew`` as max/median across devices.

    ``clock`` is injectable (utils/retry.py discipline) so tests drive
    step timing in virtual time."""

    def __init__(self, straggler_factor: float = 4.0, warmup_steps: int = 2,
                 ewma_alpha: float = 0.3,
                 clock: Callable[[], float] = time.monotonic):
        if straggler_factor <= 1.0:
            raise ValueError(
                f"straggler_factor must be > 1, got {straggler_factor}"
            )
        self.straggler_factor = float(straggler_factor)
        self.warmup_steps = int(warmup_steps)
        self.ewma_alpha = float(ewma_alpha)
        self.clock = clock
        self._ewma: Optional[float] = None
        self._steps = 0
        self._t_last: Optional[float] = None
        self.slow_steps = 0
        self.last_skew: Optional[float] = None
        # Eager registration: a HEALTHY sharded solve still exposes the
        # elastic instruments through the exporter — a dashboard keyed
        # on elastic_straggler_skew reads the 1.0 no-skew baseline, not
        # a missing series, until the first slow step overwrites it.
        obs_metrics.counter(
            "elastic.slow_steps",
            "steps slower than straggler_factor x the step-time "
            "EWMA (completed — telemetry only, never a rescue)",
        )
        g = obs_metrics.gauge(
            "elastic.straggler_skew",
            "latest slow step's wall / step-time EWMA",
        )
        if g.value is None:
            g.set(1.0)

    def reset(self) -> None:
        """Re-baseline after a rescue: the fresh engine's first steps
        pay build and warm-up wall that must not read as stragglers,
        and the degraded mesh's steady-state step time is legitimately
        different."""
        self._ewma = None
        self._steps = 0
        self._t_last = None

    def begin_step(self) -> None:
        self._t_last = self.clock()

    def end_step(self, iteration: int) -> None:
        """Record one completed step's wall (measured on ``clock``
        since :meth:`begin_step`); flags it slow AFTER the warmup once
        it exceeds ``straggler_factor`` x the EWMA."""
        if self._t_last is None:
            return
        dt = self.clock() - self._t_last
        self._t_last = None
        self._steps += 1
        if self._ewma is not None and self._steps > self.warmup_steps:
            skew = dt / max(self._ewma, 1e-12)
            if skew > self.straggler_factor:
                self.slow_steps += 1
                self.last_skew = skew
                obs_metrics.counter(
                    "elastic.slow_steps",
                    "steps slower than straggler_factor x the step-time "
                    "EWMA (completed — telemetry only, never a rescue)",
                ).inc()
                obs_metrics.gauge(
                    "elastic.straggler_skew",
                    "latest slow step's wall / step-time EWMA",
                ).set(float(skew))
                obs_log.warn(
                    f"slow step at iteration {iteration}: {dt:.3f}s is "
                    f"{skew:.1f}x the {self._ewma:.3f}s EWMA "
                    f"(straggler telemetry; not a stall, not rescued)"
                )
                return  # a straggler must not poison the EWMA baseline
        self._ewma = (
            dt if self._ewma is None
            else (1 - self.ewma_alpha) * self._ewma + self.ewma_alpha * dt
        )

    def record_device_times(self, iteration: int,
                            device_seconds: Dict[int, float]) -> None:
        """Optional per-device step walls (fault shim): publishes
        max/median skew across devices."""
        if not device_seconds:
            return
        vals = sorted(device_seconds.values())
        med = vals[len(vals) // 2]
        skew = vals[-1] / max(med, 1e-12)
        obs_metrics.gauge(
            "elastic.device_skew",
            "max/median per-device step wall at the latest measured "
            "iteration",
        ).set(float(skew))


class ElasticRunner:
    """The rescue loop around ``engine.run``.

    ``engine_factory(members)`` must build a FRESH engine over exactly
    ``members`` (the surviving member ids; over a group, called on every
    survivor after the regroup, so the new engine's mesh is the new
    group). ``snapshotter`` is both the per-iteration sink's Snapshotter
    and the warm-start source after a rescue. ``liveness(members,
    timeout_s) -> {member: alive}`` is injectable (the fault shim's
    :meth:`~pagerank_tpu_torch.testing.faults.DeviceFaultSchedule.
    liveness_probe` on fake meshes); without it a group classifies by
    the roll call and one device by ``mesh.probe_liveness``.

    ``on_rebuild(engine)`` fires after every rescue with the fresh
    engine — the hook tests use to re-install the fault shim and the
    CLI uses to rebind sinks and the snapshot ``mesh_meta``.
    """

    def __init__(
        self,
        engine,
        engine_factory: Callable[[Sequence[int]], object],
        snapshotter=None,
        *,
        max_rescues: int = 3,
        liveness: Optional[Callable[..., Dict[int, bool]]] = None,
        liveness_timeout_s: float = 5.0,
        resume_timeout_s: float = 60.0,
        monitor: Optional[DeviceHealthMonitor] = None,
        on_rebuild: Optional[Callable[[object], None]] = None,
        exclude_device_ids: Sequence[int] = (),
        on_quarantine: Optional[Callable[[Sequence[int]], None]] = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.engine = engine
        self._factory = engine_factory
        self._snap = snapshotter
        self.max_rescues = int(max_rescues)
        self._liveness = liveness
        self._liveness_timeout_s = float(liveness_timeout_s)
        self._resume_timeout_s = float(resume_timeout_s)
        self.monitor = monitor
        self._on_rebuild = on_rebuild
        self._on_quarantine = on_quarantine
        self._clock = clock
        self.rescues = 0
        self.restarts = 0  # rescues that found no snapshot (iteration 0)
        self.lost_device_ids: List[int] = []
        # Members a rescue must NEVER rebuild over: the persisted
        # quarantine list — known-bad chips from prior runs. Kept
        # SEPARATE from lost_device_ids (this run's casualties); the
        # two lists merge only where the next mesh is chosen.
        self.excluded_device_ids: List[int] = [
            int(d) for d in exclude_device_ids
        ]
        #: Members convicted of sticky SDC THIS run (a subset of
        #: lost_device_ids once their rescue fires).
        self.quarantined_device_ids: List[int] = []
        #: One record a rescue: seconds of its roll call, regroup,
        #: rebuild and warm start, and the world before and after.
        self.rescue_walls: List[Dict[str, float]] = []
        self._walls: Dict[str, float] = {}
        mesh = self._mesh()
        if (liveness is None and mesh is not None and mesh.collective
                and distributed.launcher_store() is None):
            raise ValueError(
                "an elastic rescue over a group of more than one rank needs "
                "the launcher's store: start the ranks with "
                "parallel.distributed.spawn_group(..., rescue=True)")
        obs_metrics.gauge(
            "elastic.mesh_devices", "devices in the current solve mesh"
        ).set(self._ndev())

    def _mesh(self):
        return getattr(self.engine, "mesh", None)

    def _ndev(self) -> int:
        mesh = self._mesh()
        return int(mesh.world) if mesh is not None else 1

    def _members(self) -> List[int]:
        """The current mesh's member ids (one device: its index)."""
        mesh = self._mesh()
        if mesh is not None:
            return list(mesh.members)
        ids = getattr(self.engine, "device_ids", None)
        if ids is not None:
            return [int(d) for d in ids()]
        return [mesh_lib.device_id(self.engine.device)]

    def _grouped(self) -> bool:
        """Whether classification is a roll call: a mesh over a process
        group (of any size) and no injected liveness."""
        mesh = self._mesh()
        return (self._liveness is None and mesh is not None
                and mesh.group is not None)

    def _probe(self) -> Dict[int, bool]:
        members = self._members()
        if self._liveness is not None:
            return self._liveness(members, self._liveness_timeout_s)
        alive = mesh_lib.probe_liveness([self.engine.device],
                                        self._liveness_timeout_s)
        return {members[0]: all(alive.values())}

    def _echo_own(self) -> bool:
        """Whether this rank's own device answers a 4-byte echo within
        the liveness deadline."""
        try:
            return bool(mesh_lib.run_with_deadline(
                lambda: mesh_lib._echo(self._mesh().device),
                self._liveness_timeout_s))
        except Exception:
            return False

    # -- rescue ------------------------------------------------------------

    def _exhausted(self, why: str, cause=None) -> ElasticExhaustedError:
        err = ElasticExhaustedError(
            f"{why}; lost device(s) {self.lost_device_ids}",
            lost_device_ids=self.lost_device_ids, rescues=self.rescues)
        err.__cause__ = cause
        return err

    def _rescue(self, dead_ids: Sequence[int], cause: str):
        """Leave or regroup -> rebuild over survivors -> warm-start.
        Raises :class:`ElasticExhaustedError` past the budget (or when
        nothing survives), :class:`RankLeftError` on a rank the verdict
        names."""
        dead = sorted(set(int(d) for d in dead_ids))
        self.lost_device_ids.extend(
            d for d in dead if d not in self.lost_device_ids
        )
        obs_metrics.counter(
            "elastic.devices_lost",
            "mesh devices declared dead across the run",
        ).inc(len(dead))
        if self.rescues >= self.max_rescues:
            raise self._exhausted(
                f"rescue budget ({self.max_rescues}) exhausted after "
                f"losing device(s) {dead} ({cause})")
        members = self._members()
        try:
            survivors = mesh_lib.surviving_members(
                self.lost_device_ids + self.excluded_device_ids, members)
        except RuntimeError as e:
            raise self._exhausted(
                f"no surviving devices to rescue onto ({e})", e) from e
        grouped = self._grouped()
        world0 = len(members)
        if grouped and distributed.member() not in survivors:
            raise RankLeftError(
                f"member {distributed.member()} was declared lost by the "
                f"group's roll call ({cause}); leaving the solve to the "
                f"survivors {survivors}",
                device_ids=[distributed.member()])
        with obs_trace.span("elastic/rescue", cause=cause,
                            dead_devices=",".join(map(str, dead))) as sp:
            obs_log.warn(
                f"ELASTIC RESCUE #{self.rescues + 1}: device(s) {dead} "
                f"lost ({cause}); rebuilding the mesh over "
                f"{len(survivors)} survivor(s) and warm-starting from "
                f"the newest valid snapshot"
            )
            t = self._clock()
            if grouped:
                distributed.regroup(survivors)
            self._walls["regroup"] = self._clock() - t
            t = self._clock()
            self.engine = self._factory(survivors)
            self._walls["rebuild"] = self._clock() - t
            t = self._clock()
            resumed = self._warm_start()
            self._walls["warm_start"] = self._clock() - t
            if resumed:
                obs_log.info(
                    f"elastic rescue resumed from iteration {resumed} on "
                    f"{len(survivors)} device(s)"
                )
            else:
                # Nothing valid to warm-start from: restart the solve
                # from r0 on the degraded mesh — convergent, just
                # slower; counted separately.
                self.restarts += 1
                obs_metrics.counter(
                    "elastic.restarts",
                    "rescues that found no valid snapshot and restarted "
                    "from the initial rank vector",
                ).inc()
                obs_log.warn(
                    "elastic rescue found no valid snapshot; restarting "
                    "from the initial rank vector on the degraded mesh"
                )
            self.rescues += 1
            obs_metrics.counter(
                "elastic.rescues",
                "mesh teardown + re-shard + warm-start recoveries",
            ).inc()
            obs_metrics.gauge(
                "elastic.mesh_devices",
                "devices in the current solve mesh",
            ).set(self._ndev())
            self.rescue_walls.append(dict(
                self._walls, world_before=world0, world_after=len(survivors),
                resumed_iteration=resumed))
            if sp is not None:
                sp.attrs["resumed_iteration"] = resumed
                sp.attrs["survivors"] = len(survivors)
            if self.monitor is not None:
                self.monitor.reset()
            if self._on_rebuild is not None:
                self._on_rebuild(self.engine)
        return self.engine

    def _warm_start(self) -> int:
        """The newest valid snapshot restored into the fresh engine (0:
        none). The scan runs under ``resume_timeout_s`` (a warm-start
        source can hang on buffers of the lost mesh; past the deadline
        it is abandoned and the solve restarts from r0); the restore
        runs on this thread. Over a group of more than one rank the
        ranks then agree on the OLDEST iteration any of them found (an
        all_reduce MIN; 0 if one found none), and a rank that found a
        newer one loads the agreed one: every rank resumes the same
        state."""
        from pagerank_tpu_torch.utils.snapshot import resume_engine

        if self._snap is None:
            found = None
        else:
            try:
                # found=None means "no snapshot", already decided under
                # the deadline — never rescan unbounded.
                found = mesh_lib.run_with_deadline(
                    self._snap.load_latest_valid, self._resume_timeout_s)
            except mesh_lib.DeadlineExpired:
                obs_log.warn(
                    f"elastic rescue: warm-start source did not answer "
                    f"within {self._resume_timeout_s:g}s (pending writes "
                    f"against the lost mesh?); abandoning it and "
                    f"restarting from the initial vector")
                found = None
        mesh = self._mesh()
        if self._grouped() and mesh is not None and mesh.collective:
            import torch
            import torch.distributed as dist

            it = torch.tensor([found[0] if found is not None else 0],
                              dtype=torch.int64, device=mesh.device)
            dist.all_reduce(it, op=dist.ReduceOp.MIN, group=mesh.group)
            agreed = int(it.item())
            if agreed == 0:
                found = None
            elif found is None or found[0] != agreed:
                ranks, meta = self._snap.load(agreed)
                found = (agreed, ranks, meta)
        if found is None:
            return 0
        return resume_engine(self.engine, self._snap, _found=found)

    def _classify_and_rescue(self, exc: BaseException, cause: str):
        """Classify a plausible device loss — the roll call over a
        group, the liveness probe otherwise; rescue when it finds
        casualties, return None otherwise (a live mesh means the error
        is the caller's problem). A group is torn down before its roll
        call, whatever the verdict."""
        carried = (exc.device_ids if isinstance(exc, DeviceLostError)
                   else ())
        t = self._clock()
        if self._grouped():
            distributed.abandon_group()
            dead = distributed.roll_call(
                carried, alive=self._echo_own(),
                timeout_s=self._liveness_timeout_s)
        else:
            alive = self._probe()
            dead = sorted({d for d, ok in alive.items() if not ok}
                          | set(int(d) for d in carried))
        self._walls = {"roll_call": self._clock() - t}
        if not dead:
            return None
        return self._rescue(dead, cause)

    # -- drive -------------------------------------------------------------

    def run(self, num_iters: Optional[int] = None, on_iteration=None,
            probes=None) -> np.ndarray:
        """``engine.run`` with rescue: a step failure that classifies
        as device loss (or a watchdog fire under ``--stall-action
        rescue`` whose classification finds casualties) leaves or
        regroups and rebuilds; anything else propagates unchanged.
        Numeric self-healing (NaN -> rollback) keeps running INSIDE
        engine.run with the same snapshotter."""
        monitor = self.monitor
        wrapped = on_iteration
        if monitor is not None:
            def wrapped(i, info, _inner=on_iteration):
                monitor.end_step(i)
                if _inner is not None:
                    _inner(i, info)
                monitor.begin_step()

        while True:
            try:
                if monitor is not None:
                    monitor.begin_step()
                return self.engine.run(
                    num_iters=num_iters, on_iteration=wrapped,
                    snapshotter=self._snap, probes=probes,
                )
            except KeyboardInterrupt:
                wd = obs_live.get_watchdog()
                if wd is None or not wd.consume_rescue():
                    raise
                # Watchdog-initiated: a stall past the timeout. Dead
                # member(s) -> rescue; all alive -> a hang that teardown
                # must not "fix" (the watchdog already logged loudly).
                if self._classify_and_rescue(
                        KeyboardInterrupt(), "stall watchdog") is None:
                    raise RuntimeError(
                        "stall watchdog fired but every device answers "
                        "its liveness probe: hang, not device loss — "
                        "not rescuing (see the watchdog diagnostic)"
                    )
            except Exception as e:
                if isinstance(e, RankLeftError) or \
                        not looks_like_device_loss(e):
                    raise
                cause = (f"step failure: {type(e).__name__}: "
                         f"{str(e).splitlines()[0][:200] if str(e) else ''}")
                if isinstance(e, DeviceQuarantinedError):
                    # An SDC conviction: the chip ANSWERS liveness
                    # probes but cannot be trusted — record it, persist
                    # it via the hook, and rescue on the carried ids.
                    self._note_quarantine(e.device_ids)
                    cause = "sdc quarantine"
                if self._classify_and_rescue(e, cause) is None:
                    raise

    def _note_quarantine(self, device_ids: Sequence[int]) -> None:
        new = [int(d) for d in device_ids
               if int(d) not in self.quarantined_device_ids]
        if not new:
            return
        self.quarantined_device_ids.extend(new)
        if self._on_quarantine is not None:
            self._on_quarantine(list(self.quarantined_device_ids))
