"""Deterministic, seed-driven fault injection (docs/ROBUSTNESS.md).

The reference gets chaos testing for free — kill a Spark executor and
lineage recovery is exercised (SURVEY.md §5). This build's substrate is
utils/fsio + utils/s3 + utils/snapshot, so faults are injected at those
seams instead:

- :class:`FaultInjectingFileSystem` wraps ANY :class:`fsio.FileSystem`
  and injects failures / truncated writes / latency spikes;
- :class:`HttpFaultInjector` plugs into the S3 stub's wire level
  (tests/s3stub.S3Stub.fault_hook) to answer 5xx/SlowDown, drop
  connections mid-body, or lose a multipart-complete response;
- :class:`DeviceFaultSchedule` + :func:`install_device_faults`
  inject DEVICE-plane faults — kill device k at
  iteration i, delay a step to simulate a straggler, poison the merged
  collective output, or silently FLIP one bit of one device's rank
  buffer (mantissa/exponent/sign; one-shot or sticky — the SDC
  plane's chaos substrate, pagerank_tpu/sdc.py) — through a mesh-aware
  shim over the engine's step, so the elastic rescue and SDC
  quarantine paths (parallel/elastic.py) are fully testable on CPU
  with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``.

Everything is driven by a schedule whose decisions are a pure function
of (seed, call index) — device faults: (seed, iteration) — never of
wall clock or shared global randomness — and every decision is
appended to a ``log``, so a chaos run is REPRODUCIBLE: the same seed
yields the same schedule bit-for-bit across two runs (asserted in
tests/test_faults.py and tests/test_elastic.py; the acceptance chaos
smokes in scripts/acceptance.py gate on it).

Copy of ``pagerank_tpu/testing/faults.py``: the host logic as it is;
``mutate_rank_shard`` and ``flip_rank_bit`` rewritten on the engine's
torch rank tensor, and the device ids read from the engine
(``engine.device_ids()``: over a mesh its members' ORIGINAL ids, the
ranks of the group's first generation; one device: its CUDA index, 0 on
the CPU). Over a process group every rank installs the shim with the
same seeded schedule, so every rank sees the same kill at the same
iteration (the victim's runner finds itself in the roll call's verdict
and leaves; the survivors rescue), and a flip lands only on its
member's own shard. :class:`ProcessKillPlan` may name a ``rank``: only
that rank of a group delivers the signal. The subprocess harness runs
``python -m pagerank_tpu_torch.cli`` by default.
"""

from __future__ import annotations

import io
import os
import random
import signal
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from pagerank_tpu_torch.obs import log as obs_log
from pagerank_tpu_torch.utils import fsio


class FaultInjectedError(OSError):
    """An injected transient fault. An OSError so the default retry
    predicate (utils/retry.default_retryable) classifies it as
    transient — exactly how a real connection reset presents."""


class FaultSchedule:
    """Seeded decision stream for fault injection.

    Each ``decide(op, target)`` call advances a counter and draws a
    FIXED number of uniforms from the seeded stream (whether or not a
    fault fires), so the schedule depends only on the seed and the call
    SEQUENCE — reordering real work reorders faults, but re-running the
    same work reproduces them exactly.

    Triggers: ``fail_nth`` / ``truncate_nth`` / ``delay_nth`` fire on
    exact 1-based call indices; ``fail_rate`` / ``truncate_rate`` /
    ``delay_rate`` fire probabilistically. ``ops`` restricts which
    operations are eligible (None = all). ``max_faults`` caps the total
    number of injected faults — a chaos run with a finite fault budget
    below the consumer's retry budget is GUARANTEED to make progress.
    """

    def __init__(
        self,
        seed: int = 0,
        fail_nth: Iterable[int] = (),
        fail_rate: float = 0.0,
        truncate_nth: Iterable[int] = (),
        truncate_rate: float = 0.0,
        delay_nth: Iterable[int] = (),
        delay_rate: float = 0.0,
        delay_s: float = 0.0,
        ops: Optional[Iterable[str]] = None,
        max_faults: Optional[int] = None,
    ):
        self.seed = seed
        self._rng = random.Random(seed)
        self._fail_nth = frozenset(fail_nth)
        self._truncate_nth = frozenset(truncate_nth)
        self._delay_nth = frozenset(delay_nth)
        self._fail_rate = fail_rate
        self._truncate_rate = truncate_rate
        self._delay_rate = delay_rate
        self._delay_s = delay_s
        self._ops = None if ops is None else frozenset(ops)
        self._max_faults = max_faults
        self.calls = 0
        self.faults = 0
        #: (call_index, op, target, action) — the reproducibility record.
        self.log: List[Tuple[int, str, str, str]] = []

    def decide(self, op: str, target: str) -> Optional[Tuple]:
        self.calls += 1
        n = self.calls
        # Fixed draw count per call keeps the stream position a pure
        # function of the call index.
        u, v = self._rng.random(), self._rng.random()
        action: Optional[Tuple] = None
        eligible = (
            (self._ops is None or op in self._ops)
            and (self._max_faults is None or self.faults < self._max_faults)
        )
        if eligible:
            if n in self._fail_nth or u < self._fail_rate:
                action = ("fail",)
            elif n in self._truncate_nth or u < self._fail_rate + self._truncate_rate:
                action = ("truncate", v)  # keep this fraction of bytes
            elif (n in self._delay_nth
                  or u < self._fail_rate + self._truncate_rate + self._delay_rate):
                action = ("delay", self._delay_s * (0.5 + v))
        if action is not None:
            self.faults += 1
        self.log.append((n, op, target, action[0] if action else "-"))
        return action


class _FaultWriter(io.BytesIO):
    """Buffered writer committing through the wrapped store at close —
    the injection point for truncate-on-write faults (mirrors
    fsio._MemWriter, including abort-on-exception)."""

    def __init__(self, fs: "FaultInjectingFileSystem", path: str,
                 initial: bytes = b""):
        super().__init__()
        self.write(initial)
        self._fs = fs
        self._path = path
        self._aborted = False

    def abort(self):
        self._aborted = True

    def flush(self):
        super().flush()
        if (not self.closed and not self._aborted
                and self._fs.COMMIT_ON_FLUSH):
            self._fs._commit(self._path, self.getvalue(), final=False)

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        return super().__exit__(exc_type, exc, tb)

    def close(self):
        if not self.closed and not self._aborted:
            self._fs._commit(self._path, self.getvalue(), final=True)
        super().close()


class FaultInjectingFileSystem(fsio.FileSystem):
    """Wrap any :class:`fsio.FileSystem` with schedule-driven faults.

    Operations consult the schedule BEFORE delegating: ``("fail",)``
    raises :class:`FaultInjectedError` (transient — a retrying caller
    recovers), ``("delay", s)`` sleeps via the injectable ``sleep``
    (virtual in tests). Writes buffer in memory and commit at close;
    a ``("truncate", frac)`` decision at commit time publishes only a
    prefix of the bytes — the torn-object case checksummed snapshot
    loads must detect. Ops seen by the schedule: ``open_r``, ``commit``
    (write close), ``stat``, ``listdir``, ``replace``, ``makedirs``.
    """

    def __init__(self, inner: fsio.FileSystem, schedule: FaultSchedule,
                 sleep: Callable[[float], None] = time.sleep):
        self.inner = inner
        self.schedule = schedule
        self._sleep = sleep
        self.COMMIT_ON_FLUSH = getattr(inner, "COMMIT_ON_FLUSH", True)

    def _hit(self, op: str, path: str) -> Optional[Tuple]:
        act = self.schedule.decide(op, path)
        if act is None:
            return None
        if act[0] == "fail":
            raise FaultInjectedError(
                f"injected fault #{self.schedule.faults} on {op} {path!r} "
                f"(seed {self.schedule.seed}, call {self.schedule.calls})"
            )
        if act[0] == "delay":
            self._sleep(act[1])
            return None
        return act

    def _commit(self, path: str, data: bytes, final: bool = True) -> None:
        act = self._hit("commit", path) if final else None
        if act is not None and act[0] == "truncate":
            data = data[: int(len(data) * act[1])]
        with self.inner.open(path, "wb") as f:
            f.write(data)

    def open(self, path, mode="r", **kwargs):
        binary = "b" in mode
        kind = mode.replace("b", "").replace("t", "") or "r"
        if kind == "r":
            self._hit("open_r", path)
            return self.inner.open(path, mode, **kwargs)
        if kind not in ("w", "x", "a"):
            raise ValueError(f"unsupported mode {mode!r}")
        if kind == "x" and self.inner.isfile(path):
            raise FileExistsError(path)
        initial = b""
        if kind == "a" and self.inner.isfile(path):
            with self.inner.open(path, "rb") as f:
                initial = f.read()
        raw = _FaultWriter(self, path, initial)
        if kind == "a":
            raw.seek(0, io.SEEK_END)
        if binary:
            return raw
        kwargs.pop("newline", None)
        kwargs.setdefault("encoding", "utf-8")
        return fsio._MemTextWrapper(raw, **kwargs)

    def exists(self, path):
        self._hit("stat", path)
        return self.inner.exists(path)

    def isdir(self, path):
        self._hit("stat", path)
        return self.inner.isdir(path)

    def isfile(self, path):
        self._hit("stat", path)
        return self.inner.isfile(path)

    def listdir(self, path):
        self._hit("listdir", path)
        return self.inner.listdir(path)

    def makedirs(self, path, exist_ok=True):
        self._hit("makedirs", path)
        return self.inner.makedirs(path, exist_ok=exist_ok)

    def replace(self, src, dst):
        self._hit("replace", src)
        return self.inner.replace(src, dst)


class HttpFaultInjector:
    """Schedule adapter for the S3 stub's wire-level hook
    (tests/s3stub.S3Stub.fault_hook).

    ``plan`` maps 1-based request indices to stub action tuples —
    ``("status", 503, "SlowDown")``, ``("reset",)``,
    ``("truncate", nbytes)``, ``("commit_then_status", 500)`` — and
    ``fail_rate`` adds seeded probabilistic 5xx answers on top.
    ``methods`` restricts which HTTP verbs are eligible. Decisions are
    a pure function of (seed, request index) and are logged, so the
    wire-fault schedule reproduces bit-for-bit per seed."""

    def __init__(
        self,
        seed: int = 0,
        plan: Optional[Dict[int, Tuple]] = None,
        fail_rate: float = 0.0,
        fail_status: Tuple = ("status", 503, "SlowDown"),
        methods: Optional[Iterable[str]] = None,
        max_faults: Optional[int] = None,
    ):
        self.seed = seed
        self._rng = random.Random(seed)
        self._plan = dict(plan or {})
        self._fail_rate = fail_rate
        self._fail_status = fail_status
        self._methods = None if methods is None else frozenset(methods)
        self._max_faults = max_faults
        self.calls = 0
        self.faults = 0
        self.log: List[Tuple[int, str, str, str]] = []

    def __call__(self, method: str, path: str) -> Optional[Tuple]:
        self.calls += 1
        n = self.calls
        u = self._rng.random()
        action: Optional[Tuple] = None
        eligible = (
            (self._methods is None or method in self._methods)
            and (self._max_faults is None or self.faults < self._max_faults)
        )
        if eligible:
            action = self._plan.get(n)
            if action is None and u < self._fail_rate:
                action = self._fail_status
        if action is not None:
            self.faults += 1
        self.log.append((n, method, path, action[0] if action else "-"))
        return action


# -- process-plane faults (jobs.py) ------------------------------------


class ProcessKillPlan:
    """Seed-deterministic PROCESS-plane fault: kill THIS process with a
    real signal at a staged point of a resumable job (jobs.py stage
    boundaries; per-iteration inside the solve stage).

    The plan travels to the target process via :data:`KILL_ENV`
    (``stage=solve,iter=5,signal=TERM[,seed=N]``) so the chaos harness
    (:func:`run_job_subprocess`) can kill a REAL subprocess job at an
    exact, reproducible point — the self-delivery makes SIGKILL
    placement deterministic in a way an external watcher never is.
    ``signal=TERM`` exercises the graceful drain (handler installed
    around cli.main); ``signal=KILL`` is the no-warning preemption —
    the process dies mid-stage with nothing flushed beyond the durable
    artifacts already committed.

    Like every schedule here, the decision is a pure function of the
    plan's (stage, iteration), one-shot, and logged — two same-plan
    runs kill at the identical point bit-for-bit (the log is written to
    ``PAGERANK_TPU_KILL_LOG`` when set, so even a SIGKILL'd process
    leaves its reproducibility record: the log line is flushed BEFORE
    the signal is raised). ``seed`` is schedule IDENTITY only — it
    rides the env encoding and the log line so a kill record names
    which seeded chaos campaign produced it, but never perturbs the
    placement (there is nothing random to derive: the plan pins the
    exact point)."""

    ENV = "PAGERANK_TPU_KILL_PLAN"
    LOG_ENV = "PAGERANK_TPU_KILL_LOG"

    def __init__(self, stage: str, iteration: Optional[int] = None,
                 signum: int = 15, seed: int = 0,
                 log_path: Optional[str] = None,
                 rank: Optional[int] = None):
        self.stage = stage
        self.iteration = iteration
        #: Only this rank of a process group (its ``RANK``) delivers the
        #: signal; None: every process the plan reaches.
        self.rank = rank
        self.signum = int(signum)
        self.seed = int(seed)
        self.fired = False
        self.log: List[Tuple[str, str, int]] = []
        self._log_path = log_path

    @classmethod
    def from_env(cls, env=None) -> Optional["ProcessKillPlan"]:
        env = os.environ if env is None else env
        spec = env.get(cls.ENV)
        if not spec:
            return None
        fields = dict(
            tok.split("=", 1) for tok in spec.split(",") if "=" in tok
        )
        sig_name = fields.get("signal", "TERM").upper()
        signum = getattr(signal, f"SIG{sig_name}", None)
        if signum is None:
            raise ValueError(f"{cls.ENV}: unknown signal {sig_name!r}")
        it = fields.get("iter")
        rank = fields.get("rank")
        return cls(
            stage=fields.get("stage", "solve"),
            iteration=int(it) if it is not None else None,
            signum=int(signum), seed=int(fields.get("seed", 0)),
            log_path=env.get(cls.LOG_ENV),
            rank=int(rank) if rank is not None else None,
        )

    def to_env(self) -> Dict[str, str]:
        """The env var encoding of this plan (for the subprocess
        harness)."""
        sig = signal.Signals(self.signum).name.replace("SIG", "", 1)
        spec = f"stage={self.stage},signal={sig},seed={self.seed}"
        if self.iteration is not None:
            spec += f",iter={self.iteration}"
        if self.rank is not None:
            spec += f",rank={self.rank}"
        return {self.ENV: spec}

    def check(self, stage: str, iteration: Optional[int] = None) -> None:
        """Deliver the signal when (stage, iteration) matches; one-shot.
        The reproducibility log line (and stdio) is flushed FIRST —
        a SIGKILL leaves no second chance."""
        if self.fired or stage != self.stage:
            return
        if self.iteration is not None and iteration != self.iteration:
            return
        if (self.rank is not None
                and os.environ.get("RANK", "0") != str(self.rank)):
            return
        self.fired = True
        entry = (stage, signal.Signals(self.signum).name,
                 -1 if iteration is None else int(iteration))
        self.log.append(entry)
        if self._log_path:
            with open(self._log_path, "a") as f:
                f.write(f"{entry[0]},{entry[1]},{entry[2]}\n")
                f.flush()
                os.fsync(f.fileno())
        obs_log.warn(
            f"chaos: delivering {entry[1]} at {stage}"
            + (f" iteration {iteration}" if iteration is not None else "")
            + f" (seed {self.seed})"
        )
        sys.stderr.flush()
        sys.stdout.flush()
        os.kill(os.getpid(), self.signum)


def run_job_subprocess(argv: Sequence[str],
                       kill: Optional[ProcessKillPlan] = None,
                       env: Optional[Dict[str, str]] = None,
                       kill_log: Optional[str] = None,
                       timeout: float = 600.0,
                       module: str = "pagerank_tpu_torch.cli"):
    """Chaos harness: run ``python -m <module> <argv>`` as a REAL
    subprocess (default module: ``pagerank_tpu_torch.cli``), optionally
    carrying a seeded :class:`ProcessKillPlan` that makes the child kill itself
    (SIGTERM -> graceful drain path, SIGKILL -> nothing survives but
    the durable artifacts). Returns the CompletedProcess; a SIGKILL'd
    child's returncode is ``-9`` and a hard-exited SIGTERM child's is
    per the exit-code taxonomy (exitcodes.py)."""
    import subprocess

    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    if kill is not None:
        child_env.update(kill.to_env())
        if kill_log:
            child_env[ProcessKillPlan.LOG_ENV] = kill_log
    else:
        child_env.pop(ProcessKillPlan.ENV, None)
    return subprocess.run(
        [sys.executable, "-m", module, *argv],
        env=child_env, capture_output=True, text=True, timeout=timeout,
    )


# -- device-plane faults (parallel/elastic.py) -------------------------------


#: Bit-flip fault kinds (sdc.py): which bit of
#: the targeted float element flips. "mantissa" flips the highest
#: mantissa bit (up to ~2x relative change — well above the derived
#: SDC tolerance, well below NaN territory); "exponent" flips the
#: LOWEST exponent bit (x2 / x0.5 magnitude — never produces Inf/NaN
#: at realistic rank magnitudes, so the SDC plane sees it, not the
#: NaN health check); "sign" negates the element.
FLIP_KINDS = ("mantissa", "exponent", "sign")


def _flip_bit_index(dtype, kind: str) -> int:
    dtype = np.dtype(dtype)
    bits = dtype.itemsize * 8
    try:
        mant = int(np.finfo(dtype).nmant)  # f16 10, bf16 7, f32 23...
    except (ValueError, TypeError):
        mant = {16: 10, 32: 23, 64: 52}[bits]
    if kind == "sign":
        return bits - 1
    if kind == "exponent":
        return mant  # lowest exponent bit
    if kind == "mantissa":
        return mant - 1  # highest mantissa bit
    raise ValueError(f"unknown flip kind {kind!r}; have {FLIP_KINDS}")


def _engine_device_ids(engine):
    """The device ids of the engine's rank buffer: its mesh's member ids
    (``engine.device_ids()``), or a one-device engine's CUDA index (0
    on the CPU)."""
    from pagerank_tpu_torch.parallel.mesh import device_id

    if getattr(engine, "mesh", None) is not None:
        return [int(d) for d in engine.device_ids()]
    dev = getattr(engine, "device", None)
    return [0 if dev is None else device_id(dev)]


def mutate_rank_shard(engine, device_id: int, mutator):
    """Rewrite ``device_id``'s buffer of the engine's rank vector through
    ``mutator(tensor, lo)``, which changes the tensor in place on its
    device — the silent-data-corruption injection primitive. The
    mutated tensor is a copy that then becomes the engine's rank
    vector, so a buffer already handed to a sink (the async writer's
    payload) keeps the bits it was handed, as on a chip whose buffer
    went bad after it was read. Over a mesh only the rank whose member
    is ``device_id`` changes its buffer (a replicated form's copy, or a
    vertex-sharded form's block, whose global start is ``lo``); every
    other rank leaves its own alone. Returns the targeted shard's
    global start (localization ground truth for tests)."""
    ids = _engine_device_ids(engine)
    if int(device_id) not in ids:
        raise ValueError(
            f"device {device_id} holds no shard of the rank vector "
            f"(engine devices: {ids})"
        )
    mesh = getattr(engine, "mesh", None)
    lo = 0
    if mesh is not None and getattr(engine, "_vs", False):
        lo = ids.index(int(device_id)) * int(engine._blk)
    if mesh is not None and mesh.member != int(device_id):
        return lo
    r = engine._r.clone()
    mutator(r, lo)
    engine._r = r
    return lo


def flip_element(frac: float, n_valid: int, size: int) -> int:
    """The element of a ``size``-element shard, ``n_valid`` of whose
    lanes are real vertices, that a flip carrying ``frac`` in [0, 1)
    hits."""
    n_valid = int(min(max(1, n_valid), size))
    return min(max(0, int(float(frac) * n_valid)), max(0, size - 1))


def flip_rank_bit(engine, device_id: int, kind: str, frac: float):
    """Flip one bit (``kind``: mantissa/exponent/sign) of one element
    of ``device_id``'s rank buffer, through a same-width integer view
    (``int32`` for f32, ``int64`` for f64) of the tensor on its device.
    ``frac`` in [0, 1) picks the element deterministically among the
    VALID lanes (the relabeled real-vertex prefix), so a seeded schedule
    reproduces the exact corrupted bit — the same element and bit as
    the JAX package's flip for the same (frac, dtype, n). Returns
    ``(global_element, bit)`` for the reproducibility log."""
    import torch

    out = {}
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}

    def mutator(data, lo):
        size = data.numel()
        element = flip_element(frac, engine.graph.n - lo, size)
        np_dtype = np.dtype(str(data.dtype).removeprefix("torch."))
        bit = _flip_bit_index(np_dtype, kind)
        width = data.element_size() * 8
        # The top bit of a signed view is its sign: XOR with the most
        # negative value of the width flips exactly that bit.
        mask = -(1 << bit) if bit == width - 1 else 1 << bit
        view = data.view(ints[data.element_size()])
        view[element] ^= mask
        out["element"] = element
        out["bit"] = bit

    lo = mutate_rank_shard(engine, device_id, mutator)
    if not out:  # another rank's member: nothing flipped here
        return None
    return lo + out["element"], out["bit"]


class DeviceFaultSchedule:
    """Seed-deterministic DEVICE-plane fault plan, keyed by ITERATION.

    Explicit plan entries:

    - ``kill``:   {iteration: device_id or [device_ids]} — the device
      drops out of the mesh mid-step (the shim raises
      :class:`~pagerank_tpu_torch.parallel.elastic.DeviceLostError`);
    - ``delay``:  {iteration: (device_id, seconds)} — that device's
      step runs ``seconds`` long (a straggler: the step COMPLETES,
      only slower — must produce telemetry, never a rescue);
    - ``poison``: iterable of iterations whose merged collective
      output is corrupted (NaN state + NaN step info — the numeric
      self-healing plane's rollback handles it, exactly the
      separation the decision table documents);
    - ``flip``:   {iteration: (device_id, kind)} — SILENT bit-flip
      corruption: one bit of one element of that device's
      rank buffer flips (``kind`` in :data:`FLIP_KINDS` —
      mantissa/exponent/sign; the element rides the seeded per-
      iteration draw, :meth:`flip_fraction`, so the corrupted bit is
      reproducible; an entry ``(device_id, kind, frac)`` aims at the
      element ``frac`` picks instead). Injected
      BEFORE the step runs — a lying chip corrupts inputs, not
      verdicts — and aimed at the SDC plane (pagerank_tpu/sdc.py):
      no NaN, no error, nothing the health-check and elastic planes can see.
      One-shot like every fault UNLESS the iteration is listed in
      ``sticky_flips``: a sticky entry re-fires every time its
      iteration is consulted, modeling a chip that corrupts every
      pass — the SDC redo then convicts it (transient-vs-sticky is
      EXACTLY "does the flip reproduce on re-execution").

    ``kill_rate``/``delay_rate``/``flip_rate`` add seeded
    probabilistic chaos on top. Every consulted iteration draws a FIXED number of uniforms
    from an RNG derived purely from ``(seed, iteration)``, so the
    schedule is a pure function of the seed and the iteration — NOT
    of how many times an iteration is consulted: a post-rescue
    recompute of iteration i sees the same decision, and the
    ``fired`` memory keeps one-shot faults one-shot (a killed device
    stays dead; it cannot die twice). Every decision lands in
    ``log`` as ``(iteration, action, detail)`` — two same-seed runs
    of the same scenario must produce identical logs bit-for-bit.
    """

    def __init__(
        self,
        seed: int = 0,
        kill: Optional[Dict[int, object]] = None,
        delay: Optional[Dict[int, Tuple[int, float]]] = None,
        poison: Iterable[int] = (),
        flip: Optional[Dict[int, Tuple[int, str]]] = None,
        sticky_flips: Iterable[int] = (),
        kill_rate: float = 0.0,
        delay_rate: float = 0.0,
        flip_rate: float = 0.0,
        delay_s: float = 0.1,
        max_faults: Optional[int] = None,
    ):
        self.seed = seed
        self._kill = {
            int(i): tuple(v) if isinstance(v, (list, tuple)) else (int(v),)
            for i, v in (kill or {}).items()
        }
        self._delay = {int(i): (int(d), float(s))
                       for i, (d, s) in (delay or {}).items()}
        self._poison = frozenset(int(i) for i in poison)
        self._flip = {int(i): (int(e[0]), str(e[1]),
                               float(e[2]) if len(e) > 2 else None)
                      for i, e in (flip or {}).items()}
        for _i, (_d, k, _f) in self._flip.items():
            if k not in FLIP_KINDS:
                raise ValueError(
                    f"unknown flip kind {k!r}; have {FLIP_KINDS}"
                )
        self._sticky_flips = frozenset(int(i) for i in sticky_flips)
        self._kill_rate = kill_rate
        self._delay_rate = delay_rate
        self._flip_rate = flip_rate
        self._delay_s = delay_s
        self._max_faults = max_faults
        self.faults = 0
        #: Devices killed so far — the injectable liveness probe's
        #: ground truth (see :meth:`liveness_probe`).
        self.dead: set = set()
        self._fired: set = set()  # (kind, iteration) one-shot memory
        #: (iteration, action, detail) — the reproducibility record.
        self.log: List[Tuple[int, str, str]] = []

    def _draws(self, iteration: int) -> Tuple[float, float]:
        """The iteration's fixed two uniforms ``(u, v)``. A pure
        function of (seed, iteration): consulting an iteration twice
        (post-rescue recompute) re-derives the SAME pair."""
        rng = random.Random((self.seed << 24) ^ (iteration + 1))
        return rng.random(), rng.random()

    def flip_fraction(self, iteration: int) -> float:
        """The element fraction a flip at ``iteration`` carries unless
        its plan entry names one (:func:`flip_element` maps it to the
        element that flips)."""
        return self._draws(iteration)[1]

    def _budget_ok(self) -> bool:
        return self._max_faults is None or self.faults < self._max_faults

    def decide(self, iteration: int,
               device_ids: Sequence[int]) -> List[Tuple]:
        """Actions for ``iteration`` over the CURRENT mesh's device
        ids: ``("kill", dev)``, ``("delay", dev, seconds)``,
        ``("poison",)``. Deterministic per (seed, iteration); one-shot
        per (kind, iteration); killed devices never re-die."""
        u, v = self._draws(iteration)  # fixed draw count
        alive = [d for d in device_ids if d not in self.dead]
        actions: List[Tuple] = []

        def fire(kind: str, action: Tuple, detail: str):
            self._fired.add((kind, iteration))
            self.faults += 1
            actions.append(action)
            self.log.append((iteration, action[0], detail))

        if self._budget_ok() and ("kill", iteration) not in self._fired:
            targets = [d for d in self._kill.get(iteration, ()) if d in alive]
            if not targets and u < self._kill_rate and len(alive) > 1:
                targets = [alive[int(v * len(alive))]]
            for d in targets:
                self.dead.add(d)
                fire("kill", ("kill", d), f"device {d}")
        if self._budget_ok() and ("delay", iteration) not in self._fired:
            ent = self._delay.get(iteration)
            if ent is None and u < self._kill_rate + self._delay_rate and alive:
                ent = (alive[int(v * len(alive))], self._delay_s)
            if ent is not None:
                fire("delay", ("delay", ent[0], ent[1]),
                     f"device {ent[0]} +{ent[1]:g}s")
        if (self._budget_ok() and iteration in self._poison
                and ("poison", iteration) not in self._fired):
            fire("poison", ("poison",), "collective output")
        # Bit flips: one-shot unless the iteration is
        # sticky — a sticky chip re-corrupts on every consult
        # (including the SDC redo's re-execution, which is what
        # convicts it). The element fraction rides ``v`` so the exact
        # corrupted bit is a pure function of (seed, iteration).
        flip_ok = (("flip", iteration) not in self._fired
                   or iteration in self._sticky_flips)
        if self._budget_ok() and flip_ok:
            ent = self._flip.get(iteration)
            if (ent is None
                    and u < (self._kill_rate + self._delay_rate
                             + self._flip_rate)
                    and u >= self._kill_rate + self._delay_rate
                    and alive):
                ent = (alive[int(v * len(alive))],
                       FLIP_KINDS[int(u * 997) % len(FLIP_KINDS)], None)
            if ent is not None and ent[0] in alive:
                frac = v if ent[2] is None else ent[2]
                fire("flip", ("flip", ent[0], ent[1], frac),
                     f"device {ent[0]} {ent[1]} bit, element frac "
                     f"{frac:.6f}"
                     + (" (sticky)" if iteration in self._sticky_flips
                        else ""))
        if not actions:
            self.log.append((iteration, "-", ""))
        return actions

    def liveness_probe(self, devices, timeout_s: float = 0.0
                       ) -> Dict[int, bool]:
        """Injectable stand-in for the liveness probe on a fake mesh
        (where every member shares one live process): a device or
        member id is alive iff the schedule has not killed it."""
        from pagerank_tpu_torch.parallel.mesh import device_id

        ids = [int(d) if isinstance(d, int) else device_id(d)
               for d in devices]
        return {d: d not in self.dead for d in ids}


def install_device_faults(engine, schedule: DeviceFaultSchedule,
                          sleep: Callable[[float], None] = time.sleep,
                          monitor=None):
    """Wrap ``engine.step`` / ``engine.step_probed`` with the
    mesh-aware injection shim. Idempotent per engine instance — a
    repeat call REPLACES the shim (re-wrapping from the original
    unwrapped methods) instead of stacking, so the schedule is never
    consulted twice per iteration and the log-reproducibility
    contract holds. Call it again on the fresh engine after a rescue
    (ElasticRunner's ``on_rebuild`` hook exists for exactly this).

    Semantics per action at iteration i:

    - kill:   the step raises DeviceLostError BEFORE completing — the
      device died mid-collective; the elastic runner classifies and
      rescues;
    - delay:  the real step runs, then the straggler's extra wall is
      added via the injectable ``sleep`` (virtual in tests) and the
      per-device walls are reported to the health ``monitor``
      (straggler telemetry, never an error);
    - poison: the real step runs, then the merged output is corrupted
      (NaN state + NaN info) — the NUMERIC plane's health check +
      rollback owns this, not the rescue path;
    - flip:   the device's rank buffer is silently bit-corrupted
      BEFORE the step dispatches (a lying chip corrupts inputs) — the
      SDC plane (pagerank_tpu/sdc.py) owns detection; nothing else
      can see it.
    """
    from pagerank_tpu_torch.parallel.elastic import DeviceLostError

    def device_ids():
        return _engine_device_ids(engine)

    def poison_engine(info):
        bad = {k: float("nan") for k in info}
        try:
            engine.set_ranks(
                np.asarray(engine.ranks()) * float("nan"),
                iteration=engine.iteration,
            )
        except NotImplementedError:
            pass
        return bad

    def apply(actions, info):
        for act in actions:
            if act[0] == "delay":
                sleep(act[2])
                if monitor is not None:
                    devs = device_ids()
                    walls = {d: 0.0 for d in devs}
                    walls[act[1]] = float(act[2])
                    monitor.record_device_times(engine.iteration, walls)
            elif act[0] == "poison":
                info = poison_engine(info)
        return info

    def split(actions):
        kills = [a for a in actions if a[0] == "kill"]
        flips = [a for a in actions if a[0] == "flip"]
        rest = [a for a in actions if a[0] not in ("kill", "flip")]
        return kills, flips, rest

    def pre_apply(iteration):
        """Consult the schedule and inject everything that happens
        BEFORE the step: kills raise, flips corrupt the input state
        (skipped on engines without a device rank buffer — the CPU
        oracle). Returns the post-step actions."""
        kills, flips, rest = split(
            schedule.decide(iteration, device_ids()))
        if kills:
            raise DeviceLostError(
                f"injected device loss at iteration {iteration} "
                f"(seed {schedule.seed})",
                device_ids=[a[1] for a in kills],
            )
        for a in flips:
            if hasattr(engine, "_r"):
                flip_rank_bit(engine, a[1], a[2], a[3])
        return rest

    # Re-installs rewrap from the ORIGINALS (stashed on first install),
    # never the previous shim — stacking would double-consult the
    # schedule and break bit-for-bit log reproducibility.
    orig_step = getattr(engine, "_prefault_step", engine.step)
    engine._prefault_step = orig_step

    def step():
        rest = pre_apply(engine.iteration)
        return apply(rest, orig_step())

    engine.step = step
    # The probed step is a second dispatch surface of the same
    # iteration, shimmed the same way.
    orig_probed = getattr(engine, "_prefault_step_probed",
                          getattr(engine, "step_probed", None))
    if orig_probed is not None:
        engine._prefault_step_probed = orig_probed

        def step_probed(probes):
            rest = pre_apply(engine.iteration)
            info, ids = orig_probed(probes)
            return apply(rest, info), ids

        engine.step_probed = step_probed
    # The SDC-checked step is a third dispatch surface of
    # the same iteration — shimmed identically so a checked boundary
    # sees the same one-consult-per-iteration schedule.
    orig_sdc = getattr(engine, "_prefault_step_sdc",
                       getattr(engine, "step_sdc", None))
    if orig_sdc is not None:
        engine._prefault_step_sdc = orig_sdc

        def step_sdc():
            rest = pre_apply(engine.iteration)
            info, chk = orig_sdc()
            return apply(rest, info), chk

        engine.step_sdc = step_sdc
    return engine
