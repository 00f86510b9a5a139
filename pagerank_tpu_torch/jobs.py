"""Preemption-safe resumable jobs.

The reference pipeline survives a lost Spark master through its durable
RDD lineage: a re-run recomputes only what was lost. This build's
in-process self-healing (snapshot rollback, elastic rescue) heals a
run that is still ALIVE; nothing survived the process dying — a
preempted machine lost the ingest and the 30-75 s device build
outright. This module is the lineage analogue:

- **stage machine** (:class:`JobSupervisor`): the end-to-end run
  (ingest -> build -> solve -> output) persists one checksummed,
  fingerprint-keyed durable artifact per stage into ``--job-dir`` via
  the same ``fsio.atomic_write`` idiom as snapshots. A restarted job
  validates each artifact (sha256 + graph fingerprint + layout
  geometry + config hash) and SKIPS completed stages; a corrupt or
  mismatched artifact is skipped like a corrupt snapshot and recomputed —
  never trusted.
- **graceful drain** (:class:`GracefulDrain`): SIGTERM/SIGINT handlers
  installed only around ``cli.main`` (injectable for tests) request a
  deadline-bounded drain — the in-flight step finishes, the async
  writer flushes under its SinkGuard policy, a final snapshot plus an
  interrupted-marked run report are written, and the process exits
  :data:`~pagerank_tpu_torch.exitcodes.ExitCode.INTERRUPTED`. A second
  signal hard-exits ``128 + signum`` immediately.
- **process chaos** (testing/faults.py :class:`ProcessKillPlan` /
  :func:`run_job_subprocess`): a real job is SIGTERM/SIGKILL'd at a
  seeded staged point and the resumed job must complete with
  oracle-parity ranks and bounded recomputed work, bit-for-bit
  reproducibly.

Telemetry rides the existing planes: ``job.*`` gauges/counters
(stage, resumes, stages skipped, drain seconds), ``job/<stage>``
spans, and a ``job`` section in the run report that ``obs report``
diffs.

Library modules stay handler-free for embeddability: lint **PTL008**
(analysis/lint.py) bans ``signal.signal``/``atexit.register`` outside
this module and ``cli.py``.

Copy of ``pagerank_tpu/jobs.py`` (the stage machine, its artifacts and
hashes, ``RestoredIds``, ``graph_to_arrays``/``graph_from_arrays``,
``JobSupervisor`` and the drain, and the graph-profile artifact
``save_profile``/``load_profile``, :650-675), the same artifact zip
layout and digest, so an artifact saved by either package loads in the
other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import signal
import time
import warnings
import zipfile
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from pagerank_tpu_torch.exitcodes import hard_exit_code
from pagerank_tpu_torch.obs import live as obs_live
from pagerank_tpu_torch.obs import log as obs_log
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.obs import trace as obs_trace
from pagerank_tpu_torch.utils import fsio

#: The stage machine, in execution order. ``ingest`` parses/loads (or
#: restores) the host-side inputs, ``build`` packs the device layout,
#: ``solve`` iterates, ``output`` writes the final ranks.
STAGES = ("ingest", "build", "solve", "output")

MANIFEST_NAME = "job.json"
MANIFEST_SCHEMA = 1

#: Default drain deadline (seconds): GCE preemption notice is 30 s; the
#: drain must flush inside it or give up the slower sinks.
DEFAULT_DRAIN_DEADLINE_S = 20.0


class DrainInterrupt(BaseException):
    """Raised at a safe point (stage boundary / completed iteration)
    after a drain request. A BaseException on purpose: no best-effort
    ``except Exception`` site (SinkGuard, telemetry exporters) may ever
    swallow a preemption — the PTL006 discipline applied to signals."""

    def __init__(self, signum: int, where: str = ""):
        super().__init__(
            f"drain requested by signal {signum}"
            + (f" (at {where})" if where else "")
        )
        self.signum = signum
        self.where = where


class ArtifactCorruptError(RuntimeError):
    """A stage artifact exists but cannot be trusted: unreadable npz,
    missing members, or checksum mismatch. The loader converts this to
    skip-and-recompute (the snapshot discipline) — it never
    propagates out of :meth:`JobSupervisor.load_artifact`."""


# -- config hashing ---------------------------------------------------------

#: Config fields that shape the GRAPH/LAYOUT artifact (ingest/build
#: stages): a change here means the packed planes are for a different
#: layout and must be rebuilt.
GRAPH_HASH_FIELDS = (
    "dtype", "accum_dtype", "kernel", "lane_group", "wide_accum",
    "partition_span", "stream_dtype", "vertex_sharded", "vs_bounded",
    "halo_exchange", "halo_head",
)

#: Config fields that shape the SOLVE result (solve-stage artifact):
#: anything that can move the final rank vector or the iteration count.
SOLVE_HASH_FIELDS = GRAPH_HASH_FIELDS + (
    "num_iters", "damping", "semantics", "tol", "stop_tol",
    "probe_every", "num_devices",
)


def _hash_fields(cfg, fields: Iterable[str]) -> str:
    d = dataclasses.asdict(cfg)
    doc = {k: d.get(k) for k in fields}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()
    ).hexdigest()[:16]


def graph_config_hash(cfg) -> str:
    """Layout-relevant config hash: keys the ingest/build artifacts."""
    return _hash_fields(cfg, GRAPH_HASH_FIELDS)


def solve_config_hash(cfg) -> str:
    """Result-relevant config hash: keys the solve-stage artifact."""
    return _hash_fields(cfg, SOLVE_HASH_FIELDS)


def key_hash(key: Dict[str, object]) -> str:
    """Stable hash of an arbitrary JSON-able key dict (the CLI keys
    ingest/build artifacts off the input spec + layout args BEFORE a
    PageRankConfig exists)."""
    return hashlib.sha256(
        json.dumps(key, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


# -- artifact format --------------------------------------------------------


def _artifact_digest(arrays: Dict[str, np.ndarray], meta_json: str) -> str:
    """sha256 over the meta json AND every payload array (name, dtype,
    shape, bytes) — a corrupt header is as fatal as corrupt planes
    (the Snapshotter._digest discipline)."""
    h = hashlib.sha256()
    h.update(meta_json.encode())
    for name in sorted(arrays):
        a = arrays[name]
        h.update(f"|{name}|{a.dtype.str}|{a.shape}|".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def save_artifact(path: str, arrays: Dict[str, np.ndarray],
                  meta: Dict[str, object]) -> str:
    """Atomically persist one stage artifact: payload arrays + JSON
    meta + a sha256 checksum over both. A killed writer leaves at
    worst a ``*.tmp.npz`` no loader matches (fsio.atomic_write)."""
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    meta_json = json.dumps(meta, sort_keys=True, allow_nan=False)
    digest = _artifact_digest(arrays, meta_json)
    with obs_trace.span("job/artifact_save", path=path) as sp:
        with fsio.atomic_write(path, "wb", suffix=".tmp.npz") as f:
            np.savez(
                f,
                meta=np.bytes_(meta_json.encode()),
                checksum=np.bytes_(digest.encode()),
                **arrays,
            )
            nbytes = f.tell()
        obs_metrics.counter(
            "job.artifact_bytes_written",
            "total stage-artifact payload bytes committed",
        ).inc(nbytes)
        if sp is not None:
            sp.attrs["bytes"] = nbytes
    return path


def load_artifact(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Load + verify one stage artifact. Raises FileNotFoundError when
    absent and :class:`ArtifactCorruptError` when present but
    unreadable or failing its checksum — callers recompute, never
    trust."""
    try:
        with fsio.fopen(path, "rb") as f, np.load(f) as z:
            meta_json = bytes(z["meta"]).decode()
            stored = bytes(z["checksum"]).decode()
            arrays = {
                k: z[k].copy() for k in z.files
                if k not in ("meta", "checksum")
            }
    except FileNotFoundError:
        raise
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as e:
        raise ArtifactCorruptError(
            f"stage artifact {path} is unreadable: {e!r}"
        ) from e
    want = _artifact_digest(arrays, meta_json)
    if stored != want:
        raise ArtifactCorruptError(
            f"stage artifact {path} failed its checksum "
            f"(stored {stored[:12]}…, computed {want[:12]}…)"
        )
    return arrays, json.loads(meta_json)


def encode_names(names) -> Dict[str, np.ndarray]:
    """Vertex-name table as (utf-8 blob, int64 offsets) payload arrays
    — object arrays would drag pickle into the artifact format."""
    enc = [str(k).encode("utf-8") for k in names]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) for b in enc], out=offs[1:])
    return {
        "names_blob": np.frombuffer(b"".join(enc), dtype=np.uint8),
        "names_offs": offs,
    }


def decode_names(arrays: Dict[str, np.ndarray]) -> Optional[List[str]]:
    if "names_blob" not in arrays or "names_offs" not in arrays:
        return None
    blob = arrays["names_blob"].tobytes()
    offs = arrays["names_offs"]
    return [
        blob[offs[i]:offs[i + 1]].decode("utf-8")
        for i in range(len(offs) - 1)
    ]


def doc_to_arrays(doc) -> Dict[str, np.ndarray]:
    """A JSON document as a payload-array dict (a utf-8 blob, the
    encode_names idiom), so that a measurement record rides the same
    checksummed artifact format as the numeric planes: the campaign's
    per-leg artifacts (obs/campaign.py)."""
    blob = json.dumps(doc, sort_keys=True, allow_nan=False,
                      default=str).encode("utf-8")
    return {"doc_blob": np.frombuffer(blob, dtype=np.uint8)}


def doc_from_arrays(arrays: Dict[str, np.ndarray]):
    """Inverse of :func:`doc_to_arrays`; None when the payload carries no
    document."""
    if "doc_blob" not in arrays:
        return None
    return json.loads(arrays["doc_blob"].tobytes().decode("utf-8"))


class RestoredIds:
    """Thin stand-in for an ingest id table restored from an artifact:
    the post-ingest CLI only reads ``.names`` (text dumps / --out)."""

    def __init__(self, names: List[str]):
        self.names = names


# -- host-graph artifact marshalling ---------------------------------------

_GRAPH_ARRAYS = ("src", "dst", "out_degree", "in_degree",
                 "dangling_mask", "zero_in_mask", "edge_weight")


def graph_to_arrays(graph) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Host :class:`~pagerank_tpu_torch.graph.Graph` -> artifact payload.
    The BUILT graph is the artifact (post-dedup/sort), so a restart
    skips the host parse AND the host sort."""
    arrays = {k: np.asarray(getattr(graph, k)) for k in _GRAPH_ARRAYS}
    if graph.vertex_names is not None:
        arrays.update(encode_names(graph.vertex_names))
    meta = {
        "kind": "host_graph",
        "n": int(graph.n),
        "num_edges": int(graph.num_edges),
        "fingerprint": graph.fingerprint(),
    }
    return arrays, meta


def graph_from_arrays(arrays: Dict[str, np.ndarray], meta: Dict):
    from pagerank_tpu_torch.graph import Graph

    names = decode_names(arrays)
    g = Graph(
        n=int(meta["n"]),
        vertex_names=names,
        **{k: arrays[k] for k in _GRAPH_ARRAYS},
    )
    fp = g.fingerprint()
    if fp != meta.get("fingerprint"):
        raise ArtifactCorruptError(
            f"restored host graph fingerprint {fp} != recorded "
            f"{meta.get('fingerprint')}"
        )
    return g


# -- graceful drain ---------------------------------------------------------


class GracefulDrain:
    """SIGTERM/SIGINT -> deadline-bounded drain request (the tentpole's
    preemption half). Context manager; install ONLY around the CLI
    entry point — library modules must stay handler-free (PTL008).

    First signal: records the request (``job.drain_requests`` counter,
    loud log line) and returns — the run notices at its next safe
    point (:meth:`check` raises :class:`DrainInterrupt` there). Second
    signal: hard-exits ``128 + signum`` immediately via the injectable
    ``hard_exit`` (``os._exit`` by default — no flush, the operator
    asked twice).

    Injectable for tests: ``install`` (defaults to ``signal.signal``),
    ``hard_exit``, and ``clock``. Installation degrades to a no-op
    (with a log line) off the main thread, where CPython refuses
    handlers — an embedded library use keeps working, just without
    drain."""

    def __init__(
        self,
        deadline_s: float = DEFAULT_DRAIN_DEADLINE_S,
        signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT),
        install=signal.signal,
        hard_exit=os._exit,
        clock=time.monotonic,
    ):
        self.deadline_s = float(deadline_s)
        self._signals = tuple(signals)
        self._install = install
        self._hard_exit = hard_exit
        self._clock = clock
        self._prev: Dict[int, object] = {}
        self._installed = False
        self.requested = False
        self.signum: Optional[int] = None
        self._t_request: Optional[float] = None
        # Pre-allocated handler flag: the handler may only SET simple
        # scalars (PTR003); the counter/log emission it used to do
        # in-handler is deferred to the next safe point.
        self._pending_note = False

    # -- handler lifecycle --------------------------------------------------

    def __enter__(self) -> "GracefulDrain":
        for s in self._signals:
            try:
                self._prev[s] = self._install(s, self._handler)
            except ValueError as e:
                # Non-main thread: CPython refuses handlers. Degrade —
                # embedded callers keep working without drain.
                obs_log.info(
                    f"signal handlers unavailable ({e}); preemption "
                    "drain disabled for this run"
                )
                break
        else:
            self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            try:
                self._install(s, prev)
            except ValueError:
                pass
        self._prev.clear()
        self._installed = False

    def _handler(self, signum, frame) -> None:
        """Signal-handler context (PTR003, docs/ANALYSIS.md): this body
        may only set pre-allocated flags/simple scalars. CPython runs
        handlers ON THE MAIN THREAD between bytecodes — a handler that
        takes a lock (the pre-fix ``obs_log.warn`` reached the
        tracer's ``add_event`` lock, and the registry get-or-create
        takes the registry lock) self-deadlocks the moment the signal
        lands while the main thread holds that lock. Telemetry is
        deferred to :meth:`_note_request` at the next safe point;
        ``hard_exit`` (``os._exit``) is the sanctioned exception — the
        operator asked twice — and so is the KeyboardInterrupt of a
        SIGINT that the armed stall watchdog sent with a rescue request
        pending (what Python's own SIGINT handler would raise)."""
        if signum == signal.SIGINT:
            wd = obs_live.get_watchdog()
            if wd is not None and wd.rescue_requested:
                # Not an operator's signal: the stall watchdog's rescue
                # fire (``interrupt_main``). The elastic runner takes it
                # as the KeyboardInterrupt of its handshake.
                raise KeyboardInterrupt
        if self.requested:
            # Second signal: the operator means NOW.
            self._hard_exit(hard_exit_code(signum))
            return  # injectable hard_exit may not exit (tests)
        self.requested = True
        self.signum = int(signum)
        self._t_request = self._clock()
        self._pending_note = True

    def _note_request(self) -> None:
        """Emit the drain request's counter + log line OUTSIDE handler
        context — called from every drain-side entry point (check /
        remaining / finish), so the first safe point after the signal
        reports it exactly once."""
        if not self._pending_note:
            return
        self._pending_note = False
        obs_metrics.counter(
            "job.drain_requests",
            "graceful-drain requests received (first SIGTERM/SIGINT)",
        ).inc()
        obs_log.warn(
            f"signal {self.signum}: draining (deadline "
            f"{self.deadline_s:g}s; a second signal hard-exits)"
        )

    # -- drain-side API -----------------------------------------------------

    def check(self, where: str = "") -> None:
        """Raise :class:`DrainInterrupt` when a drain was requested —
        call at safe points only (stage boundaries, completed
        iterations): the in-flight step always finishes."""
        if self.requested:
            self._note_request()
            raise DrainInterrupt(self.signum or 0, where)

    def check_agreed(self, reduce, where: str = "") -> None:
        """:meth:`check` for one rank of a process group, where every
        rank calls it at the same safe point: ``reduce`` sums an int
        over the ranks, and all of them raise if any had a request when
        it got there. The flag is read once, so a signal that lands
        after it was read counts at the next safe point on every rank
        alike. Ranks must stop after the same step: a drain's final
        snapshot is itself a collective, and ranks a step apart would
        pair its gather with the other step's. A request from another
        rank does not count as this rank's first signal (so the signal
        that reaches it later does not hard-exit the drain)."""
        if not reduce(int(self.requested)):
            return
        if self._t_request is None:
            self._t_request = self._clock()
        self._note_request()
        raise DrainInterrupt(self.signum or 0, where)

    def remaining(self) -> Optional[float]:
        """Seconds left of the drain deadline (None before a request,
        never below a small positive floor so bounded flushes still
        get one attempt)."""
        if self._t_request is None:
            return None
        self._note_request()
        left = self.deadline_s - (self._clock() - self._t_request)
        return max(0.5, left)

    def finish(self) -> float:
        """Record the drain's wall (request -> flushes done) in the
        ``job.drain_seconds`` gauge; returns it."""
        self._note_request()
        spent = (
            self._clock() - self._t_request
            if self._t_request is not None else 0.0
        )
        obs_metrics.gauge(
            "job.drain_seconds",
            "wall seconds between the drain request and the final "
            "flush",
        ).set(spent)
        return spent


# -- the stage machine ------------------------------------------------------


class JobSupervisor:
    """Durable stage machine over a job directory.

    The manifest (``job.json``, atomic rewrite per transition) records
    stage statuses and the resume count — it is ADVISORY: truth about
    whether a stage can be skipped lives in its artifact's checksum +
    key validation, so a torn manifest costs bookkeeping, never
    correctness. Artifacts live next to it (``ingest.npz`` /
    ``build.npz`` / ``solve.npz``) plus the ``snapshots/`` dir the
    solve stage reuses for its iteration checkpoints.

    Over a process group rank 0 owns the directory; every other rank
    holds a ``write=False`` supervisor, made after rank 0's: it reads
    the manifest rank 0 wrote (its resume already counted), follows the
    same stage transitions in memory and writes nothing. A rank that
    comes to own the outputs (rank 0 of a group an elastic rescue
    formed) sets :attr:`write`."""

    def __init__(self, directory: str, clock=time.perf_counter,
                 write: bool = True):
        self.directory = directory
        self._clock = clock
        self._t0: Dict[str, float] = {}
        self._skipped_this_run = 0
        #: Whether this supervisor writes the manifest and artifacts.
        self.write = bool(write)
        from pagerank_tpu_torch.testing.faults import ProcessKillPlan

        if not self.write:
            self.manifest = self._read_manifest() or self._fresh_manifest()
            self.resumed = int(self.manifest.get("resumes", 0)) > 0
            self.chaos = ProcessKillPlan.from_env()
            return
        fsio.makedirs(directory, exist_ok=True)
        self.manifest = self._read_manifest()
        self.resumed = self.manifest is not None
        if self.manifest is None:
            self.manifest = self._fresh_manifest()
        else:
            self.manifest["resumes"] = int(
                self.manifest.get("resumes", 0)) + 1
            self.manifest["status"] = "running"
            obs_metrics.counter(
                "job.resumes",
                "job restarts that found a prior manifest in --job-dir",
            ).inc()
            obs_log.info(
                f"resuming job in {directory} (resume #"
                f"{self.manifest['resumes']})"
            )
        self._write_manifest()
        # Seeded process-kill chaos (testing/faults.py): active only
        # when the env plan is set — zero cost otherwise.
        self.chaos = ProcessKillPlan.from_env()

    # -- manifest -----------------------------------------------------------

    @staticmethod
    def _fresh_manifest() -> Dict:
        return {
            "schema_version": MANIFEST_SCHEMA,
            "created_unix": time.time(),
            "resumes": 0,
            "status": "running",
            "stages": {s: {"status": "pending"} for s in STAGES},
        }

    @property
    def manifest_path(self) -> str:
        return fsio.join(self.directory, MANIFEST_NAME)

    def _read_manifest(self) -> Optional[Dict]:
        try:
            with fsio.fopen(self.manifest_path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            warnings.warn(
                f"job manifest {self.manifest_path} unreadable ({e!r}); "
                "starting a fresh manifest (artifacts still validate "
                "independently)", RuntimeWarning,
            )
            return None
        if not isinstance(doc, dict) or "stages" not in doc:
            return None
        for s in STAGES:
            doc["stages"].setdefault(s, {"status": "pending"})
        return doc

    def _write_manifest(self) -> None:
        if not self.write:
            return
        with fsio.atomic_write(self.manifest_path, "w") as f:
            json.dump(self.manifest, f, indent=2, allow_nan=False)
            f.write("\n")

    # -- stage lifecycle ----------------------------------------------------

    def artifact_path(self, stage: str) -> str:
        return fsio.join(self.directory, f"{stage}.npz")

    def snapshots_dir(self) -> str:
        return fsio.join(self.directory, "snapshots")

    def _set(self, stage: str, status: str, **detail) -> None:
        rec = self.manifest["stages"].setdefault(stage, {})
        rec["status"] = status
        rec.update(detail)
        self._write_manifest()

    def begin(self, stage: str) -> None:
        self.tick(stage)
        self._t0[stage] = self._clock()
        obs_metrics.gauge(
            "job.stage", "index of the stage the job is executing "
            "(0=ingest 1=build 2=solve 3=output)",
        ).set(STAGES.index(stage) if stage in STAGES else -1)
        self._set(stage, "running")

    def complete(self, stage: str, **detail) -> None:
        wall = (
            self._clock() - self._t0[stage]
            if stage in self._t0 else None
        )
        self._set(stage, "done", wall_s=wall, skipped=False, **detail)

    def skip(self, stage: str, **detail) -> None:
        """Stage satisfied by a validated durable artifact — record it
        and bump the skip telemetry (the resume's whole point). The
        gauge counts THIS run's skips from an instance counter, not
        the manifest — a reloaded manifest still carries the PRIOR
        run's skipped flags."""
        self.tick(stage)
        self._skipped_this_run += 1
        obs_metrics.gauge(
            "job.stages_skipped",
            "stages satisfied by validated durable artifacts this run",
        ).set(self._skipped_this_run)
        self._set(stage, "done", skipped=True, wall_s=0.0, **detail)
        if self.write:
            obs_log.info(f"job stage '{stage}' skipped (durable artifact)")

    def interrupt(self, stage: str, **detail) -> None:
        """Mark the manifest interrupted at ``stage``. A stage whose
        record is already ``done`` is NOT downgraded — the post-commit
        drain checkpoints raise with the COMPLETED stage's name, and
        its artifact is durable; the interrupt point rides the
        manifest-level ``interrupted_after`` instead, so the report
        still answers "did we lose the build" correctly (no)."""
        self.manifest["status"] = "interrupted"
        rec = self.manifest["stages"].get(stage, {})
        if rec.get("status") == "done":
            self.manifest["interrupted_after"] = stage
            self.manifest.update(
                {f"interrupt_{k}": v for k, v in detail.items()})
            self._write_manifest()
            return
        self._set(stage, "interrupted", **detail)

    def finish(self) -> None:
        self.manifest["status"] = "complete"
        self._write_manifest()

    def stage_span(self, stage: str):
        """``job/<stage>`` span + begin bookkeeping (the caller marks
        complete/skip — completion detail differs per stage)."""
        self.begin(stage)
        return obs_trace.span(f"job/{stage}")

    def tick(self, stage: str, iteration: Optional[int] = None) -> None:
        """Chaos hook: the seeded process-kill plan fires here (stage
        boundaries + per solve iteration). No-op without a plan."""
        if self.chaos is not None:
            self.chaos.check(stage, iteration)

    # -- artifacts ----------------------------------------------------------

    def save_stage_artifact(self, stage: str,
                            arrays: Dict[str, np.ndarray],
                            meta: Dict[str, object]) -> str:
        if not self.write:
            return self.artifact_path(stage)
        meta = dict(meta)
        meta["stage"] = stage
        return save_artifact(self.artifact_path(stage), arrays, meta)

    def load_stage_artifact(
        self, stage: str, expect: Optional[Dict[str, object]] = None,
    ) -> Optional[Tuple[Dict[str, np.ndarray], Dict]]:
        """Validated artifact for ``stage``, or None (absent, corrupt,
        or key-mismatched — each logged; corrupt/mismatched artifacts
        are recomputed, never trusted)."""
        path = self.artifact_path(stage)
        try:
            arrays, meta = load_artifact(path)
        except FileNotFoundError:
            return None
        except ArtifactCorruptError as e:
            obs_metrics.counter(
                "job.artifacts_rejected",
                "stage artifacts rejected at resume (corrupt or "
                "key-mismatched) and recomputed",
            ).inc()
            warnings.warn(
                f"job stage '{stage}': corrupt artifact recomputed "
                f"({e})", RuntimeWarning,
            )
            return None
        for k, v in (expect or {}).items():
            if meta.get(k) != v:
                obs_metrics.counter(
                    "job.artifacts_rejected",
                    "stage artifacts rejected at resume (corrupt or "
                    "key-mismatched) and recomputed",
                ).inc()
                warnings.warn(
                    f"job stage '{stage}': artifact key mismatch "
                    f"({k}: artifact {meta.get(k)!r} != run {v!r}); "
                    "recomputing", RuntimeWarning,
                )
                return None
        return arrays, meta

    # -- SDC quarantine persistence (sdc.py) ---------------------------------

    def quarantined_devices(self) -> List[int]:
        """Device ids convicted of sticky silent data corruption in
        ANY run of this job — a resumed job must never re-adopt a
        known-bad chip, so the exclusion list rides the manifest
        (atomic rewrite, like every stage transition)."""
        return [int(d) for d in
                self.manifest.get("quarantined_devices", [])]

    def quarantine_devices(self, device_ids) -> None:
        """Merge freshly convicted device ids into the persisted
        exclusion list (idempotent; survives resumes)."""
        have = set(self.quarantined_devices())
        new = sorted(have | {int(d) for d in device_ids})
        if new == sorted(have):
            return
        self.manifest["quarantined_devices"] = new
        self._write_manifest()

    def save_profile(self, profile) -> None:
        """Persist the data-plane graph profile
        (obs/graph_profile.GraphProfile) as a checksummed artifact next
        to the stage artifacts, keyed by graph fingerprint — a resumed
        build-skipping run republishes it instead of losing the data
        plane (the post-sort packed planes can't re-derive the raw
        dedup stats)."""
        if not self.write:
            return
        arrays, meta = profile.to_arrays()
        save_artifact(
            fsio.join(self.directory, "profile.npz"), arrays, meta)

    def load_profile(self, fingerprint: Optional[str]):
        """Validated graph-profile artifact matching ``fingerprint``,
        or None (absent / corrupt / fingerprint-mismatched — the same
        never-trust discipline as the stage artifacts)."""
        from pagerank_tpu_torch.obs.graph_profile import GraphProfile

        path = fsio.join(self.directory, "profile.npz")
        try:
            arrays, meta = load_artifact(path)
        except FileNotFoundError:
            return None
        except ArtifactCorruptError as e:
            obs_metrics.counter(
                "job.artifacts_rejected",
                "stage artifacts rejected at resume (corrupt or "
                "key-mismatched) and recomputed",
            ).inc()
            warnings.warn(
                f"job graph-profile artifact rejected ({e})",
                RuntimeWarning,
            )
            return None
        if fingerprint is not None and \
                meta.get("fingerprint") != fingerprint:
            obs_metrics.counter(
                "job.artifacts_rejected",
                "stage artifacts rejected at resume (corrupt or "
                "key-mismatched) and recomputed",
            ).inc()
            warnings.warn(
                f"job graph-profile artifact is for a different graph "
                f"({meta.get('fingerprint')!r} != {fingerprint!r}); "
                "ignored", RuntimeWarning,
            )
            return None
        try:
            return GraphProfile.from_arrays(arrays, meta)
        except (KeyError, ValueError) as e:
            warnings.warn(
                f"job graph-profile artifact undecodable ({e!r})",
                RuntimeWarning,
            )
            return None

    def save_names(self, names, key: str) -> None:
        """Persist an ingest id->name table (crawl inputs) next to the
        stage artifacts so a resumed job's --out/--dump-text-dir still
        writes urls, not integer ids."""
        if not self.write:
            return
        save_artifact(
            fsio.join(self.directory, "names.npz"),
            encode_names(names), {"key": key, "kind": "names"},
        )

    def load_names(self, key: str) -> Optional[List[str]]:
        try:
            arrays, meta = load_artifact(
                fsio.join(self.directory, "names.npz"))
        except (FileNotFoundError, ArtifactCorruptError):
            return None
        if meta.get("key") != key:
            return None
        return decode_names(arrays)

    # -- reporting ----------------------------------------------------------

    def report_section(self) -> Dict[str, object]:
        """The run report's ``job`` section (obs/report.py REPORT_KEYS;
        diffed by ``obs report A B``)."""
        stages = {
            s: {
                "status": r.get("status"),
                "skipped": bool(r.get("skipped", False)),
                "wall_s": r.get("wall_s"),
                **{k: v for k, v in r.items()
                   if k not in ("status", "skipped", "wall_s")},
            }
            for s, r in self.manifest["stages"].items()
        }
        out = {
            "dir": self.directory,
            "status": self.manifest.get("status"),
            "resumes": int(self.manifest.get("resumes", 0)),
            "stages": stages,
        }
        if "interrupted_after" in self.manifest:
            out["interrupted_after"] = self.manifest["interrupted_after"]
        quarantined = self.quarantined_devices()
        if quarantined:
            out["quarantined_devices"] = quarantined
        return out
