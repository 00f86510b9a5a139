"""Checkpoint / resume (SURVEY.md §5).

The reference's de-facto checkpoint is ``saveAsTextFile`` of the full
rank vector after every iteration (Sparky.java:237) with no resume logic.
Here snapshots are first-class: (ranks, iteration, graph fingerprint,
semantics, content checksum) per file, a ``latest()`` scan, and
``resume_engine`` that validates the fingerprint before restoring —
restart-from-latest is the failure-recovery story (kill-and-resume is
tested in tests/test_snapshot.py). Every save is atomic
(fsio.atomic_write: tmp + rename) and every load verifies the sha256
sidecar, so a torn, truncated, or bit-flipped snapshot is DETECTED and
skipped (``load_latest_valid``) rather than resumed into — the rollback
substrate for the self-healing solve loop (engine.run;
docs/ROBUSTNESS.md).

Port of ``pagerank_tpu/utils/snapshot.py``: ``Snapshotter`` over fsio
(any registered URI scheme), ``TextDumper`` (``PageRank{i}/part-00000``
+ ``_SUCCESS``, byte for byte; the route that formatted the last dump
in ``route``), ``SinkGuard`` (retry policy, dead-letter manifest),
``AsyncRankWriter`` (its payload the torch engine's
``device_ranks()``: the relabel undone and the copy to pinned host
memory on a side CUDA stream, waited on by the worker thread; the
writer records its queue waits,
decode and item seconds), ``WriterSyncedSnapshotter`` and
``resume_engine``.
The on-disk formats are the JAX package's, so a snapshot directory or
a text dump written by either package reads in the other.
"""

from __future__ import annotations

import hashlib
import json
import queue
import re
import threading
import time
import warnings
import zipfile
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from pagerank_tpu_torch.obs import log as obs_log
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.obs import trace as obs_trace
from pagerank_tpu_torch.utils import fsio
from pagerank_tpu_torch.utils.retry import RetryPolicy

_PAT = re.compile(r"^ranks_iter(\d+)\.npz$")


class SnapshotCorruptError(RuntimeError):
    """A snapshot file exists but cannot be trusted: unreadable npz,
    missing members, or checksum mismatch. Distinct from
    FileNotFoundError (no snapshot) and ValueError (valid snapshot,
    wrong graph/semantics) so recovery code can skip-and-fall-back on
    corruption while still failing loudly on real mismatches."""


def _digest(ranks: np.ndarray, iteration: int, fingerprint: str,
            semantics: str, mesh: str = "") -> str:
    """sha256 over the rank payload AND its identifying metadata — a
    corrupt header is as fatal as corrupt ranks. ``mesh`` is the
    mesh-topology JSON when the snapshot carries one (empty keeps the
    pre-elastic digest, so older snapshots still verify)."""
    h = hashlib.sha256()
    h.update(
        f"{iteration}|{fingerprint}|{semantics}|"
        f"{ranks.dtype.str}|{ranks.shape}|".encode()
    )
    if mesh:
        h.update(f"mesh:{mesh}|".encode())
    h.update(np.ascontiguousarray(ranks).tobytes())
    return h.hexdigest()


def _gather_to_host(ranks) -> np.ndarray:
    """ONE host-resident contiguous buffer from whatever the caller
    handed us (a numpy array or a torch tensor on any device), so the
    checksum covers the exact bytes ``np.savez`` writes."""
    if isinstance(ranks, np.ndarray):
        return np.ascontiguousarray(ranks)
    if hasattr(ranks, "detach"):
        ranks = ranks.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(ranks))


class Snapshotter:
    """Writes ``ranks_iter{i}.npz`` files into ``directory`` — a local
    path or any registered URI scheme (utils/fsio; the reference's sink
    is an S3 bucket, Sparky.java:237).

    Snapshots are MESH-SHAPE-AGNOSTIC: the payload is always
    the canonical host-order rank vector (``_gather_to_host`` assembles
    sharded device buffers first), and ``mesh_meta`` — the mesh
    topology + partition geometry of the engine that produced it
    (``JaxTpuEngine.snapshot_meta``) — rides as checksummed JSON
    metadata. A snapshot taken on N devices therefore restores onto
    any M-device (or single-device) mesh: ``resume_engine`` hands the
    canonical vector to ``engine.set_ranks``, which re-shards it
    through the target mesh's own placement (the elastic rescue's
    warm-start, parallel/elastic.py). ``mesh_meta`` is diagnostic
    provenance, never a restore constraint."""

    def __init__(self, directory: str, graph_fingerprint: str,
                 semantics: str, mesh_meta: Optional[Dict] = None):
        self.directory = directory
        self.fingerprint = graph_fingerprint
        self.semantics = semantics
        #: Provenance recorded in every save (mutable: the elastic
        #: runner updates it after a rescue re-shards the mesh).
        self.mesh_meta = mesh_meta
        fsio.makedirs(directory, exist_ok=True)

    def path(self, iteration: int) -> str:
        return fsio.join(self.directory, f"ranks_iter{iteration}.npz")

    def save(self, iteration: int, ranks: np.ndarray) -> str:
        p = self.path(iteration)
        with obs_trace.span("snapshot/save", iteration=iteration) as sp:
            # Gather BEFORE checksumming: a sharded engine's device
            # array becomes one host buffer, so the digest covers the
            # exact bytes np.savez writes (the torn-shard hazard).
            ranks = _gather_to_host(ranks)
            mesh_json = (
                json.dumps(self.mesh_meta, sort_keys=True)
                if self.mesh_meta else ""
            )
            members = {}
            if mesh_json:
                members["mesh"] = np.bytes_(mesh_json.encode())
            # atomic: a killed run never leaves a torn file under the
            # consumers' name pattern (suffix keeps the historical
            # *.tmp.npz spelling tests/test_hardening.py filters on)
            with fsio.atomic_write(p, "wb", suffix=".tmp.npz") as f:
                np.savez(
                    f,
                    ranks=ranks,
                    iteration=np.int64(iteration),
                    fingerprint=np.bytes_(self.fingerprint.encode()),
                    semantics=np.bytes_(self.semantics.encode()),
                    checksum=np.bytes_(
                        _digest(ranks, iteration, self.fingerprint,
                                self.semantics, mesh_json).encode()
                    ),
                    **members,
                )
                nbytes = f.tell()
            obs_metrics.counter(
                "snapshot.bytes_written",
                "total snapshot payload bytes committed",
            ).inc(nbytes)
            obs_metrics.histogram(
                "snapshot.save_bytes", "per-snapshot file size"
            ).record(nbytes)
            if sp is not None:
                sp.attrs["bytes"] = nbytes
        return p

    def iterations(self) -> List[int]:
        """All snapshot iterations present, ascending (by NAME only —
        no validity check; load_latest_valid does that)."""
        try:
            entries = fsio.listdir(self.directory)
        except FileNotFoundError:
            return []
        out = []
        for name in entries:
            m = _PAT.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        its = self.iterations()
        return its[-1] if its else None

    def load(self, iteration: int, verify: bool = True
             ) -> Tuple[np.ndarray, Dict[str, str]]:
        """Load one snapshot. Raises FileNotFoundError when absent and
        :class:`SnapshotCorruptError` when present but unreadable or
        failing its checksum. Pre-checksum snapshots (no ``checksum``
        member) load with a warning — their integrity is unverifiable."""
        path = self.path(iteration)
        try:
            with fsio.fopen(path, "rb") as f, np.load(f) as z:
                meta = {
                    "fingerprint": bytes(z["fingerprint"]).decode(),
                    "semantics": bytes(z["semantics"]).decode(),
                    "iteration": int(z["iteration"]),
                }
                mesh_json = (
                    bytes(z["mesh"]).decode() if "mesh" in z.files else ""
                )
                # Parsed topology/geometry provenance (None on
                # pre-elastic snapshots): purely diagnostic — a resume
                # onto a different mesh shape is the DESIGN, not an
                # error (docs/ROBUSTNESS.md "Elastic solve").
                meta["mesh"] = json.loads(mesh_json) if mesh_json else None
                ranks = z["ranks"].copy()
                stored = (
                    bytes(z["checksum"]).decode()
                    if "checksum" in z.files else None
                )
        except FileNotFoundError:
            raise
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            raise SnapshotCorruptError(
                f"snapshot {path} is unreadable: {e!r}"
            ) from e
        if verify:
            if stored is None:
                warnings.warn(
                    f"snapshot {path} predates content checksums; "
                    f"integrity not verifiable", RuntimeWarning,
                )
            else:
                want = _digest(ranks, meta["iteration"],
                               meta["fingerprint"], meta["semantics"],
                               mesh_json)
                if stored != want:
                    raise SnapshotCorruptError(
                        f"snapshot {path} failed its checksum "
                        f"(stored {stored[:12]}…, computed {want[:12]}…)"
                    )
        return ranks, meta

    def load_latest_valid(
        self, max_iteration: Optional[int] = None, match: bool = False
    ) -> Optional[Tuple[int, np.ndarray, Dict[str, str]]]:
        """Newest loadable, checksum-valid snapshot (optionally at or
        below ``max_iteration``): ``(iteration, ranks, meta)`` or None.
        Corrupt/truncated files are skipped WITH A WARNING and the scan
        falls back to the next older one — a damaged snapshot directory
        degrades recovery granularity, never crashes it.

        ``match=True`` additionally skips (with a warning) snapshots
        whose fingerprint/semantics differ from this Snapshotter's —
        the ROLLBACK contract (engine.run must never restore another
        graph's ranks, e.g. from a reused --snapshot-dir). The resume
        path keeps ``match=False`` so a mismatch RAISES there
        (resume_engine) instead of silently starting over."""
        for it in reversed(self.iterations()):
            if max_iteration is not None and it > max_iteration:
                continue
            try:
                ranks, meta = self.load(it)
            except FileNotFoundError:
                continue  # raced with cleanup
            except SnapshotCorruptError as e:
                warnings.warn(
                    f"skipping corrupt snapshot for iteration {it}: {e}",
                    RuntimeWarning,
                )
                continue
            if match and (meta["fingerprint"] != self.fingerprint
                          or meta["semantics"] != self.semantics):
                warnings.warn(
                    f"skipping snapshot for iteration {it}: taken on a "
                    f"different graph/semantics "
                    f"({meta['fingerprint'][:12]}…/{meta['semantics']} vs "
                    f"{self.fingerprint[:12]}…/{self.semantics})",
                    RuntimeWarning,
                )
                continue
            return it, ranks, meta
        return None

class TextDumper:
    """Per-iteration plain-text rank dumps mirroring the reference's
    ``ranks.saveAsTextFile("…/PageRank"+iter+"/")`` (Sparky.java:237):
    one directory per iteration, ``(key,rank)`` tuple lines, Spark
    part-file naming. Pair with :class:`Snapshotter` when you also want
    binary resumable checkpoints.

    Formatting goes through the native bulk formatter when the library
    is available (ingest/native.format_rank_lines_native — byte-
    identical output, ~40x the per-line Python loop; the loop remains
    as the no-toolchain fallback). The reference's per-iteration dump
    is most of its L4 wall-clock, so the formatter rate is a first-
    class number. ``route`` says which formatter wrote the last dump:
    "native", or "python" when any chunk took the loop."""

    def __init__(self, directory: str, names=None):
        self.directory = directory
        self.names = names
        self._blob: Optional[Tuple[bytes, np.ndarray]] = None
        self.route: Optional[str] = None
        fsio.makedirs(directory, exist_ok=True)

    def _names_blob(self, n: int):
        """(utf-8 blob, int64 offsets) for the first n names; None when
        the name table can't feed the native path (length mismatch or
        non-utf-8-encodable names — the Python loop handles those by
        crashing identically or writing the str form)."""
        if self._blob is None or self._blob[1].shape[0] != n + 1:
            if len(self.names) < n:
                return None
            try:
                enc = [
                    str(k).encode("utf-8") for k in self.names[:n]
                ]
            except UnicodeEncodeError:
                return None
            offs = np.zeros(n + 1, np.int64)
            np.cumsum([len(b) for b in enc], out=offs[1:])
            self._blob = (b"".join(enc), offs)
        return self._blob

    #: Rows formatted per write: bounds the formatter's transient output
    #: buffer (48 B/line integer-key cap -> ~50 MB per chunk) so a dump
    #: at any scale runs in O(chunk) extra RSS, not O(n).
    CHUNK_ROWS = 1 << 20

    def dump(self, iteration: int, ranks: np.ndarray) -> str:
        with obs_trace.span("snapshot/dump", iteration=iteration,
                            rows=len(ranks)):
            return self._dump(iteration, ranks)

    def _dump(self, iteration: int, ranks: np.ndarray) -> str:
        from pagerank_tpu_torch.ingest.native import format_rank_lines_native

        d = fsio.join(self.directory, f"PageRank{iteration}")
        fsio.makedirs(d, exist_ok=True)
        # Same atomic tmp+rename path as Snapshotter.save
        # (fsio.atomic_write): a mid-dump kill leaves at worst a
        # part-00000.tmp no Hadoop-convention consumer matches — never
        # a half-written, parseable-looking part file.
        path = fsio.join(d, "part-00000")
        blob = None if self.names is None else self._names_blob(len(ranks))
        route = "native"
        with fsio.atomic_write(path, "wb") as f:
            for lo in range(0, len(ranks), self.CHUNK_ROWS):
                hi = min(lo + self.CHUNK_ROWS, len(ranks))
                chunk = ranks[lo:hi]
                if self.names is None:
                    data = format_rank_lines_native(chunk, key_base=lo)
                elif blob is not None:
                    offs = blob[1]
                    data = format_rank_lines_native(
                        chunk,
                        blob[0][offs[lo] : offs[hi]],
                        offs[lo : hi + 1] - offs[lo],
                    )
                else:
                    data = None
                if data is None:
                    route = "python"
                    # Python fallback — encoded to utf-8 bytes
                    # explicitly so the two paths stay byte-identical
                    # on any locale/platform (text mode would use the
                    # locale codec and '\n' translation).
                    data = "".join(
                        f"({self.names[i] if self.names is not None else i},"
                        f"{float(r)!r})\n"
                        for i, r in enumerate(chunk, start=lo)
                    ).encode("utf-8")
                f.write(data)
        # Hadoop job-completion marker (saveAsTextFile writes one per
        # output dir); written LAST so its presence certifies a
        # complete, untorn dump to downstream Hadoop-convention tooling.
        with fsio.fopen(fsio.join(d, "_SUCCESS"), "w"):
            pass
        self.route = route
        return path


class SinkGuard:
    """Bounded-retry + write-failure policy for rank sinks, shared by
    :class:`AsyncRankWriter`'s worker and the synchronous ``--sync-io``
    path (cli.py) so both modes have identical failure semantics
    (docs/ROBUSTNESS.md).

    ``on_failure='fail'`` (default) re-raises after the retry budget —
    a lost snapshot fails the run. ``'warn_and_drop'`` keeps the run
    alive: the iteration is recorded in ``dropped`` (and appended to the
    ``dead_letter_path`` JSON manifest when set), a RuntimeWarning is
    emitted, and the caller moves on — the side-channel sink never
    outranks result correctness, but what was dropped is never silent.
    """

    ON_FAILURE = ("fail", "warn_and_drop")

    def __init__(
        self,
        retry_policy: Optional[RetryPolicy] = None,
        on_failure: str = "fail",
        dead_letter_path: Optional[str] = None,
        label: str = "rank writer",
    ):
        if on_failure not in self.ON_FAILURE:
            raise ValueError(
                f"on_failure must be one of {self.ON_FAILURE}, "
                f"got {on_failure!r}"
            )
        self._policy = retry_policy
        self.on_failure = on_failure
        self.dead_letter_path = dead_letter_path
        self.label = label
        self.retries = 0
        self.dropped: List[Dict[str, object]] = []

    def __call__(self, iteration: int, fn: Callable[[], object]) -> bool:
        """Run ``fn()`` under the policy; True when it ran, False when
        it was dropped (warn_and_drop). Raises in 'fail' mode."""

        def on_retry(failures, delay, exc):
            self.retries += 1
            obs_metrics.counter(
                "sink.write_retries",
                "snapshot/dump write re-attempts under the SinkGuard "
                "policy",
            ).inc()

        try:
            if self._policy is not None:
                self._policy.call(fn, on_retry=on_retry)
            else:
                fn()
            return True
        except BaseException as e:
            # KeyboardInterrupt/SystemExit are never "write failures"
            # to drop — swallowing them is the PTL006 failure mode.
            if self.on_failure == "fail" or not isinstance(e, Exception):
                raise
            self.dropped.append(
                {"iteration": int(iteration), "error": repr(e)}
            )
            obs_metrics.counter(
                "sink.dead_letters",
                "iterations dropped under on_write_failure="
                "'warn_and_drop'",
            ).inc()
            self._flush_dead_letter()
            warnings.warn(
                f"{self.label}: dropped iteration {iteration} after "
                f"{self.retries} retr{'y' if self.retries == 1 else 'ies'}: "
                f"{e!r}",
                RuntimeWarning,
            )
            return False

    def _flush_dead_letter(self) -> None:
        if not self.dead_letter_path:
            return
        try:
            with fsio.fopen(self.dead_letter_path, "w") as f:
                json.dump({"dropped": self.dropped}, f, indent=2)
        except OSError as e:
            warnings.warn(
                f"{self.label}: could not write dead-letter manifest "
                f"{self.dead_letter_path!r}: {e!r}",
                RuntimeWarning,
            )


class AsyncRankWriter:
    """Overlap the device->host rank offload and file writes with device
    compute — C17's TPU-native build target (SURVEY.md §2: "async
    device→host offload + file write per iteration"), vs the
    reference's synchronous ``saveAsTextFile`` barrier per iteration
    (Sparky.java:237).

    The iteration loop calls ``submit(i, payload)`` with a cheap
    payload — for the torch engine ``engine.device_ranks()``: on a
    card, the rank tensor relabeled on a side stream after the step's
    work and copied into pinned host memory, with a CUDA event; on the
    CPU the tensor itself (a step rebinds the rank vector, it never
    writes it in place) — and keeps dispatching steps. A worker thread
    runs ``decode(payload)`` (on a card it waits on the copy's event;
    on the CPU it undoes the relabel) and feeds every sink.
    ``max_pending`` bounds in-flight copies; when the writer falls
    behind, ``submit`` blocks — snapshots are never dropped. Worker
    errors surface on the next ``submit`` or on ``close``; ``submit``
    re-checks after enqueueing so a failure that lands during a blocking
    put aborts immediately, but a sink error can still go unnoticed for
    up to one iteration (the run keeps computing until the next submit —
    acceptable for a side-channel sink, never for result correctness).
    """

    def __init__(
        self,
        decode: Callable[[object], np.ndarray],
        sinks: Iterable[Callable[[int, np.ndarray], object]],
        max_pending: int = 4,
        guard: Optional[SinkGuard] = None,
    ):
        self._decode = decode
        self._sinks = list(sinks)
        self._guard = guard if guard is not None else SinkGuard()
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        self._closed = False
        self._abandoned = False
        #: Seconds each ``submit`` spent blocked on a full queue (the
        #: backpressure the solve pays when the writer falls behind),
        #: and, per item, the worker's seconds in ``decode`` and in the
        #: whole item (decode and every sink).
        self.queue_wait_s: List[float] = []
        self.decode_s: List[float] = []
        self.item_s: List[float] = []
        self._thread = threading.Thread(
            target=self._run, name="rank-writer", daemon=True
        )
        self._thread.start()

    @property
    def guard(self) -> SinkGuard:
        """The write-failure policy in effect (retry/drop counters live
        here — the CLI's robustness summary reads them)."""
        return self._guard

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._err is not None:
                    continue  # drain after failure
                iteration, payload = item

                def work():
                    t0 = time.perf_counter()
                    ranks = self._decode(payload)
                    self.decode_s.append(time.perf_counter() - t0)
                    for sink in self._sinks:
                        sink(iteration, ranks)

                t0 = time.perf_counter()
                self._guard(iteration, work)
                self.item_s.append(time.perf_counter() - t0)
            except BaseException as e:  # surfaced to the submitter
                self._err = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            raise RuntimeError(
                f"async rank writer failed: {self._err}"
            ) from self._err

    def submit(self, iteration: int, payload) -> None:
        if self._closed:
            raise RuntimeError("submit() after close()")
        self._check()
        tracer = obs_trace.get_tracer()
        t0 = time.perf_counter()
        if tracer.enabled:
            # The put blocks when the writer falls behind (max_pending
            # full) — exactly the backpressure a trace must show: it is
            # solve wall-clock spent waiting on I/O.
            with tracer.span("writer/queue_wait", iteration=iteration):
                self._q.put((iteration, payload))
        else:
            self._q.put((iteration, payload))
        self.queue_wait_s.append(time.perf_counter() - t0)
        # Re-check: if the worker failed while the put above blocked on a
        # full queue, fail now rather than queueing more device copies.
        self._check()

    def flush(self) -> None:
        """Block until every already-submitted write has been processed
        (written, retried, or dropped per the guard's policy), keeping
        the worker alive; raises if a write failed in 'fail' mode. The
        rollback path drains through this so load_latest_valid never
        races snapshots still sitting in the queue."""
        self._q.join()
        self._check()

    def close(self, timeout: Optional[float] = None) -> None:
        """Flush all pending writes and stop the worker; raises if ANY
        write failed — including one raised by the background thread
        after the final ``submit``, which is only observable here.
        Idempotent: every call (first or repeated, e.g. an explicit
        close inside a ``with`` block) re-raises a recorded failure, so
        no caller path can exit cleanly over a lost write.

        ``timeout`` (seconds) bounds the flush — the preemption drain's
        deadline (pagerank_tpu/jobs.py): a sink wedged PAST the
        SinkGuard's own bounded retries must not hold the drain beyond
        its deadline. On expiry the worker (a daemon thread) is
        abandoned with a RuntimeWarning and a ``sink.drain_timeouts``
        count; any failure it already recorded still re-raises. The
        guard's dead-letter semantics are untouched: a FAILING (not
        hanging) sink drains normally inside the deadline, dropping to
        ``dead_letter.json`` per policy."""
        if not self._closed:
            self._closed = True
            if timeout is None:
                self._q.put(None)
                self._thread.join()
            else:
                # Bounded close must not block on the sentinel put:
                # with the worker wedged inside a sink and the queue
                # full, an unbounded put(None) would hang before ever
                # reaching the bounded join. But a HEALTHY backlogged
                # worker frees a slot within its next write, so retry
                # the put under the same deadline — dropping the
                # sentinel outright would leave a fully-drained worker
                # parked on q.get() and burn the whole deadline in
                # join() for a false abandonment.
                deadline = time.monotonic() + timeout
                while True:
                    left = deadline - time.monotonic()
                    try:
                        self._q.put(None, timeout=max(0.01, min(0.1, left)))
                        break
                    except queue.Full:
                        if left <= 0:
                            break
                self._thread.join(max(0.0, deadline - time.monotonic()))
        elif timeout is not None and self._thread.is_alive():
            self._thread.join(timeout)  # repeat close: one more grace
        if self._thread.is_alive() and not self._abandoned:
            # Warn + count ONCE per abandonment: a repeat close (e.g.
            # the __exit__ after an explicit drain close, which passes
            # no timeout) must stay a cheap no-op, not a second count
            # — and a bounded join only ever leaves the thread alive
            # when a numeric timeout expired, so the message can name
            # it.
            self._abandoned = True
            obs_metrics.counter(
                "sink.drain_timeouts",
                "async-writer flushes abandoned at the drain deadline",
            ).inc()
            warnings.warn(
                f"async rank writer still flushing after the "
                f"{timeout:g}s drain deadline; abandoning the worker "
                f"(pending writes may be lost — the durable job "
                f"artifacts and snapshots already committed are safe)",
                RuntimeWarning,
            )
        self._check()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class WriterSyncedSnapshotter:
    """Rollback view of a :class:`Snapshotter` that drains an
    :class:`AsyncRankWriter` before every scan: without the flush, a
    mid-run rollback could scan the directory while the most recent
    healthy snapshots still sit in the writer's queue — burning
    rollback budget on a stale restore point (or finding nothing at
    all early in a run). The CLI hands THIS to ``engine.run`` whenever
    the async writer is active. ``barrier`` (optional) runs after the
    flush and before the scan: over a process group, where rank 0 alone
    writes, every rank waits there until rank 0's writes are on disk."""

    def __init__(self, snap: Snapshotter, writer: AsyncRankWriter,
                 barrier=None):
        self._snap = snap
        self._writer = writer
        self._barrier = barrier

    @property
    def fingerprint(self) -> str:
        return self._snap.fingerprint

    @property
    def semantics(self) -> str:
        return self._snap.semantics

    def load_latest_valid(self, max_iteration=None, match=False):
        self._writer.flush()
        if self._barrier is not None:
            self._barrier()
        return self._snap.load_latest_valid(
            max_iteration=max_iteration, match=match
        )


def resume_engine(engine, snap: Snapshotter, _found=None) -> int:
    """Restore the latest VALID snapshot into ``engine``; returns the
    iteration resumed from (0 if none found). Corrupt or truncated
    snapshots are skipped (warning) and the scan falls back to the
    newest valid one — a damaged snapshot directory costs recovery
    granularity, never the resume. Refuses a snapshot taken on a
    different graph or semantics mode (that is a configuration error,
    not corruption).

    Mesh-shape-AGNOSTIC: the payload is the canonical
    host-order vector, so a snapshot taken on an N-device mesh
    restores onto whatever mesh ``engine`` runs — ``set_ranks``
    re-shards through the target's own placement. A shape change is
    logged (and counted in ``snapshot.mesh_reshards``) for the run
    report — AFTER the fingerprint/semantics validation, so a refused
    resume never records a reshard that didn't happen — never
    refused: it is the elastic rescue's warm-start path
    (parallel/elastic.py), whose deadline-bounded scan hands the
    already-loaded result in via ``_found`` so the restore itself
    always runs on the CALLER's thread (an abandoned scan thread must
    never be able to set_ranks later)."""
    found = snap.load_latest_valid() if _found is None else _found
    if found is None:
        return 0
    _it, ranks, meta = found
    if meta["fingerprint"] != snap.fingerprint:
        raise ValueError(
            f"snapshot graph fingerprint {meta['fingerprint']} != current "
            f"{snap.fingerprint}; refusing to resume (note: crawl-input "
            "graphs hash their dangling mask into the fingerprint)"
        )
    if meta["semantics"] != snap.semantics:
        raise ValueError(
            f"snapshot semantics {meta['semantics']!r} != current {snap.semantics!r}"
        )
    saved_mesh = meta.get("mesh")
    engine_mesh = getattr(engine, "mesh", None)
    if saved_mesh is not None and engine_mesh is not None:
        saved_nd = saved_mesh.get("num_devices")
        now_nd = int(engine_mesh.size)
        if saved_nd is not None and int(saved_nd) != now_nd:
            obs_metrics.counter(
                "snapshot.mesh_reshards",
                "resumes that re-sharded a snapshot onto a different "
                "mesh shape",
            ).inc()
            obs_log.info(
                f"resuming a {saved_nd}-device snapshot onto a "
                f"{now_nd}-device mesh (canonical-order payload; "
                f"set_ranks re-shards)"
            )
    engine.set_ranks(ranks, iteration=meta["iteration"])
    return meta["iteration"]
