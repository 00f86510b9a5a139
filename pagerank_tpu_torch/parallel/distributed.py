"""Process-group bring-up (L0 across processes).

Port of ``pagerank_tpu/parallel/distributed.py:39-126``. The reference
scales out through Spark's cluster manager and netty shuffle (SURVEY.md
§5 "Distributed communication backend"). Here one process drives one
GPU, and :func:`maybe_initialize_distributed` joins those processes
into one ``torch.distributed`` group; after that the same engine code
runs on every rank, each over its own rows (``parallel/mesh.py``). The
graph is partitioned once, statically; no shuffle machinery exists.

Where the JAX module reads its ``PAGERANK_TPU_*`` variables and the TPU
metadata, this one reads torchrun's: ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` (``LOCAL_RANK`` picks the card,
``parallel/mesh.make_mesh``). Explicit arguments win over the
environment. The backend is an explicit argument (``nccl`` on cuda,
``gloo`` on the CPU: :func:`default_backend`); nothing swaps it on a
failure. The group gets a timeout, so that a rank that never comes up
(or never joins a collective) fails the run instead of hanging it.

Single-process runs skip initialization entirely.

Startup is RETRIED: at bring-up the ranks race the rendezvous, and a
rank that dials before rank 0's store is listening sees a refusal that
a second attempt moments later would not. The call therefore runs under
a ``utils/retry.RetryPolicy`` (jittered exponential backoff and a
wall-clock deadline); re-attempts land in the
``distributed.init_retries`` counter for the run report.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from pagerank_tpu_torch.obs import log as obs_log
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.utils.retry import RetryPolicy

#: Default bring-up policy: 5 attempts over at most ~2 minutes — wide
#: enough for a slow rank 0, bounded enough that a genuinely absent
#: one still fails the run promptly.
DEFAULT_INIT_RETRY = dict(max_attempts=5, base_delay=1.0, max_delay=15.0,
                          deadline=120.0)

#: How long a collective (and the rendezvous) may wait for a missing
#: rank before it raises.
DEFAULT_TIMEOUT_S = 300.0


def default_backend(device) -> str:
    """The backend for a device type: ``nccl`` for cuda, ``gloo`` for
    the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device!r}")


def _init_retryable(exc: BaseException) -> bool:
    """Rendezvous-race classifier: connection and timeout errors (and
    the RuntimeError spellings the store wraps them in while rank 0 is
    not listening yet) retry; everything else — bad ranks, a second
    initialization — is a configuration error that surfaces
    unchanged."""
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in (
        "connection refused", "connection reset", "failed to connect",
        "timed out", "timeout", "unavailable",
    ))


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def maybe_initialize_distributed(
    backend: str,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    retry_policy: Optional[RetryPolicy] = None,
    _initialize=None,
) -> bool:
    """Join the process group when a multi-process context is present.

    Resolution order: explicit arguments > torchrun's ``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``. Without a world size
    from either (or with a world of 1 and no ``init_method``) nothing
    runs and this returns False. ``init_method`` defaults to
    ``tcp://MASTER_ADDR:MASTER_PORT`` when both are set, else
    torch's ``env://``. Returns True if initialization ran.

    The call runs under ``retry_policy`` (default:
    ``DEFAULT_INIT_RETRY``) and re-attempts are counted in
    ``distributed.init_retries``. ``_initialize`` is injectable for
    tests (virtual-time schedules)."""
    import torch.distributed as dist

    init = (_initialize if _initialize is not None
            else dist.init_process_group)
    policy = retry_policy if retry_policy is not None else RetryPolicy(
        retryable=_init_retryable, **DEFAULT_INIT_RETRY)

    world = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if world is None or (world == 1 and init_method is None):
        return False
    rk = rank if rank is not None else _env_int("RANK")
    if rk is None:
        raise ValueError("a world size without a rank: set RANK (torchrun "
                         "does) or pass rank=")
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        init_method = f"tcp://{addr}:{port}" if addr and port else "env://"

    def on_retry(failures, delay, exc):
        obs_metrics.counter(
            "distributed.init_retries",
            "torch.distributed.init_process_group re-attempts after "
            "transient rendezvous races at startup",
        ).inc()
        obs_log.warn(
            f"init_process_group attempt {failures} failed "
            f"({type(exc).__name__}: {str(exc)[:120]}); retrying in "
            f"{delay:.1f}s")

    policy.call(
        lambda: init(backend=backend, init_method=init_method,
                     world_size=int(world), rank=int(rk),
                     timeout=datetime.timedelta(seconds=timeout_s)),
        on_retry=on_retry, retryable=_init_retryable)
    return True


def group_up() -> bool:
    """Whether this process has joined a process group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_info():
    """(rank, world_size) — (0, 1) without a process group."""
    import torch.distributed as dist

    if group_up():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if group_up():
        dist.destroy_process_group()


# -- one command, N processes ------------------------------------------------
#
# The JAX CLI runs a mesh of N devices from one command. Here a mesh is N
# processes, so without torchrun the launcher below starts them itself:
# the ``spawn`` start method (the caller may hold threads; a fresh
# interpreter imports only what the target needs), a file rendezvous in
# a directory the caller owns (no port to collide on), and a join that
# never outlives a failed rank by more than the group's own timeout.


def _rank_entry(rank: int, world: int, rendezvous: str, backend: str,
                target: str, payload, timeout_s: float) -> None:
    """A spawned rank: join the group over the rendezvous file, run
    ``target(payload)`` (``"module:function"``), leave the group. An
    exception exits the process non-zero (the parent reports it)."""
    import importlib

    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(world)
    os.environ["LOCAL_RANK"] = str(rank)
    maybe_initialize_distributed(backend, init_method=f"file://{rendezvous}",
                                 world_size=world, rank=rank,
                                 timeout_s=timeout_s)
    try:
        module, _, name = target.partition(":")
        code = getattr(importlib.import_module(module), name)(payload)
    finally:
        shutdown()
    if code:
        raise SystemExit(int(code))


def spawn_group(target: str, world: int, payload, rendezvous_dir: str, *,
                backend: str, timeout_s: float = DEFAULT_TIMEOUT_S,
                deadline_s: Optional[float] = None, poll_s: float = 0.05
                ) -> list:
    """Run ``target(payload)`` on ``world`` spawned ranks of one process
    group (``backend``; rank i sees ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` = i) and return their exit codes, in rank order.

    The group's rendezvous is a file in ``rendezvous_dir`` and its
    collectives time out after ``timeout_s``. Once a rank has exited
    non-zero, the others get ``timeout_s`` more to end (a rank blocked
    in a collective with the failed one raises by then) and are then
    killed; ``deadline_s`` (None: none) bounds the whole run the same
    way. A killed rank's code is negative (the signal)."""
    import tempfile
    import time

    import torch.multiprocessing as mp

    fd, rendezvous = tempfile.mkstemp(prefix="rendezvous.",
                                      dir=rendezvous_dir)
    os.close(fd)
    os.unlink(rendezvous)  # the store creates it
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, name=f"pagerank-rank-{r}",
                         args=(r, world, rendezvous, backend, target,
                               payload, timeout_s))
             for r in range(world)]
    for p in procs:
        p.start()
    start = time.monotonic()
    failed_at = None
    try:
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if failed_at is None and any(
                    p.exitcode not in (None, 0) for p in procs):
                failed_at = now
            if ((failed_at is not None and now - failed_at > timeout_s)
                    or (deadline_s is not None
                        and now - start > deadline_s)):
                break
            time.sleep(poll_s)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10.0)
        if os.path.exists(rendezvous):
            os.unlink(rendezvous)
    return [p.exitcode for p in procs]
