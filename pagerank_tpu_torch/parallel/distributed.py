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

Leaving and regrouping (the elastic solve, ``parallel/elastic.py``):
the JAX runner rebuilds its mesh over the surviving devices of one
controller. Here a mesh is a group of processes, so a rescue is four
group operations, all through a store that outlives any one rank — the
LAUNCHER's (:func:`spawn_group` with ``rescue=True`` hosts a
``TCPStore`` in the parent and every rank connects to it), keyed by a
prefix per group generation (``g<k>/``):

- :func:`abandon_group` tears this process's group down without
  waiting on a dead member (gloo's destroy returns at once; the other
  ranks still blocked in a collective with this one get "Connection
  closed by peer" and join the roll call);
- :func:`roll_call` agrees who is gone: every live rank posts itself
  (with the ids its error carried) under ``g<k>/roll/alive/<member>``;
  a member that has not posted within the deadline, or whose process
  the launcher saw end (``exited/<member>``), is dead, and the first
  rank to decide publishes the verdict with ``compare_set`` — every
  rank adopts that one verdict;
- :func:`regroup` forms the survivors' group, ``len(survivors)`` ranks
  numbered in the order of their original ids (``g<k+1>/pg/``);
- the launcher reads every verdict at the end (:class:`GroupCodes`
  ``.lost``).

Members keep their ORIGINAL ids (the rank of the first group) for life:
every dead set is keyed by them, never by a CUDA index (gloo ranks that
share one card all sit on ``cuda:0``).

Startup is RETRIED: at bring-up the ranks race the rendezvous, and a
rank that dials before rank 0's store is listening sees a refusal that
a second attempt moments later would not. The call therefore runs under
a ``utils/retry.RetryPolicy`` (jittered exponential backoff and a
wall-clock deadline); re-attempts land in the
``distributed.init_retries`` counter for the run report.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

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


# -- members, generations and the launcher's store ---------------------------

#: The environment variable that carries the launcher store's
#: ``host:port`` to a spawned rank.
STORE_ENV = "PAGERANK_TORCH_LAUNCHER_STORE"

#: This process's place in the elastic bookkeeping: the launcher store
#: it reaches (None outside a rescue-armed group), the generation of its
#: current group, the original ids of that group's members in rank
#: order, its own original id, and the group's backend and timeout.
_STATE = {"store": None, "generation": 0, "members": None, "member": None,
          "backend": None, "timeout_s": DEFAULT_TIMEOUT_S}


def launcher_store():
    """The launcher's store this rank reaches, or None."""
    return _STATE["store"]


def generation() -> int:
    """The generation of this process's group: 0 for the first, one
    more for each regroup."""
    return int(_STATE["generation"])


def members() -> Tuple[int, ...]:
    """The original ids of the current group's members, in rank order
    (``range(world)`` for a group without a launcher store). Between
    :func:`abandon_group` and :func:`regroup` these are still the left
    group's members (the roll call's)."""
    if _STATE["members"] is not None:
        return tuple(_STATE["members"])
    return tuple(range(process_info()[1]))


def member() -> int:
    """This process's original id (its rank in the first group)."""
    if _STATE["member"] is not None:
        return int(_STATE["member"])
    return process_info()[0]


def collective_timeout_s() -> float:
    """How long a collective of this process's group waits for a missing
    rank (the launcher's groups record theirs; any other group was
    formed with the default)."""
    return float(_STATE["timeout_s"])


def connect_store(address: str, timeout_s: float = DEFAULT_TIMEOUT_S):
    """A client of the launcher's ``TCPStore`` at ``host:port``."""
    import torch.distributed as dist

    host, port = address.rsplit(":", 1)
    return dist.TCPStore(host, int(port), is_master=False,
                         timeout=datetime.timedelta(seconds=timeout_s))


def join_group(store, backend: str, rank: int, world: int,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join generation 0 of a rescue-armed group through the launcher's
    ``store`` (its ``g0/pg/`` prefix) and remember the store for the
    roll calls and regroups to come."""
    import torch.distributed as dist

    dist.init_process_group(
        backend, store=dist.PrefixStore("g0/pg/", store), rank=int(rank),
        world_size=int(world), timeout=datetime.timedelta(seconds=timeout_s))
    _STATE.update(store=store, generation=0, members=tuple(range(world)),
                  member=int(rank), backend=backend, timeout_s=timeout_s)


def abandon_group() -> None:
    """Tear this process's group down without waiting on a dead member.
    gloo's destroy returns at once and closes this rank's pairs, so a
    peer still blocked in a collective with it raises; an NCCL group is
    aborted where torch offers it (a plain destroy can block on a dead
    peer). Never raises: the group is broken already."""
    import torch.distributed as dist

    if not group_up():
        return
    from torch.distributed import distributed_c10d as c10d

    abort = getattr(c10d, "_abort_process_group", None)
    nccl = str(dist.get_backend()) == "nccl"
    for leave in ((abort,) if nccl and abort else ()) + (
            dist.destroy_process_group,):
        try:
            if group_up():
                leave()
        except Exception:
            pass


def roll_call(carried: Sequence[int] = (), alive: bool = True,
              timeout_s: float = 5.0,
              clock: Callable[[], float] = time.monotonic,
              sleep: Callable[[float], None] = time.sleep,
              poll_s: float = 0.01) -> List[int]:
    """Agree, with every other live member, on which members of the
    current generation are gone; returns the agreed dead ids (sorted).

    This rank posts itself when ``alive`` (its own device answered),
    with the ``carried`` ids of its error, then waits until every
    member has posted or ended (the launcher's ``exited/<member>``
    record) or ``timeout_s`` passed. Dead: the members that did not
    post, and every id a posted member carried. The first rank to
    decide publishes its verdict (``compare_set`` on
    ``g<k>/roll/verdict``); every rank returns THAT verdict, so all
    survivors adopt the same one even where their waits ended apart.
    A group of one decides alone (no store needed)."""
    mem = members()
    me = member()
    carried = sorted(int(d) for d in carried)
    store = _STATE["store"]
    if store is None:
        if len(mem) > 1:
            raise RuntimeError(
                "a roll call over a group of more than one rank needs the "
                "launcher's store (spawn_group(..., rescue=True))")
        dead = set(carried) | (set() if alive else {me})
        return sorted(d for d in dead if d in mem)
    pre = f"g{generation()}/roll/"
    if alive:
        store.set(f"{pre}alive/{me}", json.dumps(carried))
    deadline = clock() + timeout_s
    while True:
        posted = [m for m in mem if store.check([f"{pre}alive/{m}"])]
        ended = [m for m in mem if m not in posted
                 and store.check([f"exited/{m}"])]
        if (len(posted) + len(ended) == len(mem) or clock() >= deadline
                or store.check([f"{pre}verdict"])):
            break
        sleep(poll_s)
    dead = set(mem) - set(posted)
    for m in posted:
        dead |= set(json.loads(store.get(f"{pre}alive/{m}")))
    dead &= set(mem)
    proposal = json.dumps({"dead": sorted(dead), "members": list(mem)})
    agreed = store.compare_set(f"{pre}verdict", "", proposal)
    return list(json.loads(agreed)["dead"])


def regroup(survivors: Sequence[int]) -> int:
    """Form the next generation's group over ``survivors`` (original
    ids; this process must be one of them): ``len(survivors)`` ranks
    numbered in the order of their ids, through the launcher's store
    (``g<k+1>/pg/``), with the first group's backend and timeout.
    Returns this process's new rank."""
    return reform(generation() + 1, survivors)


def reform(gen: int, group_members: Sequence[int]) -> int:
    """Leave this process's group and join generation ``gen``'s, over
    ``group_members`` (original ids, this process's among them; ranks in
    the order of the ids) through the launcher's store. :func:`regroup`
    is the next generation over the survivors; a harness that runs
    several rescues in one spawn re-forms every member's group at a
    generation of its own between them. Returns this process's new
    rank."""
    import torch.distributed as dist

    group_members = sorted(int(m) for m in group_members)
    me = member()
    rank = group_members.index(me)
    abandon_group()
    dist.init_process_group(
        _STATE["backend"],
        store=dist.PrefixStore(f"g{gen}/pg/", _STATE["store"]),
        rank=rank, world_size=len(group_members),
        timeout=datetime.timedelta(seconds=_STATE["timeout_s"]))
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), \
        str(len(group_members))
    _STATE.update(generation=int(gen), members=tuple(group_members),
                  member=me)
    return rank


def verdicts(store) -> List[dict]:
    """Every roll call's verdict in a launcher ``store``, generation by
    generation (the launcher reads them when its ranks have ended)."""
    out = []
    while store.check([f"g{len(out)}/roll/verdict"]):
        out.append(json.loads(store.get(f"g{len(out)}/roll/verdict")))
    return out


class GroupCodes(list):
    """The exit codes of a group's ranks, in rank order, with ``lost``:
    the original ids the group's roll calls declared dead (empty
    without rescue)."""

    def __init__(self, codes, lost=()):
        super().__init__(codes)
        self.lost = tuple(lost)


# -- one command, N processes ------------------------------------------------
#
# The JAX CLI runs a mesh of N devices from one command. Here a mesh is N
# processes, so without torchrun the launcher below starts them itself:
# the ``spawn`` start method (the caller may hold threads; a fresh
# interpreter imports only what the target needs), a file rendezvous in
# a directory the caller owns (no port to collide on), and a join that
# never outlives a failed rank by more than the group's own timeout.


def _rank_entry(rank: int, world: int, rendezvous: str, backend: str,
                target: str, payload, timeout_s: float,
                store_address: Optional[str] = None) -> None:
    """A spawned rank: join the group over the rendezvous file (or,
    rescue armed, the launcher's store at ``store_address``), run
    ``target(payload)`` (``"module:function"``), leave the group. An
    exception exits the process non-zero (the parent reports it)."""
    import importlib

    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(world)
    os.environ["LOCAL_RANK"] = str(rank)
    if store_address is not None:
        os.environ[STORE_ENV] = store_address
        if backend == "nccl":
            # torch's default NCCL error handling tears the whole process
            # down on a collective error: no survivor would be left.
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
        join_group(connect_store(store_address, timeout_s), backend, rank,
                   world, timeout_s)
    else:
        maybe_initialize_distributed(
            backend, init_method=f"file://{rendezvous}", world_size=world,
            rank=rank, timeout_s=timeout_s)
    try:
        module, _, name = target.partition(":")
        code = getattr(importlib.import_module(module), name)(payload)
    finally:
        shutdown()
    if code:
        raise SystemExit(int(code))


def spawn_group(target: str, world: int, payload, rendezvous_dir: str, *,
                backend: str, timeout_s: float = DEFAULT_TIMEOUT_S,
                deadline_s: Optional[float] = None, poll_s: float = 0.05,
                rescue: bool = False) -> GroupCodes:
    """Run ``target(payload)`` on ``world`` spawned ranks of one process
    group (``backend``; rank i sees ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` = i) and return their exit codes, in rank order.

    The group's rendezvous is a file in ``rendezvous_dir`` and its
    collectives time out after ``timeout_s``. Once a rank has exited
    non-zero, the others get ``timeout_s`` more to end (a rank blocked
    in a collective with the failed one raises by then) and are then
    killed; ``deadline_s`` (None: none) bounds the whole run the same
    way. A killed rank's code is negative (the signal).

    ``rescue``: the ranks may outlive a member. The launcher hosts the
    store the group forms, takes its roll calls and regroups through
    (module docstring), records each rank that ends under
    ``exited/<rank>`` (a roll call then need not wait out its deadline
    for a member that is gone), and forgives a failed rank once a roll
    call has declared it dead: the survivors run on to their end. A
    failed rank that no verdict names within ``timeout_s`` ends the
    group as above. The result's ``lost`` names the declared dead."""
    import tempfile

    import torch.multiprocessing as mp

    fd, rendezvous = tempfile.mkstemp(prefix="rendezvous.",
                                      dir=rendezvous_dir)
    os.close(fd)
    os.unlink(rendezvous)  # the store creates it
    store = address = None
    if rescue:
        import torch.distributed as dist

        store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                              wait_for_workers=False,
                              timeout=datetime.timedelta(seconds=timeout_s))
        address = f"127.0.0.1:{store.port}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, name=f"pagerank-rank-{r}",
                         args=(r, world, rendezvous, backend, target,
                               payload, timeout_s, address))
             for r in range(world)]
    for p in procs:
        p.start()
    start = time.monotonic()
    failed_at = None
    recorded = set()
    lost: set = set()
    try:
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if store is not None:
                for r, p in enumerate(procs):
                    if p.exitcode is not None and r not in recorded:
                        store.set(f"exited/{r}", str(p.exitcode))
                        recorded.add(r)
                for v in verdicts(store):
                    lost.update(v["dead"])
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0) and r not in lost]
            if failed_at is None and failed:
                failed_at = now
            elif not failed:
                failed_at = None
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
    if store is not None:
        for v in verdicts(store):
            lost.update(v["dead"])
    return GroupCodes([p.exitcode for p in procs], sorted(lost))
