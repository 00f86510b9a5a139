"""Device meshes, their collectives, deadline-bounded dispatch and
device liveness — a port of ``pagerank_tpu/parallel/mesh.py``.

The framework's single parallel axis is the *edge dimension* (SURVEY.md
§2 P1/P5): a 1-D mesh whose devices each own a contiguous block of the
slot rows. In JAX a mesh is a set of devices driven by one program; here
it is a ``torch.distributed`` process group, one process a GPU, each
running the same engine code on its own rows (:class:`Mesh`,
:func:`make_mesh`, ``:23-55``). The three sharding helpers become row
and vertex ranges (:func:`edge_sharding`, :func:`replicated`,
:func:`vertex_sharding`), and the collectives the sharded forms use
carry the names of the ``jax.lax`` ops they replace (:func:`psum`,
:func:`all_gather`, :func:`psum_scatter`, :func:`ppermute`), so that a
form reads like its JAX counterpart. Over a mesh of one rank every
collective is the identity and calls nothing, as ``shard_map`` over one
device lowers its collectives away: a group of one pays no
``torch.distributed`` call a step.

``DeadlineExpired`` and ``run_with_deadline`` are copies (pure
threading); ``probe_liveness`` and ``surviving_devices`` take torch
devices, keyed by :func:`device_id`, and the liveness echo is a tiny
torch op on each device.

A mesh over a group names its ranks by their MEMBER ids
(:attr:`Mesh.members`): the ranks of the group's first generation,
kept across the regroups of an elastic rescue
(``parallel/distributed.regroup``), so that a lost, excluded or
quarantined member keeps one name for the whole run.
:func:`surviving_members` is ``surviving_devices`` over those ids (a
CUDA index cannot name a rank: gloo ranks that share one card all sit
on ``cuda:0``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from pagerank_tpu_torch.parallel import distributed


@dataclasses.dataclass
class Mesh:
    """A 1-D mesh: this process's place in it and its device.

    ``group`` is the ``torch.distributed`` process group (None for a
    world of one without a group: every collective is then the
    identity), ``rank`` and ``world`` this process's rank and the group
    size, ``device`` the device this rank computes on, ``axis_name``
    the mesh axis (``config.mesh_axis``) and ``backend`` the group's
    backend (None without a group).

    ``stage_p2p``: whether :func:`ppermute` moves its payloads through
    pinned host buffers. Set at creation from the backend and the
    device, never on a failure: gloo's send and recv hand a tensor's
    pointer to its TCP transport, which reads and writes host memory,
    so under gloo a CUDA payload is copied to the host, sent, received
    there and copied back; NCCL sends device memory as it is."""

    group: Optional[object]
    rank: int
    world: int
    device: torch.device
    axis_name: str = "data"
    backend: Optional[str] = None
    stage_p2p: bool = False
    #: The original ids of the group's members in rank order (module
    #: docstring); ``range(world)`` by default.
    members: Tuple[int, ...] = ()
    #: Pinned host buffers of the staged point-to-point rounds, kept by
    #: (tag, role, numel, dtype) so a step allocates none.
    _staging: Dict[tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    def __post_init__(self):
        self.members = tuple(int(m) for m in self.members) or tuple(
            range(self.world))
        if len(self.members) != self.world:
            raise ValueError(f"{len(self.members)} member ids for a mesh of "
                             f"{self.world} ranks")

    @property
    def size(self) -> int:
        return self.world

    @property
    def member(self) -> int:
        """This rank's member id."""
        return self.members[self.rank]

    @property
    def collective(self) -> bool:
        """Whether a collective really calls ``torch.distributed``: a
        group of more than one rank. Without a group (one process
        building one rank's share), or in a group of one, every
        collective is the identity."""
        return self.group is not None and self.world > 1

    def staging(self, tag: int, role: str, like: torch.Tensor
                ) -> torch.Tensor:
        """The pinned host buffer of a staged round (made once)."""
        key = (tag, role, like.numel(), like.dtype)
        buf = self._staging.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._staging[key] = buf
        return buf

    def barrier(self) -> None:
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data",
              device=None) -> Mesh:
    """The 1-D mesh of this process's group (``pagerank_tpu/parallel/
    mesh.py:23-36``): ``num_devices`` ranks (default: the group's
    world size, 1 without a group), this rank on ``device``.

    ``device`` defaults to cuda; a cuda device without an index becomes
    ``cuda:LOCAL_RANK`` (``torch.cuda.set_device``), one card a rank.
    Asking for more cards than are visible raises the JAX error
    (``requested N devices, only M visible``) before anything is
    allocated. An indexed device is taken as given, so that several
    ranks may share one card under a backend that allows it (gloo).
    ``num_devices`` must equal the group's world size."""
    dev = torch.device("cuda" if device is None else device)
    rank, world = distributed.process_info()
    want = world if num_devices is None else int(num_devices)
    check_visible(want, dev)
    if dev.type == "cuda" and dev.index is None:
        local = distributed._env_int("LOCAL_RANK")
        dev = torch.device("cuda", rank if local is None else local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if want != world:
        raise ValueError(
            f"num_devices {want} needs a process group of {want} ranks, "
            f"this process is in one of {world}: launch it with torchrun "
            f"--nproc-per-node {want}, or through the CLI's --num-devices")
    group = backend = None
    if distributed.group_up():
        import torch.distributed as dist

        group = dist.group.WORLD
        backend = str(dist.get_backend(group))
    return Mesh(group=group, rank=rank, world=world, device=dev,
                axis_name=axis_name, backend=backend,
                stage_p2p=backend == "gloo" and dev.type == "cuda",
                members=distributed.members() if group is not None else ())


def check_visible(num_devices: int, device) -> None:
    """Raise the JAX error (``mesh.py:31-35``) when a mesh of
    ``num_devices`` cards, one a rank, asks for more than are visible.
    A CPU mesh (gloo) and an indexed device (ranks sharing one card)
    ask for none."""
    dev = torch.device(device)
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if dev.type == "cuda" and dev.index is None:
        visible = torch.cuda.device_count()
        if num_devices > visible:
            raise ValueError(
                f"requested {num_devices} devices, only {visible} visible")


def edge_sharding(mesh: Mesh, rows: int) -> slice:
    """This rank's slot rows of ``rows`` (a multiple of the world size):
    the contiguous ``rows / world`` starting at ``rank * rows / world``
    — the ``P(axis, None)`` row sharding of the JAX engine."""
    if rows % mesh.world:
        raise ValueError(f"{rows} rows do not split over {mesh.world} ranks")
    per = rows // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicated(mesh: Mesh, n: int) -> slice:
    """The whole of a replicated vector (rank vectors, masks, scalars):
    every rank holds all ``n`` entries — the analogue of Spark's
    broadcast variables (Sparky.java:135,162)."""
    return slice(0, n)


def vertex_sharding(mesh: Mesh, n_vs: int) -> slice:
    """This rank's contiguous vertex block of a PARTITIONED per-vertex
    vector of ``n_vs`` entries (a multiple of the world size;
    ``config.vertex_sharded``) — the analogue of the reference's
    hash-partitioned ``ranks`` RDD (Sparky.java:165-170)."""
    if n_vs % mesh.world:
        raise ValueError(f"{n_vs} vertices do not split over {mesh.world} "
                         f"ranks")
    blk = n_vs // mesh.world
    return slice(mesh.rank * blk, (mesh.rank + 1) * blk)


class Pending:
    """An asynchronous collective's handle: :meth:`wait` blocks until
    its result is in place (the works done, a staged payload copied to
    the device). A collective that called nothing is done at once."""

    def __init__(self, works=(), then=None):
        self._works = list(works)
        self._then = then

    def wait(self) -> None:
        for w in self._works:
            w.wait()
        self._works = []
        if self._then is not None:
            then, self._then = self._then, None
            then()


DONE = Pending()


def psum(mesh: Mesh, x: torch.Tensor, async_op: bool = False):
    """``lax.psum``: ``x`` summed over the ranks, in place
    (``all_reduce``); returns ``x``, or with ``async_op`` a
    :class:`Pending` to wait on before reading it."""
    work = None
    if mesh.collective:
        import torch.distributed as dist

        work = dist.all_reduce(x if x.dim() else x.view(1),
                               group=mesh.group, async_op=async_op)
    if async_op:
        return Pending([work] if work is not None else ())
    return x


def all_gather(mesh: Mesh, out: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``: every rank's ``x`` laid end to
    end in rank order into ``out`` (``world * len(x)`` entries,
    ``all_gather_into_tensor``); returns ``out``."""
    if not mesh.collective:
        out.copy_(x)
        return out
    import torch.distributed as dist

    # ``all_gather_single`` is the newer torch's name of the same call.
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x, group=mesh.group)
    return out


def psum_scatter(mesh: Mesh, out: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``lax.psum_scatter(tiled=True)``: ``x`` summed over the ranks,
    this rank keeping its ``len(x) / world`` block in ``out``
    (``reduce_scatter_tensor``); returns ``out``."""
    if not mesh.collective:
        out.copy_(x)
        return out
    import torch.distributed as dist

    # ``reduce_scatter_single`` is the newer torch's name of the same call.
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    scatter(out, x, group=mesh.group)
    return out


def ppermute(mesh: Mesh, out: torch.Tensor, x: torch.Tensor, perm,
             tag: int = 0, async_op: bool = False):
    """``lax.ppermute``, one round: ``perm`` holds (source, target) rank
    pairs, at most one target a source and one source a target; this
    rank sends ``x`` to its target and receives its source's payload
    into ``out`` (the same shape), and ``out`` is zeroed where no one
    sends to this rank. One ``dist.batch_isend_irecv`` of this rank's
    send and receive; ``tag`` tells a round's messages from another's
    under gloo, where rounds of one pair of ranks may be in flight
    together. Under gloo on a card the payload goes through pinned
    host buffers (:attr:`Mesh.stage_p2p`). Returns ``out``, or with
    ``async_op`` a :class:`Pending` whose ``wait`` leaves the received
    payload in ``out``."""
    me = mesh.rank
    to = [t for s, t in perm if s == me]
    frm = [s for s, t in perm if t == me]
    if not mesh.collective:
        # A rank alone receives only what it sends itself; a share built
        # without a group (one process) receives nothing from the others.
        if (me, me) in tuple(perm):
            out.copy_(x)
        else:
            out.zero_()
        return DONE if async_op else out
    if not frm:
        out.zero_()
    import torch.distributed as dist

    then = None
    send, recv = x, out
    if mesh.stage_p2p:
        if to:
            send = mesh.staging(tag, "send", x)
            send.copy_(x)
        if frm:
            recv = mesh.staging(tag, "recv", out)

            def then():
                out.copy_(recv)
    ops = [dist.P2POp(dist.isend, send, t, mesh.group, tag) for t in to]
    ops += [dist.P2POp(dist.irecv, recv, s, mesh.group, tag) for s in frm]
    pending = Pending(dist.batch_isend_irecv(ops) if ops else (), then)
    if async_op:
        return pending
    pending.wait()
    return out


def device_id(dev) -> int:
    """A device's key in the liveness and rescue maps: its CUDA index
    (0 for a device without one, such as the CPU)."""
    dev = torch.device(dev)
    return 0 if dev.index is None else int(dev.index)


def visible_devices() -> List[torch.device]:
    """Every CUDA device of the process, indexed."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class DeadlineExpired(TimeoutError):
    """A deadline-bounded dispatch did not come back in time. The work
    may still complete later (the worker thread is daemonic and
    abandoned, never killed) — the CALLER's view is what timed out."""


def run_with_deadline(fn: Callable[[], object], timeout_s: float):
    """Run ``fn()`` on a worker thread and wait at most ``timeout_s``
    for it — the deadline-bounded dispatch primitive of the elastic
    layer. A kernel that hangs, or a copy from a lost device, blocks
    its thread and cannot be cancelled; bounding it from a sibling
    thread is the only portable way to turn "hung" into a classifiable
    signal. Raises :class:`DeadlineExpired` on timeout and re-raises
    ``fn``'s own exception otherwise."""
    box: Dict[str, object] = {}
    done = threading.Event()

    def work():
        try:
            box["value"] = fn()
        except BaseException as e:  # surfaced to the caller below
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=work, name="pagerank-deadline-dispatch",
                         daemon=True)
    t.start()
    if not done.wait(timeout_s):
        raise DeadlineExpired(
            f"dispatch did not complete within {timeout_s:g}s"
        )
    if "error" in box:
        raise box["error"]
    return box["value"]


def _echo(dev: torch.device) -> bool:
    """One tiny round trip on ``dev``: a 4-byte tensor made there, one
    add, copied back."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # a new thread starts on device 0
    t = torch.ones(1, dtype=torch.int32, device=dev)
    return int((t + 1).item()) == 2


def probe_liveness(devices: Optional[Sequence] = None,
                   timeout_s: float = 2.0,
                   clock: Callable[[], float] = time.monotonic,
                   ) -> Dict[int, bool]:
    """Per-device liveness: {device id: alive}. Each device gets one
    tiny torch op (a 4-byte tensor made there, one add, copied back)
    under a SHARED deadline — a device that cannot answer within
    ``timeout_s`` is classified dead (lost, wedged, or detached), the
    hang-vs-device-lost discrimination the rescue path needs. All
    echoes run CONCURRENTLY (one daemon thread each), so several dead
    devices still classify in ~``timeout_s`` total. Any error — timeout
    or a CUDA error from the dead device — counts as not-alive; the
    probe itself never raises.

    ``clock`` is injectable, so that virtual-time tests can drive the
    shared deadline."""
    devs = ([torch.device(d) for d in devices] if devices is not None
            else visible_devices())
    results: Dict[int, bool] = {}

    def echo(dev):
        try:
            ok = _echo(dev)
        except Exception:
            ok = False
        results[device_id(dev)] = ok  # per-key dict writes are GIL-atomic

    threads = []
    for d in devs:
        t = threading.Thread(target=echo, args=(d,),
                             name="pagerank-liveness-probe", daemon=True)
        t.start()
        threads.append(t)
    deadline = clock() + timeout_s
    for t in threads:
        t.join(max(0.0, deadline - clock()))
    # A device whose echo thread missed the shared deadline is dead.
    return {device_id(d): results.get(device_id(d), False) for d in devs}


def surviving_devices(dead_ids, devices: Optional[Sequence] = None):
    """The device list minus ``dead_ids`` — what a rescue rebuilds
    over. Raises when nothing survives (there is nothing to rescue
    onto; the caller surfaces that as terminal). On one card that is
    every loss."""
    devs = ([torch.device(d) for d in devices] if devices is not None
            else visible_devices())
    dead = set(dead_ids)
    out = [d for d in devs if device_id(d) not in dead]
    if not out:
        raise RuntimeError(
            f"no surviving devices: all of "
            f"{sorted(device_id(d) for d in devs)} reported dead"
        )
    return out


def surviving_members(dead_ids, members: Sequence[int]) -> List[int]:
    """``members`` minus ``dead_ids`` — the member ids a rescue regroups
    over. Raises when nothing survives, as :func:`surviving_devices`
    does."""
    dead = set(int(d) for d in dead_ids)
    out = [int(m) for m in members if int(m) not in dead]
    if not out:
        raise RuntimeError(
            f"no surviving members: all of {sorted(members)} reported dead")
    return out


@dataclasses.dataclass
class DeviceStats:
    """One device's identity and live memory sample: the watchdog line,
    the ``device.<id>.*`` exporter gauges, the Chrome-trace memory
    counter tracks and the run report's watermark all render from this
    one record. Memory fields are None-tolerant: a CPU device reports
    nothing, and a diagnostic must never fail gathering its own
    evidence."""

    id: int
    platform: str
    kind: str
    process_index: int
    bytes_in_use: Optional[int] = None
    bytes_limit: Optional[int] = None
    #: The allocator's own peak (``torch.cuda.max_memory_allocated``);
    #: the sampler keeps a cross-sample watermark on top.
    peak_bytes_in_use: Optional[int] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _stats_of(dev: torch.device) -> DeviceStats:
    if dev.type != "cuda":
        return DeviceStats(id=device_id(dev), platform=dev.type,
                           kind=dev.type, process_index=0)
    idx = device_id(dev)
    out = DeviceStats(id=idx, platform="gpu", kind=dev.type,
                      process_index=0)
    try:
        out.kind = torch.cuda.get_device_name(idx)
    except Exception:
        pass
    for field, read in (
            ("bytes_in_use", lambda: torch.cuda.memory_allocated(idx)),
            ("peak_bytes_in_use", lambda: torch.cuda.max_memory_allocated(idx)),
            ("bytes_limit", lambda: torch.cuda.mem_get_info(idx)[1])):
        try:
            setattr(out, field, int(read()))
        except Exception:
            pass
    return out


def device_stats(devices: Optional[Sequence] = None) -> List[DeviceStats]:
    """Typed per-device samples (id, kind, memory in use, the card's
    memory, the allocator's peak) for ``devices`` (default: every
    visible CUDA device, else the CPU). Never raises; every memory
    field degrades to None on its own."""
    if devices is None:
        devs = visible_devices() or [torch.device("cpu")]
    else:
        devs = [torch.device(d) for d in devices]
    return [_stats_of(d) for d in devs]


def _render_device_line(s: DeviceStats) -> str:
    """One watchdog line from one :class:`DeviceStats`: the memory
    clause appears only when ``bytes_in_use`` is known, the limit only
    when truthy (``pagerank_tpu/parallel/mesh.py:218-229``)."""
    line = f"{s.platform}:{s.id} ({s.kind}, proc {s.process_index})"
    if s.bytes_in_use is not None:
        line += f" hbm {s.bytes_in_use / 1e9:.2f}GB"
        if s.bytes_limit:
            line += f"/{s.bytes_limit / 1e9:.2f}GB"
    return line


def device_view(devices: Optional[Sequence] = None) -> Sequence[str]:
    """One human line per device — id, kind, process and (on a card)
    memory in use — the per-device evidence the stall watchdog prints."""
    return [_render_device_line(s) for s in device_stats(devices)]
