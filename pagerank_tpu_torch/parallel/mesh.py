"""Deadline-bounded dispatch and device liveness — the serving subset
of ``pagerank_tpu/parallel/mesh.py`` (:58-156).

``DeadlineExpired`` and ``run_with_deadline`` are copies (pure
threading); ``probe_liveness`` and ``surviving_devices`` take torch
devices, keyed by :func:`device_id`, and the liveness echo is a tiny
torch op on each device. Meshes, shardings and device statistics come
with more than one GPU (ROADMAP slice 6).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch


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
