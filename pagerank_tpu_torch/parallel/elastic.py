"""The error types of the elastic layer: a copy of
``pagerank_tpu/parallel/elastic.py:55-110`` (``DeviceLostError``,
``DeviceQuarantinedError``, ``ElasticExhaustedError``,
``looks_like_device_loss``), whose loss markers also know CUDA's
strings of a lost or failing card. The serving daemon's rescue path
reads them; the elastic runner and the health monitor come with ROADMAP
slice 6.
"""

from __future__ import annotations

from typing import Sequence


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
)


def looks_like_device_loss(exc: BaseException) -> bool:
    """Whether a step failure is worth a liveness probe (vs a plain
    programming/numerics error that must surface unchanged)."""
    if isinstance(exc, DeviceLostError):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _DEVICE_LOSS_MARKERS)
