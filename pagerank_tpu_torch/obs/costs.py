"""What one card offers a kernel: the device table of the port.

Port of the capacity half of ``pagerank_tpu/obs/costs.py`` (the HBM
rate, capacity and VMEM tables, ``hbm_capacity_bytes``,
``vmem_capacity_bytes``, ``pallas_vmem_budget``,
``DEFAULT_VMEM_TARGET_KIND``) for Hopper, and of its ledger half
(``CostReport``, ``record_report``, ``attach_measurement``,
``ledger_snapshot``, ``reset``, :155-363; no compiler reports peak,
argument or temporary bytes here) with the bytes of a step taken
from the kernel's analytic byte model (``analysis/kernels.py``
``k1_cost``/``k2_cost``, through ``TorchEngine.cost_reports``) in place
of XLA's ``cost_analysis``: the run report's ``costs`` section. One entry per card, keyed by
a substring of ``torch.cuda.get_device_name()``; the longest key that
matches wins, as in the JAX tables. The numbers are NVIDIA's data
sheets and the Hopper tuning guide.

As the JAX PTK001 rule and the engine's Pallas refusal shared one VMEM
bound, the kernel-plane check (``analysis/kernels.py``, PTK001) and the
gather probe's refusal (``ops/gather_probe.py:rowsel_fits``) read one
shared-memory bound from here, and ``chip_smoke.py`` takes its memory
rate for every byte bound from here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

from pagerank_tpu_torch.obs import metrics as obs_metrics


@dataclass(frozen=True)
class DeviceSpec:
    """What a block, a thread and the card may use."""

    name: str
    #: Shared memory one block may use: static + dynamic, bytes.
    smem_per_block: int
    #: Dynamic shared memory a launch gets without the opt-in
    #: (``cudaFuncAttributeMaxDynamicSharedMemorySize``); also the most
    #: static shared memory a kernel may declare.
    smem_default: int
    #: Shared memory the card reserves for each block
    #: (cudaDevAttrReservedSharedMemoryPerBlock); cuobjdump's SHARED
    #: count includes it on every kernel of a library in which any
    #: kernel uses shared memory.
    smem_reserved: int
    regs_per_sm: int
    regs_per_thread: int
    max_threads_per_block: int
    sms: int
    l2_bytes: int
    hbm_bytes_per_s: float
    #: The card's memory (the data sheet's GB); the fit check prefers
    #: the live ``mem_get_info`` total when the card is attached.
    hbm_bytes: int
    #: f32 FLOP/s outside the tensor cores (dense, full power limit).
    fp32_flops_per_s: float
    #: TF32 FLOP/s on the tensor cores (dense, full power limit).
    tf32_flops_per_s: float


HOPPER = {
    "h100": DeviceSpec("NVIDIA H100 SXM", smem_per_block=232_448,
                       smem_default=49_152, smem_reserved=1024,
                       regs_per_sm=65_536,
                       regs_per_thread=255, max_threads_per_block=1024,
                       sms=132, l2_bytes=50_000_000,
                       hbm_bytes_per_s=3.35e12, hbm_bytes=80 * 10**9,
                       fp32_flops_per_s=67e12, tf32_flops_per_s=495e12),
    "h200": DeviceSpec("NVIDIA H200 SXM", smem_per_block=232_448,
                       smem_default=49_152, smem_reserved=1024,
                       regs_per_sm=65_536,
                       regs_per_thread=255, max_threads_per_block=1024,
                       sms=132, l2_bytes=50_000_000,
                       hbm_bytes_per_s=4.8e12, hbm_bytes=141 * 10**9,
                       fp32_flops_per_s=67e12, tf32_flops_per_s=495e12),
}

#: The card the check sizes for when none is attached (the CPU tests,
#: or sizing a launch before the card runs it): the port's measured card.
DEFAULT_TARGET_KIND = "h100"


def device_spec(device_kind: Optional[str] = None) -> DeviceSpec:
    """The table entry for ``device_kind`` (a device name), or the
    default target's when no kind is given. An unknown kind raises: a
    guessed capacity is worse than none."""
    if not device_kind:
        return HOPPER[DEFAULT_TARGET_KIND]
    kind = device_kind.lower()
    for key in sorted(HOPPER, key=len, reverse=True):
        if key in kind:
            return HOPPER[key]
    raise KeyError(f"no device table entry matches {device_kind!r} "
                   f"(known: {', '.join(sorted(HOPPER))})")


def hbm_capacity_bytes(device_kind: Optional[str]) -> Optional[int]:
    """The card's memory from the table, or None for an unknown kind
    (``pagerank_tpu/obs/costs.py:86``)."""
    try:
        return device_spec(device_kind).hbm_bytes if device_kind else None
    except KeyError:
        return None


# -- the cost ledger: one model per program form ------------------------------


@dataclass
class CostReport:
    """One step form's analytic cost (and, once attached, its measured
    time), a launch an iteration. ``bytes_accessed`` is what the form's
    kernel must move (its byte bound's numerator), so
    ``roofline_fraction`` is the step's achieved share of the kernel's
    byte bound: the bound's time over the measured step. It does not
    depend on which implementation runs the kernel (the card's or its
    plain twin)."""

    form: str
    flops: float
    bytes_accessed: float
    num_edges: Optional[int] = None
    seconds_per_iter: Optional[float] = None
    device_kind: Optional[str] = None
    #: The kernel's model in analysis/kernels.py (``k1_cost``,
    #: ``k2_cost``).
    model: Optional[str] = None

    @property
    def bytes_per_edge(self) -> Optional[float]:
        return self.bytes_accessed / self.num_edges if self.num_edges \
            else None

    @property
    def achieved_bytes_per_s(self) -> Optional[float]:
        if not self.seconds_per_iter:
            return None
        return self.bytes_accessed / self.seconds_per_iter

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Achieved bytes/s over the card's memory rate: the step's
        share of the byte bound (None off the table or unmeasured)."""
        a = self.achieved_bytes_per_s
        if a is None or not self.device_kind:
            return None
        try:
            peak = device_spec(self.device_kind).hbm_bytes_per_s
        except KeyError:
            return None
        return a / peak

    def to_json(self) -> dict:
        """Stored fields and the derived views, under the JAX ledger's
        key names (``flops_per_iter``, ``bytes_per_iter``, ...)."""
        out = dataclasses.asdict(self)
        out["flops_per_iter"] = self.flops
        out["bytes_per_iter"] = self.bytes_accessed
        out["bytes_per_edge"] = self.bytes_per_edge
        out["achieved_bytes_per_s"] = self.achieved_bytes_per_s
        out["roofline_fraction"] = self.roofline_fraction
        return out


_LEDGER: Dict[str, CostReport] = {}


def record_report(report: CostReport) -> CostReport:
    """File ``report`` under its form (last write wins) and mirror its
    headline numbers into ``cost.<form>.*`` gauges."""
    _LEDGER[report.form] = report
    for metric, value in (("flops", report.flops),
                          ("hbm_bytes", report.bytes_accessed)):
        obs_metrics.gauge(
            f"cost.{report.form}.{metric}",
            f"kernel byte model: per-iteration {metric} of the "
            f"'{report.form}' program",
        ).set(value)
    return report


def attach_measurement(form: str, seconds_per_iter: float,
                       num_edges: Optional[int] = None
                       ) -> Optional[CostReport]:
    """Attach a measured per-iteration wall to a ledgered form (None
    when the form was never recorded)."""
    report = _LEDGER.get(form)
    if report is None:
        return None
    report.seconds_per_iter = float(seconds_per_iter)
    if num_edges is not None:
        report.num_edges = num_edges
    frac = report.roofline_fraction
    if frac is not None:
        obs_metrics.gauge(
            f"cost.{form}.roofline_fraction",
            f"achieved bytes/s over the card's memory rate for '{form}'",
        ).set(frac)
    return report


def ledger_snapshot() -> Dict[str, dict]:
    """``{form: CostReport.to_json()}``, stable key order: the run
    report's ``costs`` section."""
    return {form: _LEDGER[form].to_json() for form in sorted(_LEDGER)}


def reset() -> None:
    """Drop every ledgered report (one run's model must not bleed into
    the next in-process run)."""
    _LEDGER.clear()
