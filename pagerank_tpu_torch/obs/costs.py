"""What one card offers a kernel: the device table of the port.

Port of the capacity half of ``pagerank_tpu/obs/costs.py`` (the HBM
rate and VMEM tables, ``vmem_capacity_bytes``, ``pallas_vmem_budget``,
``DEFAULT_VMEM_TARGET_KIND``) for Hopper. One entry per card, keyed by
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

from dataclasses import dataclass
from typing import Optional


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
    #: f32 FLOP/s outside the tensor cores (dense, full power limit).
    fp32_flops_per_s: float


HOPPER = {
    "h100": DeviceSpec("NVIDIA H100 SXM", smem_per_block=232_448,
                       smem_default=49_152, smem_reserved=1024,
                       regs_per_sm=65_536,
                       regs_per_thread=255, max_threads_per_block=1024,
                       sms=132, l2_bytes=50_000_000,
                       hbm_bytes_per_s=3.35e12, fp32_flops_per_s=67e12),
    "h200": DeviceSpec("NVIDIA H200 SXM", smem_per_block=232_448,
                       smem_default=49_152, smem_reserved=1024,
                       regs_per_sm=65_536,
                       regs_per_thread=255, max_threads_per_block=1024,
                       sms=132, l2_bytes=50_000_000,
                       hbm_bytes_per_s=4.8e12, fp32_flops_per_s=67e12),
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
