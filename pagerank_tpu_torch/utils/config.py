"""Configuration of a PageRank run.

Port of ``pagerank_tpu/utils/config.py:132-212`` (``PageRankConfig``),
its kernel and partition-centric validation rules (``:404-410``,
``:445-480``, same messages) and the three ``RobustnessConfig`` fields the solve loop reads. The
fields of layouts and modes that later slices of the port bring are
kept so a caller can name them, and ``validate`` refuses them with the
ROADMAP slice that ports them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

SEMANTICS_REFERENCE = "reference"
SEMANTICS_TEXTBOOK = "textbook"

#: The dtype strings the port accepts, and their torch dtypes.
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype string ("float32"/"float64")."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(
            f"dtype {name!r} is not supported by the port; use one of "
            f"{sorted(DTYPES)}"
        ) from None


@dataclass
class RobustnessConfig:
    """The self-healing knobs of the solve loop (engine.run)."""

    #: Per-step health check: a non-finite step scalar (l1_delta,
    #: dangling_mass) triggers rollback-or-raise.
    health_checks: bool = True

    #: Opt-in rank-mass drift bound: relative change of sum(ranks)
    #: allowed per step. None disables.
    mass_tol: Optional[float] = None

    #: Snapshot rollbacks engine.run may perform before raising
    #: SolverHealthError.
    max_rollbacks: int = 3

    def validate(self) -> "RobustnessConfig":
        if self.max_rollbacks < 0:
            raise ValueError(
                f"max_rollbacks must be >= 0, got {self.max_rollbacks}"
            )
        if self.mass_tol is not None and not (0.0 < self.mass_tol):
            raise ValueError(f"mass_tol must be positive, got {self.mass_tol}")
        return self


@dataclass
class PageRankConfig:
    """All knobs for a PageRank run of the port.

    Defaults reproduce the reference workload: 10 iterations
    (Sparky.java:187), damping 0.85 (:233), reference semantics.
    """

    num_iters: int = 10
    damping: float = 0.85
    semantics: str = SEMANTICS_REFERENCE

    # dtype holds the rank vector; accum_dtype is used for the
    # contribution sums, the dangling mass and the L1 delta.
    dtype: str = "float32"
    accum_dtype: str = "float32"

    # "auto", "ell" and "pallas" all run the hand-written CUDA kernels:
    # the flat ELL form through K1 (ops/ell_spmv.py), and with a
    # partition_span the partition-centric form through K2
    # (ops/ell_spmv_partitioned.py). On the card the kernel is the hot
    # op of every ELL form. "coo" = dst-sorted COO + a per-edge segment
    # sum in fixed order (ops/spmv.py:edge_contrib_segment_sum; torch
    # ops, no hand kernel): the portable baseline.
    kernel: str = "auto"

    # Early stop when L1(r' - r) <= tol; None runs all num_iters.
    tol: Optional[float] = None

    # Partition-centric layout: sub-bin slots by source partitions of
    # this many vertices (a positive multiple of 128; 0 = the flat
    # form). 32-bit accumulation only.
    partition_span: int = 0
    # "bfloat16" streams the partition windows in bf16, summed in f32;
    # "" streams them in the rank dtype. Needs partition_span.
    stream_dtype: str = ""

    # Fields of later slices (ROADMAP queue 1): accepted at their
    # defaults only.
    vertex_sharded: bool = False
    num_devices: Optional[int] = None

    robustness: RobustnessConfig = field(default_factory=RobustnessConfig)

    def validate(self) -> "PageRankConfig":
        self.robustness.validate()
        if self.semantics not in (SEMANTICS_REFERENCE, SEMANTICS_TEXTBOOK):
            raise ValueError(f"unknown semantics mode: {self.semantics!r}")
        if not (0.0 < self.damping < 1.0):
            raise ValueError(f"damping must be in (0,1), got {self.damping}")
        if self.num_iters < 0:
            raise ValueError("num_iters must be >= 0")
        if self.tol is not None and not (0.0 < self.tol < float("inf")):
            raise ValueError(
                f"tol must be a finite positive float, got {self.tol}"
            )
        # The kernel and partition rules come first, in the JAX
        # package's order, so the same invalid config raises the same
        # message in both.
        if self.kernel not in ("auto", "ell", "coo", "pallas"):
            raise ValueError(f"unknown kernel: {self.kernel!r}")
        if self.vertex_sharded and self.kernel in ("coo", "pallas"):
            raise ValueError(
                f"vertex_sharded requires the ell kernel, got "
                f"{self.kernel!r}"
            )
        if self.stream_dtype not in ("", "bfloat16"):
            raise ValueError(
                f"stream_dtype must be '' or 'bfloat16', got "
                f"{self.stream_dtype!r}"
            )
        if self.stream_dtype and not self.partition_span:
            raise ValueError(
                "stream_dtype is consumed by the partition-centric "
                "layout only; set partition_span (the default layout "
                "would silently ignore the narrowed stream)"
            )
        if self.partition_span:
            if self.partition_span < 0 or self.partition_span % 128:
                raise ValueError(
                    f"partition_span must be a positive multiple of 128 "
                    f"(0 disables), got {self.partition_span}"
                )
            if self.kernel not in ("auto", "ell", "pallas"):
                raise ValueError(
                    f"partition_span requires the ell or pallas kernel, "
                    f"got {self.kernel!r}"
                )
            if self.vertex_sharded:
                raise ValueError(
                    "partition_span is a replicated-mode layout; it does "
                    "not compose with vertex_sharded"
                )
        if (self.stream_dtype or self.partition_span) and torch_dtype(
                self.accum_dtype).itemsize > 4:
            raise ValueError(
                "partition_span/stream_dtype support 32-bit "
                "accumulation only (the pair/native wide paths keep "
                "the default layout)"
            )
        if self.vertex_sharded or (self.num_devices or 1) > 1:
            raise ValueError(
                "vertex_sharded/num_devices > 1 (more than one GPU) are "
                "not ported yet: ROADMAP slice 6"
            )
        if torch_dtype(self.accum_dtype).itemsize < torch_dtype(
                self.dtype).itemsize:
            raise ValueError(
                f"accum_dtype {self.accum_dtype} narrower than dtype "
                f"{self.dtype}"
            )
        return self

    def replace(self, **kw) -> "PageRankConfig":
        return dataclasses.replace(self, **kw)
