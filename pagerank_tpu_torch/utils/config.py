"""Configuration of a PageRank run.

Port of ``pagerank_tpu/utils/config.py:132-212`` (``PageRankConfig``),
its kernel and partition-centric validation rules (``:404-410``,
``:445-480``, same messages), its probe and SDC fields
(``probe_every``, ``probe_topk``, ``stop_tol``, ``sdc_check_every``,
``sdc_seed``, ``:325-402``) and the ``RobustnessConfig`` fields of the
solve loop, the sinks and the SDC redo (``:22-125``: health checks,
rollbacks, ``write_attempts``, ``on_write_failure``,
``write_retry_policy()``, ``sdc_redo_deadline_s``, ``sdc_max_redos``,
and the elastic runner's ``max_rescues``, ``straggler_factor`` and
``rescue_budget()``, ``:58-64``, ``:86-93``, ``:125-129``; same defaults
and messages), and the vertex-sharded forms' fields
(``vs_bounded``, ``halo_exchange``, ``halo_head``, ``halo_async``,
``stale_max_lag``, ``halo_async_min_gain``, ``:232-313``, their rules
``:411-441``, same defaults and messages).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

from pagerank_tpu_torch.utils.retry import RetryPolicy

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

    #: Sink-write retry budget for snapshots/text dumps (total
    #: attempts; 1 disables) and what to do when it is exhausted:
    #: 'fail' aborts the run, 'warn_and_drop' records the iteration in
    #: the dead-letter manifest and keeps solving.
    write_attempts: int = 3
    on_write_failure: str = "fail"

    #: Elastic-rescue budget (parallel/elastic.py): group teardown +
    #: regroup + re-shard + warm-start recoveries the run may perform
    #: after device losses before raising ElasticExhaustedError. None
    #: (default) spends the SAME budget class as rollbacks
    #: (max_rollbacks) — one knob bounds total recovery work unless
    #: the operator splits them.
    max_rescues: Optional[int] = None

    #: Straggler-detection threshold (DeviceHealthMonitor): a step
    #: slower than this factor times the step-time EWMA — but
    #: COMPLETED — is flagged as slow-step telemetry (elastic.slow_steps
    #: counter, straggler_skew gauge). Never triggers a rescue.
    straggler_factor: float = 4.0

    #: Wall-clock budget for one SDC breach's bounded re-execution
    #: window (sdc.py): past it the episode escalates (quarantine when
    #: an attribution stands, SdcExhaustedError otherwise).
    sdc_redo_deadline_s: float = 30.0

    #: Re-executions one SDC breach episode may spend before
    #: escalating: the first clean redo classifies TRANSIENT, a repeat
    #: breach attributing to the same device classifies STICKY.
    sdc_max_redos: int = 2

    def validate(self) -> "RobustnessConfig":
        if self.max_rollbacks < 0:
            raise ValueError(
                f"max_rollbacks must be >= 0, got {self.max_rollbacks}"
            )
        if self.max_rescues is not None and self.max_rescues < 0:
            raise ValueError(
                f"max_rescues must be >= 0 (None = max_rollbacks), got "
                f"{self.max_rescues}"
            )
        if self.straggler_factor <= 1.0:
            raise ValueError(
                f"straggler_factor must be > 1, got {self.straggler_factor}"
            )
        if self.write_attempts < 1:
            raise ValueError(
                f"write_attempts must be >= 1, got {self.write_attempts}"
            )
        if self.on_write_failure not in ("fail", "warn_and_drop"):
            raise ValueError(
                f"on_write_failure must be 'fail' or 'warn_and_drop', "
                f"got {self.on_write_failure!r}"
            )
        if self.mass_tol is not None and not (0.0 < self.mass_tol):
            raise ValueError(f"mass_tol must be positive, got {self.mass_tol}")
        if self.sdc_redo_deadline_s <= 0:
            raise ValueError(
                f"sdc_redo_deadline_s must be positive, got "
                f"{self.sdc_redo_deadline_s}"
            )
        if self.sdc_max_redos < 1:
            raise ValueError(
                f"sdc_max_redos must be >= 1, got {self.sdc_max_redos}"
            )
        return self

    def write_retry_policy(self) -> Optional[RetryPolicy]:
        """RetryPolicy for sink writes, or None when retries are off."""
        if self.write_attempts <= 1:
            return None
        return RetryPolicy(max_attempts=self.write_attempts)

    def rescue_budget(self) -> int:
        """The resolved elastic-rescue budget (max_rescues, defaulting
        to the rollback budget — ONE recovery-work bound by default)."""
        return (self.max_rescues if self.max_rescues is not None
                else self.max_rollbacks)


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

    # Devices (parallel/mesh.py): the ranks of the process group the
    # solve runs over (None: the group's world size, 1 without a group)
    # and the mesh axis name. vertex_sharded shards the rank vector, the
    # masks and 1/out-degree over the mesh in contiguous vertex blocks
    # (the reference's hash-partitioned ranks RDD, Sparky.java:165-170)
    # instead of keeping them whole on every device: a per-iteration
    # all_gather of z and a reduce-scatter of the contribution, for
    # 1/num_devices of the per-vertex memory per device. Requires the
    # ell kernel.
    vertex_sharded: bool = False
    num_devices: Optional[int] = None
    mesh_axis: str = "data"

    # Sparse boundary exchange (parallel/partition.build_halo_plan):
    # replace the vertex-sharded step's dense exchange (all_gather of
    # the whole z + a full-width reduce-scatter) with a build-time halo
    # plan — the top-K high in-degree head replicated by one small
    # psum, the tail boundary moved point to point over static ppermute
    # rounds, and the merge returning only each writer's band windows —
    # so the bytes a step scale with the boundary instead of n. K1 reads
    # the same z bits as on the dense path; only the merge regroups.
    # Requires vertex_sharded; not with vs_bounded.
    halo_exchange: bool = False

    # Head-replication K for halo_exchange: -1 = auto (the relabeled
    # in-degree prefix whose replication minimizes the modeled exchange
    # bytes over the exact build-time pair sets —
    # parallel/partition.auto_head_k; may resolve to 0), 0 = none,
    # > 0 = explicit (rounded up to a multiple of 128).
    halo_head: int = -1

    # Asynchronous stale-boundary iteration: a two-slot boundary buffer,
    # so iteration k's K1 runs over iteration k-1's boundary while
    # iteration k's ships (remote reads lag one iteration; each rank's
    # own block is always fresh). Requires halo_exchange; refused at
    # build (layout_info records halo_async="off:<reason>") on one
    # device, a plan with no boundary, or a predicted overlap gain
    # below halo_async_min_gain (parallel/comms.predict_overlap_gain).
    halo_async: bool = False

    # The most a boundary read may lag under halo_async: 1 = the
    # double-buffered form; 0 = exactness — the build runs the
    # synchronous vs_halo step (no extra buffer, the same bits).
    stale_max_lag: int = 1

    # The predicted overlap gain (exchange fraction x overlappable byte
    # share) below which the halo_async gate refuses the async form.
    halo_async_min_gain: float = 0.02

    # Owner-computes vertex sharding: dst blocks dealt across the ranks'
    # contiguous ranges by capacity-constrained LPT
    # (ops/ell.deal_block_order), each rank holding only the slot rows
    # of its own dst range, so K1's sums land where they are owned and
    # the contribution merge disappears — the reference's reduceByKey
    # (Sparky.java:229). Agrees with the other forms to accumulation
    # rounding (bit-equal on one device). Requires vertex_sharded and a
    # host-built graph.
    vs_bounded: bool = False

    # Silent-data-corruption defense (sdc.py): every K-th step runs
    # the SDC-checked step (the same contribution launch and update as
    # step(), plus a check tail of reductions), a breach triggering the
    # bounded redo -> transient/sticky -> quarantine machine. 0
    # disables: the solve takes the unchecked code path, with zero
    # check computations.
    sdc_check_every: int = 0

    # In-loop convergence probes (obs/probes.py): every probe_every
    # iterations the step also computes the rank mass and the
    # top-probe_topk churn on the device, fetched with the step's own
    # scalars. 0 disables: the unprobed code path (zero probe calls).
    # stop_tol early-exits when the PROBED residual reaches it (checked
    # at probe points only — unlike `tol`, which checks every
    # iteration); None keeps the reference's fixed iteration count.
    probe_every: int = 0
    probe_topk: int = 64
    stop_tol: Optional[float] = None

    # Seed of the Rademacher random-projection vector the SDC
    # fingerprints contract against (sdc.fingerprint_vector).
    sdc_seed: int = 0

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
        if self.probe_every < 0:
            raise ValueError(
                f"probe_every must be >= 0 (0 disables), got "
                f"{self.probe_every}"
            )
        if self.probe_topk < 1:
            raise ValueError(
                f"probe_topk must be >= 1, got {self.probe_topk}"
            )
        if self.sdc_check_every < 0:
            raise ValueError(
                f"sdc_check_every must be >= 0 (0 disables), got "
                f"{self.sdc_check_every}"
            )
        if self.stop_tol is not None:
            if not (0.0 < self.stop_tol < float("inf")):
                raise ValueError(
                    f"stop_tol must be a finite positive float, got "
                    f"{self.stop_tol}"
                )
            if self.probe_every == 0:
                raise ValueError(
                    "stop_tol is checked at probe points only; set "
                    "probe_every > 0 (or use tol for an every-"
                    "iteration check)"
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
        if self.vs_bounded and not self.vertex_sharded:
            raise ValueError("vs_bounded requires vertex_sharded")
        if self.halo_exchange:
            if not self.vertex_sharded:
                raise ValueError("halo_exchange requires vertex_sharded")
            if self.vs_bounded:
                raise ValueError(
                    "halo_exchange targets the plain vertex-sharded "
                    "exchange; vs_bounded has its own owner-computes "
                    "exchange"
                )
        if self.halo_async and not self.halo_exchange:
            raise ValueError(
                "halo_async overlaps the sparse boundary exchange; "
                "set halo_exchange (the dense all_gather step has no "
                "boundary buffer to double)"
            )
        if self.stale_max_lag not in (0, 1):
            raise ValueError(
                f"stale_max_lag must be 0 (exact sync) or 1 (double-"
                f"buffered overlap), got {self.stale_max_lag}"
            )
        if self.halo_async_min_gain < 0:
            raise ValueError(
                f"halo_async_min_gain must be >= 0, got "
                f"{self.halo_async_min_gain}"
            )
        if self.halo_head < -1:
            raise ValueError(
                f"halo_head must be -1 (auto), 0 (off), or positive, "
                f"got {self.halo_head}"
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
        if torch_dtype(self.accum_dtype).itemsize < torch_dtype(
                self.dtype).itemsize:
            raise ValueError(
                f"accum_dtype {self.accum_dtype} narrower than dtype "
                f"{self.dtype}"
            )
        return self

    def replace(self, **kw) -> "PageRankConfig":
        return dataclasses.replace(self, **kw)
