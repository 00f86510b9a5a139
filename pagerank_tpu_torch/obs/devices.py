"""Device-plane observability of one card: the memory sampler and the
OOM-preflight fit check.

Port of ``pagerank_tpu/obs/devices.py`` at one device:

  - :class:`DeviceSampler` (:68-252, copied): per-device samples from
    ``parallel/mesh.device_stats()`` (``torch.cuda.memory_allocated``,
    ``max_memory_allocated``, ``mem_get_info``; None on the CPU) fanned
    out to ``device.<id>.*`` gauges, Chrome counter tracks and the
    watermark the run report embeds, failure-marked reports included.
    Process-global arm/disarm like the watchdog: disarmed, the solve
    loop makes zero sampler calls.
  - :func:`fit_check` / :func:`render_fit` (:625-750): the JAX check
    AOT-lowers the build stages over abstract shapes and reads XLA's
    memory analysis; torch has no such compiler, so here each stage's
    peak is an ANALYTIC model of the port's own device build
    (``ops/device_build.py``: generation or upload, relabel, the one
    int64-key sort, slots, scatter) and of the placed engine (slot
    arrays, planes, the z buffer, the step's temporaries), against the
    card's memory from live ``mem_get_info`` or the Hopper table
    (``obs/costs.py``). Nothing allocates.

  - :func:`attribute_exchange` (:258-320, copied): the vertex-sharded
    step's wall split between its exchange and its compute, from the
    engine's exchange-only dispatch (``TorchEngine.time_exchange_split``,
    fenced by ``torch.cuda.synchronize``) and its comms byte model.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence

from pagerank_tpu_torch.obs import costs as obs_costs
from pagerank_tpu_torch.obs import log as obs_log
from pagerank_tpu_torch.obs import metrics as obs_metrics
from pagerank_tpu_torch.obs import trace as obs_trace

# -- per-device sampler ------------------------------------------------------

#: Chrome-trace pid base for per-device counter tracks: device id d
#: renders on pid TRACK_PID_BASE + d, above the kernel's maximum
#: pid_max (2^22 on Linux), so the memory lanes never collide with the
#: process's own span rows in Perfetto.
TRACK_PID_BASE = 1 << 23


class DeviceSampler:
    """Structured per-device memory sampler.

    Each :meth:`sample` reads ``mesh.device_stats()`` once and fans the
    typed records out to every device-plane surface:

      - ``device.<id>.bytes_in_use`` / ``.bytes_limit`` /
        ``.peak_bytes`` registry gauges — registered eagerly (the name
        exists in the snapshot even when the CPU reports None; an
        unset gauge publishes no sample);
      - a ``device.<id>.hbm`` counter point on the active tracer's
        per-device track (Chrome ``ph:"C"``) — skipped when tracing is
        off or nothing was reported;
      - the cross-sample high-water mark (:meth:`watermark`) the run
        report embeds, folded with the allocator's own peak.

    ``on_step(iteration)`` is the engine.run hook: it samples at the
    ``every`` cadence, and runs only when a sampler is armed."""

    def __init__(self, every: int = 1, devices: Optional[Sequence] = None):
        if every < 1:
            raise ValueError(f"sample cadence must be >= 1, got {every}")
        self.every = int(every)
        # A sequence pins the device set; a zero-arg callable resolves
        # it at each sweep; None sweeps every visible device.
        self._devices = (devices if devices is None or callable(devices)
                         else list(devices))
        self.samples = 0
        self.last: List = []
        #: Per-device high-water ``bytes_in_use`` across every sample of
        #: this sampler's life (plus the allocator's own peak field).
        self.peak_bytes: Dict[int, int] = {}

    def sample(self, iteration: Optional[int] = None) -> List:
        """One sweep over the devices; returns the typed
        :class:`~pagerank_tpu_torch.parallel.mesh.DeviceStats` list.
        Never raises past a field degrading to None."""
        from pagerank_tpu_torch.parallel import mesh as mesh_lib

        devs = self._devices
        if callable(devs):
            try:
                devs = list(devs())
            except Exception:
                devs = None
        stats = mesh_lib.device_stats(devs)
        self.samples += 1
        self.last = stats
        tracer = obs_trace.get_tracer()
        for s in stats:
            g_use = obs_metrics.gauge(
                f"device.{s.id}.bytes_in_use",
                f"live device memory bytes in use on device {s.id}",
            )
            g_lim = obs_metrics.gauge(
                f"device.{s.id}.bytes_limit",
                f"device memory bytes the card reports for device {s.id}",
            )
            g_peak = obs_metrics.gauge(
                f"device.{s.id}.peak_bytes",
                f"high-water device memory bytes observed on device "
                f"{s.id} (max of sampled bytes_in_use and the "
                f"allocator's own peak)",
            )
            if s.bytes_limit is not None:
                g_lim.set(s.bytes_limit)
            peak = self.peak_bytes.get(s.id)
            for candidate in (s.bytes_in_use, s.peak_bytes_in_use):
                if candidate is not None:
                    peak = candidate if peak is None else max(peak,
                                                              candidate)
            if s.bytes_in_use is not None:
                g_use.set(s.bytes_in_use)
            if peak is not None:
                self.peak_bytes[s.id] = peak
                g_peak.set(peak)
            if tracer.enabled:
                values = {
                    k: v for k, v in (
                        ("bytes_in_use", s.bytes_in_use),
                        ("bytes_limit", s.bytes_limit),
                    ) if v is not None
                }
                if values:
                    tracer.add_counter(
                        f"device.{s.id}.hbm", values,
                        track=TRACK_PID_BASE + s.id,
                        track_label=(
                            f"device {s.platform}:{s.id} ({s.kind})"
                        ),
                    )
        if self.peak_bytes:
            obs_metrics.gauge(
                "device.hbm_high_water_bytes",
                "max device memory bytes_in_use observed on any device "
                "this run",
            ).set(max(self.peak_bytes.values()))
        return stats

    def on_step(self, iteration: int) -> None:
        """engine.run's per-completed-step hook (armed samplers only):
        sample at the ``every`` cadence, starting from the first
        step."""
        if iteration % self.every == 0:
            self.sample(iteration)

    def watermark(self) -> dict:
        """The run report's ``devices`` section: the high-water mark,
        per-device peaks, and the last full sample."""
        overall = max(self.peak_bytes.values()) if self.peak_bytes else None
        return {
            "samples": self.samples,
            "hbm_high_water_bytes": overall,
            "per_device_peak_bytes": {
                str(k): v for k, v in sorted(self.peak_bytes.items())
            },
            "last": [s.to_json() for s in self.last],
        }


_SAMPLER: Optional[DeviceSampler] = None


def get_sampler() -> Optional[DeviceSampler]:
    """The armed sampler, or None (the default — engine.run reads this
    once per run; disarmed, the loop makes zero sampler calls)."""
    return _SAMPLER


def arm_sampler(sampler: DeviceSampler) -> DeviceSampler:
    """Install ``sampler`` as the process sampler and take an immediate
    baseline sample."""
    global _SAMPLER
    _SAMPLER = sampler
    sampler.sample()
    return sampler


def disarm_sampler() -> Optional[DeviceSampler]:
    global _SAMPLER
    prev = _SAMPLER
    _SAMPLER = None
    return prev


def report_section(sample_now: bool = True) -> Optional[dict]:
    """The ``devices`` section every run report carries: the armed
    sampler's watermark, refreshed with one final sample, or with no
    sampler armed a one-shot sample. Never raises."""
    try:
        s = get_sampler()
        if s is None:
            s = DeviceSampler()
            s.sample()
        elif sample_now:
            s.sample()
        return s.watermark()
    except Exception as e:  # a broken device must not block the report
        return {"error": repr(e)}


# -- comms-vs-compute attribution -------------------------------------------


def attribute_exchange(engine, iters: int = 10, warmup: int = 2,
                       ) -> Optional[dict]:
    """Wall attribution of the vertex-sharded step: time the engine's
    EXCHANGE-ONLY dispatch (the same all_gather / head-psum + ppermute
    rounds and the same merge collectives, the contribution replaced by
    zeros — ``TorchEngine._exchange_step``) against the full step, both
    closed by a device fence, and combine with the static comms byte
    model (parallel/comms.py):

      - ``exchange_s`` / ``compute_s`` / ``step_s`` (per iteration);
      - ``exchange_fraction`` = exchange / step — the is-it-wire-bound
        verdict, published as the ``comms.exchange_fraction`` gauge;
      - ``achieved_bytes_per_sec`` = modeled wire bytes per iteration
        over the measured exchange seconds — what the interconnect
        actually delivered, published as
        ``comms.achieved_bytes_per_sec``. Under gloo (ranks on the CPU,
        or sharing one card) the exchange goes through host memory:
        the number says where it was measured, not what NCCL across
        cards would deliver.

    Returns None when the engine has no exchange-only program
    (replicated forms, vs_bounded). Out-of-band by construction: nothing
    here touches the solve loop, and the engine restores its state after
    the timing steps. Over a mesh every rank must call it."""
    has = getattr(engine, "has_exchange_program", None)
    if has is None or not has():
        return None
    exchange_s, step_s = engine.time_exchange_split(
        iters=iters, warmup=warmup
    )
    model = engine.comms_model() or {}
    model_bytes = model.get("bytes_per_iter") or 0
    # Clamped like compute_s: the two walls are measured independently
    # and at dispatch-overhead-dominated toy geometries timing noise
    # can push the raw ratio past 1 — a fraction is a fraction.
    fraction = (min(1.0, exchange_s / step_s)) if step_s > 0 else None
    achieved = (model_bytes / exchange_s
                if exchange_s > 0 and model_bytes else None)
    out = {
        "iters": int(iters),
        "exchange_s": exchange_s,
        "step_s": step_s,
        "compute_s": max(0.0, step_s - exchange_s),
        "exchange_fraction": fraction,
        "model_bytes_per_iter": int(model_bytes) if model_bytes else None,
        "achieved_bytes_per_sec": achieved,
        "mode": model.get("mode"),
    }
    if fraction is not None:
        obs_metrics.gauge(
            "comms.exchange_fraction",
            "measured exchange wall over the full step wall "
            "(vertex-sharded attribution)",
        ).set(fraction)
    if achieved is not None:
        obs_metrics.gauge(
            "comms.achieved_bytes_per_sec",
            "modeled exchange bytes over the measured exchange "
            "seconds — delivered interconnect bandwidth",
        ).set(achieved)
    return out


# -- OOM-preflight fit check -------------------------------------------------

#: Slot-row estimate slack over the raw-edge lower bound e/128 (the
#: JAX check's constant): the port's pack measured 1.13 x e/128 at
#: rmat:22 (592,595 rows for 67,108,864 raw edges).
SLOT_ROW_SLACK = 1.6

DEFAULT_FIT_HEADROOM = 0.9  # allocator and context reserve off the top

#: Bytes an edge of each build stage's peak, as ``ops/device_build.py``
#: holds them (int32 = 4 B an edge, int64 = 8, bool/int8 = 1), counted
#: from the stage's code; the per-vertex tensors are added apart.
#:
#: - gen: src, dst (8) + one round's f32 draw (4), the f32 threshold
#:   (4) and two bool bit vectors (2) = 18;
#: - upload: the raw src, dst (8);
#: - relabel: the raw edges (8);
#: - sort: the int64 key (8), ``torch.sort``'s values and int64
#:   indices (16), the index iota it sorts from (8) and the radix
#:   sort's alternate key and index buffers (16) = 48, plus 1 for its
#:   small buffers and the allocator's rounding (the whole build of
#:   rmat:24 measured 13.096 GB on the card, 48.8 B a raw edge) = 49;
#: - slots: the sorted (sb_dst, new_src) (8), the dedup flags (1), the
#:   row ranks (4), the block ids (4), the lane ids (1) and the
#:   scatter-max's int64 index (8) and row + 1 (4) = 30 (flat); the
#:   striped form adds the stripe ids and local ids (8);
#: - scatter: words, row ids, lanes and keep flags (10), the int64
#:   flat slot index and its two int64 operands (24) = 34.
STAGE_BYTES_PER_EDGE = {"gen": 18, "upload": 8, "relabel": 8, "sort": 49,
                        "slots": 30, "slots_striped": 38, "scatter": 34}

#: Bytes a vertex held through the build: perm, inv_perm (int32), the
#: zero-in mask (bool), and from the slots stage the unique out-degree
#: (int32) = 13; the relabel's sort of n degrees peaks at 40.
BUILD_BYTES_PER_VERTEX = 13
RELABEL_BYTES_PER_VERTEX = 40


@dataclasses.dataclass
class FitStage:
    """One stage of the preflight table: the modeled peak bytes and
    where the number came from (``model`` = the analytic formula;
    ``error`` = a geometry the build refuses, itself a does-not-fit
    verdict)."""

    stage: str
    bytes: Optional[int]
    source: str
    detail: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FitResult:
    fits: bool
    limit_bytes: int
    limit_source: str
    headroom: float
    n: int
    num_edges: int
    ndev: int
    dtype: str
    accum_dtype: str
    vertex_sharded: bool
    stages: List[FitStage] = dataclasses.field(default_factory=list)
    scale: Optional[int] = None

    @property
    def effective_limit(self) -> float:
        return self.limit_bytes * self.headroom

    @property
    def peak_stage(self) -> Optional[FitStage]:
        known = [s for s in self.stages if s.bytes is not None]
        return max(known, key=lambda s: s.bytes) if known else None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["effective_limit_bytes"] = self.effective_limit
        peak = self.peak_stage
        d["peak_stage"] = peak.stage if peak else None
        d["peak_bytes"] = peak.bytes if peak else None
        return d


def _gib(v) -> str:
    return f"{v / (1 << 30):.2f} GiB" if v is not None else "-"


def resolve_hbm_limit(limit_bytes: Optional[int] = None,
                      device_kind: Optional[str] = None):
    """(card memory bytes, source string), in evidence order: an
    explicit byte limit, an explicit ``device_kind`` through the table,
    the attached card's own ``mem_get_info`` total, the attached card's
    kind through the table, and last the table's default card."""
    if limit_bytes:
        return int(limit_bytes), "explicit"
    if device_kind:
        cap = obs_costs.hbm_capacity_bytes(device_kind)
        if cap is not None:
            return int(cap), f"device-kind table ({device_kind})"
        obs_log.warn(
            f"fit check: device kind {device_kind!r} is not in the "
            f"Hopper table; falling back to live/default limits"
        )
    kind = None
    try:
        from pagerank_tpu_torch.parallel import mesh as mesh_lib

        stats = [s for s in mesh_lib.device_stats() if s.platform == "gpu"]
        limits = [s.bytes_limit for s in stats if s.bytes_limit]
        if limits:
            return int(min(limits)), "device mem_get_info"
        kind = stats[0].kind if stats else None
    except Exception as e:
        obs_log.info(f"fit check: no live device limits "
                     f"({type(e).__name__}); using the Hopper table")
    cap = obs_costs.hbm_capacity_bytes(kind)
    if cap is not None:
        return int(cap), f"device-kind table (attached {kind})"
    spec = obs_costs.device_spec()
    return spec.hbm_bytes, f"default ({spec.name} table entry)"


def estimate_slot_rows(num_edges: int, n_padded: int, n_stripes: int) -> int:
    """Upper-bound estimate of the packed slot-row count (the build's
    one data-dependent size): ceil(e/128) x :data:`SLOT_ROW_SLACK`, plus
    one row per (stripe, 128-dst block) for ragged tails."""
    num_blocks = max(1, n_padded // 128)
    return (int(math.ceil(num_edges * SLOT_ROW_SLACK / 128))
            + max(1, n_stripes) * num_blocks)


def _build_stage_reports(n: int, num_edges: int, generated: bool,
                         stripe: int) -> List[FitStage]:
    """The device build's stages at the target geometry, each its
    per-edge bytes (:data:`STAGE_BYTES_PER_EDGE`) times the raw edges
    plus the per-vertex tensors alive beside it; the scatter adds the
    slot plane at the estimated row count."""
    n_padded = -(-n // 128) * 128
    sz = min(stripe, n_padded) if stripe else n_padded
    n_stripes = -(-n_padded // sz) if n_padded else 1
    e = int(num_edges)
    per = STAGE_BYTES_PER_EDGE
    stages: List[FitStage] = []
    if n_stripes > 1 and n_stripes * n_padded > (1 << 31) - 1:
        stages.append(FitStage(
            stage="build/sort", bytes=None, source="error",
            detail=f"striped sort key overflows int32 ({n_stripes} "
                   f"stripes x n_padded {n_padded}): the device build "
                   f"refuses this geometry"))
        return stages
    if e > (1 << 31) - 1:
        stages.append(FitStage(
            stage="build/slots", bytes=None, source="error",
            detail=f"{e:,} raw edges overflow the int32 row ranks of "
                   f"the slot stage: the device build cannot run it"))
        return stages

    def add(name, nbytes, detail):
        stages.append(FitStage(stage=f"build/{name}", bytes=int(nbytes),
                               source="model", detail=detail))

    if generated:
        add("gen", per["gen"] * e + 4 * n,
            f"R-MAT generation, {e:,} raw edges x {per['gen']} B")
    else:
        add("upload", per["upload"] * e,
            f"raw int32 edges, {e:,} x {per['upload']} B")
    add("relabel", per["relabel"] * e + RELABEL_BYTES_PER_VERTEX * n,
        f"raw edges + in-degree sort ({RELABEL_BYTES_PER_VERTEX} B a vertex)")
    add("sort", per["sort"] * e + BUILD_BYTES_PER_VERTEX * n,
        f"the int64-key sort, {per['sort']} B an edge")
    slots = per["slots_striped" if n_stripes > 1 else "slots"]
    add("slots", slots * e + BUILD_BYTES_PER_VERTEX * n,
        f"slot coordinates + dedup flags, {slots} B an edge")
    rows = estimate_slot_rows(e, n_padded, n_stripes)
    add("scatter", per["scatter"] * e + BUILD_BYTES_PER_VERTEX * n
        + rows * 128 * 4,
        f"slot-plane scatter at ~{rows:,} estimated rows (slack "
        f"{SLOT_ROW_SLACK})")
    return stages


def _solve_stage_report(n: int, num_edges: int, dtype: str,
                        accum_dtype: str, stripe: int,
                        stream_dtype: str, ndev: int = 1,
                        vertex_sharded: bool = False) -> FitStage:
    """Analytic residency of the placed engine and its step, on one
    rank of ``ndev``: its share of the slot plane (int32, or the 3-byte
    words of the partitioned form) and of the row ids (rows padded to
    a multiple of ndev x 256 and split evenly), the per-vertex planes
    (three bool masks and 1/out-degree in z's dtype), the z buffer
    (flat: n_padded + 8 of z's dtype; partitioned: K windows of span +
    128), the rank vector, the graph's own per-vertex tensors (perm,
    masks, out-degree: 10 B a vertex) and the step's temporaries (the
    contribution, the update's casts and the new rank vector: 6 vectors
    of the accumulation dtype). Vertex-sharded, the planes, the rank
    vector and the update's temporaries are the rank's block of n_vs /
    ndev vertices; z is gathered whole (n_vs + 8) beside the local z,
    and the merge buffer holds n_vs sums."""
    item = {"float32": 4, "float64": 8}
    dt, acc = item[dtype], item[accum_dtype]
    z_item = max(dt, acc)
    ndev = max(1, int(ndev))
    n_padded = -(-n // 128) * 128

    def share(rows):  # the rank's rows (jax_engine.py:1146-1161)
        if ndev == 1:
            return rows
        return -(-rows // (ndev * 256)) * 256
    if stripe:
        sz = min(stripe, n_padded)
        parts = -(-n_padded // sz)
        rows = share(estimate_slot_rows(num_edges, n_padded, parts))
        words = rows * (128 * 3 if sz < (1 << 24) else 128 * 4)
        z = parts * (sz + 128) * (2 if stream_dtype else z_item)
    else:
        rows = share(estimate_slot_rows(num_edges, n_padded, 1))
        words = rows * 128 * 4
        z = (n_padded + 8) * z_item
    tables = words + rows * 4
    local = n_padded
    if vertex_sharded:
        n_vs = -(-n_padded // (128 * ndev)) * 128 * ndev
        local = n_vs // ndev
        z = (n_vs + 8) * z_item + local * z_item + n_vs * z_item
    planes = local * (3 + z_item)
    state = local * dt + 10 * n
    temps = 6 * local * acc
    total = tables + planes + z + state + temps
    return FitStage(
        stage="solve/step", bytes=int(total), source="model",
        detail=(f"tables {_gib(tables)} + planes {_gib(planes)} + z "
                f"{_gib(z)} + state {_gib(state)} + step temporaries "
                f"{_gib(temps)}"))


def fit_check(scale: Optional[int] = None, *, n: Optional[int] = None,
              num_edges: Optional[int] = None, edge_factor: int = 16,
              dtype: str = "float32", accum_dtype: Optional[str] = None,
              device_build: bool = True, generated: Optional[bool] = None,
              partition_span: int = 0, stream_dtype: str = "",
              ndev: int = 1, vertex_sharded: bool = False,
              limit_bytes: Optional[int] = None,
              device_kind: Optional[str] = None,
              headroom: float = DEFAULT_FIT_HEADROOM) -> FitResult:
    """The OOM preflight: will (build +) solve at this geometry fit in
    the card's memory? Pass ``scale`` for the R-MAT geometry (``2^scale``
    vertices, ``edge_factor << scale`` raw edges, generated on the card)
    or explicit ``n``/``num_edges`` (a loaded graph's). ``device_build``
    False models the solve alone (a host-built graph); ``generated``
    (default: whether ``scale`` was given) picks the generator stage
    over the upload. ``partition_span`` is the resolved span (0 = flat).
    ``ndev`` and ``vertex_sharded`` size each rank's share of the solve
    (``pagerank_tpu/cli.py:1160-1175``); the build stages are one
    device's.

    Nothing allocates: every stage is an analytic model, and the limit
    comes from live ``mem_get_info`` or the Hopper table
    (:func:`resolve_hbm_limit`). The verdict is per stage."""
    if scale is None and n is None:
        raise ValueError("fit_check needs scale= or n=")
    if n is None:
        n = 1 << scale
    if num_edges is None:
        num_edges = (edge_factor << scale if scale is not None
                     else edge_factor * n)
    accum_dtype = accum_dtype or dtype
    if generated is None:
        generated = scale is not None
    limit, limit_source = resolve_hbm_limit(limit_bytes, device_kind)
    t0 = time.perf_counter()
    stages: List[FitStage] = []
    if device_build:
        stages += _build_stage_reports(n, num_edges, generated,
                                       partition_span)
    stages.append(_solve_stage_report(n, num_edges, dtype, accum_dtype,
                                      partition_span, stream_dtype, ndev,
                                      vertex_sharded))
    effective = limit * headroom
    fits = bool(stages) and not any(
        s.source == "error" for s in stages
    ) and all(
        s.bytes <= effective for s in stages if s.bytes is not None
    )
    res = FitResult(
        fits=fits, limit_bytes=limit, limit_source=limit_source,
        headroom=headroom, n=n, num_edges=num_edges, ndev=int(ndev),
        dtype=dtype, accum_dtype=accum_dtype,
        vertex_sharded=bool(vertex_sharded),
        stages=stages, scale=scale,
    )
    obs_log.info(
        f"fit check: {len(stages)} stage(s) in "
        f"{time.perf_counter() - t0:.4f}s -> "
        f"{'fits' if fits else 'DOES NOT FIT'}"
    )
    return res


def render_fit(res: FitResult) -> str:
    """The per-stage preflight table (what the CLI shows before refusing
    a doomed build)."""
    head = (f"OOM preflight: "
            + (f"scale {res.scale} " if res.scale is not None else "")
            + f"({res.n:,} vertices, ~{res.num_edges:,} raw edges), "
            f"{res.ndev} device(s), {res.dtype}/{res.accum_dtype}"
            + (", vertex-sharded" if res.vertex_sharded else ""))
    lines = [head,
             f"per-chip limit {_gib(res.limit_bytes)} "
             f"[{res.limit_source}] x headroom {res.headroom:g} = "
             f"{_gib(res.effective_limit)}"]
    w = max((len(s.stage) for s in res.stages), default=5)
    effective = res.effective_limit
    for s in res.stages:
        if s.bytes is None:
            verdict = "ERROR" if s.source == "error" else "?"
        else:
            verdict = "ok" if s.bytes <= effective else "OVER"
        lines.append(
            f"  {s.stage:<{w}}  {_gib(s.bytes):>12}  {s.source:<5}  "
            f"{verdict:<5}"
            + (f"  {s.detail}" if s.detail else "")
        )
    peak = res.peak_stage
    lines.append(
        ("FITS" if res.fits else "DOES NOT FIT")
        + (f": peak stage {peak.stage} at {_gib(peak.bytes)} vs "
           f"{_gib(effective)}" if peak else ": no stage evaluated")
    )
    return "\n".join(lines)
