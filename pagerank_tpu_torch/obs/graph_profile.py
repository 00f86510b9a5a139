"""Data-plane observability: the graph itself as telemetry, and the
rank-mass ledger.

Port of ``pagerank_tpu/obs/graph_profile.py``: ``GraphProfile``,
``profile_graph``, ``block_geometry``, ``log2_hist``,
``layout_profile_geometry``, the arming and publishing, and the ledger
(``ledger_tolerance``, ``mass_ledger_entry``, ``record_ledger``) are
copies (numpy and the metrics registry). ``device_stats`` and
``finish_device_profile`` (:455-588) are torch ops over the device
build's sorted key (``ops/device_build.build_ell_device`` calls them
between its sort and slot stages, only when :func:`armed`): the
``segment_sum``s are ``index_add_``, ``searchsorted`` over the
power-of-two bounds is ``torch.searchsorted(right=True)``, and
``lax.top_k``'s lowest-index tie rule is ``ops/spmv.topk_lowest_index`` —
``torch.topk``'s order among equal values is unspecified on CUDA, and
hub degrees tie constantly. The integer stats equal the JAX device
build's on the same host edges, bit for bit.

  - :class:`GraphProfile` — log2-binned in/out-degree histograms,
    dangling/zero-in counts, self-loop and duplicate-edge counts, top-K
    hub ids by in-degree, per-partition/stripe unique-edge counts and
    their max/mean skew, per-(stripe, dst-block) edge/row counts, and a
    power-law tail estimate. On the device build the stats are one pass
    of reductions over the already-sorted key and one transfer at the
    end of the build; host graphs profile in numpy
    (:func:`profile_graph`).
  - the **rank-mass ledger** (:func:`mass_ledger_entry`) — an exact
    per-iteration decomposition of the rank update's mass flow that
    must reconcile with the measured ``sum(ranks)`` within dtype
    tolerance, with a NAMED leak location. The engines compute the raw
    sums inside the probed step and the SDC-checked step.

Arming discipline: the profiler is DISARMED by default and every
computation site guards on :func:`armed` — a disarmed build makes ZERO
profile computations (tests/test_torch_graph_profile.py pins it). Armed
by CLI ``--graph-profile``. The ledger half rides the probe arming
(``--probe-every``) and the SDC guard instead.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from pagerank_tpu_torch.obs import metrics as obs_metrics

#: log2 histogram shape: bin 0 counts degree-0 vertices, bin k >= 1
#: counts degrees in [2^(k-1), 2^k). 32 bins cover every int32 degree.
HIST_BINS = 32

#: Degree thresholds shared by the device and host histogram paths:
#: searchsorted(bounds, d, side="right") == bit_length(d) exactly (an
#: integer comparison ladder — float log2 misbins near 2^24+ where
#: f32 cannot represent the degree).
_HIST_BOUNDS = np.asarray([1 << k for k in range(HIST_BINS - 1)],
                          dtype=np.int64)

#: Default hub count captured by a profile.
DEFAULT_TOPK = 16

#: Mass-ledger tolerance factor: a term leaks when its relative
#: residual exceeds ``tol_factor * eps(accum) * max(1, sqrt(n))`` —
#: the sqrt(n) absorbs the reduction-order error of an n-term sum
#: while staying orders of magnitude below any real mass bug (a wrong
#: weight or mask moves whole rank fractions, not ulps).
LEDGER_TOL_FACTOR = 64.0


# -- arming (the tracer/sampler discipline) ---------------------------------

_ARMED = False
_PROFILE: Optional["GraphProfile"] = None


def armed() -> bool:
    """Whether graph profiling is armed. Every computation site guards
    on this — the disarmed path makes ZERO profile calls."""
    return _ARMED


def arm() -> None:
    global _ARMED
    _ARMED = True


def disarm() -> None:
    global _ARMED
    _ARMED = False


def reset() -> None:
    """Drop the published profile (per-run scoping, like the cost and
    hlo ledgers)."""
    global _PROFILE
    _PROFILE = None


def publish(profile: "GraphProfile") -> None:
    """Stash the latest profile and mirror its headline scalars into
    ``graph.*`` gauges (next to the measured ``comms.*`` /
    ``elastic.*`` values the predictions are diffed against)."""
    global _PROFILE
    _PROFILE = profile
    obs_metrics.gauge(
        "graph.dangling_fraction",
        "dangling vertices / n of the profiled graph",
    ).set(profile.dangling_fraction)
    skew = profile.partition_skew()
    if skew is not None:
        obs_metrics.gauge(
            "graph.partition_skew",
            "max/mean unique edges over source partitions/stripes",
        ).set(skew)
    if profile.self_loops is not None:
        obs_metrics.gauge(
            "graph.self_loops", "unique self-loop edges"
        ).set(profile.self_loops)
    if profile.duplicate_edges is not None:
        obs_metrics.gauge(
            "graph.duplicate_edges",
            "raw minus unique edges collapsed by the build's dedup",
        ).set(profile.duplicate_edges)
    alpha = profile.powerlaw_alpha()
    if alpha is not None:
        obs_metrics.gauge(
            "graph.powerlaw_alpha",
            "power-law tail exponent estimated from the log2 "
            "in-degree histogram",
        ).set(alpha)


def get_profile() -> Optional["GraphProfile"]:
    """The latest published profile (None when disarmed/not built)."""
    return _PROFILE


def report_section() -> Dict[str, object]:
    """The run report's ``graph`` data-plane block: profile summary +
    any published prediction — None-tolerant (a disarmed run embeds
    nothing)."""
    out: Dict[str, object] = {}
    if _PROFILE is not None:
        out["profile"] = _PROFILE.summary()
        if _PROFILE.prediction is not None:
            out["prediction"] = dict(_PROFILE.prediction)
    return out


# -- the profile ------------------------------------------------------------


@dataclass
class GraphProfile:
    """Structural profile of one graph at one packed layout.

    ``block_edges`` / ``block_rows`` are per-(stripe, 128-dst-block)
    UNIQUE-edge and slot-row counts in packed row order — small
    (n_padded/128 * n_stripes entries) but excluded from the JSON
    summary; they persist in the job artifact and feed the per-device
    load prediction (parallel/comms.predict_from_profile)."""

    n: int
    n_padded: int
    num_edges: int                       # unique
    raw_edges: Optional[int]             # pre-dedup (None when unknown)
    self_loops: Optional[int]
    dangling_count: int
    zero_in_count: int
    in_hist: List[int]                   # HIST_BINS log2 bins, unique degrees
    out_hist: List[int]
    top_hub_ids: List[int]               # ORIGINAL id space, in-degree desc
    top_hub_in_degrees: List[int]
    partition_edges: List[int]           # unique edges per source stripe
    stripe_span: int                     # 0 = single stripe
    group: int = 1
    block_edges: Optional[np.ndarray] = field(default=None, repr=False)
    block_rows: Optional[np.ndarray] = field(default=None, repr=False)
    fingerprint: Optional[str] = None
    source: str = "host"                 # host | device_build
    #: attached by parallel/comms.predict_from_profile consumers so
    #: the run report carries predicted-vs-measured in one block.
    prediction: Optional[Dict[str, object]] = None

    @property
    def duplicate_edges(self) -> Optional[int]:
        if self.raw_edges is None:
            return None
        return int(self.raw_edges) - int(self.num_edges)

    @property
    def dangling_fraction(self) -> float:
        return self.dangling_count / self.n if self.n else 0.0

    @property
    def initial_dangling_mass(self) -> float:
        """Dangling mass of the uniform textbook r0 (= the dangling
        fraction; reference semantics starts at rank 1.0 per vertex,
        so ITS initial dangling mass is ``dangling_count``)."""
        return self.dangling_fraction

    def partition_skew(self) -> Optional[float]:
        """max/mean unique edges over source partitions/stripes — the
        straggler-imbalance axis a partitioned/striped layout inherits
        from the data. None when the graph is edge-free."""
        pe = [int(v) for v in self.partition_edges]
        if not pe or sum(pe) == 0:
            return None
        return max(pe) / (sum(pe) / len(pe))

    def powerlaw_alpha(self) -> Optional[float]:
        """Tail exponent alpha of p(d) ~ d^-alpha from the log2
        in-degree histogram: bin k's count ~ C * 2^(k(1-alpha)), so
        the least-squares slope b of log2(count) over k >= 2 gives
        alpha = 1 - b. None with fewer than 3 populated tail bins
        (no tail to estimate)."""
        pts = [(k, math.log2(c)) for k, c in enumerate(self.in_hist)
               if k >= 2 and c > 0]
        if len(pts) < 3:
            return None
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        mx = sum(xs) / len(xs)
        my = sum(ys) / len(ys)
        denom = sum((x - mx) ** 2 for x in xs)
        if denom == 0:
            return None
        slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom
        return 1.0 - slope

    def summary(self) -> Dict[str, object]:
        """JSON-safe headline view (run reports, bench legs, the CLI).
        The per-block arrays stay out — their size is geometry-bound,
        not content-bound, and the artifact carries them."""
        return {
            "source": self.source,
            "fingerprint": self.fingerprint,
            "n": int(self.n),
            "num_edges": int(self.num_edges),
            "raw_edges": (int(self.raw_edges)
                          if self.raw_edges is not None else None),
            "duplicate_edges": self.duplicate_edges,
            "self_loops": (int(self.self_loops)
                           if self.self_loops is not None else None),
            "dangling_count": int(self.dangling_count),
            "dangling_fraction": float(self.dangling_fraction),
            "initial_dangling_mass": float(self.initial_dangling_mass),
            "zero_in_count": int(self.zero_in_count),
            "in_hist": [int(v) for v in self.in_hist],
            "out_hist": [int(v) for v in self.out_hist],
            "top_hub_ids": [int(v) for v in self.top_hub_ids],
            "top_hub_in_degrees": [int(v) for v in
                                   self.top_hub_in_degrees],
            "partition_edges": [int(v) for v in self.partition_edges],
            "partition_skew": self.partition_skew(),
            "stripe_span": int(self.stripe_span),
            "group": int(self.group),
            "powerlaw_alpha": self.powerlaw_alpha(),
        }

    # -- job artifact (the jobs.py stage-machine format) ----------------------

    def to_arrays(self):
        """(arrays, meta) in the checksummed jobs.save_artifact format,
        keyed by graph fingerprint — the resume path validates the key
        before trusting the profile (tamper/corruption rejected by the
        artifact sha256)."""
        arrays = {
            "in_hist": np.asarray(self.in_hist, np.int64),
            "out_hist": np.asarray(self.out_hist, np.int64),
            "top_hub_ids": np.asarray(self.top_hub_ids, np.int64),
            "top_hub_in_degrees": np.asarray(self.top_hub_in_degrees,
                                             np.int64),
            "partition_edges": np.asarray(self.partition_edges,
                                          np.int64),
        }
        if self.block_edges is not None:
            arrays["block_edges"] = np.asarray(self.block_edges,
                                               np.int64)
        if self.block_rows is not None:
            arrays["block_rows"] = np.asarray(self.block_rows, np.int64)
        meta = {
            "kind": "graph_profile",
            "fingerprint": self.fingerprint,
            "source": self.source,
            "n": int(self.n),
            "n_padded": int(self.n_padded),
            "num_edges": int(self.num_edges),
            "raw_edges": (int(self.raw_edges)
                          if self.raw_edges is not None else None),
            "self_loops": (int(self.self_loops)
                           if self.self_loops is not None else None),
            "dangling_count": int(self.dangling_count),
            "zero_in_count": int(self.zero_in_count),
            "stripe_span": int(self.stripe_span),
            "group": int(self.group),
        }
        return arrays, meta

    @classmethod
    def from_arrays(cls, arrays, meta) -> "GraphProfile":
        if meta.get("kind") != "graph_profile":
            raise ValueError(
                f"not a graph-profile artifact: kind={meta.get('kind')!r}"
            )
        return cls(
            n=int(meta["n"]), n_padded=int(meta["n_padded"]),
            num_edges=int(meta["num_edges"]),
            raw_edges=meta.get("raw_edges"),
            self_loops=meta.get("self_loops"),
            dangling_count=int(meta["dangling_count"]),
            zero_in_count=int(meta["zero_in_count"]),
            in_hist=[int(v) for v in arrays["in_hist"]],
            out_hist=[int(v) for v in arrays["out_hist"]],
            top_hub_ids=[int(v) for v in arrays["top_hub_ids"]],
            top_hub_in_degrees=[int(v) for v in
                                arrays["top_hub_in_degrees"]],
            partition_edges=[int(v) for v in arrays["partition_edges"]],
            stripe_span=int(meta["stripe_span"]),
            group=int(meta.get("group", 1)),
            block_edges=arrays.get("block_edges"),
            block_rows=arrays.get("block_rows"),
            fingerprint=meta.get("fingerprint"),
            source=str(meta.get("source", "host")),
        )


def layout_profile_geometry(layout) -> tuple:
    """(group, span) a host profile should use for an engine's
    RESOLVED layout (``engine.layout_info()``) — THE one derivation,
    shared by the CLI, bench, and ``obs graph`` so the three surfaces
    cannot disagree: the partition span when the partitioned form
    engaged, else the stripe span when the layout is actually striped
    (per-stripe edge counts ARE the partition telemetry there), else
    a single partition."""
    layout = layout or {}
    span = int(layout.get("partition_span") or 0)
    if not span and (layout.get("n_stripes") or 1) > 1:
        span = int(layout.get("stripe_span") or 0)
    return int(layout.get("group") or 1), span


def log2_hist(deg: np.ndarray) -> np.ndarray:
    """Host log2 degree histogram — EXACT integer binning shared with
    the device path (searchsorted over power-of-two bounds ==
    bit_length per element)."""
    deg = np.asarray(deg, np.int64)
    k = np.searchsorted(_HIST_BOUNDS, deg, side="right")
    return np.bincount(k, minlength=HIST_BINS).astype(np.int64)


def _relabel_order(in_degree: np.ndarray):
    """(perm, inv): the engine's stable in-degree-descending relabel
    (ops/device_build._relabel_perm semantics) in numpy."""
    n = in_degree.shape[0]
    perm = np.argsort(-np.asarray(in_degree, np.int64), kind="stable")
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    return perm, inv


def block_geometry(new_src: np.ndarray, new_dst: np.ndarray, *,
                   n_padded: int, stripe_span: int, group: int = 1):
    """Per-(stripe, 128-dst-block) unique-edge and slot-row counts
    from RELABELED deduplicated edges — the host twin of what the
    device build reads off its own sort (exact for deduplicated
    input; device builds count duplicate-occupied slots too, which
    the device path captures from the real ``sb_rows``)."""
    sz = stripe_span or n_padded
    n_stripes = -(-n_padded // sz) if n_padded else 1
    num_blocks = n_padded // 128
    stripe = new_src // sz if n_stripes > 1 else np.zeros_like(new_src)
    sb = stripe * num_blocks + new_dst // 128
    block_edges = np.bincount(sb, minlength=n_stripes * num_blocks)
    # Rows per (stripe, block) = max over its lane groups of
    # ceil(group_run / group) — the packer's exact row rule
    # (ops/device_build._slot_coords).
    log2g = group.bit_length() - 1
    grp = (stripe * n_padded + new_dst) >> log2g
    cnt = np.bincount(grp, minlength=(n_stripes * n_padded) >> log2g)
    rows_grp = -(-cnt // group)
    grp_ids = np.arange(cnt.shape[0], dtype=np.int64)
    sb_of_grp = ((grp_ids << log2g) // n_padded) * num_blocks + (
        (grp_ids << log2g) % n_padded
    ) // 128
    block_rows = np.zeros(n_stripes * num_blocks, np.int64)
    np.maximum.at(block_rows, sb_of_grp, rows_grp)
    return block_edges.astype(np.int64), block_rows


def profile_graph(graph, *, partition_span: int = 0, group: int = 1,
                  topk: int = DEFAULT_TOPK,
                  raw_edges: Optional[int] = None) -> GraphProfile:
    """Profile a HOST :class:`pagerank_tpu_torch.graph.Graph` (already
    deduplicated) in numpy. ``partition_span`` records the per-source-
    partition edge counts at that span (0 = one partition spanning the
    padded range — the replicated single-stripe layout)."""
    n = int(graph.n)
    n_padded = -(-n // 128) * 128
    in_deg = np.asarray(graph.in_degree, np.int64)
    out_deg = np.asarray(graph.out_degree, np.int64)
    src = np.asarray(graph.src, np.int64)
    dst = np.asarray(graph.dst, np.int64)
    sz = min(partition_span, n_padded) if partition_span else n_padded
    n_stripes = -(-n_padded // sz) if n_padded else 1

    perm, inv = _relabel_order(in_deg)
    new_src, new_dst = inv[src], inv[dst]
    part_edges = np.bincount(new_src // sz, minlength=n_stripes)
    block_edges, block_rows = block_geometry(
        new_src, new_dst, n_padded=n_padded, stripe_span=sz if
        n_stripes > 1 else 0, group=group)

    k = max(1, min(int(topk), n))
    in_rel = in_deg[perm]
    # top-k by UNIQUE in-degree with ties broken by lowest relabeled
    # id — matching lax.top_k over the relabeled degree vector.
    top_rel = np.lexsort((np.arange(n), -in_rel))[:k]
    dangling = int((np.asarray(graph.dangling_mask, bool)).sum())
    return GraphProfile(
        n=n, n_padded=n_padded, num_edges=int(graph.num_edges),
        raw_edges=raw_edges,
        self_loops=int((src == dst).sum()),
        dangling_count=dangling,
        zero_in_count=int((in_deg == 0).sum()),
        in_hist=[int(v) for v in log2_hist(in_deg)],
        out_hist=[int(v) for v in log2_hist(out_deg)],
        top_hub_ids=[int(perm[i]) for i in top_rel],
        top_hub_in_degrees=[int(in_rel[i]) for i in top_rel],
        partition_edges=[int(v) for v in part_edges],
        stripe_span=int(sz if n_stripes > 1 else 0),
        group=int(group),
        block_edges=block_edges, block_rows=block_rows,
        fingerprint=graph.fingerprint(),
        source="host",
    )


# -- device-build stats (ops/device_build hooks) ------------------------------


def device_stats(sb_dst, new_src, perm, *, n: int, n_padded: int,
                 stripe_size: int, num_blocks: int,
                 topk: int = DEFAULT_TOPK):
    """One pass of reductions over the composite-key-sorted edges
    (called by ops/device_build.build_ell_device between its sort and
    slot stages, ONLY when :func:`armed`): dedup flags from key
    adjacency exactly as in ``_slot_coords``, and every profile stat
    reduced from them — no per-edge host transfer. Reads only, so
    arming cannot perturb the build. Returns a dict of device tensors;
    the caller fetches them in one transfer at the end of the build
    (:func:`finish_device_profile`)."""
    import torch

    from pagerank_tpu_torch.ops.spmv import topk_lowest_index

    i32 = torch.int32
    dev = sb_dst.device
    k = max(1, min(int(topk), n))
    sz = stripe_size or n_padded
    n_stripes = -(-n_padded // sz) if n_padded else 1
    if n_stripes > 1:
        stripe_of = sb_dst // n_padded
        new_dst = sb_dst - stripe_of * n_padded
    else:
        new_dst, stripe_of = sb_dst, None
    uniq = torch.ones(sb_dst.shape[0], dtype=torch.bool, device=dev)
    uniq[1:] = (sb_dst[1:] != sb_dst[:-1]) | (new_src[1:] != new_src[:-1])
    u32 = uniq.to(i32)
    num_edges = u32.sum(dtype=torch.int64)
    raw_edges = torch.tensor(sb_dst.shape[0], dtype=torch.int64, device=dev)
    self_loops = (uniq & (new_dst == new_src)).sum(dtype=torch.int64)
    # Unique degrees in RELABELED space.
    in_deg = torch.zeros(n, dtype=i32, device=dev).index_add_(0, new_dst, u32)
    out_deg = torch.zeros(n, dtype=i32, device=dev).index_add_(0, new_src,
                                                               u32)
    bounds = torch.as_tensor(_HIST_BOUNDS, dtype=i32, device=dev)
    in_hist = torch.bincount(torch.searchsorted(bounds, in_deg, right=True),
                             minlength=HIST_BINS)
    out_hist = torch.bincount(torch.searchsorted(bounds, out_deg,
                                                 right=True),
                              minlength=HIST_BINS)
    dangling = (out_deg == 0).sum(dtype=torch.int64)
    zero_in = (in_deg == 0).sum(dtype=torch.int64)
    top_deg, top_rel = topk_lowest_index(in_deg, k)
    top_orig = perm[top_rel]
    if n_stripes > 1:
        part_edges = torch.zeros(n_stripes, dtype=i32, device=dev
                                 ).index_add_(0, stripe_of, u32)
        sb = stripe_of * num_blocks + new_dst // 128
    else:
        part_edges = num_edges.reshape(1)
        sb = new_dst // 128
    block_edges = torch.zeros(n_stripes * num_blocks, dtype=i32,
                              device=dev).index_add_(0, sb, u32)
    return {"num_edges": num_edges, "raw_edges": raw_edges,
            "self_loops": self_loops, "dangling_count": dangling,
            "zero_in_count": zero_in, "in_hist": in_hist,
            "out_hist": out_hist, "top_hub_in_degrees": top_deg,
            "top_hub_ids": top_orig, "partition_edges": part_edges,
            "block_edges": block_edges}


def finish_device_profile(stats: Dict[str, object], *, stripe_size: int,
                          group: int, n: int, n_padded: int,
                          block_rows=None, dangling_count_override=None,
                          fingerprint: Optional[str] = None
                          ) -> GraphProfile:
    """Assemble the :class:`GraphProfile` from the device-stat tensors
    in ONE transfer (the build's only profile-side host sync): every
    tensor flattened to int64 and concatenated, split on the host.
    ``dangling_count_override`` carries the crawl inputs' explicit
    dangling-mask count; ``block_rows`` is the build's own exact
    per-(stripe, block) row vector (``sb_rows``)."""
    import torch

    fetch = dict(stats)
    if block_rows is not None:
        fetch["block_rows"] = block_rows
    if dangling_count_override is not None:
        fetch["dangling_count"] = dangling_count_override
    names = list(fetch)
    flat = [fetch[k].reshape(-1).to(torch.int64) for k in names]
    cuts = np.cumsum([t.shape[0] for t in flat])[:-1]
    host = dict(zip(names, np.split(torch.cat(flat).cpu().numpy(), cuts)))
    return GraphProfile(
        n=int(n), n_padded=int(n_padded),
        num_edges=int(host["num_edges"][0]),
        raw_edges=int(host["raw_edges"][0]),
        self_loops=int(host["self_loops"][0]),
        dangling_count=int(host["dangling_count"].sum()),
        zero_in_count=int(host["zero_in_count"][0]),
        in_hist=[int(v) for v in host["in_hist"]],
        out_hist=[int(v) for v in host["out_hist"]],
        top_hub_ids=[int(v) for v in host["top_hub_ids"]],
        top_hub_in_degrees=[int(v) for v in host["top_hub_in_degrees"]],
        partition_edges=[int(v) for v in host["partition_edges"]],
        stripe_span=int(stripe_size),
        group=int(group),
        block_edges=np.asarray(host["block_edges"], np.int64),
        block_rows=(np.asarray(host["block_rows"], np.int64)
                    if "block_rows" in host else None),
        fingerprint=fingerprint,
        source="device_build",
    )


# -- the rank-mass ledger ----------------------------------------------------


def ledger_tolerance(eps: float, n: int,
                     tol_factor: float = LEDGER_TOL_FACTOR) -> float:
    """Relative reconciliation tolerance for an n-vertex mass sum in a
    dtype with machine epsilon ``eps`` (see LEDGER_TOL_FACTOR)."""
    return tol_factor * float(eps) * max(1.0, math.sqrt(max(1, n)))


def mass_ledger_entry(*, damping: float, semantics: str, n: int,
                      eps: float, mass_prev: float, mass: float,
                      dangling_mass: float, contrib_total: float,
                      retained_total: float = 0.0,
                      tol_factor: float = LEDGER_TOL_FACTOR,
                      flow_slack: float = 0.0
                      ) -> Dict[str, object]:
    """One probe iteration's exact mass decomposition + reconciliation.

    The update (models/pagerank.apply_update) sums to

      textbook:  mass' = (1-d)      + d*contrib_total + d*m
      reference: mass' = (1-d)*n    + d*contrib_total
                         + d*retained_total + d*m

    where every right-hand term except the teleport is MEASURED inside
    the step (``step_probed`` ledger sums). Two reconciliations, each
    with a named leak:

      - **identity residual**: measured ``mass`` minus the term sum.
        The teleport term is the only one derived from the formula
        rather than measured, so a violation is attributed to
        ``teleport`` (the epilogue/mask path — e.g. a wrong valid
        mask zeroing live lanes).
      - **flow conservation** (textbook only, where the dangling mask
        IS out_degree == 0): every unit of ``mass_prev`` must leave
        through links or the dangling pool —
        ``unaccounted = mass_prev - m - contrib_total``. Positive
        unaccounted means mass silently fell out of the flow (a
        ``dangling``-mask leak: a sink vertex the mask misses);
        negative means the edges CREATED mass (a ``link`` leak: bad
        weights / duplicated slots). Reference semantics deliberately
        does not conserve mass (the zero-in retention re-feeds old
        rank, module docstring of models/pagerank), so only the
        identity check applies there.

    All residuals are reported relative to the mode's expected total
    (1 textbook, n reference). ``leak`` is the worst offender's name,
    None when the ledger reconciles within :func:`ledger_tolerance`.

    ``flow_slack`` (mass units) widens ONLY the flow-
    conservation check: under the stale-boundary step
    (config.halo_async) the measured contribution total mixes this
    iteration's own-block mass with LAST iteration's boundary mass,
    so flow conservation holds up to the previous step's L1 delta —
    the caller passes that bound and the check stays sharp as the
    solve converges (slack -> 0 with delta). The identity residual
    needs no slack: the update consumed the same measured contrib the
    ledger reports, stale or not.
    """
    reference = semantics == "reference"
    scale = float(n) if reference else 1.0
    teleport = (1.0 - damping) * scale
    link = damping * contrib_total
    retained = damping * retained_total if reference else 0.0
    dangling_term = damping * dangling_mass
    total = teleport + link + retained + dangling_term
    tol = ledger_tolerance(eps, n, tol_factor)
    residual = (mass - total) / scale
    violations = {}
    if abs(residual) > tol:
        violations["teleport"] = abs(residual)
    unaccounted = None
    if not reference:
        unaccounted = (mass_prev - dangling_mass - contrib_total) / scale
        flow_tol = tol + abs(flow_slack) / scale
        if unaccounted > flow_tol:
            violations["dangling"] = abs(unaccounted)
        elif unaccounted < -flow_tol:
            violations["link"] = abs(unaccounted)
    leak = (max(violations, key=violations.get) if violations else None)
    return {
        "mass_prev": float(mass_prev),
        "mass": float(mass),
        "normalized_mass": float(mass / scale),
        "teleport_mass": float(teleport / scale),
        "link_mass": float(link / scale),
        "retained_mass": float(retained / scale),
        "dangling_mass": float(dangling_term / scale),
        "residual": float(residual),
        "unaccounted": (float(unaccounted)
                        if unaccounted is not None else None),
        "tol": float(tol),
        "leak": leak,
        "ok": leak is None,
    }


def record_ledger(entry: Dict[str, object]) -> None:
    """Publish one ledger entry through the metrics registry: the
    decomposition gauges plus the violation counter the exporter and
    run report surface."""
    for key, name in (("link_mass", "ledger.link_mass"),
                      ("teleport_mass", "ledger.teleport_mass"),
                      ("dangling_mass", "ledger.dangling_mass"),
                      ("residual", "ledger.residual")):
        obs_metrics.gauge(
            name, f"rank-mass ledger: {key} (normalized)"
        ).set(entry[key])
    if not entry.get("ok", True):
        obs_metrics.counter(
            "ledger.violations",
            "probe iterations whose mass ledger failed to reconcile",
        ).inc()
