"""Per-iteration communication accounting for the sharded solve.

Port of ``pagerank_tpu/parallel/comms.py``: the dense byte model
(``dense_exchange_bytes``, ``model_dense``, :40-68), the sparse and
asynchronous halo models (``model_sparse``, ``model_async``, :69-99),
the async gate's overlap gain (``predict_overlap_gain``,
``publish_overlap_gain``, :102-134), their publication (``register``,
:137), the skew-driven load and halo head-K prediction from a graph
profile (``predict_device_load``, :181-217; ``_expected_remote_readers``
and ``predict_halo_head_k``, :224-293; ``predict_from_profile`` and
``publish_prediction``, :296-335) and the measured load
(``measured_device_edges``, :336).

A static byte model per exchange mode, derived once at build from the
engine's resolved layout, plus the live instruments every solve
publishes through the metrics registry:

  - ``comms.bytes_exchanged``   counter, modeled wire bytes sent by
                                 this rank, accumulated per iteration;
  - ``comms.bytes_per_iter``    gauge, the per-iteration rate;
  - ``comms.dense_bytes_per_iter`` gauge, what the DENSE exchange
                                 (all_gather + full-width merge) would
                                 move — the standing comparator;
  - ``comms.halo_fraction``     gauge, tail boundary entries over the
                                 dense all_gather's remote entries
                                 (sparse mode only);
  - ``comms.head_k``            gauge, replicated head size (sparse).

Byte convention: bytes SENT per rank per iteration under the standard
ring lowering — all_gather/reduce_scatter of an n-element vector cost
``(ndev-1) * n/ndev`` sends per rank, an all-reduce twice that, a
ppermute exactly its payload.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from pagerank_tpu_torch.obs import metrics as obs_metrics


def dense_exchange_bytes(ndev: int, blk: int, z_item: int,
                         accum_item: int, rs_merge: bool = True) -> int:
    """Modeled bytes sent per rank per iteration by the dense
    vertex-sharded exchange: one tiled all_gather of the z shard plus
    the full-width contribution merge (reduce-scatter; ``rs_merge``
    False models the psum + local-slice merge that ``jax_engine.py:
    2281-2291`` takes where a backend lacks the wide reduce-scatter.
    Both backends the port brings up have it, so its engine always
    reduce-scatters)."""
    if ndev <= 1:
        return 0
    merge = (ndev - 1) * blk * accum_item
    if not rs_merge:
        merge *= 2
    return int((ndev - 1) * blk * z_item + merge)


def model_dense(ndev: int, blk: int, z_item: int, accum_item: int,
                rs_merge: bool = True) -> dict:
    """Comms model record for the dense vertex-sharded step."""
    dense = dense_exchange_bytes(ndev, blk, z_item, accum_item, rs_merge)
    return {
        "mode": "dense",
        "bytes_per_iter": dense,
        "dense_bytes_per_iter": dense,
        "sparse_bytes_per_iter": None,
        "halo_fraction": None,
        "head_k": None,
    }


def model_sparse(plan) -> dict:
    """Comms model record for a halo-exchange step, from its build-time
    :class:`pagerank_tpu_torch.parallel.partition.HaloPlan`."""
    return {
        "mode": "sparse",
        "bytes_per_iter": plan.sparse_bytes_per_iter(),
        "dense_bytes_per_iter": plan.dense_bytes_per_iter(),
        "sparse_bytes_per_iter": plan.sparse_bytes_per_iter(),
        "halo_fraction": plan.halo_fraction,
        "head_k": plan.head_k,
    }


def model_async(plan) -> dict:
    """Comms model record for the ASYNCHRONOUS stale-boundary step
    (config.halo_async). Same wire bytes as the synchronous
    sparse exchange — overlap reorders the collectives, it never adds
    or removes one — plus the
    overlap split the gate and the bench attribution read."""
    m = model_sparse(plan)
    m["mode"] = "sparse_async"
    m["overlappable_bytes_per_iter"] = plan.overlappable_bytes_per_iter()
    return m


#: Standing exchange-fraction assumption when no measurement exists
#: yet (a fresh build gates BEFORE its first attribution run): the JAX
#: package's value, kept so that both gates decide alike; a measured
#: ``comms.exchange_fraction`` (obs/devices.attribute_exchange) takes
#: its place once one exists.
DEFAULT_EXCHANGE_FRACTION = 0.3


def predict_overlap_gain(plan, exchange_fraction: Optional[float] = None
                         ) -> float:
    """Predicted fractional step-wall saving of the stale-boundary
    overlap: ``exchange_fraction x overlappable_share``,
    where overlappable_share is the head + read-round portion of the
    sparse exchange bytes (the write-band merge cannot be hidden —
    parallel/partition.HaloPlan.overlappable_bytes_per_iter). The
    exchange fraction comes from the caller (the engine passes the
    live ``comms.exchange_fraction`` gauge when a prior attribution
    measured one) or falls back to :data:`DEFAULT_EXCHANGE_FRACTION`.
    Zero on single-device meshes and boundary-free plans — the
    auto-gate's refusal signal."""
    sparse = plan.sparse_bytes_per_iter()
    if not sparse:
        return 0.0
    share = plan.overlappable_bytes_per_iter() / sparse
    ef = exchange_fraction
    if ef is None:
        gauges = obs_metrics.get_registry().snapshot()["gauges"]
        ef = gauges.get("comms.exchange_fraction")
    if ef is None:
        ef = DEFAULT_EXCHANGE_FRACTION
    return float(max(0.0, min(1.0, ef)) * share)


def publish_overlap_gain(gain: float) -> None:
    """Publish the predicted payoff next to the measured exchange
    fraction so `obs report` shows the gate's evidence."""
    obs_metrics.gauge(
        "comms.predicted_overlap_gain",
        "predicted fractional step-wall saving of the stale-boundary "
        "overlap (exchange fraction x overlappable byte share)",
    ).set(float(gain))


def register(model: dict) -> Optional[obs_metrics.Counter]:
    """Publish a comms model through the central registry (gauges) and
    return the ``comms.bytes_exchanged`` counter the solve loop feeds
    per iteration. None for an empty model (single device: nothing
    crosses the wire, and a zero-rate counter would just be noise)."""
    if not model or not model.get("bytes_per_iter"):
        return None
    obs_metrics.gauge(
        "comms.bytes_per_iter",
        "modeled wire bytes sent per rank per solve iteration",
    ).set(model["bytes_per_iter"])
    obs_metrics.gauge(
        "comms.dense_bytes_per_iter",
        "what the dense all_gather+reduce-scatter exchange would send",
    ).set(model["dense_bytes_per_iter"])
    if model.get("halo_fraction") is not None:
        obs_metrics.gauge(
            "comms.halo_fraction",
            "tail boundary entries / the dense all_gather's remote "
            "entries",
        ).set(model["halo_fraction"])
    if model.get("head_k") is not None:
        obs_metrics.gauge(
            "comms.head_k", "replicated high in-degree head size"
        ).set(model["head_k"])
    return obs_metrics.counter(
        "comms.bytes_exchanged",
        "modeled wire bytes sent by this rank, accumulated per "
        "iteration",
    )


# -- skew-driven load prediction (obs/graph_profile.py) ---------------------
#
# The comms model prices the exchange AFTER a build exists; this section
# PREDICTS the per-device load from the graph profile alone, from the
# per-(stripe, dst-block) edge/row geometry, so a run's balance risk is
# readable before it spends card time, and predicted-vs-measured is one
# report diff.


def predict_device_load(profile, ndev: int) -> Optional[dict]:
    """Per-device unique-edge counts for the row-sharded solve,
    predicted from the profile's per-(stripe, 128-dst-block) edge and
    row counts: slot rows concatenate in (stripe, block) order and
    shard evenly over ``ndev`` devices (rows padded to an ndev
    multiple), with each block's edges spread uniformly over its own
    rows — exact up to within-block row-density variation. None when
    the profile lacks the block geometry or the graph is edge-free."""
    be = getattr(profile, "block_edges", None)
    br = getattr(profile, "block_rows", None)
    if be is None or br is None or not ndev or ndev < 1:
        return None
    be = np.asarray(be, np.float64)
    br = np.asarray(br, np.int64)
    num_blocks = profile.n_padded // 128 if profile.n_padded else 0
    if num_blocks == 0 or be.shape != br.shape:
        return None
    n_stripes = max(1, be.shape[0] // num_blocks)
    edges_dev = np.zeros(ndev, np.float64)
    for s in range(n_stripes):
        e = be[s * num_blocks:(s + 1) * num_blocks]
        r = br[s * num_blocks:(s + 1) * num_blocks]
        rows = int(r.sum())
        if rows == 0:
            continue
        rows_pad = -(-rows // ndev) * ndev
        per_row = np.repeat(e / np.maximum(r, 1), r)
        if rows_pad > rows:
            per_row = np.concatenate(
                [per_row, np.zeros(rows_pad - rows)])
        edges_dev += per_row.reshape(ndev, rows_pad // ndev).sum(axis=1)
    total = float(edges_dev.sum())
    if total <= 0:
        return None
    mean = total / ndev
    return {
        "ndev": int(ndev),
        "device_edges": [float(x) for x in edges_dev],
        "straggler_skew": float(edges_dev.max() / mean),
    }


def _expected_remote_readers(d: np.ndarray, ndev: int) -> np.ndarray:
    """Expected distinct NON-OWNER devices whose rows gather a vertex
    of unique in-degree ``d``, under uniform edge-to-row placement:
    distinct devices among d draws = ndev*(1-(1-1/ndev)^d), of which
    (ndev-1)/ndev are remote on average."""
    hit = 1.0 - np.power(1.0 - 1.0 / ndev, np.asarray(d, np.float64))
    return (ndev - 1) * hit


def predict_halo_head_k(profile, ndev: int) -> int:
    """Predicted head-replication K for the sparse boundary exchange,
    from the profile's log2 in-degree histogram alone — the same cost
    argmin as parallel/partition.auto_head_k (replicating the first K
    relabeled vertices costs ``2*(ndev-1)*K/ndev`` all-reduce elements
    against the tail pair entries it removes), with the exact pair
    sets replaced by the expected remote-reader count per degree bin
    (bin k's vertices carry the bin's geometric-midpoint degree; the
    relabel is in-degree descending, so a prefix IS the high-degree
    head). A prediction, not the plan: `obs report` diffs it against
    the measured ``comms.head_k``."""
    if ndev <= 1:
        return 0
    # Descending (degree, count) sequence from the histogram.
    seq: List[tuple] = []
    hist = list(getattr(profile, "in_hist", []) or [])
    for k in range(len(hist) - 1, 0, -1):
        c = int(hist[k])
        if not c:
            continue
        d = 1.0 if k == 1 else 1.5 * (1 << (k - 1))
        seq.append((d, c))
    if not seq:
        return 0
    n_vs = -(-profile.n_padded // (128 * ndev)) * (128 * ndev)
    cap = min((n_vs // 256) * 128, 1 << 20)
    cands = [0]
    k = 128
    while k <= cap:
        cands.append(k)
        k *= 2
    degs = np.asarray([d for d, _ in seq])
    cnts = np.asarray([c for _, c in seq], np.int64)
    readers = _expected_remote_readers(degs, ndev)
    # Per-CHIP tail cost of one tail vertex with r expected remote
    # readers: the real plan pays one padded round per ring offset
    # (sum over offsets of the MAX pair width). A fully-shared vertex
    # (r = ndev-1) sits in every pair, so it costs each chip one slot
    # in every round: ndev-1. A scattered vertex (r small) hits r of
    # the ndev pairs per offset on average: ~r/ndev ~ r^2/(ndev-1)
    # per chip. r^2/(ndev-1) interpolates both ends exactly.
    per_vertex = readers * readers / (ndev - 1)
    cum = np.concatenate([[0], np.cumsum(cnts)])
    total_tail = float((per_vertex * cnts).sum())
    best_k, best_cost = 0, None
    for K in cands:
        # Tail cost beyond rank K: whole bins past K plus the partial
        # bin K lands in.
        i = int(np.searchsorted(cum, K, side="right")) - 1
        if i >= len(cnts):
            tail = 0.0
        else:
            head = float((per_vertex[:i] * cnts[:i]).sum())
            head += per_vertex[i] * (K - cum[i])
            tail = total_tail - head
        # The head all-reduce costs 2*(ndev-1)*K/ndev sends per chip
        # (the HaloPlan ring convention).
        cost = 2.0 * (ndev - 1) * K / ndev + tail
        if best_cost is None or cost < best_cost:
            best_k, best_cost = K, cost
    return int(best_k)


def predict_from_profile(profile, ndev: int) -> Optional[dict]:
    """The data-plane prediction block: per-device load and straggler
    skew for a target mesh size, from the profile alone (no build, no
    devices). Embedded in run reports next to the measured values;
    published as ``graph.*`` gauges by :func:`publish_prediction`."""
    if profile is None or not ndev:
        return None
    load = predict_device_load(profile, ndev)
    return {
        "ndev": int(ndev),
        "predicted_straggler_skew": (load["straggler_skew"]
                                     if load else None),
        "predicted_device_edges": (load["device_edges"]
                                   if load else None),
        "predicted_halo_head_k": predict_halo_head_k(profile, ndev),
    }


def publish_prediction(pred: Optional[dict]) -> None:
    """Mirror a prediction block into ``graph.*`` gauges so predicted
    sits next to measured in the exporter and the run-report diff."""
    if not pred:
        return
    if pred.get("predicted_straggler_skew") is not None:
        obs_metrics.gauge(
            "graph.predicted_straggler_skew",
            "max/mean per-device edge load predicted from the graph "
            "profile (compare: measured_device_edges)",
        ).set(pred["predicted_straggler_skew"])
    if pred.get("predicted_halo_head_k") is not None:
        obs_metrics.gauge(
            "graph.predicted_halo_head_k",
            "halo head-K predicted from the in-degree histogram "
            "(compare: comms.head_k)",
        ).set(pred["predicted_halo_head_k"])


def measured_device_edges(engine, ndev: Optional[int] = None
                          ) -> Optional[np.ndarray]:
    """ACTUAL per-rank real-slot counts of a built engine's row-sharded
    tables (the measurement the predicted skew is held against):
    sentinel and duplicate slots excluded, counted on the host at build
    (``TorchEngine.device_edges``). Each rank of the port holds only
    its own rows, so only the engine's own mesh size can be measured:
    None for another ``ndev``, and for an engine that keeps no count
    (the coo form)."""
    counts = getattr(engine, "device_edges", lambda: None)()
    if counts is None:
        return None
    counts = np.asarray(counts, np.int64)
    if ndev is not None and int(ndev) != counts.shape[0]:
        return None
    return counts
