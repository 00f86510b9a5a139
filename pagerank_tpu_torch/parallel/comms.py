"""Per-iteration communication accounting for the sharded solve.

Port of the dense half of ``pagerank_tpu/parallel/comms.py``: the dense
byte model (``dense_exchange_bytes``, ``model_dense``, :40-68), its
publication (``register``, :137), the skew-driven load prediction from
a graph profile (``predict_device_load``, :181-217;
``predict_from_profile`` and ``publish_prediction``, :296-335) and its
measured counterpart (``measured_device_edges``, :336). The sparse and
asynchronous exchange models, the overlap gain and the halo head-K
prediction (``model_sparse``, ``model_async``, ``predict_overlap_gain``,
``publish_overlap_gain``, ``predict_halo_head_k``) come with the halo
forms (ROADMAP slice 6b); until then a prediction's
``predicted_halo_head_k`` is None.

A static byte model per exchange mode, derived once at build from the
engine's resolved layout, plus the live instruments every solve
publishes through the metrics registry:

  - ``comms.bytes_exchanged``   counter, modeled wire bytes sent by
                                 this rank, accumulated per iteration;
  - ``comms.bytes_per_iter``    gauge, the per-iteration rate;
  - ``comms.dense_bytes_per_iter`` gauge, what the DENSE exchange
                                 (all_gather + full-width merge) would
                                 move — the standing comparator.

Byte convention: bytes SENT per rank per iteration under the standard
ring lowering — all_gather/reduce_scatter of an n-element vector cost
``(ndev-1) * n/ndev`` sends per rank, an all-reduce twice that.
"""

from __future__ import annotations

from typing import Optional

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


def predict_from_profile(profile, ndev: int) -> Optional[dict]:
    """The data-plane prediction block: per-device load and straggler
    skew for a target mesh size, from the profile alone (no build, no
    devices). Embedded in run reports next to the measured values;
    published as ``graph.*`` gauges by :func:`publish_prediction`. The
    halo head-K prediction comes with the halo forms (slice 6b): None
    here."""
    if profile is None or not ndev:
        return None
    load = predict_device_load(profile, ndev)
    return {
        "ndev": int(ndev),
        "predicted_straggler_skew": (load["straggler_skew"]
                                     if load else None),
        "predicted_device_edges": (load["device_edges"]
                                   if load else None),
        "predicted_halo_head_k": None,
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
