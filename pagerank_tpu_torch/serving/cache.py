"""LRU result cache for served PPR queries.

Copy of ``pagerank_tpu/serving/cache.py``.

Keyed ``(graph fingerprint, source, params key, k)`` — the graph
fingerprint (``Graph.fingerprint()``, a structural sha256) makes a
cached entry self-invalidating when the resident graph changes, and
the params key folds in everything that changes the answer
(iterations, damping, dtype, dangling policy, mesh width after a
degraded re-shard is NOT included: a degraded mesh computes the same
numbers, only slower, so hits stay valid across a rescue).

Thread discipline (PTR001): a single lock guards the OrderedDict; the
stored arrays are immutable by convention (the daemon stores the
device-fetched numpy copies and hands the same objects back).

Query plane: the daemon wraps every admission-time lookup
in a ``query/cache`` phase (attr ``hit``) on the query's trace — a
cache-hit settle is ``answered_cache`` with a one-phase timeline, so
even never-queued queries carry a complete causal record. The cache
itself stays observability-free beyond its aggregate hit/miss
counters: it cannot see the querying context, only keys.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Hashable, Optional, Tuple

from pagerank_tpu_torch.obs import metrics as obs_metrics


class ResultCache:
    """Bounded LRU of ``key -> (topk_ids, topk_scores)``.

    ``capacity=0`` disables caching (every ``get`` misses, ``put`` is
    a no-op) — the chaos harness uses that to keep every query on the
    compute path."""

    def __init__(self, capacity: int = 1024):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, Tuple]" = OrderedDict()
        self._hits = obs_metrics.counter(
            "serve.cache_hits", "queries answered from the LRU cache"
        )
        self._misses = obs_metrics.counter(
            "serve.cache_misses", "queries that went to the mesh"
        )

    @staticmethod
    def key(graph_fingerprint: str, source: int, params_key: Hashable,
            k: int) -> Tuple:
        return (graph_fingerprint, int(source), params_key, int(k))

    def get(self, key: Hashable) -> Optional[Tuple]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._misses.inc()
                return None
            self._entries.move_to_end(key)
            self._hits.inc()
            return entry

    def put(self, key: Hashable, ids, scores) -> None:
        if self.capacity == 0:
            return
        with self._lock:
            self._entries[key] = (ids, scores)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value
