"""String-vertex id assignment (C8 in SURVEY.md §2).

Copy of ``pagerank_tpu/ingest/ids.py``.

The reference collects all source urls into one HashSet (``collect()``)
and broadcasts it for membership tests (Sparky.java:127-135). Here that is a
host-side url -> int32 id dictionary built once during ingestion; the
device only ever sees integer ids.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

from pagerank_tpu_torch.graph import Graph, build_graph


class IdMap:
    """Insertion-ordered string -> int32 id assignment."""

    def __init__(self):
        self._ids = {}
        self._names: List[str] = []

    def get_or_add(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = len(self._names)
            self._ids[name] = i
            self._names.append(name)
        return i

    def get(self, name: str) -> Optional[int]:
        return self._ids.get(name)

    def __len__(self) -> int:
        return len(self._names)

    def __contains__(self, name: str) -> bool:
        return name in self._ids

    @property
    def names(self) -> List[str]:
        return self._names

    @classmethod
    def from_names(cls, names: List[str]) -> "IdMap":
        """Rebuild the map from an insertion-ordered name list (the
        native ingest path returns ids already assigned)."""
        m = cls()
        m._names = list(names)
        m._ids = {name: i for i, name in enumerate(m._names)}
        return m


def records_to_arrays(
    records: Iterable[Tuple[str, List[str]]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, IdMap]:
    """Crawl records -> raw (src, dst, crawled_mask, ids) arrays —
    the id-assignment half of :func:`records_to_graph`, exposed so the
    on-device build can consume integer edges directly."""
    ids = IdMap()
    src: List[int] = []
    dst: List[int] = []
    crawled: List[int] = []
    for url, targets in records:
        u = ids.get_or_add(url)
        crawled.append(u)
        for t in targets:
            src.append(u)
            dst.append(ids.get_or_add(t))
    n = len(ids)
    crawled_mask = np.zeros(n, dtype=bool)
    if crawled:
        crawled_mask[np.asarray(crawled)] = True
    # int32: ids are int32 by construction (IdMap), and the device-build
    # path ships these over the host->device link — 8 bytes/edge.
    return (
        np.asarray(src, dtype=np.int32),
        np.asarray(dst, dtype=np.int32),
        crawled_mask,
        ids,
    )


def records_to_graph(
    records: Iterable[Tuple[str, List[str]]],
) -> Tuple[Graph, IdMap]:
    """Build a :class:`Graph` from (url, anchor-targets) crawl records.

    A record with no targets contributes a vertex with no out-edges — the
    reference's dangling sentinel (Sparky.java:114-118). Linked-to but
    never-crawled targets become vertices too (Sparky.java:137-161); that
    falls out of id assignment covering both endpoints.

    Dangling-mass membership follows the post-repair ``dangUrls``
    (Sparky.java:172-184): *uncrawled targets only*. A crawled page with
    no anchor links contributes nothing and is NOT in the dangling mass —
    its lookup value is a non-null Iterable([null]), so the repair pass
    removes it (see graph.py module docstring).
    """
    src, dst, crawled_mask, ids = records_to_arrays(records)
    graph = build_graph(
        src,
        dst,
        n=len(ids),
        dangling_mask=~crawled_mask,
        vertex_names=ids.names,
    )
    return graph, ids
