"""Common Crawl metadata-JSON link extraction (C6 in SURVEY.md §2) —
host-side equivalent of the reference's Gson flatMap
(`Sparky.java:78-124`), quirks preserved:

  - only links whose ``type`` is the *string* ``"a"`` count
    (Sparky.java:103 — the reference compares Gson ``toString()`` output
    against ``"\"a\""``, which is string-equality on "a");
  - every double-quote character is stripped from ``href``
    (Sparky.java:101,105 — ``replace("\"", "")`` runs on the *quoted*
    Gson rendering, so embedded quotes vanish too);
  - a record with zero anchor links yields a vertex with no out-edges
    (the (url, null) sentinel + dangUrls, Sparky.java:114-118);
  - ``content`` / ``links`` may be absent (null-checks at :91,:94) — the
    record is then dangling;
  - a malformed JSON record or a link entry missing ``href``/``type``
    crashes the reference job (Gson parse/NPE inside the flatMap);
    ``strict=True`` reproduces that, ``strict=False`` skips bad entries.

Input file format here: one record per line, ``url<TAB>json`` (the
(Text, Text) SequenceFile pairs of Sparky.java:61 flattened to TSV), or
JSONL with ``{"url": ..., "metadata": {...}}``.

Copy of ``pagerank_tpu/ingest/crawljson.py`` without its tracer span;
:func:`load_crawl_file_routed` also says which parser ran.
"""

from __future__ import annotations

import json
from typing import Iterator, List, Tuple

from pagerank_tpu_torch.utils import fsio


def _render(value) -> str:
    """Gson ``JsonElement.toString()`` for primitives: strings keep their
    quotes, numbers/bools/null render as JSON literals. Gson does not
    escape non-ASCII, so neither do we."""
    return json.dumps(value, ensure_ascii=False)


def parse_metadata_record(
    url: str, metadata_json: str, strict: bool = True
) -> Tuple[str, List[str]]:
    """One crawl record -> (url, anchor targets). Empty targets means the
    page is dangling (no anchor links)."""
    try:
        root = json.loads(metadata_json)
    except json.JSONDecodeError:
        if strict:
            raise
        return url, []
    targets: List[str] = []
    content = root.get("content") if isinstance(root, dict) else None
    if isinstance(content, dict):
        links = content.get("links")
        if isinstance(links, list):
            for entry in links:
                try:
                    href = entry["href"]  # KeyError == reference NPE
                    ltype = entry["type"]
                except (KeyError, TypeError):
                    if strict:
                        raise
                    continue
                # type.equals("\"a\"") on the quoted rendering == the
                # JSON string "a" (Sparky.java:103).
                if _render(ltype) == '"a"':
                    # strip ALL double quotes from the quoted rendering
                    # (Sparky.java:105).
                    targets.append(_render(href).replace('"', ""))
    return url, targets


def iter_crawl_records(
    path: str, strict: bool = True
) -> Iterator[Tuple[str, List[str]]]:
    """Yield (url, targets) from a TSV (url<TAB>json) or JSONL file."""
    with fsio.fopen(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if "\t" in line:
                url, meta = line.split("\t", 1)
            else:
                obj = json.loads(line)
                url = obj["url"]
                meta = json.dumps(obj.get("metadata", obj.get("json", {})))
            yield parse_metadata_record(url, meta, strict=strict)


def load_crawl_file(path: str, strict: bool = True, native: str = "auto"):
    """Parse a crawl-metadata file (TSV or JSONL) into a Graph (+ IdMap).

    ``native="auto"`` uses the C++ L1 (``ingest/native.py:crawl_load``)
    when its library is available, else (and with ``native="off"``)
    this module's Python parser; both give the same graph."""
    return load_crawl_file_routed(path, strict, native)[0]


def load_crawl_file_arrays(path: str, strict: bool = True,
                           native: str = "auto"):
    """Like :func:`load_crawl_file` but stops before the graph build:
    raw ``(src, dst, crawled_mask, IdMap)``."""
    return load_crawl_file_routed(path, strict, native, raw=True)[0]


def load_crawl_file_routed(path: str, strict: bool = True,
                           native: str = "auto", raw: bool = False):
    """``(result, route)``: what :func:`load_crawl_file` (or, with
    ``raw``, :func:`load_crawl_file_arrays`) returns, and the parser
    that produced it, "native" or "python"."""
    if native == "auto":
        from pagerank_tpu_torch.ingest import native as native_mod

        result = native_mod.try_crawl_load([path], "tsv", strict=strict,
                                           raw=raw)
        if result is not None:
            return result, "native"
    from pagerank_tpu_torch.ingest.ids import (records_to_arrays,
                                               records_to_graph)

    records = iter_crawl_records(path, strict=strict)
    return (records_to_arrays(records) if raw
            else records_to_graph(records)), "python"
