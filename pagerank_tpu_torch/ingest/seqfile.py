"""Hadoop SequenceFile ingestion — the reference's literal input format.

The reference reads the Common Crawl web graph as Hadoop SequenceFiles
of (Text url, Text json-metadata) pairs: ``ctx.sequenceFile(path,
Text.class, Text.class)`` over 301 `metadata-*` segments
(Sparky.java:44-58,61). This module reads that on-disk format directly
(and writes it, for tests and interop), so a dataset prepared for the
reference runs here unmodified.

Format implemented (the one the reference's inputs use): SequenceFile
version 6, record-oriented, uncompressed, ``org.apache.hadoop.io.Text``
keys and values:

    "SEQ" 0x06
    keyClassName: Hadoop writeString (Text-style VInt length + UTF-8)
    valueClassName: writeString
    compressed: bool byte      (must be 0 here)
    blockCompressed: bool byte (must be 0 here)
    metadata: int32-BE pair count, then (writeString k, writeString v)*
    sync: 16 random bytes
    records: int32-BE recordLen | int32-BE keyLen | key | value
             recordLen == -1 -> a 16-byte sync marker follows (verified)

``Text`` payloads inside a record carry their own Hadoop VInt length
prefix followed by UTF-8 bytes.

Compression: the reference inherits transparent codec support through
``ctx.sequenceFile`` (Sparky.java:61), so both Hadoop layouts of
DefaultCodec/DeflateCodec (plain zlib) are read AND written here:

- *record* compression (``compressed=1, blockCompressed=0``): each
  record's value bytes are a zlib stream; keys stay raw.
- *block* compression (``compressed=1, blockCompressed=1``): records
  are buffered and flushed as blocks — each block is a sync marker,
  a VInt record count, then FOUR length-prefixed zlib streams
  (key lengths, keys, value lengths, values), per Hadoop's
  ``SequenceFile.BlockCompressWriter``. Common Crawl segments of the
  reference's vintage commonly use this layout.

Other codecs (gzip framing, snappy, lzo) raise a clear error.

Copy of ``pagerank_tpu/ingest/seqfile.py`` without its tracer spans;
:func:`load_crawl_seqfile_routed` also says which parser ran.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Iterable, Iterator, List, Optional, Tuple

from pagerank_tpu_torch.utils import fsio

SEQ_MAGIC = b"SEQ"
TEXT_CLASS = "org.apache.hadoop.io.Text"
_DEFLATE_CODECS = (
    "org.apache.hadoop.io.compress.DefaultCodec",
    "org.apache.hadoop.io.compress.DeflateCodec",
)


# -- Hadoop primitive encodings ------------------------------------------


def _read_vint(f) -> int:
    """Hadoop WritableUtils.readVInt/VLong: single byte in [-112, 127]
    is the value; otherwise it encodes sign + byte count."""
    b0 = f.read(1)
    if not b0:
        raise EOFError("EOF inside VInt")
    first = struct.unpack("b", b0)[0]
    if first >= -112:
        return first
    if first >= -120:
        size, negative = first + 112, False
    else:
        size, negative = first + 120, True
    size = -size
    data = f.read(size)
    if len(data) != size:
        raise EOFError("EOF inside VInt body")
    value = 0
    for byte in data:
        value = (value << 8) | byte
    return ~value if negative else value


def _write_vint(out: io.BytesIO, value: int) -> None:
    if -112 <= value <= 127:
        out.write(struct.pack("b", value))
        return
    negative = value < 0
    if negative:
        value = ~value
    size = (value.bit_length() + 7) // 8
    out.write(struct.pack("b", (-120 if negative else -112) - size))
    out.write(value.to_bytes(size, "big"))


def _read_i32(f, what: str) -> int:
    data = f.read(4)
    if len(data) != 4:
        raise EOFError(f"EOF inside {what}")
    return struct.unpack(">i", data)[0]


def _read_exact(f, n: int, what: str) -> bytes:
    """Read exactly ``n`` bytes or raise EOFError — in bounded chunks,
    so a corrupt length field (a flipped VInt/int32 can claim 2^60
    bytes) fails with EOFError instead of a huge upfront allocation
    blowing up as MemoryError (found by the native-vs-Python container
    fuzz, tests/test_native_crawl.py)."""
    if n < (1 << 24):
        data = f.read(n)
        if len(data) != n:
            raise EOFError(f"EOF inside {what}")
        return data
    chunks = []
    remaining = n
    while remaining:
        chunk = f.read(min(remaining, 1 << 24))
        if not chunk:
            raise EOFError(f"EOF inside {what}")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def _read_text(f) -> bytes:
    n = _read_vint(f)
    if n < 0:
        raise ValueError(f"negative Text length {n}")
    return _read_exact(f, n, "Text payload")


def _text_bytes(s: str) -> bytes:
    out = io.BytesIO()
    payload = s.encode("utf-8")
    _write_vint(out, len(payload))
    out.write(payload)
    return out.getvalue()


# -- reading --------------------------------------------------------------


def read_sequence_file(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (key, value) Text pairs from one SequenceFile.

    Supports version-6 files with Text/Text classes: uncompressed,
    per-record deflate, or block-compressed deflate (DefaultCodec —
    plain zlib). Other codecs and non-Text classes raise ValueError.
    ``path`` may use any registered URI scheme (utils/fsio) — the
    reference reads these straight off S3 (Sparky.java:44-61).
    """
    with fsio.fopen(path, "rb") as f:
        magic = f.read(4)
        # len guard: a file truncated inside the magic (e.g. exactly
        # b"SEQ") must raise the same FORMAT ValueError as the native
        # reader (crawl_ingest.cpp), not IndexError on magic[3].
        if len(magic) < 4 or magic[:3] != SEQ_MAGIC:
            raise ValueError(f"{path}: not a SequenceFile (magic {magic!r})")
        version = magic[3]
        if version != 6:
            raise ValueError(
                f"{path}: SequenceFile version {version}; only the "
                "version-6 layout (metadata header, Text class names) "
                "is supported"
            )
        key_cls = _read_text(f).decode("utf-8")
        val_cls = _read_text(f).decode("utf-8")
        if key_cls != TEXT_CLASS or val_cls != TEXT_CLASS:
            raise ValueError(
                f"{path}: expected Text/Text pairs "
                f"(Sparky.java:61), got {key_cls}/{val_cls}"
            )
        compressed = f.read(1) != b"\x00"
        block_compressed = f.read(1) != b"\x00"
        decompress = None
        if compressed:
            codec = _read_text(f).decode("utf-8")
            if codec not in _DEFLATE_CODECS:
                raise ValueError(f"{path}: unsupported codec {codec}")
            decompress = zlib.decompress
        n_meta = _read_i32(f, "metadata count")
        for _ in range(n_meta):
            _read_text(f)
            _read_text(f)
        sync = f.read(16)
        if len(sync) != 16:
            raise EOFError(f"{path}: truncated header (sync marker)")

        if block_compressed:
            yield from _read_blocks(f, path, sync, decompress)
            return

        while True:
            head = f.read(4)
            if len(head) < 4:
                return  # clean EOF
            rec_len = struct.unpack(">i", head)[0]
            if rec_len == -1:  # sync escape
                marker = f.read(16)
                if marker != sync:
                    raise ValueError(f"{path}: sync marker mismatch "
                                     "(corrupt file)")
                continue
            if rec_len < 0:
                raise ValueError(f"{path}: bad record length {rec_len}")
            key_len = _read_i32(f, "key length")
            if not (0 <= key_len <= rec_len):
                raise ValueError(f"{path}: bad key length {key_len}")
            key_raw = _read_exact(f, key_len, f"record ({path})")
            val_raw = _read_exact(f, rec_len - key_len, f"record ({path})")
            if decompress is not None:
                val_raw = decompress(val_raw)
            key = _read_text(io.BytesIO(key_raw)).decode("utf-8", "replace")
            val = _read_text(io.BytesIO(val_raw)).decode("utf-8", "replace")
            yield key, val


def _read_blocks(f, path: str, sync: bytes, decompress) -> Iterator[Tuple[str, str]]:
    """Iterate a block-compressed body: each block is SYNC_ESCAPE(-1) +
    sync + VInt recordCount + four VInt-length-prefixed compressed
    buffers (key lengths, keys, value lengths, values) — the layout
    Hadoop's ``SequenceFile.BlockCompressWriter.sync()`` emits."""
    if decompress is None:
        raise ValueError(f"{path}: block-compressed flag set without a codec")

    def read_buffer(what: str) -> io.BytesIO:
        n = _read_vint(f)
        if n < 0:
            raise ValueError(f"{path}: bad {what} buffer length {n}")
        data = _read_exact(f, n, f"{what} buffer ({path})")
        return io.BytesIO(decompress(data))

    while True:
        head = f.read(4)
        if len(head) < 4:
            return  # clean EOF between blocks
        if struct.unpack(">i", head)[0] != -1:
            raise ValueError(f"{path}: expected block sync escape, got {head!r}")
        marker = f.read(16)
        if marker != sync:
            raise ValueError(f"{path}: sync marker mismatch (corrupt file)")
        n_rec = _read_vint(f)
        if n_rec < 0:
            raise ValueError(f"{path}: bad block record count {n_rec}")
        key_lens = read_buffer("key-lengths")
        keys = read_buffer("keys")
        val_lens = read_buffer("value-lengths")
        vals = read_buffer("values")
        for _ in range(n_rec):
            klen = _read_vint(key_lens)
            key_raw = keys.read(klen)
            vlen = _read_vint(val_lens)
            val_raw = vals.read(vlen)
            if len(key_raw) != klen or len(val_raw) != vlen:
                raise EOFError(f"{path}: truncated block record")
            key = _read_text(io.BytesIO(key_raw)).decode("utf-8", "replace")
            val = _read_text(io.BytesIO(val_raw)).decode("utf-8", "replace")
            yield key, val


def expand_seqfile_paths(spec: str) -> List[str]:
    """A path, a directory (all non-hidden files, sorted — the layout of
    a crawl segment like the reference's `metadata-00000..00300`), or a
    comma-joined list of either (the reference builds a comma-joined
    path string, Sparky.java:42-58)."""
    paths: List[str] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if fsio.isdir(part):
            paths.extend(
                full
                for name in sorted(fsio.listdir(part))
                if not name.startswith((".", "_"))
                and fsio.isfile(full := fsio.join(part, name))
            )
        else:
            paths.append(part)
    if not paths:
        raise ValueError(f"no input files in {spec!r}")
    return paths


def _parse_seqfile_worker(args):
    """One segment file -> parsed (url, targets) records; runs in a
    forked worker process (module-level so it pickles by reference)."""
    path, strict = args
    from pagerank_tpu_torch.ingest.crawljson import parse_metadata_record

    return [
        parse_metadata_record(url, meta, strict=strict)
        for url, meta in read_sequence_file(path)
    ]


def iter_segment_records(
    paths, strict: bool = True, workers: Optional[int] = None
):
    """Parsed records from a multi-file segment, optionally in parallel.

    The reference parses its 301 segment files across the cluster
    (``ctx.sequenceFile``, Sparky.java:61); here the per-file work
    (VInt/codec decode + JSON anchor extraction, both pure-Python
    CPU-bound) fans out over a process pool. ``workers=None`` = auto:
    one per core, capped by the file count (serial on single-core hosts
    where the pool is pure overhead). Record order — and therefore id
    assignment and every downstream array — is IDENTICAL to the serial
    path: files are yielded in input order, records in file order
    (tests/test_torch_ingest.py pins this).

    Workers are forked, as in the JAX package; platforms without fork
    run serially. Auto mode runs serially in a process that already has
    threads (fork could clone a held lock into a worker).
    """
    import multiprocessing
    import os
    import threading

    paths = list(paths)
    if workers is None:
        workers = min(len(paths), os.cpu_count() or 1)
        # Auto mode degrades to serial once the parent is multi-threaded
        # (e.g. the async snapshot writer, or an engine already built):
        # forking a threaded process can clone a held lock into the
        # child and deadlock the pool. An EXPLICIT workers>1 is honored
        # as the caller's assertion that forking is safe here (the CLI
        # ingests before any engine/writer exists).
        if threading.active_count() > 1:
            workers = 1
    if (
        workers <= 1
        or len(paths) <= 1
        or "fork" not in multiprocessing.get_all_start_methods()
    ):
        from pagerank_tpu_torch.ingest.crawljson import parse_metadata_record

        for path in paths:
            for url, meta in read_sequence_file(path):
                yield parse_metadata_record(url, meta, strict=strict)
        return
    import collections
    import concurrent.futures

    ctx = multiprocessing.get_context("fork")
    with concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=ctx
    ) as ex:
        # Bounded in-flight window (2x workers) instead of ex.map: map
        # submits every file at once, and since the consumer drains in
        # order, completed per-file record lists would pile up to the
        # whole parsed segment in RAM. The window keeps the speedup with
        # a bounded transient. Order is preserved (deque is FIFO over
        # the input order); a strict-mode parse error in any worker
        # propagates at its file's position, matching the serial crash.
        pending = collections.deque()
        it = iter(paths)
        for path in it:
            pending.append(ex.submit(_parse_seqfile_worker, (path, strict)))
            if len(pending) >= 2 * workers:
                break
        while pending:
            yield from pending.popleft().result()
            for path in it:
                pending.append(
                    ex.submit(_parse_seqfile_worker, (path, strict))
                )
                break


def load_crawl_seqfile(
    spec: str, strict: bool = True, workers: Optional[int] = None,
    native: str = "auto",
):
    """SequenceFile(s) of (url, crawl-metadata json) -> (Graph, IdMap).

    The reference's pipeline on these files: JSON anchor extraction with
    the Gson rendering quirks (crawljson.py), then the dedup, adjacency
    and dangling graph build (Sparky.java:61-124).

    ``native="auto"`` (default) uses the C++ L1 when its library builds
    (container decode + JSON extraction + interning in one pass).
    ``native="off"``, or an explicit ``workers`` value (a request for
    the Python process pool), takes the Python path, where multi-file
    segments parse in parallel (:func:`iter_segment_records`). Both give
    the same graph.
    """
    return load_crawl_seqfile_routed(spec, strict, workers, native)[0]


def load_crawl_seqfile_arrays(
    spec: str, strict: bool = True, workers: Optional[int] = None,
    native: str = "auto",
):
    """Like :func:`load_crawl_seqfile` but stops before the graph build:
    raw ``(src, dst, crawled_mask, IdMap)`` integer arrays."""
    return load_crawl_seqfile_routed(spec, strict, workers, native,
                                     raw=True)[0]


def load_crawl_seqfile_routed(spec, strict=True, workers=None,
                              native="auto", raw=False):
    """``(result, route)``: what :func:`load_crawl_seqfile` (or, with
    ``raw``, :func:`load_crawl_seqfile_arrays`) returns, and the parser
    that produced it, "native" or "python". The one copy of the rule:
    auto with no explicit workers tries the native L1; no library, or
    an input it cannot represent, takes the Python path."""
    paths = expand_seqfile_paths(spec)
    if native == "auto" and workers is None:
        from pagerank_tpu_torch.ingest import native as native_mod

        result = native_mod.try_crawl_load(paths, "seqfile", strict=strict,
                                           raw=raw)
        if result is not None:
            return result, "native"
    from pagerank_tpu_torch.ingest.ids import (records_to_arrays,
                                               records_to_graph)

    records = iter_segment_records(paths, strict, workers)
    return (records_to_arrays(records) if raw
            else records_to_graph(records)), "python"


# -- writing (tests + interop) -------------------------------------------


def write_sequence_file(
    path: str,
    pairs: Iterable[Tuple[str, str]],
    sync_every: int = 100,
    compression: str = "none",
    block_size: int = 1 << 20,
) -> int:
    """Write (key, value) Text pairs as a version-6 SequenceFile
    readable by Hadoop/Spark and :func:`read_sequence_file`. Returns the
    record count.

    ``compression``: "none", "record" (each value a zlib stream), or
    "block" (Hadoop block layout: records buffered until ~``block_size``
    raw bytes, then flushed as sync + VInt count + four compressed
    buffers). Both compressed modes declare DefaultCodec."""
    if compression not in ("none", "record", "block"):
        raise ValueError(f"unknown compression {compression!r}")
    sync = bytes((i * 89 + 41) % 256 for i in range(16))
    count = 0
    with fsio.fopen(path, "wb") as f:
        f.write(SEQ_MAGIC + bytes([6]))
        f.write(_text_bytes(TEXT_CLASS))
        f.write(_text_bytes(TEXT_CLASS))
        f.write(b"\x00" if compression == "none" else b"\x01")
        f.write(b"\x01" if compression == "block" else b"\x00")
        if compression != "none":
            f.write(_text_bytes(_DEFLATE_CODECS[0]))
        f.write(struct.pack(">i", 0))  # no metadata
        f.write(sync)

        if compression == "block":
            key_lens, keys = io.BytesIO(), io.BytesIO()
            val_lens, vals = io.BytesIO(), io.BytesIO()
            buffered = 0

            def flush():
                nonlocal buffered
                if not buffered:
                    return
                f.write(struct.pack(">i", -1))
                f.write(sync)
                _write_vint(f, buffered)
                for buf in (key_lens, keys, val_lens, vals):
                    comp = zlib.compress(buf.getvalue())
                    _write_vint(f, len(comp))
                    f.write(comp)
                    buf.seek(0)
                    buf.truncate()
                buffered = 0

            for key, value in pairs:
                k = _text_bytes(key)
                v = _text_bytes(value)
                _write_vint(key_lens, len(k))
                keys.write(k)
                _write_vint(val_lens, len(v))
                vals.write(v)
                buffered += 1
                count += 1
                if keys.tell() + vals.tell() >= block_size:
                    flush()
            flush()
            return count

        deflate = zlib.compress if compression == "record" else None
        for key, value in pairs:
            if count and sync_every and count % sync_every == 0:
                f.write(struct.pack(">i", -1))
                f.write(sync)
            k = _text_bytes(key)
            v = _text_bytes(value)
            if deflate is not None:
                v = deflate(v)
            f.write(struct.pack(">i", len(k) + len(v)))
            f.write(struct.pack(">i", len(k)))
            f.write(k)
            f.write(v)
            count += 1
    return count
